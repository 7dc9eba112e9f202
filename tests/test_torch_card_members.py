"""The card's warm-start members kept as fixtures (``tests/fixtures/
card_members/``, loaded by ``tests/_torch_card_members.py``), checked
against each job's network in both packages: the flat dimension (738 for
protein, 786 at width 16, 5,426 at width 48, 426 for airfoil's deep-8
FCN), the port's layout of the
job's model, and the JAX model's ``ravel_pytree`` order, leaf by leaf;
and the providers' members against the network of each ``nuts_ta`` job
that samples from them."""
import jax
import numpy as np
import pytest

import _torch_card_members as card
from _torch_parity import one_torch_thread  # noqa: F401

JOB = pytest.mark.parametrize('job', sorted(card.JOBS))
# the nuts_ta jobs whose provider's members are fixtures
CONSUMERS = [f'bike_nuts_ta{t}_r{r}' for r in (1, 2) for t in (80, 90, 95)]


@pytest.mark.parametrize('consumer', CONSUMERS)
def test_a_providers_members_fit_its_nuts_ta_consumer(consumer, tmp_path):
    from mile_tpu_torch.train.trainer import BDETrainer

    job = card.provider(consumer)
    assert job in card.JOBS
    spec = card.catalogue_job(consumer)
    assert spec.study == 'nuts_ta'
    trainer = BDETrainer(spec.config(tmp_path, tpu_arithmetic=True),
                         device='cpu')
    assert trainer.bayes.dim == card.JOBS[job][1] == 786
    assert card.layout(job).to_json() == trainer.model.layout.to_json()


@JOB
def test_the_members_fit_the_ports_model(job, tmp_path):
    from mile_tpu_torch.train.trainer import BDETrainer

    study, dim = card.JOBS[job]
    spec = card.catalogue_job(job)
    assert spec.study == study
    trainer = BDETrainer(spec.config(tmp_path, tpu_arithmetic=True),
                         device='cpu')
    flat = card.members(job)
    assert flat.shape == (12, dim) and flat.dtype == np.float32
    assert np.isfinite(flat).all()
    assert trainer.bayes.dim == dim
    assert card.layout(job).to_json() == trainer.model.layout.to_json()


@JOB
def test_the_members_unravel_in_the_jax_order(job, tmp_path):
    from mile_tpu.config import Config as JaxConfig
    from mile_tpu.train.trainer import BDETrainer as JaxTrainer

    spec = card.catalogue_job(job)
    (cfg,) = JaxConfig.from_file(card.ROOT / spec.base)
    cfg = cfg.replace(**{'saving_dir': str(tmp_path), 'experiment_name': job,
                         **spec.overrides})
    bayes = JaxTrainer(cfg).bayes
    flat = card.members(job)
    assert bayes.dim == card.JOBS[job][1]
    layout = card.layout(job)
    for c in (0, 11):
        tree = bayes.unravel(flat[c])
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        paths = ['/'.join(str(k.key) for k in path) for path, _ in leaves]
        assert paths == [leaf.path for leaf in layout.leaves]
        with np.load(card.directory(job) / f'params_{c}.npz') as data:
            for i, ((_, value), leaf) in enumerate(zip(leaves,
                                                       layout.leaves)):
                assert value.shape == leaf.shape
                np.testing.assert_array_equal(np.asarray(value),
                                              data[f'leaf_{i}'])
        np.testing.assert_array_equal(np.asarray(bayes.flatten(tree)),
                                      flat[c])
