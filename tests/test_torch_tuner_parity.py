"""Both packages' MCLMC tuners from the same warm-start members, on the
CPU, at a cut size of the ``dataset`` study's config
(``configs/replicate_uci/mclmc.yaml``: FCN [16, 16, 2], 12 chains).

The port's warm start (20 epochs) makes 12 members of yacht and of
airfoil; the JAX package's ``mclmc_tune`` (vmapped over the chains) and
the port's tune from those members for 500 steps with the config's knobs,
each package with its own noise, in exact float32. Their tuned ε and L
are compared as statistics over the chains, as
``test_torch_tuning.py`` compares them: the means of log ε and log L
within 4 standard errors and 15 %, the spreads within a factor of 2.

Then the port's tuner runs again from the same members with the same
noise at the TPU's one bfloat16 pass. On airfoil, the JAX package's A/B
set (``aggr_results/aggr_dtype_ab.csv``), its ε falls, as the A/B's did
on the TPU (0.037-0.039 exact, 0.0051-0.0054 at the default): here by
more than 20 % and 2.5 standard errors after 500 steps (by 36 % when this
was written). On yacht the fall at this size is within the chains'
spread (17 %), so its direction is left to the full-count runs on the
card (``PERF.md``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mile_tpu_torch.mcmc.adaptation.mclmc_tuning import (
    TuningConfig,
    mclmc_tune,
)
from mile_tpu_torch.utils.precision import matmul_precision

CONFIG = 'configs/replicate_uci/mclmc.yaml'
CUT = {'training.warmstart.max_epochs': 20, 'rng': 1}
STEPS = 500
KNOBS = dict(warmup_steps=STEPS, step_size_init=0.001,
             desired_energy_var_start=0.5, desired_energy_var_end=0.1,
             trust_in_estimate=1.5, num_effective_samples=100)


@pytest.fixture(scope='module')
def tuned(tmp_path_factory):
    """``tuned(ds)``: {arm: (ε, L)} of the JAX tuner and the port's in
    float32 and in one bfloat16 pass, from the same 12 members of set
    ``ds``, computed once a set."""
    cache = {}

    def get(ds):
        if ds not in cache:
            cache[ds] = _tune(ds, tmp_path_factory.mktemp(ds))
        return cache[ds]
    return get


def _tune(ds, root):
    from mile_tpu.config import Config as JaxConfig
    from mile_tpu.mcmc.adaptation.mclmc_tuning import TuningConfig as JaxCfg
    from mile_tpu.mcmc.adaptation.mclmc_tuning import mclmc_tune as jax_tune
    from mile_tpu.train.trainer import BDETrainer as JaxTrainer
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    over = {'saving_dir': str(root), 'experiment_name': ds,
            'data.path': f'data/{ds}.data', **CUT}
    (cfg,) = Config.from_file(CONFIG)
    trainer = BDETrainer(cfg.replace(**over), device='cpu')
    members = trainer.train_warmstart()
    x, y = trainer.loader.arrays('train')
    vg = trainer.bayes.logdensity_and_grad_fn(x, y)
    out = {}
    for prec in ('float32', 'bfloat16'):
        with matmul_precision(prec):
            _, p = mclmc_tune(vg, members.clone(),
                              torch.Generator().manual_seed(1),
                              TuningConfig(**KNOBS))
        out[prec] = (p.step_size.numpy(), p.L.numpy())
    torch.set_num_threads(prev)

    (jcfg,) = JaxConfig.from_file(CONFIG)
    jax_trainer = JaxTrainer(jcfg.replace(**{**over, 'saving_dir':
                                             str(root / 'jax')}))
    jx, jy = jax_trainer.loader.arrays('train')
    np.testing.assert_array_equal(np.asarray(jx), x.numpy())
    logdensity = jax_trainer.bayes.logdensity_fn(jx, jy)
    _, ref = jax.jit(jax.vmap(
        lambda p, k: jax_tune(logdensity, p, k, JaxCfg(**KNOBS))))(
        jnp.asarray(members.numpy()),
        jax.random.split(jax.random.PRNGKey(3), members.shape[0]))
    out['jax'] = (np.asarray(ref.step_size), np.asarray(ref.L))
    return out


def _logs(a, b):
    """log values, the difference of their means and its standard error."""
    la, lb = np.log(a), np.log(b)
    return la, lb, lb.mean() - la.mean(), np.sqrt((la.var() + lb.var())
                                                  / len(la))


@pytest.mark.parametrize('ds', ['yacht', 'airfoil'])
def test_the_tuners_agree_from_the_same_members(tuned, ds):
    """Exact float32 in both packages: ε and L as statistics over the 12
    chains."""
    out = tuned(ds)
    for want, got in zip(out['jax'], out['float32']):
        la, lb, diff, se = _logs(want, got)
        assert np.isfinite(lb).all()
        assert abs(diff) < min(4 * se, 0.15), (la, lb)
        assert 0.5 < lb.std() / la.std() < 2.0, (la, lb)


def test_one_pass_tuning_shrinks_eps_on_airfoil(tuned):
    """The port's tuner at the one bfloat16 pass against itself in exact
    float32, same members and noise: airfoil's ε and L fall (yacht's
    direction is left to the card runs: module docstring)."""
    out = tuned('airfoil')
    for exact, one_pass in zip(out['float32'], out['bfloat16']):
        _, _, diff, se = _logs(exact, one_pass)
        assert diff < min(-2.5 * se, np.log(0.8)), (exact, one_pass)
