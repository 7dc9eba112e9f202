"""Triage of the ``tabular_classif`` study's LPPD on the CPU: the warm
start and its deep-ensemble evaluation in both packages.

On the card the port's LPPD of sonar (3 of 5 seeds) and ionosphere (2 of
5) lay above the JAX seeds' intervals, and so did its deep ensemble's
LPPD (``de_lppd``, the members alone, before any draw). Here, for seeds
1-5 of each set's config, both packages warm-start the 12 members in
exact float32 (the JAX package's trainer and the port's, each with its own
initialisation and batches) and evaluate them as the trainers do on the
test split. Printed: each seed's DE LPPD and accuracy in both packages,
their means and standard errors, and the JAX evaluation of the port's
members. Held: both evaluations of the same members agree (rtol 1e-4),
and the two packages' mean DE LPPD lie within 3 standard errors of each
other.

Marked ``slow`` and outside the tier-1 run: ten warm starts of up to 500
epochs a set (a few minutes).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow

ROOT = Path(__file__).resolve().parent.parent
SEEDS = (1, 2, 3, 4, 5)


def port_de(config: str, rng: int, root: Path):
    """The port's members of seed ``rng`` and their DE (LPPD, accuracy)."""
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.inference.evaluation import evaluate_de
    from mile_tpu_torch.train.trainer import BDETrainer

    (cfg,) = Config.from_file(ROOT / config)
    cfg = cfg.replace(saving_dir=str(root / 'port'), rng=rng,
                      experiment_name=f'r{rng}')
    trainer = BDETrainer(cfg, device='cpu')
    members = trainer.train_warmstart()
    x, y = trainer.loader.arrays('test')
    _, metrics = evaluate_de(trainer.model, members, x, y, cfg.data.task,
                             n_samples=100)
    return members.numpy(), metrics['de_lppd'], metrics['de_acc']


def jax_de(config: str, rng: int, root: Path, members=None):
    """The JAX package's DE (LPPD, accuracy) of seed ``rng``: of its own
    members, or of the flat ``members`` given."""
    import jax

    from mile_tpu.config import Config as JaxConfig
    from mile_tpu.inference.evaluation import evaluate_de
    from mile_tpu.train.trainer import BDETrainer as JaxTrainer

    (cfg,) = JaxConfig.from_file(ROOT / config)
    cfg = cfg.replace(saving_dir=str(root / 'jax'), rng=rng,
                      experiment_name=f'r{rng}')
    trainer = JaxTrainer(cfg)
    params = (trainer.train_warmstart() if members is None else
              jax.vmap(trainer.bayes.unravel)(members))
    x, y = trainer.loader.arrays('test')
    _, metrics = evaluate_de(trainer.module, params, x, y, cfg.data.task,
                             n_samples=100)
    return float(metrics['de_lppd']), float(metrics['de_acc'])


def mean_se(v):
    v = np.asarray(v, dtype=np.float64)
    return float(v.mean()), float(v.std(ddof=1) / np.sqrt(len(v)))


@pytest.mark.parametrize('dataset', ['sonar', 'ionosphere'])
def test_classification_warm_starts_of_both_packages(tmp_path, dataset):
    config = f'configs/tabular_classif/{dataset}.yaml'
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    record = {'port': [], 'jax': [], 'jax_of_port_members': []}
    try:
        for rng in SEEDS:
            members, lppd, acc = port_de(config, rng, tmp_path)
            record['port'].append((float(lppd), float(acc)))
            record['jax'].append(jax_de(config, rng, tmp_path))
            record['jax_of_port_members'].append(
                jax_de(config, rng, tmp_path / 'same', members))
    finally:
        torch.set_num_threads(prev)
    summary = {k: {'lppd': mean_se([v[0] for v in rows]),
                   'acc': mean_se([v[1] for v in rows])}
               for k, rows in record.items()}
    print(json.dumps({'dataset': dataset, 'per_seed': record,
                      'summary': summary}))
    np.testing.assert_allclose(record['jax_of_port_members'],
                               record['port'], rtol=1e-4)
    (pm, pse), (jm, jse) = summary['port']['lppd'], summary['jax']['lppd']
    assert abs(pm - jm) < 3 * np.hypot(pse, jse), summary
