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

Then sonar's ``mean_ess``: on the card the port's five seeds gave 610-672
against the JAX rows' 294-341 (every seed outside their interval), while
its ``fs_ess``, split R-hat and between- and within-chain variances lay
inside. Here both packages run their own ``sonar_mclmc_r1``-``r5`` jobs
at full counts on the CPU in exact float32, through their catalogue
runners, side by side; each is pooled by ``pool_results.py``. Printed:
each seed's pooled ``mean_ess`` and ``fs_ess`` in both packages, their
means and standard errors, and the JAX rows' interval. Held: both
packages' ``diagnostics.csv`` have the same leaf rows and coordinate
counts; the two packages' diagnostics of the same draws (the JAX run's)
agree to rtol 1e-4; the two packages' mean ``mean_ess`` lie within 3
standard errors of each other; and every seed of both lies above the
JAX rows' interval, so that the rows from the TPU, not the port, are the
outliers.

Marked ``slow`` and outside the tier-1 run: ten warm starts of up to 500
epochs a set (a few minutes), and ten full-count sonar jobs (about 15
minutes, the two packages side by side).
"""
import json
import os
import subprocess
import sys
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


def _sonar_jobs(runner: str, root: Path, env: dict) -> subprocess.Popen:
    """One package's catalogue runner over ``sonar_mclmc_r1``-``r5`` on
    the CPU (``torch_run_catalog.py`` is told so, the JAX runner is run
    with ``JAX_PLATFORMS=cpu``)."""
    cmd = [sys.executable, str(ROOT / 'experiments' / runner), '--root',
           str(root), '--only', 'tabular_classif', '--name-filter',
           r'^sonar_mclmc_r[1-5]$', '--job-timeout', '3600']
    if runner.startswith('torch_'):
        cmd += ['--device', 'cpu']
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_sonar_mean_ess_of_both_packages_at_full_counts(tmp_path):
    import pandas as pd

    sys.path.insert(0, str(ROOT / 'experiments'))
    import pool_results
    import torch_compare_study as tc

    from mile_tpu_torch.inference import reporting
    from mile_tpu_torch.train import checkpoint as ckpt

    env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='2')
    procs = {'jax': _sonar_jobs('run_catalog.py', tmp_path / 'jax', env),
             'port': _sonar_jobs('torch_run_catalog.py', tmp_path / 'port',
                                 env)}
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=5400)
        assert proc.returncode == 0, (name, out[-3000:])
    pooled = {name: pool_results.pool(tmp_path / name / 'tabular_classif')
              .set_index('experiment_name').sort_index()
              for name in procs}
    rows = pd.read_csv(ROOT / 'aggr_results' / 'aggr_tabular_classif.csv')
    rows = rows[rows['experiment_name'].str.startswith('sonar_mclmc_r')]
    _, _, lo, hi = tc.prediction_interval(rows['mean_ess'])
    record = {name: {k: df[k].tolist() for k in ('mean_ess', 'fs_ess')}
              for name, df in pooled.items()}
    summary = {name: {k: mean_se(v) for k, v in cols.items()}
               for name, cols in record.items()}
    print(json.dumps({'per_seed': record, 'summary': summary,
                      'tpu_rows': rows['mean_ess'].tolist(),
                      'tpu_interval': [lo, hi]}))

    runs = {name: tmp_path / name / 'tabular_classif' / 'sonar_mclmc_r1'
            for name in procs}
    written = {name: pd.read_csv(run / 'diagnostics.csv')
               for name, run in runs.items()}
    for key in ('layer', 'n_coords', 'layer_size'):
        assert written['jax'][key].tolist() == written['port'][key].tolist()
    assert len(written['jax']) == 6
    samples = ckpt.load_flat_samples(runs['jax'] / 'samples')
    layout = ckpt.load_layout(runs['port'] / 'samples')
    port_rows = reporting.compute_diagnostics(samples, layout, device='cpu')
    for _, row in written['jax'].iterrows():
        for key in ('ess', 'split_rhat', 'bcv', 'wcv'):
            np.testing.assert_allclose(port_rows[row['layer']][key],
                                       row[key], rtol=1e-4)

    (pm, pse), (jm, jse) = (summary[n]['mean_ess'] for n in ('port', 'jax'))
    assert abs(pm - jm) < 3 * np.hypot(pse, jse), summary
    for name in procs:
        assert min(record[name]['mean_ess']) > hi, (name, record, hi)
