"""The port's report against the JAX package's: the wall times, the
diagnostics' row names, the per-parameter diagnostics, ``diagnostics.csv``
(written by each package for the same port run directory), the metrics
recomputed from a run's files, and the trainer's report, profiling and
``--no_report``.

Tolerances: per-parameter diagnostics of the same float32 draws rtol 1e-5
with atol 1e-6 of the largest value of their kind (the ranks are the same,
both sorts being stable; the FFTs and reductions run in another order);
the metrics recomputed from the files exactly as the run's (the tuned
values, read back from ``warmup_params.txt``, rtol 1e-6).
"""
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from _torch_parity import one_torch_thread  # noqa: F401

from mile_tpu.inference import metrics as jax_M
from mile_tpu.inference import reporting as jax_rep
from mile_tpu_torch.inference import metrics as M
from mile_tpu_torch.inference import reporting as rep

ROOT = Path(__file__).resolve().parents[1]
DIAG_RTOL, DIAG_ATOL = 1e-5, 1e-6


def close(ours, want, rtol=DIAG_RTOL, atol=DIAG_ATOL):
    want = np.asarray(want)
    scale = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 1.0
    np.testing.assert_allclose(ours, want, rtol=rtol, atol=atol * scale,
                               equal_nan=True)


def draws(n_chains, n_draws, dim, seed=0):
    """Continuous AR(1) chains with per-chain offsets, float32."""
    rng = np.random.default_rng(seed)
    x = np.empty((n_chains, n_draws, dim))
    x[:, 0] = rng.normal(size=(n_chains, dim))
    for i in range(1, n_draws):
        x[:, i] = 0.6 * x[:, i - 1] + rng.normal(size=(n_chains, dim))
    return (x + rng.normal(size=(n_chains, 1, dim)) * 0.3).astype(np.float32)


def test_parse_times(tmp_path):
    log = tmp_path / 'training.log'
    log.write_text('2026 INFO mile: time.warmstart took 1.2500 seconds\n'
                   'noise time.bogus took x seconds\n'
                   '2026 INFO mile: time.sampling took 0.0312 seconds\n'
                   '2026 INFO mile: time.sampling took 3.5000 seconds\n')
    assert rep.parse_times(log) == jax_rep.parse_times(log) == {
        'time.warmstart': 1.25, 'time.sampling': 3.5}
    assert rep.parse_times(tmp_path / 'absent.log') == {}


def test_measure_time_writes_what_parse_times_reads(tmp_path, caplog):
    from mile_tpu_torch.utils.timing import measure_time, timed

    with caplog.at_level('INFO'):
        with measure_time('time.warmstart'):
            pass
        timed('time.sampling')(lambda: None)()
    log = tmp_path / 'training.log'
    log.write_text(caplog.text)
    assert set(rep.parse_times(log)) == {'time.warmstart', 'time.sampling'}


def _jax_template(name):
    from mile_tpu.config import models as jax_models
    from mile_tpu.models import build_model as jax_build

    if name == 'FCN':
        module = jax_build(jax_models.FCNConfig(hidden_structure=[16, 16, 2]))
        example = jnp.zeros((1, 5))
    elif name == 'LeNet':
        module = jax_build(jax_models.LeNetConfig())
        example = jnp.zeros((1, 1, 28, 28))
    else:
        module = jax_build(jax_models.AttentionClassifierConfig(
            vocab_size=1000, context_len=70, emb_size=48, n_heads=8,
            qkv_dim=64, projection_dim=[32]))
        example = jnp.zeros((1, 70), jnp.int32)
    return module.init(jax.random.PRNGKey(0), example)['params']


def _torch_model(name):
    from mile_tpu_torch.config import models as tm
    from mile_tpu_torch.models import build_model

    if name == 'FCN':
        return build_model(tm.FCNConfig(hidden_structure=[16, 16, 2]), (5,))
    if name == 'LeNet':
        return build_model(tm.LeNetConfig(), (1, 28, 28))
    return build_model(tm.AttentionClassifierConfig(
        vocab_size=1000, context_len=70, emb_size=48, n_heads=8, qkv_dim=64,
        projection_dim=[32]), (70,))


@pytest.mark.parametrize('name', ['FCN', 'LeNet', 'AttentionClassifier'])
def test_layer_slices_match_jax(name):
    """Each leaf's name (``jax.tree_util.keystr``) and slice, in order."""
    want = jax_rep.layer_slices(_jax_template(name))
    ours = rep.layer_slices(_torch_model(name).layout)
    assert list(ours.items()) == list(want.items())


@pytest.mark.parametrize('n_draws', [7, 10, 16])
@pytest.mark.parametrize('dim', [300, 5000])
def test_per_param_diagnostics_match_jax(n_draws, dim):
    """Below 8 draws split R-hat is NaN; 10 draws are trimmed to 8; above
    4,096 coordinates the same evenly spaced ones are diagnosed."""
    x = draws(4, n_draws, dim, seed=n_draws + dim)
    want, want_coords = jax_rep.per_param_diagnostics(x)
    ours, coords = rep.per_param_diagnostics(x, device='cpu')
    np.testing.assert_array_equal(coords, want_coords)
    assert len(coords) == min(dim, 4096)
    assert set(ours) == set(want)
    for k in want:
        close(ours[k], want[k])
    assert np.isnan(ours['split_rhat']).all() == (n_draws < 8)


@pytest.mark.parametrize('n_splits', [2, 4])
def test_split_chain_r_hat_matches_jax(n_splits):
    x = draws(3, 16, 50, seed=n_splits)
    want = jax_M.split_chain_r_hat(jnp.asarray(x), n_splits)
    ours = M.split_chain_r_hat(torch.from_numpy(x), n_splits)
    assert ours.shape == (3, 50)
    close(ours.numpy(), want)


def test_constant_coordinates_rank_as_in_jax():
    """A frozen coordinate (one value in every draw) ranks in flat order in
    both packages, so its diagnostics agree too."""
    x = draws(3, 12, 6)
    x[..., 2] = 0.25
    want, _ = jax_rep.per_param_diagnostics(x)
    ours, _ = rep.per_param_diagnostics(x, device='cpu')
    for k in want:
        close(ours[k], want[k])


def test_write_diagnostics_csv_matches_jax(tmp_path):
    model = _torch_model('FCN')   # dim 5*16+16 + 16*16+16 + 16*2+2 = 402
    x = draws(3, 12, model.dim)
    rows = rep.compute_diagnostics(x, model.layout,
                                   rep.per_param_diagnostics(x, device='cpu'))
    rep.write_diagnostics_csv(tmp_path / 'ours.csv', rows)
    jax_rep.write_diagnostics_csv(tmp_path / 'jax.csv', rows)
    assert (tmp_path / 'ours.csv').read_text() == \
        (tmp_path / 'jax.csv').read_text()
    want = jax_rep.compute_diagnostics(x, _jax_template('FCN'))
    assert list(rows) == list(want)
    for name in want:
        for k in ('n_coords', 'layer_size'):
            assert rows[name][k] == want[name][k]
        close([rows[name][k] for k in ('ess', 'bcv', 'wcv', 'split_rhat')],
              [want[name][k] for k in ('ess', 'bcv', 'wcv', 'split_rhat')])


def _tiny_debug(saving_dir, **top) -> dict:
    with open(ROOT / 'configs' / 'debug.yaml') as f:
        cfg = yaml.safe_load(f)
    cfg.update(saving_dir=str(saving_dir), experiment_name='tiny', **top)
    cfg['training']['warmstart'].update(max_epochs=3)
    cfg['training']['sampler'].update(warmup_steps=60, n_samples=40,
                                      keep_warmup=True)
    return cfg


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """``BDETrainer(configs/debug.yaml, device='cpu').train()`` with its
    default report (step counts cut: 3 epochs, 60 tuner steps, 20 kept
    draws of 2 chains)."""
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = BDETrainer(Config.from_dict(_tiny_debug(
            tmp_path_factory.mktemp('report'))), device='cpu')
        return trainer, trainer.train()
    finally:
        torch.set_num_threads(prev)


def test_train_writes_the_report(run):
    trainer, metrics = run
    d = trainer.exp_dir
    for name in ('report.html', 'diagnostics.csv',
                 'warmstart/warmstart_curves.png'):
        assert (d / name).is_file(), name
    page = (d / 'report.html').read_text()
    for section in ('Wall times', 'Metrics', 'Running LPPD',
                    'Warmstart curves', 'Chain diagnostics (per layer)',
                    'Plots', 'Warmup adaptation', 'Tuned sampler'):
        assert section in page, section
    order = [page.index(s) for s in ('Wall times', 'Metrics', 'Running LPPD',
                                     'Warmstart curves', 'Chain diagnostics',
                                     'Plots', 'Tuned sampler')]
    assert order == sorted(order)
    times = rep.parse_times(d / 'training.log')
    assert set(times) == {'time.warmstart', 'time.sampling'}
    with open(d / 'metrics.pkl', 'rb') as f:
        saved = pickle.load(f)
    assert {k: saved[k] for k in times} == times
    assert np.isfinite(metrics['lppd'])


def test_diagnostics_csv_matches_jax_generate_report(run, tmp_path):
    """``mile_tpu``'s ``generate_report`` on a copy of the port's run
    directory (it reads the port's config.yaml, samples.bin and
    metrics.pkl) writes the same diagnostics.csv."""
    trainer, _ = run
    copy = tmp_path / 'jax'
    shutil.copytree(trainer.exp_dir, copy)
    (copy / 'diagnostics.csv').unlink()
    (copy / 'report.html').unlink()
    jax_rep.generate_report(copy)
    assert (copy / 'report.html').is_file()

    def rows(path):
        lines = path.read_text().splitlines()
        return lines[0], [line.split(',') for line in lines[1:]]

    head, ours = rows(trainer.exp_dir / 'diagnostics.csv')
    want_head, want = rows(copy / 'diagnostics.csv')
    assert head == want_head
    assert [r[0] for r in ours] == [r[0] for r in want]
    assert [r[5:] for r in ours] == [r[5:] for r in want]
    close(np.array([r[1:5] for r in ours], float),
          np.array([r[1:5] for r in want], float))


def test_recompute_metrics_matches_the_run(run):
    trainer, _ = run
    with open(trainer.exp_dir / 'metrics.pkl', 'rb') as f:
        saved = pickle.load(f)
    again = rep.recompute_metrics(trainer.exp_dir, device='cpu')
    for k, v in again.items():
        if k in ('step_size', 'L'):
            # read back from warmup_params.txt, whose text holds float32
            # values to their shortest repr
            np.testing.assert_allclose(v, saved[k], rtol=1e-6)
        elif isinstance(v, float):
            assert v == saved[k], k
        else:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(saved[k]))
    assert {k for k in saved if not k.startswith('time.')} == set(again)


def test_standalone_report_recomputes_metrics(run, tmp_path):
    """With no metrics.pkl, the report recomputes the metrics from the
    run's files (no trainer, no config passed) and saves them."""
    trainer, _ = run
    copy = tmp_path / 'copy'
    shutil.copytree(trainer.exp_dir, copy)
    (copy / 'metrics.pkl').unlink()
    (copy / 'report.html').unlink()
    rep.generate_report(copy, device='cpu')
    with open(copy / 'metrics.pkl', 'rb') as f:
        recomputed = pickle.load(f)
    with open(trainer.exp_dir / 'metrics.pkl', 'rb') as f:
        saved = pickle.load(f)
    assert recomputed['lppd'] == saved['lppd']
    assert recomputed['time.sampling'] == saved['time.sampling']
    assert 'lppd' in (copy / 'report.html').read_text()


def test_report_without_matplotlib(run, tmp_path, monkeypatch):
    """The report's tables and diagnostics.csv with matplotlib blocked,
    each plot logged as failed; the package imports without it."""
    env = dict(os.environ, OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-c',
         "import sys; sys.modules['matplotlib'] = None; "
         "import mile_tpu_torch, mile_tpu_torch.inference.reporting, "
         "mile_tpu_torch.viz, mile_tpu_torch.train.trainer"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]

    trainer, _ = run
    copy = tmp_path / 'copy'
    shutil.copytree(trainer.exp_dir, copy)
    for name in ('report.html', 'diagnostics.csv',
                 'warmstart/warmstart_curves.png'):
        (copy / name).unlink()
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    rep.generate_report(copy, device='cpu')
    page = (copy / 'report.html').read_text()
    assert 'Chain diagnostics (per layer)' in page and 'Wall times' in page
    assert '<h2>Plots</h2>' not in page and '<img' not in page
    assert (copy / 'diagnostics.csv').read_text() == \
        (trainer.exp_dir / 'diagnostics.csv').read_text()


def test_failed_plot_is_logged_and_report_written(run, tmp_path, monkeypatch,
                                                  caplog):
    from mile_tpu_torch import viz

    def broken(*args, **kwargs):
        raise ValueError('no projection')

    trainer, _ = run
    copy = tmp_path / 'copy'
    shutil.copytree(trainer.exp_dir, copy)
    monkeypatch.setattr(viz, 'plot_pca', broken)
    with caplog.at_level('ERROR'):
        rep.generate_report(copy, device='cpu')
    assert 'plot rendering failed' in caplog.text
    page = (copy / 'report.html').read_text()
    assert 'Chain diagnostics (per layer)' in page
    assert '<h2>Plots</h2>' not in page


def test_no_report_flag(tmp_path):
    from mile_tpu_torch.cli import main

    cfg = _tiny_debug(tmp_path)
    cfg['training']['sampler'].update(warmup_steps=30, n_samples=8)
    path = tmp_path / 'tiny.yaml'
    path.write_text(yaml.safe_dump(cfg))
    assert main(['-c', str(path), '--device', 'cpu', '--silent',
                 '--no_report']) == 0
    d = tmp_path / 'tiny'
    assert (d / 'metrics.pkl').is_file()
    assert not (d / 'report.html').exists()
    assert not (d / 'diagnostics.csv').exists()


def test_profile_writes_a_trace(tmp_path):
    """``profile: true``: a torch.profiler trace of the warm start and the
    sampling under ``exp_dir/profile`` (the report is skipped here)."""
    import json

    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    cfg = _tiny_debug(tmp_path, profile=True)
    cfg['training']['warmstart'].update(max_epochs=1)
    cfg['training']['sampler'].update(warmup_steps=20, n_samples=8)
    trainer = BDETrainer(Config.from_dict(cfg), device='cpu')
    metrics = trainer.train(report=False)
    assert np.isfinite(metrics['lppd'])
    trace = trainer.exp_dir / 'profile' / 'trace.json'
    events = json.loads(trace.read_text())['traceEvents']
    names = {e.get('name', '') for e in events}
    assert any(n.startswith('aten::') for n in names)
