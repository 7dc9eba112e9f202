"""The port end to end on the CPU: its CLI and trainer write the JAX
package's artifacts (the draws through the native sink), which the JAX
package reads back, for MCLMC, NUTS and HMC; its entry points refuse to run
without a GPU unless asked for the CPU; and it imports nothing of JAX."""
import ast
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from _torch_parity import jax_airfoil, one_torch_thread  # noqa: F401
from jax.flatten_util import ravel_pytree

from mile_tpu.mcmc import hmc as jax_hmc
from mile_tpu.mcmc import nuts as jax_nuts
from mile_tpu.train import checkpoint as jax_ckpt

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / 'mile_tpu_torch'


def tiny_config(saving_dir, config='illustrative_airfoil_mclmc.yaml',
                **sampler) -> dict:
    with open(ROOT / 'configs' / config) as f:
        cfg = yaml.safe_load(f)
    cfg['saving_dir'] = str(saving_dir)
    cfg['experiment_name'] = 'tiny'
    cfg['training']['warmstart'].update(max_epochs=2, batch_size=256)
    cfg['training']['sampler'].update(
        dict(n_chains=2, warmup_steps=30, n_samples=24, n_thinning=3),
        **sampler)
    return cfg


@pytest.fixture(scope='module')
def cli_run(tmp_path_factory):
    """``python -m mile_tpu_torch --device cpu`` on a tiny airfoil run."""
    tmp = tmp_path_factory.mktemp('cli')
    path = tmp / 'tiny.yaml'
    path.write_text(yaml.safe_dump(tiny_config(tmp / 'results')))
    env = dict(os.environ, OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'mile_tpu_torch', '-c', str(path),
         '--device', 'cpu', '--silent'],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return tmp / 'results' / 'tiny'


def test_cli_writes_the_artifacts(cli_run):
    for name in ('config.yaml', 'training.log', 'metrics.pkl',
                 'warmup_params.txt', 'warmstart/metrics.pkl',
                 'warmstart/params_0.npz', 'warmstart/params_1.npz',
                 'warmstart/layout.json', 'samples/layout.json',
                 'samples/info.pkl', 'samples/chain_0/samples.bin',
                 'samples/chain_0/samples.meta',
                 'samples/chain_1/samples.bin'):
        assert (cli_run / name).is_file(), name
    with open(cli_run / 'metrics.pkl', 'rb') as f:
        metrics = pickle.load(f)
    for key in ('lppd', 'rmse', 'de_lppd', 'de_rmse', 'cal_error'):
        assert np.isfinite(metrics[key]), key
    with open(cli_run / 'samples/info.pkl', 'rb') as f:
        info = pickle.load(f)
    assert info['energy_change'].shape == (2, 8)
    assert info['step_size'].shape == (2,)


def test_jax_package_reads_the_artifacts(cli_run):
    """``load_flat_samples`` reads the draws, ``load_warmup_params`` the
    tuned values, and the ``leaf_{k}`` entries of a member unflatten with
    the JAX treedef to the same flat vector."""
    samples = jax_ckpt.load_flat_samples(cli_run / 'samples')
    assert samples.shape == (2, 8, 674) and np.isfinite(samples).all()
    step_size, L = jax_ckpt.load_warmup_params(cli_run / 'warmup_params.txt')
    with open(cli_run / 'samples/info.pkl', 'rb') as f:
        info = pickle.load(f)
    np.testing.assert_allclose(step_size, info['step_size'], rtol=1e-6)
    np.testing.assert_allclose(L, info['L'], rtol=1e-6)

    _, _, template, _ = jax_airfoil()
    treedef = jax.tree.structure(template)
    with np.load(cli_run / 'warmstart/params_1.npz') as data:
        leaves = [data[f'leaf_{i}'] for i in range(len(data.files))]
    tree = jax.tree.unflatten(treedef, leaves)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, template)
    flat = np.asarray(ravel_pytree(tree)[0])
    assert flat.shape == (674,) and np.isfinite(flat).all()
    assert np.abs(flat).max() > 0


@pytest.fixture(scope='module', params=['nuts', 'hmc'])
def hmc_family_run(request, tmp_path_factory):
    """``BDETrainer`` on ``illustrative_airfoil_nuts.yaml`` (and the same
    config with ``name: hmc``) on the CPU, at full width and tree depth 10,
    with the step counts cut: 2 chains, 20 adaptation steps, 4 draws."""
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    cfg = tiny_config(tmp_path_factory.mktemp(request.param),
                      'illustrative_airfoil_nuts.yaml', name=request.param,
                      n_chains=2, warmup_steps=20, n_samples=4, n_thinning=1)
    trainer = BDETrainer(Config.from_dict(cfg), device='cpu')
    # one torch thread, as every test here (the autouse fixture is
    # function-scoped and does not cover this one)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return request.param, trainer, trainer.train(report=False)
    finally:
        torch.set_num_threads(prev)


def test_hmc_family_draws_reach_the_jax_package(hmc_family_run):
    """The draws stream through the native sink into ``samples.bin``, which
    the JAX package's ``load_flat_samples`` reads; no ``samples.npy``, and
    no ``warmup_params.txt`` (MCLMC only)."""
    _, trainer, _ = hmc_family_run
    samples = jax_ckpt.load_flat_samples(trainer.samples_dir)
    assert samples.shape == (2, 4, 674) and np.isfinite(samples).all()
    assert trainer.sink.native and trainer.sink.rows_written == 4
    assert (trainer.samples_dir / 'chain_1/samples.bin').is_file()
    assert not list(trainer.samples_dir.rglob('samples.npy'))
    assert not (trainer.exp_dir / 'warmup_params.txt').exists()


def test_hmc_family_info_and_metrics(hmc_family_run):
    """``info.pkl`` holds the JAX trainer's keys for the sampler (its info
    fields and the tuned values); the metrics are finite."""
    name, trainer, metrics = hmc_family_run
    fields = (jax_nuts.NUTSInfo if name == 'nuts' else jax_hmc.HMCInfo)._fields
    with open(trainer.samples_dir / 'info.pkl', 'rb') as f:
        info = pickle.load(f)
    assert set(info) == set(fields) | {
        'step_size', 'inverse_mass_matrix', 'bracketed_step_size',
        'final_buffer_acceptance'}
    assert info['acceptance_rate'].shape == (2, 4)
    assert info['inverse_mass_matrix'].shape == (2, 674)
    for key in ('lppd', 'rmse', 'de_lppd', 'de_rmse', 'cal_error'):
        assert np.isfinite(metrics[key]), key
    assert metrics['L'] is None and metrics['step_size'].shape == (2,)


def test_entry_points_refuse_to_run_without_a_gpu(monkeypatch, tmp_path):
    from mile_tpu_torch.cli import main
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    config = Config.from_dict(tiny_config(tmp_path))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        BDETrainer(config)
    path = tmp_path / 'tiny.yaml'
    path.write_text(yaml.safe_dump(tiny_config(tmp_path)))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        main(['-c', str(path), '--silent'])


@pytest.mark.parametrize('feature', ['data_sharding', 'orbax_format',
                                     'orbax_warmstart'])
def test_features_once_refused_now_run(feature, tmp_path):
    """The three configs the port refused until it had a mesh and the
    orbax format: ``data_sharding: 2`` samples over a chains x data mesh
    of CPU entries; ``checkpoint_format: orbax`` writes the ensemble as a
    ``torch.distributed.checkpoint`` beside the npz members; a
    ``warmstart_exp_dir`` holding such a ``warmstart/orbax/`` (and no npz
    members) is reused bit for bit."""
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.checkpoint_orbax import load_ensemble
    from mile_tpu_torch.train.trainer import BDETrainer

    update = {'data_sharding': {'training.sampler.data_sharding': 2}}.get(
        feature, {'training.checkpoint_format': 'orbax'})
    config = Config.from_dict(tiny_config(tmp_path)).replace(**update)
    trainer = BDETrainer(config, device='cpu', n_devices=8)
    if feature == 'data_sharding':
        assert trainer.mesh.shape == {'chains': 2, 'data': 2}
        metrics = trainer.train(report=False)
        assert np.isfinite(metrics['lppd'])
        samples = jax_ckpt.load_flat_samples(trainer.samples_dir)
        assert samples.shape == (2, 8, 674) and np.isfinite(samples).all()
        return
    members = trainer.train_warmstart()
    saved = load_ensemble(trainer.warmstart_dir / 'orbax')['members']
    assert (trainer.warmstart_dir / 'orbax/step_0/.metadata').is_file()
    assert torch.equal(saved, members)
    if feature == 'orbax_warmstart':
        for path in trainer.warmstart_dir.glob('params_*.npz'):
            path.unlink()
        reuse = config.replace(**{
            'experiment_name': 'reuse',
            'training.warmstart.warmstart_exp_dir': str(trainer.exp_dir)})
        second = BDETrainer(reuse, device='cpu')
        assert torch.equal(second.train_warmstart(), members)
        assert (second.warmstart_dir / 'params_1.npz').is_file()


def test_a_report_that_raises_is_logged(tmp_path, monkeypatch, caplog):
    """A report that raises is logged by the trainer, which still returns
    its metrics (as the JAX trainer does)."""
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.inference import reporting
    from mile_tpu_torch.train.trainer import BDETrainer

    def broken(*args, **kwargs):
        raise RuntimeError('report broke')

    monkeypatch.setattr(reporting, 'generate_report', broken)
    trainer = BDETrainer(Config.from_dict(tiny_config(tmp_path)), 'cpu')
    with caplog.at_level('ERROR'):
        metrics = trainer.train(report=True)
    assert np.isfinite(metrics['lppd'])
    assert 'report generation failed' in caplog.text
    assert 'report broke' in caplog.text
    assert not (trainer.exp_dir / 'report.html').exists()


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, 'id', None) == '__import__'
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_no_mile_tpu():
    """Read every module of the port, chip_smoke.py, bench_torch.py and
    the port's experiment scripts as source: no import of jax, flax, optax
    or mile_tpu anywhere, at any depth."""
    files = (sorted(PACKAGE.rglob('*.py'))
             + [ROOT / 'chip_smoke.py', ROOT / 'bench_torch.py']
             + sorted((ROOT / 'experiments').glob('torch_*.py')))
    assert ROOT / 'experiments' / 'torch_symmetric_splitting.py' in files
    for script in ('torch_run_catalog.py', 'torch_dtype_ab_widefcn.py',
                   'torch_time_warmup.py', 'torch_profile_nuts.py',
                   'torch_catalog_queue.py', 'torch_compare_study.py',
                   'torch_tune_members.py', 'torch_kernel_times.py',
                   'torch_nuts_members.py'):
        assert ROOT / 'experiments' / script in files
    assert PACKAGE / 'mcmc' / 'split_hmc.py' in files
    assert PACKAGE / 'utils' / 'card.py' in files
    for name in ('parallel/__init__.py', 'parallel/mesh.py',
                 'parallel/distributed.py', 'bayes/sharded.py',
                 'train/checkpoint_orbax.py'):
        assert PACKAGE / name in files
    assert len(files) > 30
    banned = ('jax', 'jaxlib', 'flax', 'optax', 'mile_tpu')
    for path in files:
        for name in _imports(ast.parse(path.read_text(), str(path))):
            root = name.split('.')[0]
            assert root not in banned, f'{path}: imports {name}'
