"""Multi-process runs of the port on the CPU, and the orbax-format
checkpoints on ``torch.distributed.checkpoint`` (DCP).

Two gloo processes with 4 CPU entries each (``tests/
_torch_distributed_worker.py``) against one process with 8, the
counterpart of ``tests/test_distributed.py``: the draws equal, the DCP
round trip written by both ranks equals them, the in-step check raises on
ranks whose arrays differ, and the trainer over both ranks equals the
trainer in one process, with one experiment directory. Then the
counterparts of ``tests/test_orbax_checkpoint.py``: a round trip, the
latest step, a step written over, the trainer's ``checkpoint_format:
orbax`` and its reuse, and the directory the JAX package's orbax writes,
which the port refuses with a ``ValueError`` naming it.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from _torch_distributed_workload import run_chains, trainer_config
from _torch_parity import one_torch_thread  # noqa: F401

from mile_tpu.train.checkpoint_orbax import load_ensemble as jax_load
from mile_tpu.train.checkpoint_orbax import save_ensemble as jax_save
from mile_tpu_torch.parallel.mesh import chain_mesh
from mile_tpu_torch.train.checkpoint_orbax import load_ensemble, save_ensemble

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def two_processes(tmp_path_factory):
    """The worker's results (written by rank 0) and the output dir."""
    out = tmp_path_factory.mktemp('dist')
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('MASTER_ADDR', None)
    workers = [subprocess.Popen(
        [sys.executable, str(ROOT / 'tests' / '_torch_distributed_worker.py'),
         str(rank), '2', str(port), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    logs = []
    try:
        for w in workers:
            logs.append(w.communicate(timeout=240)[0])
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    for rank, (w, log) in enumerate(zip(workers, logs)):
        assert w.returncode == 0, f'rank {rank} failed:\n{log[-4000:]}'
        assert f'rank {rank} ok' in log
    with np.load(out / 'distributed.npz') as d:
        return dict(d), out


def test_two_gloo_processes_equal_one_process(two_processes):
    """``run_mclmc`` over a mesh of 2 ranks x 4 CPU entries gives the draws
    of one process's mesh of 8 entries bit for bit (each entry computes
    the same rows either way, and every rank runs the tuner and the
    sampler on the gathered values)."""
    got, _ = two_processes
    want = run_chains(chain_mesh(devices=['cpu'] * 8))
    np.testing.assert_array_equal(got['samples'], want.samples)
    assert got['samples'].shape == (8, 12, want.samples.shape[2])
    assert np.isfinite(got['samples']).all()


def test_dcp_round_trip_across_processes(two_processes):
    """Both ranks wrote the checkpoint together and read it back equal
    (checked in each worker); rank 0's copy equals the draws."""
    got, out = two_processes
    np.testing.assert_array_equal(got['restored'], got['samples'])
    assert (out / 'dcp' / 'step_0' / '.metadata').is_file()
    restored = load_ensemble(out / 'dcp')   # and in this one process
    np.testing.assert_array_equal(restored['draws']['positions'].numpy(),
                                  got['samples'])


def test_trainer_across_processes_equals_one_process(two_processes,
                                                     tmp_path):
    """The trainer over 2 ranks x 2 CPU entries: one experiment directory
    (made by rank 0, its path broadcast), the warm start computed by rank
    0 and broadcast, draws and LPPD equal to the trainer in one process
    over 4 entries."""
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    got, out = two_processes
    assert list(got['exp_dirs']) == ['dist']
    exp = out / 'runs' / 'dist'
    for name in ('metrics.pkl', 'warmup_params.txt', 'samples/info.pkl',
                 'warmstart/params_3.npz', 'samples/chain_3/samples.bin'):
        assert (exp / name).is_file(), name
    trainer = BDETrainer(Config.from_dict(trainer_config(tmp_path)),
                         devices=['cpu'] * 4)
    members = trainer.train_warmstart()
    result = trainer.start_sampling(members)
    metrics = trainer.evaluate(members, result)
    np.testing.assert_array_equal(got['trainer_samples'], result.samples)
    assert float(got['lppd']) == metrics['lppd']


# ---------------------------------------------------------------- DCP
def _params(n_members=8):
    rng = np.random.default_rng(0)
    return {'layer0': {'kernel': rng.normal(size=(n_members, 5, 16))
                       .astype(np.float32),
                       'bias': np.zeros((n_members, 16), np.float32)},
            'layer1': {'kernel': torch.ones(n_members, 16, 2)},
            'step': np.int64(3)}


def _assert_equal_trees(got, want):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            _assert_equal_trees(got[key], want[key])
        else:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]))


def test_dcp_round_trip(tmp_path):
    params = _params()
    path = save_ensemble(tmp_path / 'ckpt', params, step=3)
    assert path == (tmp_path / 'ckpt' / 'step_3').absolute()
    restored = load_ensemble(tmp_path / 'ckpt')
    _assert_equal_trees(restored, params)
    assert restored['layer0']['kernel'].dtype == torch.float32
    assert restored['step'].dtype == torch.int64


def test_dcp_latest_step_selected_and_a_step_written_over(tmp_path):
    params = _params()
    save_ensemble(tmp_path / 'ckpt', params, step=1)
    bumped = {**params, 'layer1': {'kernel': torch.full((8, 16, 2), 2.0)}}
    save_ensemble(tmp_path / 'ckpt', bumped, step=2)
    _assert_equal_trees(load_ensemble(tmp_path / 'ckpt'), bumped)
    _assert_equal_trees(load_ensemble(tmp_path / 'ckpt', step=1), params)
    save_ensemble(tmp_path / 'ckpt', params, step=2)
    _assert_equal_trees(load_ensemble(tmp_path / 'ckpt'), params)
    assert sorted(p.name for p in (tmp_path / 'ckpt').iterdir()) == [
        'step_1', 'step_2']
    template = {'layer1': {'kernel': torch.empty(8, 16, 2)}}
    with pytest.raises(FileNotFoundError):
        load_ensemble(tmp_path / 'none')
    assert load_ensemble(tmp_path / 'ckpt', template=template)[
        'layer1']['kernel'].shape == (8, 16, 2)


def _jax_orbax_dir(path: Path) -> None:
    """An ensemble written by the JAX package's orbax checkpointer."""
    jax_save(path, {'layer0': {'kernel': jnp.ones((2, 3))}}, step=0)


def test_jax_written_orbax_directory_raises(tmp_path):
    """The JAX package's orbax directory has no DCP metadata: loading it,
    directly or as a trainer's ``warmstart_exp_dir``, raises a
    ``ValueError`` that says which package wrote it."""
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    _jax_orbax_dir(tmp_path / 'jax_run' / 'warmstart' / 'orbax')
    assert jax_load(tmp_path / 'jax_run' / 'warmstart' / 'orbax')
    with pytest.raises(ValueError, match='written by the JAX package'):
        load_ensemble(tmp_path / 'jax_run' / 'warmstart' / 'orbax')
    cfg = trainer_config(tmp_path / 'res')
    cfg['training']['warmstart']['warmstart_exp_dir'] = str(
        tmp_path / 'jax_run')
    trainer = BDETrainer(Config.from_dict(cfg), device='cpu')
    with pytest.raises(ValueError, match='cannot read'):
        trainer.train_warmstart()


def test_trainer_orbax_format_round_trip(tmp_path):
    """``checkpoint_format: orbax`` writes ``warmstart/orbax/`` and a
    second experiment reuses it (its npz members removed, so the reuse has
    to go through DCP): the same members, hence the same LPPD."""
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    cfg = trainer_config(tmp_path / 'res')
    cfg['training']['checkpoint_format'] = 'orbax'
    first = BDETrainer(Config.from_dict(cfg), device='cpu')
    metrics = first.train(report=False)
    assert (first.warmstart_dir / 'orbax/step_0/.metadata').is_file()
    for path in first.warmstart_dir.glob('params_*.npz'):
        path.unlink()
    reuse = yaml.safe_load(yaml.safe_dump(cfg))
    reuse['experiment_name'] = 'reuse'
    reuse['training']['warmstart']['warmstart_exp_dir'] = str(first.exp_dir)
    second = BDETrainer(Config.from_dict(reuse), device='cpu')
    metrics2 = second.train(report=False)
    assert np.isfinite(metrics['lppd'])
    assert metrics2['lppd'] == metrics['lppd']
