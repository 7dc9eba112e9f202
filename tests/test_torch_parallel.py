"""The port's device mesh against the JAX package's, on the CPU.

The JAX side runs on the suite's 8 fake CPU devices; the port's mesh is a
grid of repeated ``'cpu'`` entries. The count functions equal JAX's; the
log-posterior sharded over a chains x data mesh equals JAX's on
``tests/test_data_sharding.py``'s workload (FCN [8, 2] on 200 rows, and
203 rows, which JAX replicates and the port splits unevenly); MCLMC on a
2-D mesh matches a 1-D mesh and no mesh (the 1-D mesh bit for bit); the
partition density on a mesh matches no mesh; the trainer pads 13 chains
over 8 entries and drops the pad chains everywhere, and runs
``data_sharding: 2`` end to end; the CLI takes ``--devices``,
``--device_limit``, ``--multihost`` and ``--outer_parallel``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from _torch_distributed_workload import posterior
from _torch_parity import one_torch_thread  # noqa: F401

from mile_tpu.parallel import mesh as jax_mesh
from mile_tpu_torch.bayes import partition as part
from mile_tpu_torch.bayes.posterior import value_and_grad
from mile_tpu_torch.config import SamplerConfig
from mile_tpu_torch.parallel.mesh import (
    chain_data_mesh,
    chain_mesh,
    local_devices,
    padded_chain_count,
    pick_chain_device_count,
    split_bounds,
)
from mile_tpu_torch.train.sampling import run_mclmc

CPU8 = ['cpu'] * 8


def test_count_functions_equal_jax():
    """Every (chains 1-64, devices 1-16) pair, in one loop."""
    for n_chains in range(1, 65):
        for n_dev in range(1, 17):
            assert pick_chain_device_count(n_chains, n_dev, quiet=True) \
                == jax_mesh.pick_chain_device_count(n_chains, n_dev,
                                                    quiet=True), (n_chains,
                                                                  n_dev)
            assert padded_chain_count(n_chains, n_dev) \
                == jax_mesh.padded_chain_count(n_chains, n_dev), (n_chains,
                                                                  n_dev)


def test_the_idle_devices_warning_is_kept(caplog):
    with caplog.at_level('WARNING'):
        assert pick_chain_device_count(13, 8) == 1
    assert '13 chains do not divide over 8 devices; using 1 device(s), ' \
        '7 idle' in caplog.text


def test_mesh_shapes_and_entries():
    mesh = chain_data_mesh(4, 2, CPU8)
    assert mesh.axis_names == ('chains', 'data')
    assert mesh.shape == {'chains': 4, 'data': 2} and mesh.size == 8
    assert mesh.first == torch.device('cpu') and mesh.is_primary
    assert chain_mesh(3, CPU8).shape == {'chains': 3}
    assert chain_mesh(devices=['cpu'] * 2).size == 2
    with pytest.raises(ValueError, match='needs 10 devices'):
        chain_data_mesh(5, 2, CPU8)
    assert split_bounds(13, 8) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10),
                                   (10, 11), (11, 12), (12, 13)]
    assert split_bounds(2, 3) == [(0, 1), (1, 2), (2, 2)]


def test_asking_for_more_cuda_devices_than_visible_raises(monkeypatch):
    """JAX's ``chain_mesh`` silently takes fewer devices; the port
    raises."""
    assert local_devices('cpu', 3) == [torch.device('cpu')] * 3
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, 'is_available', lambda: False)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            chain_mesh()     # the default entries are the GPUs
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert local_devices('cuda') == [torch.device('cuda', 0)]
    assert chain_mesh().first == torch.device('cuda', 0)
    with pytest.raises(RuntimeError, match='2 CUDA device'):
        local_devices('cuda', 2)
    with pytest.raises(RuntimeError, match='from cuda:1'):
        local_devices('cuda:1')


def _jax_workload(n_obs):
    from mile_tpu.bayes import BayesianModel, Prior
    from mile_tpu.config import FCNConfig, PriorDist, Task
    from mile_tpu.models import build_model

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n_obs, 5)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(n_obs,)), jnp.float32)
    module = build_model(FCNConfig(hidden_structure=[8, 2]))
    template = module.init(jax.random.PRNGKey(0), x[:1])['params']
    bayes = BayesianModel(module, template,
                          Prior.from_name(PriorDist.STANDARD_NORMAL),
                          Task.REGRESSION)
    return bayes, x, y


@pytest.mark.parametrize('n_obs', [200, 203])
def test_sharded_value_and_grad_match_jax(n_obs):
    """8 chains on a 4 x 2 chains x data mesh against JAX's value and
    gradient on ``chain_data_mesh(4, 2)`` (203 rows: JAX replicates them,
    the port splits them 102 + 101): value rtol 1e-5, gradient rtol 1e-4
    / atol 1e-6, the tolerances of ``tests/test_data_sharding.py``."""
    jbayes, jx, jy = _jax_workload(n_obs)
    mesh = jax_mesh.chain_data_mesh(4, 2)
    xs, ys = jax_mesh.shard_data((jx, jy), mesh)
    vg = jax.jit(jax.vmap(jax.value_and_grad(jbayes.logdensity_fn(xs, ys))))
    theta = 0.05 * np.arange(jbayes.dim, dtype=np.float32) \
        + 0.3 * np.random.default_rng(1).normal(
            size=(8, jbayes.dim)).astype(np.float32)
    want_v, want_g = (np.asarray(a) for a in vg(jnp.asarray(theta)))

    bayes, _, _ = posterior()
    x, y = (torch.from_numpy(np.array(a)) for a in (jx, jy))
    port = bayes.logdensity_and_grad_fn(x, y, chain_data_mesh(4, 2, CPU8))
    value, grad = port(torch.from_numpy(theta))
    np.testing.assert_allclose(value.numpy(), want_v, rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), want_g, rtol=1e-4, atol=1e-6)


def test_one_entry_mesh_is_no_mesh_and_chain_split_is_exact():
    """A one-entry mesh gives the plain density; splitting only the chain
    rows (13 over 8 entries, uneven) changes no bit on the CPU."""
    bayes, x, y = posterior()
    theta = torch.from_numpy(0.3 * np.random.default_rng(3).normal(
        size=(13, bayes.dim)).astype(np.float32))
    want = bayes.logdensity_and_grad_fn(x, y)(theta)
    for mesh in (chain_mesh(1, CPU8), chain_mesh(8, CPU8)):
        got = bayes.logdensity_and_grad_fn(x, y, mesh)(theta)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _mclmc(mesh, warmup_steps=30, n_samples=10):
    bayes, x, y = posterior()
    init = torch.from_numpy(0.1 * np.random.default_rng(2).normal(
        size=(4, bayes.dim)).astype(np.float32))
    cfg = SamplerConfig(warmup_steps=warmup_steps, n_chains=4,
                        n_samples=n_samples, step_size_init=0.01)
    return run_mclmc(bayes.logdensity_and_grad_fn(x, y, mesh), cfg,
                     torch.Generator().manual_seed(1), init, mesh=mesh)


def test_run_mclmc_on_a_2d_mesh_matches_1d_and_no_mesh():
    """``run_mclmc`` on a 4 x 2 mesh against a 4-entry chain mesh and no
    mesh. The refresh noise is the same stream in all three runs (keyed by
    the seed and the step), so none is injected.

    - The chain mesh alone changes no bit, the tuner included.
    - The 2-D mesh sums each chain's log-likelihood in two halves, which
      rounds differently in float32. The tuner reads ΔE at ε = 0.01, where
      that rounding is most of ΔE, and amplifies it (tuned ε apart by up to
      30 % after 30 steps; JAX's 2-D and 1-D runs are bit-identical on the
      CPU, so its test never meets this). So the draws are held at
      ``tests/test_data_sharding.py``'s tolerance (rtol 5e-3, atol 5e-4)
      with the tuner cut to one step and 30 draws at the initial ε; with
      the full 30-step tuner the 2-D run is held to finite draws and
      positive ε."""
    for warmup_steps, n_samples in ((1, 30), (30, 10)):
        plain = _mclmc(None, warmup_steps, n_samples)
        one_d = _mclmc(chain_mesh(4, CPU8), warmup_steps, n_samples)
        two_d = _mclmc(chain_data_mesh(4, 2, CPU8), warmup_steps, n_samples)
        np.testing.assert_array_equal(one_d.samples, plain.samples)
        np.testing.assert_array_equal(one_d.tuned['step_size'],
                                      plain.tuned['step_size'])
        assert np.isfinite(two_d.samples).all()
        assert (two_d.tuned['step_size'] > 0).all()
        if warmup_steps == 1:
            np.testing.assert_allclose(two_d.samples, one_d.samples,
                                       rtol=5e-3, atol=5e-4)


def test_partition_density_on_a_mesh_matches_no_mesh():
    """The partitioned density differentiates through the index copy into
    the sharded full-dim density: its value and subspace gradient on a
    4 x 2 mesh equal no mesh's (value rtol 1e-5, gradient rtol 1e-4 /
    atol 1e-6)."""
    bayes, x, y = posterior()
    mask = part.partition_mask(bayes.model.layout)
    base = torch.from_numpy(0.3 * np.random.default_rng(4).normal(
        size=(6, bayes.dim)).astype(np.float32))
    z = part.split(base, mask) + 0.1
    results = [value_and_grad(part.make_partitioned_logdensity(
        bayes.logdensity_fn(x, y, mesh), mask, base))(z)
        for mesh in (None, chain_data_mesh(4, 2, CPU8))]
    (v0, g0), (v1, g1) = results
    assert g1.shape == z.shape
    np.testing.assert_allclose(v1.numpy(), v0.numpy(), rtol=1e-5)
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------- trainer
def _trainer_config(tmp_path, n_chains, **sampler):
    from mile_tpu_torch.config import Config

    with open('configs/illustrative_airfoil_mclmc.yaml') as f:
        cfg = yaml.safe_load(f)
    cfg.update(saving_dir=str(tmp_path), experiment_name='pad')
    cfg['data'].update(datapoint_limit=120)
    cfg['model']['hidden_structure'] = [4, 2]
    cfg['training']['warmstart'].update(max_epochs=2, batch_size=32)
    cfg['training']['sampler'].update(n_chains=n_chains, warmup_steps=20,
                                      n_samples=6, n_thinning=1, **sampler)
    return Config.from_dict(cfg)


def test_trainer_pads_thirteen_chains_over_eight_entries(tmp_path):
    """The counterpart of ``tests/test_chain_padding.py``: the divisor mesh
    has 1 entry, the sampling mesh 8, and sampling runs 16 chains (2 an
    entry); the 3 pad chains are gone from the draws, the tuned values,
    the final state, the per-draw statistics and the sink's files."""
    from mile_tpu_torch.train.checkpoint import load_flat_samples
    from mile_tpu_torch.train.trainer import BDETrainer

    trainer = BDETrainer(_trainer_config(tmp_path, 13), devices=CPU8)
    assert trainer.mesh.size == 1
    assert trainer._pad_chains == 3
    assert trainer._sampling_mesh.size == 8
    members = trainer.train_warmstart()
    result = trainer.start_sampling(members)
    assert result.samples.shape[:2] == (13, 6)
    assert np.isfinite(result.samples).all()
    for value in (*result.tuned.values(), *result.info.values(),
                  *result.final_state):
        assert value.shape[0] == 13
    assert len(list(trainer.samples_dir.glob('chain_*'))) == 13
    on_disk = load_flat_samples(trainer.samples_dir)
    np.testing.assert_array_equal(on_disk, result.samples)
    metrics = trainer.evaluate(members, result)
    assert np.isfinite(metrics['lppd'])


def test_trainer_data_sharding_end_to_end(tmp_path):
    """The counterpart of ``tests/test_data_sharding.py``'s trainer test:
    4 chains with ``data_sharding: 2`` over 8 entries build a 4 x 2 mesh
    and sample finite draws of every chain, on disk too."""
    from mile_tpu_torch.train.checkpoint import load_flat_samples
    from mile_tpu_torch.train.trainer import BDETrainer

    config = _trainer_config(tmp_path, 4, data_sharding=2)
    trainer = BDETrainer(config, devices=CPU8)
    assert trainer.mesh.axis_names == ('chains', 'data')
    assert trainer.mesh.shape == {'chains': 4, 'data': 2}
    assert trainer._pad_chains == 0
    result = trainer.start_sampling(trainer.train_warmstart())
    assert result.samples.shape[:2] == (4, 6)
    assert np.isfinite(result.samples).all()
    np.testing.assert_array_equal(load_flat_samples(trainer.samples_dir),
                                  result.samples)


# ------------------------------------------------------------ warm start
def _warm_start(mesh, partition=False, n_members=6):
    """``train_ensemble`` on the airfoil loader (FCN [16, 16, 2], or the
    partition warm start of a PartitionFCN [8, 8, 8, 2]), AdamW at
    learning rate 0.1, 4 epochs of batch 32 with early stopping at
    patience 1 (so that some members stop before others), over
    ``mesh``."""
    from mile_tpu_torch.config.data import DataConfig, Task
    from mile_tpu_torch.config.models import FCNConfig, PartitionFCNConfig
    from mile_tpu_torch.config.training import WarmstartConfig
    from mile_tpu_torch.data import build_loader
    from mile_tpu_torch.models import build_model
    from mile_tpu_torch.train.warmstart import train_ensemble
    from mile_tpu_torch.utils.keys import experiment_keys

    loader = build_loader(
        DataConfig(path='data/airfoil.data', task=Task.REGRESSION,
                   datapoint_limit=300, train_split=0.7, valid_split=0.1,
                   test_split=0.2), experiment_keys(0).loader, 'cpu')
    hidden = [8, 8, 8, 2] if partition else [16, 16, 2]
    model_cfg = (PartitionFCNConfig if partition else FCNConfig)(
        hidden_structure=hidden)
    model = build_model(model_cfg, loader.input_shape)
    cfg = WarmstartConfig.from_dict({
        'max_epochs': 4, 'batch_size': 32, 'patience': 1,
        'partition_warmstart': partition,
        'optimizer_config': {'name': 'adamw', 'parameters': {
            'learning_rate': 0.1, 'weight_decay': 0.001}}})
    return train_ensemble(model, loader, cfg, Task.REGRESSION, n_members,
                          torch.Generator().manual_seed(3), mesh=mesh)


@pytest.mark.parametrize('case', ['fcn', 'partition', 'chains x data',
                                  'more entries than members'])
def test_warm_start_on_a_mesh_is_bitwise_one_device(case):
    """The warm start's forward and backward passes split by rows of
    members over a 4-entry chain mesh (a 2 x 2 chains x data mesh: the
    data axis is not split; 8 entries for 6 members: two hold none) equal
    one device's bit for bit: the members, and every metric of the
    store."""
    mesh = {'fcn': chain_mesh(4, ['cpu'] * 4),
            'partition': chain_mesh(4, ['cpu'] * 4),
            'chains x data': chain_data_mesh(2, 2, ['cpu'] * 4),
            'more entries than members': chain_mesh(8, CPU8)}[case]
    partition = case == 'partition'
    want, want_store = _warm_start(None, partition)
    got, store = _warm_start(mesh, partition)
    assert torch.equal(got, want)
    for split in ('train', 'valid', 'test'):
        a, b = getattr(store, split), getattr(want_store, split)
        for name, value in dataclasses.asdict(a).items():
            np.testing.assert_array_equal(value, getattr(b, name),
                                          err_msg=f'{split}.{name}')
    stopped = np.isnan(want_store.train.nlll[:, -1])
    assert stopped.any() and not stopped.all()


def test_trainer_warm_start_runs_over_its_mesh(tmp_path, monkeypatch):
    """``BDETrainer(devices=['cpu'] * 4)`` with 4 chains passes its divisor
    mesh of 4 entries to the warm start, whose members equal a one-device
    trainer's bit for bit."""
    from mile_tpu_torch.train import trainer as trainer_mod

    seen = []
    real = trainer_mod.train_ensemble

    def spy(*args, **kwargs):
        seen.append(kwargs.get('mesh'))
        return real(*args, **kwargs)

    monkeypatch.setattr(trainer_mod, 'train_ensemble', spy)
    on_mesh = trainer_mod.BDETrainer(_trainer_config(tmp_path / 'a', 4),
                                     devices=['cpu'] * 4)
    members = on_mesh.train_warmstart()
    alone = trainer_mod.BDETrainer(_trainer_config(tmp_path / 'b', 4),
                                   device='cpu')
    assert torch.equal(members, alone.train_warmstart())
    assert seen[0] is on_mesh.mesh and seen[0].shape == {'chains': 4}
    assert seen[1].size == 1


# ------------------------------------------------------------------- CLI
def _config_file(tmp_path, **sampler) -> str:
    path = tmp_path / 'tiny.yaml'
    path.write_text(yaml.safe_dump(_trainer_config(
        tmp_path / 'results', 2, **sampler).to_dict()))
    return str(path)


@pytest.fixture
def capture_runs(monkeypatch):
    from mile_tpu_torch import cli

    runs = []
    monkeypatch.setattr(cli, '_run_one', lambda *job: runs.append(job))
    return runs


def test_cli_runs_on_two_cpu_devices(tmp_path):
    """``--device cpu --devices 2``: the experiment samples over a chain
    mesh of 2 CPU entries and writes its metrics."""
    from mile_tpu_torch.cli import main

    assert main(['-c', _config_file(tmp_path), '--device', 'cpu',
                 '--devices', '2', '--no_report', '--silent']) == 0
    assert (tmp_path / 'results' / 'pad' / 'metrics.pkl').is_file()
    log = (tmp_path / 'results' / 'pad' / 'training.log').read_text()
    assert "ChainMesh({'chains': 2}" in log


def test_cli_device_limit_caps(tmp_path, capture_runs):
    from mile_tpu_torch.cli import main

    path = _config_file(tmp_path)
    main(['-c', path, '--device', 'cpu', '--devices', '8',
          '--device_limit', '2', '--silent'])
    main(['-c', path, '--device', 'cpu', '--device_limit', '3', '--silent'])
    main(['-c', path, '--device', 'cpu', '--devices', '2',
          '--device_limit', '4', '--silent'])
    assert [job[2] for job in capture_runs] == [2, 3, 2]


def test_cli_multihost_with_nothing_configured_runs_single_process(
        tmp_path, capture_runs, monkeypatch, caplog):
    """As ``tests/test_cli.py``: with no coordinator in the environment
    ``--multihost`` logs that and the experiment runs in this process."""
    from mile_tpu_torch.cli import main

    for key in ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE'):
        monkeypatch.delenv(key, raising=False)
    with caplog.at_level('INFO'):
        assert main(['-c', _config_file(tmp_path), '--device', 'cpu',
                     '--multihost', '--silent']) == 0
    assert len(capture_runs) == 1
    assert 'running single-process' in caplog.text
    assert not torch.distributed.is_initialized()


def test_cli_more_devices_than_cards_raises(tmp_path, monkeypatch):
    """``--devices 2`` on the CUDA device of a machine with one card
    raises rather than run on one."""
    from mile_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(RuntimeError, match='2 CUDA device'):
        main(['-c', _config_file(tmp_path), '--devices', '2', '--silent'])


def test_cli_outer_parallel_runs_a_grid_in_processes(tmp_path, monkeypatch):
    """``--outer_parallel`` runs the experiments of a search tree in a
    ``spawn`` pool: each writes its own experiment directory."""
    from mile_tpu_torch.cli import main

    tree = tmp_path / 'seeds.yaml'
    tree.write_text('rng:\n- 1\n- 2\n')
    monkeypatch.setenv('OMP_NUM_THREADS', '1')   # read by the workers
    assert main(['-c', _config_file(tmp_path), '-s', str(tree), '--device',
                 'cpu', '--outer_parallel', '--no_report', '--silent']) == 0
    runs = sorted(p.name for p in (tmp_path / 'results').iterdir())
    assert len(runs) == 2
    for run in runs:
        assert (tmp_path / 'results' / run / 'metrics.pkl').is_file()
