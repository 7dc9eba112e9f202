"""Mid-chain resume, per-draw streaming and warm-start reuse in the port,
against the JAX package's contract and files.

A resumed MCLMC, NUTS or HMC run gives the uninterrupted run's draws,
per-draw statistics and tuned parameters bit for bit, without the tuner,
with the snapshot in the npz or the orbax format, and when the run was
killed between a chunk and the snapshot that counts it or between the
snapshot and the meta file;
the checkpoint directory holds the JAX package's files and npz keys (the
random state apart: the port stores its own); the per-draw writer's files
equal the JAX writer's; each package's trainer reuses the other's
warm-start members bit for bit. Two findings about the JAX trainer are
pinned: re-running it never resumes, and ``stream_samples`` fails with
partition sampling (the port refuses the combination up front).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from _torch_parity import jax_airfoil, one_torch_thread  # noqa: F401
from jax.flatten_util import ravel_pytree

from mile_tpu.train import checkpoint as jax_ckpt
from mile_tpu_torch.bayes.posterior import value_and_grad
from mile_tpu_torch.config import SamplerConfig
from mile_tpu_torch.config.training import Sampler
from mile_tpu_torch.train import checkpoint as ckpt
from mile_tpu_torch.train import sampling, sampling_hmc
from mile_tpu_torch.train.resume import SamplerCheckpoint

ROOT = Path(__file__).resolve().parents[1]
DIM = 16
N_CHAINS = 4
# 32 kept draws; 4 chains x 16 dim x 4 B = 256 B a kept draw: 8 a chunk
CHUNK_BYTES = 8 * N_CHAINS * DIM * 4
SAMPLERS = ['mclmc', 'nuts', 'hmc']
# the random state: the JAX snapshot's threefry keys, the port's own
JAX_RNG_KEYS = {'key_data'}
PORT_RNG_KEYS = {'mclmc': {'rng_seed', 'rng_step'},
                 'hmc': {'rng_generator_state'}}


def gaussian():
    scale = torch.linspace(0.5, 2.0, DIM)
    return value_and_grad(lambda x: -0.5 * torch.sum((x / scale) ** 2,
                                                     dim=1))


def config(sampler: str, **kw) -> SamplerConfig:
    if sampler == 'mclmc':
        return SamplerConfig(warmup_steps=200, n_chains=N_CHAINS,
                             n_samples=64, n_thinning=2, step_size_init=0.05,
                             **kw)
    return SamplerConfig(name=Sampler(sampler), warmup_steps=150,
                         n_chains=N_CHAINS, n_samples=64, n_thinning=2,
                         num_integration_steps=8, **kw)


def run(sampler: str, seed: int, cfg=None, **kw):
    """``run_sampler`` on a 16-dim Gaussian, 4 chains, 32 kept draws in
    chunks of 8, from a fresh generator seeded with ``seed``."""
    positions = 0.1 * torch.randn(N_CHAINS, DIM,
                                  generator=torch.Generator().manual_seed(0))
    return sampling.run_sampler(
        gaussian(), cfg or config(sampler),
        torch.Generator().manual_seed(seed), positions,
        max_chunk_bytes=CHUNK_BYTES, **kw)


class Stop(Exception):
    """A simulated preemption."""


class StopAfter:
    """A sink that stops the run at its ``n``-th chunk."""

    def __init__(self, n):
        self.n, self.seen = n, 0

    def __call__(self, chunk, start):
        self.seen += 1
        if self.seen >= self.n:
            raise Stop(f'after chunk {self.seen}')


def assert_same_run(ours, want):
    np.testing.assert_array_equal(ours.samples, want.samples)
    assert set(ours.info) == set(want.info)
    for key in want.info:
        np.testing.assert_array_equal(ours.info[key], want.info[key])
    for key in ours.tuned:
        np.testing.assert_array_equal(ours.tuned[key], want.tuned[key])


def tuned_keys(sampler):
    return ({'L', 'step_size', 'sqrt_diag_cov'} if sampler == 'mclmc'
            else {'step_size', 'inverse_mass_matrix'})


@pytest.mark.parametrize('sampler', SAMPLERS)
def test_resume_reproduces_uninterrupted_run(tmp_path, sampler):
    """Stopped after its second chunk and resumed with the same arguments:
    the draws, every per-draw statistic and the tuned parameters equal the
    uninterrupted run's bit for bit; each completed run removes its
    checkpoint directory."""
    full = run(sampler, 7, checkpoint_dir=tmp_path / 'full')
    assert full.samples.shape == (N_CHAINS, 32, DIM)
    assert not (tmp_path / 'full').exists()

    ckpt_dir = tmp_path / 'stopped'
    with pytest.raises(Stop):
        run(sampler, 7, checkpoint_dir=ckpt_dir, sample_sink=StopAfter(2))
    assert (ckpt_dir / 'sampler_state.npz').exists()
    resumed = run(sampler, 7, checkpoint_dir=ckpt_dir)
    assert_same_run(resumed, full)
    # a resumed run returns what it restored, as the JAX runtimes do
    assert set(resumed.tuned) == tuned_keys(sampler)
    assert not ckpt_dir.exists()


@pytest.mark.parametrize('sampler', SAMPLERS)
def test_a_kill_between_a_chunk_and_its_snapshot(tmp_path, sampler,
                                                 monkeypatch):
    """A run killed after chunk 1 is on disk but before the snapshot that
    points past it (a SIGKILL can land there): the resumed run runs chunk 1
    again instead of loading it, and equals the uninterrupted run bit for
    bit. (The JAX package's resume loads every chunk file and would hold
    chunk 1 twice.)"""
    full = run(sampler, 5)
    ckpt_dir = tmp_path / 'c'
    save = SamplerCheckpoint.save
    calls = []

    def killed_at_third_snapshot(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 3:   # post-warmup, after chunk 0, after chunk 1
            raise Stop('between chunk 1 and its snapshot')
        return save(self, *args, **kwargs)

    monkeypatch.setattr(SamplerCheckpoint, 'save', killed_at_third_snapshot)
    with pytest.raises(Stop):
        run(sampler, 5, checkpoint_dir=ckpt_dir)
    monkeypatch.setattr(SamplerCheckpoint, 'save', save)
    assert sorted(p.name for p in ckpt_dir.glob('chunk_*.npz')) == [
        'chunk_000000.npz', 'chunk_000001.npz']
    meta = json.loads((ckpt_dir / 'sampler_meta.json').read_text())
    assert meta['kept_done'] == 8
    assert_same_run(run(sampler, 5, checkpoint_dir=ckpt_dir), full)
    assert not ckpt_dir.exists()


@pytest.mark.parametrize('sampler', SAMPLERS)
def test_a_kill_between_the_snapshot_and_the_meta_file(tmp_path, sampler,
                                                       monkeypatch):
    """A run killed after the snapshot after chunk 0 is written but before
    ``sampler_meta.json`` is (the two files are replaced one after the
    other): the resume takes the snapshot's own count, not the meta file's
    older one, and equals the uninterrupted run bit for bit."""
    full = run(sampler, 5)
    ckpt_dir = tmp_path / 'c'
    write = SamplerCheckpoint._write
    metas = []

    def killed_before_the_second_meta(self, name, fn):
        if name == 'sampler_meta.json':
            metas.append(1)
            if len(metas) == 2:   # post-warmup, then after chunk 0
                raise Stop('between the snapshot and the meta file')
        return write(self, name, fn)

    monkeypatch.setattr(SamplerCheckpoint, '_write',
                        killed_before_the_second_meta)
    with pytest.raises(Stop):
        run(sampler, 5, checkpoint_dir=ckpt_dir)
    monkeypatch.setattr(SamplerCheckpoint, '_write', write)
    meta = json.loads((ckpt_dir / 'sampler_meta.json').read_text())
    with np.load(ckpt_dir / 'sampler_state.npz') as snapshot:
        assert (meta['kept_done'], int(snapshot['meta_kept_done'])) == (0, 8)
    assert_same_run(run(sampler, 5, checkpoint_dir=ckpt_dir), full)
    assert not ckpt_dir.exists()


@pytest.mark.parametrize('sampler', SAMPLERS)
def test_stop_inside_chunk_0_resumes_without_the_tuner(tmp_path, sampler,
                                                       monkeypatch):
    """A run stopped before its first chunk is drained resumes from the
    post-warmup snapshot without calling the tuner, and equals a run made
    without a checkpoint at all."""
    full = run(sampler, 3)
    ckpt_dir = tmp_path / 'c'

    def halt(*args, **kwargs):
        raise Stop('inside chunk 0')

    with monkeypatch.context() as m:
        m.setattr(sampling.Drain, 'push', halt)
        with pytest.raises(Stop):
            run(sampler, 3, checkpoint_dir=ckpt_dir)
    meta = json.loads((ckpt_dir / 'sampler_meta.json').read_text())
    assert meta['kept_done'] == 0 and not list(ckpt_dir.glob('chunk_*'))

    def no_tuner(*args, **kwargs):
        raise AssertionError('the tuner ran on resume')

    monkeypatch.setattr(sampling, 'warmup_mclmc', no_tuner)
    monkeypatch.setattr(sampling_hmc, 'run_window_adaptation', no_tuner)
    assert_same_run(run(sampler, 3, checkpoint_dir=ckpt_dir), full)


@pytest.mark.parametrize('sampler', SAMPLERS)
def test_fingerprint_mismatch_is_ignored_with_a_warning(tmp_path, caplog,
                                                        sampler):
    """A checkpoint of another random stream is ignored (with a warning),
    not merged: the run starts afresh."""
    ckpt_dir = tmp_path / 'fp'
    with pytest.raises(Stop):
        run(sampler, 1, checkpoint_dir=ckpt_dir, sample_sink=StopAfter(2))
    with caplog.at_level('WARNING'):
        out = run(sampler, 2, checkpoint_dir=ckpt_dir)
    assert 'fingerprint mismatch' in caplog.text
    assert_same_run(out, run(sampler, 2))


@pytest.mark.parametrize('sampler', SAMPLERS)
def test_snapshot_is_the_state_at_the_end_of_its_chunk(tmp_path, sampler):
    """The snapshot written when chunk k is drained holds the state as of
    the end of chunk k, though chunk k+1 has already run: its position is
    the chunk's last draw, and MCLMC's counter step counts the steps up to
    there."""
    ckpt_dir = tmp_path / 's'
    cfg = config(sampler)
    with pytest.raises(Stop):
        run(sampler, 5, cfg, checkpoint_dir=ckpt_dir,
            sample_sink=StopAfter(2))
    state, rng, _, kept_done = _load(ckpt_dir)
    with np.load(ckpt_dir / 'chunk_000001.npz') as d:
        last = d['positions'][:, -1]
    assert kept_done == 16
    np.testing.assert_array_equal(state['position'], last)
    if sampler == 'mclmc':
        assert int(rng['step']) == kept_done * cfg.n_thinning
    else:
        assert rng['generator_state'].dtype == np.uint8


def _load(ckpt_dir):
    """The snapshot, read whatever its fingerprint."""
    meta = json.loads((ckpt_dir / 'sampler_meta.json').read_text())
    return SamplerCheckpoint(ckpt_dir, meta['fingerprint']).load()


def test_sink_offsets_on_resume(tmp_path):
    """The sink receives only the chunks not yet drained, at contiguous
    start offsets that end at the last draw."""
    ckpt_dir = tmp_path / 's'
    with pytest.raises(Stop):
        run('mclmc', 11, checkpoint_dir=ckpt_dir, sample_sink=StopAfter(3))
    starts = []
    run('mclmc', 11, checkpoint_dir=ckpt_dir,
        sample_sink=lambda chunk, start: starts.append((start,
                                                        chunk.shape[1])))
    assert starts == [(24, 8)]


@pytest.mark.parametrize('sampler', ['mclmc', 'nuts'])
def test_keep_warmup_trace_survives_resume(tmp_path, sampler):
    """A resumed run returns the uninterrupted run's warmup trace, saved
    beside the snapshot and removed on success."""
    cfg = config(sampler, keep_warmup=True)
    full = run(sampler, 7, cfg)
    assert 'warmup_trace' in full.info
    ckpt_dir = tmp_path / 'c'
    with pytest.raises(Stop):
        run(sampler, 7, cfg, checkpoint_dir=ckpt_dir,
            sample_sink=StopAfter(2))
    assert (ckpt_dir / 'warmup_trace.npy').exists()
    resumed = run(sampler, 7, cfg, checkpoint_dir=ckpt_dir)
    assert_same_run(resumed, full)
    assert not ckpt_dir.exists()


def _jax_setup():
    scale = jnp.linspace(0.5, 2.0, DIM)
    logdensity = lambda x: -0.5 * jnp.sum((x / scale) ** 2)
    positions = 0.1 * jax.random.normal(jax.random.PRNGKey(0),
                                        (N_CHAINS, DIM))
    return logdensity, positions


def _npz_keys(path):
    with np.load(path) as d:
        return set(d.files)


@pytest.mark.parametrize('sampler', ['mclmc', 'hmc'])
def test_checkpoint_files_match_jax(tmp_path, sampler):
    """Each package's run, stopped after chunk 2, leaves the same files
    with the same npz keys and the same fingerprint keys, apart from the
    random state and the snapshot's own kept-draw count."""
    from mile_tpu.config.training import Sampler as JaxSampler
    from mile_tpu.config.training import SamplerConfig as JaxSamplerConfig
    from mile_tpu.train.sampling import run_sampler as jax_run_sampler

    logdensity, positions = _jax_setup()
    kw = (dict(warmup_steps=50, step_size_init=0.05) if sampler == 'mclmc'
          else dict(name=JaxSampler(sampler), warmup_steps=50,
                    num_integration_steps=8))
    jax_cfg = JaxSamplerConfig(n_chains=N_CHAINS, n_samples=64,
                               n_thinning=2, **kw)
    with pytest.raises(Stop):
        jax_run_sampler(logdensity, jax_cfg, jax.random.PRNGKey(1),
                        positions, max_chunk_bytes=CHUNK_BYTES,
                        checkpoint_dir=tmp_path / 'jax',
                        sample_sink=StopAfter(2))
    with pytest.raises(Stop):
        run(sampler, 1, config(sampler), checkpoint_dir=tmp_path / 'port',
            sample_sink=StopAfter(2))
    names = {p: sorted(q.name for q in (tmp_path / p).iterdir())
             for p in ('jax', 'port')}
    assert names['port'] == names['jax'] == [
        'chunk_000000.npz', 'chunk_000001.npz', 'sampler_meta.json',
        'sampler_state.npz']
    for name in ('chunk_000000.npz', 'chunk_000001.npz'):
        assert _npz_keys(tmp_path / 'port' / name) \
            == _npz_keys(tmp_path / 'jax' / name)
    jax_keys = _npz_keys(tmp_path / 'jax' / 'sampler_state.npz')
    port_keys = _npz_keys(tmp_path / 'port' / 'sampler_state.npz')
    assert jax_keys & JAX_RNG_KEYS == JAX_RNG_KEYS
    assert port_keys & PORT_RNG_KEYS[sampler] == PORT_RNG_KEYS[sampler]
    # the port's snapshot also holds its own kept-draw count
    assert 'meta_kept_done' in port_keys
    assert port_keys - PORT_RNG_KEYS[sampler] - {'meta_kept_done'} \
        == jax_keys - JAX_RNG_KEYS
    metas = {p: json.loads((tmp_path / p / 'sampler_meta.json').read_text())
             for p in ('jax', 'port')}
    assert metas['port']['kept_done'] == metas['jax']['kept_done'] == 16
    assert set(metas['port']['fingerprint']) == set(metas['jax']['fingerprint'])


@pytest.mark.parametrize('sampler', SAMPLERS)
def test_orbax_format_resume_is_bitwise(tmp_path, sampler):
    """``checkpoint_format='orbax'`` routes the snapshot through
    ``torch.distributed.checkpoint`` (``sampler_state_orbax/step_0/``, no
    ``sampler_state.npz``; the chunks stay npz, as in the JAX package): a
    stopped run resumes bit for bit and the directory is cleared."""
    full = run(sampler, 7)
    ckpt_dir = tmp_path / 'stopped'
    with pytest.raises(Stop):
        run(sampler, 7, checkpoint_dir=ckpt_dir, checkpoint_format='orbax',
            sample_sink=StopAfter(2))
    assert (ckpt_dir / 'sampler_state_orbax' / 'step_0' / '.metadata').exists()
    assert not (ckpt_dir / 'sampler_state.npz').exists()
    assert sorted(p.name for p in ckpt_dir.glob('chunk_*')) == [
        'chunk_000000.npz', 'chunk_000001.npz']
    resumed = run(sampler, 7, checkpoint_dir=ckpt_dir,
                  checkpoint_format='orbax')
    assert_same_run(resumed, full)
    assert not ckpt_dir.exists()


def test_orbax_snapshot_round_trip(tmp_path):
    """The orbax-format snapshot gives back what the npz one does, and a
    writer that is not rank 0 writes nothing."""
    parts = ({'position': np.arange(6, dtype=np.float32).reshape(2, 3)},
             {'seed': np.int64(5), 'step': np.int64(9)},
             {'L': np.ones(2, np.float32)})
    loaded = {}
    for fmt in ('npz', 'orbax'):
        checkpoint = SamplerCheckpoint(tmp_path / fmt, {'a': 1}, fmt=fmt)
        checkpoint.save(*parts, kept_done=4)
        loaded[fmt] = checkpoint.load()
    for want, got in zip(loaded['npz'], loaded['orbax']):
        if isinstance(want, dict):
            assert set(want) == set(got)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype
        else:
            assert got == want == 4
    silent = SamplerCheckpoint(tmp_path / 'rank1', {'a': 1}, fmt='orbax',
                               writer=False)
    silent.save(*parts, kept_done=4)
    silent.save_chunk(0, parts[0]['position'], {})
    assert not (tmp_path / 'rank1').exists() and silent.load() is None


# ------------------------------------------------------------ streaming
def _templates(name):
    """(JAX template params, the port's model) of one model family."""
    from mile_tpu.config import models as jax_models
    from mile_tpu.models import build_model as jax_build
    from mile_tpu_torch.config import models as tm
    from mile_tpu_torch.models import build_model

    if name == 'FCN':
        module = jax_build(jax_models.FCNConfig(hidden_structure=[16, 16, 2]))
        example = jnp.zeros((1, 5))
        model = build_model(tm.FCNConfig(hidden_structure=[16, 16, 2]), (5,))
    elif name == 'LeNet':
        module = jax_build(jax_models.LeNetConfig())
        example = jnp.zeros((1, 1, 28, 28))
        model = build_model(tm.LeNetConfig(), (1, 28, 28))
    else:
        module = jax_build(jax_models.AttentionClassifierConfig(
            vocab_size=100, context_len=12, emb_size=16, n_heads=2,
            qkv_dim=16, projection_dim=[8]))
        example = jnp.zeros((1, 12), jnp.int32)
        model = build_model(tm.AttentionClassifierConfig(
            vocab_size=100, context_len=12, emb_size=16, n_heads=2,
            qkv_dim=16, projection_dim=[8]), (12,))
    return module.init(jax.random.PRNGKey(0), example)['params'], model


@pytest.mark.parametrize('name', ['FCN', 'LeNet', 'AttentionClassifier'])
def test_save_samples_streaming_matches_jax(tmp_path, name):
    """The same flat draw through each package's per-draw writer: the same
    file names, the same entries in the same order, equal arrays."""
    template, model = _templates(name)
    _, unravel = ravel_pytree(template)
    flat = np.random.default_rng(3).normal(size=model.dim).astype(np.float32)
    jax_ckpt.save_samples_streaming(tmp_path / 'jax', 1, 5,
                                    unravel(jnp.asarray(flat)))
    ckpt.save_samples_streaming(tmp_path / 'port', 1, 5, flat, model.layout)
    for root in ('jax', 'port'):
        assert [p.relative_to(tmp_path / root).as_posix()
                for p in (tmp_path / root).rglob('*.npz')] == \
            ['1/sample_5.npz']
    with np.load(tmp_path / 'jax/1/sample_5.npz') as want, \
            np.load(tmp_path / 'port/1/sample_5.npz') as ours:
        assert ours.files == want.files
        for key in want.files:
            assert ours[key].dtype == want[key].dtype
            np.testing.assert_array_equal(ours[key], want[key])


def tiny_config(saving_dir, name='tiny', **sampler) -> dict:
    with open(ROOT / 'configs' / 'illustrative_airfoil_mclmc.yaml') as f:
        cfg = yaml.safe_load(f)
    cfg['saving_dir'] = str(saving_dir)
    cfg['experiment_name'] = name
    cfg['training']['warmstart'].update(max_epochs=2, batch_size=256)
    cfg['training']['sampler'].update(
        dict(n_chains=2, warmup_steps=30, n_samples=24, n_thinning=3),
        **sampler)
    return cfg


def port_trainer(cfg: dict):
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    return BDETrainer(Config.from_dict(cfg), device='cpu')


def jax_trainer(cfg: dict):
    from mile_tpu.config import Config
    from mile_tpu.train.trainer import BDETrainer

    return BDETrainer(Config.from_dict(cfg))


def test_trainer_streams_each_draw(tmp_path):
    """``stream_samples``: one ``samples/{c}/sample_{n}.npz`` per draw,
    with the JAX package's entries, equal to ``chain_{c}/samples.npy`` row
    by row, which the JAX package reads; no native sink."""
    from mile_tpu_torch.models.layout import jax_leaves_from_flat, keystr

    trainer = port_trainer(tiny_config(tmp_path, stream_samples=True))
    trainer.train(report=False)
    assert trainer.sink is None
    samples = jax_ckpt.load_flat_samples(trainer.samples_dir)
    assert samples.shape == (2, 8, 674)
    assert not list(trainer.samples_dir.rglob('samples.bin'))
    layout = trainer.model.layout
    names = [keystr(leaf.path) for leaf in layout.leaves]
    files = sorted(trainer.samples_dir.glob('[0-9]*/sample_*.npz'))
    assert len(files) == 16
    for c in range(2):
        for n in range(8):
            with np.load(trainer.samples_dir / f'{c}/sample_{n}.npz') as d:
                assert d.files == names
                for key, leaf in zip(names, jax_leaves_from_flat(
                        samples[c, n], layout)):
                    np.testing.assert_array_equal(d[key], leaf)


def test_trainer_checkpoint_sampling(tmp_path):
    """``checkpoint_sampling``: no native sink, ``samples.npy`` at the end,
    ``sampler_ckpt/`` removed on success, and the draws those of the same
    run without it."""
    plain = port_trainer(tiny_config(tmp_path, 'plain'))
    plain.train(report=False)
    trainer = port_trainer(tiny_config(tmp_path, 'ckpt',
                                       checkpoint_sampling=True))
    trainer.train(report=False)
    assert trainer.sink is None
    assert (trainer.samples_dir / 'chain_0' / 'samples.npy').is_file()
    assert not (trainer.exp_dir / 'sampler_ckpt').exists()
    np.testing.assert_array_equal(
        ckpt.load_flat_samples(trainer.samples_dir),
        ckpt.load_flat_samples(plain.samples_dir))


# ------------------------------------------------------ warm-start reuse
def test_port_reuses_a_jax_warmstart(tmp_path):
    """The port's trainer with ``warmstart_exp_dir`` set to a JAX run takes
    its members bit for bit, and saves them again in its own run."""
    jax_cfg = tiny_config(tmp_path / 'jax')
    jax_cfg['training']['warmstart']['include'] = False   # fresh inits
    source = jax_trainer(jax_cfg)
    params = source.train_warmstart()
    want = np.asarray(jax.vmap(lambda p: ravel_pytree(p)[0])(params))
    cfg = tiny_config(tmp_path / 'port')
    cfg['training']['warmstart']['warmstart_exp_dir'] = str(source.exp_dir)
    trainer = port_trainer(cfg)
    members = trainer.train_warmstart()
    np.testing.assert_array_equal(members.numpy(), want)
    np.testing.assert_array_equal(
        ckpt.load_params_batch(trainer.warmstart_dir, [0, 1]), want)


def test_jax_reuses_a_port_warmstart(tmp_path):
    """The JAX trainer reuses the port's members bit for bit. The port
    writes ``layout.json`` where the JAX package pickles its treedef (a
    kept divergence), so the treedef is added to the port's directory."""
    source = port_trainer(tiny_config(tmp_path / 'port'))
    members = source.train_warmstart().numpy()
    _, _, template, _ = jax_airfoil()
    jax_ckpt.save_treedef(source.warmstart_dir,
                          jax.tree.structure(template))
    cfg = tiny_config(tmp_path / 'jax')
    cfg['training']['warmstart']['warmstart_exp_dir'] = str(source.exp_dir)
    params = jax_trainer(cfg).train_warmstart()
    got = np.asarray(jax.vmap(lambda p: ravel_pytree(p)[0])(params))
    np.testing.assert_array_equal(got, members)


def test_too_few_warmstart_members_raise_as_in_jax(tmp_path):
    source = port_trainer(tiny_config(tmp_path / 'src'))
    source.train_warmstart()
    errors = []
    for package, make in (('jax', jax_trainer), ('port', port_trainer)):
        cfg = tiny_config(tmp_path / package, n_chains=3)
        cfg['training']['warmstart']['warmstart_exp_dir'] = str(
            source.exp_dir)
        with pytest.raises(ValueError) as info:
            make(cfg).train_warmstart()
        errors.append(str(info.value))
    assert errors[0] == errors[1] == (
        f'warmstart dir {source.warmstart_dir} has 2 checkpoints, need 3')


# ------------------------------------------------------------- findings
def test_rerunning_a_trainer_never_resumes(tmp_path):
    """Finding (kept in both packages): a second trainer on the same
    config gets a new, time-stamped experiment directory, so its
    ``sampler_ckpt/`` is never the first run's. Resume works only through
    ``run_mclmc`` / ``run_hmc_family`` with the same ``checkpoint_dir``."""
    from mile_tpu.config import Config as JaxConfig
    from mile_tpu_torch.config import Config

    for package, make in (('jax', JaxConfig), ('port', Config)):
        config = make.from_dict(tiny_config(tmp_path / package))
        first = config.setup_dir()
        (first / 'sampler_ckpt').mkdir()
        second = config.setup_dir()
        assert second != first and second.name.startswith('tiny_'), package
        assert not (second / 'sampler_ckpt').exists()


@pytest.mark.parametrize('option', ['partition_sampling', 'params_frozen'])
def test_stream_samples_with_partition_sampling_raises(tmp_path, option):
    """Finding: the JAX trainer streams partition sampling's subspace-wide
    draws through the full layout's ``unravel``, which fails after the
    first chunk ('Sum of sizes 674 must be equal to dimension 0 of the
    operand shape [130]' on configs/ablations/partition_airfoil.yaml). The
    port refuses the combination before the run, naming both options."""
    update = ({'partition_sampling': True} if option == 'partition_sampling'
              else {'params_frozen': ['layer1']})
    cfg = tiny_config(tmp_path, stream_samples=True, **update)
    if option == 'partition_sampling':
        cfg['model']['model'] = 'PartitionFCN'
    with pytest.raises(ValueError, match='stream_samples cannot be combined '
                       'with training.sampler.partition_sampling'):
        port_trainer(cfg)
