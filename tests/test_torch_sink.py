"""The port's native sample sink against the JAX package's: the same files,
byte for byte, read back bit-equal by both packages' ``load_flat_samples``;
and the sampling runtime streaming its chunks into it."""
import math

import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

from mile_tpu.native import NativeSampleSink as JaxSink
from mile_tpu.train.checkpoint import load_flat_samples as jax_load
from mile_tpu_torch.bayes.posterior import value_and_grad
from mile_tpu_torch.config import SamplerConfig
from mile_tpu_torch.native import NativeSampleSink, native_available, sink
from mile_tpu_torch.train import checkpoint, sampling


def chunks(seed=0, n_chains=3, dim=11, blocks=(7, 1, 5, 7)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n_chains, b, dim)).astype(np.float32)
            for b in blocks]


def write(sink_cls, directory, parts):
    with sink_cls(directory, n_chains=parts[0].shape[0],
                  dim=parts[0].shape[2]) as s:
        start = 0
        for part in parts:
            s(part, start)
            start += part.shape[1]
    return s


def same_files(a, b, n_chains):
    for c in range(n_chains):
        for name in ('samples.bin', 'samples.meta'):
            assert (a / f'chain_{c}' / name).read_bytes() == \
                (b / f'chain_{c}' / name).read_bytes(), (c, name)


def test_native_library_builds():
    assert native_available(), 'g++ should build the port\'s sink'


def test_sink_writes_the_jax_sinks_files(tmp_path):
    """The same chunks through both sinks: equal bytes in every file, and
    both loaders read back the concatenated chunks bit for bit."""
    parts = chunks()
    ours = write(NativeSampleSink, tmp_path / 'port', parts)
    assert ours.native
    write(JaxSink, tmp_path / 'jax', parts)
    same_files(tmp_path / 'port', tmp_path / 'jax', 3)
    want = np.concatenate(parts, axis=1)
    for load in (jax_load, checkpoint.load_flat_samples):
        np.testing.assert_array_equal(load(tmp_path / 'port'), want)


def test_rows_written_survive_close(tmp_path):
    """``rows_written`` counts each chain's rows on disk; after ``close()``
    it keeps the final count, which matches the files."""
    parts = chunks(seed=1, n_chains=2, dim=64, blocks=(100,) * 10)
    s = write(NativeSampleSink, tmp_path, parts)
    assert s.rows_written == 1000
    assert checkpoint.load_flat_samples(tmp_path).shape == (2, 1000, 64)


def test_numpy_fallback_writes_the_same_files(tmp_path, monkeypatch):
    """Without the C++ library the sink writes the same files itself."""
    monkeypatch.setattr(sink, '_library', lambda: None)
    parts = chunks(seed=2)
    ours = write(NativeSampleSink, tmp_path / 'port', parts)
    assert not ours.native and ours.rows_written == -1
    write(JaxSink, tmp_path / 'jax', parts)
    same_files(tmp_path / 'port', tmp_path / 'jax', 3)


def test_sink_refuses_a_chunk_that_does_not_fit(tmp_path):
    with NativeSampleSink(tmp_path, n_chains=2, dim=8) as s:
        for shape in ((3, 1, 8), (2, 1, 9)):
            with pytest.raises(ValueError, match='does not fit'):
                s(np.zeros(shape, np.float32), 0)


def test_load_flat_samples_reads_npy(tmp_path):
    draws = np.random.default_rng(3).normal(size=(2, 4, 6)).astype(np.float32)
    checkpoint.save_samples(tmp_path, draws)
    for load in (jax_load, checkpoint.load_flat_samples):
        np.testing.assert_array_equal(load(tmp_path), draws)


@pytest.mark.parametrize('n_samples,thin', [(200, 2), (25, 4)])
def test_run_mclmc_streams_into_the_sink(tmp_path, n_samples, thin):
    """Chunks of a run that streams to the host in several pieces reach the
    sink in order: the files hold exactly ``result.samples``."""
    n_chains, dim = 2, 8
    cfg = SamplerConfig(warmup_steps=100, n_chains=n_chains,
                        n_samples=n_samples, n_thinning=thin,
                        step_size_init=0.05)
    vg = value_and_grad(lambda x: -0.5 * torch.sum(x * x, dim=1))
    starts = []

    with NativeSampleSink(tmp_path, n_chains, dim) as s:
        def sink_fn(chunk, start):
            starts.append(start)
            s(chunk, start)

        res = sampling.run_mclmc(
            vg, cfg, torch.Generator().manual_seed(0),
            torch.randn(n_chains, dim,
                        generator=torch.Generator().manual_seed(1)),
            max_chunk_bytes=n_chains * dim * 4 * 16, sample_sink=sink_fn)
    n_kept = math.ceil(n_samples / thin)
    assert starts == list(range(0, n_kept, 16))
    assert s.rows_written == n_kept
    np.testing.assert_array_equal(jax_load(tmp_path), res.samples)
