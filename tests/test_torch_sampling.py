"""The port's MCLMC sampling runtime: thinned blocks, chunked egress, the
warmup re-init and the per-phase matmul precision."""
import math

import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

from mile_tpu_torch.bayes.posterior import value_and_grad
from mile_tpu_torch.config import SamplerConfig
from mile_tpu_torch.train import sampling
from mile_tpu_torch.utils.precision import matmul_precision


def gaussian():
    return value_and_grad(lambda x: -0.5 * torch.sum(x * x, dim=1))


@pytest.mark.parametrize('n_samples,thin', [(24, 3), (25, 4)])
def test_thinned_chunked_draws(n_samples, thin):
    """ceil(n_samples/thin) kept draws per chain, each the position after
    a block of ``thin`` steps; streaming them to the host in chunks of at
    most ``max_chunk_bytes`` changes no draw."""
    n_chains, dim = 3, 10
    cfg = SamplerConfig(n_chains=n_chains, warmup_steps=40,
                        n_samples=n_samples, n_thinning=thin,
                        step_size_init=0.1)

    def run(**kw):
        return sampling.run_mclmc(gaussian(), cfg,
                                  torch.Generator().manual_seed(0),
                                  torch.zeros(n_chains, dim), **kw)

    result = run(max_chunk_bytes=3 * n_chains * dim * 4)
    n_kept = math.ceil(n_samples / thin)
    assert result.samples.shape == (n_chains, n_kept, dim)
    np.testing.assert_array_equal(result.samples, run().samples)
    assert np.array_equal(result.samples[:, -1],
                          result.final_state.position.numpy())
    de, de_sq = result.info['energy_change'], result.info['energy_change_sq']
    assert de.shape == de_sq.shape == (n_chains, n_kept)
    assert np.all(de_sq >= de ** 2 - 1e-6)   # mean square >= square of mean
    assert set(result.tuned) == {'L', 'step_size', 'sqrt_diag_cov'}
    # no preconditioner is tuned: written out as ones, as the JAX tuner's
    np.testing.assert_array_equal(result.tuned['sqrt_diag_cov'],
                                  np.ones((n_chains, dim), np.float32))
    assert set(result.seconds) == {'warmup', 'sampling'}
    assert all(v > 0 for v in result.seconds.values())


def test_warmup_trace_and_restart_from_the_warm_start():
    """``keep_warmup`` returns the thinned tuner trajectory; with
    ``use_warmup_as_init`` off the chains restart at their initial
    positions with the tuned parameters."""
    n_chains, dim = 2, 6
    start = torch.full((n_chains, dim), 3.0)
    cfg = SamplerConfig(n_chains=n_chains, warmup_steps=50, n_samples=1,
                        keep_warmup=True, use_warmup_as_init=False,
                        step_size_init=0.01)
    result = sampling.run_mclmc(gaussian(), cfg,
                                torch.Generator().manual_seed(1), start)
    # every phase-1+2 step (0.8 + 0.1 of 50) at this trace_every of 1
    assert result.info['warmup_trace'].shape == (n_chains, 45, dim)
    # one step from the start, not from the tuned chain's end
    moved = np.abs(result.samples[:, 0] - start.numpy()).max()
    assert moved < 10 * float(result.tuned['step_size'].max())


def test_matmul_precision_is_scoped():
    prev = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    with matmul_precision('tensorfloat32'):
        assert torch.get_float32_matmul_precision() == 'high'
        assert torch.backends.cudnn.allow_tf32 is False
        with matmul_precision('float32'):
            assert torch.get_float32_matmul_precision() == 'highest'
        assert torch.get_float32_matmul_precision() == 'high'
    assert torch.get_float32_matmul_precision() == prev
    assert torch.backends.cudnn.allow_tf32 is True
