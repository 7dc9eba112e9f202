"""The port's fused ops against the JAX package, and their kernels on a GPU.

On the CPU each wrapper computes its plain PyTorch version; those are held
against ``mile_tpu``'s reference math and its Pallas kernels, run in
interpret mode exactly as ``tests/test_pallas_ops.py`` runs them. The
kernels themselves run only on a CUDA device: ``chip_smoke.py`` holds them
against these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread, t, unit_rows  # noqa: F401

from mile_tpu.mcmc.integrators import (
    isokinetic_momentum_update,
    partially_refresh_momentum,
)
from mile_tpu.ops import isokinetic as jax_ops
from mile_tpu_torch.ops import isokinetic as ops


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the Pallas kernels in interpreter mode off-TPU."""
    from jax.experimental import pallas as pl

    real_call = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault('interpret', True)
        return real_call(*args, **kwargs)

    monkeypatch.setattr(pl, 'pallas_call', interp_call)
    _clear_kernel_caches()
    yield
    _clear_kernel_caches()


def _clear_kernel_caches():
    jax_ops._momentum_kernel.cache_clear()
    jax_ops._refresh_kernel.cache_clear()
    jax_ops._batched_momentum_kernel.cache_clear()
    jax_ops._batched_refresh_kernel.cache_clear()


def _momentum_inputs(n_chains, dim, seed=0):
    """Inputs in the regime the sampler meets: the momentum partly aligned
    with the gradient. ΔK = (d−1)(δ − log 2 + log1p(…)) cancels to about
    (d−1)·δ·(u·e) in float32, so with a random u (u·e ~ 1/√d) and a small
    δ its relative rounding error alone exceeds the 2e-4 contract at
    dim 2048 in either package; aligned inputs keep it well conditioned."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(n_chains, dim)) * 3.0).astype(np.float32)
    u = g + 3.0 * rng.normal(size=(n_chains, dim)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sdc = (np.abs(rng.normal(size=(n_chains, dim))) + 0.5).astype(np.float32)
    eps = rng.uniform(0.05, 0.25, n_chains).astype(np.float32)
    return u, g, sdc, eps


@pytest.mark.parametrize('dim', [64, 674, 2048])
def test_momentum_matches_reference_and_pallas(dim, interpret_mode):
    """Per-chain ε and preconditioner: plain K1 against the reference math
    and the chain-batched Pallas kernel (u atol 2e-5, ΔK rtol 2e-4)."""
    u, g, sdc, eps = _momentum_inputs(5, dim)
    ref_u, ref_dk = jax.vmap(isokinetic_momentum_update)(u, g, eps, sdc)
    pal_u, pal_dk = jax.vmap(jax_ops.fused_momentum_update)(u, g, eps, sdc)
    new_u, dk = ops.isokinetic_momentum(t(u), t(g), t(eps), t(sdc))
    for want_u, want_dk in ((ref_u, ref_dk), (pal_u, pal_dk)):
        np.testing.assert_allclose(new_u.numpy(), np.asarray(want_u),
                                   atol=2e-5)
        np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk),
                                   rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize('dim', [64, 674])
def test_momentum_single_chain_matches_unbatched_pallas(dim, interpret_mode):
    """K2's case: one chain, against the unbatched Pallas kernel."""
    u, g, sdc, eps = _momentum_inputs(1, dim, seed=1)
    pal_u, pal_dk = jax_ops.fused_momentum_update(u[0], g[0], eps[0], sdc[0])
    new_u, dk = ops.isokinetic_momentum(t(u), t(g), t(eps), t(sdc))
    np.testing.assert_allclose(new_u.numpy()[0], np.asarray(pal_u), atol=2e-5)
    np.testing.assert_allclose(float(dk[0]), float(pal_dk), rtol=2e-4,
                               atol=1e-5)


def test_momentum_shared_scalars():
    """A shared step size and a scalar preconditioner across chains."""
    u, g, _, _ = _momentum_inputs(3, 256, seed=2)
    eps = np.float32(0.07)
    ref_u, ref_dk = jax.vmap(
        lambda u, g: isokinetic_momentum_update(u, g, eps, 1.0))(u, g)
    new_u, dk = ops.isokinetic_momentum(t(u), t(g), float(eps), 1.0)
    np.testing.assert_allclose(new_u.numpy(), np.asarray(ref_u), atol=2e-5)
    np.testing.assert_allclose(dk.numpy(), np.asarray(ref_dk), rtol=2e-4,
                               atol=1e-5)


def test_momentum_stage_coefficient_and_shared_preconditioner():
    """``coef`` scales ε as the integrator's stage fraction does, and a
    (dim,) preconditioner is shared by all chains."""
    u, g, sdc, eps = _momentum_inputs(4, 674, seed=3)
    coef = 0.6136333449924328
    ref_u, ref_dk = jax.vmap(isokinetic_momentum_update,
                             in_axes=(0, 0, 0, None))(u, g, coef * eps, sdc[0])
    new_u, dk = ops.isokinetic_momentum(t(u), t(g), t(eps), t(sdc[0]),
                                        coef=coef)
    np.testing.assert_allclose(new_u.numpy(), np.asarray(ref_u), atol=2e-5)
    np.testing.assert_allclose(dk.numpy(), np.asarray(ref_dk), rtol=2e-4,
                               atol=1e-5)


def test_momentum_zero_gradient_is_identity():
    u = unit_rows(np.random.default_rng(4), 3, 128)
    new_u, dk = ops.isokinetic_momentum(t(u), torch.zeros(3, 128),
                                        torch.full((3,), 0.1))
    np.testing.assert_allclose(new_u.numpy(), u, atol=1e-6)
    assert np.abs(dk.numpy()).max() < 1e-5


def _positions(rng, n_chains, dim):
    """Positions away from zero, so that x' is held to a relative bound."""
    sign = rng.choice([-1.0, 1.0], size=(n_chains, dim))
    return (sign * rng.uniform(0.5, 1.5, (n_chains, dim))).astype(np.float32)


@pytest.mark.parametrize('preconditioned', [True, False])
@pytest.mark.parametrize('n_chains,dim', [(5, 674), (2, 64)])
def test_momentum_with_fused_drift_matches_reference(n_chains, dim,
                                                     preconditioned):
    """K1 with the drift fused in: the JAX rotation followed by the drift
    of ``mile_tpu/mcmc/integrators.py::_position_update``
    (x + ε_x · u' · s): u' atol 2e-5, ΔK rtol 2e-4, x' rtol 1e-6."""
    u, g, sdc, eps = _momentum_inputs(n_chains, dim, seed=9)
    x = _positions(np.random.default_rng(10), n_chains, dim)
    if not preconditioned:
        sdc = np.ones_like(sdc)
    coef, x_frac = 0.6136333449924328, 0.5
    ref_u, ref_dk = jax.vmap(isokinetic_momentum_update)(
        u, g, jnp.float32(coef) * eps, sdc)
    ref_x = jax.vmap(lambda x, u, e, s: x + e * u * s)(
        x, ref_u, jnp.float32(x_frac) * eps, sdc)
    new_u, dk, new_x = ops.isokinetic_momentum(
        t(u), t(g), t(eps), t(sdc) if preconditioned else None, coef,
        x=t(x), x_frac=x_frac)
    np.testing.assert_allclose(new_u.numpy(), np.asarray(ref_u), atol=2e-5)
    np.testing.assert_allclose(dk.numpy(), np.asarray(ref_dk), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(new_x.numpy(), np.asarray(ref_x), rtol=1e-6)


def test_kinetic_accumulates_in_place():
    """``kinetic=`` adds ΔK into the given tensor and returns it: after
    three rotations it holds the sum of their three ΔK."""
    u, g, sdc, eps = _momentum_inputs(4, 674, seed=11)
    gs = [g, g[::-1].copy(), 2.0 * g]
    u1, dk1 = ops.isokinetic_momentum(t(u), t(gs[0]), t(eps), t(sdc))
    u2, dk2 = ops.isokinetic_momentum(u1, t(gs[1]), t(eps), t(sdc))
    _, dk3 = ops.isokinetic_momentum(u2, t(gs[2]), t(eps), t(sdc))
    kinetic = dk1.clone()
    v2, same = ops.isokinetic_momentum(u1, t(gs[1]), t(eps), t(sdc),
                                       kinetic=kinetic)
    ops.isokinetic_momentum(v2, t(gs[2]), t(eps), t(sdc), kinetic=kinetic)
    assert same is kinetic
    np.testing.assert_array_equal(kinetic.numpy(),
                                  (dk1 + dk2 + dk3).numpy())


@pytest.mark.parametrize('n_chains,dim', [(3, 674), (1, 674)])
def test_refresh_with_fused_energy_matches_reference(n_chains, dim):
    """K3 with ΔE fused in, fed the JAX normals: the refresh of
    ``partially_refresh_momentum`` and ΔE = ΔK − logp′ + logp of
    ``mile_tpu/mcmc/mclmc.py`` (atol 1e-6), and the running sums of ΔE
    and ΔE² moved by exactly ΔE and ΔE²."""
    rng = np.random.default_rng(12)
    u = unit_rows(rng, n_chains, dim)
    eps = rng.uniform(0.05, 0.2, n_chains).astype(np.float32)
    L = rng.uniform(0.5, 3.0, n_chains).astype(np.float32)
    dk, logp_new, logp, total, total_sq = (
        rng.normal(size=n_chains).astype(np.float32) * 50.0 for _ in range(5))
    keys = jax.random.split(jax.random.PRNGKey(13), n_chains)
    z = jax.vmap(lambda k: jax.random.normal(k, (dim,)))(keys)
    ref = jax.vmap(partially_refresh_momentum)(u, keys, eps, L)
    ref_de = jnp.asarray(dk) - jnp.asarray(logp_new) + jnp.asarray(logp)
    sums = (t(total), t(total_sq))
    out, de = ops.partial_refresh(t(u), t(eps), t(L), z=t(z),
                                  energy=(t(dk), t(logp_new), t(logp)),
                                  energy_sums=sums)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(de.numpy(), np.asarray(ref_de), atol=1e-6)
    np.testing.assert_allclose(sums[0].numpy(),
                               np.asarray(jnp.asarray(total) + ref_de),
                               atol=1e-6)
    np.testing.assert_allclose(sums[1].numpy(),
                               np.asarray(jnp.asarray(total_sq)
                                          + ref_de * ref_de), rtol=1e-6)


def test_cpu_refresh_counter_tensor():
    """A CPU step counter: the call keys its noise by the counter's step
    (as the integer counter does) and advances it by one step."""
    u = t(unit_rows(np.random.default_rng(14), 3, 674))
    eps, L = torch.full((3,), 0.1), torch.ones(3)
    counter = ops.step_counter(5)
    assert counter.dtype == torch.int64 and ops.counter_step(counter) == 5
    a = ops.partial_refresh(u, eps, L, seed=3, counter=counter)
    assert ops.counter_step(counter) == 6
    b = ops.partial_refresh(u, eps, L, seed=3, counter=counter)
    assert ops.counter_step(counter) == 7
    assert torch.equal(a, ops.partial_refresh(u, eps, L, seed=3,
                                              counter=ops.step_counter(5)))
    assert torch.equal(a, ops.partial_refresh(u, eps, L, seed=3, counter=5))
    assert torch.equal(b, ops.partial_refresh(u, eps, L, seed=3, counter=6))
    assert not torch.allclose(a, b)


def test_refresh_refuses_bad_counter_and_sums():
    u = t(unit_rows(np.random.default_rng(15), 2, 64))
    eps, L = torch.full((2,), 0.1), torch.ones(2)
    with pytest.raises(ValueError, match='counter must be torch.int64'):
        ops.partial_refresh(u, eps, L, counter=torch.tensor(1.0))
    with pytest.raises(ValueError, match='energy_sums needs energy'):
        ops.partial_refresh(u, eps, L, energy_sums=(torch.zeros(2),
                                                    torch.zeros(2)))


@pytest.mark.parametrize('dim', [2, 64, 674, 2048, 8192, 8193, 40000, 65536,
                                 65537, 300000])
def test_kernel_route(dim):
    """The launch shape the wrappers give the kernels: whole warps, at
    most 512 threads and a portable cluster of 8, every group of 4
    elements covered, and resident only where the groups fit in
    registers (4 a thread)."""
    route = ops.kernel_route(dim)
    groups = -(-dim // 4)
    assert route.threads % 32 == 0 and 32 <= route.threads <= 512
    assert 1 <= route.cluster <= 8
    assert route.per_cta * route.cluster >= groups
    assert route.per_cta - 1 < -(-groups // route.cluster)
    assert route.resident == (route.per_cta <= 4 * route.threads)
    assert (route.cluster == 1) == (dim <= 8192)
    assert route.resident == (dim <= 65536)
    if dim == 674:
        assert route == (96, 1, 169, True)


@pytest.mark.parametrize('n_chains,dim', [(3, 674), (1, 674), (2, 64)])
def test_refresh_matches_reference_with_jax_normals(n_chains, dim):
    """Plain K3 fed the normals ``jax.random.normal(k, (dim,))`` that the
    reference draws: atol 1e-6."""
    rng = np.random.default_rng(5)
    u = unit_rows(rng, n_chains, dim)
    eps = (rng.uniform(0.05, 0.2, n_chains)).astype(np.float32)
    L = (rng.uniform(0.5, 3.0, n_chains)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), n_chains)
    z = jax.vmap(lambda k: jax.random.normal(k, (dim,)))(keys)
    ref = jax.vmap(partially_refresh_momentum)(u, keys, eps, L)
    out = ops.partial_refresh(t(u), t(eps), t(L), z=t(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_cpu_refresh_keeps_unit_norm_and_keys_noise():
    """The Philox-free CPU refresh: unit rows, distinct noise per chain and
    per step counter, the same noise for the same (seed, counter)."""
    u = t(unit_rows(np.random.default_rng(6), 4, 674))
    eps, L = torch.full((4,), 0.1), torch.ones(4)
    a = ops.partial_refresh(u, eps, L, seed=11, counter=0)
    b = ops.partial_refresh(u, eps, L, seed=11, counter=1)
    np.testing.assert_allclose(torch.linalg.norm(a, dim=1).numpy(), 1.0,
                               atol=1e-5)
    assert torch.equal(a, ops.partial_refresh(u, eps, L, seed=11, counter=0))
    assert not torch.allclose(a, b)
    corr = np.corrcoef((a - u).numpy())
    assert np.abs(corr[~np.eye(4, dtype=bool)]).max() < 0.2


def test_refresh_leaves_zero_entries_without_noise():
    u = torch.zeros(2, 64)
    u[:, :8] = 1.0 / np.sqrt(8)
    out = ops.partial_refresh(u, torch.full((2,), 0.3), torch.ones(2),
                              z=torch.randn(2, 64))
    assert torch.all(out[:, 8:] == 0)
    np.testing.assert_allclose(torch.linalg.norm(out, dim=1).numpy(), 1.0,
                               atol=1e-6)


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    u = t(unit_rows(np.random.default_rng(8), 2, 64))
    ops.isokinetic_momentum(u, u, torch.full((2,), 0.1))
    ops.partial_refresh(u, torch.full((2,), 0.1), torch.ones(2))
    assert ops.isokinetic_momentum.launches == 0
    assert ops.partial_refresh.launches == 0


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU tensors take the plain version; any other device launches
    the kernel or raises."""
    u = torch.zeros(2, 8, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        ops.isokinetic_momentum(u, u, 0.1)
    with pytest.raises(ValueError, match='unsupported device'):
        ops.partial_refresh(u, 0.1, 1.0)
