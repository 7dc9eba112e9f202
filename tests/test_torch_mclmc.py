"""The port's MCLMC: the analytic checks of ``tests/test_mclmc.py`` on the
chain-batched kernel, and a trajectory on airfoil against the JAX kernel
with the JAX package's normals injected."""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import jax_airfoil, one_torch_thread, t, torch_airfoil  # noqa: F401

from mile_tpu.mcmc import mclmc as jax_mclmc
from mile_tpu_torch.bayes.posterior import value_and_grad
from mile_tpu_torch.mcmc import integrators, mclmc
from mile_tpu_torch.ops.isokinetic import counter_step, isokinetic_momentum


def gaussian(scales=None):
    """``theta (C, dim) -> (logp (C,), grad (C, dim))`` of a diagonal
    Gaussian, through the port's autograd wrapper."""
    def logdensity(x):
        z = x if scales is None else x / scales
        return -0.5 * torch.sum(z * z, dim=1)

    return value_and_grad(logdensity)


def run_chains(vg, x0, n_steps, step_size, L, seed=0):
    n_chains = x0.shape[0]
    gen = torch.Generator().manual_seed(seed)
    kernel = mclmc.build_kernel(vg, gen)
    state = mclmc.init(x0, vg, gen)
    step_size = torch.as_tensor(step_size, dtype=torch.float32).expand(
        n_chains)
    L = torch.as_tensor(L, dtype=torch.float32).expand(n_chains)
    positions, energy = [], []
    for _ in range(n_steps):
        state, info = kernel(state, L, step_size)
        positions.append(state.position)
        energy.append(info.energy_change)
    return torch.stack(positions, dim=1), torch.stack(energy, dim=1)


def test_momentum_update_stays_on_sphere():
    gen = torch.Generator().manual_seed(0)
    u = torch.randn(2, 64, generator=gen)
    u = u / u.norm(dim=1, keepdim=True)
    new_u, dk = isokinetic_momentum(u, torch.randn(2, 64, generator=gen),
                                    torch.tensor([0.3, 0.3]))
    np.testing.assert_allclose(new_u.norm(dim=1).numpy(), 1.0, atol=1e-5)
    assert torch.isfinite(dk).all()


def test_momentum_update_rotates_towards_gradient():
    new_u, _ = isokinetic_momentum(torch.tensor([[1.0, 0.0]]),
                                   torch.tensor([[0.0, 10.0]]), 1.0)
    assert float(new_u[0, 1]) > 0.5


def test_integrator_second_order():
    """McLachlan is second order: the per-step energy error scales as ε³."""
    dim = 32
    x0 = torch.randn(4, dim, generator=torch.Generator().manual_seed(1))

    def energy_std(eps):
        _, de = run_chains(gaussian(), x0, 700, eps, dim ** 0.5)
        return float(de[:, 200:].std())

    ratio = energy_std(0.8) / energy_std(0.4)
    assert 5.0 < ratio < 12.0, f'expected ~8 (eps^3 scaling), got {ratio}'


def test_standard_gaussian_moments():
    """An unadjusted run recovers N(0, I) moments within MC error."""
    dim = 20
    positions, de = run_chains(gaussian(), torch.zeros(16, dim), 1500, 0.8,
                               dim ** 0.5, seed=42)
    samples = positions[:, 250:].reshape(-1, dim)
    assert float(samples.mean(dim=0).abs().max()) < 0.25
    assert abs(float(samples.var(dim=0).mean()) - 1.0) < 0.1
    assert torch.isfinite(de).all()


def test_anisotropic_gaussian_variances():
    scales = torch.tensor([0.5, 1.0, 2.0, 4.0])
    positions, _ = run_chains(gaussian(scales), torch.zeros(16, 4), 3000,
                              0.25, 5.0, seed=7)
    var = positions[:, 500:].reshape(-1, 4).var(dim=0)
    np.testing.assert_allclose(var.numpy(), (scales ** 2).numpy(), rtol=0.35)


def test_per_chain_parameters():
    """Every chain has its own (L, ε): different step sizes give different
    positions from the same start and noise."""
    vg = gaussian()
    gen = torch.Generator().manual_seed(0)
    kernel = mclmc.build_kernel(vg, gen)
    state = mclmc.init(torch.zeros(4, 8), vg, gen)
    state = state._replace(momentum=state.momentum[:1].expand(4, 8))
    new_state, info = kernel(state, torch.full((4,), 3.0),
                             torch.tensor([0.05, 0.1, 0.2, 0.4]))
    assert new_state.position.shape == (4, 8)
    assert info.energy_change.shape == (4,)
    assert not torch.allclose(new_state.position[0], new_state.position[3])


def test_kernel_counter_and_energy_sums():
    """The kernel's step counter is a tensor on the state's device,
    advanced once per step by the refresh; ΔE is ΔK − logp′ + logp, and
    ``energy_sums`` collects ΔE and ΔE² of every step in place."""
    vg = gaussian()
    gen = torch.Generator().manual_seed(3)
    kernel = mclmc.build_kernel(vg, gen)
    state = mclmc.init(torch.randn(3, 16, generator=gen), vg, gen)
    eps, L = torch.full((3,), 0.3), torch.full((3,), 2.0)
    sums = (torch.zeros(3), torch.zeros(3))
    total, total_sq = torch.zeros(3), torch.zeros(3)
    for step in range(4):
        new_state, info = kernel(state, L, eps, energy_sums=sums)
        assert kernel.counter.device == state.position.device
        assert counter_step(kernel.counter) == step + 1
        want = info.kinetic_change - new_state.logdensity + state.logdensity
        assert torch.equal(info.energy_change, want)
        total += want
        total_sq += want * want
        state = new_state
    assert torch.equal(sums[0], total) and torch.equal(sums[1], total_sq)


@pytest.mark.parametrize('integrator', ['mclachlan', 'leapfrog'])
def test_fused_drifts_match_separate_updates(integrator):
    """The integrator's drifts, fused into the rotations, move the chains
    exactly as separate rotation, drift and ΔK sums do."""
    vg = gaussian(torch.tensor([0.5, 1.0, 2.0, 4.0] * 4))
    gen = torch.Generator().manual_seed(4)
    state = mclmc.init(torch.randn(2, 16, generator=gen), vg, gen)
    eps = torch.tensor([0.2, 0.4])
    sdc = torch.rand(2, 16, generator=gen) + 0.5
    make = (integrators.isokinetic_leapfrog if integrator == 'leapfrog'
            else integrators.isokinetic_mclachlan)
    new_state, kinetic = make(vg)(state, eps, sdc)
    if integrator == 'leapfrog':
        v_fracs, x_fracs = [0.5, 0.5], [1.0]
    else:
        b1 = integrators.MCLACHLAN_B1
        v_fracs, x_fracs = [b1, 1.0 - 2.0 * b1, b1], [0.5, 0.5]
    x, (u, want_k) = state.position, isokinetic_momentum(
        state.momentum, state.logdensity_grad, eps, sdc, coef=v_fracs[0])
    for xf, vf in zip(x_fracs, v_fracs[1:]):
        x = x + (xf * eps)[:, None] * u * sdc
        _, grad = vg(x)
        u, dk = isokinetic_momentum(u, grad, eps, sdc, coef=vf)
        want_k = want_k + dk
    assert torch.equal(new_state.position, x)
    assert torch.equal(new_state.momentum, u)
    assert torch.equal(kinetic, want_k)


@pytest.mark.parametrize('integrator', ['mclachlan', 'mclachlan_pallas',
                                        'leapfrog'])
def test_airfoil_trajectory_matches_jax(integrator):
    """20 steps of 3 chains on the airfoil posterior against the vmapped
    JAX kernel, with the JAX normals of every refresh injected: positions
    atol 1e-4, ΔE atol 1e-3. (The JAX package's Pallas integrator runs its
    XLA math off the TPU, so 'mclachlan_pallas' is compared with
    'mclachlan' there.)"""
    loader, _, template, bayes = jax_airfoil()
    t_loader, _, t_bayes = torch_airfoil()
    x, y = loader.arrays('train')
    logdensity = bayes.logdensity_fn(x, y)
    n_chains, n_steps, dim = 3, 20, bayes.dim
    theta = (np.random.default_rng(0).normal(size=(n_chains, dim)) * 0.3
             ).astype(np.float32)
    step_size = np.array([0.002, 0.004, 0.006], np.float32)
    L = np.array([0.05, 0.1, 0.2], np.float32)

    jax_name = 'leapfrog' if integrator == 'leapfrog' else 'mclachlan'
    kernel = jax_mclmc.build_kernel(logdensity, integrator=jax_name)
    init_keys = jax.random.split(jax.random.PRNGKey(1), n_chains)
    state = jax.vmap(lambda p, k: jax_mclmc.init(p, logdensity, k))(
        theta, init_keys)
    step_keys = jax.random.split(jax.random.PRNGKey(2), n_steps * n_chains
                                 ).reshape(n_steps, n_chains, -1)

    @jax.jit
    def run(state):
        def one(state, keys):
            state, info = jax.vmap(kernel)(keys, state, L, step_size)
            return state, (state.position, info.energy_change)
        return jax.lax.scan(one, state, step_keys)[1]

    ref_x, ref_de = run(state)
    noise = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (dim,))))(
        step_keys)

    tx, ty = t_loader.arrays('train')
    vg = t_bayes.logdensity_and_grad_fn(tx, ty)
    t_kernel = mclmc.build_kernel(vg, torch.Generator().manual_seed(0),
                                  integrator=integrator,
                                  noise=iter(t(z) for z in noise))
    t_state = mclmc.init(t(theta), vg, momentum=t(state.momentum))
    xs, des = [], []
    for _ in range(n_steps):
        t_state, info = t_kernel(t_state, t(L), t(step_size))
        xs.append(t_state.position)
        des.append(info.energy_change)
    np.testing.assert_allclose(torch.stack(xs).numpy(), np.asarray(ref_x),
                               atol=1e-4)
    np.testing.assert_allclose(torch.stack(des).numpy(), np.asarray(ref_de),
                               atol=1e-3)
