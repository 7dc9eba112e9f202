"""The port's HMC, NUTS and window adaptation against the JAX package.

The JAX kernels draw from threefry keys and take no injected numbers, so
each test replays the JAX key splits itself (``hmc.py:55``,
``nuts.py:93,198,123``), derives the same normals and uniforms from them,
and feeds them to the port through its ``draws=`` source. JAX-side work is
kept small (max depth 5, narrow networks) because NUTS compiles slowly on
the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_airfoil, one_torch_thread, t, torch_airfoil  # noqa: F401

from mile_tpu.config.training import Sampler as JaxSampler
from mile_tpu.mcmc import hmc as jax_hmc
from mile_tpu.mcmc import nuts as jax_nuts
from mile_tpu.mcmc.adaptation import dual_averaging as jax_da
from mile_tpu.mcmc.adaptation import mass_matrix as jax_mm
from mile_tpu.mcmc.adaptation import window as jax_window
from mile_tpu.mcmc.integrators import EuclideanState as JaxEuclidean
from mile_tpu.mcmc.integrators import velocity_verlet as jax_verlet
from mile_tpu.train.sampling_hmc import _aggregate_thin
from mile_tpu_torch.bayes.posterior import value_and_grad
from mile_tpu_torch.config import SamplerConfig
from mile_tpu_torch.config.training import Sampler
from mile_tpu_torch.mcmc import hmc, nuts
from mile_tpu_torch.mcmc.adaptation import dual_averaging as da
from mile_tpu_torch.mcmc.adaptation import mass_matrix as mm
from mile_tpu_torch.mcmc.adaptation import window
from mile_tpu_torch.mcmc.integrators import EuclideanState, velocity_verlet
from mile_tpu_torch.train.sampling_hmc import aggregate_thin, run_hmc_family

MAX_DEPTH = 5


class ReplayDraws:
    """A ``draws=`` source that hands out given arrays in call order,
    checking that each call asks for the shape it holds."""

    def __init__(self, calls):
        self.calls = list(calls)

    def _next(self, kind, shape):
        want_kind, value = self.calls.pop(0)
        assert want_kind == kind and tuple(value.shape) == tuple(shape), (
            kind, shape, want_kind, value.shape)
        return t(value)

    def normal(self, shape):
        return self._next('normal', shape)

    def uniform(self, shape):
        return self._next('uniform', shape)


def nuts_draws(keys, dim, max_depth=MAX_DEPTH):
    """The numbers one JAX NUTS step draws per chain from ``keys``, in the
    port's call order: the momentum normals, then per doubling the
    direction and bias uniforms and one swap uniform per leaf."""
    per_chain = []
    for key in keys:
        key_mom, rng = jax.random.split(key)
        out = [np.asarray(jax.random.normal(key_mom, (dim,)))]
        for depth in range(max_depth):
            rng, key_dir, key_bias, sub = jax.random.split(rng, 4)
            swaps = []
            for _ in range(1 << depth):
                sub, key_swap = jax.random.split(sub)
                swaps.append(jax.random.uniform(key_swap))
            out += [np.asarray(jax.random.uniform(key_dir)),
                    np.asarray(jax.random.uniform(key_bias)),
                    np.asarray(swaps)]
        per_chain.append(out)
    kinds = ['normal'] + ['uniform'] * (3 * max_depth)
    return ReplayDraws((k, np.stack([c[i] for c in per_chain]))
                       for i, k in enumerate(kinds))


def hmc_draws(keys, dim):
    normals, uniforms = [], []
    for key in keys:
        key_mom, key_acc = jax.random.split(key)
        normals.append(np.asarray(jax.random.normal(key_mom, (dim,))))
        uniforms.append(np.asarray(jax.random.uniform(key_acc)))
    return ReplayDraws([('normal', np.stack(normals)),
                        ('uniform', np.stack(uniforms))])


# ------------------------------------------------------------- targets
def correlated_gaussian(dim=5, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(dim, dim)).astype(np.float32)
    prec = (a @ a.T / dim + 0.2 * np.eye(dim)).astype(np.float32)
    jprec = jnp.asarray(prec)
    tprec = t(prec)
    return (lambda x: -0.5 * x @ jprec @ x,
            value_and_grad(lambda x: -0.5 * torch.sum((x @ tprec) * x, dim=1)),
            dim)


def narrow_fcn():
    loader, _, _, bayes = jax_airfoil(hidden=(8, 2))
    x, y = loader.arrays('train')
    t_loader, _, t_bayes = torch_airfoil(hidden=(8, 2))
    tx, ty = t_loader.arrays('train')
    return (bayes.logdensity_fn(x, y),
            t_bayes.logdensity_and_grad_fn(tx, ty), bayes.dim)


# --------------------------------------------------------------- tests
def test_bit_helpers_match_jax():
    n = np.arange(1, 2049)
    jax_pc = np.asarray(jax_nuts._popcount(jnp.asarray(n)))
    jax_tz = np.asarray(jax_nuts._trailing_zeros(jnp.asarray(n)))
    assert [nuts._popcount(int(i)) for i in n] == jax_pc.tolist()
    assert [nuts._trailing_zeros(int(i)) for i in n] == jax_tz.tolist()


@pytest.mark.parametrize('budget', [10, 19, 20, 100, 150, 1000, 1003])
def test_build_schedule_matches_jax(budget):
    np.testing.assert_array_equal(window.build_schedule(budget),
                                  jax_window.build_schedule(budget))


def test_dual_averaging_matches_jax():
    """50 updates of 4 chains over the same acceptance sequence, with a
    restart at the averaged step size halfway: rtol 1e-6."""
    rng = np.random.default_rng(0)
    eps0 = np.array([1e-3, 0.1, 1.0, 3.0], np.float32)
    acc = rng.uniform(0, 1, size=(50, 4)).astype(np.float32)
    ref, ours = jax_da.da_init(jnp.asarray(eps0)), da.da_init(t(eps0))
    for i, a in enumerate(acc):
        ref = jax_da.da_update(ref, jnp.asarray(a), target=0.9)
        ours = da.da_update(ours, t(a), target=0.9)
        if i == 24:
            ref = jax_da.da_init(jax_da.da_final(ref))
            ours = da.da_init(da.da_final(ours))
        for want, got in zip(ref, ours):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)
    np.testing.assert_allclose(da.da_final(ours).numpy(),
                               np.asarray(jax_da.da_final(ref)), rtol=1e-6)


def test_welford_matches_jax():
    """Welford over the same 40 positions of 3 chains: mean, m2 and both
    variances within rtol 1e-5."""
    values = np.random.default_rng(1).normal(
        2.0, 3.0, size=(40, 3, 7)).astype(np.float32)
    refs = [jax_mm.welford_init(7) for _ in range(3)]
    ours = mm.welford_init(t(values[0]))
    for v in values:
        refs = [jax_mm.welford_update(r, jnp.asarray(v[c]))
                for c, r in enumerate(refs)]
        ours = mm.welford_update(ours, t(v))
    assert ours.count == float(refs[0].count) == 40.0
    for field in ('mean', 'm2'):
        np.testing.assert_allclose(
            getattr(ours, field).numpy(),
            np.stack([np.asarray(getattr(r, field)) for r in refs]),
            rtol=1e-5)
    for regularized in (True, False):
        np.testing.assert_allclose(
            mm.welford_variance(ours, regularized).numpy(),
            np.stack([np.asarray(jax_mm.welford_variance(r, regularized))
                      for r in refs]), rtol=1e-5)


def test_velocity_verlet_matches_jax():
    """One leapfrog step of 3 chains on the airfoil FCN posterior, per-chain
    signed ε and M⁻¹: q' within rtol 1e-6, p' within atol 1e-4 of momenta of
    order 10-100, logp' within rtol 1e-6."""
    loader, _, _, bayes = jax_airfoil()
    x, y = loader.arrays('train')
    logdensity = bayes.logdensity_fn(x, y)
    t_loader, _, t_bayes = torch_airfoil()
    vg = t_bayes.logdensity_and_grad_fn(*t_loader.arrays('train'))
    rng = np.random.default_rng(2)
    q = (rng.normal(size=(3, bayes.dim)) * 0.3).astype(np.float32)
    p = rng.normal(size=(3, bayes.dim)).astype(np.float32) * 10.0
    imm = rng.uniform(0.5, 1.5, size=(3, bayes.dim)).astype(np.float32)
    eps = np.array([1e-4, -3e-4, 1e-3], np.float32)

    def jax_step(q, p, eps, imm):
        logp, grad = jax.value_and_grad(logdensity)(q)
        return jax_verlet(logdensity, imm)(JaxEuclidean(q, p, logp, grad),
                                           eps)

    ref = jax.jit(jax.vmap(jax_step))(q, p, eps, imm)
    logp, grad = vg(t(q))
    ours = velocity_verlet(vg, t(imm))(
        EuclideanState(t(q), t(p), logp, grad), t(eps))
    np.testing.assert_allclose(ours.position.numpy(),
                               np.asarray(ref.position), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ours.momentum.numpy(),
                               np.asarray(ref.momentum), atol=1e-4)
    np.testing.assert_allclose(ours.logdensity.numpy(),
                               np.asarray(ref.logdensity), rtol=1e-6)


def test_hmc_step_matches_jax():
    """An HMC step of 4 chains on the narrow FCN posterior with the JAX
    kernel's draws injected: the same accept decisions (among them both
    outcomes) and positions within atol 1e-4."""
    logdensity, vg, dim = narrow_fcn()
    rng = np.random.default_rng(3)
    q = (rng.normal(size=(4, dim)) * 0.3).astype(np.float32)
    imm = rng.uniform(0.5, 1.5, size=(4, dim)).astype(np.float32)
    eps = np.array([1e-3, 3e-3, 1e-2, 3e-2], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), 4)
    kernel = jax_hmc.build_kernel(logdensity, num_integration_steps=8)
    ref_state, ref_info = jax.jit(jax.vmap(
        lambda k, q, e, m: kernel(k, jax_hmc.init(q, logdensity), e, m)))(
        keys, q, eps, imm)
    ours, info = hmc.build_kernel(vg, num_integration_steps=8,
                                  draws=hmc_draws(keys, dim))(
        hmc.init(t(q), vg), t(eps), t(imm))
    accepted = np.asarray(ref_info.is_accepted)
    assert accepted.any() and not accepted.all(), accepted
    np.testing.assert_array_equal(info.is_accepted.numpy(), accepted)
    np.testing.assert_allclose(ours.position.numpy(),
                               np.asarray(ref_state.position), atol=1e-4)
    np.testing.assert_allclose(info.acceptance_rate.numpy(),
                               np.asarray(ref_info.acceptance_rate),
                               atol=1e-3)


# (target, per-chain step sizes, key, position atol, whether a chain stops
# inside a subtree on a sub-U-turn found through the checkpoints); chain
# 3's step size diverges at once
NUTS_CASES = {
    'correlated_gaussian': (correlated_gaussian, [0.05, 0.2, 0.5, 30.0], 18,
                            1e-5, True),
    'narrow_fcn': (narrow_fcn, [1e-3, 3e-3, 1e-2, 1.0], 6, 1e-4, False),
}


@pytest.mark.parametrize('target', NUTS_CASES)
def test_nuts_step_matches_jax(target):
    """A NUTS step (max depth 5) of 4 chains with the JAX kernel's draws
    injected: depth, number of integration steps, is_turning and
    is_divergent identical per chain, positions within the case's atol
    (1e-5 on the Gaussian, 1e-4 on the FCN posterior)."""
    make, eps, key, atol, sub_turn = NUTS_CASES[target]
    logdensity, vg, dim = make()
    rng = np.random.default_rng(5)
    q = (rng.normal(size=(4, dim)) * 0.3).astype(np.float32)
    imm = rng.uniform(0.5, 1.5, size=(4, dim)).astype(np.float32)
    eps = np.asarray(eps, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(key), 4)
    kernel = jax_nuts.build_kernel(logdensity, max_depth=MAX_DEPTH)
    ref_state, ref_info = jax.jit(jax.vmap(
        lambda k, q, e, m: kernel(k, jax_nuts.init(q, logdensity), e, m)))(
        keys, q, eps, imm)
    ours, info = nuts.build_kernel(vg, max_depth=MAX_DEPTH,
                                   draws=nuts_draws(keys, dim))(
        nuts.init(t(q), vg), t(eps), t(imm))
    for field in ('num_trajectory_expansions', 'num_integration_steps',
                  'is_turning', 'is_divergent'):
        np.testing.assert_array_equal(getattr(info, field).numpy(),
                                      np.asarray(getattr(ref_info, field)),
                                      err_msg=field)
    divergent = np.asarray(ref_info.is_divergent)
    assert divergent[3] and not divergent[:3].any(), divergent
    steps = np.asarray(ref_info.num_integration_steps)
    depth = np.asarray(ref_info.num_trajectory_expansions)
    assert (steps != 2 ** depth - 1).any() == sub_turn, (steps, depth)
    np.testing.assert_allclose(ours.position.numpy(),
                               np.asarray(ref_state.position), atol=atol)
    np.testing.assert_allclose(info.acceptance_rate.numpy(),
                               np.asarray(ref_info.acceptance_rate),
                               atol=1e-3)


def test_find_reasonable_step_size_matches_jax():
    """Bracketing from seeds far too small and far too large, with the JAX
    search's momentum injected: the same ε, bit for bit (it is the seed
    times a power of 2)."""
    logdensity, vg, dim = narrow_fcn()
    rng = np.random.default_rng(7)
    q = (rng.normal(size=(4, dim)) * 0.3).astype(np.float32)
    imm = rng.uniform(0.5, 1.5, size=(4, dim)).astype(np.float32)
    seeds = np.array([1e-7, 1e-3, 0.5, 100.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(8), 4)
    ref = jax.jit(jax.vmap(
        lambda q, k, m, e: jax_window.find_reasonable_step_size(
            logdensity, q, k, inverse_mass_matrix=m, initial_step_size=e)))(
        q, keys, imm, seeds)
    normals = np.stack([np.asarray(jax.random.normal(k, (dim,)))
                        for k in keys])
    ours = window.find_reasonable_step_size(
        vg, t(q), ReplayDraws([('normal', normals)]),
        inverse_mass_matrix=t(imm), initial_step_size=t(seeds))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert len(set(np.round(np.log2(ours.numpy() / seeds)))) > 1


def test_thin_aggregation_matches_jax():
    rng = np.random.default_rng(9)
    infos = {
        'acceptance_rate': rng.uniform(size=(3, 4)).astype(np.float32),
        'is_divergent': rng.uniform(size=(3, 4)) < 0.3,
        'is_accepted': rng.uniform(size=(3, 4)) < 0.5,
        'is_turning': rng.uniform(size=(3, 4)) < 0.5,
        'num_integration_steps': rng.integers(1, 64, (3, 4), np.int32),
        'num_trajectory_expansions': rng.integers(1, 7, (3, 4), np.int32),
        'energy': rng.normal(size=(3, 4)).astype(np.float32),
    }
    ref = _aggregate_thin({k: jnp.asarray(v) for k, v in infos.items()})
    ours = aggregate_thin({k: torch.from_numpy(v) for k, v in infos.items()})
    assert set(ours) == set(ref)
    for k in ref:
        want, got = np.asarray(ref[k]), ours[k].numpy()
        assert got.dtype == want.dtype, (k, got.dtype, want.dtype)
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize('name', [Sampler.NUTS, Sampler.HMC])
def test_window_adapted_runtime_gaussian(name):
    """The checks of ``tests/test_nuts_hmc.py``'s runtime test, on the
    port: draws of the right shape, acceptance near target, the target's
    variances recovered and the mass matrix's scale structure learned."""
    dim = 8
    scales = torch.linspace(0.5, 2.0, dim)
    vg = value_and_grad(lambda x: -0.5 * torch.sum((x / scales) ** 2, dim=1))
    n_samples = 2000 if name == Sampler.NUTS else 6000
    cfg = SamplerConfig(name=name, warmup_steps=500, n_chains=2,
                        n_samples=n_samples, n_thinning=2, step_size_init=0.5,
                        num_integration_steps=16)
    x0 = torch.randn(2, dim, generator=torch.Generator().manual_seed(0)) \
        * scales
    res = run_hmc_family(vg, cfg, torch.Generator().manual_seed(1), x0)
    assert res.samples.shape == (2, n_samples // 2, dim)
    acc = res.info['acceptance_rate']
    assert 0.55 < float(np.nanmean(acc)) <= 1.0
    var = res.samples[:, 200:].reshape(-1, dim).var(axis=0)
    np.testing.assert_allclose(var, scales.numpy() ** 2, rtol=0.4)
    imm = res.tuned['inverse_mass_matrix']
    assert imm[:, -1].mean() / imm[:, 0].mean() > 4.0
    assert set(res.tuned) == {'step_size', 'inverse_mass_matrix',
                              'bracketed_step_size',
                              'final_buffer_acceptance'}


@pytest.mark.parametrize('name', [JaxSampler.NUTS, JaxSampler.HMC])
def test_adapted_parameters_match_jax_over_seeds(name):
    """(ε, M⁻¹) of a 300-step window adaptation on a scaled Gaussian
    against ``run_window_adaptation``: 16 chains from one start, each
    package with its own randomness, compared as statistics over the
    seeds. Mean log ε within 4 standard errors and 15 %, its spread within
    a factor of 2.5; per coordinate, the mean log M⁻¹ within 4 standard
    errors and 0.25."""
    dim, n_seeds, steps = 8, 16, 300
    scales = np.linspace(0.5, 2.0, dim).astype(np.float32)
    js = jnp.asarray(scales)
    logdensity = lambda x: -0.5 * jnp.sum((x / js) ** 2)
    ts = t(scales)
    vg = value_and_grad(lambda x: -0.5 * torch.sum((x / ts) ** 2, dim=1))
    start = np.repeat(scales[None] * 0.5, n_seeds, axis=0)

    def jax_kernel():
        if name == JaxSampler.NUTS:
            return jax_nuts.build_kernel(logdensity, max_depth=MAX_DEPTH)
        return jax_hmc.build_kernel(logdensity, num_integration_steps=8)

    def adapt(q, key):
        state = jax_nuts.init(q, logdensity)
        return jax_window.run_window_adaptation(
            jax_kernel(), state, key, steps, initial_step_size=0.5,
            target_acceptance_rate=0.9, logdensity_fn=logdensity)[1:]

    ref_eps, ref_imm = jax.jit(jax.vmap(adapt))(
        start, jax.random.split(jax.random.PRNGKey(10), n_seeds))
    draws = hmc.Draws(torch.Generator().manual_seed(11))
    kernel = (nuts.build_kernel(vg, max_depth=MAX_DEPTH, draws=draws)
              if name == JaxSampler.NUTS else
              hmc.build_kernel(vg, num_integration_steps=8, draws=draws))
    _, eps, imm = window.run_window_adaptation(
        kernel, hmc.init(t(start), vg), draws, steps, initial_step_size=0.5,
        target_acceptance_rate=0.9, logdensity_and_grad=vg)
    a, b = np.log(np.asarray(ref_eps)), np.log(eps.numpy())
    se = np.sqrt((a.var() + b.var()) / n_seeds)
    assert abs(a.mean() - b.mean()) < min(4 * se, 0.15), (a, b)
    assert 0.4 < b.std() / a.std() < 2.5, (a, b)
    a, b = np.log(np.asarray(ref_imm)), np.log(imm.numpy())
    se = np.sqrt((a.var(axis=0) + b.var(axis=0)) / n_seeds)
    diff = np.abs(a.mean(axis=0) - b.mean(axis=0))
    assert (diff < np.minimum(4 * se, 0.25)).all(), (diff, se)


@pytest.mark.parametrize('case', ['keep_warmup', 'warmup_depth_cap'])
def test_runtime_options(case):
    """``keep_warmup`` returns the adaptation trajectory (the checks of
    ``tests/test_nuts_hmc.py``'s trace test, here with the restart at the
    initial positions); a warmup depth cap holds the adaptation's trees
    only (its depth-cap test)."""
    from mile_tpu_torch.mcmc.nuts import NUTSKernel

    dim = 6
    vg = value_and_grad(lambda x: -0.5 * torch.sum(x * x, dim=1))
    x0 = torch.randn(2, dim, generator=torch.Generator().manual_seed(0))
    if case == 'keep_warmup':
        cfg = SamplerConfig(name=Sampler.NUTS, warmup_steps=120, n_chains=2,
                            n_samples=40, n_thinning=2, step_size_init=0.5,
                            keep_warmup=True, use_warmup_as_init=False)
    else:
        cfg = SamplerConfig(name=Sampler.NUTS, warmup_steps=30, n_chains=2,
                            n_samples=10, step_size_init=0.5,
                            target_acceptance=0.8, max_num_doublings=10,
                            warmup_max_num_doublings=4)
    depths = {}
    call = NUTSKernel.__call__

    def recorded(kernel, *args):
        state, info = call(kernel, *args)
        depths.setdefault(kernel.max_depth, []).append(
            int(info.num_trajectory_expansions.max()))
        return state, info

    NUTSKernel.__call__ = recorded
    try:
        res = run_hmc_family(vg, cfg, torch.Generator().manual_seed(1), x0)
    finally:
        NUTSKernel.__call__ = call
    n_kept = cfg.n_samples // cfg.n_thinning
    assert res.samples.shape == (2, n_kept, dim)
    assert np.isfinite(res.samples).all()
    if case == 'keep_warmup':
        assert res.info['warmup_trace'].shape == (2, 120, dim)
        assert np.isfinite(res.info['warmup_trace']).all()
        assert list(depths) == [10]
    else:
        assert 'warmup_trace' not in res.info
        assert len(depths[4]) == 30 and max(depths[4]) <= 4
        assert len(depths[10]) == 10


def test_run_sampler_dispatch():
    from mile_tpu_torch.exceptions import SamplerNotImplementedError
    from mile_tpu_torch.train.sampling import run_sampler

    vg = value_and_grad(lambda x: -0.5 * torch.sum(x * x, dim=1))
    x0 = torch.zeros(2, 3)
    for name, keys in ((Sampler.MCLMC, {'L', 'step_size', 'sqrt_diag_cov'}),
                       (Sampler.HMC, {'step_size', 'inverse_mass_matrix',
                                      'bracketed_step_size',
                                      'final_buffer_acceptance'})):
        cfg = SamplerConfig(name=name, warmup_steps=20, n_chains=2,
                            n_samples=4, step_size_init=0.1)
        res = run_sampler(vg, cfg, torch.Generator().manual_seed(0), x0)
        assert set(res.tuned) == keys and res.samples.shape == (2, 4, 3)
    # the JAX package has no epoch-wise sampling either, and says so
    with pytest.raises(SamplerNotImplementedError,
                       match='the posterior is full-batch by design'):
        run_sampler(vg, SamplerConfig(epoch_wise_sampling=True),
                    torch.Generator(), x0)
