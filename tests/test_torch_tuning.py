"""The port's MCMC diagnostics and MCLMC tuner against analytic
expectations and the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_airfoil, one_torch_thread, t, torch_airfoil  # noqa: F401

from mile_tpu.mcmc import diagnostics as jax_diag
from mile_tpu_torch.mcmc.diagnostics import (
    autocovariance,
    effective_sample_size,
    potential_scale_reduction,
)


def test_autocovariance_matches_numpy():
    x = np.random.default_rng(0).normal(size=(2, 256)).astype(np.float32)
    acov = autocovariance(t(x), dim=1).numpy()
    for c in range(2):
        centered = x[c] - x[c].mean()
        want = np.correlate(centered, centered, mode='full')[255:] / 256
        np.testing.assert_allclose(acov[c], want, atol=1e-4)


def test_ess_iid_close_to_n():
    x = np.random.default_rng(1).normal(size=(4, 1000, 3))
    ess = effective_sample_size(t(x)).numpy()
    assert ess.shape == (3,)
    assert np.all(ess > 2500), ess


def test_ess_ar1_matches_theory():
    rho, n, c = 0.9, 20_000, 2
    rng = np.random.default_rng(2)
    eps = rng.normal(size=(c, n)) * np.sqrt(1 - rho ** 2)
    x = np.zeros((c, n))
    x[:, 0] = rng.normal(size=c)
    for i in range(1, n):
        x[:, i] = rho * x[:, i - 1] + eps[:, i]
    ess = float(effective_sample_size(t(x)[..., None])[0])
    want = c * n * (1 - rho) / (1 + rho)   # ESS/N = (1-ρ)/(1+ρ)
    assert 0.6 * want < ess < 1.6 * want, (ess, want)


@pytest.mark.parametrize('shape', [(4, 500, 3), (1, 64, 2, 5), (3, 37)])
def test_ess_and_rhat_match_jax(shape):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    x = np.cumsum(x, axis=1) * 0.1 + x       # some autocorrelation
    np.testing.assert_allclose(effective_sample_size(t(x)).numpy(),
                               np.asarray(jax_diag.effective_sample_size(x)),
                               rtol=1e-4)
    if shape[0] > 1:
        np.testing.assert_allclose(
            potential_scale_reduction(t(x)).numpy(),
            np.asarray(jax_diag.potential_scale_reduction(x)), rtol=1e-5)


def test_rhat_mixed_and_unmixed_chains():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 2000, 2))
    np.testing.assert_allclose(potential_scale_reduction(t(x)).numpy(), 1.0,
                               atol=0.01)
    x[0] += 5.0
    assert float(potential_scale_reduction(t(x))[0]) > 1.5


def test_energy_schedule_matches_jax():
    from mile_tpu.mcmc.adaptation.mclmc_tuning import TuningConfig as JaxCfg
    from mile_tpu.mcmc.adaptation.mclmc_tuning import _energy_var_schedule
    from mile_tpu_torch.mcmc.adaptation.mclmc_tuning import (
        TuningConfig,
        energy_var_schedule,
    )

    for start, end in ((0.5, 0.1), (5.0, 0.1)):
        ours = energy_var_schedule(TuningConfig(
            desired_energy_var_start=start, desired_energy_var_end=end), 91)
        ref = _energy_var_schedule(JaxCfg(
            desired_energy_var_start=start,
            desired_energy_var_end=end).runtime(), 91)
        for step in (0, 10, 45, 90, 120):
            assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6)


@pytest.mark.parametrize('diagonal', [False, True])
def test_tuned_parameters_match_jax_over_seeds(diagonal):
    """(ε, L) of a 100-step tuning on airfoil against ``mclmc_tune``: 16
    chains from one start, each package with its own noise, compared as
    statistics over the seeds: the means of log ε and log L agree within
    4 standard errors and 15 %, and their spreads within a factor of 2.

    Statistics over seeds, not injected noise: at the tuner's start
    (ε = 0.002) the energy error ΔE is float32 rounding of a log-density of
    order 10³, which the two packages round differently. With the same
    normals injected, one chain's first ε already differs by 2.5 %, and the
    ε⁶ law and the chaotic dynamics then drive the trajectories apart
    within 20 steps. With the preconditioner on, its readjustment runs and
    the tuned sqrt_diag_cov is compared the same way."""
    from mile_tpu.mcmc.adaptation.mclmc_tuning import TuningConfig as JaxCfg
    from mile_tpu.mcmc.adaptation.mclmc_tuning import mclmc_tune as jax_tune
    from mile_tpu_torch.mcmc.adaptation.mclmc_tuning import (
        TuningConfig,
        mclmc_tune,
    )

    loader, _, _, bayes = jax_airfoil()
    t_loader, _, t_bayes = torch_airfoil()
    x, y = loader.arrays('train')
    logdensity = bayes.logdensity_fn(x, y)
    n_seeds, dim = 16, bayes.dim
    knobs = dict(warmup_steps=100, step_size_init=0.002,
                 desired_energy_var_start=0.5, desired_energy_var_end=0.1,
                 diagonal_preconditioning=diagonal)
    start = np.random.default_rng(0).normal(size=(1, dim)) * 0.3
    theta = np.repeat(start, n_seeds, axis=0).astype(np.float32)
    _, ref = jax.jit(jax.vmap(
        lambda p, k: jax_tune(logdensity, p, k, JaxCfg(**knobs))))(
        theta, jax.random.split(jax.random.PRNGKey(3), n_seeds))
    tx, ty = t_loader.arrays('train')
    _, params = mclmc_tune(t_bayes.logdensity_and_grad_fn(tx, ty), t(theta),
                           torch.Generator().manual_seed(1),
                           TuningConfig(**knobs))
    pairs = [(np.asarray(ref.step_size), params.step_size.numpy()),
             (np.asarray(ref.L), params.L.numpy())]
    if diagonal:   # one value per chain: the mean log preconditioner
        pairs.append((np.log(np.asarray(ref.sqrt_diag_cov)).mean(axis=1),
                      params.sqrt_diag_cov.log().mean(dim=1).numpy()))
        pairs[-1] = tuple(np.exp(v) for v in pairs[-1])
    for want, got in pairs:
        a, b = np.log(want), np.log(got)
        se = np.sqrt((a.var() + b.var()) / n_seeds)
        assert abs(a.mean() - b.mean()) < min(4 * se, 0.15), (a, b)
        assert 0.5 < b.std() / a.std() < 2.0, (a, b)


@pytest.mark.parametrize('n', [3, 10, 11, 40])
def test_constant_trace_ess_is_the_compiled_jax_value(n):
    """Draws that are all equal: the JAX package's ESS, compiled (as its
    tuner runs it), centres them on XLA's inexact mean and gives the ESS
    of a constant offset, which ``constant_trace_ess`` computes (rtol
    1e-5); centred exactly, the estimator gives NaN."""
    from mile_tpu_torch.mcmc.diagnostics import constant_trace_ess

    values = np.random.default_rng(n).normal(size=50).astype(np.float32)
    trace = np.repeat(values[None, None], n, axis=1)
    want = np.asarray(jax.jit(jax_diag.effective_sample_size)(trace))
    np.testing.assert_allclose(want, constant_trace_ess(n), rtol=1e-5)
    assert np.isnan(effective_sample_size(t(trace)).numpy()).any()


def test_phase3_L_is_finite_with_a_frozen_coordinate():
    """Phase 3 with a preconditioner entry clamped to 1e-15 (a coordinate
    whose phase-2 variance rounded to 0): the coordinate's trace stays
    constant, and every chain's L is finite, as in the JAX package's
    compiled phase 3 from the same states; the two L agree within 15 %
    (each package with its own noise, 10 steps)."""
    from mile_tpu.mcmc import mclmc as jax_mclmc
    from mile_tpu.mcmc.adaptation import mclmc_tuning as jax_tuning
    from mile_tpu_torch.mcmc import mclmc
    from mile_tpu_torch.mcmc.adaptation.mclmc_tuning import (
        MCLMCTuningParams,
        TuningConfig,
        _phase3_refine_L,
    )

    loader, _, _, bayes = jax_airfoil()
    t_loader, _, t_bayes = torch_airfoil()
    n_chains, dim = 8, bayes.dim
    rng = np.random.default_rng(5)
    theta = (0.3 * rng.normal(size=(n_chains, dim))).astype(np.float32)
    sdc = np.ones((n_chains, dim), np.float32)
    sdc[:, [3, 400]] = 1e-15
    eps = np.full(n_chains, 0.05, np.float32)
    L = np.full(n_chains, 1.0, np.float32)
    x, y = loader.arrays('train')
    logdensity = bayes.logdensity_fn(x, y)
    kernel = jax_mclmc.build_kernel(logdensity)

    def jax_phase3(position, key):
        state = jax_mclmc.init(position, logdensity, key)
        params = jax_tuning.MCLMCTuningParams(
            L=jnp.asarray(1.0), step_size=jnp.asarray(0.05),
            sqrt_diag_cov=jnp.asarray(sdc[0]))
        return jax_tuning._phase3_refine_L(
            kernel, jax_tuning.TuningConfig(), state, params, 10, key)[1].L

    want = np.asarray(jax.jit(jax.vmap(jax_phase3))(
        theta, jax.random.split(jax.random.PRNGKey(0), n_chains)))
    tx, ty = t_loader.arrays('train')
    vg = t_bayes.logdensity_and_grad_fn(tx, ty)
    gen = torch.Generator().manual_seed(0)
    state = mclmc.init(t(theta), vg, gen)
    params = MCLMCTuningParams(L=t(L), step_size=t(eps),
                               sqrt_diag_cov=t(sdc))
    end, got = _phase3_refine_L(mclmc.build_kernel(vg, gen), TuningConfig(),
                                state, params, 10, gen)
    assert torch.equal(end.position[:, [3, 400]], state.position[:, [3, 400]])
    assert np.isfinite(want).all() and torch.isfinite(got.L).all()
    assert abs(np.log(got.L.numpy().mean() / want.mean())) < 0.15


def test_nonfinite_proposals_are_rejected_per_chain():
    """A chain whose proposal is non-finite keeps its state and shrinks its
    step-size cap to 0.8 ε; the other chains move on."""
    from mile_tpu_torch.mcmc import mclmc
    from mile_tpu_torch.mcmc.adaptation.mclmc_tuning import _reject_nonfinite

    def state(x):
        return mclmc.MCLMCState(x, x, x[:, 0], x)

    prev = state(torch.zeros(2, 3))
    new = state(torch.tensor([[1.0, 2.0, 3.0], [1.0, float('nan'), 3.0]]))
    ok, out, cap, de = _reject_nonfinite(
        prev, new, torch.tensor([0.1, 0.2]), torch.full((2,), float('inf')),
        torch.tensor([0.5, 0.7]))
    assert ok.tolist() == [True, False]
    assert torch.equal(out.position[0], new.position[0])
    assert torch.equal(out.position[1], prev.position[1])
    assert cap[0] == float('inf') and cap[1] == pytest.approx(0.16)
    assert de.tolist() == pytest.approx([0.5, 0.0])
