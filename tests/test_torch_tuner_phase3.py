"""The tuner's phase 3 in both packages on fixed traces: the ESS of each
chain's trace and ``L = 0.4 · ε · mean(n / ESS)``.

A stand-in kernel replays a fixed trace, so each package's own
``_phase3_refine_L`` (the JAX one vmapped over chains, as ``mclmc_tune``
runs under vmap) reads the same positions:

- at the full-count length of the studies' tuners (50,000 steps, the
  last tenth of them the phase-3 trace: 5,000 draws), on a few dozen
  coordinates of AR(1) traces of different autocorrelations, with and
  without ``linspace`` sub-sampling (``ess_samples_limit``) and with a
  coordinate that never moves (``constant_trace_ess``): ESS and L within
  rtol 1e-4;
- on a trace of a collapsed step (ε 1e-7 to 3e-6: most coordinates never
  move in float32, some move by a unit in the last place now and then),
  L finite in both and within 5 % (the two FFTs' float32 rounding parts
  such ESS by up to 2 %): the JAX tuner compiled on the CPU gives no NaN
  there, and neither does the port;
- above ``ess_params_limit`` (2,000) coordinates each chain's ESS is taken
  over a random subset of its own coordinates: on one trace of 2,306
  coordinates (the 10-layer FCN of airfoil) repeated in every chain, L
  over 32 chains has the JAX tuner's mean and spread. One subset shared by
  every chain gives every chain the same L.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

from mile_tpu.mcmc import diagnostics as jax_diag
from mile_tpu.mcmc.adaptation import mclmc_tuning as jax_tuning
from mile_tpu_torch.mcmc import diagnostics
from mile_tpu_torch.mcmc.adaptation import mclmc_tuning


class Replay(NamedTuple):
    position: object
    i: object


def ar1_traces(n_chains, n_draws, rhos, seed):
    """(C, N, len(rhos)) float32 AR(1) traces of unit variance."""
    rng = np.random.default_rng(seed)
    rhos = np.asarray(rhos)
    x = np.empty((n_chains, n_draws, len(rhos)))
    x[:, 0] = rng.normal(size=(n_chains, len(rhos)))
    noise = rng.normal(size=(n_chains, n_draws, len(rhos)))
    for i in range(1, n_draws):
        x[:, i] = rhos * x[:, i - 1] + np.sqrt(1 - rhos ** 2) * noise[:, i]
    return x.astype(np.float32)


def jax_L(traces, eps, cfg, seed=0):
    """The JAX package's phase 3 over (C, N, dim) ``traces``: L per chain."""
    n_chains, n_draws, dim = traces.shape

    def one(trace, step_size, key):
        def kernel(key, state, L, step_size, sqrt_diag_cov):
            return Replay(trace[state.i], state.i + 1), None

        params = jax_tuning.MCLMCTuningParams(
            L=jnp.asarray(1.0), step_size=step_size,
            sqrt_diag_cov=jnp.ones(dim))
        _, out = jax_tuning._phase3_refine_L(
            kernel, cfg, Replay(jnp.zeros(dim), jnp.asarray(0)), params,
            n_draws, key)
        return out.L

    keys = jax.random.split(jax.random.PRNGKey(seed), n_chains)
    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(traces),
                                             jnp.asarray(eps), keys))


def port_L(traces, eps, cfg, seed=0):
    """The port's phase 3 over the same (C, N, dim) ``traces``."""
    n_chains, n_draws, dim = traces.shape
    steps = torch.as_tensor(traces).transpose(0, 1).contiguous()

    def kernel(state, L, step_size, sqrt_diag_cov):
        return Replay(steps[state.i], state.i + 1), None

    params = mclmc_tuning.MCLMCTuningParams(
        L=torch.ones(n_chains), step_size=torch.as_tensor(eps),
        sqrt_diag_cov=None)
    _, out = mclmc_tuning._phase3_refine_L(
        kernel, cfg, Replay(torch.zeros(n_chains, dim), 0), params, n_draws,
        torch.Generator().manual_seed(seed))
    return out.L.numpy()


RHOS = np.linspace(0.0, 0.95, 36)


@pytest.mark.parametrize('samples_limit,constant', [
    (10_000, False), (2_000, False), (10_000, True)])
def test_phase3_ess_and_L_agree_on_a_full_count_trace(samples_limit,
                                                      constant):
    """5,000 draws of 3 chains; 36 coordinates (37 with one that never
    moves); the full trace, or its 2,000 ``linspace`` draws."""
    traces = ar1_traces(3, 5_000, RHOS, seed=1)
    if constant:
        traces = np.concatenate(
            [traces, np.full(traces.shape[:2] + (1,), 0.25, np.float32)], 2)
    eps = np.asarray([0.04, 0.03, 0.05], np.float32)
    if not constant:   # the ESS itself (one chain at a time, as phase 3)
        for chain in traces:
            np.testing.assert_allclose(
                diagnostics.effective_sample_size(
                    torch.as_tensor(chain)[None]).numpy(),
                np.asarray(jax_diag.effective_sample_size(chain[None])),
                rtol=1e-4)
    cfg_j = jax_tuning.TuningConfig(ess_samples_limit=samples_limit)
    cfg_p = mclmc_tuning.TuningConfig(ess_samples_limit=samples_limit)
    want, got = jax_L(traces, eps, cfg_j), port_L(traces, eps, cfg_p)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_phase3_L_is_finite_on_a_near_frozen_trace():
    """3 chains x 5,000 draws x 48 coordinates near 0.3-1.0, each moved
    by float32 steps of 1e-10 to 1e-6: about half never move."""
    rng = np.random.default_rng(3)
    n_chains, n_draws, dim = 3, 5_000, 48
    current = rng.uniform(0.3, 1.0, (n_chains, dim)).astype(np.float32)
    scale = np.logspace(-10, -6, dim).astype(np.float32)
    traces = np.empty((n_chains, n_draws, dim), np.float32)
    for i in range(n_draws):
        current = current + (rng.normal(size=(n_chains, dim))
                             * scale).astype(np.float32)
        traces[:, i] = current
    frozen = (traces == traces[:, :1]).all(axis=1)
    assert 10 < frozen.sum(axis=1).min() and frozen.sum(axis=1).max() < 38
    eps = np.asarray([1e-7, 1e-6, 3e-6], np.float32)
    want = jax_L(traces, eps, jax_tuning.TuningConfig())
    got = port_L(traces, eps, mclmc_tuning.TuningConfig())
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0.05)


def test_each_chain_draws_its_own_coordinates_above_the_limit():
    """2,306 coordinates, 23 of them slow random walks: L follows how many
    of the 23 a chain's 2,000 coordinates hold. The same trace in each of
    32 chains: L's mean within 4 standard errors of the JAX tuner's and its
    spread over chains within a factor of 2 of JAX's."""
    n_chains, n_draws, dim = 32, 200, 2306
    rng = np.random.default_rng(2)
    trace = rng.normal(size=(n_draws, dim))
    slow = rng.choice(dim, 23, replace=False)
    trace[:, slow] = np.cumsum(trace[:, slow], axis=0)
    traces = np.broadcast_to(trace.astype(np.float32),
                             (n_chains, n_draws, dim))
    eps = np.full(n_chains, 0.04, np.float32)
    want = jax_L(traces, eps, jax_tuning.TuningConfig())
    got = port_L(np.ascontiguousarray(traces), eps,
                 mclmc_tuning.TuningConfig())
    assert want.std() > 0.01 * want.mean()   # the subset moves L
    se = np.sqrt((want.var(ddof=1) + got.var(ddof=1)) / n_chains)
    assert abs(got.mean() - want.mean()) < 4 * se, (got, want)
    assert 0.5 < got.std(ddof=1) / want.std(ddof=1) < 2.0, (got, want)
