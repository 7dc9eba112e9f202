"""MCLMC hyperparameter adaptation: step size ε and decoherence length L
(counterpart of ``mile_tpu/mcmc/adaptation/mclmc_tuning.py``).

The algorithm is the JAX package's, per chain, with the chain axis written
out so all chains tune in one batch:

Phase 1+2 (ratio 0.8/0.1 of the budget): one kernel step per iteration.
  - ε from energy-variance control: an exponentially decayed,
    trust-weighted average of ``ΔE²/(dim·v(t))·ε⁻⁶`` sets ``ε = avg^{-1/6}``
    (the Var[ΔE] = O(ε⁶) law), capped at the largest ε seen before a
    divergence.
  - During phase 2 only, ε-weighted streaming of E[x] and E[x²] gives the
    coordinate variances → ``L = sqrt(Σ var)``; with diagonal
    preconditioning ``sqrt_diag_cov = sqrt(var)``, ``L = sqrt(dim)`` and a
    short ε re-adjustment follows.
  - Non-finite proposals are rejected per chain (``torch.where``, no host
    branch): state reverted, ε cap shrunk by 0.8, the sample excluded.

Phase 3 (ratio 0.1): run the tuned kernel, estimate the ESS of the trace
by FFT autocorrelation, refine ``L = 0.4 · ε · n_steps / ESS``. A
coordinate whose trace stays constant (with diagonal preconditioning, one
whose phase-2 variance rounded to 0 and was clamped to 1e-30 moves by
less than a float32 unit) gets the ESS the JAX package's compiled tuner
gives it (:func:`~mile_tpu_torch.mcmc.diagnostics.constant_trace_ess`),
not NaN, which would make the chain's L NaN and its draws with it.

The schedule value v(t) is a host number, so a step makes no host sync.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from mile_tpu_torch.mcmc import mclmc
from mile_tpu_torch.mcmc.diagnostics import (
    constant_trace_ess,
    effective_sample_size,
)


class MCLMCTuningParams(NamedTuple):
    L: torch.Tensor              # (C,)
    step_size: torch.Tensor      # (C,)
    sqrt_diag_cov: Optional[torch.Tensor]  # (C, dim), None: identity


class TuningConfig(NamedTuple):
    """Tuner knobs (mirror ``SamplerConfig`` fields)."""

    warmup_steps: int = 1000
    phase_ratio: tuple = (0.8, 0.1, 0.1)
    step_size_init: float = 0.005
    desired_energy_var_start: float = 5e-4
    desired_energy_var_end: float = 5e-4
    trust_in_estimate: float = 1.5
    num_effective_samples: int = 100
    diagonal_preconditioning: bool = False
    integrator: str = 'mclachlan'
    ess_params_limit: int = 2000   # coordinate subsample cap for phase-3 FFT
    ess_samples_limit: int = 10000  # trace-length cap for phase-3 FFT
    trace_every: int = 0  # keep every Nth phase-1/2 position (0 = none)


def energy_var_schedule(cfg: TuningConfig, total_steps: int
                        ) -> Callable[[int], float]:
    """Desired energy variance at a step: exponential decay when the start
    value is large (> 2), else linear."""
    start, end = cfg.desired_energy_var_start, cfg.desired_energy_var_end
    tau = total_steps / 4.0

    def sched(step: int) -> float:
        if start > 2.0:
            decay = math.exp(-step / tau)
            return start * decay + end * (1.0 - decay)
        return start - (start - end) * min(step / total_steps, 1.0)

    return sched


class _AdaptState(NamedTuple):
    state: mclmc.MCLMCState
    params: MCLMCTuningParams
    time: torch.Tensor           # (C,) decayed weight sum of the ε estimator
    x_avg: torch.Tensor          # (C,) decayed average of xi/ε⁶
    step_size_max: torch.Tensor  # (C,) divergence cap
    stream_w: torch.Tensor       # (C,) streamed weight of E[x], E[x²]
    mean_x: torch.Tensor         # (C, dim)
    mean_x2: torch.Tensor        # (C, dim)


def _fresh(state, params) -> _AdaptState:
    n_chains, dim = state.position.shape
    zeros = torch.zeros(n_chains, device=state.position.device)
    return _AdaptState(state, params, zeros, zeros,
                       torch.full_like(zeros, math.inf), zeros,
                       torch.zeros_like(state.position),
                       torch.zeros_like(state.position))


def _reject_nonfinite(prev_state, new_state, step_size, step_size_max,
                      energy_change):
    """Revert chains whose proposal (or energy change) is non-finite."""
    ok = torch.isfinite(new_state.position).all(dim=1) \
        & torch.isfinite(energy_change)

    def pick(new, old):
        mask = ok.view(-1, *([1] * (new.dim() - 1)))
        return torch.where(mask, torch.nan_to_num(new), old)

    state = mclmc.MCLMCState(*(pick(n, o) for n, o in zip(new_state,
                                                           prev_state)))
    step_size_max = torch.where(ok, step_size_max, step_size * 0.8)
    energy_change = torch.where(ok, torch.nan_to_num(energy_change),
                                torch.zeros_like(energy_change))
    return ok, state, step_size_max, energy_change


def _phase12_step(kernel, carry: _AdaptState, dim: int, target: float,
                  decay: float, trust: float, in_phase2: bool) -> _AdaptState:
    new_state, info = kernel(carry.state, carry.params.L,
                             carry.params.step_size,
                             carry.params.sqrt_diag_cov)
    ok, state, step_size_max, energy_change = _reject_nonfinite(
        carry.state, new_state, carry.params.step_size,
        carry.step_size_max, info.energy_change)

    # ε from the Var[ΔE] = O(ε⁶) law, trust-weighted
    xi = energy_change * energy_change / (dim * target) + 1e-8
    weight = torch.exp(-0.5 * torch.square(torch.log(xi) / (6.0 * trust)))
    x_avg = decay * carry.x_avg + weight * (
        xi / torch.pow(carry.params.step_size, 6.0))
    time = decay * carry.time + weight
    step_size = torch.minimum(torch.pow(x_avg / time, -1.0 / 6.0),
                              step_size_max)
    params = carry.params._replace(step_size=step_size)

    stream_w, mean_x, mean_x2 = carry.stream_w, carry.mean_x, carry.mean_x2
    if in_phase2:   # ε-weighted streaming of E[x], E[x²]
        w = ok.to(step_size.dtype) * step_size
        stream_w = carry.stream_w + w
        frac = (w / torch.clamp_min(stream_w, 1e-30))[:, None]
        mean_x = mean_x + frac * (state.position - mean_x)
        mean_x2 = mean_x2 + frac * (torch.square(state.position) - mean_x2)
    return _AdaptState(state, params, time, x_avg, step_size_max, stream_w,
                       mean_x, mean_x2)


def _phase3_refine_L(kernel, cfg: TuningConfig, state, params,
                     num_steps: int, generator: torch.Generator):
    """ESS-based L refinement over a ``num_steps`` trace of the tuned kernel."""
    n_chains, dim = state.position.shape
    trace = torch.empty(num_steps, n_chains, dim,
                        device=state.position.device)
    for i in range(num_steps):
        state, _ = kernel(state, params.L, params.step_size,
                          params.sqrt_diag_cov)
        trace[i] = state.position
    if dim > cfg.ess_params_limit:
        coords = torch.randperm(dim, generator=generator)[
            :cfg.ess_params_limit].to(trace.device)
        trace = trace[..., coords]
    if num_steps > cfg.ess_samples_limit:
        idx = torch.linspace(0, num_steps - 1, cfg.ess_samples_limit).long()
        trace = trace[idx.to(trace.device)]
    # one chain per ESS: the chain axis rides along as a parameter axis
    ess = effective_sample_size(trace[None])           # (C, coords)
    # (two equal values average exactly, and give NaN there too)
    frozen = (trace == trace[:1]).all(dim=0)
    if trace.shape[0] > 2 and bool(frozen.any()):
        ess = torch.where(frozen, constant_trace_ess(trace.shape[0]), ess)
    L = 0.4 * params.step_size * torch.mean(num_steps / ess, dim=1)
    return state, params._replace(L=L)


def mclmc_tune(logdensity_and_grad: Callable, position: torch.Tensor,
               generator: torch.Generator, cfg: TuningConfig):
    """Tune (ε, L, sqrt_diag_cov) for every chain of ``position`` (C, dim).

    ``sqrt_diag_cov`` stays None (no preconditioner) unless
    ``cfg.diagonal_preconditioning``. Returns ``(state, params)``, or
    ``(state, params, trace)`` with ``trace`` (C, kept, dim) when
    ``cfg.trace_every`` is set.
    """
    n_chains, dim = position.shape
    device = position.device
    kernel = mclmc.build_kernel(logdensity_and_grad, generator,
                                integrator=cfg.integrator)

    t1 = int(cfg.warmup_steps * cfg.phase_ratio[0])
    t2 = int(cfg.warmup_steps * cfg.phase_ratio[1])
    t3 = int(cfg.warmup_steps * cfg.phase_ratio[2])

    state = mclmc.init(position, logdensity_and_grad, generator)
    params = MCLMCTuningParams(
        L=torch.full((n_chains,), max(math.sqrt(dim), 15.0), device=device),
        step_size=torch.full((n_chains,), cfg.step_size_init, device=device),
        sqrt_diag_cov=None)

    sched = energy_var_schedule(cfg, t1 + t2 + 1)
    decay = (cfg.num_effective_samples - 1.0) / (
        cfg.num_effective_samples + 1.0)

    def run_steps(state, params, n_steps: int, phase2_from: int,
                  trace_every: int = 0):
        carry = _fresh(state, params)
        n_traced = (n_steps // trace_every) * trace_every if trace_every else 0
        trace = []
        for i in range(n_steps):
            carry = _phase12_step(kernel, carry, dim, sched(i), decay,
                                  cfg.trust_in_estimate, i >= phase2_from)
            if i < n_traced and (i + 1) % trace_every == 0:
                trace.append(carry.state.position)
        return carry, trace

    # ---- phases 1+2: joint ε adaptation + streaming variance for L
    out, trace = run_steps(state, params, t1 + t2, t1, cfg.trace_every)
    state, params = out.state, out.params

    if t2 > 0:
        variances = torch.clamp_min(out.mean_x2 - torch.square(out.mean_x),
                                    1e-30)
        if cfg.diagonal_preconditioning:
            params = params._replace(
                sqrt_diag_cov=torch.sqrt(variances),
                L=torch.full((n_chains,), math.sqrt(dim), device=device))
            # short ε re-adjustment with the new preconditioner, streaming
            # off (as the reference's masked run)
            readjust = t2 // 3
            if readjust > 0:
                out, _ = run_steps(state, params, readjust, readjust)
                state, params = out.state, out.params
        else:
            params = params._replace(L=torch.sqrt(variances.sum(dim=1)))

    # ---- phase 3: ESS-based L refinement
    if t3 > 0:
        state, params = _phase3_refine_L(kernel, cfg, state, params, t3,
                                         generator)

    if cfg.trace_every:
        warmup_trace = (torch.stack(trace, dim=1) if trace else
                        torch.empty(n_chains, 0, dim, device=device))
        return state, params, warmup_trace
    return state, params
