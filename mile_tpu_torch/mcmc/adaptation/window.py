"""Stan-style window adaptation for the HMC family (NUTS/HMC) over a chain
batch (counterpart of ``mile_tpu/mcmc/adaptation/window.py``).

- schedule: fast(75) | doubling slow windows starting at 25 | fast(50),
  scaled down proportionally for small budgets (Stan's rules);
- fast phases: dual averaging of the step size only;
- slow windows: dual averaging + Welford estimation of the diagonal
  inverse mass matrix; at a window end the mass matrix is adopted, Welford
  resets, and dual averaging restarts at its averaged step size (and, when
  the log-density is given, at a step size re-bracketed against the new
  mass matrix).

Every chain adapts its own (ε, M⁻¹): step sizes are ``(C,)``, mass
matrices ``(C, dim)``. The schedule is a host array shared by the chains,
so its stage decides real host branches, as the unbatched stage of the JAX
scan does.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mile_tpu_torch.mcmc.adaptation.dual_averaging import (
    DualAveragingState,
    da_final,
    da_init,
    da_update,
)
from mile_tpu_torch.mcmc.adaptation.mass_matrix import (
    WelfordState,
    welford_init,
    welford_update,
    welford_variance,
)
from mile_tpu_torch.mcmc.hmc import metropolis_delta, sample_momentum
from mile_tpu_torch.mcmc.integrators import (
    EuclideanState,
    euclidean_kinetic_energy,
    velocity_verlet,
)


def build_schedule(num_steps: int, initial_buffer: int = 75,
                   final_buffer: int = 50, first_window: int = 25
                   ) -> np.ndarray:
    """Per-step stage labels: 0 = fast, 1 = slow, 2 = slow-window-end.

    Mirrors Stan's logic: if the budget is under 20 steps everything is
    fast; small budgets shrink the buffers 15%/10%/75%; slow windows double
    until the remainder fits.
    """
    if num_steps < 20:
        return np.zeros(num_steps, dtype=np.int32)
    if initial_buffer + first_window + final_buffer > num_steps:
        initial_buffer = int(0.15 * num_steps)
        final_buffer = int(0.1 * num_steps)
        first_window = num_steps - initial_buffer - final_buffer

    schedule = np.zeros(num_steps, dtype=np.int32)
    slow_total = num_steps - initial_buffer - final_buffer
    pos, size = initial_buffer, first_window
    while pos < initial_buffer + slow_total:
        remaining = initial_buffer + slow_total - pos
        if size * 3 > remaining:  # last window absorbs the remainder
            size = remaining
        end = pos + size
        schedule[pos:end] = 1
        schedule[end - 1] = 2
        pos, size = end, size * 2
    return schedule


def find_reasonable_step_size(
    logdensity_and_grad: Callable,
    position: torch.Tensor,
    draws,
    inverse_mass_matrix: Optional[torch.Tensor] = None,
    initial_step_size: float | torch.Tensor = 1.0,
    max_doublings: int = 64,
) -> torch.Tensor:
    """Stan's initial step-size bracketing (Hoffman & Gelman 2014, alg. 4),
    per chain: doubles or halves ε until the one-leapfrog Metropolis
    probability crosses 0.5.

    ``draws`` gives the momentum (one ``normal((C, dim))``; see
    :class:`~mile_tpu_torch.mcmc.hmc.Draws`). All chains still searching
    share the iteration count, so the loop reads once per iteration whether
    any chain searches on. Returns ε (C,) float32.
    """
    if inverse_mass_matrix is None:
        inverse_mass_matrix = torch.ones_like(position)
    logdensity, grad = logdensity_and_grad(position)
    p0 = sample_momentum(draws, position.shape, inverse_mass_matrix)
    z0 = EuclideanState(position, p0, logdensity, grad)
    h0 = -logdensity + euclidean_kinetic_energy(p0, inverse_mass_matrix)
    integrate = velocity_verlet(logdensity_and_grad, inverse_mass_matrix)

    def log_accept(eps):
        z = integrate(z0, eps)
        h = -z.logdensity + euclidean_kinetic_energy(z.momentum,
                                                     inverse_mass_matrix)
        return metropolis_delta(h0, h)

    log_half = math.log(0.5)
    eps = torch.as_tensor(initial_step_size, dtype=torch.float32,
                          device=position.device).expand(
        position.shape[0]).clone()
    la = log_accept(eps)
    up = la > log_half
    factor = torch.where(up, 2.0, 0.5)
    for _ in range(max_doublings):
        going = torch.where(up, la > log_half, la <= log_half)
        if not bool(going.any()):
            break
        eps = torch.where(going, eps * factor, eps)
        la = torch.where(going, log_accept(eps), la)
    return eps


class WindowAdaptState(NamedTuple):
    da: DualAveragingState
    welford: WelfordState
    inverse_mass_matrix: torch.Tensor


def window_adaptation_init(position: torch.Tensor,
                           initial_step_size: torch.Tensor
                           ) -> WindowAdaptState:
    return WindowAdaptState(da=da_init(initial_step_size),
                            welford=welford_init(position),
                            inverse_mass_matrix=torch.ones_like(position))


def window_adaptation_update(
    adapt: WindowAdaptState,
    stage: int,                    # 0 fast, 1 slow, 2 slow end
    position: torch.Tensor,
    acceptance_rate: torch.Tensor,
    target_acceptance_rate: float = 0.8,
) -> WindowAdaptState:
    da = da_update(adapt.da, acceptance_rate, target=target_acceptance_rate)
    welford = adapt.welford
    inverse_mass_matrix = adapt.inverse_mass_matrix
    if stage >= 1:
        welford = welford_update(welford, position)
    if stage == 2:
        # adopt the variance, reset Welford, and restart dual averaging at
        # the AVERAGED step size (BlackJAX _update_at_middle_window_end)
        inverse_mass_matrix = welford_variance(welford)
        welford = welford_init(position)
        da = da_init(da_final(da))
    return WindowAdaptState(da, welford, inverse_mass_matrix)


def window_adaptation_final(adapt: WindowAdaptState):
    return da_final(adapt.da), adapt.inverse_mass_matrix


def run_window_adaptation(
    kernel: Callable,              # kernel(state, eps, inv_mass) -> (state, info)
    init_state,
    draws,
    num_steps: int,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    trace_every: int = 0,
    logdensity_and_grad: Optional[Callable] = None,
    return_stats: bool = False,
):
    """Adapt every chain for ``num_steps``; returns (state, step_size (C,),
    inverse_mass_matrix (C, dim)[, trace (C, n, dim)][, stats]).

    With ``trace_every`` > 0 the position after every ``trace_every``-th
    step is kept. When ``logdensity_and_grad`` is given,
    ``initial_step_size`` is first re-bracketed with
    :func:`find_reasonable_step_size`, and again at every slow-window end
    against the adopted mass matrix; ``draws`` (in place of the JAX
    function's key) gives those searches their momenta. With
    ``return_stats`` the last element is ``{'bracketed_step_size',
    'final_buffer_acceptance'}``: the bracketed seed ε and the mean
    acceptance over the terminal fast buffer.
    """
    sched = build_schedule(num_steps)
    final_buffer = int(np.sum(np.cumsum(sched[::-1] != 0) == 0))
    position = init_state.position
    if logdensity_and_grad is not None:
        initial_step_size = find_reasonable_step_size(
            logdensity_and_grad, position, draws,
            initial_step_size=initial_step_size)
    eps0 = torch.as_tensor(initial_step_size, dtype=torch.float32,
                           device=position.device).expand(
        position.shape[0]).clone()
    adapt = window_adaptation_init(position, eps0)
    acc_sum = torch.zeros_like(eps0)
    acc_count = 0

    state, trace = init_state, []
    for step_idx, stage in enumerate(sched.tolist()):
        state, info = kernel(state, torch.exp(adapt.da.log_step_size),
                             adapt.inverse_mass_matrix)
        if step_idx >= num_steps - max(final_buffer, 1):
            acc_sum = acc_sum + info.acceptance_rate
            acc_count += 1
        adapt = window_adaptation_update(
            adapt, stage, state.position, info.acceptance_rate,
            target_acceptance_rate)
        if logdensity_and_grad is not None and stage == 2:
            # re-bracket ε against the freshly adopted mass matrix: the
            # pre-adoption ε can be instantly divergent under it
            eps_b = find_reasonable_step_size(
                logdensity_and_grad, state.position, draws,
                inverse_mass_matrix=adapt.inverse_mass_matrix,
                initial_step_size=torch.exp(adapt.da.log_step_size))
            adapt = adapt._replace(da=da_init(eps_b))
        if trace_every and (step_idx + 1) % trace_every == 0:
            trace.append(state.position)

    step_size, inverse_mass_matrix = window_adaptation_final(adapt)
    out = (state, step_size, inverse_mass_matrix)
    if trace_every:
        out = out + (torch.stack(trace, dim=1),)
    if return_stats:
        out = out + ({'bracketed_step_size': eps0,
                      'final_buffer_acceptance':
                          acc_sum / max(acc_count, 1)},)
    return out
