"""Nesterov dual averaging for step-size adaptation (Hoffman & Gelman 2014)
over a chain batch (counterpart of ``mile_tpu/mcmc/adaptation/
dual_averaging.py``): every field is ``(C,)``."""
from __future__ import annotations

from typing import NamedTuple

import torch


class DualAveragingState(NamedTuple):
    log_step_size: torch.Tensor
    log_step_size_avg: torch.Tensor
    t: torch.Tensor
    avg_error: torch.Tensor
    mu: torch.Tensor


def da_init(initial_step_size: torch.Tensor,
            mu_factor: float = 10.0) -> DualAveragingState:
    """``initial_step_size``: (C,) float32."""
    zeros = torch.zeros_like(initial_step_size)
    return DualAveragingState(
        log_step_size=torch.log(initial_step_size),
        log_step_size_avg=zeros, t=zeros, avg_error=zeros,
        mu=torch.log(mu_factor * initial_step_size))


def da_update(state: DualAveragingState, acceptance_rate: torch.Tensor,
              target: float = 0.8, t0: float = 10.0, gamma: float = 0.05,
              kappa: float = 0.75) -> DualAveragingState:
    t = state.t + 1.0
    error = target - acceptance_rate
    avg_error = (1.0 - 1.0 / (t + t0)) * state.avg_error + error / (t + t0)
    log_eps = state.mu - torch.sqrt(t) / gamma * avg_error
    eta = t ** -kappa
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_step_size_avg
    return DualAveragingState(log_eps, log_eps_avg, t, avg_error, state.mu)


def da_final(state: DualAveragingState) -> torch.Tensor:
    """The averaged (smoothed) step size."""
    return torch.exp(state.log_step_size_avg)
