"""Isokinetic integrators over chain-batched flat parameters
(counterpart of ``mile_tpu/mcmc/integrators.py``).

The chain axis is written out: positions, momenta and gradients are
``(C, dim)``, the step size ``(C,)``, the preconditioner ``(C, dim)``.
The momentum rotations go through :func:`mile_tpu_torch.ops.isokinetic.
isokinetic_momentum`, which launches the hand-written kernel on a CUDA
tensor and computes its plain version on a CPU tensor. The position drift
that follows a rotation and the sum of ΔK over the step are fused into
that call, so a McLachlan step is 3 kernel launches and 2
``logdensity_and_grad`` (the network forward/backward, the only heavy op).

The Euclidean leapfrog of HMC and NUTS (:func:`velocity_verlet`) is plain
PyTorch, as its JAX counterpart is plain XLA.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mile_tpu_torch.ops.isokinetic import isokinetic_momentum

# Minimal-norm (McLachlan) two-stage coefficient.
MCLACHLAN_B1 = 0.1931833275037836


class IntegratorState(NamedTuple):
    """Isokinetic dynamics state of a chain batch."""

    position: torch.Tensor         # (C, dim)
    momentum: torch.Tensor         # (C, dim), unit rows
    logdensity: torch.Tensor       # (C,)
    logdensity_grad: torch.Tensor  # (C, dim)


def isokinetic_integrator(logdensity_and_grad: Callable,
                          coefficients: tuple[float, ...] = (MCLACHLAN_B1,)
                          ) -> Callable:
    """Build a palindromic isokinetic integrator step.

    ``(b1,)`` gives the two-stage minimal-norm (McLachlan) scheme:
    v(b1 h), x(h/2), v((1-2 b1) h), x(h/2), v(b1 h). ``()`` gives
    isokinetic leapfrog: v(h/2), x(h), v(h/2).

    Returns ``step(state, step_size, sqrt_diag_cov) -> (state, kinetic_change)``
    with per-chain ``step_size`` (C,) and ``sqrt_diag_cov`` None or (C, dim).
    """
    if coefficients == ():
        v_fracs, x_fracs = [0.5, 0.5], [1.0]
    else:
        (b1,) = coefficients
        v_fracs, x_fracs = [b1, 1.0 - 2.0 * b1, b1], [0.5, 0.5]

    # the drift that follows each rotation (none after the last), fused
    # into the rotation's kernel, which also sums ΔK in place
    drifts = [*x_fracs, None]

    def step(state: IntegratorState, step_size: torch.Tensor,
             sqrt_diag_cov: torch.Tensor | None = None):
        x, u, kinetic = state.position, state.momentum, None
        logp, grad = state.logdensity, state.logdensity_grad
        for i, (vf, xf) in enumerate(zip(v_fracs, drifts)):
            if i:
                logp, grad = logdensity_and_grad(x)
            u, kinetic, *moved = isokinetic_momentum(
                u, grad, step_size, sqrt_diag_cov, coef=vf,
                x=x if xf else None, x_frac=xf or 0.0,
                kinetic=kinetic)
            if moved:
                (x,) = moved
        return IntegratorState(x, u, logp, grad), kinetic

    return step


def isokinetic_mclachlan(logdensity_and_grad):
    return isokinetic_integrator(logdensity_and_grad, (MCLACHLAN_B1,))


def isokinetic_leapfrog(logdensity_and_grad):
    return isokinetic_integrator(logdensity_and_grad, ())


# --------------------------------------------------------- euclidean (HMC)
class EuclideanState(NamedTuple):
    """Hamiltonian dynamics state of a chain batch."""

    position: torch.Tensor         # (C, dim)
    momentum: torch.Tensor         # (C, dim)
    logdensity: torch.Tensor       # (C,)
    logdensity_grad: torch.Tensor  # (C, dim)


def velocity_verlet(logdensity_and_grad: Callable,
                    inverse_mass_matrix: torch.Tensor) -> Callable:
    """Standard leapfrog with a diagonal inverse mass matrix ``(C, dim)``.

    Returns ``step(state, step_size) -> state`` with per-chain
    ``step_size`` (C,), signed for the direction of integration."""

    def step(state: EuclideanState, step_size: torch.Tensor
             ) -> EuclideanState:
        half = (0.5 * step_size)[:, None]
        p = state.momentum + half * state.logdensity_grad
        q = state.position + step_size[:, None] * inverse_mass_matrix * p
        logdensity, grad = logdensity_and_grad(q)
        p = p + half * grad
        return EuclideanState(q, p, logdensity, grad)

    return step


def euclidean_kinetic_energy(momentum: torch.Tensor,
                             inverse_mass_matrix: torch.Tensor
                             ) -> torch.Tensor:
    """``0.5 pᵀ M⁻¹ p`` per chain: (C, dim) -> (C,)."""
    return 0.5 * torch.sum(momentum * momentum * inverse_mass_matrix, dim=-1)
