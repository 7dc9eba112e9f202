"""Symmetric-split HMC: minibatch HMC over data shards, for a chain batch
(counterpart of ``mile_tpu/mcmc/split_hmc.py``).

The potential is ``U(θ) = Σ_{j=1}^M U_j(θ)`` with ``U_j = -(loglik of
shard j + logprior/M)``. One leapfrog step of size ε is the palindromic
composition

    K_1 D K_2 D … K_M D · D K_M D K_{M-1} … D K_1

where ``K_j`` kicks ``p ← p − (ε/2)∇U_j(θ)`` and ``D`` drifts
``θ ← θ + (ε/2M) M⁻¹ p``: each shard gradient is used twice a step, the
drifts total ε, and the palindrome of shears is volume-preserving and
time-reversible, so the Metropolis test on the full potential (a forward
pass only) makes the kernel exact.

The JAX package computes this in XLA (no Pallas kernel): here it is plain
torch. The chain axis is written out (positions ``(C, dim)``, potentials
``(C,)``), one shard at a time, so only one shard's activations are live;
each shard gradient is ``torch.autograd.grad`` of the shard potential.
Randomness comes from a :class:`~mile_tpu_torch.mcmc.hmc.Draws` source, as
in :mod:`mile_tpu_torch.mcmc.hmc`: per step ``normal((C, dim))`` for the
momentum, then ``uniform((C,))`` for the accept test.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from mile_tpu_torch.mcmc.hmc import device_draws, metropolis_delta, select

DIVERGENCE_THRESHOLD = 1000.0


class SplitHMCState(NamedTuple):
    position: torch.Tensor    # (C, dim)
    potential: torch.Tensor   # (C,): U(position) = Σ_j U_j, for the MH test


class SplitHMCInfo(NamedTuple):
    """Per-step statistics, each ``(C,)``."""

    acceptance_rate: torch.Tensor
    is_accepted: torch.Tensor
    energy: torch.Tensor
    is_divergent: torch.Tensor
    num_integration_steps: torch.Tensor


def _per_chain(value, like: torch.Tensor) -> torch.Tensor:
    """A step size (a number or a (C,) tensor) as a (C or 1, 1) column."""
    return torch.as_tensor(value, dtype=like.dtype,
                           device=like.device).reshape(-1, 1)


def _full_potential(shard_potential_fn: Callable, n_shards: int,
                    position: torch.Tensor) -> torch.Tensor:
    """``Σ_j U_j(position)``, summed shard by shard in order."""
    with torch.no_grad():
        total = torch.zeros(position.shape[:-1], dtype=position.dtype,
                            device=position.device)
        for j in range(n_shards):
            total = total + shard_potential_fn(position, j)
    return total


def init(position: torch.Tensor, shard_potential_fn: Callable,
         n_shards: int) -> SplitHMCState:
    return SplitHMCState(
        position, _full_potential(shard_potential_fn, n_shards, position))


def build_integrator(shard_potential_fn: Callable, n_shards: int
                     ) -> Callable:
    """One palindromic split-leapfrog step:
    ``leapfrog_step(theta, p, step_size, inverse_mass_matrix)``."""
    M = n_shards

    def shard_grad(theta: torch.Tensor, j: int) -> torch.Tensor:
        with torch.enable_grad():
            t = theta.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(shard_potential_fn(t, j).sum(), t)
        return grad

    def leapfrog_step(theta, p, step_size, inverse_mass_matrix):
        step_size = _per_chain(step_size, theta)
        half_kick = 0.5 * step_size
        drift = (step_size / (2.0 * M)) * inverse_mass_matrix
        for j in range(M):
            p = p - half_kick * shard_grad(theta, j)
            theta = theta + drift * p
        for j in reversed(range(M)):
            theta = theta + drift * p
            p = p - half_kick * shard_grad(theta, j)
        return theta, p

    return leapfrog_step


class SplitHMCKernel:
    """``kernel(state, step_size, inverse_mass_matrix) -> (state, info)``;
    ``step_size`` a number or (C,), ``inverse_mass_matrix`` (dim,) or
    (C, dim).

    ``draws`` (a :class:`~mile_tpu_torch.mcmc.hmc.Draws` or any object with
    its two methods) replaces the generator's, which is seeded from
    ``generator`` on the state's device at the first call."""

    def __init__(self, shard_potential_fn: Callable, n_shards: int,
                 num_integration_steps: int = 10,
                 generator: Optional[torch.Generator] = None, draws=None):
        self.shard_potential_fn = shard_potential_fn
        self.n_shards = n_shards
        self.num_integration_steps = num_integration_steps
        self.leapfrog_step = build_integrator(shard_potential_fn, n_shards)
        self.generator = generator
        self.draws = draws

    def __call__(self, state: SplitHMCState, step_size,
                 inverse_mass_matrix: torch.Tensor):
        theta = state.position
        if self.draws is None:
            self.draws = device_draws(self.generator, theta.device)
        n_chains = theta.shape[0]
        p0 = self.draws.normal(theta.shape) / torch.sqrt(inverse_mass_matrix)
        kinetic0 = 0.5 * torch.sum(p0 * p0 * inverse_mass_matrix, dim=-1)
        energy0 = state.potential + kinetic0

        p = p0
        for _ in range(self.num_integration_steps):
            theta, p = self.leapfrog_step(theta, p, step_size,
                                          inverse_mass_matrix)

        potential1 = _full_potential(self.shard_potential_fn, self.n_shards,
                                     theta)
        kinetic1 = 0.5 * torch.sum(p * p * inverse_mass_matrix, dim=-1)
        energy1 = potential1 + kinetic1
        delta = metropolis_delta(energy0, energy1)   # NaN: a rejection
        accept_prob = torch.clamp(torch.exp(delta), max=1.0)
        accept = self.draws.uniform((n_chains,)) < accept_prob
        info = SplitHMCInfo(
            acceptance_rate=accept_prob,
            is_accepted=accept,
            energy=energy1,
            is_divergent=-delta > DIVERGENCE_THRESHOLD,
            num_integration_steps=torch.full(
                (n_chains,), self.num_integration_steps, dtype=torch.int32,
                device=theta.device))
        return select(accept, SplitHMCState(theta, potential1), state), info


def build_kernel(shard_potential_fn: Callable, n_shards: int,
                 num_integration_steps: int = 10,
                 generator: Optional[torch.Generator] = None,
                 draws=None) -> SplitHMCKernel:
    """The split-HMC step. ``shard_potential_fn(position, j) ->
    U_j(position)`` must satisfy ``Σ_j U_j = -log unnormalized posterior``
    (the caller folds the 1/M prior share into each shard)."""
    return SplitHMCKernel(shard_potential_fn, n_shards,
                          num_integration_steps, generator, draws)
