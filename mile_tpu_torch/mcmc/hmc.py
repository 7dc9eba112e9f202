"""Hamiltonian Monte Carlo with Metropolis correction over a chain batch
(counterpart of ``mile_tpu/mcmc/hmc.py``).

Velocity-Verlet leapfrog under a diagonal inverse mass matrix, full
momentum resampling, MH accept/reject. The chain axis is written out:
positions ``(C, dim)``, step sizes ``(C,)``, inverse mass matrices
``(C, dim)``; the accept/reject is a per-chain ``torch.where``, so a step
makes no host sync.

Randomness comes from a :class:`Draws` source: by default normals and
uniforms from one ``torch.Generator`` on the chains' device; tests inject
the JAX package's numbers through the same two methods.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from mile_tpu_torch.mcmc.integrators import (
    EuclideanState,
    euclidean_kinetic_energy,
    velocity_verlet,
)

DIVERGENCE_THRESHOLD = 1000.0


class HMCState(NamedTuple):
    position: torch.Tensor         # (C, dim)
    logdensity: torch.Tensor       # (C,)
    logdensity_grad: torch.Tensor  # (C, dim)


class HMCInfo(NamedTuple):
    """Per-step statistics, each ``(C,)``."""

    acceptance_rate: torch.Tensor
    is_accepted: torch.Tensor
    energy: torch.Tensor
    is_divergent: torch.Tensor
    num_integration_steps: torch.Tensor


class Draws:
    """Standard normals and uniforms on [0, 1) for the HMC family, drawn
    from ``generator`` (on its device) and moved to ``device`` if given.

    Any object with these two methods can stand in for it (``draws=`` of
    the kernels); the kernels call them in a fixed order, given in each
    kernel's docstring."""

    def __init__(self, generator: torch.Generator, device=None):
        self.generator = generator
        self.device = None if device is None else torch.device(device)

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.device is None else x.to(self.device)

    def normal(self, shape) -> torch.Tensor:
        return self._out(torch.randn(shape, generator=self.generator,
                                     device=self.generator.device))

    def uniform(self, shape) -> torch.Tensor:
        return self._out(torch.rand(shape, generator=self.generator,
                                    device=self.generator.device))


def device_draws(generator: torch.Generator, device) -> Draws:
    """A :class:`Draws` on a generator of ``device``, seeded from
    ``generator`` (the experiment's CPU stream)."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return Draws(torch.Generator(device=device).manual_seed(seed))


def select(mask: torch.Tensor, new, old):
    """Per chain, ``new`` where ``mask`` (C,) holds, else ``old``: a tensor
    with a leading chain axis, or every tensor of a (nested) NamedTuple."""
    if isinstance(new, tuple):
        return type(new)(*(select(mask, n, o) for n, o in zip(new, old)))
    return torch.where(mask.view(-1, *[1] * (new.dim() - 1)), new, old)


def init(position: torch.Tensor, logdensity_and_grad: Callable) -> HMCState:
    logdensity, grad = logdensity_and_grad(position)
    return HMCState(position, logdensity, grad)


def sample_momentum(draws, shape, inverse_mass_matrix: torch.Tensor
                    ) -> torch.Tensor:
    """p ~ N(0, M) with M = diag(1/inverse_mass_matrix), per chain."""
    return draws.normal(shape) / torch.sqrt(inverse_mass_matrix)


def metropolis_delta(energy0: torch.Tensor, energy: torch.Tensor
                     ) -> torch.Tensor:
    """``energy0 - energy`` with NaN read as -inf (a rejected proposal)."""
    return torch.nan_to_num(energy0 - energy, nan=-torch.inf,
                            posinf=torch.inf, neginf=-torch.inf)


class HMCKernel:
    """``kernel(state, step_size (C,), inverse_mass_matrix (C, dim))
    -> (state, info)``.

    Draws per step: ``normal((C, dim))`` for the momentum, then
    ``uniform((C,))`` for the accept test. ``draws`` (a :class:`Draws` or
    any object with its two methods) replaces the generator's, which is
    seeded from ``generator`` on the state's device at the first call."""

    def __init__(self, logdensity_and_grad: Callable,
                 generator: Optional[torch.Generator] = None,
                 num_integration_steps: int = 32, draws=None):
        self.logdensity_and_grad = logdensity_and_grad
        self.generator = generator
        self.num_integration_steps = num_integration_steps
        self.draws = draws

    def __call__(self, state: HMCState, step_size: torch.Tensor,
                 inverse_mass_matrix: torch.Tensor):
        if self.draws is None:
            self.draws = device_draws(self.generator, state.position.device)
        n_chains = state.position.shape[0]
        p0 = sample_momentum(self.draws, state.position.shape,
                             inverse_mass_matrix)
        energy0 = -state.logdensity + euclidean_kinetic_energy(
            p0, inverse_mass_matrix)
        integrate = velocity_verlet(self.logdensity_and_grad,
                                    inverse_mass_matrix)
        z = EuclideanState(state.position, p0, state.logdensity,
                           state.logdensity_grad)
        for _ in range(self.num_integration_steps):
            z = integrate(z, step_size)

        energy1 = -z.logdensity + euclidean_kinetic_energy(
            z.momentum, inverse_mass_matrix)
        delta = metropolis_delta(energy0, energy1)
        accept_prob = torch.clamp(torch.exp(delta), max=1.0)
        accept = self.draws.uniform((n_chains,)) < accept_prob
        proposal = HMCState(z.position, z.logdensity, z.logdensity_grad)
        info = HMCInfo(
            acceptance_rate=accept_prob,
            is_accepted=accept,
            energy=energy1,
            is_divergent=-delta > DIVERGENCE_THRESHOLD,
            num_integration_steps=torch.full(
                (n_chains,), self.num_integration_steps, dtype=torch.int32,
                device=state.position.device))
        return select(accept, proposal, state), info


def build_kernel(logdensity_and_grad: Callable,
                 generator: Optional[torch.Generator] = None,
                 num_integration_steps: int = 32, draws=None) -> HMCKernel:
    return HMCKernel(logdensity_and_grad, generator, num_integration_steps,
                     draws)
