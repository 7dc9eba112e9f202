"""Unadjusted Microcanonical Langevin Monte Carlo over a chain batch
(counterpart of ``mile_tpu/mcmc/mclmc.py``).

One step: an isokinetic McLachlan (or leapfrog) integration step, then a
partial momentum refresh, which also computes ΔE = ΔK − logp′ + logp.
Every chain has its own ``L``, step size and preconditioner, held as
device tensors, so a step makes no host sync. The refresh noise is keyed
by the kernel's run seed and a step counter held on the device (see
:func:`mile_tpu_torch.ops.isokinetic.partial_refresh`), or injected for
deterministic comparisons.
"""
from __future__ import annotations

from typing import Callable, Iterator, NamedTuple, Optional

import torch

from mile_tpu_torch.mcmc.integrators import (
    IntegratorState,
    isokinetic_leapfrog,
    isokinetic_mclachlan,
)
from mile_tpu_torch.ops.isokinetic import (
    counter_steps,
    partial_refresh,
    step_counter,
)

MCLMCState = IntegratorState


class MCLMCInfo(NamedTuple):
    """Per-step sampling statistics, each ``(C,)``."""

    logdensity: torch.Tensor
    kinetic_change: torch.Tensor
    energy_change: torch.Tensor


def random_unit_momentum(shape, generator: torch.Generator,
                         device) -> torch.Tensor:
    """Uniformly random unit rows (drawn on the CPU generator)."""
    u = torch.randn(shape, generator=generator).to(device)
    return u / torch.sqrt(torch.sum(u * u, dim=-1, keepdim=True))


def init(position: torch.Tensor, logdensity_and_grad: Callable,
         generator: Optional[torch.Generator] = None,
         momentum: Optional[torch.Tensor] = None) -> MCLMCState:
    """Start every chain at ``position`` (C, dim) with a uniformly random
    unit velocity (or the given ``momentum``)."""
    logdensity, grad = logdensity_and_grad(position)
    if momentum is None:
        momentum = random_unit_momentum(position.shape, generator,
                                        position.device)
    return MCLMCState(position, momentum, logdensity, grad)


class MCLMCKernel:
    """``kernel(state, L, step_size, sqrt_diag_cov, energy_sums=None)
    -> (state, info)``.

    ``noise``: an optional iterator of ``(C, dim)`` standard normals used
    for the refreshes in place of the generated ones (tests inject the JAX
    package's normals through it). The refresh's step counter is a tensor
    on the state's device (:func:`~mile_tpu_torch.ops.isokinetic.
    step_counter`), advanced by the refresh itself (on CUDA by its
    kernel), so a step makes no host sync and a captured step draws fresh
    noise on each replay.
    ``energy_sums``: an optional pair of (C,) tensors into which ΔE and ΔE²
    are added in place.
    ``seed`` and ``step``: the run seed (drawn from ``generator`` when None)
    and the counter's first step; a resumed run passes the saved ones
    (:meth:`random_state`).
    """

    def __init__(self, logdensity_and_grad: Callable,
                 generator: Optional[torch.Generator],
                 integrator: str = 'mclachlan',
                 noise: Optional[Iterator[torch.Tensor]] = None,
                 seed: Optional[int] = None, step: int = 0):
        make = (isokinetic_leapfrog if integrator == 'leapfrog'
                else isokinetic_mclachlan)
        self.integrator_step = make(logdensity_and_grad)
        if seed is None:
            seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
        self.seed, self.step = int(seed), int(step)
        self.counter = None
        self.noise = noise

    def random_state(self) -> dict:
        """The seed and the counter's step, as int64 tensors, queued in
        stream order: the state as of the last call, which later calls do
        not change and reading which waits for nothing but that call."""
        step = (torch.tensor(self.step) if self.counter is None
                else counter_steps(self.counter))
        return {'seed': torch.tensor(self.seed), 'step': step}

    def __call__(self, state: MCLMCState, L: torch.Tensor,
                 step_size: torch.Tensor,
                 sqrt_diag_cov: Optional[torch.Tensor] = None,
                 energy_sums: Optional[tuple] = None):
        if self.counter is None:
            self.counter = step_counter(self.step, state.position.device)
        new_state, kinetic_change = self.integrator_step(
            state, step_size, sqrt_diag_cov)
        z = None if self.noise is None else next(self.noise)
        momentum, energy_change = partial_refresh(
            new_state.momentum, step_size, L, self.seed, self.counter, z,
            energy=(kinetic_change, new_state.logdensity, state.logdensity),
            energy_sums=energy_sums)
        new_state = new_state._replace(momentum=momentum)
        return new_state, MCLMCInfo(new_state.logdensity, kinetic_change,
                                    energy_change)


def build_kernel(logdensity_and_grad: Callable,
                 generator: Optional[torch.Generator],
                 integrator: str = 'mclachlan',
                 noise: Optional[Iterator[torch.Tensor]] = None,
                 seed: Optional[int] = None, step: int = 0) -> MCLMCKernel:
    """The MCLMC step for a chain batch. ``integrator``: 'mclachlan' or
    'mclachlan_pallas' (the same in the port: kernels on CUDA tensors,
    plain versions on CPU tensors), or 'leapfrog'."""
    return MCLMCKernel(logdensity_and_grad, generator, integrator, noise,
                       seed, step)
