"""No-U-Turn Sampler, iterative and multinomial, over a chain batch
(counterpart of ``mile_tpu/mcmc/nuts.py``).

- Iterative tree building: a doubling loop, each doubling running
  ``2^depth`` leapfrog steps with progressive multinomial sampling of the
  proposal.
- Sub-U-turns are detected with the O(max_depth) checkpoint scheme
  (iterative NUTS, as in numpyro): momenta and momentum prefix sums are
  checkpointed at odd leaves; at even leaves every complete binary subtree
  ending there is checked against its stored left boundary. For 1-based
  leaf ``n``: store at slot ``popcount(n-1)`` when n is odd; when n is even
  check slots ``popcount(n-1)-1 - tz(n) + 1 .. popcount(n-1)-1``.

The JAX kernel is single-chain and ``vmap`` lifts it; ``vmap`` turns each
``while_loop`` into one loop over the batch that runs while any chain's
condition holds, and a chain whose condition is false keeps its carry.
This port writes exactly that out: per-chain ``active`` masks and
``torch.where`` on every carried field. All chains still active in a
doubling share its depth, and all still active in a subtree share its leaf
counter, so the slot arithmetic is on host integers and the checkpoint
buffers are ``(C, max_depth, dim)`` with no per-chain gather.

The host reads "is any chain still active" once per leaf after the first
of each subtree and once per doubling (``NUTSKernel.host_syncs`` counts
them); masked chains' leaves cost gradients but change no result.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from mile_tpu_torch.mcmc.hmc import (
    HMCState,
    device_draws,
    init,  # noqa: F401  (NUTS starts from the same state)
    metropolis_delta,
    sample_momentum,
    select,
)
from mile_tpu_torch.mcmc.integrators import (
    EuclideanState,
    euclidean_kinetic_energy,
    velocity_verlet,
)

NUTSState = HMCState

DIVERGENCE_THRESHOLD = 1000.0


class NUTSInfo(NamedTuple):
    """Per-step statistics, each ``(C,)``."""

    acceptance_rate: torch.Tensor   # mean leaf MH prob (dual-avg statistic)
    is_divergent: torch.Tensor
    is_turning: torch.Tensor
    energy: torch.Tensor
    num_integration_steps: torch.Tensor
    num_trajectory_expansions: torch.Tensor


def _popcount(n: int) -> int:
    return bin(n).count('1')


def _trailing_zeros(n: int) -> int:
    """tz(n) for n >= 1."""
    return (n & -n).bit_length() - 1


def _is_turning(p_left, p_right, psum, inverse_mass_matrix) -> torch.Tensor:
    """U-turn test over the last axis (broadcasting over the others)."""
    v_left = p_left * inverse_mass_matrix
    v_right = p_right * inverse_mass_matrix
    return ((torch.sum(v_left * psum, dim=-1) <= 0.0)
            | (torch.sum(v_right * psum, dim=-1) <= 0.0))


class _Subtree(NamedTuple):
    leaves: torch.Tensor      # (C,) leaves taken in this subtree
    z: EuclideanState         # integrator frontier
    prop: EuclideanState      # proposal (progressive multinomial)
    log_sum_w: torch.Tensor   # subtree multinomial weight
    psum: torch.Tensor        # subtree momentum sum
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor  # sum of per-leaf min(1, e^{H0-H})


class _Tree(NamedTuple):
    left: EuclideanState
    right: EuclideanState
    prop: EuclideanState
    log_sum_w: torch.Tensor
    psum: torch.Tensor
    depth: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    n_leaves: torch.Tensor


class NUTSKernel:
    """``kernel(state, step_size (C,), inverse_mass_matrix (C, dim))
    -> (state, info)``.

    Draws per step, in this order: ``normal((C, dim))`` for the momentum;
    then per doubling of depth d ``uniform((C,))`` for the direction (right
    where < 0.5, as ``jax.random.bernoulli``), ``uniform((C,))`` for the
    biased swap between tree and subtree, and ``uniform((C, 2**d))``, one
    per leaf, for the multinomial swaps inside the subtree. ``draws`` (a
    :class:`~mile_tpu_torch.mcmc.hmc.Draws` or any object with its two
    methods) replaces the generator's, which is seeded from ``generator``
    on the state's device at the first call.
    """

    def __init__(self, logdensity_and_grad: Callable,
                 generator: Optional[torch.Generator] = None,
                 max_depth: int = 10,
                 divergence_threshold: float = DIVERGENCE_THRESHOLD,
                 draws=None):
        self.logdensity_and_grad = logdensity_and_grad
        self.generator = generator
        self.max_depth = max_depth
        self.divergence_threshold = divergence_threshold
        self.draws = draws
        self.host_syncs = 0

    def _any(self, active: torch.Tensor) -> bool:
        self.host_syncs += 1
        return bool(active.any())

    def _subtree(self, frontier: EuclideanState, h: torch.Tensor, depth: int,
                 active: torch.Tensor, energy0: torch.Tensor,
                 inverse_mass_matrix: torch.Tensor, integrate: Callable,
                 ckpt_p: torch.Tensor, ckpt_psum: torch.Tensor) -> _Subtree:
        """``2**depth`` leaves from ``frontier`` in the direction of the
        signed step ``h``, for the chains in ``active``; a chain that is not
        (or stops being) active keeps its carry and its checkpoints."""
        n_chains = active.shape[0]
        n_leaves = 1 << depth
        swaps = self.draws.uniform((n_chains, n_leaves))
        no = torch.zeros_like(active)
        c = _Subtree(
            leaves=torch.zeros(n_chains, dtype=torch.int32,
                               device=active.device),
            z=frontier, prop=frontier,
            log_sum_w=torch.full_like(energy0, -torch.inf),
            psum=torch.zeros_like(frontier.momentum),
            turning=no, diverging=no, sum_accept=torch.zeros_like(energy0))
        for n in range(1, n_leaves + 1):          # 1-based leaf number
            if n > 1 and not self._any(active):
                break
            z = integrate(c.z, h)
            energy = -z.logdensity + euclidean_kinetic_energy(
                z.momentum, inverse_mass_matrix)
            delta = metropolis_delta(energy0, energy)
            diverging = -delta > self.divergence_threshold
            log_sum_w = torch.logaddexp(c.log_sum_w, delta)
            take = torch.log(swaps[:, n - 1]) < delta - log_sum_w
            psum = c.psum + z.momentum

            if n & 1:
                # store the checkpoint at odd leaves: slot popcount(n-1)
                slot = _popcount(n - 1)
                ckpt_p[:, slot] = select(active, z.momentum, ckpt_p[:, slot])
                ckpt_psum[:, slot] = select(active, c.psum,
                                            ckpt_psum[:, slot])
                turning = no
            else:
                # check every complete subtree ending at this even leaf
                idx_max = _popcount(n - 1) - 1
                idx_min = max(idx_max - _trailing_zeros(n) + 1, 0)
                sl = slice(idx_min, idx_max + 1)
                turning = _is_turning(
                    ckpt_p[:, sl], z.momentum[:, None],
                    psum[:, None] - ckpt_psum[:, sl],
                    inverse_mass_matrix[:, None]).any(dim=1) & ~diverging

            new = _Subtree(
                leaves=c.leaves + 1, z=z, prop=select(take, z, c.prop),
                log_sum_w=log_sum_w, psum=psum, turning=turning,
                diverging=diverging,
                sum_accept=c.sum_accept + torch.clamp(torch.exp(delta),
                                                      max=1.0))
            c = select(active, new, c)
            active = active & ~(turning | diverging)
        return c

    def __call__(self, state: NUTSState, step_size: torch.Tensor,
                 inverse_mass_matrix: torch.Tensor):
        if self.draws is None:
            self.draws = device_draws(self.generator, state.position.device)
        n_chains, dim = state.position.shape
        device = state.position.device
        p0 = sample_momentum(self.draws, (n_chains, dim), inverse_mass_matrix)
        energy0 = -state.logdensity + euclidean_kinetic_energy(
            p0, inverse_mass_matrix)
        integrate = velocity_verlet(self.logdensity_and_grad,
                                    inverse_mass_matrix)
        z0 = EuclideanState(state.position, p0, state.logdensity,
                            state.logdensity_grad)
        no = torch.zeros(n_chains, dtype=torch.bool, device=device)
        t = _Tree(left=z0, right=z0, prop=z0,
                  log_sum_w=torch.zeros_like(energy0),  # root leaf: e^0
                  psum=p0,
                  depth=torch.zeros(n_chains, dtype=torch.int32,
                                    device=device),
                  turning=no, diverging=no,
                  sum_accept=torch.zeros_like(energy0),
                  n_leaves=torch.ones(n_chains, dtype=torch.int32,
                                      device=device))
        ckpt_p = torch.zeros(n_chains, self.max_depth, dim, device=device,
                             dtype=p0.dtype)
        ckpt_psum = torch.zeros_like(ckpt_p)
        active = ~no

        for depth in range(self.max_depth):
            if depth and not self._any(active):
                break
            go_right = self.draws.uniform((n_chains,)) < 0.5
            bias = self.draws.uniform((n_chains,))
            direction = torch.where(go_right, 1.0, -1.0).to(step_size.dtype)
            frontier = select(go_right, t.right, t.left)
            sub = self._subtree(frontier, direction * step_size, depth,
                                active, energy0, inverse_mass_matrix,
                                integrate, ckpt_p, ckpt_psum)
            sub_ok = ~sub.turning & ~sub.diverging

            # biased progressive sampling between tree and new subtree
            take = sub_ok & (torch.log(bias) < sub.log_sum_w - t.log_sum_w)
            left = select(go_right, t.left, sub.z)
            right = select(go_right, sub.z, t.right)
            psum = t.psum + sub.psum
            turning_merged = _is_turning(left.momentum, right.momentum, psum,
                                         inverse_mass_matrix)
            new = _Tree(
                left=left, right=right, prop=select(take, sub.prop, t.prop),
                log_sum_w=torch.logaddexp(t.log_sum_w, sub.log_sum_w),
                psum=psum, depth=t.depth + 1,
                turning=sub.turning | (sub_ok & turning_merged),
                diverging=sub.diverging,
                sum_accept=t.sum_accept + sub.sum_accept,
                n_leaves=t.n_leaves + sub.leaves)
            t = select(active, new, t)
            active = active & ~t.turning & ~t.diverging

        z = t.prop
        n_steps = t.n_leaves - 1
        info = NUTSInfo(
            acceptance_rate=t.sum_accept / torch.clamp(n_steps, min=1),
            is_divergent=t.diverging,
            is_turning=t.turning,
            energy=-z.logdensity + euclidean_kinetic_energy(
                z.momentum, inverse_mass_matrix),
            num_integration_steps=n_steps,
            num_trajectory_expansions=t.depth)
        return NUTSState(z.position, z.logdensity, z.logdensity_grad), info


def build_kernel(logdensity_and_grad: Callable,
                 generator: Optional[torch.Generator] = None,
                 max_depth: int = 10,
                 divergence_threshold: float = DIVERGENCE_THRESHOLD,
                 draws=None) -> NUTSKernel:
    return NUTSKernel(logdensity_and_grad, generator, max_depth,
                      divergence_threshold, draws)
