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
counter, so one counter serves the whole batch and the checkpoint buffers
are ``(C, max_depth, dim)`` with no per-chain gather.

The host reads "is any chain still active" once per leaf after the first
of each subtree and once per doubling (``NUTSKernel.host_syncs`` counts
them); masked chains' leaves cost gradients but change no result.

A leaf is the same work whatever its number: its checkpoint slot and the
slots it checks are rows of a table indexed by a leaf counter on the
device, and it updates the subtree's carry in place (:class:`_Leaves`).
On a CUDA device that leaf is captured once per kernel in a CUDA graph and
replayed (its value and gradient included), so that a leaf costs one
replay and one host read instead of a launch per operation; the captured
leaf takes a small Dense kernel's gradient over many rows in blocks of
rows (:func:`~mile_tpu_torch.models.blocks.split_k_rows`). Elsewhere, and
with ``graph=False`` (a mesh that shards the log-density), the leaf runs
eagerly on the models' plain products.
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
from mile_tpu_torch.models.blocks import split_k_rows
from mile_tpu_torch.utils.precision import arithmetic

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
                 draws=None, graph: bool = True):
        self.logdensity_and_grad = logdensity_and_grad
        self.generator = generator
        self.max_depth = max_depth
        self.divergence_threshold = divergence_threshold
        self.draws = draws
        self.graph = graph
        self.host_syncs = 0
        self._leaves: Optional[_Leaves] = None

    def _any(self, active: torch.Tensor) -> bool:
        """Whether any chain of ``active`` (a ``(C,)`` mask or the
        leaves' 0-d flag) is still active: one host read."""
        self.host_syncs += 1
        return bool(active.any())

    @property
    def leaf_steps(self) -> int:
        """Batched leaves taken so far (each one full-batch gradient)."""
        return 0 if self._leaves is None else self._leaves.steps

    @property
    def graphed(self) -> bool:
        """Whether the leaves are replayed from a captured CUDA graph."""
        return self._leaves is not None and self._leaves.captured

    def _subtree(self, leaves: '_Leaves', frontier: EuclideanState,
                 h: torch.Tensor, depth: int,
                 active: torch.Tensor) -> _Subtree:
        """``2**depth`` leaves from ``frontier`` in the direction of the
        signed step ``h``, for the chains in ``active``; a chain that is not
        (or stops being) active keeps its carry and its checkpoints."""
        n_leaves = 1 << depth
        leaves.begin_subtree(frontier, h, active,
                             self.draws.uniform((active.shape[0], n_leaves)))
        for n in range(1, n_leaves + 1):          # 1-based leaf number
            if n > 1 and not self._any(leaves.any_active):
                break
            leaves.step()
        return leaves.subtree()

    def __call__(self, state: NUTSState, step_size: torch.Tensor,
                 inverse_mass_matrix: torch.Tensor):
        if self.draws is None:
            self.draws = device_draws(self.generator, state.position.device)
        n_chains, dim = state.position.shape
        device = state.position.device
        p0 = sample_momentum(self.draws, (n_chains, dim), inverse_mass_matrix)
        energy0 = -state.logdensity + euclidean_kinetic_energy(
            p0, inverse_mass_matrix)
        leaves = self._leaves
        if leaves is None or not leaves.fits(p0):
            leaves = self._leaves = _Leaves(
                self.logdensity_and_grad, p0, self.max_depth,
                self.divergence_threshold,
                self.graph and device.type == 'cuda')
        leaves.begin_step(energy0, inverse_mass_matrix)
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
        active = ~no

        for depth in range(self.max_depth):
            if depth and not self._any(active):
                break
            go_right = self.draws.uniform((n_chains,)) < 0.5
            bias = self.draws.uniform((n_chains,))
            direction = torch.where(go_right, 1.0, -1.0).to(step_size.dtype)
            frontier = select(go_right, t.right, t.left)
            sub = self._subtree(leaves, frontier, direction * step_size,
                                depth, active)
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


def _leaf_table(max_depth: int, device) -> tuple:
    """``(store, check)``, each ``(2**(max_depth-1), max_depth)`` bool, by
    0-based leaf index: the odd leaf ``n`` (1-based) stores its checkpoint
    at slot ``popcount(n-1)``; the even leaf ``n`` checks the slots
    ``popcount(n-1)-1 - tz(n) + 1 .. popcount(n-1)-1`` (those of every
    complete subtree ending at it)."""
    n_leaves = 1 << max(max_depth - 1, 0)
    store = torch.zeros(n_leaves, max_depth, dtype=torch.bool)
    check = torch.zeros_like(store)
    for n in range(1, n_leaves + 1):
        if n & 1:
            store[n - 1, _popcount(n - 1)] = True
        else:
            idx_max = _popcount(n - 1) - 1
            idx_min = max(idx_max - _trailing_zeros(n) + 1, 0)
            check[n - 1, idx_min:idx_max + 1] = True
    return store.to(device), check.to(device)


class _Leaves:
    """A subtree's carry, its checkpoints and the inputs of its leaves in
    buffers of fixed address, and the leaf that updates them in place.

    :meth:`begin_step` loads a NUTS step's initial energy and inverse mass
    matrix and clears the checkpoints; :meth:`begin_subtree` loads a
    subtree's frontier, signed step, active chains and leaf uniforms and
    sets the leaf counter to 0; each :meth:`step` takes the next leaf for
    the active chains; :meth:`subtree` copies the carry out. The leaf's
    slot arithmetic reads the table of :func:`_leaf_table` at the counter,
    so every leaf is the same work. With ``graph`` (a CUDA device) the
    leaf is captured in a CUDA graph at the first :meth:`step`, after two
    eager runs on a side stream whose changes to the buffers are undone,
    all three in :func:`~mile_tpu_torch.models.blocks.split_k_rows`, and
    each later step replays it. The graph keeps the route of every
    product as it was at capture, so the leaves serve only a step under
    the same arithmetic and float32 matmul precision (:meth:`fits`)."""

    def __init__(self, logdensity_and_grad: Callable, p0: torch.Tensor,
                 max_depth: int, divergence_threshold: float, graph: bool):
        n_chains, dim = p0.shape
        device, dtype = p0.device, p0.dtype
        self.divergence_threshold = divergence_threshold
        vec = lambda: torch.zeros(n_chains, dim, device=device, dtype=dtype)
        chains = lambda dt=dtype: torch.zeros(n_chains, device=device,
                                              dtype=dt)
        state = lambda: EuclideanState(vec(), vec(), chains(), vec())
        self.carry = _Subtree(
            leaves=chains(torch.int32), z=state(), prop=state(),
            log_sum_w=chains(), psum=vec(), turning=chains(torch.bool),
            diverging=chains(torch.bool), sum_accept=chains())
        self.active = chains(torch.bool)
        self.any_active = torch.zeros((), device=device, dtype=torch.bool)
        self.h = chains()
        self.energy0 = chains()
        self.inverse_mass_matrix = vec()
        self.ckpt_p = torch.zeros(n_chains, max_depth, dim, device=device,
                                  dtype=dtype)
        self.ckpt_psum = torch.zeros_like(self.ckpt_p)
        self.store, self.check = _leaf_table(max_depth, device)
        self.swaps = torch.zeros(n_chains, self.store.shape[0],
                                 device=device, dtype=dtype)
        self.index = torch.zeros(1, device=device, dtype=torch.long)
        self.integrate = velocity_verlet(logdensity_and_grad,
                                         self.inverse_mass_matrix)
        self.graph = graph
        self._graph = None
        self.steps = 0
        self.key = self.key_of(p0)

    @staticmethod
    def key_of(p0: torch.Tensor) -> tuple:
        """What the leaves are built for: the batch's shape, device and
        dtype, and the scope's arithmetic and float32 matmul precision."""
        return (tuple(p0.shape), p0.device, p0.dtype, arithmetic(),
                torch.get_float32_matmul_precision())

    def fits(self, p0: torch.Tensor) -> bool:
        return self.key_of(p0) == self.key

    def _buffers(self) -> list:
        """Every buffer a leaf writes."""
        c = self.carry
        return [c.leaves, *c.z, *c.prop, c.log_sum_w, c.psum, c.turning,
                c.diverging, c.sum_accept, self.active, self.any_active,
                self.ckpt_p, self.ckpt_psum, self.index]

    def begin_step(self, energy0: torch.Tensor,
                   inverse_mass_matrix: torch.Tensor) -> None:
        self.energy0.copy_(energy0)
        self.inverse_mass_matrix.copy_(inverse_mass_matrix)
        self.ckpt_p.zero_()
        self.ckpt_psum.zero_()

    def begin_subtree(self, frontier: EuclideanState, h: torch.Tensor,
                      active: torch.Tensor, swaps: torch.Tensor) -> None:
        c = self.carry
        for buf, value in zip((*c.z, *c.prop), (*frontier, *frontier)):
            buf.copy_(value)
        c.leaves.zero_()
        c.log_sum_w.fill_(-torch.inf)
        c.psum.zero_()
        c.turning.zero_()
        c.diverging.zero_()
        c.sum_accept.zero_()
        self.active.copy_(active)
        self.h.copy_(h)
        self.swaps[:, :swaps.shape[1]].copy_(swaps)
        self.index.zero_()

    def subtree(self) -> _Subtree:
        c = self.carry
        copy = lambda s: EuclideanState(*(t.clone() for t in s))
        return _Subtree(
            leaves=c.leaves.clone(), z=copy(c.z), prop=copy(c.prop),
            log_sum_w=c.log_sum_w.clone(), psum=c.psum.clone(),
            turning=c.turning.clone(), diverging=c.diverging.clone(),
            sum_accept=c.sum_accept.clone())

    def _leaf(self) -> None:
        """One leaf for the active chains, in place."""
        c, active, imm = self.carry, self.active, self.inverse_mass_matrix
        store = self.store.index_select(0, self.index)      # (1, depth)
        check = self.check.index_select(0, self.index)
        u = self.swaps.index_select(1, self.index)[:, 0]
        z = self.integrate(c.z, self.h)
        energy = -z.logdensity + euclidean_kinetic_energy(z.momentum, imm)
        delta = metropolis_delta(self.energy0, energy)
        diverging = -delta > self.divergence_threshold
        log_sum_w = torch.logaddexp(c.log_sum_w, delta)
        take = torch.log(u) < delta - log_sum_w
        psum = c.psum + z.momentum
        # every complete subtree ending at an even leaf, against the slots
        # of its checked rows; an odd leaf checks none
        turning = (_is_turning(self.ckpt_p, z.momentum[:, None],
                               psum[:, None] - self.ckpt_psum,
                               imm[:, None]) & check).any(dim=1) & ~diverging
        # an odd leaf stores its checkpoint at its row's slot
        keep = (active[:, None] & store)[..., None]
        ckpt_p = torch.where(keep, z.momentum[:, None], self.ckpt_p)
        ckpt_psum = torch.where(keep, c.psum[:, None], self.ckpt_psum)
        new = select(active, _Subtree(
            leaves=c.leaves + 1, z=z, prop=select(take, z, c.prop),
            log_sum_w=log_sum_w, psum=psum, turning=turning,
            diverging=diverging,
            sum_accept=c.sum_accept + torch.clamp(torch.exp(delta),
                                                  max=1.0)), c)
        active = active & ~(turning | diverging)
        for buf, value in zip(
                self._buffers(),
                [new.leaves, *new.z, *new.prop, new.log_sum_w, new.psum,
                 new.turning, new.diverging, new.sum_accept, active,
                 active.any(), ckpt_p, ckpt_psum, self.index + 1]):
            buf.copy_(value)

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def step(self) -> None:
        self.steps += 1
        if not self.graph:
            self._leaf()
            return
        if self._graph is None:
            self._capture()
        self._graph.replay()

    def _capture(self) -> None:
        saved = [b.clone() for b in self._buffers()]
        side = torch.cuda.Stream(self.h.device)
        side.wait_stream(torch.cuda.current_stream(self.h.device))
        with split_k_rows():
            with torch.cuda.stream(side):
                for _ in range(2):
                    self._leaf()
            torch.cuda.current_stream(self.h.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._leaf()
        for buf, value in zip(self._buffers(), saved):
            buf.copy_(value)
        self._graph = graph


def build_kernel(logdensity_and_grad: Callable,
                 generator: Optional[torch.Generator] = None,
                 max_depth: int = 10,
                 divergence_threshold: float = DIVERGENCE_THRESHOLD,
                 draws=None, graph: bool = True) -> NUTSKernel:
    """``graph``: capture the leaf in a CUDA graph on a CUDA device (see
    :class:`_Leaves`). ``False`` is for a log-density sharded over a mesh
    of several entries (``train/sampling_hmc.py``), whose leaves run
    eagerly, as every leaf off CUDA."""
    return NUTSKernel(logdensity_and_grad, generator, max_depth,
                      divergence_threshold, draws, graph)
