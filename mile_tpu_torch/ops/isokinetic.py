"""The MCLMC hot path's two fused ops: kernel wrappers, plain versions and
launch counters (counterpart of ``mile_tpu/ops/isokinetic.py``).

- :func:`isokinetic_momentum` replaces the Pallas TPU kernels
  ``_batched_momentum_kernel`` (K1) and ``_momentum_kernel`` (K2, served
  here with C = 1) of ``mile_tpu/ops/isokinetic.py``: the isokinetic
  velocity rotation towards the preconditioned gradient, with its
  kinetic-energy change. Fused in: the preconditioner multiply (outside
  the TPU kernel), and on request the position drift that follows the
  rotation and the running sum of ΔK.
- :func:`partial_refresh` replaces ``_batched_refresh_kernel`` (K3) and
  ``_refresh_kernel`` (K4, served with C = 1): the partial momentum
  refresh with in-kernel random numbers (Philox4x32-10 keyed by run seed,
  chain, step counter and group of four elements, instead of the TPU's
  on-chip PRNG). Fused in on request: ΔE = ΔK − logp′ + logp and its
  running sums. The step counter may be a device tensor that the kernel
  advances itself, so that a CUDA graph of a step draws fresh noise.

Both kernels are CUDA C++ for ``sm_90a`` in ``mile_tpu_torch/csrc/
isokinetic.cu``. What bounds them on an H100 is bytes; at the main path's
(12, 674) the bound is tens of nanoseconds, under one round trip to device
memory, so the design cuts round trips: each element is read once into
registers, both reductions come from there, and the result is written
once; a long chain is split over a thread-block cluster
(:func:`kernel_route` picks the launch shape; the source note in the
``.cu`` file has the rest). The wrappers keep host work low, since the
eager step is bound by host launch cost: the ctypes function is resolved
once, a ``(C,)`` float32 tensor on the card passes through unconverted,
and the stream is read as a raw handle.

Dispatch is by the tensors' device alone: on a CPU tensor each wrapper
computes its plain PyTorch version; on a CUDA tensor it launches its
kernel or raises. There is no fallback from the kernel to the plain
version. Each wrapper counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from mile_tpu_torch.ops import build

_GUARD = 1e-30

# csrc/isokinetic.cu's kSlots, kMaxThreads, kMaxCluster and kTicketBits
_SLOTS, _MAX_THREADS, _MAX_CLUSTER, _TICKET_BITS = 4, 512, 8, 24


class Route(NamedTuple):
    """A kernel's launch shape for one chain length: ``threads`` per block,
    ``cluster`` blocks per chain, ``per_cta`` groups of 4 elements per
    block, and whether they stay ``resident`` in registers."""

    threads: int
    cluster: int
    per_cta: int
    resident: bool


@functools.cache
def kernel_route(dim: int) -> Route:
    """About two groups a thread up to one block's registers (8192
    elements); past that, a cluster of up to 8 blocks of 512 threads per
    chain, resident up to 65,536 elements and streaming beyond."""
    groups = -(-dim // 4)
    if groups <= _MAX_THREADS * _SLOTS:
        threads, cluster = min(_MAX_THREADS, 32 * -(-groups // 64)), 1
    else:
        threads = _MAX_THREADS
        cluster = min(_MAX_CLUSTER, -(-groups // (_MAX_THREADS * _SLOTS)))
    per_cta = -(-groups // cluster)
    return Route(threads, cluster, per_cta, per_cta <= threads * _SLOTS)


# ------------------------------------------------------------- helpers
def _per_chain(value, n_chains: int, like: torch.Tensor) -> torch.Tensor:
    """A per-chain float32 ``(C,)`` tensor on ``like``'s device from a
    number, a 0-d or a ``(C,)`` tensor; one that already is passes
    through."""
    if (isinstance(value, torch.Tensor) and value.dtype == torch.float32
            and value.shape == (n_chains,) and value.device == like.device
            and value.is_contiguous()):
        return value
    t = torch.as_tensor(value, dtype=torch.float32, device=like.device)
    if t.dim() == 0:
        t = t.expand(n_chains)
    if t.shape != (n_chains,):
        raise ValueError(f'expected a per-chain ({n_chains},) value, '
                         f'got shape {tuple(t.shape)}')
    return t.contiguous()


def _check(t: torch.Tensor, name: str, shape: tuple, like: torch.Tensor,
           dtype=torch.float32) -> None:
    if t.device != like.device or t.dtype != dtype:
        raise ValueError(f'{name} must be {dtype} on {like.device}, got '
                         f'{t.dtype} on {t.device}')
    if t.shape != shape or not t.is_contiguous():
        raise ValueError(f'{name} must be a contiguous {tuple(shape)} tensor,'
                         f' got {tuple(t.shape)} (contiguous='
                         f'{t.is_contiguous()})')


def _on_cpu(what: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA tensor
    (kernel); raises for any other device."""
    if t.is_cuda:
        return False
    if t.device.type == 'cpu':
        return True
    raise ValueError(f'{what}: unsupported device {t.device}')


@functools.cache
def _kernels():
    """(momentum, refresh, current raw stream): resolved once."""
    lib = build.isokinetic_library()
    return (lib.mile_isokinetic_momentum, lib.mile_partial_refresh,
            torch._C._cuda_getCurrentRawStream)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


# ----------------------------------------------- K1/K2: momentum rotation
def isokinetic_momentum_plain(u: torch.Tensor, g: torch.Tensor, step_size,
                              sqrt_diag_cov=None, coef: float = 1.0, *,
                              x: torch.Tensor | None = None,
                              x_frac: float = 0.0,
                              kinetic: torch.Tensor | None = None):
    """Plain PyTorch version of K1: ``mile_tpu.mcmc.integrators.
    isokinetic_momentum_update`` over a chain batch.

    ``u``, ``g``: (C, dim); ``step_size``: per-chain (C,) or shared;
    ``sqrt_diag_cov``: None, a number, (dim,) or (C, dim); the rotation
    uses ε = coef · step_size. Returns (u' (C, dim), ΔK (C,)).

    ``kinetic`` (C,): ΔK is added into it in place and it is returned in
    ΔK's place. ``x`` (C, dim): the drift that follows the rotation,
    x' = x + (x_frac · step_size) · u' · sqrt_diag_cov in the order of
    ``mile_tpu/mcmc/integrators.py::_position_update``, is appended to the
    result.
    """
    n_chains, dim = u.shape
    step_size = _per_chain(step_size, n_chains, u)
    if sqrt_diag_cov is not None:
        g = g * sqrt_diag_cov
    eps = (coef * step_size)[:, None]
    g_norm = torch.sqrt(torch.sum(g * g, dim=1, keepdim=True))
    e = g / torch.clamp_min(g_norm, _GUARD)
    ue = torch.sum(u * e, dim=1, keepdim=True)
    delta = eps * g_norm / (dim - 1)
    zeta = torch.exp(-delta)
    new_u = e * ((1.0 - zeta) * (1.0 + zeta + ue * (1.0 - zeta))) \
        + 2.0 * zeta * u
    norm = torch.sqrt(torch.sum(new_u * new_u, dim=1, keepdim=True))
    new_u = new_u / torch.clamp_min(norm, _GUARD)
    delta_r = delta - math.log(2.0) + torch.log1p(
        ue + (1.0 - ue) * zeta * zeta)
    dk = (delta_r * (dim - 1))[:, 0]
    if kinetic is not None:
        dk = kinetic.add_(dk)
    if x is None:
        return new_u, dk
    dx = (x_frac * step_size)[:, None] * new_u
    if sqrt_diag_cov is not None:
        dx = dx * sqrt_diag_cov
    return new_u, dk, x + dx


def _preconditioner(sqrt_diag_cov, n_chains: int, dim: int,
                    like: torch.Tensor) -> tuple[int | None, int]:
    """(pointer, row stride) of the kernel's preconditioner: none for None
    or 1.0, else a (dim,) or (C, dim) float32 tensor on the card."""
    if sqrt_diag_cov is None or (isinstance(sqrt_diag_cov, (int, float))
                                 and sqrt_diag_cov == 1.0):
        return None, 0
    sdc = sqrt_diag_cov
    if not isinstance(sdc, torch.Tensor) or sdc.dim() == 0:
        sdc = torch.as_tensor(sdc, dtype=torch.float32,
                              device=like.device).expand(dim).contiguous()
    _check(sdc, 'sqrt_diag_cov', sdc.shape, like)
    if sdc.shape == (n_chains, dim):
        return sdc.data_ptr(), dim
    if sdc.shape != (dim,):
        raise ValueError(f'sqrt_diag_cov must be (dim,) or (C, dim), '
                         f'got {tuple(sdc.shape)}')
    return sdc.data_ptr(), 0


def isokinetic_momentum(u: torch.Tensor, g: torch.Tensor, step_size,
                        sqrt_diag_cov=None, coef: float = 1.0, *,
                        x: torch.Tensor | None = None, x_frac: float = 0.0,
                        kinetic: torch.Tensor | None = None):
    """K1: the isokinetic rotation of a chain batch (see the plain version
    for the arguments and results). CPU tensors: plain version. CUDA
    tensors: the kernel ``isokinetic_momentum_kernel`` in
    ``csrc/isokinetic.cu``."""
    if _on_cpu('isokinetic_momentum', u):
        return isokinetic_momentum_plain(u, g, step_size, sqrt_diag_cov, coef,
                                         x=x, x_frac=x_frac, kinetic=kinetic)
    n_chains, dim = u.shape
    shape = u.shape
    step_size = _per_chain(step_size, n_chains, u)
    _check(u, 'u', shape, u)
    _check(g, 'g', shape, u)
    sdc_ptr, sdc_stride = _preconditioner(sqrt_diag_cov, n_chains, dim, u)
    if kinetic is None:
        dk = torch.empty(n_chains, dtype=torch.float32, device=u.device)
    else:
        _check(kinetic, 'kinetic', step_size.shape, u)
        dk = kinetic
    x_out = None
    if x is not None:
        _check(x, 'x', shape, u)
        x_out = torch.empty_like(x)
    new_u = torch.empty_like(u)
    momentum, _, stream = _kernels()
    code = momentum(
        u.data_ptr(), g.data_ptr(), sdc_ptr, sdc_stride, step_size.data_ptr(),
        coef, _ptr(x), x_frac, _ptr(x_out), new_u.data_ptr(), dk.data_ptr(),
        kinetic is not None, n_chains, dim, *kernel_route(dim),
        stream(u.get_device()))
    if code:
        build.raise_error(code, 'isokinetic_momentum')
    isokinetic_momentum.launches += 1
    return (new_u, dk) if x is None else (new_u, dk, x_out)


isokinetic_momentum.launches = 0


# --------------------------------------------------- K3/K4: partial refresh
def step_counter(step: int = 0, device=None) -> torch.Tensor:
    """A step counter for :func:`partial_refresh` at ``step``: an int64
    holding the step above its low 24 bits, which the kernel uses as its
    ticket while a call runs (zero between calls)."""
    return torch.full((), step << _TICKET_BITS, dtype=torch.int64,
                      device=device)


def counter_step(counter: torch.Tensor) -> int:
    """The step a :func:`step_counter` holds (reading it waits for the
    device)."""
    return int(counter_steps(counter))


def counter_steps(counter: torch.Tensor) -> torch.Tensor:
    """The step a :func:`step_counter` holds, as a new int64 tensor on its
    device: computed in stream order, so it keeps the step at the point of
    the call while the counter goes on, and nothing waits for the device."""
    return counter >> _TICKET_BITS


def refresh_noise_cpu(shape, seed: int, counter: int) -> torch.Tensor:
    """The CPU path's standard normals for (run seed, step counter): a
    torch generator keyed by both, so a run's noise does not depend on
    what else drew numbers. (On CUDA the kernel's Philox draws its own.)"""
    key = (int(seed) * 0x9E3779B97F4A7C15 + int(counter)) % (1 << 64)
    return torch.randn(shape, generator=torch.Generator().manual_seed(key))


def partial_refresh_plain(u: torch.Tensor, step_size, L, z: torch.Tensor, *,
                          energy: tuple | None = None,
                          energy_sums: tuple | None = None):
    """Plain PyTorch version of K3: ``mile_tpu.mcmc.integrators.
    partially_refresh_momentum`` over a chain batch, given the normals
    ``z`` (C, dim). ν = sqrt((e^(2ε/L) − 1)/dim); entries where u == 0
    get no noise (the kernel's rule); u' = (u + νz)/|u + νz|.

    ``energy`` = (ΔK, logp′, logp), each (C,): ΔE = ΔK − logp′ + logp (the
    order of ``mile_tpu/mcmc/mclmc.py``) is computed too, and the result
    is (u', ΔE). ``energy_sums`` = (Σ, Σ²), each (C,): ΔE and ΔE² are
    added into them in place.
    """
    n_chains, dim = u.shape
    eps = _per_chain(step_size, n_chains, u)
    L = _per_chain(L, n_chains, u)
    nu = torch.sqrt((torch.exp(2.0 * eps / L) - 1.0) / dim)[:, None]
    z = torch.where(u == 0.0, torch.zeros_like(z), z)
    w = u + nu * z
    norm = torch.sqrt(torch.sum(w * w, dim=1, keepdim=True))
    out = w / torch.clamp_min(norm, _GUARD)
    if energy is None:
        if energy_sums is not None:
            raise ValueError('energy_sums needs energy')
        return out
    kinetic_change, logdensity_new, logdensity = energy
    energy_change = kinetic_change - logdensity_new + logdensity
    if energy_sums is not None:
        total, total_sq = energy_sums
        total += energy_change
        total_sq += energy_change * energy_change
    return out, energy_change


def partial_refresh(u: torch.Tensor, step_size, L, seed: int = 0,
                    counter: int | torch.Tensor = 0,
                    z: torch.Tensor | None = None, *,
                    energy: tuple | None = None,
                    energy_sums: tuple | None = None):
    """K3: partial momentum refresh of a chain batch ``u`` (C, dim).

    The noise is keyed by the run's ``seed`` and the step ``counter``, or
    injected as ``z`` (C, dim). ``counter`` is an int, or a
    :func:`step_counter` on ``u``'s device that the call reads and
    advances by one step (on CUDA the kernel does both, so a captured
    graph draws fresh noise on each replay). ``energy`` and
    ``energy_sums``: as in the plain version.

    CPU tensors: plain version, with :func:`refresh_noise_cpu`'s normals.
    CUDA tensors: the kernel ``partial_refresh_kernel`` in
    ``csrc/isokinetic.cu`` (Philox4x32-10, or ``z`` when given)."""
    if energy_sums is not None and energy is None:
        raise ValueError('energy_sums needs energy')
    counts = isinstance(counter, torch.Tensor)
    if counts:
        _check(counter, 'counter', counter.shape, u, torch.int64)
        if counter.numel() != 1:
            raise ValueError('counter must hold one element')
    if _on_cpu('partial_refresh', u):
        if z is None:
            z = refresh_noise_cpu(u.shape, seed, counter_step(counter)
                                  if counts else counter)
        if counts:
            counter += 1 << _TICKET_BITS
        return partial_refresh_plain(u, step_size, L, z, energy=energy,
                                     energy_sums=energy_sums)
    n_chains, dim = u.shape
    step_size = _per_chain(step_size, n_chains, u)
    L = _per_chain(L, n_chains, u)
    _check(u, 'u', u.shape, u)
    if z is not None:
        _check(z, 'z', u.shape, u)
    dk = logp_new = logp = de = total = total_sq = None
    if energy is not None:
        dk, logp_new, logp = energy
        for t, name in ((dk, 'kinetic change'), (logp_new, 'logdensity_new'),
                        (logp, 'logdensity')):
            _check(t, name, step_size.shape, u)
        de = torch.empty(n_chains, dtype=torch.float32, device=u.device)
    if energy_sums is not None:
        total, total_sq = energy_sums
        _check(total, 'energy sum', step_size.shape, u)
        _check(total_sq, 'energy square sum', step_size.shape, u)
    out = torch.empty_like(u)
    _, refresh, stream = _kernels()
    code = refresh(
        u.data_ptr(), step_size.data_ptr(), L.data_ptr(), _ptr(z),
        int(seed) % (1 << 64), 0 if counts else int(counter) % (1 << 64),
        counter.data_ptr() if counts else None, out.data_ptr(),
        _ptr(dk), _ptr(logp_new), _ptr(logp), _ptr(de), _ptr(total),
        _ptr(total_sq), n_chains, dim, *kernel_route(dim),
        stream(u.get_device()))
    if code:
        build.raise_error(code, 'partial_refresh')
    partial_refresh.launches += 1
    return out if energy is None else (out, de)


partial_refresh.launches = 0


def reset_launch_counts() -> None:
    isokinetic_momentum.launches = 0
    partial_refresh.launches = 0
