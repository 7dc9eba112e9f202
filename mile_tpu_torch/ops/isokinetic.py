"""The MCLMC hot path's two fused ops: kernel wrappers, plain versions and
launch counters (counterpart of ``mile_tpu/ops/isokinetic.py``).

- :func:`isokinetic_momentum` replaces the Pallas TPU kernels
  ``_batched_momentum_kernel`` (K1) and ``_momentum_kernel`` (K2, served
  here with C = 1) of ``mile_tpu/ops/isokinetic.py``: the isokinetic
  velocity rotation towards the preconditioned gradient, with its
  kinetic-energy change. The preconditioner multiply, done outside the
  TPU kernel, is fused in.
- :func:`partial_refresh` replaces ``_batched_refresh_kernel`` (K3) and
  ``_refresh_kernel`` (K4, served with C = 1): the partial momentum
  refresh with in-kernel random numbers (Philox4x32-10 keyed by run seed,
  chain, step counter and element, instead of the TPU's on-chip PRNG).

Both kernels are CUDA C++ for ``sm_90a`` in ``mile_tpu_torch/csrc/
isokinetic.cu``. What bounds them on an H100 is bytes (two to three
float32 ``(C, dim)`` vectors read, one written); at the main path's
(12, 674) that is ~10^-5 ms of memory time, so a launch costs far more than
its work, and one block per chain keeps 12 of the 132 SMs busy. The design
is the simple one (one block per chain, block-stride loops, block
reductions; any dim, no padding, no cap); the source note in the ``.cu``
file has the rest. Making them fast is a later PR's work.

Dispatch is by the tensors' device alone: on a CPU tensor each wrapper
computes its plain PyTorch version; on a CUDA tensor it launches its
kernel or raises. There is no fallback from the kernel to the plain
version. Each wrapper counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import math

import torch

from mile_tpu_torch.ops import build

_GUARD = 1e-30


# ------------------------------------------------------------- helpers
def _per_chain(value, n_chains: int, like: torch.Tensor) -> torch.Tensor:
    """A per-chain float32 ``(C,)`` tensor from a number, a 0-d or a
    ``(C,)`` tensor."""
    t = torch.as_tensor(value, dtype=torch.float32, device=like.device)
    if t.dim() == 0:
        t = t.expand(n_chains)
    if t.shape != (n_chains,):
        raise ValueError(f'expected a per-chain ({n_chains},) value, '
                         f'got shape {tuple(t.shape)}')
    return t


def _check(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f'{name} must be float32 on {device}, got '
                         f'{t.dtype} on {t.device}')
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f'{name} must be a contiguous {tuple(shape)} tensor,'
                         f' got {tuple(t.shape)} (contiguous='
                         f'{t.is_contiguous()})')


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------- K1/K2: momentum rotation
def isokinetic_momentum_plain(u: torch.Tensor, g: torch.Tensor, step_size,
                              sqrt_diag_cov=None, coef: float = 1.0
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: ``mile_tpu.mcmc.integrators.
    isokinetic_momentum_update`` over a chain batch.

    ``u``, ``g``: (C, dim); ``step_size``: per-chain (C,) or shared;
    ``sqrt_diag_cov``: None, a number, (dim,) or (C, dim); the rotation
    uses ε = coef · step_size. Returns (u' (C, dim), ΔK (C,)).
    """
    n_chains, dim = u.shape
    if sqrt_diag_cov is not None:
        g = g * sqrt_diag_cov
    eps = (coef * _per_chain(step_size, n_chains, u))[:, None]
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
    return new_u, (delta_r * (dim - 1))[:, 0]


def isokinetic_momentum(u: torch.Tensor, g: torch.Tensor, step_size,
                        sqrt_diag_cov=None, coef: float = 1.0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: the isokinetic rotation of a chain batch (see the plain version
    for the arguments). CPU tensors: plain version. CUDA tensors: the
    kernel ``isokinetic_momentum_kernel`` in ``csrc/isokinetic.cu``."""
    if u.device.type == 'cpu':
        return isokinetic_momentum_plain(u, g, step_size, sqrt_diag_cov, coef)
    if u.device.type != 'cuda':
        raise ValueError(f'isokinetic_momentum: unsupported device {u.device}')
    n_chains, dim = u.shape
    device = u.device
    step_size = _per_chain(step_size, n_chains, u).contiguous()
    _check(u, 'u', (n_chains, dim), device)
    _check(g, 'g', (n_chains, dim), device)
    sdc_ptr, sdc_stride = None, 0
    if sqrt_diag_cov is not None and not (
            isinstance(sqrt_diag_cov, (int, float)) and sqrt_diag_cov == 1.0):
        sdc = torch.as_tensor(sqrt_diag_cov, dtype=torch.float32,
                              device=device)
        if sdc.dim() == 0:
            sdc = sdc.expand(dim).contiguous()
        _check(sdc, 'sqrt_diag_cov', sdc.shape, device)
        if sdc.shape == (n_chains, dim):
            sdc_stride = dim
        elif sdc.shape != (dim,):
            raise ValueError(f'sqrt_diag_cov must be (dim,) or (C, dim), '
                             f'got {tuple(sdc.shape)}')
        sdc_ptr = sdc.data_ptr()
    lib = build.isokinetic_library()
    new_u = torch.empty_like(u)
    dk = torch.empty(n_chains, dtype=torch.float32, device=device)
    build.check(lib, lib.mile_isokinetic_momentum(
        u.data_ptr(), g.data_ptr(), sdc_ptr, sdc_stride,
        step_size.data_ptr(), float(coef), new_u.data_ptr(), dk.data_ptr(),
        n_chains, dim, _stream(device)), 'isokinetic_momentum')
    isokinetic_momentum.launches += 1
    return new_u, dk


isokinetic_momentum.launches = 0


# --------------------------------------------------- K3/K4: partial refresh
def refresh_noise_cpu(shape, seed: int, counter: int) -> torch.Tensor:
    """The CPU path's standard normals for (run seed, step counter): a
    torch generator keyed by both, so a run's noise does not depend on
    what else drew numbers. (On CUDA the kernel's Philox draws its own.)"""
    key = (int(seed) * 0x9E3779B97F4A7C15 + int(counter)) % (1 << 64)
    return torch.randn(shape, generator=torch.Generator().manual_seed(key))


def partial_refresh_plain(u: torch.Tensor, step_size, L,
                          z: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: ``mile_tpu.mcmc.integrators.
    partially_refresh_momentum`` over a chain batch, given the normals
    ``z`` (C, dim). ν = sqrt((e^(2ε/L) − 1)/dim); entries where u == 0
    get no noise (the kernel's rule); u' = (u + νz)/|u + νz|."""
    n_chains, dim = u.shape
    eps = _per_chain(step_size, n_chains, u)
    L = _per_chain(L, n_chains, u)
    nu = torch.sqrt((torch.exp(2.0 * eps / L) - 1.0) / dim)[:, None]
    z = torch.where(u == 0.0, torch.zeros_like(z), z)
    w = u + nu * z
    norm = torch.sqrt(torch.sum(w * w, dim=1, keepdim=True))
    return w / torch.clamp_min(norm, _GUARD)


def partial_refresh(u: torch.Tensor, step_size, L, seed: int = 0,
                    counter: int = 0, z: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """K3: partial momentum refresh of a chain batch ``u`` (C, dim).

    The noise is keyed by the run's ``seed`` and the host step ``counter``
    (no device sync), or injected as ``z`` (C, dim). CPU tensors: plain
    version. CUDA tensors: the kernel ``partial_refresh_kernel`` in
    ``csrc/isokinetic.cu`` (Philox4x32-10, or ``z`` when given)."""
    if u.device.type == 'cpu':
        if z is None:
            z = refresh_noise_cpu(u.shape, seed, counter)
        return partial_refresh_plain(u, step_size, L, z)
    if u.device.type != 'cuda':
        raise ValueError(f'partial_refresh: unsupported device {u.device}')
    n_chains, dim = u.shape
    device = u.device
    step_size = _per_chain(step_size, n_chains, u).contiguous()
    L = _per_chain(L, n_chains, u).contiguous()
    _check(u, 'u', (n_chains, dim), device)
    if z is not None:
        _check(z, 'z', (n_chains, dim), device)
    lib = build.isokinetic_library()
    out = torch.empty_like(u)
    build.check(lib, lib.mile_partial_refresh(
        u.data_ptr(), step_size.data_ptr(), L.data_ptr(),
        None if z is None else z.data_ptr(), int(seed) % (1 << 64),
        int(counter) % (1 << 64), out.data_ptr(), n_chains, dim,
        _stream(device)), 'partial_refresh')
    partial_refresh.launches += 1
    return out


partial_refresh.launches = 0


def reset_launch_counts() -> None:
    isokinetic_momentum.launches = 0
    partial_refresh.launches = 0
