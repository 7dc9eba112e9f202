"""Cross-chain MCMC diagnostics: ESS, autocovariance, potential scale
reduction (counterpart of ``mile_tpu/mcmc/diagnostics.py``).

FFT autocovariance (``torch.fft``) + Geyer's initial monotone positive
sequence, vectorized over arbitrary trailing parameter dimensions.
"""
from __future__ import annotations

import math

import torch


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


def autocovariance(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Biased sample autocovariance along ``dim`` via FFT:
    ``acov[t] = (1/N) sum_i (x_i - mean)(x_{i+t} - mean)``."""
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    centered = x - x.mean(dim=-1, keepdim=True)
    m = _next_pow2(2 * n)   # >= 2n for linear (non-circular) correlation
    f = torch.fft.rfft(centered, n=m, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=-1)[..., :n] / n
    return torch.movedim(acov, -1, dim)


def effective_sample_size(samples: torch.Tensor) -> torch.Tensor:
    """ESS of ``samples`` (n_chains, n_samples, ...), pooled over chains:
    one value per parameter, shape ``samples.shape[2:]``."""
    c, n = samples.shape[0], samples.shape[1]
    acov = autocovariance(samples, dim=1)             # (C, N, ...)
    chain_mean = samples.mean(dim=1)                  # (C, ...)
    mean_acov = acov.mean(dim=0)                      # (N, ...)
    chain_var = acov[:, 0] * n / (n - 1.0)            # unbiased per chain
    w = chain_var.mean(dim=0)                         # within-chain variance
    var_plus = w * (n - 1.0) / n
    if c > 1:
        var_plus = var_plus + chain_mean.var(dim=0, correction=1)

    rho = 1.0 - (w - mean_acov) / var_plus            # (N, ...)
    return ess_from_autocorrelation(rho, c, n)


def constant_trace_ess(n: int) -> float:
    """The ESS the JAX package's compiled tuner gives a coordinate whose
    ``n`` draws (one chain) are all equal. XLA's mean of equal float32
    values is inexact, so such a trace is centred on a tiny constant
    offset, whose autocorrelation at lag t is (n - t)/n - 1/(n - 1) at any
    offset; centred exactly, the estimator divides 0 by 0."""
    t = torch.arange(n, dtype=torch.float64)
    return float(ess_from_autocorrelation((n - t) / n - 1.0 / (n - 1.0),
                                          1, n))


def ess_from_autocorrelation(rho: torch.Tensor, c: int, n: int
                             ) -> torch.Tensor:
    """Geyer's initial monotone sequence estimate over the pooled
    autocorrelation ``rho`` (N, ...) of ``c`` chains of ``n`` draws."""
    # Geyer pair sums P_k = rho_{2k} + rho_{2k+1}
    n_pairs = n // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2, *rho.shape[1:]).sum(dim=1)
    # initial positive sequence: zero from the first non-positive pair on
    positive = torch.cumprod((pairs > 0.0).to(pairs.dtype), dim=0)
    pairs = pairs * positive
    # initial monotone sequence: running minimum
    pairs = torch.cummin(pairs, dim=0).values
    pairs = torch.clamp_min(pairs, 0.0)

    tau = -1.0 + 2.0 * pairs.sum(dim=0)
    # (a single draw gives an infinite floor, and so an ESS of 0, as in JAX)
    floor = 1.0 / math.log10(c * n) if c * n > 1 else math.inf
    tau = torch.clamp_min(tau, floor)
    return torch.clamp_max(c * n / tau, float(c * n))


def potential_scale_reduction(samples: torch.Tensor) -> torch.Tensor:
    """Plain (non-split) R-hat for (n_chains, n_samples, ...) samples."""
    n = samples.shape[1]
    w = samples.var(dim=1, correction=1).mean(dim=0)
    b_over_n = samples.mean(dim=1).var(dim=0, correction=1)
    var_plus = w * (n - 1.0) / n + b_over_n
    return torch.sqrt(var_plus / w)
