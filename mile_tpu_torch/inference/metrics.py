"""Metrics: containers + posterior-predictive and cross-chain statistics
(counterpart of ``mile_tpu/inference/metrics.py``)."""
from __future__ import annotations

import dataclasses
import math
import pickle
from pathlib import Path

import numpy as np
import torch

from mile_tpu_torch.bayes.posterior import SIGMA_MAX, SIGMA_MIN
from mile_tpu_torch.config.data import Task
from mile_tpu_torch.mcmc.diagnostics import effective_sample_size as _ess

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


# ----------------------------------------------------------- containers
@dataclasses.dataclass
class Metrics:
    """Per-step metric traces, numpy arrays of shape (n_members, n_steps)."""

    step: np.ndarray

    @classmethod
    def empty(cls) -> 'Metrics':
        return cls(**{f.name: np.empty((1, 0))
                      for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class RegressionMetrics(Metrics):
    nlll: np.ndarray
    rmse: np.ndarray


@dataclasses.dataclass
class ClassificationMetrics(Metrics):
    cross_entropy: np.ndarray
    accuracy: np.ndarray


@dataclasses.dataclass
class MetricsStore:
    """train/valid/test metric bundle with pickle persistence."""

    train: Metrics
    valid: Metrics
    test: Metrics

    def save(self, path: str | Path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, 'wb') as f:
            pickle.dump(self, f)


# ------------------------------------------------------------ pointwise
def pointwise_lppd(lvals: torch.Tensor, y: torch.Tensor,
                   task: Task) -> torch.Tensor:
    """Pointwise log predictive density.

    ``lvals``: (n_chains, n_samples, n_obs, 2) regression heads or
    (..., n_obs, n_classes) logits; lower-rank inputs get leading axes
    added. Returns (n_chains, n_samples, n_obs).
    """
    if lvals.dim() == 3:
        lvals = lvals[None]
    elif lvals.dim() == 2:
        lvals = lvals[None, None]
    if task == Task.REGRESSION:
        mu = lvals[..., 0]
        sigma = torch.clamp(torch.exp(lvals[..., 1]), SIGMA_MIN, SIGMA_MAX)
        z = (y - mu) / sigma
        return -0.5 * z * z - torch.log(sigma) - _HALF_LOG_2PI
    if task == Task.CLASSIFICATION:
        log_pmf = torch.log_softmax(lvals, dim=-1)
        idx = y.long().expand(log_pmf.shape[:-1]).unsqueeze(-1)
        return torch.gather(log_pmf, -1, idx)[..., 0]
    raise NotImplementedError(task)


def lppd(lppd_pointwise: torch.Tensor) -> torch.Tensor:
    """Pooled LPPD: mean over observations of logmeanexp over (chain, sample)."""
    lead = lppd_pointwise.shape[:-1]
    flat = lppd_pointwise.reshape(-1, lppd_pointwise.shape[-1])
    return (torch.logsumexp(flat, dim=0) - math.log(math.prod(lead))).mean()


def running_lppd_per_chain(lppd_pointwise: torch.Tensor) -> torch.Tensor:
    """Per-chain running LPPD over the sample axis: (n_chains, n_samples)."""
    p = torch.exp(lppd_pointwise)
    counts = torch.arange(1, p.shape[-2] + 1, device=p.device,
                          dtype=p.dtype)[:, None]
    return torch.log(torch.cumsum(p, dim=-2) / counts).mean(dim=-1)


def running_lppd(lppd_pointwise: torch.Tensor) -> torch.Tensor:
    """Running LPPD over the sample axis: (n_samples,)."""
    return running_lppd_per_chain(lppd_pointwise).mean(dim=0)


def gaussian_nlll(y, mu, sigma):
    sigma = torch.clamp_min(sigma, 1e-5)
    return 0.5 * torch.log(2 * math.pi * sigma ** 2) \
        + (y - mu) ** 2 / (2 * sigma ** 2)


def squared_error(y, mu):
    return (y - mu) ** 2


# ---------------------------------------------------------- cross-chain
def between_chain_var(x: torch.Tensor) -> torch.Tensor:
    """Variance of per-chain means; x: (n_chains, n_samples, ...)."""
    return x.mean(dim=1).var(dim=0, correction=1)


def within_chain_var(x: torch.Tensor) -> torch.Tensor:
    """Mean of per-chain variances; x: (n_chains, n_samples, ...)."""
    return x.var(dim=1, correction=1).mean(dim=0)


def rank_normalize(x: torch.Tensor) -> torch.Tensor:
    """Rank-normalize over the pooled (chain, sample) axes (Vehtari et al.
    2021, fractional offset 3/8): same shape, values ~ N(0, 1) ranks.

    Ties rank in flat (chain-major) order, as ``jnp.argsort``'s stable
    sort ranks them: a coordinate held constant (a frozen partition
    layer) gets the same ranks on the CPU, on the card and in JAX."""
    shape = x.shape
    flat = x.reshape(-1, *shape[2:])
    n = flat.shape[0]
    order = torch.argsort(flat, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0) + 1.0
    return torch.special.ndtri((ranks - 0.375) / (n + 0.25)).reshape(shape)


def effective_sample_size(x: torch.Tensor,
                          rank_normalized: bool = True) -> torch.Tensor:
    """Per-chain ESS: x (n_chains, n_samples, ...) -> (n_chains, ...), each
    chain's ESS computed on its own, after optional rank normalization over
    the pooled draws."""
    if rank_normalized:
        x = rank_normalize(x)
    # one chain per ESS: the chain axis rides along as a parameter axis
    return _ess(x.transpose(0, 1)[None])


def pooled_effective_sample_size(x: torch.Tensor,
                                 rank_normalized: bool = True) -> torch.Tensor:
    """Multi-chain pooled ESS (shape ``x.shape[2:]``)."""
    if rank_normalized:
        x = rank_normalize(x)
    return _ess(x)


def gelman_split_r_hat(samples: torch.Tensor, n_splits: int,
                       rank_normalized: bool = True) -> torch.Tensor:
    """Split-chain R-hat: chains are split into ``n_splits`` segments.
    samples: (n_chains, n_samples, ...) -> R-hat per parameter."""
    c, n = samples.shape[0], samples.shape[1]
    if n % n_splits != 0:
        raise ValueError('n_samples must be divisible by n_splits')
    if rank_normalized:
        samples = rank_normalize(samples)
    m = n // n_splits
    splits = samples.reshape(c * n_splits, m, *samples.shape[2:])
    wcv = within_chain_var(splits)
    bcv = between_chain_var(splits)
    return torch.sqrt(((m - 1.0) / m * wcv + bcv) / wcv)


def split_chain_r_hat(samples: torch.Tensor, n_splits: int,
                      rank_normalized: bool = True) -> torch.Tensor:
    """Per-chain split R-hat: (n_chains, ...)."""
    return torch.stack([
        gelman_split_r_hat(chain[None], n_splits, rank_normalized)
        for chain in samples])
