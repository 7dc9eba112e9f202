"""Unnormalized log-posterior over flat, chain-batched parameters
(counterpart of ``mile_tpu/bayes/posterior.py``).

The sampler-facing density maps ``theta (C, dim) -> (C,)``: the chain axis
is written out instead of vmapped. Its value and gradient come from one
autograd pass over the sum of the per-chain log-densities; the chains are
independent, so the gradient of the sum is each chain's own gradient.
"""
from __future__ import annotations

import logging
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mile_tpu_torch.bayes.priors import Prior
from mile_tpu_torch.config.data import Task

logger = logging.getLogger(__name__)

# Predictive log-sigma is exp-clipped to this range everywhere.
SIGMA_MIN, SIGMA_MAX = 1e-6, 1e6
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def gaussian_loglik(lvals: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum over observations of Normal(y | mean, exp(log_sigma)) log-pdfs.

    ``lvals[..., 0]`` is the mean head, ``lvals[..., 1]`` the log-σ head;
    ``lvals`` is ``(..., N, 2)``, ``y`` ``(N,)``, the result ``(...)``.
    NaN observations contribute zero (``nansum`` semantics).
    """
    mu = lvals[..., 0]
    sigma = torch.clamp(torch.exp(lvals[..., 1]), SIGMA_MIN, SIGMA_MAX)
    z = (y - mu) / sigma
    logpdf = -0.5 * z * z - torch.log(sigma) - _HALF_LOG_2PI
    return torch.nansum(logpdf, dim=-1)


def categorical_loglik(lvals: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum over observations of Categorical(y | logits) log-pmfs."""
    log_pmf = F.log_softmax(lvals, dim=-1)
    idx = y.long().expand(log_pmf.shape[:-1]).unsqueeze(-1)
    return torch.nansum(torch.gather(log_pmf, -1, idx)[..., 0], dim=-1)


def value_and_grad(fn: Callable[[torch.Tensor], torch.Tensor]):
    """``fn: (C, dim) -> (C,)`` -> ``theta -> (fn(theta), d fn / d theta)``,
    with one backward pass over the sum of the chains' values."""

    def vg(theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with torch.enable_grad():
            t = theta.detach().requires_grad_(True)
            value = fn(t)
            (grad,) = torch.autograd.grad(value.sum(), t)
        return value.detach(), grad

    return vg


class BayesianModel:
    """Wraps a flat-parameter network into an unnormalized posterior."""

    def __init__(self, model, prior: Prior, task: Task, n_batches: int = 1,
                 likelihood_chunk_size: int | None = None,
                 compute_dtype: torch.dtype | str | None = None):
        """``likelihood_chunk_size``: evaluate the log-likelihood over
        chunks of this many observations, each recomputed in the backward
        pass (``torch.utils.checkpoint``), to bound activation memory.

        ``compute_dtype`` (e.g. ``'bfloat16'``): run the network forward
        in this dtype while the log-likelihood reduction, the prior and the
        sampler's energy accounting stay in the parameters' dtype (float32
        in the sampler)."""
        self.model = model
        self.prior = prior
        self.task = task
        self.n_batches = n_batches
        self.likelihood_chunk_size = likelihood_chunk_size
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        self.compute_dtype = compute_dtype
        self.dim = model.dim
        logger.info('BayesianModel: task=%s dim=%d prior=%s', task,
                    self.dim, prior.name)

    def log_prior(self, theta: torch.Tensor) -> torch.Tensor:
        return self.prior.log_prior(theta)

    def _loglik_term(self, lvals, y) -> torch.Tensor:
        if self.task == Task.REGRESSION:
            return gaussian_loglik(lvals, y)
        if self.task == Task.CLASSIFICATION:
            return categorical_loglik(lvals, y)
        raise NotImplementedError(f'likelihood for {self.task} not implemented')

    def apply(self, theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Network forward in ``compute_dtype`` (if set), outputs in the
        dtype of ``theta``."""
        dtype = theta.dtype
        if self.compute_dtype is not None:
            theta = theta.to(self.compute_dtype)
            if x.is_floating_point():
                x = x.to(self.compute_dtype)
        return self.model(theta, x).to(dtype)

    def _chunk_loglik(self, theta, x, y) -> torch.Tensor:
        return self._loglik_term(self.apply(theta, x), y)

    def log_likelihood(self, theta: torch.Tensor, x, y) -> torch.Tensor:
        """Chunks run along the observation axis, whatever follows it
        (``(N, F)`` rows, ``(N, C, H, W)`` images or ``(N, T)`` token
        ids): full chunks are recomputed in the backward pass, the
        remainder is not."""
        chunk = self.likelihood_chunk_size
        if not chunk or x.shape[0] <= chunk:
            return self._chunk_loglik(theta, x, y)
        n = x.shape[0]
        n_full = (n // chunk) * chunk
        total = sum(checkpoint(self._chunk_loglik, theta, x[i:i + chunk],
                               y[i:i + chunk], use_reentrant=False)
                    for i in range(0, n_full, chunk))
        if n_full < n:  # remainder chunk, not recomputed (as the reference)
            total = total + self._chunk_loglik(theta, x[n_full:], y[n_full:])
        return total

    def log_posterior(self, theta: torch.Tensor, x, y) -> torch.Tensor:
        return (self.log_prior(theta)
                + self.n_batches * self.log_likelihood(theta, x, y))

    def logdensity_fn(self, x, y, mesh=None
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Close over the (device-resident) training data -> ``(C,)``
        density, differentiable in ``theta``. With a ``mesh`` (a
        :class:`~mile_tpu_torch.parallel.mesh.ChainMesh` of more than one
        entry) its value and gradient are computed shard by shard over the
        mesh (:class:`~mile_tpu_torch.bayes.sharded.ShardedLogDensity`); a
        one-entry mesh of one process is no mesh."""
        if mesh is not None and (mesh.size > 1 or mesh.group is not None):
            from mile_tpu_torch.bayes.sharded import ShardedLogDensity

            return ShardedLogDensity(self, x, y, mesh)
        return lambda theta: self.log_posterior(theta, x, y)

    def logdensity_and_grad_fn(self, x, y, mesh=None):
        """The sampler's hot function: ``theta (C, dim) -> ((C,), (C, dim))``
        (over ``mesh``, as :meth:`logdensity_fn`)."""
        return value_and_grad(self.logdensity_fn(x, y, mesh))

    def shard_potential_fn(self, x_shards, y_shards) -> Callable:
        """``U_j(theta)`` for :mod:`mile_tpu_torch.mcmc.split_hmc`:
        ``-(loglik(shard j) + log_prior / M)`` over the device-resident
        shards ``x_shards`` (M, B, ...) and ``y_shards`` (M, B), for a
        ``(C, dim)`` batch -> ``(C,)`` or one chain ``(dim,)`` -> a scalar.
        ``Σ_j U_j`` is the negative log-posterior of the sharded data (the
        prior is spread 1/M per shard); it is differentiable in ``theta``
        (the likelihood is chunked as :meth:`log_likelihood` chunks it)."""
        n_shards = x_shards.shape[0]

        def shard_potential(theta: torch.Tensor, j: int) -> torch.Tensor:
            if theta.dim() == 1:
                return shard_potential(theta[None], j)[0]
            return -(self.log_likelihood(theta, x_shards[j], y_shards[j])
                     + self.log_prior(theta) / n_shards)

        return shard_potential
