"""Sampling runtime: warmup, then thinned posterior draws (counterpart of
``mile_tpu/train/sampling.py``: ``run_mclmc`` and the ``run_sampler``
dispatch; NUTS and HMC are in :mod:`mile_tpu_torch.train.sampling_hmc`).

All chains advance together as one ``(C, dim)`` batch. Draws are kept in
a device buffer per chunk and copied to the host while the next chunk
computes (on a CUDA device the copy goes to pinned memory without
blocking, and is waited for only after the next chunk has been enqueued).
Each chunk that has arrived on the host goes to ``sample_sink(chunk,
start)`` when one is given (the native sink writes it to disk on its own
thread).
"""
from __future__ import annotations

import logging
import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mile_tpu_torch.config.training import Sampler, SamplerConfig
from mile_tpu_torch.exceptions import SamplerNotImplementedError
from mile_tpu_torch.mcmc import mclmc
from mile_tpu_torch.mcmc.adaptation.mclmc_tuning import (
    TuningConfig,
    mclmc_tune,
)
from mile_tpu_torch.utils.precision import matmul_precision

logger = logging.getLogger(__name__)

MAX_KEPT_WARMUP = 1000  # cap on stored warmup positions per chain
EPOCH_WISE_MESSAGE = ('epoch_wise (mini-batch) sampling is not supported; '
                      'the posterior is full-batch by design')


class SamplingResult(NamedTuple):
    samples: np.ndarray   # (n_chains, n_kept, dim)
    tuned: dict           # tuned hyperparameters per chain (numpy)
    info: dict            # per-draw statistics (numpy)
    final_state: object
    seconds: dict         # wall time of the 'warmup' and 'sampling' phases


def tuning_config(cfg: SamplerConfig) -> TuningConfig:
    return TuningConfig(
        warmup_steps=cfg.warmup_steps,
        step_size_init=cfg.step_size_init,
        desired_energy_var_start=cfg.desired_energy_var_start,
        desired_energy_var_end=cfg.desired_energy_var_end,
        trust_in_estimate=cfg.trust_in_estimate,
        num_effective_samples=cfg.num_effective_samples,
        diagonal_preconditioning=cfg.diagonal_preconditioning,
        integrator=cfg.integrator,
        trace_every=(max(1, cfg.warmup_steps // MAX_KEPT_WARMUP)
                     if cfg.keep_warmup else 0),
    )


def warmup_mclmc(logdensity_and_grad: Callable, cfg: SamplerConfig,
                 generator: torch.Generator, positions: torch.Tensor):
    """Tune (ε, L, preconditioner) for every chain simultaneously, under
    ``cfg.warmup_matmul_precision`` (default exact float32: the tuner reads
    per-step energies). Returns (states, params, trace or None)."""
    tcfg = tuning_config(cfg)
    with matmul_precision(cfg.warmup_matmul_precision
                          or cfg.matmul_precision):
        out = mclmc_tune(logdensity_and_grad, positions, generator, tcfg)
    states, params, trace = out if tcfg.trace_every else (*out, None)
    eps = params.step_size.cpu().numpy()
    n_bad = int(np.sum(~np.isfinite(eps) | (eps <= 0.0)))
    if n_bad:
        logger.warning(
            'MCLMC tuning collapsed on %d/%d chains (step_size<=0 or '
            'non-finite); their draws will be NaN and excluded from '
            'evaluation', n_bad, len(eps))
    return states, params, trace


class _Egress:
    """A chunk of draws on its way to the host."""

    def __init__(self, tensors: dict):
        if next(iter(tensors.values())).device.type == 'cuda':
            self.host = {k: torch.empty(v.shape, dtype=v.dtype,
                                        pin_memory=True)
                         for k, v in tensors.items()}
            for k, v in tensors.items():
                self.host[k].copy_(v, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = {k: v.clone()
                                     for k, v in tensors.items()}, None

    def result(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return {k: v.numpy() for k, v in self.host.items()}


class Drain:
    """Collects the chunks of draws that have reached the host: positions
    into ``host_chunks``, the per-draw statistics into ``info_chunks``,
    and each chunk of positions to ``sample_sink(chunk, start)``, only
    after its copy has been waited for."""

    def __init__(self, sample_sink: Optional[Callable] = None):
        self.sample_sink = sample_sink
        self.host_chunks, self.info_chunks = [], []
        self.pending: Optional[tuple] = None

    def push(self, tensors: dict, start: int) -> None:
        """Start copying a chunk (``'positions'`` and the per-draw
        statistics, device tensors) to the host; then drain the chunk before
        it, whose copy ran while this one computed."""
        egress = _Egress(tensors)
        self.flush()
        self.pending = (egress, start)

    def flush(self) -> None:
        if self.pending is None:
            return
        egress, start = self.pending
        self.pending = None
        out = egress.result()
        positions = out.pop('positions')
        self.host_chunks.append(positions)
        self.info_chunks.append(out)
        if self.sample_sink is not None:
            self.sample_sink(positions, start)

    def samples(self) -> np.ndarray:
        return np.concatenate(self.host_chunks, axis=1)

    def info(self) -> dict:
        return {k: np.concatenate([c[k] for c in self.info_chunks], axis=1)
                for k in self.info_chunks[0]}


def run_mclmc(logdensity_and_grad: Callable, cfg: SamplerConfig,
              generator: torch.Generator, init_positions: torch.Tensor,
              max_chunk_bytes: int = 1 << 30,
              sample_sink: Optional[Callable] = None) -> SamplingResult:
    """Warmup, then ``n_samples`` kernel steps per chain, keeping every
    ``n_thinning``-th position, with per-draw mean and mean square of ΔE
    over each thin block. The tuner runs under
    ``warmup_matmul_precision``, the draws under ``matmul_precision``.
    Each chunk of draws on the host goes to ``sample_sink(chunk, start)``.

    ``seconds['sampling']`` runs from the end of the tuner (which ends on
    a host read of the tuned ε) to the arrival of the last draws on the
    host, so it times every step, accumulation and copy of the draws.
    """
    n_chains, dim = init_positions.shape
    thin = cfg.n_thinning
    n_kept = math.ceil(cfg.n_samples / thin)
    chunk_kept = max(1, min(n_kept, max_chunk_bytes // (n_chains * dim * 4)))
    n_chunks = math.ceil(n_kept / chunk_kept)

    logger.info('> starting MCLMC warmup (%d chains, %d steps, matmul=%s)...',
                n_chains, cfg.warmup_steps,
                cfg.warmup_matmul_precision or cfg.matmul_precision
                or 'default')
    t0 = time.perf_counter()
    state, params, warmup_trace = warmup_mclmc(
        logdensity_and_grad, cfg, generator, init_positions)
    t1 = time.perf_counter()
    logger.info('> warmup done: step_size=%s L=%s',
                params.step_size.cpu().numpy(), params.L.cpu().numpy())

    kernel = mclmc.build_kernel(logdensity_and_grad, generator,
                                integrator=cfg.integrator)
    if not cfg.use_warmup_as_init:
        # restart at the warmstart weights, keeping the tuned parameters
        state = mclmc.init(init_positions, logdensity_and_grad, generator)

    logger.info('> starting MCLMC sampling: %d kept draws x %d chains '
                '(%d chunks)...', n_kept, n_chains, n_chunks)
    drain = Drain(sample_sink)
    device = init_positions.device
    kept_done = 0
    with matmul_precision(cfg.matmul_precision):
        for _ in range(n_chunks):
            block = min(chunk_kept, n_kept - kept_done)
            positions = torch.empty(n_chains, block, dim, device=device)
            de = torch.empty(n_chains, block, device=device)
            de_sq = torch.empty(n_chains, block, device=device)
            for j in range(block):
                acc = torch.zeros(n_chains, device=device)
                acc_sq = torch.zeros(n_chains, device=device)
                for _ in range(thin):
                    state, _ = kernel(state, params.L, params.step_size,
                                      params.sqrt_diag_cov,
                                      energy_sums=(acc, acc_sq))
                positions[:, j] = state.position
                de[:, j] = acc / thin
                de_sq[:, j] = acc_sq / thin
            drain.push({'positions': positions, 'energy_change': de,
                        'energy_change_sq': de_sq}, kept_done)
            kept_done += block
    drain.flush()
    seconds = {'warmup': t1 - t0, 'sampling': time.perf_counter() - t1}

    samples = drain.samples()
    sqrt_diag_cov = params.sqrt_diag_cov
    if sqrt_diag_cov is None:
        sqrt_diag_cov = torch.ones(n_chains, dim)
    tuned = {k: v.cpu().numpy() for k, v in params._replace(
        sqrt_diag_cov=sqrt_diag_cov)._asdict().items()}
    info = drain.info()
    if warmup_trace is not None:
        info['warmup_trace'] = warmup_trace.cpu().numpy()
    logger.info('> MCLMC sampling completed.')
    return SamplingResult(samples, tuned, info, state, seconds)


def run_sampler(logdensity_and_grad: Callable, cfg: SamplerConfig,
                generator: torch.Generator, init_positions: torch.Tensor,
                **kwargs) -> SamplingResult:
    """Dispatch on the configured sampling algorithm."""
    if cfg.epoch_wise_sampling:
        # reserved in the JAX package too
        raise SamplerNotImplementedError(EPOCH_WISE_MESSAGE)
    if cfg.name == Sampler.MCLMC:
        return run_mclmc(logdensity_and_grad, cfg, generator, init_positions,
                         **kwargs)
    from mile_tpu_torch.train.sampling_hmc import run_hmc_family

    return run_hmc_family(logdensity_and_grad, cfg, generator,
                          init_positions, **kwargs)
