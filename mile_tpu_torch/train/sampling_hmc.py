"""NUTS / HMC sampling runtime: window adaptation, then thinned draws
(counterpart of ``mile_tpu/train/sampling_hmc.py::run_hmc_family``).

All chains advance together as one ``(C, dim)`` batch; draws are buffered
on the device per chunk and copied to the host while the next chunk
computes, as in :func:`mile_tpu_torch.train.sampling.run_mclmc`. Partition
sampling needs no per-chain auxiliary argument here: its density closes
over every chain's frozen base (:mod:`mile_tpu_torch.bayes.partition`), so
the adaptation, the re-init and every step see the subspace. With
``checkpoint_dir`` a stopped run resumes bit for bit, as ``run_mclmc``
does, from the sampling ``Draws`` generator's state as of the last drained
chunk. With a ``mesh`` the batch and its randomness stay on the mesh's
first device and the mesh shards the log-density, as in ``run_mclmc``.
On one CUDA device each NUTS leaf is replayed from a CUDA graph
(:mod:`mile_tpu_torch.mcmc.nuts`); over a mesh of several entries or
processes it runs eagerly.
"""
from __future__ import annotations

import logging
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from mile_tpu_torch.config.training import Sampler, SamplerConfig
from mile_tpu_torch.mcmc import hmc, nuts
from mile_tpu_torch.mcmc.adaptation.window import run_window_adaptation
from mile_tpu_torch.train.resume import restore_generator
from mile_tpu_torch.train.sampling import (
    MAX_KEPT_WARMUP,
    Drain,
    SamplingResult,
    open_checkpoint,
)
from mile_tpu_torch.utils.precision import matmul_precision

logger = logging.getLogger(__name__)

# NUTS draws cost up to 2^max_depth gradients each: at most this many kept
# draws per chunk, so that a chunk's latency stays bounded
MAX_CHUNK_KEPT = 128


def _count(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.to(torch.int32), dim=0, dtype=torch.int32)


# how a per-step info field folds over a thin block of kernel steps: one
# row per KEPT draw, aggregated so nothing is dropped (divergences and
# steps are counted over the whole block, rates are block means); any
# other field keeps its last step
_THIN_AGG = {
    'acceptance_rate': lambda x: torch.mean(x, dim=0),
    'is_divergent': _count,
    'is_accepted': _count,
    'is_turning': _count,
    'num_integration_steps': _count,
    'num_trajectory_expansions': lambda x: torch.mean(
        x.to(torch.float32), dim=0),
}


def aggregate_thin(infos: dict) -> dict:
    """Fold a dict of (thin, C) per-step statistics into (C,) per-draw
    ones."""
    return {k: _THIN_AGG.get(k, lambda x: x[-1])(v)
            for k, v in infos.items()}


def run_hmc_family(logdensity_and_grad: Callable, cfg: SamplerConfig,
                   generator: torch.Generator, init_positions: torch.Tensor,
                   max_chunk_bytes: int = 1 << 30,
                   sample_sink: Optional[Callable] = None,
                   checkpoint_dir=None,
                   checkpoint_format: str = 'npz',
                   mesh=None) -> SamplingResult:
    """Window adaptation, then ``n_samples`` NUTS or HMC steps per chain,
    keeping every ``n_thinning``-th position with its block's aggregated
    statistics; each chunk of draws on the host goes to
    ``sample_sink(chunk, start)``. ``checkpoint_dir``: mid-chain resume,
    as in :func:`~mile_tpu_torch.train.sampling.run_mclmc` (a resumed run's
    ``tuned`` holds only ``step_size`` and ``inverse_mass_matrix``, as the
    JAX runtime's). ``mesh``: as in ``run_mclmc``.

    Metropolis-corrected samplers read O(1) energy differences of
    log-densities of order 10³-10⁴, so the whole runtime runs in exact
    float32 matmuls (TF32 off), whatever ``cfg.matmul_precision`` says,
    as the JAX runtime traces under ``default_matmul_precision('float32')``.
    """
    with matmul_precision('float32'):
        return _run_hmc_family(logdensity_and_grad, cfg, generator,
                               init_positions, max_chunk_bytes, sample_sink,
                               checkpoint_dir, checkpoint_format, mesh)


def _run_hmc_family(logdensity_and_grad, cfg, generator, init_positions,
                    max_chunk_bytes, sample_sink, checkpoint_dir,
                    checkpoint_format, mesh) -> SamplingResult:
    if mesh is not None:
        init_positions = init_positions.to(mesh.first)
    n_chains, dim = init_positions.shape
    device = init_positions.device
    # a mesh of several entries or processes shards the log-density over
    # them (``BayesianModel.logdensity_fn``): its leaves run eagerly
    one_device = mesh is None or (mesh.size == 1 and mesh.group is None)

    def make_kernel(draws, warmup: bool = False):
        if cfg.name == Sampler.NUTS:
            depth = cfg.max_num_doublings
            if warmup and cfg.warmup_max_num_doublings is not None:
                depth = cfg.warmup_max_num_doublings
            return nuts.build_kernel(logdensity_and_grad, max_depth=depth,
                                     draws=draws, graph=one_device)
        return hmc.build_kernel(
            logdensity_and_grad,
            num_integration_steps=cfg.num_integration_steps, draws=draws)

    thin = cfg.n_thinning
    n_kept = math.ceil(cfg.n_samples / thin)
    chunk_kept = max(1, min(n_kept, max_chunk_bytes // (n_chains * dim * 4),
                            MAX_CHUNK_KEPT))
    n_chunks = math.ceil(n_kept / chunk_kept)
    checkpoint, resumed = open_checkpoint(
        checkpoint_dir, checkpoint_format,
        {'sampler': cfg.name.value, 'n_chains': n_chains, 'dim': dim,
         'n_samples': cfg.n_samples, 'n_thinning': thin,
         'chunk_kept': chunk_kept,
         'use_warmup_as_init': cfg.use_warmup_as_init,
         'num_integration_steps': cfg.num_integration_steps}, generator,
        mesh)

    t0 = time.perf_counter()
    if resumed is not None:
        state_leaves, rng, tuned, kept_done = resumed
        state = hmc.HMCState(**{k: torch.from_numpy(v).to(device)
                                for k, v in state_leaves.items()})
        tuned = {k: tuned[k] for k in ('step_size', 'inverse_mass_matrix')}
        step_size, inverse_mass_matrix = (
            torch.from_numpy(v).to(device) for v in tuned.values())
        kernel = make_kernel(hmc.Draws(restore_generator(
            rng['generator_state'], device)))
        warmup_trace = checkpoint.load_warmup_trace()
        t1 = time.perf_counter()
    else:
        # ------------------------------------------------------ warmup
        logger.info('> starting %s window adaptation (%d chains, %d '
                    'steps)...', cfg.name.value, n_chains, cfg.warmup_steps)
        trace_every = (max(1, cfg.warmup_steps // MAX_KEPT_WARMUP)
                       if cfg.keep_warmup else 0)
        warmup_kernel = make_kernel(hmc.device_draws(generator, device),
                                    warmup=True)
        out = run_window_adaptation(
            warmup_kernel, hmc.init(init_positions, logdensity_and_grad),
            warmup_kernel.draws, cfg.warmup_steps,
            initial_step_size=cfg.step_size_init or 1.0,
            target_acceptance_rate=cfg.target_acceptance,
            trace_every=trace_every, logdensity_and_grad=logdensity_and_grad,
            return_stats=True)
        state, step_size, inverse_mass_matrix = out[:3]
        warmup_trace, stats = (out[3] if trace_every else None), out[-1]
        tuned = {'step_size': step_size, 'inverse_mass_matrix':
                 inverse_mass_matrix, **stats}
        tuned = {k: v.cpu().numpy() for k, v in tuned.items()}
        t1 = time.perf_counter()
        logger.info(
            '> adaptation done: step_size=%s\n  bracketed seed eps=%s\n'
            '  terminal-buffer acceptance=%s (target %.2f)',
            tuned['step_size'], tuned['bracketed_step_size'],
            tuned['final_buffer_acceptance'], cfg.target_acceptance)
        kept_done = 0
        if warmup_trace is not None:
            warmup_trace = warmup_trace.cpu().numpy()
            if checkpoint is not None:
                checkpoint.save_warmup_trace(warmup_trace)
        kernel = make_kernel(hmc.device_draws(generator, device))
        if not cfg.use_warmup_as_init:
            # restart at the original weights with the tuned (ε, M⁻¹)
            state = hmc.init(init_positions, logdensity_and_grad)

    # ---------------------------------------------------------- sampling
    draws_generator = kernel.draws.generator
    random_state = lambda: {'generator_state': draws_generator.get_state()}
    drain = Drain(sample_sink, checkpoint, tuned, mesh)
    if resumed is not None:   # the chunks the stopped run drained
        drain.host_chunks, drain.info_chunks = checkpoint.load_chunks(
            kept_done // chunk_kept)
    elif checkpoint is not None:
        drain.snapshot(state, random_state(), 0)
    logger.info('> starting %s sampling: %d kept draws x %d chains...',
                cfg.name.value, n_kept, n_chains)
    for chunk in range(kept_done // chunk_kept, n_chunks):
        block = min(chunk_kept, n_kept - kept_done)
        positions = torch.empty(n_chains, block, dim, device=device)
        rows = []
        for j in range(block):
            steps = []
            for _ in range(thin):
                state, info = kernel(state, step_size, inverse_mass_matrix)
                steps.append(info)
            positions[:, j] = state.position
            rows.append(aggregate_thin(
                {k: torch.stack([getattr(s, k) for s in steps])
                 for k in steps[0]._fields}))
        infos = {k: torch.stack([r[k] for r in rows], dim=1)
                 for k in rows[0]}
        # the generator's state is kept on the host, where each draw
        # advances it as it is enqueued: it needs no copy from the card
        snapshot = None if checkpoint is None else (
            chunk, kept_done + block, state._asdict(), random_state())
        drain.push({'positions': positions, **infos}, kept_done, snapshot)
        kept_done += block
    drain.flush()
    seconds = {'warmup': t1 - t0, 'sampling': time.perf_counter() - t1}
    if checkpoint is not None:
        checkpoint.clear()

    info = drain.info()
    if warmup_trace is not None:
        info['warmup_trace'] = warmup_trace
    logger.info('> %s sampling completed (mean acceptance %.3f, '
                '%d divergent steps).', cfg.name.value,
                float(np.mean(info['acceptance_rate'])),
                int(np.sum(info.get('is_divergent', 0))))
    return SamplingResult(drain.samples(), tuned, info, state, seconds)
