"""Sampling runtime: warmup, then thinned posterior draws (counterpart of
``mile_tpu/train/sampling.py``: ``run_mclmc`` and the ``run_sampler``
dispatch; NUTS and HMC are in :mod:`mile_tpu_torch.train.sampling_hmc`).

All chains advance together as one ``(C, dim)`` batch. Draws are kept in
a device buffer per chunk and copied to the host while the next chunk
computes (on a CUDA device the copy goes to pinned memory without
blocking, and is waited for only after the next chunk has been enqueued).
Each chunk that has arrived on the host goes to ``sample_sink(chunk,
start)`` when one is given (the native sink writes it to disk on its own
thread). With ``checkpoint_dir`` each drained chunk is also a checkpoint
(:mod:`mile_tpu_torch.train.resume`), copied with the state as of its
end.

With a ``mesh`` (:mod:`mile_tpu_torch.parallel.mesh`) the chain batch,
the tuner, the kernels and all randomness stay on the mesh's first
device; the mesh shards the log-density it was built into
(``BayesianModel.logdensity_and_grad_fn(x, y, mesh)``). Across processes
every rank runs this loop on the same state: rank 0 writes the
checkpoint, and at each drained chunk the ranks compare their draws.
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
    MCLMCTuningParams,
    TuningConfig,
    mclmc_tune,
)
from mile_tpu_torch.train.resume import SamplerCheckpoint, generator_digest
from mile_tpu_torch.utils.precision import matmul_precision, resolve

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
    per-step energies), or ``cfg.matmul_precision`` where that is None; a
    None for both is the process's :func:`~mile_tpu_torch.utils.precision.
    none_precision`, as a scope-less tuner on the TPU. Returns (states,
    params, trace or None)."""
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
    """Tensors on their way to the host: each CUDA tensor is copied to
    pinned memory without blocking, each CPU tensor cloned."""

    def __init__(self, tensors: dict):
        self.host, self.event = {}, None
        for k, v in tensors.items():
            if v.device.type == 'cuda':
                self.host[k] = torch.empty(v.shape, dtype=v.dtype,
                                           pin_memory=True)
                self.host[k].copy_(v, non_blocking=True)
            else:
                self.host[k] = v.clone()
        if any(v.device.type == 'cuda' for v in tensors.values()):
            self.event = torch.cuda.Event()
            self.event.record()

    def result(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return {k: v.numpy() for k, v in self.host.items()}


class Drain:
    """Collects the chunks of draws that have reached the host: positions
    into ``host_chunks``, the per-draw statistics into ``info_chunks``,
    and each chunk of positions to ``sample_sink(chunk, start)``, only
    after its copy has been waited for.

    With a ``checkpoint`` (a :class:`~mile_tpu_torch.train.resume.
    SamplerCheckpoint`), each drained chunk is persisted first, then the
    snapshot that points past it (with ``tuned``), and only then is the
    sink called: a run stopped in between resumes from the snapshot before
    and writes the chunk again.

    With a ``mesh`` whose chains axis spans processes, the ranks first
    check that their chunks are equal (:func:`~mile_tpu_torch.parallel.
    distributed.check_in_step`)."""

    def __init__(self, sample_sink: Optional[Callable] = None,
                 checkpoint=None, tuned: Optional[dict] = None, mesh=None):
        self.sample_sink = sample_sink
        self.checkpoint, self.tuned = checkpoint, tuned
        self.group = None if mesh is None else mesh.group
        self.host_chunks, self.info_chunks = [], []
        self.pending: Optional[tuple] = None

    def push(self, tensors: dict, start: int,
             snapshot: Optional[tuple] = None) -> None:
        """Start copying a chunk (``'positions'`` and the per-draw
        statistics, device tensors) to the host; then drain the chunk before
        it, whose copy ran while this one computed.

        ``snapshot`` = (chunk index, kept draws done after it, state
        tensors, random-state tensors): the sampler as of the end of this
        chunk. Its tensors are copied with the chunk, in stream order, so
        that later steps, which go on while the copy waits, do not change
        it."""
        egress = _Egress(tensors)
        if snapshot is not None:
            chunk, done, state, rng = snapshot
            snapshot = (chunk, done, _Egress(state), _Egress(rng))
        self.flush()
        self.pending = (egress, start, snapshot)

    def flush(self) -> None:
        if self.pending is None:
            return
        egress, start, snapshot = self.pending
        self.pending = None
        out = egress.result()
        positions = out.pop('positions')
        if self.group is not None:
            from mile_tpu_torch.parallel.distributed import check_in_step

            check_in_step(positions, self.group)
        self.host_chunks.append(positions)
        self.info_chunks.append(out)
        if snapshot is not None:
            chunk, done, state, rng = snapshot
            self.checkpoint.save_chunk(chunk, positions, out)
            self.checkpoint.save(state.result(), rng.result(), self.tuned,
                                 done)
        if self.sample_sink is not None:
            self.sample_sink(positions, start)

    def snapshot(self, state: NamedTuple, rng: dict, kept_done: int) -> None:
        """Persist the sampler's state now (it waits for the device): the
        post-warmup snapshot, from which a run stopped inside chunk 0
        resumes without the warmup."""
        host = lambda d: {k: v.cpu().numpy() for k, v in d.items()}
        self.checkpoint.save(host(state._asdict()), host(rng), self.tuned,
                             kept_done)

    def samples(self) -> np.ndarray:
        return np.concatenate(self.host_chunks, axis=1)

    def info(self) -> dict:
        return {k: np.concatenate([c[k] for c in self.info_chunks], axis=1)
                for k in self.info_chunks[0]}


def open_checkpoint(checkpoint_dir, checkpoint_format: str,
                    fingerprint: dict, generator: torch.Generator,
                    mesh=None):
    """The checkpoint under ``checkpoint_dir`` (None without one) and what
    it resumes from (None: a fresh run). ``fingerprint`` gets the digest of
    ``generator``'s state at entry, where the JAX runtimes put their run
    key. Only the primary rank of ``mesh`` writes it."""
    if checkpoint_dir is None:
        return None, None
    checkpoint = SamplerCheckpoint(
        checkpoint_dir, {**fingerprint, 'rng': generator_digest(generator)},
        fmt=checkpoint_format, writer=mesh is None or mesh.is_primary)
    return checkpoint, checkpoint.load()


def run_mclmc(logdensity_and_grad: Callable, cfg: SamplerConfig,
              generator: torch.Generator, init_positions: torch.Tensor,
              max_chunk_bytes: int = 1 << 30,
              sample_sink: Optional[Callable] = None,
              checkpoint_dir=None,
              checkpoint_format: str = 'npz',
              mesh=None) -> SamplingResult:
    """Warmup, then ``n_samples`` kernel steps per chain, keeping every
    ``n_thinning``-th position, with per-draw mean and mean square of ΔE
    over each thin block. The tuner runs under
    ``warmup_matmul_precision``, the draws under ``matmul_precision``.
    Each chunk of draws on the host goes to ``sample_sink(chunk, start)``.

    ``checkpoint_dir`` enables mid-chain resume: the state is persisted at
    each drained chunk, and a call with the same arguments (a generator in
    the same state included) continues where a stopped one ended: it skips
    the tuner, builds the kernel with the saved seed and counter step, and
    gives the uninterrupted run's draws bit for bit. The sink then receives
    only the chunks not yet drained. The directory is removed on success.

    ``mesh``: the mesh ``logdensity_and_grad`` is sharded over; the
    positions go to its first device, and across processes the ranks
    check each chunk against each other and only rank 0 writes the
    checkpoint.

    ``seconds['sampling']`` runs from the end of the tuner (which ends on
    a host read of the tuned ε) to the arrival of the last draws on the
    host, so it times every step, accumulation and copy of the draws.
    """
    if mesh is not None:
        init_positions = init_positions.to(mesh.first)
    n_chains, dim = init_positions.shape
    device = init_positions.device
    thin = cfg.n_thinning
    n_kept = math.ceil(cfg.n_samples / thin)
    chunk_kept = max(1, min(n_kept, max_chunk_bytes // (n_chains * dim * 4)))
    n_chunks = math.ceil(n_kept / chunk_kept)
    checkpoint, resumed = open_checkpoint(
        checkpoint_dir, checkpoint_format,
        {'n_chains': n_chains, 'dim': dim, 'n_samples': cfg.n_samples,
         'n_thinning': thin, 'chunk_kept': chunk_kept,
         'use_warmup_as_init': cfg.use_warmup_as_init}, generator, mesh)

    t0 = time.perf_counter()
    if resumed is not None:
        state_leaves, rng, tuned_arrays, kept_done = resumed
        to_device = lambda a: torch.from_numpy(a).to(device)
        state = mclmc.MCLMCState(**{k: to_device(v)
                                    for k, v in state_leaves.items()})
        params = MCLMCTuningParams(
            L=to_device(tuned_arrays['L']),
            step_size=to_device(tuned_arrays['step_size']),
            # ones are saved where no preconditioner was tuned
            sqrt_diag_cov=(to_device(tuned_arrays['sqrt_diag_cov'])
                           if cfg.diagonal_preconditioning else None))
        kernel = mclmc.build_kernel(logdensity_and_grad, None,
                                    integrator=cfg.integrator,
                                    seed=int(rng['seed']),
                                    step=int(rng['step']))
        warmup_trace = checkpoint.load_warmup_trace()
        t1 = time.perf_counter()
    else:
        logger.info('> starting MCLMC warmup (%d chains, %d steps, '
                    'matmul=%s)...', n_chains, cfg.warmup_steps,
                    resolve(cfg.warmup_matmul_precision
                            or cfg.matmul_precision))
        state, params, warmup_trace = warmup_mclmc(
            logdensity_and_grad, cfg, generator, init_positions)
        t1 = time.perf_counter()
        logger.info('> warmup done: step_size=%s L=%s',
                    params.step_size.cpu().numpy(), params.L.cpu().numpy())
        kept_done = 0
        if warmup_trace is not None:
            warmup_trace = warmup_trace.cpu().numpy()
            if checkpoint is not None:
                checkpoint.save_warmup_trace(warmup_trace)
        kernel = mclmc.build_kernel(logdensity_and_grad, generator,
                                    integrator=cfg.integrator)
        if not cfg.use_warmup_as_init:
            # restart at the warmstart weights, keeping the tuned parameters
            state = mclmc.init(init_positions, logdensity_and_grad, generator)

    sqrt_diag_cov = params.sqrt_diag_cov
    if sqrt_diag_cov is None:
        sqrt_diag_cov = torch.ones(n_chains, dim)
    tuned = {k: v.cpu().numpy() for k, v in params._replace(
        sqrt_diag_cov=sqrt_diag_cov)._asdict().items()}
    drain = Drain(sample_sink, checkpoint, tuned, mesh)
    if resumed is not None:   # the chunks the stopped run drained
        drain.host_chunks, drain.info_chunks = checkpoint.load_chunks(
            kept_done // chunk_kept)
    elif checkpoint is not None:
        drain.snapshot(state, kernel.random_state(), 0)

    logger.info('> starting MCLMC sampling: %d kept draws x %d chains '
                '(%d chunks)...', n_kept, n_chains, n_chunks)
    with matmul_precision(cfg.matmul_precision):
        for chunk in range(kept_done // chunk_kept, n_chunks):
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
            snapshot = None if checkpoint is None else (
                chunk, kept_done + block, state._asdict(),
                kernel.random_state())
            drain.push({'positions': positions, 'energy_change': de,
                        'energy_change_sq': de_sq}, kept_done, snapshot)
            kept_done += block
    drain.flush()
    seconds = {'warmup': t1 - t0, 'sampling': time.perf_counter() - t1}
    if checkpoint is not None:
        checkpoint.clear()   # the run is complete: its draws are returned

    info = drain.info()
    if warmup_trace is not None:
        info['warmup_trace'] = warmup_trace
    logger.info('> MCLMC sampling completed.')
    return SamplingResult(drain.samples(), tuned, info, state, seconds)


def run_sampler(logdensity_and_grad: Callable, cfg: SamplerConfig,
                generator: torch.Generator, init_positions: torch.Tensor,
                **kwargs) -> SamplingResult:
    """Dispatch on the configured sampling algorithm (``kwargs``, the
    ``mesh`` among them, go to the runtime)."""
    if cfg.epoch_wise_sampling:
        # reserved in the JAX package too
        raise SamplerNotImplementedError(EPOCH_WISE_MESSAGE)
    if cfg.name == Sampler.MCLMC:
        return run_mclmc(logdensity_and_grad, cfg, generator, init_positions,
                         **kwargs)
    from mile_tpu_torch.train.sampling_hmc import run_hmc_family

    return run_hmc_family(logdensity_and_grad, cfg, generator,
                          init_positions, **kwargs)
