"""Experiment orchestrator: warmstart -> sampling -> evaluation -> report
(counterpart of ``mile_tpu/train/trainer.py::BDETrainer``, with MCLMC,
NUTS or HMC).

The trainer builds a device mesh (:mod:`mile_tpu_torch.parallel.mesh`) as
the JAX trainer does: the largest device count that divides the chains,
or chains x data with ``data_sharding > 1``. Sampling pads a chain count
that does not divide over the devices with wrap-around duplicates of real
chains (13 chains over 8 devices run as 16) and drops the pad chains from
every result and from the sink; partition and frozen sampling do not pad.
The mesh shards the log-posterior's value and gradient, and the warm
start's forward and backward passes by rows of members (over the divisor
mesh: the warm start pads nothing); the chain batch, the kernels, the
optimizer and the randomness stay on its first device. In a multi-process
run (:mod:`mile_tpu_torch.parallel.distributed`) the chains axis spans the
ranks: rank 0 makes the experiment directory, every rank runs the warm
start's loop on the gathered gradients (rank 0 loads a reused one and
broadcasts it), and rank 0 does every write.

Draws stream to disk while sampling runs, through the native sink
(``samples/chain_{c}/samples.bin``); where it cannot be built the trainer
writes ``samples.npy`` at the end instead, as the JAX trainer does. With
``stream_samples`` each draw is also written as
``samples/{c}/sample_{n}.npz`` (the JAX package's per-draw layout) and
``samples.npy`` at the end; with ``checkpoint_sampling`` the sampler
checkpoints into ``sampler_ckpt/`` and the draws are saved at the end (an
appending sink would write rows twice across a resume). A
``warmstart_exp_dir`` reuses another run's ``warmstart/params_*.npz``, or
its ``warmstart/orbax/`` when there is one. Partition and frozen sampling
run in the subspace of the sampled coordinates, with each chain's
warm-start member as its frozen base, and save their draws merged back to
full dimension at the end. ``checkpoint_format: orbax`` also writes the
ensemble as a ``torch.distributed.checkpoint`` in ``warmstart/orbax/``
and routes the sampler's resume snapshot through it.
"""
from __future__ import annotations

import logging
import pickle
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from mile_tpu_torch.bayes import BayesianModel
from mile_tpu_torch.bayes import partition as part
from mile_tpu_torch.bayes.posterior import value_and_grad
from mile_tpu_torch.config import Config, Sampler, Task
from mile_tpu_torch.data import build_loader
from mile_tpu_torch.exceptions import SamplerNotImplementedError
from mile_tpu_torch.inference.evaluation import evaluate_bde, evaluate_de
from mile_tpu_torch.native import NativeSampleSink, native_available
from mile_tpu_torch.parallel import distributed
from mile_tpu_torch.parallel.mesh import (
    chain_data_mesh,
    chain_mesh,
    local_devices,
    padded_chain_count,
    pick_chain_device_count,
)
from mile_tpu_torch.train import checkpoint as ckpt
from mile_tpu_torch.train.sampling import (
    EPOCH_WISE_MESSAGE,
    SamplingResult,
    run_sampler,
)
from mile_tpu_torch.train.warmstart import train_ensemble
from mile_tpu_torch.utils.device import resolve_device
from mile_tpu_torch.utils.keys import experiment_keys
from mile_tpu_torch.utils.timing import measure_time

logger = logging.getLogger(__name__)

NOMINAL_COVERAGES = [0.5, 0.75, 0.9, 0.95]


def check_supported(config: Config) -> None:
    """Raise for epoch-wise sampling, which the JAX package lacks too, and
    for ``stream_samples`` with partition or frozen sampling, with which
    the JAX trainer fails."""
    scfg = config.training.sampler
    if scfg.epoch_wise_sampling:
        raise SamplerNotImplementedError(EPOCH_WISE_MESSAGE)
    if scfg.stream_samples and (scfg.partition_sampling
                                or scfg.params_frozen):
        # the JAX trainer streams the subspace-wide draws of partition
        # sampling through the full layout's unravel, which fails after
        # the first chunk
        raise ValueError(
            'training.sampler.stream_samples cannot be combined with '
            'training.sampler.partition_sampling or params_frozen: the '
            'per-draw files hold full parameter trees, and partition '
            'sampling draws a subspace; turn one of them off')


def slice_chains(result: SamplingResult, n: int) -> SamplingResult:
    """Drop the pad chains (those past the first ``n``) from every array
    of ``result`` whose leading axis is the chain axis (the runtimes put
    the chains first everywhere; other arrays pass unchanged)."""
    n_run = result.samples.shape[0]

    def cut(x):
        if getattr(x, 'ndim', 0) >= 1 and x.shape[0] == n_run:
            return x[:n]
        return x

    state = result.final_state
    return result._replace(
        samples=result.samples[:n],
        tuned={k: cut(v) for k, v in result.tuned.items()},
        info={k: cut(v) for k, v in result.info.items()},
        final_state=type(state)(*(cut(v) for v in state)))


class BDETrainer:
    """Bayesian-deep-ensemble training pipeline for one experiment config.

    Runs on ``device`` (the GPU by default; without one it raises unless
    ``device='cpu'`` is asked for), over ``n_devices`` devices of its type
    (default: every visible CUDA device; one CPU entry), or over the
    explicit entries ``devices``, which may repeat (``['cpu'] * 8``).
    """

    def __init__(self, config: Config, device: str | torch.device = 'cuda',
                 n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None):
        check_supported(config)
        if config.model.model == 'EmbeddingClassifier':
            # the JAX trainer fails here too: module.init(key, x[:1]) gives
            # the model one argument where it takes two
            raise ValueError(
                'EmbeddingClassifier takes (x, attn_mask): precomputed '
                'embeddings and their attention mask, which no loader '
                'gives; the trainer feeds a model its features alone. Use '
                'AttentionClassifier or PretrainedAttentionClassifier on '
                'text data')
        if devices is None:
            devices = local_devices(resolve_device(device), n_devices)
        devices = [torch.device(d) for d in devices]
        self.device = resolve_device(devices[0])
        self.group = distributed.process_group()
        self.primary = distributed.is_primary_host()
        self.config = config
        if self.group is None:
            self.exp_dir: Path = config.setup_dir()
        else:   # one directory, made by rank 0
            self.exp_dir = Path(distributed.broadcast_object(
                str(config.setup_dir()) if self.primary else None,
                self.group))
        sampler_cfg = config.training.sampler
        self.n_chains = sampler_cfg.n_chains
        self.sink: NativeSampleSink | None = None  # of the last sampling
        self._build_meshes(devices, sampler_cfg)

        keys = experiment_keys(config.rng)
        self._gen_init, self._gen_train, self._gen_sample = (
            keys.init, keys.train, keys.sample)
        self.loader = build_loader(config.data, keys.loader, self.device,
                                   target_len=config.data.target_len,
                                   tokenizer_config=config.training.tokenizer)
        self.model = config.get_model(self.loader.input_shape)
        if config.data.task == Task.CLASSIFICATION:
            # out-of-range labels would give NaN log-likelihoods
            n_classes = int(self.loader.numpy_arrays('train')[1].max()) + 1
            if n_classes > self.model.out_features:
                raise ValueError(
                    f'model outputs {self.model.out_features} classes but '
                    f'the training labels span {n_classes}; fix the model '
                    f'out_dim / hidden_structure')
        self.bayes = BayesianModel(
            self.model, sampler_cfg.prior_config.build(), config.data.task,
            likelihood_chunk_size=sampler_cfg.likelihood_chunk_size,
            compute_dtype=sampler_cfg.compute_dtype)
        logger.info('model dim=%d on %s', self.bayes.dim, self.device)

    def _build_meshes(self, devices: list, scfg) -> None:
        """``self.mesh`` (the largest device count that divides the chains,
        or chains x data) and the sampling mesh with its pad chains, as the
        JAX trainer counts them over every process's devices."""
        n_procs = 1 if self.group is None else \
            torch.distributed.get_world_size(self.group)
        avail = n_procs * len(devices)
        n_dev = pick_chain_device_count(self.n_chains, avail)
        n_data = scfg.data_sharding
        if n_data > 1:
            n_data = min(n_data, max(1, avail // n_dev))
            self.mesh = chain_data_mesh(n_dev, n_data, devices, self.group)
        else:
            self.mesh = chain_mesh(n_dev, devices, self.group)
        logger.info('mesh %s for %d chains', self.mesh, self.n_chains)
        self._pad_chains = 0
        self._sampling_mesh = self.mesh
        if n_data <= 1:
            n_run = padded_chain_count(self.n_chains, avail)
            if n_run > self.n_chains:
                self._pad_chains = n_run - self.n_chains
                self._sampling_mesh = chain_mesh(min(avail, n_run), devices,
                                                 self.group)
                if not (scfg.partition_sampling or scfg.params_frozen):
                    logger.info(
                        'sampling will pad %d chains to %d over %d devices '
                        '(pad chains dropped from results)', self.n_chains,
                        n_run, self._sampling_mesh.size)

    @property
    def warmstart_dir(self) -> Path:
        return self.exp_dir / 'warmstart'

    @property
    def samples_dir(self) -> Path:
        return self.exp_dir / 'samples'

    # ------------------------------------------------------------ phases
    def train_warmstart(self) -> torch.Tensor:
        """Deep-ensemble pre-training, or the reuse of another run's
        members (``warmstart_exp_dir``: its ``warmstart/orbax/`` when there
        is one, else the first ``n_chains`` of its
        ``warmstart/params_*.npz`` in id order): flat members (n_chains,
        dim) on the first device, saved again into this run's
        ``warmstart/`` (and ``warmstart/orbax/`` with ``checkpoint_format:
        orbax``). Trained members come from every rank's loop over the
        mesh; reused or fresh ones from rank 0. Rank 0's are broadcast to
        the other ranks."""
        cfg = self.config.training.warmstart
        with measure_time('time.warmstart'):
            src = (Path(cfg.warmstart_exp_dir) / 'warmstart'
                   if cfg.warmstart_exp_dir else None)
            params = None
            if src is not None and (src / 'orbax').exists():
                params = self._load_orbax(src / 'orbax')   # every rank
            elif self.primary or (src is None and cfg.include):
                params = self._warmstart(cfg, src)
            if self.group is not None:
                params = distributed.broadcast_tensor(
                    params, (self.n_chains, self.bayes.dim), torch.float32,
                    self.device, self.group)
        if self.primary:
            host = params.cpu().numpy()
            for i in range(self.n_chains):
                ckpt.save_params(self.warmstart_dir, host[i],
                                 self.model.layout, i)
        if self.config.training.checkpoint_format == 'orbax':
            from mile_tpu_torch.train.checkpoint_orbax import save_ensemble

            save_ensemble(self.warmstart_dir / 'orbax', {'members': params})
        return params

    def _warmstart(self, cfg, src: Optional[Path]) -> torch.Tensor:
        if src is not None:
            ids = ckpt.list_checkpoints(src)
            if len(ids) < self.n_chains:
                raise ValueError(
                    f'warmstart dir {src} has {len(ids)} checkpoints,'
                    f' need {self.n_chains}')
            logger.info('reusing warmstart checkpoints from %s', src)
            return self._members(ckpt.load_params_batch(
                src, ids[: self.n_chains]), src)
        if cfg.include:
            params, store = train_ensemble(
                self.model, self.loader, cfg, self.config.data.task,
                self.n_chains, self._gen_train, mesh=self.mesh)
            if not self.primary:
                return params
            store.save(self.warmstart_dir / 'metrics.pkl')
            try:
                from mile_tpu_torch.viz import plot_warmstart_results

                plot_warmstart_results(store).savefig(
                    self.warmstart_dir / 'warmstart_curves.png')
            except Exception:
                logger.exception('warmstart plot failed')
            return params
        logger.info('warmstart disabled; sampling from fresh inits')
        return self.model.init(self.n_chains, self._gen_train).to(self.device)

    def _load_orbax(self, path: Path) -> torch.Tensor:
        """The members of a ``warmstart/orbax/`` this package wrote (one
        the JAX package wrote raises a ``ValueError`` naming it)."""
        from mile_tpu_torch.train.checkpoint_orbax import load_ensemble

        logger.info('reusing orbax-format warmstart ensemble from %s', path)
        members = load_ensemble(path).get('members')
        if members is None:
            raise ValueError(f'{path} holds no ensemble members')
        if members.shape[0] < self.n_chains:
            raise ValueError(f'orbax ensemble at {path} has '
                             f'{members.shape[0]} members, need '
                             f'{self.n_chains}')
        return self._members(members[: self.n_chains], path)

    def _members(self, params, src) -> torch.Tensor:
        if params.shape[1] != self.bayes.dim:
            raise ValueError(
                f'warmstart dir {src} holds members of {params.shape[1]} '
                f'parameters; the model has {self.bayes.dim}')
        return torch.as_tensor(params).to(self.device)

    def sampled_mask(self) -> np.ndarray | None:
        """The coordinates partition or frozen sampling samples (True),
        None when every coordinate is sampled: ``params_frozen`` freezes
        the groups it names, ``partition_sampling`` samples the first and
        last layer groups."""
        scfg = self.config.training.sampler
        if scfg.params_frozen:
            return part.frozen_mask(self.model.layout, scfg.params_frozen)
        if scfg.partition_sampling:
            return part.partition_mask(self.model.layout)
        return None

    def _sink(self, scfg, mask):
        """The sink of the draws (on rank 0 only): per draw with
        ``stream_samples``, else the native sink (kept as ``self.sink``)
        where it can be built, for full-space runs without
        ``checkpoint_sampling``."""
        self.sink = None
        if not self.primary:
            return None
        if scfg.stream_samples:
            def sink(chunk, start):
                for c in range(chunk.shape[0]):
                    for j in range(chunk.shape[1]):
                        ckpt.save_samples_streaming(
                            self.samples_dir, c, start + j, chunk[c, j],
                            self.model.layout)
            return sink
        if (mask is None and not scfg.checkpoint_sampling
                and native_available()):
            self.sink = NativeSampleSink(self.samples_dir, self.n_chains,
                                         self.bayes.dim)
        return self.sink

    def start_sampling(self, member_params: torch.Tensor) -> SamplingResult:
        """Run the configured sampler from the ensemble members' weights
        over the mesh, persisting the draws chunk by chunk through the
        native sink (kept as ``self.sink``), or per draw with
        ``stream_samples``. A full-space run pads the chains to the
        sampling mesh and drops the pad chains from the sink and the
        result. Partition and frozen sampling run in the subspace, without
        a sink or padding, and save the draws merged back to full
        dimension at the end; with ``checkpoint_sampling`` the full-space
        run checkpoints into ``sampler_ckpt/`` in ``checkpoint_format``
        (the JAX trainer ignores the option in the subspace, and so does
        the port)."""
        scfg = self.config.training.sampler
        x, y = self.loader.arrays('train')
        mask = self.sampled_mask()
        sink = self._sink(scfg, mask)
        with measure_time('time.sampling'):
            if mask is not None:
                logger.info('partition sampling: %d of %d coords sampled',
                            int(mask.sum()), self.bayes.dim)
                vg = value_and_grad(part.make_partitioned_logdensity(
                    self.bayes.logdensity_fn(x, y, self.mesh), mask,
                    member_params))
                result = run_sampler(vg, scfg, self._gen_sample,
                                     part.split(member_params, mask),
                                     mesh=self.mesh)
                result = result._replace(samples=part.merge(
                    member_params.cpu().numpy(), result.samples, mask))
            else:
                extra = ({'checkpoint_dir': self.exp_dir / 'sampler_ckpt',
                          'checkpoint_format':
                              self.config.training.checkpoint_format}
                         if scfg.checkpoint_sampling else {})
                pad, mesh = self._pad_chains, self._sampling_mesh
                positions = member_params
                if pad:
                    # wrap-around duplicates of real chains, with their own
                    # noise (K3 keys it by the chain's row)
                    positions = torch.cat([positions, positions[:pad]])
                    if sink is not None:
                        real_sink, n = sink, self.n_chains
                        sink = lambda chunk, start: real_sink(chunk[:n],
                                                              start)
                try:
                    result = run_sampler(
                        self.bayes.logdensity_and_grad_fn(x, y, mesh), scfg,
                        self._gen_sample, positions, sample_sink=sink,
                        mesh=mesh, **extra)
                finally:
                    if self.sink is not None:
                        self.sink.close()   # drain the writer queue
                if pad:
                    result = slice_chains(result, self.n_chains)
        if 'warmup_trace' in result.info:
            warmup_trace = result.info.pop('warmup_trace')
            if self.primary:
                ckpt.save_samples(self.exp_dir / 'warmup_samples',
                                  warmup_trace)
        if not self.primary:
            return result
        if self.sink is None:
            ckpt.save_samples(self.samples_dir, result.samples)
        ckpt.save_layout(self.samples_dir, self.model.layout)
        if scfg.name == Sampler.MCLMC:
            ckpt.save_warmup_params(self.exp_dir / 'warmup_params.txt',
                                    result.tuned['step_size'],
                                    result.tuned['L'])
        with open(self.samples_dir / 'info.pkl', 'wb') as f:
            pickle.dump({**result.info, **result.tuned}, f)
        return result

    def evaluate(self, member_params: torch.Tensor,
                 result: SamplingResult) -> dict:
        """Posterior-predictive metrics on the test split -> metrics.pkl
        (every rank computes them, rank 0 writes them).

        With an empty test split (``test_split: 0.0``) it raises, after the
        warm start and the draws are on disk, as the JAX trainer's
        evaluation does (there the empty prediction fails inside the
        network); here the error names the cause."""
        x, y = self.loader.arrays('test')
        if x.shape[0] == 0:
            raise ValueError(
                f'the test split is empty (data.test_split: '
                f'{self.config.data.test_split}); evaluation needs test '
                f'data. The warm start and the draws are in {self.exp_dir}')
        task = self.config.data.task
        nominal = NOMINAL_COVERAGES if task == Task.REGRESSION else None
        _, metrics = evaluate_de(self.model, member_params, x, y, task,
                                 n_samples=100, nominal_coverages=nominal)
        _, metrics = evaluate_bde(
            self.model, torch.from_numpy(result.samples).to(self.device),
            x, y, task, nominal_coverages=nominal, metrics_dict=metrics)
        metrics['step_size'] = result.tuned.get('step_size')
        metrics['L'] = result.tuned.get('L')
        if self.primary:
            with open(self.exp_dir / 'metrics.pkl', 'wb') as f:
                pickle.dump(metrics, f)
        return metrics

    def _start_profiler(self):
        """A ``torch.profiler`` session over the warm start and sampling
        (the card's kernels too on a CUDA device), or None if it cannot
        start."""
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.start()
            return profiler
        except Exception:   # profiling must never kill a run
            logger.exception('could not start the torch profiler')
            return None

    def _stop_profiler(self, profiler) -> None:
        """Stop ``profiler`` and write its Chrome trace (TensorBoard and
        Perfetto read it) to ``profile/trace.json``."""
        try:
            profiler.stop()
            out = self.exp_dir / 'profile'
            out.mkdir(parents=True, exist_ok=True)
            profiler.export_chrome_trace(str(out / 'trace.json'))
            logger.info('torch profile written to %s', out)
        except Exception:
            logger.exception('could not write the torch profile')

    def train(self, report: bool = True) -> dict:
        """Warm start, sampling (under the profiler with ``profile:
        true``), evaluation, then the report (``report.html`` and
        ``diagnostics.csv``; a failed report is logged, not raised). The
        profiler and the report run on rank 0 only."""
        profiler = (self._start_profiler()
                    if self.config.profile and self.primary else None)
        try:
            member_params = self.train_warmstart()
            result = self.start_sampling(member_params)
        finally:
            if profiler is not None:
                self._stop_profiler(profiler)
        metrics = self.evaluate(member_params, result)
        if report and self.primary:
            try:
                from mile_tpu_torch.inference.reporting import generate_report

                generate_report(self.exp_dir, self.config, self.device)
            except Exception:   # report failures must not kill the run
                logger.exception('report generation failed')
        return metrics
