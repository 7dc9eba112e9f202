"""Experiment orchestrator: warmstart -> sampling -> evaluation
(counterpart of ``mile_tpu/train/trainer.py::BDETrainer``, with MCLMC,
NUTS or HMC on one device).

Draws stream to disk while sampling runs, through the native sink
(``samples/chain_{c}/samples.bin``); where it cannot be built the trainer
writes ``samples.npy`` at the end instead, as the JAX trainer does.

Features of the JAX trainer that the port does not have yet raise
:class:`~mile_tpu_torch.exceptions.NotYetPortedError` when a config asks
for them: partition or frozen sampling, mid-chain resume, orbax
checkpoints, per-draw streaming, profiling, warmstart reuse, report
rendering, and more than one device.
"""
from __future__ import annotations

import logging
import pickle
from pathlib import Path

import torch

from mile_tpu_torch.bayes import BayesianModel
from mile_tpu_torch.config import Config, Sampler, Task
from mile_tpu_torch.data import build_loader
from mile_tpu_torch.exceptions import NotYetPortedError
from mile_tpu_torch.inference.evaluation import evaluate_bde, evaluate_de
from mile_tpu_torch.native import NativeSampleSink, native_available
from mile_tpu_torch.train import checkpoint as ckpt
from mile_tpu_torch.train.sampling import SamplingResult, run_sampler
from mile_tpu_torch.train.warmstart import train_ensemble
from mile_tpu_torch.utils.device import resolve_device
from mile_tpu_torch.utils.keys import experiment_keys

logger = logging.getLogger(__name__)

NOMINAL_COVERAGES = [0.5, 0.75, 0.9, 0.95]


def check_supported(config: Config) -> None:
    """Raise for the config options this slice of the port lacks."""
    scfg = config.training.sampler
    wcfg = config.training.warmstart
    unported = [
        (scfg.epoch_wise_sampling, 'epoch-wise (mini-batch) sampling'),
        (scfg.partition_sampling or bool(scfg.params_frozen),
         'partition / frozen-parameter sampling'),
        (scfg.checkpoint_sampling, 'mid-chain resume (checkpoint_sampling)'),
        (scfg.stream_samples, 'per-draw sample streaming (stream_samples)'),
        (scfg.data_sharding > 1, 'data-axis sharding (data_sharding > 1)'),
        (config.training.checkpoint_format != 'npz', 'orbax checkpoints'),
        (config.profile, 'profiling (profile: true)'),
        (wcfg.warmstart_exp_dir is not None,
         'warmstart reuse (warmstart_exp_dir)'),
        (wcfg.partition_warmstart, 'partition warmstart'),
    ]
    for unsupported, feature in unported:
        if unsupported:
            raise NotYetPortedError(feature)


class BDETrainer:
    """Bayesian-deep-ensemble training pipeline for one experiment config.

    Runs on ``device`` (the GPU by default; without one it raises unless
    ``device='cpu'`` is asked for).
    """

    def __init__(self, config: Config, device: str | torch.device = 'cuda'):
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
        self.device = resolve_device(device)
        self.config = config
        self.exp_dir: Path = config.setup_dir()
        sampler_cfg = config.training.sampler
        self.n_chains = sampler_cfg.n_chains
        self.sink: NativeSampleSink | None = None  # of the last sampling

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

    @property
    def warmstart_dir(self) -> Path:
        return self.exp_dir / 'warmstart'

    @property
    def samples_dir(self) -> Path:
        return self.exp_dir / 'samples'

    # ------------------------------------------------------------ phases
    def train_warmstart(self) -> torch.Tensor:
        """Deep-ensemble pre-training: flat members (n_chains, dim)."""
        cfg = self.config.training.warmstart
        if cfg.include:
            params, store = train_ensemble(
                self.model, self.loader, cfg, self.config.data.task,
                self.n_chains, self._gen_train)
            store.save(self.warmstart_dir / 'metrics.pkl')
        else:
            logger.info('warmstart disabled; sampling from fresh inits')
            params = self.model.init(self.n_chains,
                                     self._gen_train).to(self.device)
        host = params.cpu().numpy()
        for i in range(self.n_chains):
            ckpt.save_params(self.warmstart_dir, host[i], self.model.layout, i)
        return params

    def start_sampling(self, member_params: torch.Tensor) -> SamplingResult:
        """Run the configured sampler from the ensemble members' weights,
        persisting the draws chunk by chunk through the native sink (the
        sink is kept as ``self.sink``)."""
        scfg = self.config.training.sampler
        x, y = self.loader.arrays('train')
        self.sink = None
        if native_available():
            self.sink = NativeSampleSink(self.samples_dir, self.n_chains,
                                         self.bayes.dim)
        try:
            result = run_sampler(self.bayes.logdensity_and_grad_fn(x, y),
                                 scfg, self._gen_sample, member_params,
                                 sample_sink=self.sink)
        finally:
            if self.sink is not None:
                self.sink.close()   # drain the writer queue; files complete
        if self.sink is None:
            ckpt.save_samples(self.samples_dir, result.samples)
        ckpt.save_layout(self.samples_dir, self.model.layout)
        if 'warmup_trace' in result.info:
            ckpt.save_samples(self.exp_dir / 'warmup_samples',
                              result.info.pop('warmup_trace'))
        if scfg.name == Sampler.MCLMC:
            ckpt.save_warmup_params(self.exp_dir / 'warmup_params.txt',
                                    result.tuned['step_size'],
                                    result.tuned['L'])
        with open(self.samples_dir / 'info.pkl', 'wb') as f:
            pickle.dump({**result.info, **result.tuned}, f)
        return result

    def evaluate(self, member_params: torch.Tensor,
                 result: SamplingResult) -> dict:
        """Posterior-predictive metrics on the test split -> metrics.pkl.

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
        with open(self.exp_dir / 'metrics.pkl', 'wb') as f:
            pickle.dump(metrics, f)
        return metrics

    def train(self, report: bool = False) -> dict:
        if report:
            raise NotYetPortedError('report generation')
        member_params = self.train_warmstart()
        result = self.start_sampling(member_params)
        return self.evaluate(member_params, result)
