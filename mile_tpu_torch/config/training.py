"""Training-phase configuration: warmstart optimizer, sampler, tokenizer.

Counterpart of ``mile_tpu/config/training.py``: the same fields and
validation, so the reference YAMLs (``integrator: mclachlan_pallas``
included) load unchanged. Optimizers are ``torch.optim`` classes built
from the optax-style parameter names the YAMLs use, and
``SamplerConfig.build_kernel`` resolves the port's own MCLMC, NUTS and HMC
kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from mile_tpu_torch.config.base import BaseConfig, CfgEnum, ConfigError

# optax keyword -> torch.optim keyword; ``b1``/``b2`` merge into ``betas``
_OPTAX_TO_TORCH = {'learning_rate': 'lr', 'eps': 'eps',
                   'weight_decay': 'weight_decay', 'momentum': 'momentum',
                   'nesterov': 'nesterov'}
# keywords each optax constructor accepts (its signature), and the optax
# defaults that differ from torch's
_ACCEPTED = {
    'adamw': {'learning_rate', 'b1', 'b2', 'eps', 'weight_decay'},
    'adam': {'learning_rate', 'b1', 'b2', 'eps'},
    'sgd': {'learning_rate', 'momentum', 'nesterov'},
}
_OPTAX_DEFAULTS = {'adamw': {'weight_decay': 1e-4}}


# --------------------------------------------------------------- warmstart
class Optimizer(CfgEnum):
    ADAMW = 'adamw'
    ADAM = 'adam'
    SGD = 'sgd'

    def torch_kwargs(self, parameters: dict) -> dict:
        """Translate optax keyword arguments into ``torch.optim`` ones,
        keeping optax's defaults where the two libraries differ."""
        unknown = set(parameters) - _ACCEPTED[self.value]
        if unknown:
            raise ConfigError(
                f'optimizer {self.value}: unsupported parameter(s) '
                f'{sorted(unknown)}; valid: {sorted(_ACCEPTED[self.value])}')
        params = {**_OPTAX_DEFAULTS.get(self.value, {}), **parameters}
        kwargs = {_OPTAX_TO_TORCH[k]: v for k, v in params.items()
                  if k in _OPTAX_TO_TORCH}
        if 'b1' in params or 'b2' in params:
            kwargs['betas'] = (params.get('b1', 0.9), params.get('b2', 0.999))
        if kwargs.get('momentum') is None:
            kwargs.pop('momentum', None)   # optax ``momentum=None``: plain SGD
        return kwargs

    def build(self, parameters: dict, params: list[torch.Tensor]
              ) -> torch.optim.Optimizer:
        cls = {'adamw': torch.optim.AdamW, 'adam': torch.optim.Adam,
               'sgd': torch.optim.SGD}[self.value]
        return cls(params, **self.torch_kwargs(parameters))


@dataclasses.dataclass(frozen=True)
class OptimizerConfig(BaseConfig):
    name: Optimizer = Optimizer.ADAMW
    parameters: dict[str, Any] = dataclasses.field(
        default_factory=lambda: {'learning_rate': 1e-3})

    def build(self, params: list[torch.Tensor]) -> torch.optim.Optimizer:
        return self.name.build(self.parameters, params)


@dataclasses.dataclass(frozen=True)
class WarmstartConfig(BaseConfig):
    """Deep-ensemble (frequentist) pre-training of the chain initializers."""

    include: bool = True
    optimizer_config: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    warmstart_exp_dir: Optional[str] = None
    max_epochs: int = 100
    batch_size: Optional[int] = None
    patience: Optional[int] = None
    partition_warmstart: bool = False


# ----------------------------------------------------------------- priors
class PriorDist(CfgEnum):
    NORMAL = 'Normal'
    STANDARD_NORMAL = 'StandardNormal'
    LAPLACE = 'Laplace'


@dataclasses.dataclass(frozen=True)
class PriorConfig(BaseConfig):
    name: PriorDist = PriorDist.STANDARD_NORMAL
    parameters: dict[str, Any] = dataclasses.field(default_factory=dict)

    def build(self):
        from mile_tpu_torch.bayes.priors import Prior

        return Prior.from_name(self.name, **self.parameters)


# ---------------------------------------------------------------- sampler
class Sampler(CfgEnum):
    NUTS = 'nuts'
    HMC = 'hmc'
    MCLMC = 'mclmc'


@dataclasses.dataclass(frozen=True)
class SamplerConfig(BaseConfig):
    """MCMC sampling-phase knobs; the fields and their meaning are those of
    ``mile_tpu.config.training.SamplerConfig`` (see its comments)."""

    name: Sampler = Sampler.MCLMC
    epoch_wise_sampling: bool = False
    params_frozen: list[str] = dataclasses.field(default_factory=list)
    warmup_steps: int = 1000
    n_chains: int = 4
    n_samples: int = 1000
    use_warmup_as_init: bool = True
    n_thinning: int = 1
    diagonal_preconditioning: bool = False
    desired_energy_var_start: float = 5e-4
    desired_energy_var_end: float = 5e-4
    trust_in_estimate: float = 1.5
    num_effective_samples: int = 100
    step_size_init: float = 0.005
    keep_warmup: bool = False
    prior_config: PriorConfig = dataclasses.field(default_factory=PriorConfig)
    partition_sampling: bool = False
    stream_samples: bool = False
    checkpoint_sampling: bool = False
    likelihood_chunk_size: Optional[int] = None
    compute_dtype: Optional[str] = None
    # matmul arithmetic of the sampling phase and of the tuner; None is the
    # process's ``mile_tpu_torch.utils.precision.none_precision`` (see
    # that module)
    matmul_precision: Optional[str] = None
    warmup_matmul_precision: Optional[str] = 'float32'
    num_integration_steps: int = 32
    target_acceptance: float = 0.9
    max_num_doublings: int = 10
    warmup_max_num_doublings: Optional[int] = None
    data_sharding: int = 1
    # 'mclachlan' and 'mclachlan_pallas' are the same in the port: on a
    # CUDA device both run the hand-written kernels, on the CPU the plain
    # PyTorch versions
    integrator: str = 'mclachlan'

    def build_kernel(self, logdensity_and_grad, generator: torch.Generator):
        """Resolve the kernel factory: the configured sampler's step over a
        chain batch, drawing its randomness from ``generator``."""
        from mile_tpu_torch.mcmc import hmc, mclmc, nuts

        if self.name == Sampler.MCLMC:
            return mclmc.build_kernel(logdensity_and_grad, generator,
                                      integrator=self.integrator)
        if self.name == Sampler.NUTS:
            return nuts.build_kernel(logdensity_and_grad, generator,
                                     max_depth=self.max_num_doublings)
        return hmc.build_kernel(
            logdensity_and_grad, generator,
            num_integration_steps=self.num_integration_steps)

    def __post_init__(self):
        if self.warmup_steps <= 0:
            raise ConfigError('sampler.warmup_steps must be > 0')
        if self.n_chains <= 0 or self.n_samples <= 0:
            raise ConfigError('sampler.n_chains and n_samples must be > 0')
        if self.n_thinning < 1:
            raise ConfigError('sampler.n_thinning must be >= 1')
        if self.data_sharding < 1:
            raise ConfigError('sampler.data_sharding must be >= 1')
        if not 0.0 < self.target_acceptance < 1.0:
            raise ConfigError('sampler.target_acceptance must be in (0, 1)')
        if not 1 <= self.max_num_doublings <= 20:
            raise ConfigError(
                'sampler.max_num_doublings must be in [1, 20]')
        if (self.warmup_max_num_doublings is not None
                and not 1 <= self.warmup_max_num_doublings <= 20):
            raise ConfigError(
                'sampler.warmup_max_num_doublings must be in [1, 20]')
        for field in ('matmul_precision', 'warmup_matmul_precision'):
            val = getattr(self, field)
            if val not in (None, 'float32', 'bfloat16', 'tensorfloat32'):
                raise ConfigError(
                    f"sampler.{field} must be one of None/'float32'/"
                    f"'bfloat16'/'tensorfloat32', got {val!r}")
        if self.integrator not in ('mclachlan', 'mclachlan_pallas'):
            raise ConfigError(
                "sampler.integrator must be 'mclachlan' or "
                f"'mclachlan_pallas', got {self.integrator!r}")


# -------------------------------------------------------------- tokenizer
class TokenizerName(CfgEnum):
    CUSTOM_BPE = 'custom_bpe'
    BPE = 'bpe'
    BERT = 'bert'
    SINGLE_CHAR = 'single_char'


@dataclasses.dataclass(frozen=True)
class TokenizerConfig(BaseConfig):
    name: TokenizerName = TokenizerName.SINGLE_CHAR
    parameters: dict[str, Any] = dataclasses.field(default_factory=dict)


# ------------------------------------------------------------------- root
@dataclasses.dataclass(frozen=True)
class TrainingConfig(BaseConfig):
    warmstart: WarmstartConfig = dataclasses.field(default_factory=WarmstartConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    tokenizer: Optional[TokenizerConfig] = None
    checkpoint_format: str = 'npz'

    def __post_init__(self):
        if self.checkpoint_format not in ('npz', 'orbax'):
            raise ConfigError(
                "training.checkpoint_format must be 'npz' or 'orbax', "
                f'got {self.checkpoint_format!r}')
