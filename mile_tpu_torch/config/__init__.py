"""Configuration system (counterpart of ``mile_tpu.config``)."""
from mile_tpu_torch.config.base import BaseConfig, CfgEnum, ConfigError  # noqa: F401
from mile_tpu_torch.config.core import Config  # noqa: F401
from mile_tpu_torch.config.data import DataConfig, DatasetType, Source, Task  # noqa: F401
from mile_tpu_torch.config.models import (  # noqa: F401
    Activation,
    FCNConfig,
    ModelConfig,
)
from mile_tpu_torch.config.training import (  # noqa: F401
    Optimizer,
    OptimizerConfig,
    PriorConfig,
    PriorDist,
    Sampler,
    SamplerConfig,
    TrainingConfig,
    WarmstartConfig,
)
