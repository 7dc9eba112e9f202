"""Model configurations + name registry (counterpart of
``mile_tpu/config/models.py``).

The same dataclasses and field names, so every YAML loads unchanged; the
activation and dtype bindings point at PyTorch instead of flax/jnp.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from mile_tpu_torch.config.base import BaseConfig, CfgEnum, ConfigError


class FloatPrecision(CfgEnum):
    FLOAT16 = 'float16'
    FLOAT32 = 'float32'
    FLOAT64 = 'float64'
    BFLOAT16 = 'bfloat16'

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.value)


_ACTIVATIONS = {
    'sigmoid': torch.sigmoid,
    'relu': F.relu,
    # flax.linen.gelu defaults to the tanh approximation
    'gelu': lambda x: F.gelu(x, approximate='tanh'),
    'tanh': torch.tanh,
    'softmax': lambda x: F.softmax(x, dim=-1),
    # flax.linen.leaky_relu's default negative_slope is 0.01, as torch's
    'leaky_relu': F.leaky_relu,
}


class Activation(CfgEnum):
    SIGMOID = 'sigmoid'
    RELU = 'relu'
    GELU = 'gelu'
    TANH = 'tanh'
    SOFTMAX = 'softmax'
    LEAKY_RELU = 'leaky_relu'

    @property
    def fn(self):
        return _ACTIVATIONS[self.value]


@dataclasses.dataclass(frozen=True)
class ModelConfig(BaseConfig):
    """Base model config; subclasses register themselves by their ``model`` name."""

    model: str = 'Model'

    @classmethod
    def registry(cls) -> dict[str, type]:
        out = {}

        def walk(c):
            for sub in c.__subclasses__():
                default = sub.__dataclass_fields__['model'].default
                out[default] = sub
                walk(sub)

        walk(ModelConfig)
        return out

    @classmethod
    def resolve(cls, data: dict) -> 'ModelConfig':
        """Build the right ModelConfig subclass from a plain dict."""
        name = data.get('model')
        reg = cls.registry()
        if name not in reg:
            raise ConfigError(
                f'model.model: unknown model {name!r}; options: {sorted(reg)}'
            )
        return reg[name].from_dict(data, _path='model')


@dataclasses.dataclass(frozen=True)
class FCNConfig(ModelConfig):
    """Fully connected network (the BNN used in all UCI experiments)."""

    model: str = 'FCN'
    hidden_structure: list[int] = dataclasses.field(
        default_factory=lambda: [10, 10])
    activation: Activation = Activation.RELU
    use_bias: bool = True


@dataclasses.dataclass(frozen=True)
class PartitionFCNConfig(FCNConfig):
    """FCN variant used with partition warmstart/sampling."""

    model: str = 'PartitionFCN'


@dataclasses.dataclass(frozen=True)
class LeNetConfig(ModelConfig):
    model: str = 'LeNet'
    activation: Activation = Activation.SIGMOID
    out_dim: int = 10
    use_bias: bool = True


@dataclasses.dataclass(frozen=True)
class LeNettiConfig(ModelConfig):
    model: str = 'LeNetti'
    activation: Activation = Activation.SIGMOID
    out_dim: int = 10
    use_bias: bool = True


@dataclasses.dataclass(frozen=True)
class GPTConfig(ModelConfig):
    """Transformer hyperparameters shared by the attention models."""

    model: str = 'GPT'
    vocab_size: int = 1000
    context_len: int = 8
    emb_size: int = 256
    n_blocks: int = 6
    n_heads: int = 8
    qkv_dim: int = 512
    bias: bool = False
    dropout: float = 0.1
    dtype: FloatPrecision = FloatPrecision.FLOAT32


@dataclasses.dataclass(frozen=True)
class AttentionClassifierConfig(GPTConfig):
    model: str = 'AttentionClassifier'
    n_classes: int = 2
    projection_dim: list[int] = dataclasses.field(default_factory=lambda: [32])


@dataclasses.dataclass(frozen=True)
class PretrainedAttentionClassifierConfig(AttentionClassifierConfig):
    model: str = 'PretrainedAttentionClassifier'
    emb_path: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class EmbeddingClassifierConfig(AttentionClassifierConfig):
    model: str = 'EmbeddingClassifier'
