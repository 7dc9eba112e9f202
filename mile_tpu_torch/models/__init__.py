"""Models (counterpart of ``mile_tpu.models``: the FCN and PartitionFCN, the
CNNs and the attention classifiers)."""
from __future__ import annotations

from mile_tpu_torch.config.models import ModelConfig
from mile_tpu_torch.models.attention import (  # noqa: F401
    AttentionClassifier,
    EmbeddingClassifier,
    PretrainedAttentionClassifier,
)
from mile_tpu_torch.models.cnn import LeNet, LeNetti  # noqa: F401
from mile_tpu_torch.models.fcn import FCN, PartitionFCN  # noqa: F401
from mile_tpu_torch.models.layout import (  # noqa: F401
    FlatLayout,
    flat_from_jax_params,
    jax_leaves_from_flat,
)

MODEL_REGISTRY = {
    'FCN': FCN,
    'PartitionFCN': PartitionFCN,
    'LeNet': LeNet,
    'LeNetti': LeNetti,
    'AttentionClassifier': AttentionClassifier,
    'PretrainedAttentionClassifier': PretrainedAttentionClassifier,
    'EmbeddingClassifier': EmbeddingClassifier,
}


def build_model(config: ModelConfig, input_shape: int | tuple[int, ...]):
    """The network named by ``config.model`` for observations of
    ``input_shape``: ``(F,)`` (or the int ``F``) for the FCN, ``(C, H, W)``
    for the CNNs, ``(context_len,)`` token ids for the text models
    (``(T, F)`` embeddings for ``EmbeddingClassifier``)."""
    if config.model not in MODEL_REGISTRY:
        raise KeyError(f'unknown model {config.model!r}; options: '
                       f'{sorted(MODEL_REGISTRY)}')
    if isinstance(input_shape, int):
        input_shape = (input_shape,)
    cls = MODEL_REGISTRY[config.model]
    if issubclass(cls, FCN):
        if len(input_shape) != 1:
            raise ValueError(f'{config.model} needs flat features, got '
                             f'input shape {tuple(input_shape)}')
        return cls(config, input_shape[0])
    return cls(config, tuple(input_shape))
