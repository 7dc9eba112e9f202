"""Models (counterpart of ``mile_tpu.models``; the FCN so far)."""
from __future__ import annotations

from mile_tpu_torch.config.models import ModelConfig
from mile_tpu_torch.models.fcn import FCN  # noqa: F401
from mile_tpu_torch.models.layout import (  # noqa: F401
    FlatLayout,
    flat_from_jax_params,
    jax_leaves_from_flat,
)


def build_model(config: ModelConfig, in_features: int) -> FCN:
    """The network named by ``config.model``, for ``in_features`` inputs."""
    if config.model != 'FCN':
        from mile_tpu_torch.exceptions import NotYetPortedError

        raise NotYetPortedError(f'the {config.model} model')
    return FCN(config, in_features)
