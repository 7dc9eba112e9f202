"""Data loaders (counterpart of ``mile_tpu.data``; tabular and image so
far)."""
from __future__ import annotations

from mile_tpu_torch.config.data import DataConfig, DatasetType
from mile_tpu_torch.data.image import ImageLoader  # noqa: F401
from mile_tpu_torch.data.tabular import TabularLoader  # noqa: F401


def build_loader(config: DataConfig, rng, device='cpu', target_len: int = 1):
    if config.data_type == DatasetType.TABULAR:
        return TabularLoader(config, rng, target_len=target_len,
                             device=device)
    if config.data_type == DatasetType.IMAGE:
        return ImageLoader(config, rng, device=device)
    from mile_tpu_torch.exceptions import NotYetPortedError

    raise NotYetPortedError(f'the {config.data_type.value} data loader')
