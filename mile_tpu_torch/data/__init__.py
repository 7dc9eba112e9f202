"""Data loaders (counterpart of ``mile_tpu.data``: tabular, image and
text)."""
from __future__ import annotations

from mile_tpu_torch.config.data import DataConfig, DatasetType
from mile_tpu_torch.data.image import ImageLoader  # noqa: F401
from mile_tpu_torch.data.tabular import TabularLoader  # noqa: F401
from mile_tpu_torch.data.text import TextLoader  # noqa: F401


def build_loader(config: DataConfig, rng, device='cpu', target_len: int = 1,
                 tokenizer_config=None):
    """The loader of ``config.data_type``; ``tokenizer_config`` (the
    config's ``training.tokenizer``) is the text loader's."""
    if config.data_type == DatasetType.TABULAR:
        return TabularLoader(config, rng, target_len=target_len,
                             device=device)
    if config.data_type == DatasetType.IMAGE:
        return ImageLoader(config, rng, device=device)
    if config.data_type == DatasetType.TEXT:
        return TextLoader(config, rng, tokenizer_config=tokenizer_config,
                          device=device)
    raise NotImplementedError(f'no loader for {config.data_type}')
