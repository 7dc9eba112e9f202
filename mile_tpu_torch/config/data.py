"""Dataset configuration (counterpart of ``mile_tpu/config/data.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from mile_tpu_torch.config.base import BaseConfig, CfgEnum, ConfigError


class Source(CfgEnum):
    LOCAL = 'local'
    URL = 'url'
    HUGGINGFACE = 'huggingface'
    TORCHVISION = 'torchvision'


class Task(CfgEnum):
    REGRESSION = 'regr'
    CLASSIFICATION = 'class'


class DatasetType(CfgEnum):
    TABULAR = 'tabular'
    IMAGE = 'image'
    TEXT = 'text'


@dataclasses.dataclass(frozen=True)
class DataConfig(BaseConfig):
    """Where the data lives, what kind it is, and how to split it."""

    path: str
    source: Source = Source.LOCAL
    data_type: DatasetType = DatasetType.TABULAR
    task: Task = Task.REGRESSION
    target_column: Optional[str] = None
    target_len: int = 1
    features: Optional[list[str]] = None
    datapoint_limit: Optional[int] = None
    normalize: bool = True
    train_split: float = 0.8
    valid_split: float = 0.1
    test_split: float = 0.1

    def __post_init__(self):
        total = self.train_split + self.valid_split + self.test_split
        if abs(total - 1.0) > 1e-6:
            raise ConfigError(
                f'data splits must sum to 1.0, got {total} '
                f'({self.train_split}/{self.valid_split}/{self.test_split})'
            )
