"""Data-path resolution and the loaders' common protocol (counterpart of
``mile_tpu/data/base.py``)."""
from __future__ import annotations

from pathlib import Path
from typing import Literal

import numpy as np
import torch

Split = Literal['train', 'valid', 'test']

_REPO_ROOT = Path(__file__).resolve().parents[2]


def resolve_data_path(path: str | Path) -> Path:
    """Resolve a data path against cwd, then the repo root."""
    p = Path(path)
    if p.exists():
        return p
    alt = _REPO_ROOT / p
    if alt.exists():
        return alt
    raise FileNotFoundError(f'data file not found: {path} (also tried {alt})')


def check_seed(rng) -> None:
    if not isinstance(rng, (int, np.integer, np.random.SeedSequence,
                            np.random.Generator)):
        raise TypeError(f'loader seed must be an int, a numpy '
                        f'SeedSequence or Generator, got {type(rng)}')


class BaseLoader:
    """A loader holds its splits as numpy arrays on the host; tensors cross
    to its ``device`` in :meth:`arrays`. Subclasses implement
    :meth:`numpy_arrays`."""

    def __init__(self, config, device: str | torch.device = 'cpu'):
        self.config = config
        self.device = torch.device(device)

    def numpy_arrays(self, split: Split) -> tuple[np.ndarray, np.ndarray]:
        """(features, labels) of a split; class labels are int64."""
        raise NotImplementedError

    def arrays(self, split: Split) -> tuple[torch.Tensor, torch.Tensor]:
        """Full (features, labels) tensors of a split, on the loader's device."""
        x, y = self.numpy_arrays(split)
        return (torch.from_numpy(np.ascontiguousarray(x)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(y)).to(self.device))

    @property
    def input_shape(self) -> tuple[int, ...]:
        """Shape of one observation: ``(F,)`` or ``(C, H, W)``."""
        return tuple(self.numpy_arrays('train')[0].shape[1:])
