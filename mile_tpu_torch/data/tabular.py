"""Tabular (UCI) data loader (counterpart of ``mile_tpu/data/tabular.py``).

The load, z-normalization, single seeded permutation and fractional split
are the JAX package's numpy code, so with the same seed the splits are
bit-identical. Tensors cross to the loader's device in ``arrays()``.
"""
from __future__ import annotations

import numpy as np
import torch

from mile_tpu_torch.config.data import DataConfig, DatasetType, Task
from mile_tpu_torch.data.base import (
    BaseLoader,
    Split,
    check_seed,
    resolve_data_path,
)


class TabularLoader(BaseLoader):
    def __init__(self, config: DataConfig, rng, target_len: int = 1,
                 device: str | torch.device = 'cpu'):
        if config.data_type != DatasetType.TABULAR:
            raise ValueError(f'TabularLoader needs tabular data, got '
                             f'{config.data_type.value}')
        check_seed(rng)
        super().__init__(config, device)
        self.target_len = target_len
        self._rng = np.random.default_rng(rng)
        data = self._load(resolve_data_path(config.path))
        if config.normalize:
            data = self._normalize(data)
        data = data[self._rng.permutation(len(data))]
        if config.datapoint_limit:
            data = data[: config.datapoint_limit]
        n = len(data)
        n_train = int(n * config.train_split)
        n_valid = int(n * (config.train_split + config.valid_split))
        self._splits = {
            'train': data[:n_train],
            'valid': data[n_train:n_valid],
            'test': data[n_valid:],
        }

    @staticmethod
    def _load(path) -> np.ndarray:
        path = str(path)
        if path.endswith('.npy'):
            raw = np.load(path)
        elif path.endswith('.csv'):
            raw = np.loadtxt(path, delimiter=',')
        elif path.endswith('.data'):
            raw = np.genfromtxt(path, delimiter=' ')
        else:
            raise NotImplementedError(
                f'unsupported tabular format: {path} (.npy/.csv/.data)')
        return np.asarray(raw, dtype=np.float32)

    def _normalize(self, data: np.ndarray) -> np.ndarray:
        if self.config.task == Task.CLASSIFICATION:
            feats = data[:, : -self.target_len]
            feats = (feats - feats.mean(axis=0)) / feats.std(axis=0)
            return np.concatenate([feats, data[:, -self.target_len:]], axis=1)
        return (data - data.mean(axis=0)) / data.std(axis=0)

    def numpy_arrays(self, split: Split) -> tuple[np.ndarray, np.ndarray]:
        data = self._splits[split]
        x = data[..., : -self.target_len]
        y = data[..., -self.target_len:].squeeze(-1)
        if self.config.task == Task.CLASSIFICATION:
            y = y.astype(np.int64)
        return x, y

    @property
    def n_features(self) -> int:
        return self._splits['train'].shape[-1] - self.target_len

    def __len__(self):
        return sum(len(v) for v in self._splits.values())
