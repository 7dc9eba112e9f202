"""Image data loader (counterpart of ``mile_tpu/data/image.py``).

Local ``.npz`` archives with keys ``x``/``y``, or pre-split archives with
``train_x``/``train_y``/``valid_x``/... (concatenated, then split anew by
the config). The conversion to float32, the ``/255`` normalization, the
channel axis added to ``(N, H, W)`` images (NCHW), the single seeded
permutation, ``datapoint_limit`` and the fractional split are the JAX
package's numpy code, so with the same seed the splits are bit-identical.
``source: torchvision`` needs the torchvision package and datasets already
on disk; the loader never downloads.
"""
from __future__ import annotations

import numpy as np
import torch

from mile_tpu_torch.config.data import DataConfig, DatasetType, Source, Task
from mile_tpu_torch.data.base import (
    BaseLoader,
    Split,
    check_seed,
    resolve_data_path,
)

TORCHVISION_SETS = {'MNIST', 'FashionMNIST', 'CIFAR10'}
_SPLITS = ('train', 'valid', 'test')


class ImageLoader(BaseLoader):
    def __init__(self, config: DataConfig, rng,
                 device: str | torch.device = 'cpu'):
        if config.data_type != DatasetType.IMAGE:
            raise ValueError(f'ImageLoader needs image data, got '
                             f'{config.data_type.value}')
        check_seed(rng)
        super().__init__(config, device)
        self._rng = np.random.default_rng(rng)
        x, y = self._load()
        if config.normalize:
            x = x / 255.0
        if x.ndim == 3:  # add the channel axis -> NCHW
            x = x[:, None, :, :]
        perm = self._rng.permutation(len(x))
        x, y = x[perm], y[perm]
        if config.datapoint_limit:
            x, y = x[: config.datapoint_limit], y[: config.datapoint_limit]
        n = len(x)
        n_train = int(n * config.train_split)
        n_valid = int(n * (config.train_split + config.valid_split))
        bounds = {'train': (0, n_train), 'valid': (n_train, n_valid),
                  'test': (n_valid, n)}
        self._x = {s: x[a:b] for s, (a, b) in bounds.items()}
        self._y = {s: y[a:b] for s, (a, b) in bounds.items()}

    def _load(self) -> tuple[np.ndarray, np.ndarray]:
        if self.config.source == Source.TORCHVISION:
            return self._load_torchvision(self.config.path)
        with np.load(resolve_data_path(self.config.path)) as data:
            if 'x' in data:
                x, y = data['x'], data['y']
            else:  # pre-split archive: concatenate, split anew by config
                x = np.concatenate([data[f'{s}_x'] for s in _SPLITS
                                    if f'{s}_x' in data])
                y = np.concatenate([data[f'{s}_y'] for s in _SPLITS
                                    if f'{s}_y' in data])
        return np.asarray(x, np.float32), np.asarray(y)

    @staticmethod
    def _load_torchvision(name: str) -> tuple[np.ndarray, np.ndarray]:
        try:
            import torchvision
        except ImportError as e:
            raise ImportError(
                f'source=torchvision requires the torchvision package '
                f'(dataset {name}); provide a local .npz instead') from e
        if name not in TORCHVISION_SETS:
            raise ValueError(f'unsupported torchvision dataset {name}; '
                             f'options: {sorted(TORCHVISION_SETS)}')
        cls = getattr(torchvision.datasets, name)
        # download=False: the datasets must already be on disk
        train = cls('data/_torchvision', train=True, download=False)
        test = cls('data/_torchvision', train=False, download=False)
        x = np.concatenate([np.asarray(train.data, np.float32),
                            np.asarray(test.data, np.float32)])
        y = np.concatenate([np.asarray(train.targets),
                            np.asarray(test.targets)])
        if x.ndim == 4 and x.shape[-1] in (1, 3):  # NHWC -> NCHW
            x = x.transpose(0, 3, 1, 2)
        return x, y

    def numpy_arrays(self, split: Split) -> tuple[np.ndarray, np.ndarray]:
        y = self._y[split]
        if self.config.task == Task.CLASSIFICATION:
            y = y.astype(np.int64)
        return self._x[split], y

    def __len__(self):
        return sum(len(v) for v in self._x.values())
