"""Experiment-level random streams (counterpart of ``mile_tpu/utils/keys.py``).

One root seed per experiment (``config.rng``). The loader stream stays
``np.random.SeedSequence([rng, 0])``, so the data split is bit-identical to
the JAX package's. The init, train and sample streams are
``torch.Generator``s (on the CPU, so a run draws the same numbers whatever
device it computes on) seeded from ``SeedSequence([rng, k])`` for k = 1, 2, 3.
JAX's threefry keys and torch's generators cannot give the same numbers,
so only the loader stream is shared with the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

_LOADER_STREAM, _INIT_STREAM, _TRAIN_STREAM, _SAMPLE_STREAM = 0, 1, 2, 3


def stream_seed(rng: int, stream: int) -> int:
    """64-bit seed of stream ``stream`` of root seed ``rng``."""
    return int(np.random.SeedSequence([int(rng), stream]).generate_state(
        1, np.uint64)[0])


def generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


class ExperimentKeys:
    __slots__ = ('rng',)

    def __init__(self, rng: int):
        self.rng = int(rng)

    @property
    def loader(self) -> np.random.SeedSequence:
        return np.random.SeedSequence([self.rng, _LOADER_STREAM])

    @property
    def init(self) -> torch.Generator:
        return generator(stream_seed(self.rng, _INIT_STREAM))

    @property
    def train(self) -> torch.Generator:
        return generator(stream_seed(self.rng, _TRAIN_STREAM))

    @property
    def sample(self) -> torch.Generator:
        return generator(stream_seed(self.rng, _SAMPLE_STREAM))


def experiment_keys(rng: int) -> ExperimentKeys:
    return ExperimentKeys(rng)
