"""Welford streaming variance for diagonal mass-matrix adaptation over a
chain batch (counterpart of ``mile_tpu/mcmc/adaptation/mass_matrix.py``).

``count`` is one number shared by the chains (they are updated together);
``mean`` and ``m2`` are ``(C, dim)``."""
from __future__ import annotations

from typing import NamedTuple

import torch


class WelfordState(NamedTuple):
    count: float
    mean: torch.Tensor
    m2: torch.Tensor


def welford_init(like: torch.Tensor) -> WelfordState:
    """An empty estimate for positions shaped (and placed) like ``like``."""
    return WelfordState(0.0, torch.zeros_like(like), torch.zeros_like(like))


def welford_update(state: WelfordState, value: torch.Tensor) -> WelfordState:
    count = state.count + 1.0
    delta = value - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (value - mean)
    return WelfordState(count, mean, m2)


def welford_variance(state: WelfordState, regularized: bool = True
                     ) -> torch.Tensor:
    """Sample variance; Stan's shrinkage towards 1e-3 when regularized."""
    var = state.m2 / max(state.count - 1.0, 1.0)
    if regularized:
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var
