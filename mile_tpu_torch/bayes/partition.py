"""Parameter-subspace partitioning (counterpart of
``mile_tpu/bayes/partition.py``): sample the first and last layer groups,
or every group but the named frozen ones, and hold the rest at each
chain's warm-start values.

In flat space the mechanism is an index set over the JAX layout:

- ``partition_mask`` / ``frozen_mask``: boolean (dim,), True = sampled;
- the samplers run in the subspace ``z = theta[:, idx]`` with the density
  of ``base`` (each chain's full warm-start member, ``(C, dim)``) with its
  sampled coordinates replaced by ``z``;
- the draws are merged back to full dimension.

Groups follow the flat layout's order, which sorts layer names as
strings: with 11 layers or more the last group is ``fcn/layer9``, not the
output layer ``fcn/layer10``, and a frozen name ``layer1`` also matches
``layer10``-``layer19``. Both are the JAX package's behaviour, kept here.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mile_tpu_torch.models.layout import FlatLayout


def layer_groups(layout: FlatLayout) -> list[tuple[str, int, int]]:
    """Ordered (group name, start, end) flat slices, grouping leaves by
    their parent path (``fcn/layer0`` holds its bias and kernel)."""
    groups: list[tuple[str, int, int]] = []
    for leaf in layout.leaves:
        name = leaf.path.rpartition('/')[0] or 'root'
        end = leaf.offset + leaf.size
        if groups and groups[-1][0] == name:
            groups[-1] = (name, groups[-1][1], end)
        else:
            groups.append((name, leaf.offset, end))
    return groups


def partition_mask(layout: FlatLayout) -> np.ndarray:
    """True = sampled (first and last layer group); False = frozen."""
    groups = layer_groups(layout)
    mask = np.zeros(layout.dim, dtype=bool)
    for _, start, end in (groups[0], groups[-1]):
        mask[start:end] = True
    return mask


def frozen_mask(layout: FlatLayout, frozen_names: list[str]) -> np.ndarray:
    """True = sampled; the groups whose name contains any entry of
    ``frozen_names`` are frozen (``SamplerConfig.params_frozen``)."""
    groups = layer_groups(layout)
    mask = np.ones(layout.dim, dtype=bool)
    matched = False
    for name, start, end in groups:
        if any(f in name for f in frozen_names):
            mask[start:end] = False
            matched = True
    if not matched:
        raise ValueError(
            f'params_frozen {frozen_names} matched no layer; layers: '
            f'{[g[0] for g in groups]}')
    return mask


def partition_labels(layout: FlatLayout) -> dict[str, str]:
    """Each leaf path -> ``'input_output_layers'`` (first and last layer
    group: the partition warm start trains them) or ``'hidden_layers'``
    (held at their initial values), the labels of the JAX package's
    ``optax.multi_transform``."""
    groups = layer_groups(layout)
    sampled = {groups[0][0], groups[-1][0]}
    return {leaf.path: ('input_output_layers'
                        if (leaf.path.rpartition('/')[0] or 'root') in sampled
                        else 'hidden_layers')
            for leaf in layout.leaves}


def make_partitioned_logdensity(logdensity_fn: Callable, mask: np.ndarray,
                                base: torch.Tensor) -> Callable:
    """``z (C, d) -> (C,)``: the density of ``base`` (C, dim) with its
    sampled coordinates replaced by ``z``. ``base`` is detached, so a
    gradient of the result flows into ``z`` alone: it is the full
    gradient at the sampled coordinates."""
    idx = torch.as_tensor(np.nonzero(mask)[0], device=base.device)
    base = base.detach()

    def partitioned(z: torch.Tensor) -> torch.Tensor:
        return logdensity_fn(base.index_copy(-1, idx, z))

    return partitioned


def split(theta, mask: np.ndarray):
    """The sampled subvector of ``theta`` (..., dim), numpy or torch."""
    idx = np.nonzero(mask)[0]
    if isinstance(theta, torch.Tensor):
        return theta[..., torch.as_tensor(idx, device=theta.device)]
    return theta[..., idx]


def merge(base: np.ndarray, z: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Draws back at full dimension: ``base`` (C, dim) frozen values, ``z``
    (C, n_kept, d) draws -> (C, n_kept, dim)."""
    base = np.asarray(base)
    z = np.asarray(z)
    out = np.broadcast_to(base[:, None, :],
                          (*z.shape[:2], base.shape[-1])).copy()
    out[..., np.nonzero(mask)[0]] = z
    return out
