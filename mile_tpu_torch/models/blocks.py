"""Network building blocks over flat, chain-batched parameters
(counterpart of ``mile_tpu/models/blocks.py``)."""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from mile_tpu_torch.models.layout import FlatLayout

# flax.linen.initializers.lecun_normal: a normal truncated to [-2, 2],
# rescaled by this constant so that its variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape: tuple[int, ...], fan_in: int,
                 generator: torch.Generator) -> torch.Tensor:
    """Truncated-normal draws with variance 1/fan_in, as Flax's Dense
    initializes its kernels (inverse-CDF sampling, float32 result)."""
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(shape, generator=generator,
                                    dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).float()


class FullyConnected(nn.Module):
    """Stack of Dense layers named ``layer{i}`` with an activation between,
    reading its weights from a flat ``(C, dim)`` tensor.

    Parameter names and shapes are Flax's (``kernel`` is ``(in, out)``),
    so the flat layout is the JAX package's.
    """

    def __init__(self, in_features: int, hidden_sizes: tuple[int, ...],
                 activation: Callable, use_bias: bool = True,
                 last_layer_activation: Optional[Callable] = None,
                 blockid: Optional[str] = None):
        super().__init__()
        self.in_features = in_features
        self.hidden_sizes = tuple(hidden_sizes)
        self.activation = activation
        self.use_bias = use_bias
        self.last_layer_activation = last_layer_activation
        prefix = f'{blockid}_' if blockid else ''
        self.layer_names = [f'{prefix}layer{i}'
                            for i in range(len(self.hidden_sizes))]

    def param_shapes(self) -> dict:
        shapes, fan_in = {}, self.in_features
        for name, size in zip(self.layer_names, self.hidden_sizes):
            shapes[name] = {'kernel': (fan_in, size)}
            if self.use_bias:
                shapes[name]['bias'] = (size,)
            fan_in = size
        return shapes

    def forward(self, theta: torch.Tensor, x: torch.Tensor,
                layout: FlatLayout, scope: str) -> torch.Tensor:
        """``theta`` (C, dim), ``x`` (N, F) shared by all chains or
        (C, N, F) -> (C, N, out)."""
        n_chains = theta.shape[0]
        h = x if x.dim() == 3 else x.unsqueeze(0).expand(n_chains, -1, -1)
        last = len(self.layer_names) - 1
        for i, name in enumerate(self.layer_names):
            k = layout[f'{scope}/{name}/kernel']
            w = theta[:, k.offset:k.offset + k.size].view(n_chains, *k.shape)
            if self.use_bias:
                b = layout[f'{scope}/{name}/bias']
                bias = theta[:, b.offset:b.offset + b.size].unsqueeze(1)
                h = torch.baddbmm(bias, h, w)
            else:
                h = torch.bmm(h, w)
            if i < last:
                h = self.activation(h)
            elif self.last_layer_activation is not None:
                h = self.last_layer_activation(h)
        return h
