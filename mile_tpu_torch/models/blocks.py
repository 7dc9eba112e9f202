"""Network building blocks over flat, chain-batched parameters
(counterpart of ``mile_tpu/models/blocks.py``)."""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
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


def init_flat(layout: FlatLayout, n: int,
              generator: torch.Generator) -> torch.Tensor:
    """``n`` fresh members ``(n, dim)``, initialized as Flax's Dense and
    Conv: lecun-normal kernels, zero biases. A kernel's fan-in is the
    product of all its axes but the last: ``in`` for a Dense kernel
    ``(in, out)``, ``kh * kw * in`` for a Conv kernel
    ``(kh, kw, in, out)``."""
    flat = torch.zeros(n, layout.dim)
    for leaf in layout.leaves:
        if leaf.path.endswith('/kernel'):
            flat[:, leaf.offset:leaf.offset + leaf.size] = lecun_normal(
                (n, leaf.size), math.prod(leaf.shape[:-1]), generator)
    return flat


def dense(theta: torch.Tensor, h: torch.Tensor, layout: FlatLayout,
          name: str, use_bias: bool = True) -> torch.Tensor:
    """The Dense layer ``name`` of every chain: ``h`` (C, N, in) ->
    (C, N, out). A Flax Dense kernel is ``(in, out)``, as ``bmm`` wants."""
    n_chains = theta.shape[0]
    k = layout[f'{name}/kernel']
    w = theta[:, k.offset:k.offset + k.size].view(n_chains, *k.shape)
    if not use_bias:
        return torch.bmm(h, w)
    b = layout[f'{name}/bias']
    return torch.baddbmm(theta[:, b.offset:b.offset + b.size].unsqueeze(1),
                         h, w)


def conv2d(theta: torch.Tensor, h: torch.Tensor, layout: FlatLayout,
           name: str, padding: int, shared: bool) -> torch.Tensor:
    """The Conv layer ``name`` of every chain in one ``conv2d``, with the
    chain axis folded into the channels (chain-major): ``h`` is
    ``(N, C * in, H, W)``, or ``(N, in, H, W)`` shared by every chain
    (``shared``); the result is ``(N, C * out, H', W')``.

    Kernel layout: a Flax Conv kernel is ``(kh, kw, in, out)``; torch wants
    ``(out, in, kh, kw)``, here ``(C * out, in, kh, kw)``. A shared input
    meets every chain's filters in one dense convolution; chain-major input
    channels meet their own chain's filters with ``groups=C``."""
    n_chains = theta.shape[0]
    k, b = layout[f'{name}/kernel'], layout[f'{name}/bias']
    kh, kw, c_in, c_out = k.shape
    w = theta[:, k.offset:k.offset + k.size].view(
        n_chains, kh, kw, c_in, c_out).permute(0, 4, 3, 1, 2).reshape(
        n_chains * c_out, c_in, kh, kw)
    bias = theta[:, b.offset:b.offset + b.size].reshape(-1)
    return F.conv2d(h, w, bias, padding=padding,
                    groups=1 if shared else n_chains)


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
            h = dense(theta, h, layout, f'{scope}/{name}', self.use_bias)
            if i < last:
                h = self.activation(h)
            elif self.last_layer_activation is not None:
                h = self.last_layer_activation(h)
        return h
