"""LeNet-family CNNs over flat, chain-batched parameters (counterpart of
``mile_tpu/models/cnn.py``).

Both read a ``(C, dim)`` parameter tensor in the JAX package's flat layout
and images in NCHW, either ``(N, in, H, W)`` shared by every chain (the
sampler's full batch, the evaluation) or ``(C, N, in, H, W)``, one batch
per chain (the warm start's members). The chain axis is folded into the
convolutions' channels (:func:`~mile_tpu_torch.models.blocks.conv2d`); the
Dense layers run as one ``bmm`` over chains.

Parity with the Flax modules:

- Flatten order: Flax transposes NCHW to NHWC and flattens each image as
  ``(h, w, c)``; a torch NCHW flatten would give ``(c, h, w)``, with the
  same shapes and silently wrong weights. :meth:`ChainCNN.forward`
  permutes to NHWC before it flattens.
- Kernel layout: Flax's Conv kernel ``(kh, kw, in, out)`` is permuted to
  torch's ``(out, in, kh, kw)``; Dense kernels ``(in, out)`` are used as
  they are.
- Padding and pooling: ``padding=p`` pads ``p`` on every side, as Flax's
  integer padding; ``nn.avg_pool`` 2x2 with stride 2 is VALID, as
  ``F.avg_pool2d``'s default (floor). Flax's Conv has a bias whatever
  ``use_bias`` says; ``use_bias`` applies to the Dense layers only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from mile_tpu_torch.config.models import LeNetConfig, LeNettiConfig
from mile_tpu_torch.models.blocks import (
    Init,
    conv2d,
    dense,
    dense_params,
    init_flat,
)
from mile_tpu_torch.models.layout import FlatLayout


class ConvSpec(NamedTuple):
    name: str
    features: int
    kernel: int
    padding: int
    pool: bool        # a 2x2, stride-2 average pool after the activation


class ChainCNN(nn.Module):
    """Conv layers (each: conv, activation, optional pool), then Dense
    layers with the activation between them."""

    convs: tuple[ConvSpec, ...] = ()
    dense_names: tuple[str, ...] = ()
    dense_widths: tuple[int, ...] = ()   # all but the last (out_dim)

    def __init__(self, config: LeNetConfig | LeNettiConfig,
                 input_shape: tuple[int, int, int]):
        super().__init__()
        if len(input_shape) != 3:
            raise ValueError(f'{type(self).__name__} needs (C, H, W) '
                             f'images, got input shape {input_shape}')
        self.config = config
        self.input_shape = tuple(int(s) for s in input_shape)
        self.activation = config.activation.fn
        self.use_bias = config.use_bias
        shapes, self.inits, self._floats = {}, {}, 0
        c, h, w = self.input_shape
        self._floats += c * h * w                       # NCHW -> NHWC
        for conv in self.convs:
            shapes[conv.name] = {'kernel': (conv.kernel, conv.kernel, c,
                                            conv.features),
                                 'bias': (conv.features,)}
            self.inits[f'{conv.name}/kernel'] = Init(conv.kernel ** 2 * c)
            c = conv.features
            h += 2 * conv.padding - conv.kernel + 1
            w += 2 * conv.padding - conv.kernel + 1
            # conv, bias add, activation; and the bias broadcast
            self._floats += 3 * c * h * w + c
            if conv.pool:
                h, w = h // 2, w // 2
                self._floats += 2 * c * h * w           # window sum, divide
        fan_in = c * h * w
        self._floats += fan_in                          # the flatten
        widths = self.dense_widths + (config.out_dim,)
        for i, (name, width) in enumerate(zip(self.dense_names, widths)):
            shapes[name] = dense_params(fan_in, width, self.use_bias)
            self.inits[f'{name}/kernel'] = Init(fan_in)
            fan_in = width
            # product (+ bias broadcast and sum) (+ activation)
            self._floats += width * ((3 if self.use_bias else 1)
                                     + (i < len(widths) - 1))
        self.layout = FlatLayout(shapes)

    @property
    def dim(self) -> int:
        return self.layout.dim

    @property
    def out_features(self) -> int:
        return self.config.out_dim

    def forward(self, theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``theta`` (C, dim), ``x`` (N, in, H, W) shared by all chains or
        (C, N, in, H, W) -> (C, N, out)."""
        n_chains = theta.shape[0]
        shared = x.dim() == 4
        # per-chain batches: fold the chain axis into the channels
        h = x if shared else x.transpose(0, 1).reshape(
            x.shape[1], -1, *x.shape[3:])
        for conv in self.convs:
            h = self.activation(conv2d(theta, h, self.layout, conv.name,
                                       conv.padding, shared))
            shared = False
            if conv.pool:
                h = F.avg_pool2d(h, 2)
        n, _, hh, ww = h.shape
        # flatten each image in Flax's NHWC order (h, w, c)
        h = h.view(n, n_chains, -1, hh, ww).permute(1, 0, 3, 4, 2).reshape(
            n_chains, n, -1)
        last = len(self.dense_names) - 1
        for i, name in enumerate(self.dense_names):
            h = dense(theta, h, self.layout, name, self.use_bias)
            if i < last:
                h = self.activation(h)
        return h

    def activation_floats(self) -> int:
        """Floats of the intermediates of one (sample, observation) pair's
        forward pass, op by op before any fusion, as the JAX package's
        traced plan counts them (the NHWC transpose; each conv's output,
        bias add and activation; each pool's window sum and divide; the
        flatten; each Dense layer's product, bias add and activation). It
        over-counts what the port holds at once, since a forward frees
        each intermediate once the next is computed. The evaluation's chunk
        planner budgets memory with it."""
        return self._floats

    def init(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """``n`` fresh members ``(n, dim)``, initialized as Flax's Conv and
        Dense."""
        return init_flat(self.layout, self.inits, n, generator)


class LeNet(ChainCNN):
    """LeNet-5 shape: 2 conv (+ avg-pool) and 3 dense layers."""

    convs = (ConvSpec('conv1', 6, 5, 2, True),
             ConvSpec('conv2', 16, 5, 0, True))
    dense_names = ('fc1', 'fc2', 'fc3')
    dense_widths = (120, 84)


class LeNetti(ChainCNN):
    """Minimal CNN: 1 tiny conv (3x3, padding 2: 30x30 out of 28x28) and 4
    small dense layers."""

    convs = (ConvSpec('conv1', 1, 3, 2, False),)
    dense_names = ('fc1', 'fc2', 'fc3', 'fc4')
    dense_widths = (8, 8, 8)
