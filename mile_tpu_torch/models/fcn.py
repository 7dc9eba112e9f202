"""Fully connected BNN (counterpart of ``mile_tpu/models/fcn.py``)."""
from __future__ import annotations

import torch
from torch import nn

from mile_tpu_torch.config.models import FCNConfig
from mile_tpu_torch.models.blocks import FullyConnected, init_flat
from mile_tpu_torch.models.layout import FlatLayout


class FCN(nn.Module):
    """FCN with ``fcn`` scope, the BNN of all UCI experiments.

    Reads a chain-batched flat parameter tensor ``(C, dim)`` in the JAX
    package's layout. For regression the final layer has 2 outputs:
    predictive mean and log-σ.
    """

    scope = 'fcn'

    def __init__(self, config: FCNConfig, in_features: int):
        super().__init__()
        self.config = config
        self.fcn = FullyConnected(
            in_features, tuple(config.hidden_structure),
            config.activation.fn, use_bias=config.use_bias)
        self.layout = FlatLayout({self.scope: self.fcn.param_shapes()})

    @property
    def dim(self) -> int:
        return self.layout.dim

    @property
    def out_features(self) -> int:
        return self.fcn.hidden_sizes[-1]

    def forward(self, theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.fcn(theta, x, self.layout, self.scope)

    def activation_floats(self) -> int:
        """Floats of the intermediates of one (sample, observation) pair's
        forward pass, op by op before any fusion, as the JAX package's
        traced plan counts them: each Dense layer's product, broadcast bias
        and sum, and its activation. The evaluation's chunk planner budgets
        memory with it."""
        per_layer = 3 if self.fcn.use_bias else 1
        return (per_layer + 1) * sum(self.fcn.hidden_sizes) \
            - self.out_features

    def init(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """``n`` fresh members ``(n, dim)``, initialized as flax's Dense."""
        return init_flat(self.layout, self.fcn.param_inits(self.scope), n,
                         generator)


class PartitionFCN(FCN):
    """FCN variant used with partition warm start and sampling (same
    forward)."""
