"""Parameter priors (counterpart of ``mile_tpu/bayes/priors.py``).

Priors are iid over all weights, so they are evaluated directly on the
flat, chain-batched parameter tensor: ``(C, dim) -> (C,)``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from mile_tpu_torch.config.training import PriorDist

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class Prior(NamedTuple):
    """iid prior: init sampler + log density over flat parameters."""

    f_init: Callable  # (shape, generator) -> tensor
    log_prior: Callable[[torch.Tensor], torch.Tensor]  # (C, dim) -> (C,)
    name: str

    @classmethod
    def from_name(cls, name: PriorDist, **parameters) -> 'Prior':
        loc = float(parameters.get('loc', 0.0))
        scale = float(parameters.get('scale', 1.0))
        if name == PriorDist.STANDARD_NORMAL:
            loc, scale = 0.0, 1.0
        if name in (PriorDist.NORMAL, PriorDist.STANDARD_NORMAL):
            return cls(f_init=_normal_init(scale),
                       log_prior=_normal_logpdf_sum(loc, scale),
                       name=str(name))
        if name == PriorDist.LAPLACE:
            return cls(f_init=_laplace_init(loc, scale),
                       log_prior=_laplace_logpdf_sum(loc, scale),
                       name=str(name))
        raise NotImplementedError(f'prior {name} not implemented')


def _normal_init(scale: float):
    def init(shape, generator: torch.Generator):
        return scale * torch.randn(shape, generator=generator)

    return init


def _normal_logpdf_sum(loc: float, scale: float):
    def log_prior(theta: torch.Tensor) -> torch.Tensor:
        z = (theta - loc) / scale
        return -0.5 * torch.sum(z * z, dim=-1) - theta.shape[-1] * (
            _LOG_SQRT_2PI + math.log(scale))

    return log_prior


def _laplace_init(loc: float, scale: float):
    def init(shape, generator: torch.Generator):
        u = torch.rand(shape, generator=generator) - 0.5
        return loc - scale * torch.sign(u) * torch.log1p(-2.0 * u.abs())

    return init


def _laplace_logpdf_sum(loc: float, scale: float):
    def log_prior(theta: torch.Tensor) -> torch.Tensor:
        return -torch.sum(torch.abs(theta - loc), dim=-1) / scale \
            - theta.shape[-1] * math.log(2.0 * scale)

    return log_prior
