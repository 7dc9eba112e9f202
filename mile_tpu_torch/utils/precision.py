"""Matmul arithmetic, scoped per phase.

The JAX package sets XLA's matmul precision per phase (``sampler.
matmul_precision``, ``sampler.warmup_matmul_precision``). A scope here
names the arithmetic of the models' products, as those config values name
it on the TPU:

- ``'float32'``: exact float32 (TF32 off);
- ``'bfloat16'``: one bfloat16 pass, XLA's ``DEFAULT`` on a TPU: each
  operand of a product is rounded to bfloat16 (to nearest, ties to even),
  the products are exact and the sums and the result float32. The models'
  products read it through :func:`arithmetic`
  (:func:`mile_tpu_torch.models.blocks.product` and ``conv``);
- ``'tensorfloat32'``: TF32 tensor cores allowed (torch's ``'high'``). On
  the TPU XLA's ``HIGH`` is three bfloat16 passes; no JAX row or config
  uses it, so the port keeps TF32 for it;
- ``None``: the process-wide :func:`none_precision`, ``'float32'`` unless
  a runner sets it (``--tpu-arithmetic``: ``'bfloat16'``, the arithmetic
  of a scope-less phase on the TPU, where the JAX package's studies ran).

cuDNN's TF32 switch (on by default, for convolutions) is set off inside
every scope, so a float32 reference stays float32 throughout.

The rule for every phase: each runs inside a scope (the evaluation and
NUTS/HMC in ``'float32'``, the warm start in ``None``, the tuner in
``warmup_matmul_precision``, the draws in ``matmul_precision``), so no
work of the port runs under PyTorch's process-wide defaults, where cuDNN
would take TF32 for the convolutions while matmuls stay float32.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ('float32', 'bfloat16', 'tensorfloat32')
_TORCH_PRECISION = {'float32': 'highest', 'bfloat16': 'highest',
                    'tensorfloat32': 'high'}

_none = 'float32'       # what a None precision stands for
_active = 'float32'     # the arithmetic of the innermost scope


def _check(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f'precision must be one of None/'
                         f'{"/".join(map(repr, PRECISIONS))}, got '
                         f'{precision!r}')
    return precision


def set_none_precision(precision: str) -> None:
    """Make a ``None`` precision stand for ``precision`` in this process."""
    global _none
    _none = _check(precision)


def none_precision() -> str:
    """The arithmetic a ``None`` precision stands for in this process."""
    return _none


def arithmetic() -> str:
    """The arithmetic of the innermost scope (``'float32'`` outside any)."""
    return _active


def resolve(precision: str | None) -> str:
    """The arithmetic a scope of ``precision`` runs at."""
    return _none if precision is None else _check(precision)


@contextlib.contextmanager
def matmul_precision(precision: str | None):
    global _active
    arith = resolve(precision)
    prev = torch.get_float32_matmul_precision()
    prev_cudnn = torch.backends.cudnn.allow_tf32
    prev_active = _active
    torch.set_float32_matmul_precision(_TORCH_PRECISION[arith])
    torch.backends.cudnn.allow_tf32 = False
    _active = arith
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cudnn.allow_tf32 = prev_cudnn
        _active = prev_active
