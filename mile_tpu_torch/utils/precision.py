"""Float32 matmul precision, scoped per phase.

The JAX package sets XLA's matmul precision per phase (``sampler.
matmul_precision``, ``sampler.warmup_matmul_precision``). The port maps the
same config values onto ``torch.set_float32_matmul_precision``:

- ``'float32'`` -> ``'highest'``: full float32 (TF32 off);
- ``'tensorfloat32'`` -> ``'high'``: TF32 tensor cores allowed;
- ``'bfloat16'`` -> ``'medium'``: reduced-precision internal products allowed;
- ``None`` -> ``'highest'``, PyTorch's own default.

cuDNN's TF32 switch (on by default, for convolutions) is set off inside
every scope, so a float32 reference stays float32 throughout.

The rule for every phase: each runs inside a scope (the warm start and the
evaluation in ``'float32'``, the tuner in ``warmup_matmul_precision``, the
draws in ``matmul_precision``), so convolutions are float32 in every phase
and matmuls are float32 unless the sampler's config asks for TF32. No
work of the port runs under PyTorch's process-wide defaults, where cuDNN
would take TF32 for the convolutions while matmuls stay float32.
"""
from __future__ import annotations

import contextlib

import torch

_TORCH_PRECISION = {None: 'highest', 'float32': 'highest',
                    'tensorfloat32': 'high', 'bfloat16': 'medium'}


@contextlib.contextmanager
def matmul_precision(precision: str | None):
    prev = torch.get_float32_matmul_precision()
    prev_cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision(_TORCH_PRECISION[precision])
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cudnn.allow_tf32 = prev_cudnn
