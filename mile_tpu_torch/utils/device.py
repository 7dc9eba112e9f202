"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = 'cuda') -> torch.device:
    """The device an entry point computes on.

    The default is the GPU. Without a CUDA device this raises rather than
    running on the CPU unasked: the caller asks for the CPU explicitly
    (``device='cpu'``, ``--device cpu``), as the tests do.
    """
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" '
            '(--device cpu) to run the port on the CPU')
    return dev
