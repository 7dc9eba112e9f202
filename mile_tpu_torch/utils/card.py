"""The card's peak rates and the line that names it.

The peaks are an H100 SXM's (NVIDIA's data sheet, dense, at its 700 W
limit): what a share of the peak (an MFU, a roofline share) is computed
against. A card set below 700 W runs slower under load, so every number
kept beside a peak names the card and its power limit (:func:`card_line`).
"""
from __future__ import annotations

import subprocess

# FLOP/s by what the matmuls run in: float32 outside the tensor cores,
# TF32 and BF16 on them
PEAK_FLOPS = {'float32': 67e12, 'tensorfloat32': 494.7e12,
              'bfloat16': 989.4e12}
HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
