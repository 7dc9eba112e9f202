"""Data-path resolution (counterpart of ``mile_tpu/data/base.py``)."""
from __future__ import annotations

from pathlib import Path
from typing import Literal

Split = Literal['train', 'valid', 'test']

_REPO_ROOT = Path(__file__).resolve().parents[2]


def resolve_data_path(path: str | Path) -> Path:
    """Resolve a data path against cwd, then the repo root."""
    p = Path(path)
    if p.exists():
        return p
    alt = _REPO_ROOT / p
    if alt.exists():
        return alt
    raise FileNotFoundError(f'data file not found: {path} (also tried {alt})')
