"""Sharded-capable ensemble checkpoints for ``checkpoint_format: orbax``
(counterpart of ``mile_tpu/train/checkpoint_orbax.py``), on
``torch.distributed.checkpoint`` (DCP).

``save_ensemble(path, params, step)`` writes ``path/step_{step}/`` (DCP's
``.metadata`` and ``*.distcp`` files); ``load_ensemble(path)`` reads the
latest step back. ``params`` is a (nested) dict of tensors or numpy
arrays. In a multi-process run every rank calls both together (DCP plans
the writes over the ranks); with no process group, or ``collective=False``
(the sampler snapshot, which rank 0 writes alone), they run in this
process only.

The directory layout is the JAX package's; the files are not. A
``step_*`` directory written by the JAX package (orbax and tensorstore,
which the port does not use) has no DCP ``.metadata``, and loading it
raises a ``ValueError`` that says so.
"""
from __future__ import annotations

import logging
import shutil
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_DCP_METADATA = '.metadata'
_SEP = '/'


def _collective(collective: Optional[bool]) -> bool:
    if collective is None:
        return dist.is_initialized() and dist.get_world_size() > 1
    return collective


def _flatten(tree: dict, prefix: str = '') -> dict:
    flat = {}
    for key, value in tree.items():
        name = f'{prefix}{key}'
        if isinstance(value, dict):
            flat.update(_flatten(value, name + _SEP))
        else:
            flat[name] = (torch.from_numpy(np.ascontiguousarray(value))
                          if isinstance(value, np.ndarray)
                          else torch.as_tensor(value))
    return flat


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        *parents, leaf = name.split(_SEP)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _dcp(fn, collective: bool, **kwargs):
    import torch.distributed.checkpoint as dcp

    if collective:
        return getattr(dcp, fn)(**kwargs)
    with warnings.catch_warnings():   # "assuming ... a single process"
        warnings.simplefilter('ignore', UserWarning)
        return getattr(dcp, fn)(no_dist=True, **kwargs)


def save_ensemble(path: str | Path, params: dict, step: int = 0,
                  collective: Optional[bool] = None) -> Path:
    """Write ``params`` as ``path/step_{step}/``, replacing that step if
    it exists (written beside it first, then moved over it)."""
    collective = _collective(collective)
    primary = not collective or dist.get_rank() == 0
    target = Path(path).absolute() / f'step_{step}'
    tmp = target.with_name(target.name + '.tmp')
    if primary:
        shutil.rmtree(tmp, ignore_errors=True)
    if collective:
        dist.barrier()
    state = {k: v.detach().cpu().contiguous()
             for k, v in _flatten(params).items()}
    _dcp('save', collective, state_dict=state, checkpoint_id=str(tmp))
    if primary:
        old = target.with_name(target.name + '.old')
        if target.exists():
            target.rename(old)
        tmp.rename(target)
        shutil.rmtree(old, ignore_errors=True)
    if collective:
        dist.barrier()
    logger.info('DCP checkpoint written to %s', target)
    return target


def latest_step(path: str | Path) -> int:
    steps = sorted(int(p.name.split('_')[1]) for p in Path(path).glob('step_*')
                   if p.name.split('_')[1].isdigit())
    if not steps:
        raise FileNotFoundError(f'no orbax-format checkpoints under {path}')
    return steps[-1]


def load_ensemble(path: str | Path, template: Optional[dict] = None,
                  step: Optional[int] = None,
                  collective: Optional[bool] = None) -> dict:
    """The checkpoint at ``path/step_{step}`` (the latest step when None)
    as the nested dict that was saved: on the CPU, or with the shapes,
    types and devices of ``template``'s tensors."""
    from torch.distributed.checkpoint import FileSystemReader

    path = Path(path).absolute()
    directory = path / f'step_{latest_step(path) if step is None else step}'
    if not (directory / _DCP_METADATA).exists():
        raise ValueError(
            f'{directory} holds no torch.distributed.checkpoint metadata: '
            f'it was written by the JAX package (mile_tpu, with orbax), '
            f'whose orbax-format checkpoints the PyTorch port cannot read. '
            f'Reuse that run\'s warmstart/params_*.npz (checkpoint_format: '
            f'npz), or rerun its warm start with the port')
    metadata = FileSystemReader(str(directory)).read_metadata()
    if template is not None:
        state = {k: torch.empty_like(v) for k, v in _flatten(template).items()}
    else:
        state = {k: torch.empty(m.size, dtype=m.properties.dtype)
                 for k, m in metadata.state_dict_metadata.items()}
    _dcp('load', _collective(collective), state_dict=state,
         checkpoint_id=str(directory))
    return _unflatten(state)
