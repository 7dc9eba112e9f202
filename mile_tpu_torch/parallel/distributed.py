"""Multi-process runs (counterpart of ``mile_tpu/parallel/distributed.py``).

Call :func:`initialize_distributed` once per process before building the
mesh. Every rank then runs the same sampler loop on the same state (the
SPMD pattern of JAX's multi-controller runtime): the chains axis of a mesh
built with the process group spans the ranks, each rank computes the
value and gradient of its own chain rows, and an ``all_gather`` gives
every rank the whole batch's. Rank 0 makes the experiment directory and
does every write, apart from the ``torch.distributed.checkpoint`` files,
which all ranks write together. At each drained chunk the ranks compare a
digest of their draws (:func:`check_in_step`) and raise on a mismatch.

The collectives run on gloo unless another backend is asked for: NCCL
needs each rank to own its own GPU.
"""
from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_ENV = ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE')


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = 'gloo') -> bool:
    """Join the process group: at ``tcp://coordinator_address`` (``host:
    port``) as rank ``process_id`` of ``num_processes``, or from
    ``torchrun``'s environment (``env://``). With neither configured it
    logs that and returns False: the run is single-process. A configured
    group that cannot be joined raises. True once joined (or when this
    process already was)."""
    if dist.is_initialized():
        return True
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError('a coordinator address needs num_processes '
                             'and process_id')
        address = coordinator_address.removeprefix('tcp://')
        dist.init_process_group(backend, init_method=f'tcp://{address}',
                                world_size=num_processes, rank=process_id)
    elif all(k in os.environ for k in _ENV):
        dist.init_process_group(backend, init_method='env://')
    else:
        logger.info('torch.distributed not initialized (no coordinator '
                    'address and no %s in the environment); running '
                    'single-process', '/'.join(_ENV))
        return False
    logger.info('torch.distributed initialized (%s): process %d/%d',
                backend, dist.get_rank(), dist.get_world_size())
    return True


def process_group():
    """The default process group, or None in a single-process run."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def is_primary_host() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _on_backend(tensor: torch.Tensor, group) -> torch.Tensor:
    """``tensor`` where the group's backend takes it: gloo on the CPU."""
    if dist.get_backend(group) == 'gloo':
        return tensor.cpu()
    return tensor


def all_gather_rows(block: torch.Tensor, counts: list[int],
                    group) -> torch.Tensor:
    """Every rank's ``block`` (``counts[r]`` rows of rank ``r``), stacked
    in rank order on ``block``'s device. Blocks are padded to the longest
    for the collective."""
    longest = max(counts)
    pad = block.new_zeros((longest - block.shape[0], *block.shape[1:]))
    send = _on_backend(torch.cat([block, pad]), group)
    parts = [torch.empty_like(send) for _ in counts]
    dist.all_gather(parts, send, group=group)
    return torch.cat([p[:n] for p, n in zip(parts, counts)]).to(block.device)


def broadcast_tensor(tensor: Optional[torch.Tensor], shape, dtype,
                     device, group) -> torch.Tensor:
    """Rank 0's ``tensor`` on every rank (the others pass None)."""
    if dist.get_rank(group) == 0:
        buf = _on_backend(tensor.to(dtype), group).contiguous()
    else:
        buf = _on_backend(torch.empty(shape, dtype=dtype, device=device),
                          group)
    dist.broadcast(buf, src=0, group=group)
    return buf.to(device)


def broadcast_object(obj, group):
    """Rank 0's picklable ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def digest(array: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def check_in_step(array: np.ndarray, group, what: str = 'draws') -> None:
    """Raise unless every rank of ``group`` holds the same ``array`` (the
    ranks run one sampler loop on identical state; ranks that diverged
    would sample different things without any other sign)."""
    digests = [None] * dist.get_world_size(group)
    dist.all_gather_object(digests, digest(array), group=group)
    if len(set(digests)) != 1:
        raise RuntimeError(
            f'the ranks\' {what} differ (sha256 by rank: '
            f'{[d[:12] for d in digests]}): the processes are out of step')
