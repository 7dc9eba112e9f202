"""Chain-axis device mesh (counterpart of ``mile_tpu/parallel/mesh.py``).

A :class:`ChainMesh` is a grid of ``torch.device`` entries with the axes
``('chains',)`` or ``('chains', 'data')``. The sampler's chain batch, its
tuner, the kernels K1 and K3 and all its randomness stay on the mesh's
first device; the mesh shards only the log-posterior's value and gradient
(:mod:`mile_tpu_torch.bayes.sharded`): chain rows over the ``chains`` axis,
training rows over the ``data`` axis. Entries may repeat (``['cpu'] * 8``,
``['cuda:0'] * 2``): the port's counterpart of the JAX package's
``--xla_force_host_platform_device_count``.

Across processes (:mod:`mile_tpu_torch.parallel.distributed`) the chains
axis spans the ranks: each rank holds the same local grid, computes the
rows of its own entries, and an ``all_gather`` gives every rank the whole
batch's value and gradient.

The two count functions are copies of the JAX package's, with the device
count as an argument where JAX reads ``jax.devices()``.
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence

import torch

CHAIN_AXIS = 'chains'
DATA_AXIS = 'data'

logger = logging.getLogger(__name__)


class ChainMesh:
    """A grid of devices: ``grid[i][j]`` computes chain shard ``i`` (of
    this process) over data shard ``j``. ``group``: the process group the
    chains axis spans (None: this process alone)."""

    def __init__(self, grid: Sequence[Sequence], axis_names: tuple,
                 group=None):
        self.grid = tuple(tuple(torch.device(d) for d in row) for row in grid)
        widths = {len(row) for row in self.grid}
        if not self.grid or len(widths) != 1 or 0 in widths:
            raise ValueError(f'a mesh needs a non-empty rectangular grid, '
                             f'got {grid}')
        if tuple(axis_names) not in ((CHAIN_AXIS,), (CHAIN_AXIS, DATA_AXIS)) \
                or (len(axis_names) == 1 and widths != {1}):
            raise ValueError(f'axes {axis_names} do not fit a grid of '
                             f'{len(self.grid)} x {widths.pop()}')
        self.axis_names = tuple(axis_names)
        self.group = group
        if group is not None:
            import torch.distributed as dist

            self.n_procs = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        else:
            self.n_procs, self.rank = 1, 0

    @property
    def shape(self) -> dict:
        """Entries along each axis, the chains axis over all processes."""
        out = {CHAIN_AXIS: self.n_procs * len(self.grid)}
        if DATA_AXIS in self.axis_names:
            out[DATA_AXIS] = len(self.grid[0])
        return out

    @property
    def size(self) -> int:
        """Entries of the whole mesh (over all processes)."""
        return self.n_procs * len(self.grid) * len(self.grid[0])

    @property
    def first(self) -> torch.device:
        """The device of the chain batch, its kernels and its randomness."""
        return self.grid[0][0]

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def __repr__(self) -> str:
        procs = f' x {self.n_procs} processes' if self.group else ''
        return (f'ChainMesh({dict(self.shape)}{procs}: '
                f'{[[str(d) for d in row] for row in self.grid]})')


def local_devices(device: str | torch.device = 'cuda',
                  n_devices: Optional[int] = None) -> list[torch.device]:
    """The device entries of this process: ``n_devices`` CUDA devices
    (default: every visible one), or ``n_devices`` CPU entries (default 1)
    for ``device='cpu'``. Asking for more CUDA devices than are visible
    raises: the port never runs on fewer devices than asked for."""
    dev = torch.device(device)
    if dev.type == 'cpu':
        return [dev] * (n_devices or 1)
    if dev.type != 'cuda':
        raise ValueError(f'no mesh over {dev.type} devices')
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0:
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" '
            '(--device cpu) to run the port on the CPU')
    # from the named device on; every visible device by default
    first = dev.index or 0
    want = n_devices or (1 if dev.index is not None else have)
    if first + want > have:
        raise RuntimeError(
            f'{want} CUDA device(s) from cuda:{first} were asked for and '
            f'{have} are visible: the port does not run on fewer devices '
            f'than asked for')
    return [torch.device('cuda', first + i) for i in range(want)]


def chain_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None, group=None) -> ChainMesh:
    """1-D mesh over the first ``n_devices`` (global, over the processes
    of ``group``) of ``devices`` (this process's entries; default: every
    visible CUDA device)."""
    if devices is None:
        devices = local_devices()
    n_procs = _procs(group)
    local = len(devices) if n_devices is None else -(-n_devices // n_procs)
    if local > len(devices):
        raise ValueError(f'chain_mesh needs {local} devices in each process, '
                         f'have {len(devices)}')
    return ChainMesh([[d] for d in devices[:local]], (CHAIN_AXIS,), group)


def chain_data_mesh(n_chain_devices: int, n_data_devices: int,
                    devices: Optional[Sequence] = None,
                    group=None) -> ChainMesh:
    """2-D ``(chains, data)`` mesh: ``n_chain_devices`` chain shards (over
    the processes of ``group``), each over ``n_data_devices`` data shards
    whose log-likelihoods are summed (``devices`` as in
    :func:`chain_mesh`)."""
    if devices is None:
        devices = local_devices()
    local = -(-n_chain_devices // _procs(group))
    need = local * n_data_devices
    if len(devices) < need:
        raise ValueError(
            f'chain_data_mesh needs {need} devices '
            f'({local} chains x {n_data_devices} data), have {len(devices)}')
    grid = [list(devices[i * n_data_devices:(i + 1) * n_data_devices])
            for i in range(local)]
    return ChainMesh(grid, (CHAIN_AXIS, DATA_AXIS), group)


def _procs(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def pick_chain_device_count(n_chains: int, max_devices: int,
                            quiet: bool = False) -> int:
    """Largest device count that divides ``n_chains`` (a copy of the JAX
    package's), warning when devices stay idle."""
    avail = max_devices
    cap = min(avail, n_chains)
    n = cap
    while n_chains % n != 0:
        n -= 1
    if n < cap and not quiet:
        logger.warning(
            '%d chains do not divide over %d devices; using %d device(s), '
            '%d idle. Pick n_chains as a multiple of the device count '
            '(sampling pads the chain batch automatically).',
            n_chains, avail, n, avail - n)
    return n


def padded_chain_count(n_chains: int, max_devices: int) -> int:
    """Chain count to run so every device is used (a copy of the JAX
    package's): the smallest multiple of the device count at least
    ``n_chains``, when that shrinks the per-device batch against the
    largest-divisor mesh; else ``n_chains``."""
    avail = max_devices
    n_div = pick_chain_device_count(n_chains, max_devices, quiet=True)
    if avail <= 0 or n_chains <= avail:
        return n_chains
    padded = -(-n_chains // avail) * avail
    if padded // avail < n_chains // n_div:
        return padded
    return n_chains


def split_bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """``(start, end)`` of ``parts`` contiguous blocks of ``n`` rows, the
    first ``n % parts`` one row longer (``numpy.array_split``'s rule);
    blocks may be empty."""
    base, extra = divmod(n, parts)
    bounds, start = [], 0
    for i in range(parts):
        end = start + base + (i < extra)
        bounds.append((start, end))
        start = end
    return bounds
