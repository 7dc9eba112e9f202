"""Parameter / sample persistence in the JAX package's file formats
(counterpart of ``mile_tpu/train/checkpoint.py``).

- ``params_{i}.npz``: one member, entries ``leaf_{k}`` in JAX leaf order;
- a chain's flat (n_kept, dim) draws, in either of two layouts, both read
  by :func:`load_flat_samples` here and by ``mile_tpu.train.checkpoint.
  load_flat_samples``: ``samples/chain_{c}/samples.bin`` + ``samples.meta``,
  written while sampling runs by the native sink
  (:mod:`mile_tpu_torch.native`), or ``samples/chain_{c}/samples.npy``,
  written at the end when the sink is not used;
- with ``stream_samples``, one ``samples/{c}/sample_{n}.npz`` per draw as
  well (:func:`save_samples_streaming`);
- ``warmup_params.txt`` (MCLMC only): tuned step sizes and Ls, one line
  each.

Members and draws are read back as flat numpy arrays in the same layout
(:func:`load_params`, :func:`load_params_batch`, :func:`load_flat_samples`).

The JAX package pickles its treedef beside these (a JAX object). The port
writes ``layout.json`` instead: the leaf paths and shapes of the flat
layout (a deliberate divergence, recorded in ROADMAP.md).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from mile_tpu_torch.models.layout import (
    FlatLayout,
    jax_leaves_from_flat,
    keystr,
)

LAYOUT_FILE = 'layout.json'


def save_layout(path: str | Path, layout: FlatLayout) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / LAYOUT_FILE).write_text(json.dumps(layout.to_json(), indent=1))


def save_params(path: str | Path, flat: np.ndarray, layout: FlatLayout,
                chain_id: int) -> None:
    """Save one member's flat (dim,) parameters as ``params_{chain}.npz``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves = jax_leaves_from_flat(np.asarray(flat, np.float32), layout)
    np.savez_compressed(path / f'params_{chain_id}.npz',
                        **{f'leaf_{i}': leaf for i, leaf in enumerate(leaves)})
    save_layout(path, layout)


def load_layout(path: str | Path) -> FlatLayout:
    return FlatLayout.from_json(json.loads((Path(path) / LAYOUT_FILE)
                                           .read_text()))


def load_params(path: str | Path, chain_id: int) -> np.ndarray:
    """One member's flat (dim,) parameters from ``params_{chain}.npz``:
    its ``leaf_{k}`` entries, in JAX leaf order, are the flat layout's
    consecutive slices."""
    with np.load(Path(path) / f'params_{chain_id}.npz') as data:
        return np.concatenate([data[f'leaf_{i}'].reshape(-1)
                               for i in range(len(data.files))])


def load_params_batch(path: str | Path, chain_ids) -> np.ndarray:
    """N member checkpoints stacked on a leading chain axis: (N, dim)."""
    return np.stack([load_params(path, i) for i in chain_ids])


def list_checkpoints(path: str | Path) -> list[int]:
    return sorted(
        int(p.stem.split('_')[1]) for p in Path(path).glob('params_*.npz'))


def save_chain_samples(path: str | Path, chain_id: int,
                       flat_samples: np.ndarray) -> None:
    """Write a chain's flat (n_kept, dim) sample block."""
    chain_dir = Path(path) / f'chain_{chain_id}'
    chain_dir.mkdir(parents=True, exist_ok=True)
    np.save(chain_dir / 'samples.npy', np.asarray(flat_samples))


def save_samples(path: str | Path, flat_samples: np.ndarray) -> None:
    """Save (n_chains, n_kept, dim) samples, one file per chain."""
    for c in range(flat_samples.shape[0]):
        save_chain_samples(path, c, flat_samples[c])


def save_samples_streaming(path: str | Path, chain_id: int, draw_id: int,
                           flat: np.ndarray, layout: FlatLayout) -> None:
    """The per-draw layout of the JAX package's ``stream_samples``:
    ``{path}/{chain}/sample_{n}.npz`` with one entry per leaf, in JAX leaf
    order, named as ``jax.tree_util.keystr`` names it and shaped as the
    leaf."""
    chain_dir = Path(path) / f'{chain_id}'
    chain_dir.mkdir(parents=True, exist_ok=True)
    leaves = jax_leaves_from_flat(flat, layout)
    np.savez_compressed(chain_dir / f'sample_{draw_id}.npz',
                        **{keystr(leaf.path): value for leaf, value
                           in zip(layout.leaves, leaves)})


def load_flat_samples(path: str | Path) -> np.ndarray:
    """All chains' flat samples -> (n_chains, n_kept, dim), from
    ``samples.npy`` or ``samples.bin`` + ``samples.meta``."""
    chains = sorted(Path(path).glob('chain_*'),
                    key=lambda p: int(p.name.split('_')[1]))
    if not chains:
        raise FileNotFoundError(f'no chain_* dirs under {path}')

    def load_chain(c: Path) -> np.ndarray:
        if (c / 'samples.npy').exists():
            return np.load(c / 'samples.npy')
        meta = json.loads((c / 'samples.meta').read_text())
        raw = np.fromfile(c / 'samples.bin', dtype=meta['dtype'])
        return raw.reshape(-1, meta['dim'])

    return np.stack([load_chain(c) for c in chains])


def save_warmup_params(path: str | Path, step_size, L) -> None:
    """Tuned-parameter file: line 1 = step sizes, line 2 = Ls, comma-joined."""
    step_size = np.atleast_1d(np.asarray(step_size))
    L = np.atleast_1d(np.asarray(L))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'w') as f:
        f.write(','.join(str(s) for s in step_size) + '\n')
        f.write(','.join(str(s) for s in L) + '\n')


def load_warmup_params(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    with open(path) as f:
        lines = f.read().strip().split('\n')
    return (np.array([float(v) for v in lines[0].split(',')]),
            np.array([float(v) for v in lines[1].split(',')]))
