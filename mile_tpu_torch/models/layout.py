"""The flat parameter layout shared with the JAX package.

``jax.flatten_util.ravel_pytree`` flattens a parameter tree leaf by leaf in
sorted-key order: within a Dense layer ``bias`` comes before ``kernel``,
and layer names sort as strings (``layer10`` before ``layer2``). A Flax
Dense kernel is ``(in, out)``, row-major. The port keeps exactly that
layout for its flat ``(C, dim)`` parameter tensors, its draws and its
checkpoints, so that each package can read what the other wrote.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import numpy as np


def keystr(path: str) -> str:
    """A layout path ``fcn/layer0/bias`` as ``jax.tree_util.keystr`` names
    the same leaf: ``['fcn']['layer0']['bias']``."""
    return ''.join(f'[{key!r}]' for key in path.split('/'))


class Leaf(NamedTuple):
    path: str                 # '/'-joined key path, e.g. 'fcn/layer0/bias'
    shape: tuple[int, ...]
    offset: int               # start in the flat vector

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def _walk(tree: Mapping, prefix: tuple = ()):
    """(path, value) pairs of a nested mapping in ravel_pytree order."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (key,))
        else:
            yield '/'.join(prefix + (key,)), value


class FlatLayout:
    """Leaf paths, shapes and offsets of a flat parameter vector."""

    def __init__(self, shapes: Mapping):
        """``shapes``: a nested mapping whose leaves are shape tuples."""
        leaves, offset = [], 0
        for path, shape in _walk(shapes):
            leaf = Leaf(path, tuple(int(s) for s in shape), offset)
            leaves.append(leaf)
            offset += leaf.size
        self.leaves: list[Leaf] = leaves
        self.dim = offset
        self._by_path = {leaf.path: leaf for leaf in leaves}

    def __getitem__(self, path: str) -> Leaf:
        return self._by_path[path]

    @classmethod
    def from_json(cls, data: Mapping) -> 'FlatLayout':
        """The inverse of :meth:`to_json`."""
        shapes: dict = {}
        for leaf in data['leaves']:
            *parents, name = leaf['path'].split('/')
            node = shapes
            for key in parents:
                node = node.setdefault(key, {})
            node[name] = tuple(leaf['shape'])
        layout = cls(shapes)
        if layout.dim != data['dim']:
            raise ValueError(f'layout leaves sum to {layout.dim}, the file '
                             f'says {data["dim"]}')
        return layout

    def to_json(self) -> dict:
        return {'dim': self.dim,
                'leaves': [{'path': leaf.path, 'shape': list(leaf.shape)}
                           for leaf in self.leaves]}


def flat_from_jax_params(tree: Mapping, layout: FlatLayout | None = None
                         ) -> np.ndarray:
    """A JAX ParamTree given as numpy arrays -> the flat layout.

    Without ``layout`` every leaf is one parameter block and the result is
    ``(dim,)``. With ``layout`` the paths and trailing shapes are checked
    against it, and leading axes shared by every leaf (a member or chain
    axis) are kept: leaves of shape ``(M, *shape)`` give ``(M, dim)``.
    """
    pairs = list(_walk(tree))
    if layout is None:
        return np.concatenate([np.asarray(v, np.float32).reshape(-1)
                               for _, v in pairs])
    if [p for p, _ in pairs] != [leaf.path for leaf in layout.leaves]:
        raise ValueError(f'parameter tree paths {[p for p, _ in pairs]} do '
                         f'not match the layout\'s '
                         f'{[leaf.path for leaf in layout.leaves]}')
    lead, parts = None, []
    for (path, value), leaf in zip(pairs, layout.leaves):
        value = np.asarray(value, np.float32)
        n_lead = value.ndim - len(leaf.shape)
        if n_lead < 0 or value.shape[n_lead:] != leaf.shape:
            raise ValueError(f'leaf {path} has shape {value.shape}, the '
                             f'layout {leaf.shape}')
        if lead is None:
            lead = value.shape[:n_lead]
        if value.shape[:n_lead] != lead:
            raise ValueError(f'leaf {path} has leading axes '
                             f'{value.shape[:n_lead]}, expected {lead}')
        parts.append(value.reshape(*lead, leaf.size))
    return np.concatenate(parts, axis=-1)


def jax_leaves_from_flat(flat, layout: FlatLayout) -> list[np.ndarray]:
    """A flat ``(..., dim)`` array -> its leaves in JAX leaf order, each
    shaped ``(..., *leaf.shape)``."""
    flat = np.asarray(flat)
    if flat.shape[-1] != layout.dim:
        raise ValueError(f'flat vector has {flat.shape[-1]} entries, the '
                         f'layout {layout.dim}')
    lead = flat.shape[:-1]
    return [flat[..., leaf.offset:leaf.offset + leaf.size].reshape(
        *lead, *leaf.shape) for leaf in layout.leaves]
