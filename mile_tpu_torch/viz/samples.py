"""Sample and diagnostic plots (counterpart of ``mile_tpu/viz/samples.py``):
trace plots, histograms, PCA projections, per-layer ESS / R-hat / variance
boxplots, warm-start curves and the running LPPD. Each returns a
:class:`matplotlib.figure.Figure` that no pyplot figure manager holds, so
callers save or embed it and need not close it.

matplotlib (with the ``Agg`` backend) is imported inside each function:
``import mile_tpu_torch.viz`` works where matplotlib is absent, and a plot
asked for there raises ``ImportError``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from mile_tpu_torch.inference import metrics as M


def _figure(figsize=None):
    import matplotlib

    matplotlib.use('Agg')
    from matplotlib.figure import Figure

    return Figure(figsize=figsize)


def _subplots(nrows=1, ncols=1, figsize=None, squeeze=True):
    fig = _figure(figsize)
    return fig, fig.subplots(nrows, ncols, squeeze=squeeze)


def _chains_first(samples) -> np.ndarray:
    samples = np.asarray(samples)
    return samples[None] if samples.ndim == 2 else samples


def _rotate_labels(ax) -> None:
    for label in ax.get_xticklabels():
        label.set_rotation(30)
        label.set_ha('right')
        label.set_fontsize(7)


def plot_param_movement(samples, param_ids: Sequence[int] = (0, 1, 2),
                        ax=None):
    """Trace plot: per-chain trajectories of selected parameters."""
    samples = _chains_first(samples)
    if ax is None:
        _, ax = _subplots(figsize=(8, 4))
    for p in param_ids:
        for c in range(samples.shape[0]):
            ax.plot(samples[c, :, p], alpha=0.6, lw=0.8,
                    label=f'chain{c}/θ{p}' if c == 0 else None)
    ax.set_xlabel('draw')
    ax.set_ylabel('value')
    ax.legend(fontsize=7)
    return ax.figure


def plot_param_hist(samples, param_ids: Sequence[int] = (0, 1, 2),
                    bins: int = 40):
    """Pooled posterior histograms of selected parameters."""
    samples = _chains_first(samples)
    fig, axes = _subplots(1, len(param_ids),
                          figsize=(3 * len(param_ids), 3))
    for ax, p in zip(np.atleast_1d(axes), param_ids):
        ax.hist(samples[:, :, p].ravel(), bins=bins, density=True)
        ax.set_title(f'θ{p}')
    fig.tight_layout()
    return fig


def plot_pca(samples, n_components: int = 2):
    """PCA projection of draws, colored by chain (2d or 3d)."""
    samples = _chains_first(samples)
    c, s, d = samples.shape
    flat = samples.reshape(c * s, d)
    centered = flat - flat.mean(axis=0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    proj = (centered @ vt[:n_components].T).reshape(c, s, n_components)
    fig = _figure((5, 4))
    if n_components == 3:
        ax = fig.add_subplot(projection='3d')
        for ci in range(c):
            ax.scatter(*proj[ci].T, s=2, alpha=0.5, label=f'chain {ci}')
    else:
        ax = fig.add_subplot()
        for ci in range(c):
            ax.scatter(proj[ci, :, 0], proj[ci, :, 1], s=2, alpha=0.5,
                       label=f'chain {ci}')
    ax.legend(fontsize=7)
    ax.set_title('sample PCA')
    return fig


def plot_per_layer_box(values_by_layer: dict, ylabel: str,
                       hline: Optional[float] = None):
    """Boxplot of precomputed per-parameter values grouped by layer."""
    fig, ax = _subplots(figsize=(max(4, 1.2 * len(values_by_layer)), 3.5))
    ax.boxplot(list(values_by_layer.values()),
               tick_labels=list(values_by_layer.keys()))
    if hline is not None:
        ax.axhline(hline, color='r', ls='--', lw=1)
    ax.set_ylabel(ylabel)
    _rotate_labels(ax)
    fig.tight_layout()
    return fig


def _layer_values(samples, layer_slices: Optional[dict], fn) -> dict:
    """``fn`` (torch in, torch out) of each layer's draws, as flat numpy."""
    x = torch.from_numpy(np.ascontiguousarray(_chains_first(samples)))
    if layer_slices is None:
        return {'all': fn(x).numpy().ravel()}
    return {name: fn(x[:, :, sl]).numpy().ravel()
            for name, sl in layer_slices.items()}


def plot_effective_sample_size(samples, layer_slices: Optional[dict] = None):
    return plot_per_layer_box(
        _layer_values(samples, layer_slices, M.pooled_effective_sample_size),
        'effective sample size', None)


def plot_split_chain_r_hat(samples, layer_slices: Optional[dict] = None,
                           n_splits: int = 4):
    return plot_per_layer_box(
        _layer_values(samples, layer_slices,
                      lambda x: M.gelman_split_r_hat(x, n_splits)),
        'split R-hat', 1.0)


def plot_variances(samples, layer_slices: Optional[dict] = None):
    """Between- vs within-chain variance per layer."""
    bcv = _layer_values(samples, layer_slices, M.between_chain_var)
    wcv = _layer_values(samples, layer_slices, M.within_chain_var)
    fig, axes = _subplots(1, 2, figsize=(10, 3.5))
    for ax, (vals, title) in zip(
            axes, [(bcv, 'between-chain var'), (wcv, 'within-chain var')]):
        ax.boxplot(list(vals.values()), tick_labels=list(vals.keys()))
        ax.set_ylabel(title)
        _rotate_labels(ax)
    fig.tight_layout()
    return fig


def plot_lppd(lppd_pointwise):
    """Running LPPD over draws (pooled over chains)."""
    running = M.running_lppd(torch.as_tensor(np.asarray(lppd_pointwise)))
    fig, ax = _subplots(figsize=(6, 3.5))
    ax.plot(running.numpy())
    ax.set_xlabel('draw')
    ax.set_ylabel('running LPPD')
    fig.tight_layout()
    return fig


def plot_warmstart_results(store, keys: Sequence[str] = None):
    """Collage of warm-start training curves per metric (train/valid)."""
    keys = keys or [k for k in store.train.__dict__ if k != 'step']
    fig, axes = _subplots(len(keys), 2, figsize=(9, 3 * len(keys)),
                          squeeze=False)
    for row, key in enumerate(keys):
        for col, split in enumerate(('train', 'valid')):
            metric = getattr(store, split)
            vals = np.asarray(getattr(metric, key))
            if vals.size == 0:
                continue
            ax = axes[row][col]
            for c in range(vals.shape[0]):
                ax.plot(vals[c], alpha=0.7, lw=0.9)
            ax.set_title(f'{split} {key}', fontsize=9)
            ax.set_xlabel('epoch')
    fig.tight_layout()
    return fig
