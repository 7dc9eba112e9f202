"""Experiment report (counterpart of ``mile_tpu/inference/reporting.py``).

``generate_report`` writes ``diagnostics.csv`` (per-leaf ESS, between- and
within-chain variance, split R-hat) and ``report.html`` (wall times,
metrics, running LPPD, warm-start curves, diagnostics, plots, warm-up
trace, tuned parameters) from a run directory's files alone, in the JAX
package's formats: ``mile_tpu``'s ``generate_report`` reads the port's run
directories and writes the same ``diagnostics.csv``.

The per-parameter diagnostics are one pass of torch ops on ``device`` (on
the card by default): FFT ESS, rank normalisation and split R-hat. The
plots need matplotlib; where it is absent each one is logged as failed and
the report is written without it.
"""
from __future__ import annotations

import base64
import html
import io
import logging
import pickle
import re
from pathlib import Path

import numpy as np
import torch

from mile_tpu_torch.inference import metrics as M
from mile_tpu_torch.models.layout import FlatLayout, keystr
from mile_tpu_torch.train import checkpoint as ckpt
from mile_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

TIME_RE = re.compile(r'(time\.\w+) took ([0-9.]+) seconds')


def parse_times(log_path: Path) -> dict:
    """``time.X took Y seconds`` lines of ``training.log`` -> {name: Y}."""
    times: dict = {}
    if log_path.exists():
        for match in TIME_RE.finditer(log_path.read_text()):
            times[match.group(1)] = float(match.group(2))
    return times


def layer_slices(layout: FlatLayout) -> dict:
    """Each leaf's name (as ``keystr``) -> its slice of the flat vector."""
    return {keystr(leaf.path): slice(leaf.offset, leaf.offset + leaf.size)
            for leaf in layout.leaves}


def per_param_diagnostics(samples: np.ndarray, max_params: int = 4096,
                          device: str | torch.device = 'cuda'
                          ) -> tuple[dict, np.ndarray]:
    """All per-parameter diagnostics in one pass on ``device`` over the flat
    draws (n_chains, n_kept, dim), subsampled to ``max_params`` evenly
    spaced coordinates. With 8 draws or more, the draws are trimmed to a
    multiple of 4 (split R-hat's 4 segments); below 8, split R-hat is NaN.

    Returns ({'ess', 'bcv', 'wcv', 'split_rhat'}: (p,) each, coordinate
    indices (p,)); per-layer summaries slice these.
    """
    n = samples.shape[1]
    if n >= 8:
        n -= n % 4
    dim = samples.shape[-1]
    coords = (np.linspace(0, dim - 1, max_params).astype(int)
              if dim > max_params else np.arange(dim))
    x = torch.from_numpy(np.ascontiguousarray(samples[:, :n][..., coords]))
    x = x.to(resolve_device(device))
    out = {'ess': M.pooled_effective_sample_size(x),
           'bcv': M.between_chain_var(x),
           'wcv': M.within_chain_var(x),
           'split_rhat': (M.gelman_split_r_hat(x, n_splits=4) if n >= 8
                          else torch.full((x.shape[-1],), float('nan')))}
    return {k: v.cpu().numpy() for k, v in out.items()}, coords


def _in_slice(coords: np.ndarray, sl: slice) -> np.ndarray:
    return ((coords >= (sl.start or 0))
            & (coords < (sl.stop if sl.stop is not None
                         else coords.max() + 1)))


def compute_diagnostics(samples: np.ndarray, layout: FlatLayout | None = None,
                        per_param=None, device: str | torch.device = 'cuda'
                        ) -> dict:
    """Per-leaf means of ESS, R-hat and between- and within-chain
    variance, with the number of diagnosed coordinates behind each row
    (``n_coords``, of ``layer_size``)."""
    if per_param is None:
        per_param = per_param_diagnostics(samples, device=device)
    vals, coords = per_param
    slices = (layer_slices(layout) if layout is not None
              else {'all': slice(None)})
    rows = {}
    for name, sl in slices.items():
        in_layer = _in_slice(coords, sl)
        if not in_layer.any():
            continue
        rows[name] = {k: float(np.nanmean(v[in_layer]))
                      for k, v in vals.items()}
        rows[name]['n_coords'] = int(in_layer.sum())
        rows[name]['layer_size'] = int(
            (sl.stop if sl.stop is not None else samples.shape[-1])
            - (sl.start or 0))
    return rows


def write_diagnostics_csv(path: Path, rows: dict) -> None:
    cols = ('ess', 'bcv', 'wcv', 'split_rhat', 'n_coords', 'layer_size')
    with open(path, 'w') as f:
        f.write('layer,' + ','.join(cols) + '\n')
        for name, r in rows.items():
            f.write(name + ',' + ','.join(str(r.get(c, '')) for c in cols)
                    + '\n')


def _fmt(v) -> str:
    if isinstance(v, float):
        return f'{v:.4f}'
    if isinstance(v, np.ndarray):
        return np.array2string(np.asarray(v), precision=4)
    return str(v)


def _table(d: dict) -> str:
    rows = ''.join(
        f'<tr><td>{html.escape(str(k))}</td>'
        f'<td>{html.escape(_fmt(v))}</td></tr>'
        for k, v in d.items())
    return f'<table border=1 cellpadding=4>{rows}</table>'


def _img(png: bytes) -> str:
    return f'<img src="data:image/png;base64,{base64.b64encode(png).decode()}"/>'


def _embed_figure(fig) -> str:
    """A matplotlib figure -> an inline <img> (base64 PNG)."""
    buf = io.BytesIO()
    fig.savefig(buf, format='png', dpi=90, bbox_inches='tight')
    return _img(buf.getvalue())


def _load_config(exp_dir: Path, config=None):
    """The config the run was launched with (``setup_dir`` dumps it)."""
    if config is not None:
        return config
    cfile = exp_dir / 'config.yaml'
    if not cfile.exists():
        return None
    from mile_tpu_torch.config import Config

    return Config.from_yaml(cfile)


def recompute_metrics(exp_dir: str | Path, config=None,
                      device: str | torch.device = 'cuda') -> dict:
    """The deep-ensemble and posterior-predictive metrics recomputed from a
    run directory alone (``config.yaml``, the warm-start members, the
    draws, ``warmup_params.txt``), as the trainer computes them."""
    from mile_tpu_torch.config.data import Task
    from mile_tpu_torch.data import build_loader
    from mile_tpu_torch.inference.evaluation import evaluate_bde, evaluate_de
    from mile_tpu_torch.train.trainer import NOMINAL_COVERAGES
    from mile_tpu_torch.utils.keys import experiment_keys

    exp_dir = Path(exp_dir)
    config = _load_config(exp_dir, config)
    if config is None:
        raise FileNotFoundError(f'no config.yaml in {exp_dir}')
    device = resolve_device(device)
    loader = build_loader(config.data, experiment_keys(config.rng).loader,
                          device, target_len=config.data.target_len,
                          tokenizer_config=config.training.tokenizer)
    model = config.get_model(loader.input_shape)
    x, y = loader.arrays('test')
    task = config.data.task
    nominal = NOMINAL_COVERAGES if task == Task.REGRESSION else None

    metrics: dict = {}
    ws_ids = ckpt.list_checkpoints(exp_dir / 'warmstart')
    if ws_ids:
        members = ckpt.load_params_batch(exp_dir / 'warmstart', ws_ids)
        _, metrics = evaluate_de(model, torch.from_numpy(members).to(device),
                                 x, y, task, n_samples=100,
                                 nominal_coverages=nominal)
    samples = ckpt.load_flat_samples(exp_dir / 'samples')
    _, metrics = evaluate_bde(model, torch.from_numpy(samples).to(device),
                              x, y, task, nominal_coverages=nominal,
                              metrics_dict=metrics)
    wp = exp_dir / 'warmup_params.txt'
    if wp.exists():
        metrics['step_size'], metrics['L'] = ckpt.load_warmup_params(wp)
    return metrics


def _running_lppd_section(running, running_pc) -> list[str]:
    from mile_tpu_torch.viz.samples import _subplots

    fig, ax = _subplots(figsize=(6, 3))
    if running_pc is not None:
        for curve in np.asarray(running_pc):
            ax.plot(curve, lw=0.7, alpha=0.4, color='grey')
    ax.plot(np.asarray(running), lw=1.8, color='#3D348B', label='pooled')
    ax.set_xlabel('draw')
    ax.set_ylabel('running LPPD')
    ax.legend(loc='lower right', fontsize=8)
    return ['<h2>Running LPPD (per chain + pooled)</h2>', _embed_figure(fig)]


def _plot_sections(samples, layout, per_param) -> list[str]:
    from mile_tpu_torch import viz

    vals, coords = per_param
    slices = (layer_slices(layout) if layout is not None
              else {'all': slice(None)})

    def by_layer(key):
        return {name: vals[key][_in_slice(coords, sl)]
                for name, sl in slices.items()}

    return ['<h2>Plots</h2>'] + [_embed_figure(fig) for fig in (
        viz.plot_param_movement(samples),
        viz.plot_param_hist(samples),
        viz.plot_pca(samples),
        viz.plot_per_layer_box(by_layer('ess'), 'effective sample size'),
        viz.plot_per_layer_box(by_layer('split_rhat'), 'split R-hat', 1.0),
        viz.plot_per_layer_box(by_layer('bcv'), 'between-chain var'),
        viz.plot_per_layer_box(by_layer('wcv'), 'within-chain var'))]


def generate_report(exp_dir: str | Path, config=None,
                    device: str | torch.device = 'cuda') -> Path:
    """Write ``report.html`` and ``diagnostics.csv`` from a run's files.

    With no ``metrics.pkl`` in the directory, the metrics are recomputed
    from the run's files and saved there. The wall times of
    ``training.log`` are merged into ``metrics.pkl``. A plot that fails is
    logged and left out."""
    exp_dir = Path(exp_dir)
    times = parse_times(exp_dir / 'training.log')
    config = _load_config(exp_dir, config)

    metrics = {}
    mfile = exp_dir / 'metrics.pkl'
    if mfile.exists():
        with open(mfile, 'rb') as f:
            metrics = pickle.load(f)
    elif config is not None and (exp_dir / 'samples').exists():
        try:
            metrics = recompute_metrics(exp_dir, config, device)
            with open(mfile, 'wb') as f:
                pickle.dump(metrics, f)
            logger.info('metrics recomputed from artifacts -> %s', mfile)
        except Exception:
            logger.exception('standalone metric recomputation failed')
    if times and not all(k in metrics for k in times):
        metrics.update(times)
        with open(mfile, 'wb') as f:
            pickle.dump(metrics, f)

    running = metrics.pop('running_lppd', None)
    running_pc = metrics.pop('running_lppd_per_chain', None)
    sections = [
        '<h1>MILE experiment report</h1>',
        f'<p>experiment dir: {html.escape(str(exp_dir))}</p>',
        '<h2>Wall times</h2>', _table(times),
        '<h2>Metrics</h2>',
        _table({k: v for k, v in metrics.items()
                if not k.startswith('time.')}),
    ]
    if running is not None:
        try:
            sections += _running_lppd_section(running, running_pc)
        except Exception:
            logger.exception('running LPPD plot failed')
    ws_png = exp_dir / 'warmstart' / 'warmstart_curves.png'
    if ws_png.exists():
        sections += ['<h2>Warmstart curves</h2>', _img(ws_png.read_bytes())]

    try:
        samples = ckpt.load_flat_samples(exp_dir / 'samples')
        layout = None   # names the per-layer rows
        if (exp_dir / 'samples' / ckpt.LAYOUT_FILE).exists():
            layout = ckpt.load_layout(exp_dir / 'samples')
        per_param = per_param_diagnostics(samples, device=device)
        diag = compute_diagnostics(samples, layout, per_param)
        write_diagnostics_csv(exp_dir / 'diagnostics.csv', diag)
        sections += ['<h2>Chain diagnostics (per layer)</h2>',
                     _table({k: f"ESS={v['ess']:.1f} R-hat={v['split_rhat']:.3f} "
                                f"BCV={v['bcv']:.4g} WCV={v['wcv']:.4g} "
                                f"(n={v['n_coords']}/{v['layer_size']})"
                             for k, v in diag.items()})]
        try:
            sections += _plot_sections(samples, layout, per_param)
        except Exception:
            logger.exception('plot rendering failed')
    except FileNotFoundError:
        logger.info('no samples found; skipping diagnostics section')

    warmup_dir = exp_dir / 'warmup_samples'
    if warmup_dir.exists():
        try:
            from mile_tpu_torch import viz

            trace = ckpt.load_flat_samples(warmup_dir)
            sections += ['<h2>Warmup adaptation trajectory (thinned)</h2>',
                         _embed_figure(viz.plot_param_movement(trace))]
        except Exception:
            logger.exception('warmup trace plot failed')

    wp = exp_dir / 'warmup_params.txt'
    if wp.exists():
        eps, L = ckpt.load_warmup_params(wp)
        sections += ['<h2>Tuned sampler parameters</h2>',
                     _table({'step_size mean±std':
                             f'{eps.mean():.4g} ± {eps.std():.4g}',
                             'L mean±std': f'{L.mean():.4g} ± {L.std():.4g}'})]

    out = exp_dir / 'report.html'
    out.write_text('<html><body>' + '\n'.join(sections) + '</body></html>')
    logger.info('report written to %s', out)
    return out
