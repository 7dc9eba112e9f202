"""Posterior-predictive evaluation for DE and BDE models
(counterpart of ``mile_tpu/inference/evaluation.py``).

Prediction runs the flat-parameter network over (chain × sample) batches
of draws, chunked over samples and observations so that transient
activations fit a byte budget. The JAX package plans the chunks by tracing
a jaxpr and summing every intermediate of one (sample, observation) pair;
the port counts the same intermediates analytically (each model's
``activation_floats``), so that it never plans a larger chunk than the JAX
package for the same budget. Evaluation runs in exact float32.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from mile_tpu_torch.config.data import Task
from mile_tpu_torch.inference import metrics as M
from mile_tpu_torch.utils.precision import matmul_precision

logger = logging.getLogger(__name__)

#: default byte budget for transient prediction memory
DEFAULT_EVAL_MEMORY_BUDGET = 4 * 1024 ** 3
_EVAL_SEED = 42


def plan_eval_chunks(model, n_obs: int, n_samples: int,
                     sample_batch: int = 256,
                     memory_budget_bytes: int = DEFAULT_EVAL_MEMORY_BUDGET,
                     ) -> tuple[int, int]:
    """(sample_chunk, obs_chunk) such that a chunk's activations fit
    ``memory_budget_bytes``: the observation axis shrinks first, the sample
    axis only if a single observation still exceeds the budget."""
    s_chunk = max(1, min(sample_batch, n_samples))
    # float32 bytes per (sample, obs): the activations, and the parameter
    # vector split into its leaves and their kernels reshaped (at most 2 dim
    # floats), which the JAX package's traced count charges to every pair
    unit = 4 * (model.activation_floats() + 2 * model.dim)
    obs_chunk = int(memory_budget_bytes // (s_chunk * unit))
    if obs_chunk < 1:
        s_chunk = max(1, int(memory_budget_bytes // unit))
        obs_chunk = 1
    obs_chunk = min(obs_chunk, n_obs)
    if obs_chunk < n_obs or s_chunk < min(sample_batch, n_samples):
        logger.info('evaluation chunked to %d samples x %d observations',
                    s_chunk, obs_chunk)
    return s_chunk, obs_chunk


@torch.no_grad()
def predict_from_flat(model, flat_samples: torch.Tensor, x: torch.Tensor,
                      sample_batch: int = 256,
                      memory_budget_bytes: int = DEFAULT_EVAL_MEMORY_BUDGET,
                      ) -> torch.Tensor:
    """(S, dim) flat draws -> (S, N, out) network outputs, in float32."""
    n_samples = flat_samples.shape[0]
    s_chunk, obs_chunk = plan_eval_chunks(model, x.shape[0], n_samples,
                                          sample_batch, memory_budget_bytes)
    with matmul_precision('float32'):
        outs = [torch.cat([model(flat_samples[i:i + s_chunk],
                                 x[j:j + obs_chunk])
                           for j in range(0, x.shape[0], obs_chunk)], dim=1)
                for i in range(0, n_samples, s_chunk)]
    return torch.cat(outs, dim=0)


def predict_bde(model, samples: torch.Tensor, x: torch.Tensor,
                sample_batch: int = 256,
                memory_budget_bytes: int = DEFAULT_EVAL_MEMORY_BUDGET,
                ) -> torch.Tensor:
    """(C, S, dim) draws -> (C, S, N, out)."""
    c, s, dim = samples.shape
    preds = predict_from_flat(model, samples.reshape(c * s, dim), x,
                              sample_batch, memory_budget_bytes)
    return preds.reshape(c, s, *preds.shape[1:])


def sample_from_predictions(predictions: torch.Tensor, task: Task,
                            generator: torch.Generator) -> torch.Tensor:
    """Draw point predictions from the predictive distribution."""
    if task == Task.REGRESSION:
        loc = predictions[..., 0]
        scale = torch.clamp(torch.exp(predictions[..., 1]), 1e-6, 1e6)
        noise = torch.randn(loc.shape, generator=generator).to(loc.device)
        return loc + scale * noise
    gumbel = -torch.log(-torch.log(torch.rand(
        predictions.shape, generator=generator).clamp_min(1e-20)))
    return torch.argmax(predictions + gumbel.to(predictions.device), dim=-1)


# ------------------------------------------------------------ calibration
def calibration_error(nominal, observed) -> torch.Tensor:
    nominal = torch.as_tensor(nominal, dtype=torch.float32)
    observed = torch.as_tensor(observed, dtype=torch.float32)
    return torch.sqrt(torch.mean(torch.square(nominal - observed)))


def _quantiles(x: torch.Tensor, qs: list[float]) -> torch.Tensor:
    """Linear-interpolation quantiles along dim 0 (numpy's default)."""
    s = torch.sort(x, dim=0).values
    n = s.shape[0]
    out = []
    for q in qs:
        pos = q * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        out.append(s[lo] + (pos - lo) * (s[hi] - s[lo]))
    return torch.stack(out)


def calculate_coverage(nominal_coverages, y: torch.Tensor,
                       preds: torch.Tensor) -> torch.Tensor:
    """Empirical coverage of central credible intervals; ``preds``:
    sampled point predictions (n_chains, n_samples, N)."""
    flat = preds.reshape(-1, preds.shape[-1])
    out = []
    for cov in nominal_coverages:
        lo, hi = _quantiles(flat, [0.5 - cov / 2, 0.5 + cov / 2])
        out.append(((lo <= y) & (y <= hi)).float().mean())
    return torch.stack(out).cpu()


def _majority_vote(draws: np.ndarray, axis: tuple) -> np.ndarray:
    """Mode over the given leading axes of integer class draws."""
    moved = np.moveaxis(np.asarray(draws), axis, tuple(range(len(axis))))
    flat = moved.reshape(-1, *moved.shape[len(axis):])  # (votes, N)
    one_hot = np.eye(int(flat.max()) + 1, dtype=np.int64)[flat]
    return one_hot.sum(axis=0).argmax(axis=-1)


def _eval_generator(generator):
    return torch.Generator().manual_seed(_EVAL_SEED) if generator is None \
        else generator


# -------------------------------------------------------------- evaluation
def evaluate_bde(model, samples: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor, task: Task,
                 generator: Optional[torch.Generator] = None,
                 nominal_coverages: Optional[list] = None,
                 sample_batch: int = 256,
                 metrics_dict: Optional[dict] = None, verbose: bool = True,
                 memory_budget_bytes: int = DEFAULT_EVAL_MEMORY_BUDGET,
                 ) -> tuple[torch.Tensor, dict]:
    """Pooled + per-chain posterior-predictive metrics of ``samples``
    (C, S, dim). Returns (predictions (C, S, N, out), metrics dict)."""
    metrics_dict = dict(metrics_dict or {})
    generator = _eval_generator(generator)
    samples = torch.as_tensor(samples, device=x.device)
    preds = predict_bde(model, samples, x, sample_batch, memory_budget_bytes)

    # NaN-chain exclusion
    nan_chains = torch.isnan(preds).flatten(1).any(dim=1).cpu().numpy()
    if nan_chains.any() and not nan_chains.all():
        logger.warning('chains %s have NaN predictions; excluding',
                       np.where(nan_chains)[0])
        ok = torch.as_tensor(~nan_chains, device=preds.device)
    else:
        ok = torch.ones(preds.shape[0], dtype=torch.bool, device=preds.device)

    pw = M.pointwise_lppd(preds[ok], y, task)
    metrics_dict['lppd'] = float(M.lppd(pw))
    metrics_dict['nll'] = float(-pw.mean())
    metrics_dict['running_lppd'] = M.running_lppd(pw).cpu().numpy()
    metrics_dict['running_lppd_per_chain'] = \
        M.running_lppd_per_chain(pw).cpu().numpy()
    metrics_dict['lppd_per_chain'] = [
        float(M.lppd(M.pointwise_lppd(p, y, task))) for p in preds]

    # function-space mixing diagnostics over the predictive mean
    # (class-0 logit for classification)
    fs = preds[ok][..., 0]
    n_even = fs.shape[1] - (fs.shape[1] % 4)
    if n_even >= 8 and fs.shape[0] > 1:
        fs = fs[:, :n_even]
        metrics_dict['fs_split_rhat'] = float(torch.nanmean(
            M.gelman_split_r_hat(fs, n_splits=4)))
        metrics_dict['fs_ess_per_chain'] = float(torch.nanmean(
            M.effective_sample_size(fs)))
        metrics_dict['fs_ess'] = float(torch.nanmean(
            M.pooled_effective_sample_size(fs)))

    point = sample_from_predictions(preds, task, generator)
    if task == Task.REGRESSION:
        mean_pred = preds[ok][..., 0].mean(dim=(0, 1))
        metrics_dict['rmse'] = float(torch.sqrt(torch.mean(
            (y - mean_pred) ** 2)))
        if nominal_coverages:
            coverage = calculate_coverage(nominal_coverages, y, point[ok])
            metrics_dict['cal_error'] = float(
                calibration_error(nominal_coverages, coverage))
            for c, v in zip(nominal_coverages, coverage):
                metrics_dict[f'coverage_{c}'] = float(v)
    else:
        vote = _majority_vote(point[ok].cpu().numpy(), axis=(0, 1))
        metrics_dict['acc'] = float(np.mean(y.cpu().numpy() == vote))

    if verbose:
        key = 'rmse' if task == Task.REGRESSION else 'acc'
        logger.info('BDE | LPPD: %.3f, %s: %.4f', metrics_dict['lppd'],
                    key.upper(), metrics_dict[key])
    return preds, metrics_dict


def evaluate_de(model, members: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor, task: Task,
                generator: Optional[torch.Generator] = None,
                n_samples: int = 0,
                nominal_coverages: Optional[list] = None,
                metrics_dict: Optional[dict] = None, verbose: bool = True,
                ) -> tuple[torch.Tensor, dict]:
    """Deep-ensemble metrics of the flat members (M, dim)."""
    metrics_dict = dict(metrics_dict or {})
    generator = _eval_generator(generator)
    preds = predict_from_flat(model, members, x)       # (M, N, out)

    pw = M.pointwise_lppd(preds[:, None], y, task)     # members as chains
    metrics_dict['de_lppd'] = float(M.lppd(pw))
    if task == Task.REGRESSION:
        mean_pred = preds[..., 0].mean(dim=0)
        metrics_dict['de_rmse'] = float(torch.sqrt(torch.mean(
            (y - mean_pred) ** 2)))
        if nominal_coverages and n_samples:
            point = torch.stack([sample_from_predictions(preds, task,
                                                         generator)
                                 for _ in range(n_samples)], dim=1)
            coverage = calculate_coverage(nominal_coverages, y, point)
            metrics_dict['de_cal_error'] = float(
                calibration_error(nominal_coverages, coverage))
            for c, v in zip(nominal_coverages, coverage):
                metrics_dict[f'de_coverage_{c}'] = float(v)
    else:
        vote = _majority_vote(preds.argmax(dim=-1).cpu().numpy(), axis=(0,))
        metrics_dict['de_acc'] = float(np.mean(y.cpu().numpy() == vote))

    if verbose:
        key = 'de_rmse' if task == Task.REGRESSION else 'de_acc'
        logger.info('DE | LPPD: %.3f, %s: %.4f', metrics_dict['de_lppd'],
                    key.upper(), metrics_dict[key])
    return preds, metrics_dict
