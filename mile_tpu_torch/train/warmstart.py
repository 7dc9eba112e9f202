"""Deep-ensemble warmstart training, one member per future MCMC chain
(counterpart of ``mile_tpu/train/warmstart.py``).

Members are stacked on a leading axis of one flat ``(M, dim)`` parameter
tensor, trained by one ``torch.optim`` optimizer: the optimizers of the
config (AdamW, Adam, SGD) are elementwise, and each member's loss depends
on its own row only, so one backward pass over the sum of the members'
losses gives every member its own gradient. Every member draws its own
batch permutation per epoch. Train metrics are recorded per step, from the
step's own (pre-update) forward pass; validation metrics per epoch.
Early stopping is per member (``earlystop_mask`` semantics): a stopped
member's parameters and optimizer state stay as they were.

The partition warm start (``partition_warmstart``) trains the first and
last layer groups only, as the JAX package's ``optax.multi_transform``
with ``set_to_zero`` on the hidden groups does: their gradient is zeroed,
so their optimizer moments stay 0, and their values are put back after
each step, so that AdamW's decoupled weight decay does not move them
either. The hidden coordinates keep their initial values bit for bit.

Image members take their own batches ``(M, B, C, H, W)``, text members
their token batches ``(M, B, T)``. The validation and test forwards are
chunked over observations by the evaluation's planner, since unchunked
they would hold every member's activations of the whole split at once
(about 7 GB for LeNet on 12,000 images and 10 members; the IMDB-width
attention classifier holds 8 heads x 70 x 70 attention weights per member
and sequence). The warm start runs at the arithmetic a ``None`` precision
stands for, as the JAX package's runs at XLA's default: exact float32,
convolutions included, unless a runner set the TPU's one bfloat16 pass
(see :mod:`mile_tpu_torch.utils.precision`).

With a ``mesh`` (:class:`~mile_tpu_torch.parallel.mesh.ChainMesh`, the
counterpart of the JAX package's members sharded over the ``chains``
axis) each grid row's first entry computes the forward and backward pass
of its own rows of members, on its batches, from training data placed on
it once; the gradients and the step's metrics are gathered to the first
device (and, across processes, to every rank), where the optimizer, the
batch plan, early stopping and the validation and test forwards run as
without a mesh. So every rank runs the loop on the same gathered values,
and the result does not depend on the mesh: on the CPU it equals one
device's bit for bit. The data axis is not split: a member's mean loss
summed in parts would round otherwise.
"""
from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from mile_tpu_torch.config.data import Task
from mile_tpu_torch.config.training import WarmstartConfig
from mile_tpu_torch.inference.evaluation import predict_from_flat
from mile_tpu_torch.inference.metrics import (
    ClassificationMetrics,
    Metrics,
    MetricsStore,
    RegressionMetrics,
    gaussian_nlll,
    squared_error,
)
from mile_tpu_torch.parallel.distributed import all_gather_rows
from mile_tpu_torch.parallel.mesh import split_bounds
from mile_tpu_torch.utils.precision import matmul_precision

logger = logging.getLogger(__name__)


# ------------------------------------------------------------ loss/metrics
def _sigma(lvals):
    return torch.clamp(torch.exp(lvals[..., 1]), 1e-6, 1e6)


def _regr_loss(lvals: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-member mean Gaussian NLL: lvals (M, B, 2), y (M, B) -> (M,)."""
    return gaussian_nlll(y, lvals[..., 0], _sigma(lvals)).mean(dim=-1)


def _class_loss(lvals: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-member mean cross-entropy: lvals (M, B, K), y (M, B) or (B,)
    shared by every member -> (M,)."""
    y = y.long().expand(lvals.shape[:-1])
    ce = F.cross_entropy(lvals.flatten(0, -2), y.flatten(),
                         reduction='none')
    return ce.view(y.shape).mean(dim=-1)


def _regr_metrics(lvals, y) -> dict:
    return {'nlll': _regr_loss(lvals, y),
            'rmse': torch.sqrt(squared_error(y, lvals[..., 0]).mean(dim=-1))}


def _class_metrics(lvals, y) -> dict:
    return {'cross_entropy': _class_loss(lvals, y),
            'accuracy': (lvals.argmax(dim=-1) == y.long()).float().mean(-1)}


def task_fns(task: Task) -> tuple[Callable, Callable, type]:
    if task == Task.REGRESSION:
        return _regr_loss, _regr_metrics, RegressionMetrics
    return _class_loss, _class_metrics, ClassificationMetrics


# the keys of each task's step metrics, in the order of its metrics_fn
METRIC_NAMES = {Task.REGRESSION: ('nlll', 'rmse'),
                Task.CLASSIFICATION: ('cross_entropy', 'accuracy')}


def earlystop_mask(losses: np.ndarray, patience: int | None) -> np.ndarray:
    """Per-member stop decision from the validation-loss history
    ``losses`` (n_members, n_epochs): stop when the last ``patience``
    losses never improved on the loss ``patience+1`` epochs ago."""
    n_members, n_epochs = losses.shape
    if patience is None or n_epochs < patience + 1:
        return np.zeros(n_members, dtype=bool)
    reference = losses[:, -(patience + 1)][:, None]
    recent = losses[:, -patience:]
    return np.all(recent >= reference, axis=1)


# ---------------------------------------------------------------- training
class MemberShards:
    """The members' rows of each entry of ``mesh``'s chains axis: the
    forward and backward pass of a step split by rows of members, each
    part on its entry (the first of its grid row), gathered to the
    members' device and across the ranks of ``mesh.group``. Without a
    mesh all members form one part on the training data's device.
    ``task`` names the step's metrics."""

    def __init__(self, mesh, n_members: int, x_all, y_all, task: Task):
        self.names = METRIC_NAMES[task]
        self.group = None if mesh is None else mesh.group
        if mesh is None:
            self.parts = [(x_all.device, 0, n_members)]
        else:
            n_local = len(mesh.grid)
            bounds = split_bounds(n_members, mesh.shape['chains'])
            mine = bounds[mesh.rank * n_local:(mesh.rank + 1) * n_local]
            self.parts = [(row[0], s, e)
                          for row, (s, e) in zip(mesh.grid, mine) if e > s]
            self.counts = [bounds[(r + 1) * n_local - 1][1]
                           - bounds[r * n_local][0]
                           for r in range(mesh.n_procs)]
        self.data = {}   # the training data on each entry, placed once
        for dev, _, _ in self.parts:
            if dev not in self.data:
                self.data[dev] = (x_all.to(dev), y_all.to(dev))

    def grad_and_metrics(self, model, flat, loss_fn, metrics_fn,
                         rows: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """The members' loss gradient ``(M, dim)`` and the step's metrics
        on their batches ``rows`` (M, B), on ``flat``'s device."""
        dim = flat.shape[1]
        blocks = []
        for dev, s, e in self.parts:
            x_all, y_all = self.data[dev]
            r = rows[s:e].to(dev)
            x, y = x_all[r], y_all[r]
            theta = flat.detach()[s:e].to(dev).detach().requires_grad_(True)
            lvals = model(theta, x)
            (grad,) = torch.autograd.grad(loss_fn(lvals, y).sum(), theta)
            with torch.no_grad():
                m = metrics_fn(lvals.detach(), y)
            blocks.append(torch.cat(
                [grad] + [m[k][:, None] for k in self.names],
                dim=1).to(flat.device))
        block = (torch.cat(blocks) if blocks
                 else flat.new_zeros((0, dim + len(self.names))))
        if self.group is not None:
            block = all_gather_rows(block, self.counts, self.group)
        return block[:, :dim].contiguous(), {k: block[:, dim + i]
                                for i, k in enumerate(self.names)}


def member_step(model, flat: torch.Tensor, optimizer, loss_fn, metrics_fn,
                shards: MemberShards, rows: torch.Tensor,
                stopped: np.ndarray,
                frozen: torch.Tensor | None = None) -> dict:
    """One optimizer step of every member on its batch ``rows`` (M, B).

    Members flagged in ``stopped`` keep their parameters and optimizer
    state; the coordinates indexed by ``frozen`` keep their values in
    every member. ``shards`` runs the forward and backward pass, split
    over the mesh's entries where it has more than one. Returns the step's
    per-member metrics (NaN where stopped).
    """
    optimizer.zero_grad(set_to_none=True)
    flat.grad, m = shards.grad_and_metrics(model, flat, loss_fn, metrics_fn,
                                           rows)
    if frozen is not None:
        flat.grad[:, frozen] = 0.0
        held = flat.detach()[:, frozen]
    keep = None
    if stopped.any():
        keep = torch.as_tensor(stopped, device=flat.device)
        state = optimizer.state.get(flat, {})
        saved = [flat.detach().clone()] + [
            v.clone() for v in state.values()
            if torch.is_tensor(v) and v.shape == flat.shape]
    optimizer.step()
    if frozen is not None:
        flat.data[:, frozen] = held
    if keep is not None:
        current = [flat.data] + [
            v for v in optimizer.state[flat].values()
            if torch.is_tensor(v) and v.shape == flat.shape]
        for new, old in zip(current, saved):
            new[keep] = old[keep]
    if keep is not None:
        m = {k: torch.where(keep, torch.full_like(v, float('nan')), v)
             for k, v in m.items()}
    return m


def _to_metrics(cls: type, hist: list[dict], n_members: int) -> Metrics:
    if not hist:
        return cls.empty()
    cols = {k: torch.stack([h[k] for h in hist], dim=1).cpu().numpy()
            for k in hist[0]}
    step = np.tile(np.arange(len(hist)), (n_members, 1))
    return cls(step=step, **cols)


def train_ensemble(model, loader, config: WarmstartConfig, task: Task,
                   n_members: int, generator: torch.Generator,
                   init: torch.Tensor | None = None, mesh=None
                   ) -> tuple[torch.Tensor, MetricsStore]:
    """Train ``n_members`` networks, the forward and backward passes split
    over ``mesh``'s chains axis (:class:`MemberShards`); returns (flat params (M, dim) on the loader's device,
    metrics)."""
    with matmul_precision(None):
        return _train_ensemble(model, loader, config, task, n_members,
                               generator, init, mesh)


def _train_ensemble(model, loader, config, task, n_members, generator,
                    init, mesh):
    loss_fn, metrics_fn, metrics_cls = task_fns(task)
    x_all, y_all = loader.arrays('train')
    device = x_all.device
    if init is None:
        init = model.init(n_members, generator)
    flat = init.to(device).clone().requires_grad_(True)
    optimizer = config.optimizer_config.build([flat])
    shards = MemberShards(mesh, n_members, x_all, y_all, task)
    frozen = None
    if config.partition_warmstart:
        from mile_tpu_torch.bayes.partition import partition_mask

        frozen = torch.as_tensor(np.nonzero(~partition_mask(model.layout))[0],
                                 device=device)

    x_valid, y_valid = loader.arrays('valid')
    has_valid = x_valid.shape[0] > 0
    n_train = x_all.shape[0]
    batch_size = config.batch_size or n_train
    n_batches = max(1, n_train // batch_size)
    patience = config.patience if (config.patience and has_valid) else None
    valid_key = 'nlll' if task == Task.REGRESSION else 'cross_entropy'

    stopped = np.zeros(n_members, dtype=bool)
    train_hist, valid_hist = [], []
    epochs_done = 0
    while epochs_done < config.max_epochs and not stopped.all():
        # per-member batch permutations for this epoch: (M, n_batches, B)
        plan = torch.rand(n_members, n_train, generator=generator).argsort(
            dim=1)[:, :n_batches * batch_size].reshape(
            n_members, n_batches, batch_size).to(device)
        for b in range(n_batches):
            train_hist.append(member_step(
                model, flat, optimizer, loss_fn, metrics_fn, shards,
                plan[:, b], stopped, frozen))
        if has_valid:
            valid_hist.append(metrics_fn(
                predict_from_flat(model, flat.detach(), x_valid), y_valid))
            if patience:
                losses = torch.stack([h[valid_key] for h in valid_hist],
                                     dim=1).cpu().numpy()
                stopped |= earlystop_mask(losses, patience)
        epochs_done += 1
    logger.info('warmstart finished after %d epoch(s)', epochs_done)

    params = flat.detach()
    x_test, y_test = loader.arrays('test')
    test = (metrics_cls(step=np.zeros((n_members, 1)), **{
        k: v.cpu().numpy()[:, None] for k, v in metrics_fn(
            predict_from_flat(model, params, x_test), y_test).items()})
        if x_test.shape[0] > 0 else metrics_cls.empty())
    store = MetricsStore(
        train=_to_metrics(metrics_cls, train_hist, n_members),
        valid=_to_metrics(metrics_cls, valid_hist, n_members),
        test=test)
    return params, store
