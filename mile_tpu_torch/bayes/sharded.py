"""The log-posterior sharded over a :class:`~mile_tpu_torch.parallel.mesh.
ChainMesh` (counterpart of the JAX package's ``shard_chains`` and
``shard_data`` placements, and of the ``psum`` GSPMD inserts over the
data axis).

``theta (C, dim)`` lives on the mesh's first device. The value and
gradient are computed shard by shard: the chain rows are split over the
chains axis (over the ranks first, then over the rank's own rows of the
grid), the training rows over the data axis, each shard's log-likelihood
and its gradient on its device, from the data the mesh placed there once.
The data shards' sums are added, the prior is added once, and the result
is gathered to the first device (and, across processes, to every rank).
It is DataParallel's pattern for a function of the chains.

Splits may be uneven (``numpy.array_split``'s rule, empty shards allowed):
where the JAX package replicates a training set that does not divide over
the data axis (with a warning), the port splits it unevenly, which gives
the same sums.
"""
from __future__ import annotations

import torch

from mile_tpu_torch.parallel.distributed import all_gather_rows
from mile_tpu_torch.parallel.mesh import ChainMesh, split_bounds


class _ShardedDensity(torch.autograd.Function):
    """``theta -> value``, whose backward is the gradient the forward
    computed shard by shard, times the upstream gradient."""

    @staticmethod
    def forward(ctx, theta, density):
        value, grad = density.value_and_grad(theta)
        ctx.save_for_backward(grad)
        return value

    @staticmethod
    def backward(ctx, grad_out):
        (grad,) = ctx.saved_tensors
        return grad_out[:, None] * grad, None


class ShardedLogDensity:
    """``theta (C, dim) -> (C,)`` of ``bayes``'s log-posterior on ``(x,
    y)``, differentiable, computed over ``mesh``."""

    def __init__(self, bayes, x: torch.Tensor, y: torch.Tensor,
                 mesh: ChainMesh):
        self.bayes, self.mesh = bayes, mesh
        data = split_bounds(x.shape[0], len(mesh.grid[0]))
        # each entry's data shard, placed once (a view where the entry is
        # the data's own device)
        self.data = [[(x[s:e].to(dev), y[s:e].to(dev))
                      for dev, (s, e) in zip(row, data)] for row in mesh.grid]

    def __call__(self, theta: torch.Tensor) -> torch.Tensor:
        return _ShardedDensity.apply(theta, self)

    def _rows(self, theta: torch.Tensor, row: int):
        """The log-likelihood and its gradient of ``theta``'s rows over
        grid row ``row``'s data shards, summed on ``theta``'s device."""
        if theta.shape[0] == 0:
            return theta.new_zeros(0), theta.new_zeros(theta.shape)
        value = grad = None
        for dev, (x, y) in zip(self.mesh.grid[row], self.data[row]):
            with torch.enable_grad():
                t = theta.to(dev).detach().requires_grad_(True)
                ll = self.bayes.log_likelihood(t, x, y)
                (g,) = torch.autograd.grad(ll.sum(), t)
            ll, g = ll.detach().to(theta.device), g.to(theta.device)
            value = ll if value is None else value + ll
            grad = g if grad is None else grad + g
        return value, grad

    def value_and_grad(self, theta: torch.Tensor):
        """The log-posterior and its gradient, ``(C,)`` and ``(C, dim)`` on
        ``theta``'s device."""
        theta = theta.detach()
        mesh = self.mesh
        n_local = len(mesh.grid)
        bounds = split_bounds(theta.shape[0], mesh.shape['chains'])
        mine = bounds[mesh.rank * n_local:(mesh.rank + 1) * n_local]
        parts = [self._rows(theta[s:e], i) for i, (s, e) in enumerate(mine)]
        block = torch.cat([torch.cat([v[:, None], g], dim=1)
                           for v, g in parts])
        if mesh.group is not None:
            counts = [bounds[(r + 1) * n_local - 1][1] - bounds[r * n_local][0]
                      for r in range(mesh.n_procs)]
            block = all_gather_rows(block, counts, mesh.group)
        loglik, grad = block[:, 0], block[:, 1:]
        n_batches = self.bayes.n_batches
        if n_batches != 1:
            loglik, grad = n_batches * loglik, n_batches * grad
        with torch.enable_grad():
            t = theta.requires_grad_(True)
            prior = self.bayes.log_prior(t)
            (prior_grad,) = torch.autograd.grad(prior.sum(), t)
        return prior.detach() + loglik, prior_grad + grad
