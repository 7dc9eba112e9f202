#!/usr/bin/env python3
"""The NUTS leaf of catalogue jobs, replayed from a CUDA graph against the
same leaf run eagerly, in the PyTorch port.

    python experiments/torch_nuts_leaf_rate.py
        [--jobs protein_nuts_n40000_r1,bike_nuts_48x48x48_r1] [--steps 3]
        [--chains N] [--depth D] [--device cuda|cpu]

For each job of ``experiments/torch_run_catalog.py``: its training data
and network (the job's own config: rows, widths, split, prior), 12 chains
(``--chains``) from the network's seeded initialisation, and ``--steps``
NUTS steps at the job's tree depth (``--depth`` overrides it) with the
step size its JAX rows' seeds averaged (``ROWS_STEP_SIZE``, so that the
trees take about the rows' leaves) and a unit mass matrix, in exact
float32 as the runtime runs NUTS. The same steps run from the same draws
four times: with each leaf replayed from the kernel's CUDA graph (after
one step that captures it) as the runtime runs it on one card; eagerly on
the graph's route (the Dense kernel's gradient in blocks of rows where the
graph takes it, ``mile_tpu_torch.models.blocks.split_k_rows``), which
must give the same trees and positions; eagerly as the runtime runs a
leaf off the graph (the plain products); and graphed on the other route
(split where the runtime does not split, and the other way round), which
measures the split on both sides of its thresholds. Prints one JSON line
per job: the trees of the graph and its eager route (identical chain by
chain or not), the largest position difference, batched leaves (each one
full-batch value and gradient of all chains), seconds and leaves per
second of each run, whether the runtime's graph splits, the split route's
rate over the plain one's in the graph, and the card's name and power
limit. On the CPU no leaf is graphed: the first three runs are the same
eager leaf, and the fourth is left out. ``--profile``: then one eager
NUTS step under ``torch.profiler``, its device time by kernel (the top
``PROFILE_TOP``) in a second JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'experiments'))

# the mean of the JAX rows' ``step_size_mean`` over each grid point's
# seeds (``aggr_results/aggr_datasize.csv``, ``aggr_complexity.csv``)
ROWS_STEP_SIZE = {'protein_nuts_n': 1.4e-3, 'bike_nuts_48x48x48': 2.4e-3}
DEFAULT_STEP_SIZE = 1e-3
PROFILE_TOP = 12
FIELDS = ('num_trajectory_expansions', 'num_integration_steps',
          'is_turning', 'is_divergent')


def card() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return 'unknown'


def step_size_of(name: str) -> float:
    return next((v for k, v in ROWS_STEP_SIZE.items() if name.startswith(k)),
                DEFAULT_STEP_SIZE)


def profile_step(kernel, state, eps, imm) -> dict:
    """One eager NUTS step under the profiler: wall, device time, and the
    kernels with the most device time (name, launches, µs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mile_tpu_torch.utils.precision import matmul_precision

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with matmul_precision('float32'):
            kernel(state, eps, imm)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, 'self_device_time_total', None)
        if us is None:
            us = getattr(e, 'self_cuda_time_total', 0)
        if us > 0 and e.device_type.name == 'CUDA':
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    return {'wall_ms': wall * 1e3,
            'device_ms': sum(r[0] for r in rows) / 1e3,
            'leaves': kernel.leaf_steps,
            'kernels': sum(r[1] for r in rows),
            'top': [{'name': k[:80], 'launches': c, 'us': us}
                    for us, c, k in rows[:PROFILE_TOP]]}


def measure(name: str, steps: int, n_chains: int, depth, device: str,
            profiled: bool = False) -> dict:
    import torch

    import torch_run_catalog as cat
    from mile_tpu_torch.mcmc import hmc, nuts
    from mile_tpu_torch.models import blocks
    from mile_tpu_torch.train.trainer import BDETrainer
    from mile_tpu_torch.utils.precision import matmul_precision

    (job,) = [j for j in cat.build_jobs() if j.name == name]
    with tempfile.TemporaryDirectory() as root:
        config = job.config(Path(root), tpu_arithmetic=True)
        trainer = BDETrainer(config, device=device)
    scfg = config.training.sampler
    depth = depth or scfg.max_num_doublings
    dev = trainer.device
    x, y = trainer.loader.arrays('train')
    vg = trainer.bayes.logdensity_and_grad_fn(x, y)
    theta = trainer.bayes.model.init(
        n_chains, torch.Generator().manual_seed(2)).to(dev)
    eps = torch.full((n_chains,), step_size_of(name), device=dev)
    imm = torch.ones_like(theta)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    # the runtime splits at SPLIT_K_MIN_ROWS rows on (every kernel of the
    # study's FCNs is under SPLIT_K_MAX_KERNEL); the other route moves it
    splits = x.shape[0] >= blocks.SPLIT_K_MIN_ROWS
    other_route = mock.patch.object(blocks, 'SPLIT_K_MIN_ROWS',
                                    sys.maxsize if splits else 0)
    runs = {}

    def run(mode, graph, scope):
        kernel = nuts.build_kernel(
            vg, max_depth=depth, graph=graph,
            draws=hmc.Draws(torch.Generator().manual_seed(11), dev))
        with matmul_precision('float32'):
            state = nuts.init(theta, vg)    # as the runtime: off the scope
        with scope, matmul_precision('float32'):
            t0 = time.perf_counter()
            state, _ = kernel(state, eps, imm)      # captures the graph
            sync()
            first = time.perf_counter() - t0
            leaves0 = kernel.leaf_steps
            infos = []
            t0 = time.perf_counter()
            for _ in range(steps):
                state, info = kernel(state, eps, imm)
                infos.append(info)
            sync()
            seconds = time.perf_counter() - t0
        leaves = kernel.leaf_steps - leaves0
        runs[mode] = {'state': state, 'infos': infos,
                      'graphed': kernel.graphed, 'first_step_s': first,
                      'seconds': seconds, 'leaves': leaves,
                      'leaves_per_s': leaves / seconds,
                      'host_syncs': kernel.host_syncs}

    run('graph', True, contextlib.nullcontext())
    graphed = runs['graph']['graphed']
    run('eager_route', False, blocks.split_k_rows() if graphed
        else contextlib.nullcontext())
    run('eager', False, contextlib.nullcontext())
    if graphed:
        run('graph_other', True, other_route)
    if profiled and dev.type == 'cuda':
        kernel = nuts.build_kernel(
            vg, max_depth=depth, graph=False,
            draws=hmc.Draws(torch.Generator().manual_seed(11), dev))
        with matmul_precision('float32'):
            state = nuts.init(theta, vg)
        print(json.dumps({'job': name, 'profile': profile_step(
            kernel, state, eps, imm)}), flush=True)
    graph, route = runs['graph'], runs['eager_route']
    same = all(torch.equal(getattr(a, f), getattr(b, f))
               for a, b in zip(graph['infos'], route['infos'])
               for f in FIELDS)
    dx = float((graph['state'].position - route['state'].position)
               .abs().max())
    depth_seen = torch.stack([i.num_trajectory_expansions
                              for i in graph['infos']]).float()
    per_chain = torch.stack([i.num_integration_steps
                             for i in graph['infos']]).float()
    other = runs.get('graph_other')
    split_gain = None
    if other is not None:
        split_gain = (graph['leaves_per_s'] / other['leaves_per_s'] if splits
                      else other['leaves_per_s'] / graph['leaves_per_s'])
    return {
        'job': name, 'dim': trainer.bayes.dim, 'n_train': int(x.shape[0]),
        'chains': n_chains, 'max_depth': depth, 'steps': steps,
        'step_size': step_size_of(name), 'device': str(dev),
        'same_trees': same, 'max_abs_dposition': dx,
        'mean_depth': float(depth_seen.mean()),
        'leapfrog_steps_per_chain_and_draw': float(per_chain.mean()),
        **{f'{mode}_{k}': v for mode, r in runs.items()
           for k, v in r.items() if k not in ('state', 'infos')},
        'speedup': graph['leaves_per_s'] / runs['eager']['leaves_per_s'],
        'graph_splits': graphed and splits,
        'split_over_plain_graphed': split_gain,
        'card': card() if dev.type == 'cuda' else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--jobs',
                   default='protein_nuts_n40000_r1,bike_nuts_48x48x48_r1')
    p.add_argument('--steps', type=int, default=3)
    p.add_argument('--chains', type=int, default=12)
    p.add_argument('--depth', type=int, default=None,
                   help="tree depth (default: the job's max_num_doublings)")
    p.add_argument('--profile', action='store_true',
                   help='also profile one eager step on the card')
    p.add_argument('--device', default='cuda',
                   help="torch device (default 'cuda'; 'cpu' to run on "
                        'the CPU)')
    args = p.parse_args(argv)
    for name in args.jobs.split(','):
        print(json.dumps(measure(name, args.steps, args.chains, args.depth,
                                 args.device, args.profile)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
