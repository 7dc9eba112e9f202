#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port: MCLMC posterior sampling
throughput on the airfoil BNN, on one NVIDIA GPU (counterpart of
``bench.py``: the same modes, flags, workloads and JSON records).

    python bench_torch.py [--cpu | --cpu-baseline]
    python bench_torch.py --chain-scaling [airfoil|fcn] [--chains a,b,c]
        [--cpu]
    python bench_torch.py --lenet-mfu [--chunk C] [--f32] [--cpu]
    python bench_torch.py --fcn-mfu [--width W] [--chunk C] [--f32]
        [--integrator pallas] [--cpu]
    python bench_torch.py --reference-style-baseline

The workload is bench.py's: UCI airfoil split 0.7/0.1/0.2 with loader
seed 0, FCN [16, 16, 16, 2] (674 parameters), a StandardNormal prior and
the Gaussian likelihood. The headline is steady-state sampler throughput,
MCLMC steps per second over all chains (one step: two full-batch
gradients, three momentum rotations through K1, a refresh through K3),
after a real tuner run of 2,000 steps: the median, IQR, min and max of 7
timed blocks of 3,000 steps at 12 chains, the median at 48 chains, and the
warm start's member-steps/s at 12 and 48 members. It prints one JSON line.
Every JSON line names the card (``card``: name and power limit).

What differs from bench.py, and why:

- ``vs_baseline`` (= ``vs_reference_style``) and ``vs_own_cpu`` divide by
  CPU rates measured in the same run on this host, in short blocks of
  ``CPU_BLOCK_STEPS`` steps (``reference_style_baseline``,
  ``own_path_baseline``); bench.py's constants are JAX numbers of another
  host, and its MFU is a TPU's.
- MFU is the hand-counted model FLOPs against the H100's peaks
  (``mile_tpu_torch.utils.card``). ``hw_tflops_per_sec`` counts the FLOPs
  of one step with ``torch.utils.flop_counter.FlopCounterMode`` in place
  of XLA's ``cost_analysis``; both count the recomputation of checkpointed
  likelihood chunks.
- Each attempt of a headline measurement runs in a fresh worker process
  (this script with ``--worker``), which first checks the device with a
  tiny matmul and a synchronize. A CUDA fault is sticky: after an illegal
  address or a device-side assert every later CUDA call of the process
  fails, so bench.py's retry in the same process could never succeed. A
  worker that hits a device fault (``torch_run_catalog.is_device_fault``:
  CUDA's errors; out of memory is not one) or hangs is replaced by a new
  one after ``MILE_BENCH_COOLOFF_S`` seconds, up to ``MILE_BENCH_ATTEMPTS``
  attempts; any other error ends the bench at once. On final failure the
  headline still prints one JSON line, with ``error``, and exits 1.
- ``--donate`` is refused: it has no counterpart (see :func:`fcn_mfu`).
  bench.py's ``unroll=4`` has none either: the port steps eagerly, one
  Python iteration a step, so there is no compiled loop to unroll.

It runs on the GPU. ``--cpu`` (``device='cpu'`` in Python) asks for the
CPU, where every kernel wrapper computes its plain PyTorch version;
without a GPU and without ``--cpu`` it raises. ``--cpu-baseline`` is the
headline on the CPU, as in bench.py.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'experiments'))

import torch_dtype_ab_widefcn as wide_fcn  # noqa: E402
from torch_run_catalog import EXIT_FAULT, is_device_fault  # noqa: E402

from mile_tpu_torch.utils.card import PEAK_FLOPS, card_line  # noqa: E402
from mile_tpu_torch.utils.device import resolve_device  # noqa: E402
from mile_tpu_torch.utils.precision import matmul_precision  # noqa: E402

N_CHAINS = 12
HIDDEN = [16, 16, 16, 2]
WARMUP_STEPS = 2000
TIMED_STEPS = 3000
N_REPEATS = 7              # the headline is the median of N timed blocks
# bench.py's second point (its TPU's knee), kept so that the two benches'
# lines compare; the port's own knee is what --chain-scaling measures
BEST_PER_CHIP_CHAINS = 48
WARMSTART_EPOCHS = 200
# the CPU denominators: steps of each short block of the headline, and of
# --reference-style-baseline (bench.py's n)
CPU_BLOCK_STEPS = 200
REFERENCE_STYLE_STEPS = 1000
# LeNet's forward per 28x28 image (bench.py:414-419): conv1 28x28x6x25x2 +
# conv2 10x10x16x150x2 + fc 400->120->84->10
LENET_FWD_FLOPS = 833_040

BENCH_ATTEMPTS = int(os.environ.get('MILE_BENCH_ATTEMPTS', '3'))
BENCH_COOLOFF_S = float(os.environ.get('MILE_BENCH_COOLOFF_S', '120'))
WORKER_TIMEOUT_S = 3600
WORKER_ERROR = 'bench_torch worker: '


class DeviceFault(RuntimeError):
    """A worker ended by a device fault, or outlived its timeout."""


class WorkerFailed(RuntimeError):
    """A worker ended by any other error."""


def _sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _card(dev: torch.device) -> str:
    return card_line() if dev.type == 'cuda' else 'cpu'


def _airfoil_loader(dev: torch.device):
    from mile_tpu_torch.config import DataConfig, Task
    from mile_tpu_torch.data import TabularLoader

    return TabularLoader(DataConfig(path='data/airfoil.data',
                                    task=Task.REGRESSION, train_split=0.7,
                                    valid_split=0.1, test_split=0.2),
                         0, device=dev)


def build_workload(device='cuda', generator: torch.Generator | None = None):
    """bench.py's workload on ``device``: (BayesianModel, x, y, template),
    the training split on the device and a template member of the FCN
    drawn by its initializer (``init_flat``) from ``generator``."""
    from mile_tpu_torch.bayes import BayesianModel, Prior
    from mile_tpu_torch.config import FCNConfig, PriorDist, Task
    from mile_tpu_torch.models import build_model

    dev = resolve_device(device)
    x, y = _airfoil_loader(dev).arrays('train')
    model = build_model(FCNConfig(hidden_structure=HIDDEN), x.shape[1])
    template = model.init(1, generator or torch.Generator().manual_seed(1))[0]
    bayes = BayesianModel(model, Prior.from_name(PriorDist.STANDARD_NORMAL),
                          Task.REGRESSION)
    return bayes, x, y, template


def measure_throughput(n_chains: int, n_repeats: int = N_REPEATS, *,
                       warmup_steps: int = WARMUP_STEPS,
                       timed_steps: int = TIMED_STEPS, device='cuda',
                       generator: torch.Generator | None = None) -> dict:
    """Median/IQR steady-state MCLMC samples/s at ``n_chains`` after a real
    tuner run (``warmup_mclmc``), at the tuned per-chain (L, eps,
    sqrt_diag_cov). One untimed block warms cuBLAS (and builds the kernels
    at first use); each timed block ends in a synchronize and sends no
    draw to the host. The refresh's step counter moves on, so every block
    draws fresh noise. ``n_repeats`` >= 2."""
    from mile_tpu_torch.config import SamplerConfig
    from mile_tpu_torch.mcmc import mclmc
    from mile_tpu_torch.train.sampling import warmup_mclmc

    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(2)
    bayes, x, y, _ = build_workload(dev)
    vg = bayes.logdensity_and_grad_fn(x, y)
    cfg = SamplerConfig(warmup_steps=warmup_steps, n_chains=n_chains,
                        n_samples=timed_steps, step_size_init=0.01,
                        desired_energy_var_start=0.5,
                        desired_energy_var_end=0.1)
    positions = 0.1 * torch.randn(n_chains, bayes.dim, generator=gen)
    states, params, _ = warmup_mclmc(vg, cfg, gen, positions.to(dev))
    kernel = mclmc.build_kernel(vg, gen)

    def block(state):   # bench.py scans it with unroll=4: eager has no scan
        for _ in range(timed_steps):
            state, info = kernel(state, params.L, params.step_size,
                                 params.sqrt_diag_cov)
        return state, info.energy_change

    rates = []
    with matmul_precision(cfg.matmul_precision):
        states, energy_change = block(states)
        _sync(dev)
        for _ in range(n_repeats):
            t0 = time.perf_counter()
            states, energy_change = block(states)
            _sync(dev)
            rates.append(n_chains * timed_steps / (time.perf_counter() - t0))
    rates.sort()
    q = statistics.quantiles(rates, n=4)
    return {'median': statistics.median(rates), 'iqr': q[2] - q[0],
            'min': rates[0], 'max': rates[-1], 'n_repeats': n_repeats,
            'energy_change_finite': bool(torch.isfinite(energy_change).all())}


def measure_warmstart(n_members: int, n_epochs: int = WARMSTART_EPOCHS, *,
                      device='cuda',
                      generator: torch.Generator | None = None) -> dict:
    """Ensemble-SGD (warm start) throughput on the airfoil workload:
    ``train_ensemble`` (AdamW at lr 1e-3, batches of 32, no early stop)
    run twice, the second run timed. member-steps/s = members x epochs x
    (training rows // 32) / wall."""
    from mile_tpu_torch.config import (
        FCNConfig,
        OptimizerConfig,
        Task,
        WarmstartConfig,
    )
    from mile_tpu_torch.models import build_model
    from mile_tpu_torch.train.warmstart import train_ensemble

    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    loader = _airfoil_loader(dev)
    n_train, n_feat = loader.arrays('train')[0].shape
    model = build_model(FCNConfig(hidden_structure=HIDDEN), n_feat)
    cfg = WarmstartConfig(include=True, max_epochs=n_epochs, batch_size=32,
                          patience=None, optimizer_config=OptimizerConfig())
    n_batches = max(1, n_train // 32)

    def run():
        params, _ = train_ensemble(model, loader, cfg, Task.REGRESSION,
                                   n_members, gen)
        _sync(dev)
        return params

    run()
    t0 = time.perf_counter()
    params = run()
    elapsed = time.perf_counter() - t0
    return {'member_steps_per_sec':
                round(n_members * n_epochs * n_batches / elapsed, 1),
            'epochs_per_sec': round(n_epochs / elapsed, 2),
            'wall_s': round(elapsed, 2),
            'params_finite': bool(torch.isfinite(params).all())}


# ------------------------------------------------------------ fixed blocks
class _MatmulDtypes(TorchDispatchMode):
    """Records the dtype of the first input of every convolution and
    matrix product dispatched while it is active."""

    OPS = ('convolution', 'convolution_backward', 'mm', 'bmm', 'addmm',
           'baddbmm')

    def __init__(self):
        super().__init__()
        self.seen: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.OPS and isinstance(args[0], torch.Tensor):
            self.seen.setdefault(name, set()).add(str(args[0].dtype))
        return func(*args, **(kwargs or {}))


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        groups, output_mask, out_shape=None, **kwargs) -> int:
    """FLOPs of a convolution's backward as FlopCounterMode counts them,
    with the weight gradient of a grouped convolution counted per group:
    torch's formula counts every input channel against every output
    channel there, ``groups`` times the work (LeNet's second convolution
    has one group per chain)."""
    from torch.utils.flop_counter import conv_flop_count

    def t(shape):
        return [shape[1], shape[0], *shape[2:]]

    flops = 0
    if output_mask[0]:
        flops += conv_flop_count(grad_out_shape, w_shape, out_shape[0],
                                 not transposed)
    if output_mask[1]:
        a, b = ((grad_out_shape, x_shape) if transposed
                else (x_shape, grad_out_shape))
        flops += conv_flop_count(t(a), t(b), t(out_shape[1])) // groups
    return flops


def _timed_block(bayes, x, y, n_chains: int, n_steps: int, L: float,
                 eps: float, scale: float, dev: torch.device,
                 gen: torch.Generator, integrator: str = 'mclachlan',
                 count_flops: bool = False) -> dict:
    """MCLMC at a fixed (L, eps) and no preconditioner from ``scale`` x
    N(0, 1) positions: one warm block and one timed block of ``n_steps``
    steps, then, with ``count_flops``, one step under FlopCounterMode (and
    :class:`_MatmulDtypes`). Returns the timed block's seconds, whether its
    last energy changes are finite, the peak device memory of the two
    blocks (CUDA), the FLOPs of one step and the matmul input dtypes."""
    from torch.utils.flop_counter import FlopCounterMode

    from mile_tpu_torch.mcmc import mclmc

    vg = bayes.logdensity_and_grad_fn(x, y)
    positions = (scale * torch.randn(n_chains, bayes.dim, generator=gen)
                 ).to(dev)
    kernel = mclmc.build_kernel(vg, gen, integrator=integrator)
    Ls = torch.full((n_chains,), L, device=dev)
    epss = torch.full((n_chains,), eps, device=dev)

    def block(state, n):
        for _ in range(n):
            state, info = kernel(state, Ls, epss)
        return state, info.energy_change

    out = {}
    with matmul_precision(None):
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        state = mclmc.init(positions, vg, gen)
        state, _ = block(state, n_steps)
        _sync(dev)
        t0 = time.perf_counter()
        state, energy_change = block(state, n_steps)
        _sync(dev)
        out['elapsed'] = time.perf_counter() - t0
        out['energy_change_finite'] = bool(
            torch.isfinite(energy_change).all())
        out['peak_memory_gb'] = (torch.cuda.max_memory_allocated(dev) / 1e9
                                 if dev.type == 'cuda' else None)
        if count_flops:
            dtypes = _MatmulDtypes()
            with FlopCounterMode(display=False, custom_mapping={
                    torch.ops.aten.convolution_backward: _conv_backward_flop
            }) as flops, dtypes:
                block(state, 1)
            _sync(dev)
            out['hw_flops_per_step'] = float(flops.get_total_flops())
            out['matmul_input_dtypes'] = {k: sorted(v) for k, v in
                                          sorted(dtypes.seen.items())}
    return out


def _mfu(achieved: float, dtype: str, dev: torch.device) -> dict:
    """The share of the H100's peak for the forward's dtype, under a key
    that names that peak; None off the card."""
    kind = 'bfloat16' if dtype == 'bfloat16' else 'float32'
    key = 'mfu_vs_bf16_peak' if kind == 'bfloat16' else 'mfu_vs_f32_peak'
    return {key: (round(achieved / PEAK_FLOPS[kind], 4)
                  if dev.type == 'cuda' else None)}


def lenet_step_flops(n_images: int) -> float:
    """Model FLOPs of one chain's MCLMC step on LeNet over ``n_images``
    (MFU convention: two gradients, each 3x the forward; the recomputation
    of checkpointed chunks not counted)."""
    return float(2 * 3 * LENET_FWD_FLOPS * n_images)


def lenet_mfu(compute_dtype: str = 'bfloat16', chunk: int | None = None, *,
              n_images: int = 60_000, n_chains: int = N_CHAINS,
              n_steps: int = 30, device='cuda',
              generator: torch.Generator | None = None) -> dict:
    """Big-model device point: MCLMC on a LeNet posterior (61,706
    parameters, ``n_images`` synthetic 28 x 28 images and labels from
    ``numpy.random.RandomState(0)``, 12 chains), the forward in
    ``compute_dtype`` and the energy in float32, at L 1.0 and eps 1e-4.
    Steps/s, model TFLOP/s and MFU against the peak of the forward's dtype,
    and the hardware TFLOP/s of one counted step."""
    from mile_tpu_torch.bayes import BayesianModel, Prior
    from mile_tpu_torch.config import PriorDist, Task
    from mile_tpu_torch.config.models import LeNetConfig
    from mile_tpu_torch.models import build_model

    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(2)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(n_images, 1, 28, 28).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, size=(n_images,)).astype(np.int32))
    bayes = BayesianModel(build_model(LeNetConfig(out_dim=10), (1, 28, 28)),
                          Prior.from_name(PriorDist.STANDARD_NORMAL),
                          Task.CLASSIFICATION, likelihood_chunk_size=chunk,
                          compute_dtype=compute_dtype)
    run = _timed_block(bayes, x.to(dev), y.to(dev), n_chains, n_steps, 1.0,
                       1e-4, 0.05, dev, gen, count_flops=True)
    elapsed = run['elapsed']
    flops_per_block = lenet_step_flops(n_images) * n_chains * n_steps
    achieved = flops_per_block / elapsed
    return {
        'metric': 'mclmc_lenet_fmnist_steps_per_sec',
        'value': round(n_chains * n_steps / elapsed, 2),
        'unit': (f'MCLMC steps/s ({n_chains} chains, {bayes.dim}-param '
                 f'LeNet, {n_images}-image full-batch posterior, '
                 f'{compute_dtype} fwd + fp32 energy)'),
        'model_tflops_per_sec': round(achieved / 1e12, 2),
        **_mfu(achieved, compute_dtype, dev),
        'hw_tflops_per_sec': round(
            run['hw_flops_per_step'] * n_steps / elapsed / 1e12, 2),
        'dtype': str(compute_dtype),
        'likelihood_chunk_size': chunk,
        'flops_per_step_per_chain': round(
            flops_per_block / (n_chains * n_steps) / 1e9, 3),
        'matmul_input_dtypes': run['matmul_input_dtypes'],
        'energy_change_finite': run['energy_change_finite'],
        'peak_memory_gb': run['peak_memory_gb'],
        'card': _card(dev)}


def fcn_mfu(compute_dtype: str = 'bfloat16', chunk: int | None = 8192,
            width: int = 512, integrator: str = 'mclachlan',
            donate: bool = False, *, n_rows: int = wide_fcn.N_ROWS,
            n_chains: int = N_CHAINS, n_steps: int = 10, device='cuda',
            generator: torch.Generator | None = None) -> dict:
    """Matmul-dominated device point: MCLMC on the wide FCN [width x 3, 2]
    over ``n_rows`` x 128 synthetic rows (the dtype A/B's posterior,
    ``numpy.random.RandomState(0)``), 12 chains, L 1.0 and eps 1e-5.

    ``donate`` (bench.py's ``--donate``, donating the scan carry so that
    XLA aliases it) has no counterpart and is refused: in eager PyTorch a
    step's old state is freed as soon as the new one exists, and the
    caching allocator reuses its memory."""
    if donate:
        raise ValueError(
            '--donate has no counterpart in the port: a step\'s old chain '
            'state is freed as soon as the new one exists and the caching '
            'allocator reuses its memory, which is what donating the '
            'carry buys XLA')
    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(2)
    bayes, x, y = wide_fcn.build(compute_dtype, dev, width, n_rows, chunk)
    run = _timed_block(bayes, x, y, n_chains, n_steps, 1.0, 1e-5, 0.02, dev,
                       gen, integrator=integrator, count_flops=True)
    elapsed = run['elapsed']
    achieved = (wide_fcn.model_flops_per_step(width, n_rows) * n_chains
                * n_steps / elapsed)
    return {
        'metric': 'mclmc_wide_fcn_steps_per_sec',
        'value': round(n_chains * n_steps / elapsed, 2),
        'unit': (f'MCLMC steps/s ({n_chains} chains, {bayes.dim}-param FCN '
                 f'[{width}x3], {n_rows}-row full-batch posterior, '
                 f'{compute_dtype} fwd + fp32 energy)'),
        'model_tflops_per_sec': round(achieved / 1e12, 2),
        **_mfu(achieved, compute_dtype, dev),
        'hw_tflops_per_sec': round(
            run['hw_flops_per_step'] * n_steps / elapsed / 1e12, 2),
        'dtype': str(compute_dtype),
        'likelihood_chunk_size': chunk,
        'integrator': integrator,
        'donate': donate,
        'matmul_input_dtypes': run['matmul_input_dtypes'],
        'energy_change_finite': run['energy_change_finite'],
        'peak_memory_gb': run['peak_memory_gb'],
        'card': _card(dev)}


def chain_scaling(workload: str = 'airfoil', chain_counts=None,
                  n_steps: int | None = None, *, device='cuda',
                  generator: torch.Generator | None = None) -> list[dict]:
    """Throughput against ensemble size on one card: MCLMC samples/s at
    each chain count on the airfoil posterior (12 to 1,536 chains, 1,000
    steps, eps 0.01, L 1.5) or the wide FCN (FCN [512 x 3, 2], 65,536 x 128
    rows, bf16 forward, chunks of 8,192; 4 to 48 chains, 10 steps, eps
    1e-5, L 1.0). Prints one JSON line per point as it is measured and a
    summary line (the keys ``experiments/plot_chain_scaling.py`` reads);
    returns them."""
    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(2)
    card = _card(dev)
    if workload == 'airfoil':
        bayes, x, y, _ = build_workload(dev)
        chain_counts = chain_counts or [12, 48, 192, 768, 1536]
        n_steps = n_steps or 1000
        eps, L = 0.01, 1.5
    elif workload == 'fcn':
        bayes, x, y = wide_fcn.build('bfloat16', dev, 512, chunk=8192)
        chain_counts = chain_counts or [4, 12, 48]
        n_steps = n_steps or 10
        eps, L = 1e-5, 1.0
    else:
        raise ValueError(f'unknown --chain-scaling workload {workload!r}: '
                         f'airfoil or fcn')
    lines, points = [], []
    for n_chains in chain_counts:
        run = _timed_block(bayes, x, y, n_chains, n_steps, L, eps, 0.05, dev,
                           gen)
        sps = n_chains * n_steps / run['elapsed']
        points.append((n_chains, round(sps, 1)))
        lines.append({
            'metric': f'mclmc_{workload}_chain_scaling',
            'n_chains': n_chains, 'value': round(sps, 1),
            'unit': 'samples/s', 'per_chain': round(sps / n_chains, 2),
            'elapsed_s': round(run['elapsed'], 3),
            'energy_change_finite': run['energy_change_finite'],
            'peak_memory_gb': run['peak_memory_gb'], 'card': card})
        print(json.dumps(lines[-1]), flush=True)
    lines.append({'metric': f'mclmc_{workload}_chain_scaling_summary',
                  'value': points[-1][1],
                  'unit': 'samples/s at max ensemble', 'points': points,
                  'dim': bayes.dim, 'card': card})
    print(json.dumps(lines[-1]), flush=True)
    return lines


# --------------------------------------------------------- CPU denominators
def _cpu_rate(n_steps: int, device, egress=None,
              generator: torch.Generator | None = None) -> float:
    """samples/s of ``n_steps`` MCLMC steps of the workload's 12 chains at
    bench.py's reference-style L 1.5 and eps 0.01, after 10 untimed steps;
    with ``egress``, every chain's draw goes to ``egress(draw, chain)``
    (a host numpy copy) after every timed step."""
    from mile_tpu_torch.mcmc import mclmc

    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(2)
    bayes, x, y, _ = build_workload(dev)
    vg = bayes.logdensity_and_grad_fn(x, y)
    kernel = mclmc.build_kernel(vg, gen)
    L = torch.full((N_CHAINS,), 1.5, device=dev)
    eps = torch.full((N_CHAINS,), 0.01, device=dev)

    def block(state, n, egress=None):
        for _ in range(n):
            state, _ = kernel(state, L, eps)
            if egress is not None:
                draws = state.position.cpu().numpy()
                for chain in range(N_CHAINS):
                    egress(draws[chain].copy(), chain)
        return state

    positions = 0.1 * torch.randn(N_CHAINS, bayes.dim, generator=gen)
    with matmul_precision(None):
        state = block(mclmc.init(positions.to(dev), vg, gen), 10)
        _sync(dev)
        t0 = time.perf_counter()
        block(state, n_steps, egress)
        _sync(dev)
        return N_CHAINS * n_steps / (time.perf_counter() - t0)


def reference_style_baseline(n_steps: int = REFERENCE_STYLE_STEPS,
                             device='cuda') -> dict:
    """The reference's runtime shape: 12 chains, each step handing every
    chain's draw to a host callback, as the reference streams per draw.
    The headline and the CLI run it on the CPU (``device='cpu'``)."""
    received = []
    rate = _cpu_rate(n_steps, device, lambda draw, chain: received.append(
        chain))
    dev = resolve_device(device)
    return {'metric': 'reference_style_cpu_samples_per_sec',
            'value': round(rate, 1),
            'unit': ('samples/s (12 chains, every chain\'s draw to a host '
                     'callback every step)'),
            'callbacks_received': len(received),
            'n_steps': n_steps, 'card': _card(dev)}


def own_path_baseline(n_steps: int = CPU_BLOCK_STEPS, device='cuda') -> dict:
    """The port's own path at 12 chains without the per-draw callback: the
    headline runs it on the CPU (``device='cpu'``)."""
    dev = resolve_device(device)
    return {'metric': 'own_cpu_samples_per_sec',
            'value': round(_cpu_rate(n_steps, device), 1),
            'unit': 'samples/s (12 chains)', 'n_steps': n_steps,
            'card': _card(dev)}


# ----------------------------------------------------------------- workers
def run_worker(fn: str, kwargs: dict) -> dict:
    """One attempt of the measurement ``fn`` (a function of this script,
    or ``module:function`` importable from the repository's root) called
    with ``kwargs`` in a fresh process: the one JSON line it printed.
    Raises :class:`DeviceFault` when the worker exits with a device fault
    or outlives ``WORKER_TIMEOUT_S``, :class:`WorkerFailed` otherwise."""
    cmd = [sys.executable, str(Path(__file__).resolve()), '--worker', fn,
           json.dumps(kwargs)]
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=WORKER_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        raise DeviceFault(f'{fn}: no result after {WORKER_TIMEOUT_S} s') \
            from exc
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith('{')]
    if proc.returncode == 0 and len(lines) == 1:
        return json.loads(lines[0])
    print(proc.stderr[-3000:], file=sys.stderr)
    said = [line[len(WORKER_ERROR):] for line in proc.stderr.splitlines()
            if line.startswith(WORKER_ERROR)]
    detail = said[-1] if said else f'{len(lines)} JSON lines'
    if proc.returncode == EXIT_FAULT:
        raise DeviceFault(f'{fn}: {detail}')
    raise WorkerFailed(f'{fn}: exit {proc.returncode}: {detail}')


def _preflight(device) -> None:
    """Device health: a tiny matmul and a synchronize."""
    dev = resolve_device(device)
    a = torch.ones(8, 8, device=dev)
    (a @ a).sum()
    _sync(dev)


def worker(fn: str, kwargs_json: str) -> int:
    """The worker process: the preflight, then ``fn(**kwargs)``; prints its
    result as one JSON line and returns 0, or names the error on the last
    line of stderr and returns EXIT_FAULT (a device fault) or 1."""
    kwargs = json.loads(kwargs_json)
    module, _, name = fn.rpartition(':')
    try:
        _preflight(kwargs.get('device', 'cuda'))
        target = (importlib.import_module(module) if module
                  else sys.modules[__name__])
        result = getattr(target, name)(**kwargs)
    except Exception as exc:   # classified for the parent
        traceback.print_exc()
        said = ' '.join(f'{type(exc).__name__}: {exc}'.split())
        print(WORKER_ERROR + said[:500], file=sys.stderr, flush=True)
        return EXIT_FAULT if is_device_fault(exc) else 1
    print(json.dumps(result), flush=True)
    return 0


def _with_retries(fn, label: str):
    """Run ``fn`` (one attempt in a fresh worker) until it returns, for up
    to BENCH_ATTEMPTS attempts on device faults, with a cool-off between;
    re-raise any other error at once."""
    last = None
    for attempt in range(BENCH_ATTEMPTS):
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 — classified below
            if not (isinstance(exc, DeviceFault) or is_device_fault(exc)):
                raise
            last = exc
            more = attempt + 1 < BENCH_ATTEMPTS
            print(f'bench: {label} attempt {attempt + 1}/{BENCH_ATTEMPTS} '
                  f'hit a device fault ({str(exc)[:300]}); '
                  + (f'cooling off {BENCH_COOLOFF_S:.0f}s, then a fresh '
                     f'worker' if more else 'giving up'), file=sys.stderr)
            if more:
                time.sleep(BENCH_COOLOFF_S)
    raise last


def _measure_throughput(n_chains: int, device: str) -> dict:
    return run_worker('measure_throughput',
                      {'n_chains': n_chains, 'device': device})


def _measure_warmstart(n_members: int, device: str) -> dict:
    return run_worker('measure_warmstart',
                      {'n_members': n_members, 'device': device})


def headline(device='cuda') -> int:
    """bench.py's ``main``: prints the headline JSON line (or, on final
    failure, one with ``error``) and returns 0 (or 1)."""
    dev = resolve_device(device)
    card = _card(dev)
    unit = 'posterior samples/s (12 chains, full-batch airfoil FCN)'
    try:
        head = _with_retries(lambda: _measure_throughput(N_CHAINS, dev.type),
                             'headline-12')
        best = _with_retries(
            lambda: _measure_throughput(BEST_PER_CHIP_CHAINS, dev.type),
            'knee-48')
        ws12 = _with_retries(lambda: _measure_warmstart(N_CHAINS, dev.type),
                             'warmstart-12')
        ws48 = _with_retries(
            lambda: _measure_warmstart(BEST_PER_CHIP_CHAINS, dev.type),
            'warmstart-48')
        reference = reference_style_baseline(CPU_BLOCK_STEPS, 'cpu')['value']
        own = own_path_baseline(CPU_BLOCK_STEPS, 'cpu')['value']
    except Exception as exc:  # noqa: BLE001 — final failure: parseable line
        traceback.print_exc(file=sys.stderr)
        print(json.dumps({
            'metric': 'mclmc_airfoil_samples_per_sec', 'value': None,
            'unit': unit, 'vs_baseline': None, 'error': repr(exc)[:500],
            'attempts': BENCH_ATTEMPTS, 'card': card}), flush=True)
        return 1
    samples_per_sec = head['median']
    print(json.dumps({
        'metric': 'mclmc_airfoil_samples_per_sec',
        'value': round(samples_per_sec, 1),
        'unit': unit,
        'iqr': round(head['iqr'], 1),
        'min': round(head['min'], 1),
        'max': round(head['max'], 1),
        'n_repeats': head['n_repeats'],
        'best_per_chip_samples_per_sec': round(best['median'], 1),
        'best_per_chip_n_chains': BEST_PER_CHIP_CHAINS,
        'best_per_chip_iqr': round(best['iqr'], 1),
        # the CPU rates measured above on this host: the reference's
        # runtime shape, and the port's own CPU path
        'vs_baseline': round(samples_per_sec / reference, 2),
        'vs_reference_style': round(samples_per_sec / reference, 2),
        'vs_own_cpu': round(samples_per_sec / own, 2),
        'reference_style_cpu_samples_per_sec': reference,
        'own_cpu_samples_per_sec': own,
        'cpu_block_steps': CPU_BLOCK_STEPS,
        'warmstart_12_member_steps_per_sec': ws12['member_steps_per_sec'],
        'warmstart_48_member_steps_per_sec': ws48['member_steps_per_sec'],
        'warmstart_12_wall_s': ws12['wall_s'],
        'warmstart_48_wall_s': ws48['wall_s'],
        'card': card}), flush=True)
    return 0


def _chunk(raw: str | None, default: int | None) -> int | None:
    """--chunk N (0 or 'none': unchunked), shared by both MFU modes."""
    if raw is None:
        return default
    return None if raw.lower() in ('none', '0') else int(raw)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog='modes: (default headline) | --fcn-mfu [--width W --chunk C '
               '--f32 --integrator pallas] | --lenet-mfu [--chunk C --f32] |'
               ' --chain-scaling [airfoil|fcn] [--chains a,b,c] | '
               '--reference-style-baseline | --cpu-baseline | --cpu')
    mode = p.add_mutually_exclusive_group()
    mode.add_argument('--fcn-mfu', action='store_true')
    mode.add_argument('--lenet-mfu', action='store_true')
    mode.add_argument('--chain-scaling', nargs='?', const='airfoil',
                      metavar='WORKLOAD')
    mode.add_argument('--reference-style-baseline', action='store_true')
    mode.add_argument('--cpu-baseline', action='store_true',
                      help='the headline on the CPU')
    mode.add_argument('--worker', nargs=2, metavar=('FN', 'KWARGS'),
                      help=argparse.SUPPRESS)
    p.add_argument('--chains', help='chain counts, comma-separated')
    p.add_argument('--width', type=int, default=512)
    p.add_argument('--chunk', help="likelihood chunk (0 or 'none': none)")
    p.add_argument('--f32', action='store_true',
                   help='float32 forward (default bf16)')
    p.add_argument('--integrator', default='mclachlan',
                   help="'pallas' runs 'mclachlan_pallas'")
    p.add_argument('--donate', action='store_true',
                   help='refused: no counterpart in the port')
    p.add_argument('--cpu', action='store_true', help='run on the CPU')
    args = p.parse_args(argv)
    if args.worker:
        return worker(*args.worker)
    device = 'cpu' if (args.cpu or args.cpu_baseline) else 'cuda'
    dtype = 'float32' if args.f32 else 'bfloat16'
    if args.fcn_mfu:
        integrator = ('mclachlan_pallas' if args.integrator == 'pallas'
                      else args.integrator)
        record = fcn_mfu(dtype, _chunk(args.chunk, 8192), args.width,
                         integrator, args.donate, device=device)
    elif args.lenet_mfu:
        record = lenet_mfu(dtype, _chunk(args.chunk, None), device=device)
    elif args.chain_scaling:
        counts = ([int(c) for c in args.chains.split(',')] if args.chains
                  else None)
        chain_scaling(args.chain_scaling, counts, device=device)
        return 0
    elif args.reference_style_baseline:
        record = reference_style_baseline(device='cpu')
    else:
        return headline(device)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
