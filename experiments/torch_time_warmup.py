#!/usr/bin/env python3
"""Timing of NUTS window adaptation in the PyTorch port (counterpart of
``experiments/time_warmup.py``).

    python experiments/torch_time_warmup.py [warmup_steps] [n_chains]
        [--device cuda|cpu]

Times ``run_window_adaptation`` over a batch of chains (default 500 steps,
8 chains) on the bikesharing posterior (800 rows, FCN [16, 16, 2],
StandardNormal prior), in exact float32, twice: the first run also holds
the warm-up of CUDA and its libraries (the port compiles nothing, where
the JAX script's first run compiles), the second is the adaptation alone.
Each run ends in a device synchronisation. Prints the JAX script's lines.
Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('warmup_steps', nargs='?', type=int, default=500)
    p.add_argument('n_chains', nargs='?', type=int, default=8)
    p.add_argument('--device', default='cuda',
                   help="torch device (default 'cuda'; 'cpu' to run on "
                        'the CPU)')
    args = p.parse_args(argv)
    import torch

    from mile_tpu_torch.bayes import BayesianModel
    from mile_tpu_torch.config.data import DataConfig, Task
    from mile_tpu_torch.config.models import FCNConfig
    from mile_tpu_torch.config.training import PriorConfig
    from mile_tpu_torch.data import build_loader
    from mile_tpu_torch.mcmc import hmc, nuts
    from mile_tpu_torch.mcmc.adaptation.window import run_window_adaptation
    from mile_tpu_torch.models import build_model
    from mile_tpu_torch.utils.device import resolve_device
    from mile_tpu_torch.utils.precision import matmul_precision

    dev = resolve_device(args.device)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    data_cfg = DataConfig(path='data/bikesharing.data', data_type='tabular',
                          task='regr', datapoint_limit=800)
    loader = build_loader(data_cfg, 0, dev)
    x, y = loader.arrays('train')
    model = build_model(FCNConfig(hidden_structure=[16, 16, 2]),
                        loader.input_shape)
    bm = BayesianModel(model, PriorConfig().build(), Task.REGRESSION)
    vg = bm.logdensity_and_grad_fn(x, y)
    n_chains = args.n_chains
    print(f'dim={bm.dim} n_train={x.shape[0]} '
          f'warmup_steps={args.warmup_steps} chains={n_chains}', flush=True)

    flat0 = model.init(1, torch.Generator().manual_seed(1))[0]
    gen = torch.Generator().manual_seed(2)
    init = torch.stack([flat0 + 0.01 * torch.randn(flat0.shape,
                                                   generator=gen)
                        for _ in range(n_chains)]).to(dev)

    def warmup():
        draws = hmc.device_draws(torch.Generator().manual_seed(3), dev)
        kernel = nuts.build_kernel(vg, draws=draws)
        return run_window_adaptation(
            kernel, hmc.init(init, vg), draws, args.warmup_steps,
            initial_step_size=0.005, logdensity_and_grad=vg)

    with matmul_precision('float32'):
        t0 = time.perf_counter()
        warmup()
        sync()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = warmup()
        sync()
        run = time.perf_counter() - t0
    print(f'compile+run={first:.2f}s  run={run:.2f}s  '
          f'eps={np.asarray(out[1].cpu())}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
