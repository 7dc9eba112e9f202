#!/usr/bin/env python3
"""Where bikesharing NUTS time goes, in the PyTorch port (counterpart of
``experiments/profile_nuts.py``).

    python experiments/torch_profile_nuts.py [--draws 200]
        [--warmup-steps 100] [--device cuda|cpu]

On the bikesharing posterior (FCN [16, 16, 2], StandardNormal prior, the
0.7/0.1/0.2 split) over 12 chains, times in exact float32:

1. one full-batch value and gradient of the 12 chains (the atom);
2. one leapfrog step, as 64 steps of ``velocity_verlet`` in a row;
3. a short NUTS run through ``run_sampler``: ``--warmup-steps`` of
   window adaptation (the JAX script's 100 by default) and ``--draws``
   draws, at the config's tree depth of up to 10 (on the CPU a draw then
   takes tens of seconds), with its tree statistics;

then predicts the sampling wall from the leapfrog atom and the measured
tree sizes; the gap to the measured wall is host and dispatch overhead.
Times end in a device synchronisation. Prints the JAX script's lines.
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

N_CHAINS = 12
N_LEAPFROG = 64
MAX_NUM_DOUBLINGS = 10   # the config's default, which the JAX script runs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--draws', type=int, default=200)
    p.add_argument('--warmup-steps', type=int, default=100)
    p.add_argument('--device', default='cuda',
                   help="torch device (default 'cuda'; 'cpu' to run on "
                        'the CPU)')
    args = p.parse_args(argv)
    import torch

    from mile_tpu_torch.bayes import BayesianModel, Prior
    from mile_tpu_torch.config import (
        DataConfig,
        FCNConfig,
        PriorDist,
        Sampler,
        SamplerConfig,
        Task,
    )
    from mile_tpu_torch.data import build_loader
    from mile_tpu_torch.mcmc.integrators import (
        EuclideanState,
        velocity_verlet,
    )
    from mile_tpu_torch.models import build_model
    from mile_tpu_torch.train.sampling import run_sampler
    from mile_tpu_torch.utils.device import resolve_device
    from mile_tpu_torch.utils.precision import matmul_precision

    dev = resolve_device(args.device)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    def timed(fn, *fn_args, repeats=3):
        out = fn(*fn_args)          # warm
        sync()
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = fn(*fn_args)
        sync()
        return (time.perf_counter() - t0) / repeats, out

    data_cfg = DataConfig(path='data/bikesharing.data', task=Task.REGRESSION,
                          train_split=0.7, valid_split=0.1, test_split=0.2)
    loader = build_loader(data_cfg, 0, dev)
    x, y = loader.arrays('train')
    model = build_model(FCNConfig(hidden_structure=[16, 16, 2]),
                        loader.input_shape)
    bayes = BayesianModel(model, Prior.from_name(PriorDist.STANDARD_NORMAL),
                          Task.REGRESSION)
    vg = bayes.logdensity_and_grad_fn(x, y)
    dim = bayes.dim
    print(f'dim={dim} n_train={x.shape[0]} chains={N_CHAINS}', flush=True)

    theta = 0.05 * torch.randn(N_CHAINS, dim,
                               generator=torch.Generator().manual_seed(2))
    theta = theta.to(dev)
    with matmul_precision('float32'):
        # --- atom 1: the full-batch value and gradient of 12 chains
        t_grad, _ = timed(vg, theta, repeats=10)
        print(f'value_and_grad (12 chains): {t_grad * 1e3:.3f} ms',
              flush=True)

        # --- atom 2: N_LEAPFROG leapfrog steps in a row
        integrate = velocity_verlet(vg, torch.ones_like(theta))
        eps = torch.full((N_CHAINS,), 5e-4, device=dev)

        def leapfrogs(pos):
            ld, g = vg(pos)
            z = EuclideanState(pos, torch.zeros_like(pos) + 0.01, ld, g)
            for _ in range(N_LEAPFROG):
                z = integrate(z, eps)
            return z.position

        t_leap, _ = timed(leapfrogs, theta, repeats=3)
        per_leap = t_leap / N_LEAPFROG
        print(f'leapfrog (12 chains): {per_leap * 1e3:.3f} ms/step '
              f'({per_leap / t_grad:.2f}x grad)', flush=True)

    # --- a short NUTS run for the tree statistics and the measured walls
    cfg = SamplerConfig(name=Sampler.NUTS, warmup_steps=args.warmup_steps,
                        n_chains=N_CHAINS, n_samples=args.draws,
                        n_thinning=1, step_size_init=0.001,
                        max_num_doublings=MAX_NUM_DOUBLINGS)
    t0 = time.perf_counter()
    res = run_sampler(vg, cfg, torch.Generator().manual_seed(3), theta)
    sync()
    total = time.perf_counter() - t0
    steps = np.asarray(res.info['num_integration_steps'])
    mean_tree = float(steps.mean())
    total_steps = float(steps.sum())
    predicted = total_steps / N_CHAINS * per_leap
    print(f'NUTS run: {args.draws} draws x {N_CHAINS} chains in '
          f'{total:.1f}s (incl. {args.warmup_steps}-step window '
          f'adaptation)', flush=True)
    print(f'mean tree size: {mean_tree:.0f} leapfrogs/draw; '
          f'total {total_steps:.0f} leapfrog steps', flush=True)
    print(f'predicted sampling wall from leapfrog atom: {predicted:.1f}s '
          f'-> physics fraction {predicted / total:.0%} of total wall',
          flush=True)
    print(f'acceptance {float(np.mean(res.info["acceptance_rate"])):.3f}, '
          f'divergent {float(np.mean(res.info["is_divergent"])):.3%}, '
          f'eps {np.asarray(res.tuned["step_size"]).round(6).tolist()}',
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
