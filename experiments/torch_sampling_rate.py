#!/usr/bin/env python3
"""The PyTorch port's MCLMC sampling rate on one GPU, for one checkout.

    python experiments/torch_sampling_rate.py --root <checkout> [--runs 5]
        [--out FILE]

Imports ``mile_tpu_torch`` from ``--root`` (so one call can measure two
checkouts in turn, e.g. parent, change, change, parent), builds
``BDETrainer`` on ``configs/illustrative_airfoil_mclmc.yaml`` at full width
(12 chains, dim 674) with ``chip_smoke.py``'s cut step counts, warm-starts
the ensemble once, then runs ``run_mclmc`` (200 tuning and 200 sampling
steps) ``--runs`` times. Prints one JSON line: the rate of each run's
sampling phase (samples/s, i.e. chain-steps per second), their median,
and the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CUT = {'training.warmstart.max_epochs': 20,
       'training.sampler.warmup_steps': 200,
       'training.sampler.n_samples': 200,
       'training.sampler.n_thinning': 10}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--root', required=True, type=Path)
    parser.add_argument('--runs', type=int, default=5)
    parser.add_argument('--out', type=Path)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.sampling import run_mclmc
    from mile_tpu_torch.train.trainer import BDETrainer

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    (config,) = Config.from_file(root / 'configs'
                                 / 'illustrative_airfoil_mclmc.yaml')
    config = config.replace(saving_dir=str(root / 'results'),
                            experiment_name='sampling_rate', **CUT)
    trainer = BDETrainer(config, device=torch.device('cuda'))
    members = trainer.train_warmstart()
    x, y = trainer.loader.arrays('train')
    scfg = config.training.sampler
    n_sampled = scfg.n_samples // scfg.n_thinning * scfg.n_thinning
    rates = []
    for _ in range(args.runs):
        result = run_mclmc(trainer.bayes.logdensity_and_grad_fn(x, y), scfg,
                           torch.Generator().manual_seed(len(rates)), members)
        rates.append(scfg.n_chains * n_sampled / result.seconds['sampling'])
    line = json.dumps({'root': str(args.root), 'card': card,
                       'samples_per_s': rates,
                       'median': statistics.median(rates)})
    print(line)
    if args.out:
        with args.out.open('a') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
