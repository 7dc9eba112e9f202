"""Experiment CLI of the port (counterpart of ``mile_tpu/cli.py``).

    python -m mile_tpu_torch -c configs/illustrative_airfoil_mclmc.yaml
    python -m mile_tpu_torch -c configs/illustrative_airfoil_nuts.yaml
    python -m mile_tpu_torch -c configs/debug.yaml --device cpu
    python -m mile_tpu_torch -c configs/ablations/partition_airfoil.yaml

Each experiment ends with its report (``report.html``, ``diagnostics.csv``)
unless ``--no_report`` is given.

Runs on the GPU unless ``--device cpu`` is given; without a CUDA device
and without that flag it fails rather than run on the CPU.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m mile_tpu_torch',
        description='Train a Bayesian deep ensemble (warmstart + MCMC: '
                    'MCLMC, NUTS or HMC) with the PyTorch port.')
    parser.add_argument('--config', '-c', required=True,
                        help='config file or directory of configs')
    parser.add_argument('--search_tree', '-s', default=None,
                        help='search-tree YAML for grid expansion')
    parser.add_argument('--device', default='cuda',
                        help="torch device (default 'cuda'; 'cpu' to run "
                             'on the CPU)')
    parser.add_argument('--devices', '-d', type=int, default=None,
                        help='number of devices (only 1 is ported so far)')
    parser.add_argument('--silent', action='store_true',
                        help='disable console logging')
    parser.add_argument('--no_report', action='store_true',
                        help='skip report generation')
    args = parser.parse_args(argv)

    from mile_tpu_torch.config import Config
    from mile_tpu_torch.exceptions import NotYetPortedError
    from mile_tpu_torch.train.trainer import BDETrainer

    if args.devices is not None and args.devices > 1:
        raise NotYetPortedError('running on more than one device (--devices)')
    if not args.silent:
        logging.basicConfig(level=logging.INFO,
                            format='%(asctime)s %(levelname)s %(message)s')
    if not os.path.exists(args.config):
        parser.error(f'config not found: {args.config}')
    configs = Config.from_file(args.config)
    if args.search_tree:
        configs = [v for c in configs
                   for v in c.expand_grid_from_path(args.search_tree)]
    logging.info('running %d experiment(s)', len(configs))
    for cfg in configs:
        metrics = BDETrainer(cfg, device=args.device).train(
            report=not args.no_report)
        logging.info('experiment %s finished: %s', cfg.experiment_name,
                     {k: v for k, v in metrics.items()
                      if isinstance(v, (int, float))})
    return 0


if __name__ == '__main__':
    sys.exit(main())
