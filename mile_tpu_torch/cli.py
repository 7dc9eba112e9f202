"""Experiment CLI of the port (counterpart of ``mile_tpu/cli.py``).

    python -m mile_tpu_torch -c configs/illustrative_airfoil_mclmc.yaml
    python -m mile_tpu_torch -c configs/illustrative_airfoil_nuts.yaml
    python -m mile_tpu_torch -c configs/debug.yaml --device cpu
    python -m mile_tpu_torch -c configs/ablations/partition_airfoil.yaml
    python -m mile_tpu_torch -c configs/debug.yaml --devices 4
    python -m mile_tpu_torch -c configs/debug.yaml --device cpu --devices 8
    torchrun --nproc-per-node 2 -m mile_tpu_torch -c configs/debug.yaml \\
        --multihost

Each experiment ends with its report (``report.html``, ``diagnostics.csv``)
unless ``--no_report`` is given.

Runs on the GPU unless ``--device cpu`` is given; without a CUDA device
and without that flag it fails rather than run on the CPU. ``--devices N``
builds the chain mesh over N CUDA devices (it raises when fewer are
visible), or over N CPU entries with ``--device cpu``; by default the mesh
takes every visible CUDA device. ``--multihost`` joins the process group
``torchrun`` describes in the environment (with nothing configured it
logs that and runs as one process). ``--outer_parallel`` runs the
experiments of a grid in a pool of processes.
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
                        help='number of devices for the chain mesh (CUDA '
                             'devices, or CPU entries with --device cpu)')
    parser.add_argument('--device_limit', type=int, default=None,
                        help='cap on devices used')
    parser.add_argument('--silent', action='store_true',
                        help='disable console logging')
    parser.add_argument('--outer_parallel', action='store_true',
                        help='run grid experiments in parallel processes')
    parser.add_argument('--no_report', action='store_true',
                        help='skip report generation')
    parser.add_argument('--multihost', action='store_true',
                        help='join the torch.distributed process group '
                             "configured in the environment (torchrun's "
                             'MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) '
                             'before building the chain mesh')
    args = parser.parse_args(argv)

    if args.device_limit and (args.devices is None
                              or args.devices > args.device_limit):
        args.devices = args.device_limit
    if not args.silent:
        logging.basicConfig(level=logging.INFO,
                            format='%(asctime)s %(levelname)s %(message)s')
    joined = False
    if args.multihost:
        from mile_tpu_torch.parallel.distributed import initialize_distributed

        joined = initialize_distributed()

    from mile_tpu_torch.config import Config

    if not os.path.exists(args.config):
        parser.error(f'config not found: {args.config}')
    configs = Config.from_file(args.config)
    if args.search_tree:
        configs = [v for c in configs
                   for v in c.expand_grid_from_path(args.search_tree)]
    logging.info('running %d experiment(s)', len(configs))
    jobs = [(cfg, args.device, args.devices, args.no_report)
            for cfg in configs]
    if args.outer_parallel and len(configs) > 1:
        import multiprocessing as mp

        with mp.get_context('spawn').Pool(
                min(len(configs), os.cpu_count() or 1)) as pool:
            pool.starmap(_run_one, jobs)
    else:
        for job in jobs:
            _run_one(*job)
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def _run_one(config, device, n_devices, no_report) -> None:
    from mile_tpu_torch.train.trainer import BDETrainer

    metrics = BDETrainer(config, device=device, n_devices=n_devices).train(
        report=not no_report)
    logging.info('experiment %s finished: %s', config.experiment_name,
                 {k: v for k, v in metrics.items()
                  if isinstance(v, (int, float))})


if __name__ == '__main__':
    sys.exit(main())
