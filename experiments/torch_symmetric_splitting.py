#!/usr/bin/env python3
"""Symmetric-split HMC baseline on LeNet / FashionMNIST, in the PyTorch
port (counterpart of ``experiments/symmetric_splitting.py``).

Minibatch HMC where each leapfrog step sweeps the data shards with a
palindromic Strang splitting (:mod:`mile_tpu_torch.mcmc.split_hmc`), so
the gradient never touches the full dataset at once. Reports majority-vote
accuracy and LPPD on the test set and prints, as its last line, one JSON
object: ``accuracy``, ``lppd``, ``acceptance_rate``, ``n_samples``,
``sampling_time_s``.

Reference hyperparameters: step_size 5e-4, 30 leapfrog steps a proposal,
3300 samples, burn 299, batch 64, mass 0.01 (inverse mass 100), a
standard-normal prior. ``--datapoint-limit`` gives a smoke-scale run.
It runs on the GPU unless ``--device cpu`` is given:

    python experiments/torch_symmetric_splitting.py            # paper scale
    python experiments/torch_symmetric_splitting.py --source local \\
        --dataset archive.npz --datapoint-limit 4096 --num-samples 100 \\
        --burn 20 --device cpu                                 # smoke
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--dataset', default='FashionMNIST')
    p.add_argument('--source', default='torchvision',
                   help="'torchvision' or 'local' (.npz with x/y)")
    p.add_argument('--batch-size', type=int, default=64)
    p.add_argument('--step-size', type=float, default=5e-4)
    p.add_argument('--num-steps', type=int, default=30,
                   help='leapfrog steps per proposal')
    p.add_argument('--num-samples', type=int, default=3300)
    p.add_argument('--burn', type=int, default=299)
    p.add_argument('--mass', type=float, default=0.01)
    p.add_argument('--datapoint-limit', type=int, default=None)
    p.add_argument('--eval-limit', type=int, default=None,
                   help='cap test points for evaluation')
    p.add_argument('--seed', type=int, default=123)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def setup(args: argparse.Namespace) -> SimpleNamespace:
    """The data, LeNet, the posterior split into ``M = n_train // batch``
    shards of the training set on the device, the shard potential, the
    first position and the kernel's arguments."""
    from mile_tpu_torch.bayes import BayesianModel, Prior
    from mile_tpu_torch.config import (
        DataConfig,
        DatasetType,
        PriorDist,
        Source,
        Task,
    )
    from mile_tpu_torch.config.models import LeNetConfig
    from mile_tpu_torch.data.image import ImageLoader
    from mile_tpu_torch.models import build_model
    from mile_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    data_cfg = DataConfig(
        path=args.dataset,
        source=(Source.TORCHVISION if args.source == 'torchvision'
                else Source.LOCAL),
        data_type=DatasetType.IMAGE,
        task=Task.CLASSIFICATION,
        datapoint_limit=args.datapoint_limit,
        # the reference's 54k train / 6k valid / 10k test = 77/9/14
        train_split=0.77, valid_split=0.09, test_split=0.14,
    )
    loader = ImageLoader(data_cfg, 0, device)
    x_train, y_train = loader.arrays('train')
    x_test, y_test = loader.arrays('test')
    if args.eval_limit:
        x_test, y_test = x_test[:args.eval_limit], y_test[:args.eval_limit]

    model = build_model(LeNetConfig(out_dim=10), loader.input_shape)
    # prior precision tau = 1: a standard normal
    bayes = BayesianModel(model, Prior.from_name(PriorDist.STANDARD_NORMAL),
                          Task.CLASSIFICATION)
    B = args.batch_size
    M = int(x_train.shape[0]) // B
    x_shards = x_train[: M * B].reshape(M, B, *x_train.shape[1:])
    y_shards = y_train[: M * B].reshape(M, B)
    theta0 = model.init(1, torch.Generator().manual_seed(args.seed))
    return SimpleNamespace(
        device=device, model=model, bayes=bayes, n_shards=M,
        n_train=int(x_train.shape[0]), x_test=x_test, y_test=y_test,
        shard_potential=bayes.shard_potential_fn(x_shards, y_shards),
        theta0=theta0.to(device),
        inverse_mass_matrix=torch.full((bayes.dim,), 1.0 / args.mass,
                                       device=device),
        step_size=args.step_size)


def evaluate(problem: SimpleNamespace, draws: torch.Tensor) -> tuple:
    """Majority-vote accuracy and LPPD of the draws (S, dim) on the test
    set, one draw's forward at a time."""
    from mile_tpu_torch.config import Task
    from mile_tpu_torch.inference.metrics import lppd, pointwise_lppd

    x, y = problem.x_test, problem.y_test
    with torch.no_grad():
        logits = torch.stack([problem.model(theta[None], x)[0]
                              for theta in draws])          # (S, n_test, 10)
    votes = torch.argmax(logits, dim=-1)                    # (S, n_test)
    counts = torch.nn.functional.one_hot(votes, 10).sum(0)  # majority vote
    accuracy = float(torch.mean((torch.argmax(counts, dim=-1) == y)
                                .to(torch.float32)))
    test_lppd = float(lppd(pointwise_lppd(logits, y, Task.CLASSIFICATION)))
    return accuracy, test_lppd


def main(argv=None) -> dict:
    args = parse_args(argv)
    from mile_tpu_torch.mcmc import split_hmc
    from mile_tpu_torch.mcmc.hmc import Draws
    from mile_tpu_torch.utils.precision import matmul_precision

    problem = setup(args)
    print(f'dim={problem.bayes.dim} shards={problem.n_shards} '
          f'batch={args.batch_size} train={problem.n_train} '
          f'test={int(problem.x_test.shape[0])} device={problem.device}')
    kernel = split_hmc.build_kernel(
        problem.shard_potential, problem.n_shards,
        num_integration_steps=args.num_steps,
        draws=Draws(torch.Generator(device=problem.device)
                    .manual_seed(args.seed)))
    # the MH test reads O(1) energy differences: exact float32 (TF32 off)
    with matmul_precision('float32'):
        state = split_hmc.init(problem.theta0, problem.shard_potential,
                               problem.n_shards)
        # one proposal = 2·M·L shard gradients; the position goes to the
        # host after each draw
        draws, accepts = [], []
        t0 = time.time()
        for i in range(args.num_samples):
            state, info = kernel(state, problem.step_size,
                                 problem.inverse_mass_matrix)
            if i >= args.burn:
                draws.append(state.position[0].cpu())
            accepts.append(bool(info.is_accepted[0]))
            if (i + 1) % 50 == 0:
                print(f'sample {i + 1}/{args.num_samples} '
                      f'acc_rate={sum(accepts) / len(accepts):.3f} '
                      f'({time.time() - t0:.1f}s)', flush=True)
        sampling_time = time.time() - t0
        accuracy, test_lppd = evaluate(
            problem, torch.stack(draws).to(problem.device))

    result = {
        'accuracy': accuracy,
        'lppd': test_lppd,
        'acceptance_rate': sum(accepts) / len(accepts),
        'n_samples': len(draws),
        'sampling_time_s': round(sampling_time, 1),
    }
    print(f'Accuracy: {accuracy}')
    print(f'LPPD: {test_lppd}')
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
