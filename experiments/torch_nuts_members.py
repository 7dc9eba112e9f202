#!/usr/bin/env python3
"""NUTS from one warm-start member copied into many chains, alone.

    python experiments/torch_nuts_members.py --job NAME --members DIR
        --member I --replicas R [--draws N] [--warmup-steps N] [--depth D]
        [--no-split-k] [--device cuda|cpu]
    python experiments/torch_nuts_members.py --compare A.json B.json

Loads the catalogue job ``NAME``'s settings as ``torch_run_catalog.py
--tpu-arithmetic`` loads them (its base config and overrides, and the
rows' target acceptance of ``TPU_ROWS_NUTS`` where the job names none),
builds its data split, model and posterior, and runs the port's
``run_hmc_family`` from ``R`` copies of member ``I`` of ``DIR`` (a run
directory or its ``warmstart/``; members in id order): the job's
window-adaptation steps (``--warmup-steps`` to cut them), then ``N`` draws
(default 1,000), in exact float32 as the NUTS rows, from the job's sample
stream. NUTS adapts each chain on its own, so the copies are independent
runs of the same member, each with its own draws. ``--depth`` caps the
trees of both phases (a cut run); ``--no-split-k`` keeps the leaf's CUDA
graph on the plain Dense product (as ``torch_run_catalog.py
--no-split-k``).

Prints one JSON line: each chain's adapted ε and the mean log ε with its
standard error over the chains; each chain's acceptance over all draws
and in windows of ``WINDOW`` draws; its divergences, over all draws and
over the first ``FIRST``; its gradient evaluations a draw; whether it
sticks (:func:`sticks`), over all draws and over the first ``FIRST``,
with the counts of chains that do; and the sum of each chain's draws
(copies that run apart give different sums).

``--compare A.json B.json`` reads two such lines (files whose last line is
the record) and prints one JSON line: the chains that stick over each
run's first draws, two by two, with the two-sided Fisher exact test's
p-value and the smallest share of A's chains sticking that the test
would tell from B's observed share with power ``DETECT_POWER``; and the
difference of the mean log ε against three of its standard errors.

Logs the runtime's phases on stderr. Runs on the GPU unless ``--device cpu``
is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'experiments'))

from torch_tune_members import mean_se  # noqa: E402

WINDOW = 100
FIRST = 300
# a chain sticks when its acceptance falls this far under the target or
# more than this share of its draws diverge
STUCK_BELOW_TARGET = 0.3
STUCK_DIVERGENT = 0.1
# the level of the Fisher test, and the power at which --compare states
# the smallest stuck share it can tell
FISHER_ALPHA = 0.05
DETECT_POWER = 0.8


def sticks(acceptance: float, divergent: int, target: float,
           draws: int) -> bool:
    """Whether a chain with mean ``acceptance`` and ``divergent``
    divergences over ``draws`` draws sticks: its acceptance falls more than
    ``STUCK_BELOW_TARGET`` under ``target``, or more than
    ``STUCK_DIVERGENT`` of its draws diverge."""
    return bool(acceptance < target - STUCK_BELOW_TARGET
                or divergent > STUCK_DIVERGENT * draws)


def windows(acceptance: np.ndarray, width: int = WINDOW) -> np.ndarray:
    """Each chain's mean acceptance in consecutive windows of ``width``
    draws (one window of all draws when there are fewer):
    ``(chains, max(1, draws // width))``."""
    chains, draws = acceptance.shape
    width = min(width, draws)
    n = draws // width
    return acceptance[:, :n * width].reshape(chains, n, width).mean(axis=2)


def summarize(step_size, acceptance, divergent, evaluations,
              target: float) -> dict:
    """The record's statistics of a run: ``step_size`` (C,), and
    ``acceptance``, ``divergent`` and ``evaluations`` (C, draws) per draw;
    the early counts over its first ``FIRST`` draws."""
    eps = np.asarray(step_size, np.float64)
    accept = np.asarray(acceptance, np.float64)
    div = np.asarray(divergent, np.int64)
    draws = accept.shape[1]
    first = min(FIRST, draws)
    log_mean, log_se = mean_se(np.log(eps))
    overall = [sticks(a, d, target, draws)
               for a, d in zip(accept.mean(axis=1), div.sum(axis=1))]
    early = [sticks(a, d, target, first) for a, d in
             zip(accept[:, :first].mean(axis=1), div[:, :first].sum(axis=1))]
    return {'draws': draws, 'first': first, 'window': min(WINDOW, draws),
            'target_acceptance': target,
            'step_size': eps.tolist(), 'log_step_size_mean': log_mean,
            'log_step_size_se': log_se,
            'acceptance': accept.mean(axis=1).tolist(),
            'acceptance_windows': windows(accept).tolist(),
            'divergent': div.sum(axis=1).tolist(),
            'divergent_first': div[:, :first].sum(axis=1).tolist(),
            'evaluations': np.asarray(evaluations, np.float64).mean(
                axis=1).tolist(),
            'sticks': overall, 'sticks_first': early,
            'stuck': int(sum(overall)), 'stuck_first': int(sum(early))}


def fisher_p(a: int, n_a: int, b: int, n_b: int) -> float:
    """Two-sided Fisher exact p-value of ``a`` of ``n_a`` against ``b`` of
    ``n_b``: the probability, with the margins fixed, of every table no
    more likely than the one seen."""
    k, n = a + b, n_a + n_b

    def prob(x: int) -> float:
        return math.comb(n_a, x) * math.comb(n_b, k - x) / math.comb(n, k)

    seen = prob(a)
    return min(1.0, sum(p for x in range(max(0, k - n_b), min(k, n_a) + 1)
                        if (p := prob(x)) <= seen * (1 + 1e-7)))


def fisher_power(p_a: float, n_a: int, p_b: float, n_b: int) -> float:
    """The chance that the two-sided Fisher exact test at ``FISHER_ALPHA``
    separates ``n_a`` chains that each stick with probability ``p_a`` from
    ``n_b`` that each stick with ``p_b``."""
    def binom(k: int, n: int, q: float) -> float:
        return math.comb(n, k) * q ** k * (1 - q) ** (n - k)

    return sum(binom(a, n_a, p_a) * binom(b, n_b, p_b)
               for a in range(n_a + 1) for b in range(n_b + 1)
               if fisher_p(a, n_a, b, n_b) <= FISHER_ALPHA)


def detectable_share(n_a: int, p_b: float, n_b: int) -> float | None:
    """The smallest share of ``n_a`` chains sticking, on a grid of
    hundredths at or above ``p_b``, that the Fisher test tells from ``n_b``
    chains sticking at ``p_b`` with at least ``DETECT_POWER``; None if no
    share does."""
    return next((q / 100 for q in range(math.ceil(100 * p_b), 101)
                 if fisher_power(q / 100, n_a, p_b, n_b) >= DETECT_POWER),
                None)


def compare(a: dict, b: dict) -> dict:
    """Two records side by side: the chains that stick over the first
    draws (Fisher's two-sided p, and the share of ``a``'s chains sticking
    that the test would find with ``DETECT_POWER`` at ``b``'s observed
    share) and the mean log ε (difference against three standard errors
    of it)."""
    n_a, n_b = len(a['step_size']), len(b['step_size'])
    diff = a['log_step_size_mean'] - b['log_step_size_mean']
    se = math.hypot(a['log_step_size_se'], b['log_step_size_se'])
    return {'stuck_first': [a['stuck_first'], n_a, b['stuck_first'], n_b],
            'first': [a['first'], b['first']],
            'fisher_p': fisher_p(a['stuck_first'], n_a, b['stuck_first'],
                                 n_b),
            'detectable_stuck_share': detectable_share(
                n_a, b['stuck_first'] / n_b, n_b),
            'log_step_size_diff': diff, 'log_step_size_diff_se': se,
            'within_3se': bool(abs(diff) <= 3 * se)}


def run_members(job: str, members: Path, member: int, replicas: int,
                draws: int = 1000, warmup_steps: int | None = None,
                depth: int | None = None, split_k: bool = True,
                device: str = 'cuda', keep_draws: bool = False) -> dict:
    """Run the job's NUTS from ``replicas`` copies of the member: the
    printed record (module docstring); ``keep_draws`` adds the draws,
    ``(replicas, draws, dim)``, under ``samples`` (not printed)."""
    import torch

    import torch_run_catalog as cat
    from mile_tpu_torch.bayes import BayesianModel
    from mile_tpu_torch.data import build_loader
    from mile_tpu_torch.models import blocks
    from mile_tpu_torch.train import checkpoint as ckpt
    from mile_tpu_torch.train.sampling_hmc import run_hmc_family
    from mile_tpu_torch.utils.device import resolve_device
    from mile_tpu_torch.utils.keys import experiment_keys

    dev = resolve_device(device)
    (found,) = [j for j in cat.build_jobs() if j.name == job]
    found = dataclasses.replace(found, warmstart_from=None)
    updates = {'training.sampler.n_samples': draws,
               'training.sampler.n_thinning': 1}
    if warmup_steps is not None:
        updates['training.sampler.warmup_steps'] = warmup_steps
    if depth is not None:
        updates['training.sampler.max_num_doublings'] = depth
        updates['training.sampler.warmup_max_num_doublings'] = depth
    # the root only names the job's directory: nothing is written there
    cfg = found.config(ROOT / 'results' / 'nuts_members',
                       tpu_arithmetic=True).replace(**updates)
    scfg = cfg.training.sampler
    keys = experiment_keys(cfg.rng)
    loader = build_loader(cfg.data, keys.loader, dev,
                          target_len=cfg.data.target_len)
    bayes = BayesianModel(cfg.get_model(loader.input_shape),
                          scfg.prior_config.build(), cfg.data.task,
                          likelihood_chunk_size=scfg.likelihood_chunk_size,
                          compute_dtype=scfg.compute_dtype)
    src = members / 'warmstart' if (members / 'warmstart').is_dir() \
        else members
    ids = ckpt.list_checkpoints(src)
    one = ckpt.load_params_batch(src, [ids[member]]).astype(np.float32)
    if one.shape[1] != bayes.dim:
        raise ValueError(f'{src} holds members of {one.shape[1]} '
                         f'parameters; {job} has {bayes.dim}')
    position = torch.from_numpy(np.repeat(one, replicas, axis=0)).to(dev)
    x, y = loader.arrays('train')
    before = blocks.SPLIT_K_MIN_ROWS
    if not split_k:
        blocks.SPLIT_K_MIN_ROWS = sys.maxsize
    t0 = time.perf_counter()
    try:
        result = run_hmc_family(bayes.logdensity_and_grad_fn(x, y), scfg,
                                keys.sample, position)
    finally:
        blocks.SPLIT_K_MIN_ROWS = before
    info = result.info
    samples = np.asarray(result.samples, np.float32)
    record = {'job': job, 'members': str(src), 'member': member,
              'replicas': replicas, 'rng': cfg.rng, 'dim': bayes.dim,
              'n_train': int(x.shape[0]), 'device': str(dev),
              'split_k': split_k,
              'warmup_steps': scfg.warmup_steps,
              'max_num_doublings': scfg.max_num_doublings,
              'warmup_max_num_doublings': scfg.warmup_max_num_doublings,
              **summarize(result.tuned['step_size'],
                          info['acceptance_rate'], info['is_divergent'],
                          info['num_integration_steps'],
                          scfg.target_acceptance),
              'draw_sums': samples.sum(axis=(1, 2), dtype=np.float64)
              .tolist(),
              'seconds': {**{k: float(v) for k, v in result.seconds.items()},
                          'total': time.perf_counter() - t0}}
    if keep_draws:
        record['samples'] = samples
    return record


def last_record(path: Path) -> dict:
    lines = [ln for ln in Path(path).read_text().splitlines() if ln.strip()]
    return json.loads(lines[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--compare', nargs=2, type=Path, metavar=('A', 'B'))
    p.add_argument('--job')
    p.add_argument('--members', type=Path,
                   help='a run directory (or its warmstart/)')
    p.add_argument('--member', type=int)
    p.add_argument('--replicas', type=int)
    p.add_argument('--draws', type=int, default=1000)
    p.add_argument('--warmup-steps', type=int, default=None)
    p.add_argument('--depth', type=int, default=None,
                   help='the trees\' depth cap in both phases')
    p.add_argument('--no-split-k', action='store_true',
                   help="the leaf's CUDA graph takes the plain Dense "
                        'product (mile_tpu_torch.models.blocks.split_k_rows)')
    p.add_argument('--device', default='cuda',
                   help="torch device (default 'cuda'; 'cpu' to run on "
                        'the CPU)')
    args = p.parse_args(argv)
    if args.compare:
        a, b = (last_record(f) for f in args.compare)
        print(json.dumps(compare(a, b)), flush=True)
        return 0
    missing = [k for k in ('job', 'members', 'member', 'replicas')
               if getattr(args, k) is None]
    if missing:
        p.error('needs ' + ', '.join(f'--{k}' for k in missing))
    # the runtime's phase lines, stamped, on stderr
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
    record = run_members(args.job, args.members, args.member, args.replicas,
                         draws=args.draws, warmup_steps=args.warmup_steps,
                         depth=args.depth, split_k=not args.no_split_k,
                         device=args.device)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
