#!/usr/bin/env python3
"""The port's MCLMC tuner run on a warm start's members, alone.

    python experiments/torch_tune_members.py --config CONFIG.yaml
        --members DIR [--steps N] [--set KEY=VALUE ...] [--tpu-arithmetic]
        [--device cuda|cpu]

``--set`` overrides a config field by its dotted path, the value read as
YAML: ``--set rng=R`` for the seed of the run that made the members (it
sets the data split and the tuner's generator, the run's sample stream),
``--set training.sampler.matmul_precision=float32``. Reads the first
``n_chains`` members of ``DIR/warmstart/params_*.npz`` (or of
``DIR/params_*.npz``) in id order: any run's warm start, the JAX
package's too, as ``warmstart_exp_dir`` reads it. Builds the config's
data split, model and posterior, and tunes the members with the port's
``mclmc_tune`` at the config's knobs, ``--steps`` tuner steps (default
the config's ``warmup_steps``) and the config's tuner precision (its
``warmup_matmul_precision``, or its ``matmul_precision`` where that is
None), as the trainer's warm-up does. ``--tpu-arithmetic`` tunes as
``torch_run_catalog.py --tpu-arithmetic`` runs a job: a None precision
is the TPU's one bfloat16 pass, and a config whose overrides name no
``warmup_matmul_precision`` tunes at None.

Prints one JSON line: the per-chain ``step_size`` and ``L``, their means
with standard errors over the chains, and the phase-3 ESS summary:
``ess_harmonic``, each chain's harmonic mean over its coordinates of the
ESS of its phase-3 trace (``0.4 · ε · n3 / L``, the quantity L is made
of), and ``phase3_draws``, the trace's length. Runs on the GPU unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def mean_se(values) -> tuple[float, float]:
    """Mean and standard error (ddof 1) of the finite ``values``."""
    v = np.asarray(values, dtype=np.float64)
    v = v[np.isfinite(v)]
    if len(v) < 2:
        return (float(v.mean()) if len(v) else math.nan), math.nan
    return float(v.mean()), float(v.std(ddof=1) / math.sqrt(len(v)))


def members_dir(path: Path) -> Path:
    return path / 'warmstart' if (path / 'warmstart').is_dir() else path


def tune_members(config: str, members: Path, steps: int | None = None,
                 overrides: dict | None = None, tpu_arithmetic: bool = False,
                 device: str = 'cuda') -> dict:
    """Tune the members of ``members`` with the port's tuner: the printed
    record (module docstring)."""
    import torch

    from mile_tpu_torch.bayes import BayesianModel
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.data import build_loader
    from mile_tpu_torch.mcmc.adaptation.mclmc_tuning import mclmc_tune
    from mile_tpu_torch.train import checkpoint as ckpt
    from mile_tpu_torch.train.sampling import tuning_config
    from mile_tpu_torch.utils import precision
    from mile_tpu_torch.utils.device import resolve_device
    from mile_tpu_torch.utils.keys import experiment_keys

    dev = resolve_device(device)
    (cfg,) = Config.from_file(config)
    updates = ({'training.sampler.warmup_matmul_precision': None}
               if tpu_arithmetic else {})
    updates.update(overrides or {})
    if steps is not None:
        updates['training.sampler.warmup_steps'] = steps
    cfg = cfg.replace(**updates)
    scfg = cfg.training.sampler
    keys = experiment_keys(cfg.rng)
    loader = build_loader(cfg.data, keys.loader, dev,
                          target_len=cfg.data.target_len)
    model = cfg.get_model(loader.input_shape)
    bayes = BayesianModel(model, scfg.prior_config.build(), cfg.data.task,
                          likelihood_chunk_size=scfg.likelihood_chunk_size,
                          compute_dtype=scfg.compute_dtype)
    src = members_dir(Path(members))
    ids = ckpt.list_checkpoints(src)[: scfg.n_chains]
    if len(ids) < scfg.n_chains:
        raise ValueError(f'{src} holds {len(ids)} members, need '
                         f'{scfg.n_chains}')
    position = torch.as_tensor(ckpt.load_params_batch(src, ids)).to(dev)
    if position.shape[1] != bayes.dim:
        raise ValueError(f'{src} holds members of {position.shape[1]} '
                         f'parameters; the model has {bayes.dim}')
    x, y = loader.arrays('train')
    vg = bayes.logdensity_and_grad_fn(x, y)
    tcfg = tuning_config(scfg)._replace(trace_every=0)
    generator = keys.sample
    before = precision.none_precision()
    precision.set_none_precision('bfloat16' if tpu_arithmetic else before)
    t0 = time.perf_counter()
    try:
        tuner_precision = scfg.warmup_matmul_precision or scfg.matmul_precision
        arithmetic = precision.resolve(tuner_precision)
        with precision.matmul_precision(tuner_precision):
            _, params = mclmc_tune(vg, position, generator, tcfg)
    finally:
        precision.set_none_precision(before)
    eps = params.step_size.cpu().double().numpy()
    L = params.L.cpu().double().numpy()
    seconds = time.perf_counter() - t0
    n3 = int(tcfg.warmup_steps * tcfg.phase_ratio[2])
    ess = 0.4 * eps * n3 / L
    eps_mean, eps_se = mean_se(eps)
    L_mean, L_se = mean_se(L)
    return {'config': str(config), 'members': str(src), 'rng': cfg.rng,
            'dim': bayes.dim, 'chains': scfg.n_chains,
            'steps': tcfg.warmup_steps, 'device': str(dev),
            'tuner_arithmetic': arithmetic,
            'step_size': eps.tolist(), 'L': L.tolist(),
            'step_size_mean': eps_mean, 'step_size_se': eps_se,
            'L_mean': L_mean, 'L_se': L_se,
            'phase3_draws': n3, 'ess_harmonic': ess.tolist(),
            'seconds': seconds}


def parse_set(items) -> dict:
    out = {}
    for item in items:
        key, sep, value = item.partition('=')
        if not sep:
            raise SystemExit(f'--set takes KEY=VALUE, got {item!r}')
        out[key] = yaml.safe_load(value)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--config', required=True)
    p.add_argument('--members', required=True, type=Path,
                   help='a run directory (or its warmstart/)')
    p.add_argument('--steps', type=int, default=None)
    p.add_argument('--set', action='append', default=[], metavar='KEY=VALUE')
    p.add_argument('--tpu-arithmetic', action='store_true',
                   help='a None precision is one bfloat16 pass, and the '
                        'tuner runs at None unless --set names its '
                        'precision')
    p.add_argument('--device', default='cuda',
                   help="torch device (default 'cuda'; 'cpu' to run on "
                        'the CPU)')
    args = p.parse_args(argv)
    record = tune_members(args.config, args.members, steps=args.steps,
                          overrides=parse_set(args.set),
                          tpu_arithmetic=args.tpu_arithmetic,
                          device=args.device)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
