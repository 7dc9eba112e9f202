"""Both packages' MCLMC tuners at full counts from the same members, on the
CPU, in exact float32: the ``dtype_ab`` study's exact-tuned arm
(``f32strict``: ``configs/illustrative_airfoil_mclmc.yaml``, airfoil, FCN
[16, 16, 16, 2], 674 parameters, 12 chains, 50,000 tuner steps, of which
the last 5,000 are the phase-3 trace).

The port's trainer warm-starts the config's 12 members for seeds 1-3.
The JAX package's ``mclmc_tune`` (vmapped over the chains, jitted, as
``test_torch_tuner_parity.py`` runs it) and the port's, through
``experiments/torch_tune_members.py`` in a process of its own per seed
(one thread each, all three beside the JAX runs), tune the same members
with their own noise. Printed: ε and L, their means with standard errors
over the 36 chains, and the mean of the per-chain differences (the same
member on both sides) with its standard error. Held: the port's and the
JAX means of ε and L agree within 3 standard errors of the paired
differences.

The ``feasibility`` study's energy jobs the same way
(``configs/feasibility/feas.yaml``: the 10-layer FCN, 2,354 parameters,
12 chains, 50,000 steps; the naive arm and the tuned arm with diagonal
preconditioning): the port warm-starts the members at the TPU's one
bfloat16 pass, as the study ran on the card, and three tuners start from
them: the JAX package's and the port's in exact float32, and the port's
at the one pass (``torch_tune_members.py --tpu-arithmetic``). Printed:
each tuner's ε and L per chain, the chains whose ε fell below 1e-6 (the
study's failure) and those whose L is not finite (phase 3 rejects no
step in either package, so a chain whose trace diverges there gets a NaN
L). Held: ε collapses on at least 10 of the 12 chains under every tuner,
exact or at the one pass: the collapse is the 10-layer net's.

Marked ``slow`` and outside the tier-1 run: 50,000 steps of 12 chains
take the port about 12 minutes a seed on one CPU thread (the 10-layer
net about 15), and the tuners run side by side (minutes more).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow

ROOT = Path(__file__).resolve().parent.parent
CONFIG = 'configs/illustrative_airfoil_mclmc.yaml'
SEEDS = (1, 2, 3)
STEPS = 50_000
ARM = {'training.sampler.matmul_precision': 'float32'}    # f32strict


def warm_start(rng: int, root: Path) -> Path:
    """The port's warm start of the config's members for seed ``rng``: the
    run directory."""
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    (cfg,) = Config.from_file(ROOT / CONFIG)
    cfg = cfg.replace(**{'saving_dir': str(root), 'rng': rng,
                         'experiment_name': f'airfoil_r{rng}', **ARM})
    trainer = BDETrainer(cfg, device='cpu')
    trainer.train_warmstart()
    return trainer.exp_dir


def port_tune(members: Path, rng: int, config: str = CONFIG,
              arm: dict = ARM, extra=()) -> subprocess.Popen:
    """The port's tuner on ``members``, in a process of its own."""
    cmd = [sys.executable, str(ROOT / 'experiments' / 'torch_tune_members.py'),
           '--config', str(ROOT / config), '--members', str(members),
           '--steps', str(STEPS), '--set', f'rng={rng}', '--device', 'cpu',
           *extra]
    for key, value in arm.items():
        cmd += ['--set', f'{key}={value}']
    env = {**os.environ, 'OMP_NUM_THREADS': '1', 'MKL_NUM_THREADS': '1'}
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            text=True)


def jax_tune(members: Path, rng: int, root: Path, config: str = CONFIG,
             arm: dict = ARM):
    """The JAX package's tuner on ``members`` with the config's knobs: (ε,
    L) per chain."""
    import jax
    import jax.numpy as jnp

    from mile_tpu.config import Config as JaxConfig
    from mile_tpu.mcmc.adaptation.mclmc_tuning import TuningConfig
    from mile_tpu.mcmc.adaptation.mclmc_tuning import mclmc_tune
    from mile_tpu.train.trainer import BDETrainer as JaxTrainer
    from mile_tpu_torch.train import checkpoint as ckpt

    (cfg,) = JaxConfig.from_file(ROOT / config)
    cfg = cfg.replace(**{'saving_dir': str(root / 'jax'), 'rng': rng,
                         'experiment_name': members.name, **arm})
    trainer = JaxTrainer(cfg)
    x, y = trainer.loader.arrays('train')
    logdensity = trainer.bayes.logdensity_fn(x, y)
    s = cfg.training.sampler
    tcfg = TuningConfig(
        warmup_steps=STEPS, step_size_init=s.step_size_init,
        desired_energy_var_start=s.desired_energy_var_start,
        desired_energy_var_end=s.desired_energy_var_end,
        trust_in_estimate=s.trust_in_estimate,
        num_effective_samples=s.num_effective_samples,
        diagonal_preconditioning=s.diagonal_preconditioning)
    src = members / 'warmstart'
    position = ckpt.load_params_batch(src, ckpt.list_checkpoints(src)[:12])
    _, params = jax.jit(jax.vmap(
        lambda p, k: mclmc_tune(logdensity, p, k, tcfg)))(
        jnp.asarray(position), jax.random.split(jax.random.PRNGKey(rng),
                                                len(position)))
    return np.asarray(params.step_size), np.asarray(params.L)


def mean_se(v):
    v = np.asarray(v, dtype=np.float64)
    return v.mean(), v.std(ddof=1) / np.sqrt(len(v))


def test_exact_tuned_eps_and_L_agree_at_full_counts(tmp_path):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        members = {r: warm_start(r, tmp_path) for r in SEEDS}
    finally:
        torch.set_num_threads(prev)
    procs = {r: port_tune(members[r], r) for r in SEEDS}
    ref = {r: jax_tune(members[r], r, tmp_path) for r in SEEDS}
    port = {}
    for r, proc in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0
        port[r] = json.loads(out.strip().splitlines()[-1])
    record = {}
    for i, name in enumerate(('step_size', 'L')):
        want = np.concatenate([ref[r][i] for r in SEEDS])
        got = np.concatenate([port[r][name] for r in SEEDS])
        assert np.isfinite(got).all() and np.isfinite(want).all()
        (jm, jse), (pm, pse) = mean_se(want), mean_se(got)
        dm, dse = mean_se(got - want)
        record[name] = {'jax': [jm, jse], 'port': [pm, pse],
                        'paired_diff': [dm, dse],
                        'per_seed_jax': [float(ref[r][i].mean())
                                         for r in SEEDS],
                        'per_seed_port': [float(np.mean(port[r][name]))
                                          for r in SEEDS]}
    print(json.dumps(record))
    for name, rec in record.items():
        dm, dse = rec['paired_diff']
        assert abs(dm) < 3 * dse, (name, rec)


FEAS = 'configs/feasibility/feas.yaml'
FEAS_RNG = 4                                        # the config's rng
FEAS_ARMS = {'naive': {'data.path': 'data/energy.data'},
             'tuned': {'data.path': 'data/energy.data',
                       'training.sampler.diagonal_preconditioning': True}}
EPS_FAILS_BELOW = 1e-6


@pytest.mark.parametrize('arm', sorted(FEAS_ARMS))
def test_feasibility_energy_tuners_from_the_same_members(tmp_path, arm):
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer
    from mile_tpu_torch.utils import precision

    over = FEAS_ARMS[arm]
    (cfg,) = Config.from_file(ROOT / FEAS)
    cfg = cfg.replace(**{'saving_dir': str(tmp_path),
                         'experiment_name': f'energy_{arm}', **over})
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    precision.set_none_precision('bfloat16')
    try:
        trainer = BDETrainer(cfg, device='cpu')
        trainer.train_warmstart()
    finally:
        precision.set_none_precision('float32')
        torch.set_num_threads(prev)
    members = trainer.exp_dir
    procs = {'port_exact': port_tune(members, FEAS_RNG, FEAS, over),
             'port_one_pass': port_tune(members, FEAS_RNG, FEAS, over,
                                        ['--tpu-arithmetic'])}
    out = {'jax_exact': jax_tune(members, FEAS_RNG, tmp_path, FEAS, over)}
    for name, proc in procs.items():
        stdout, _ = proc.communicate()
        assert proc.returncode == 0
        record = json.loads(stdout.strip().splitlines()[-1])
        out[name] = (np.asarray(record['step_size']),
                     np.asarray(record['L']))
    record = {name: {'step_size': eps.tolist(), 'L': L.tolist(),
                     'collapsed': int((eps < EPS_FAILS_BELOW).sum()),
                     'L_not_finite': int((~np.isfinite(L)).sum())}
              for name, (eps, L) in out.items()}
    print(json.dumps({'arm': arm, **record}))
    for name, rec in record.items():
        assert rec['collapsed'] >= 10, (name, rec)
