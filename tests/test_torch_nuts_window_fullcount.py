"""The NUTS window adaptation of both packages from the same members, on
the CPU, at the ``datasize`` study's protein n10000 cell (marked
``slow``: about a quarter of an hour on the CPU; outside tier-1).

Members: the port's warm start of ``protein_nuts_n10000_r2``'s config on
the CPU at the TPU's one bfloat16 pass (the study's arithmetic), seed 2.
From them each package runs its HMC-family runtime as the study job does:
NUTS at depth 8 in both phases, target acceptance 0.9, the rows' 100
window-adaptation steps, then ``DRAWS`` draws, in exact float32. The two
draw from different generators, so the comparison is statistical over
the 12 chains: the adapted ε paired by chain (the log ratio's mean against
three of its standard errors), and the draws' mean acceptance and leapfrog
steps a draw against three standard errors of their difference. The test
prints every number (``-s``).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'experiments'))

pytestmark = pytest.mark.slow

JOB = 'protein_nuts_n10000_r2'
DRAWS = 100
THREADS = 4


def _se(v) -> float:
    v = np.asarray(v, dtype=np.float64)
    return float(v.std(ddof=1) / np.sqrt(len(v)))


def test_nuts_window_adaptation_from_the_same_members(tmp_path):
    import jax
    import jax.numpy as jnp
    import torch

    import torch_run_catalog as cat
    from mile_tpu.config import Config as JaxConfig
    from mile_tpu.train.sampling_hmc import run_hmc_family as jax_run
    from mile_tpu.train.trainer import BDETrainer as JaxTrainer
    from mile_tpu_torch.train.sampling_hmc import run_hmc_family
    from mile_tpu_torch.train.trainer import BDETrainer
    from mile_tpu_torch.utils import precision

    prev_threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    # the members are warm-started here: no provider
    (job,) = [dataclasses.replace(j, warmstart_from=None)
              for j in cat.build_jobs() if j.name == JOB]
    overrides = {**job.overrides, 'training.sampler.n_samples': DRAWS}
    updates = {'saving_dir': str(tmp_path), 'experiment_name': JOB,
               **overrides}
    try:
        precision.set_none_precision('bfloat16')
        config = job.config(tmp_path, tpu_arithmetic=True).replace(
            **updates)
        trainer = BDETrainer(config, device='cpu')
        members = trainer.train_warmstart()
        precision.set_none_precision('float32')
        scfg = config.training.sampler
        assert (scfg.max_num_doublings, scfg.warmup_max_num_doublings,
                scfg.target_acceptance, scfg.warmup_steps) == (8, 8, 0.9,
                                                                100)
        x, y = trainer.loader.arrays('train')
        ours = run_hmc_family(trainer.bayes.logdensity_and_grad_fn(x, y),
                              scfg, torch.Generator().manual_seed(7),
                              members)
    finally:
        precision.set_none_precision('float32')
        torch.set_num_threads(prev_threads)

    (jcfg,) = JaxConfig.from_file(ROOT / job.base)
    jcfg = jcfg.replace(**{**updates, 'saving_dir': str(tmp_path / 'jax')})
    jtrainer = JaxTrainer(jcfg)
    jx, jy = jtrainer.loader.arrays('train')
    assert jx.shape[0] == x.shape[0] == 9000
    theirs = jax_run(jtrainer.bayes.logdensity_fn(jx, jy),
                     jcfg.training.sampler, jax.random.PRNGKey(7),
                     jnp.asarray(members.numpy()))

    def stats(result):
        info = result.info
        return {'eps': np.asarray(result.tuned['step_size'], np.float64),
                'accept': np.asarray(info['acceptance_rate']).mean(axis=1),
                'steps': np.asarray(info['num_integration_steps'],
                                    np.float64).mean(axis=1),
                'divergent': int(np.sum(info['is_divergent']))}

    a, b = stats(ours), stats(theirs)
    log_ratio = np.log(a['eps'] / b['eps'])
    print(f'\nport ε {a["eps"].mean():.6f} ± {_se(a["eps"]):.6f}, JAX '
          f'{b["eps"].mean():.6f} ± {_se(b["eps"]):.6f}; paired log ratio '
          f'{log_ratio.mean():+.4f} ± {_se(log_ratio):.4f}')
    for k in ('accept', 'steps'):
        print(f'{k}: port {a[k].mean():.4f} ± {_se(a[k]):.4f}, JAX '
              f'{b[k].mean():.4f} ± {_se(b[k]):.4f}')
    print(f'divergent over {DRAWS} draws x 12 chains: port '
          f'{a["divergent"]}, JAX {b["divergent"]}')
    assert abs(log_ratio.mean()) <= 3 * _se(log_ratio)
    for k in ('accept', 'steps'):
        assert abs(a[k].mean() - b[k].mean()) <= 3 * np.hypot(_se(a[k]),
                                                              _se(b[k]))
