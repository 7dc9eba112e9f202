"""Shared workload of the port's multi-process test: MCLMC on a small FCN
posterior sharded over a chain mesh, and a tiny airfoil trainer.

Kept apart from the worker so that the single-process reference in
``tests/test_torch_distributed.py`` runs the same code on one process's
mesh of 8 CPU entries.
"""
from pathlib import Path

import numpy as np
import torch
import yaml

CONFIG = (Path(__file__).resolve().parents[1] / 'configs'
          / 'illustrative_airfoil_mclmc.yaml')

N_CHAINS = 8
N_OBS = 200


def posterior():
    """(BayesianModel, x, y) of ``tests/test_data_sharding.py``'s workload
    (FCN [8, 2] on 200 rows of 5 features, made with numpy from a seed)."""
    from mile_tpu_torch.bayes import BayesianModel, Prior
    from mile_tpu_torch.config.data import Task
    from mile_tpu_torch.config.models import FCNConfig
    from mile_tpu_torch.config.training import PriorDist
    from mile_tpu_torch.models import build_model

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(N_OBS, 5)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(N_OBS,)).astype(np.float32))
    model = build_model(FCNConfig(hidden_structure=[8, 2]), 5)
    bayes = BayesianModel(model, Prior.from_name(PriorDist.STANDARD_NORMAL),
                          Task.REGRESSION)
    return bayes, x, y


def run_chains(mesh):
    """``run_mclmc`` over ``mesh``: 8 chains, 30 tuning steps, 12 draws."""
    from mile_tpu_torch.config import SamplerConfig
    from mile_tpu_torch.train.sampling import run_mclmc

    bayes, x, y = posterior()
    init = torch.from_numpy(0.1 * np.random.default_rng(2).normal(
        size=(N_CHAINS, bayes.dim)).astype(np.float32))
    cfg = SamplerConfig(warmup_steps=30, n_chains=N_CHAINS, n_samples=12,
                        step_size_init=0.01)
    return run_mclmc(bayes.logdensity_and_grad_fn(x, y, mesh), cfg,
                     torch.Generator().manual_seed(1), init, mesh=mesh,
                     max_chunk_bytes=4 * N_CHAINS * bayes.dim * 4)


def trainer_config(saving_dir) -> dict:
    """The airfoil config cut to seconds: 4 chains, FCN [4, 2]."""
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg['saving_dir'] = str(saving_dir)
    cfg['experiment_name'] = 'dist'
    cfg['data'].update(datapoint_limit=120)
    cfg['model']['hidden_structure'] = [4, 2]
    cfg['training']['warmstart'].update(max_epochs=2, batch_size=32)
    cfg['training']['sampler'].update(n_chains=4, warmup_steps=20,
                                      n_samples=6, n_thinning=1)
    return cfg
