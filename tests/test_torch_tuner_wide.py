"""The MCLMC tuner above ``ess_params_limit``: the ``complexity`` study's
widest net, FCN [48, 48, 48, 2] on bikesharing (dim 5,426; the tuner's
phase 3 takes each chain's ESS over 2,000 of its coordinates), against the
JAX package's ``mclmc_tune`` on the same posterior and start.

The posterior is cut to a slice of bikesharing (``datapoint_limit`` 366:
256 training rows), so that a few hundred tuner steps of 16 chains run in
seconds. Each package tunes 16 chains from one start with its own noise;
the tuned ε and L are compared as statistics over the seeds, as
``test_torch_tuning.py`` does at airfoil's dim 674: the means of log ε
and log L agree within 4 standard errors and 15 %, and their spreads
within a factor of 2. Phases 1-2 set ε by the Var[ΔE] = O(ε⁶) law (a
fault there moves every chain's ε); phase 3 sets L from ε and the ESS of
its trace.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread, t  # noqa: F401

BIKE = dict(path='data/bikesharing.data', train_split=0.7, valid_split=0.1,
            test_split=0.2, datapoint_limit=366)
HIDDEN = (48, 48, 48, 2)
N_SEEDS = 16
KNOBS = dict(warmup_steps=300, step_size_init=0.001,
             desired_energy_var_start=0.5, desired_energy_var_end=0.1)


def _posteriors():
    """(JAX log-density, the port's log-density and gradient, dim) on the
    same 256 training rows."""
    from mile_tpu.bayes import BayesianModel as JaxBayes
    from mile_tpu.bayes.priors import Prior as JaxPrior
    from mile_tpu.config.data import DataConfig as JaxData
    from mile_tpu.config.data import Task as JaxTask
    from mile_tpu.config.models import FCNConfig as JaxFCN
    from mile_tpu.config.training import PriorDist as JaxDist
    from mile_tpu.data import TabularLoader as JaxLoader
    from mile_tpu.models import build_model as jax_build
    from mile_tpu.utils.keys import experiment_keys as jax_keys
    from mile_tpu_torch.bayes import BayesianModel
    from mile_tpu_torch.bayes.priors import Prior
    from mile_tpu_torch.config.data import DataConfig, Task
    from mile_tpu_torch.config.models import FCNConfig
    from mile_tpu_torch.config.training import PriorDist
    from mile_tpu_torch.data import TabularLoader
    from mile_tpu_torch.models import build_model
    from mile_tpu_torch.utils.keys import experiment_keys

    jl = JaxLoader(JaxData(task=JaxTask.REGRESSION, **BIKE),
                   jax_keys(1).loader)
    module = jax_build(JaxFCN(hidden_structure=list(HIDDEN)))
    x, y = jl.arrays('train')
    template = module.init(jax.random.PRNGKey(1), x[:1])['params']
    jb = JaxBayes(module, template,
                  JaxPrior.from_name(JaxDist.STANDARD_NORMAL),
                  JaxTask.REGRESSION)
    tl = TabularLoader(DataConfig(task=Task.REGRESSION, **BIKE),
                       experiment_keys(1).loader)
    tb = BayesianModel(build_model(FCNConfig(hidden_structure=list(HIDDEN)),
                                   tl.n_features),
                       Prior.from_name(PriorDist.STANDARD_NORMAL),
                       Task.REGRESSION)
    tx, ty = tl.arrays('train')
    assert np.array_equal(np.asarray(x), tx.numpy()) and len(tx) == 256
    return jb.logdensity_fn(x, y), tb.logdensity_and_grad_fn(tx, ty), tb.dim


def test_tuned_eps_and_L_above_ess_params_limit_match_jax():
    from mile_tpu.mcmc.adaptation.mclmc_tuning import TuningConfig as JaxCfg
    from mile_tpu.mcmc.adaptation.mclmc_tuning import mclmc_tune as jax_tune
    from mile_tpu_torch.mcmc.adaptation.mclmc_tuning import (
        TuningConfig,
        mclmc_tune,
    )

    logdensity, vg, dim = _posteriors()
    assert dim == 5_426 > TuningConfig().ess_params_limit
    start = np.random.default_rng(0).normal(size=(1, dim)) * 0.3
    theta = np.repeat(start, N_SEEDS, axis=0).astype(np.float32)
    _, ref = jax.jit(jax.vmap(
        lambda p, k: jax_tune(logdensity, p, k, JaxCfg(**KNOBS))))(
        theta, jax.random.split(jax.random.PRNGKey(3), N_SEEDS))
    _, params = mclmc_tune(vg, t(theta), torch.Generator().manual_seed(1),
                           TuningConfig(**KNOBS))
    for want, got in ((np.asarray(ref.step_size), params.step_size.numpy()),
                      (np.asarray(ref.L), params.L.numpy())):
        assert np.isfinite(got).all() and np.isfinite(want).all()
        a, b = np.log(want), np.log(got)
        se = np.sqrt((a.var() + b.var()) / N_SEEDS)
        assert abs(a.mean() - b.mean()) < min(4 * se, 0.15), (a, b)
        assert 0.5 < b.std() / a.std() < 2.0, (a, b)
