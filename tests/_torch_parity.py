"""Shared set-up of the PyTorch port's parity tests.

The same inputs, made with numpy from a seed, go through the JAX package
(the reference, on the CPU) and the port (on the CPU, where every kernel
wrapper computes its plain PyTorch version). Data crosses between the two
as numpy arrays.
"""
import jax
import numpy as np
import pytest
import torch

AIRFOIL = dict(path='data/airfoil.data', train_split=0.7, valid_split=0.1,
               test_split=0.2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch to one thread: the suite runs several pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_airfoil(hidden=(16, 16, 16, 2), seed=0):
    """(loader, module, template params, BayesianModel) of the JAX package."""
    from mile_tpu.bayes import BayesianModel
    from mile_tpu.bayes.priors import Prior
    from mile_tpu.config.data import DataConfig, Task
    from mile_tpu.config.models import FCNConfig
    from mile_tpu.config.training import PriorDist
    from mile_tpu.data import TabularLoader
    from mile_tpu.models import build_model
    from mile_tpu.utils.keys import experiment_keys

    loader = TabularLoader(DataConfig(task=Task.REGRESSION, **AIRFOIL),
                           experiment_keys(seed).loader)
    module = build_model(FCNConfig(hidden_structure=list(hidden)))
    x, _ = loader.arrays('train')
    template = module.init(jax.random.PRNGKey(seed), x[:1])['params']
    bayes = BayesianModel(module, template,
                          Prior.from_name(PriorDist.STANDARD_NORMAL),
                          Task.REGRESSION)
    return loader, module, template, bayes


def torch_airfoil(hidden=(16, 16, 16, 2), seed=0):
    """(loader, model, BayesianModel) of the port, on the CPU."""
    from mile_tpu_torch.bayes import BayesianModel
    from mile_tpu_torch.bayes.priors import Prior
    from mile_tpu_torch.config.data import DataConfig, Task
    from mile_tpu_torch.config.models import FCNConfig
    from mile_tpu_torch.config.training import PriorDist
    from mile_tpu_torch.data import TabularLoader
    from mile_tpu_torch.models import build_model
    from mile_tpu_torch.utils.keys import experiment_keys

    loader = TabularLoader(DataConfig(task=Task.REGRESSION, **AIRFOIL),
                           experiment_keys(seed).loader)
    model = build_model(FCNConfig(hidden_structure=list(hidden)),
                        loader.n_features)
    bayes = BayesianModel(model, Prior.from_name(PriorDist.STANDARD_NORMAL),
                          Task.REGRESSION)
    return loader, model, bayes


def unit_rows(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    u = rng.normal(size=(n, dim)).astype(np.float32)
    return u / np.linalg.norm(u, axis=1, keepdims=True)


def t(a) -> torch.Tensor:
    """numpy (or JAX) array -> CPU float32 torch tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))
