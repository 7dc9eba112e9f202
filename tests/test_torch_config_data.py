"""The port's configuration, random streams and tabular data against the JAX
package: the same YAMLs load to the same values, and the airfoil split is
bit-identical."""
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import AIRFOIL, one_torch_thread  # noqa: F401

from mile_tpu.config import Config as JaxConfig
from mile_tpu_torch.config import Config, ConfigError, OptimizerConfig

ROOT = Path(__file__).resolve().parents[1]
TABULAR_CONFIGS = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / 'configs').rglob('*.yaml')
    if "data_type: 'tabular'" in p.read_text()
    or 'data_type: tabular' in p.read_text())


def test_every_tabular_config_is_covered():
    assert len(TABULAR_CONFIGS) >= 20
    assert 'configs/illustrative_airfoil_mclmc.yaml' in TABULAR_CONFIGS


@pytest.mark.parametrize('path', TABULAR_CONFIGS)
def test_tabular_yaml_loads_to_the_same_values(path):
    ours = Config.from_file(ROOT / path)
    ref = JaxConfig.from_file(ROOT / path)
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in ref]


def test_pallas_integrator_name_loads():
    (cfg,) = Config.from_file(ROOT / 'configs/illustrative_airfoil_mclmc.yaml')
    cfg = cfg.replace(**{'training.sampler.integrator': 'mclachlan_pallas'})
    assert cfg.training.sampler.integrator == 'mclachlan_pallas'
    with pytest.raises(ConfigError):
        cfg.replace(**{'training.sampler.integrator': 'rk4'})


@pytest.mark.parametrize('name,params,cls,want', [
    ('adamw', {'learning_rate': 0.01, 'b1': 0.8, 'b2': 0.99,
               'weight_decay': 0.001},
     torch.optim.AdamW, {'lr': 0.01, 'betas': (0.8, 0.99),
                         'weight_decay': 0.001}),
    # optax.adamw's default weight decay is 1e-4, torch's 1e-2
    ('adamw', {'learning_rate': 0.02}, torch.optim.AdamW,
     {'lr': 0.02, 'weight_decay': 1e-4}),
    ('adam', {'learning_rate': 0.03, 'eps': 1e-6}, torch.optim.Adam,
     {'lr': 0.03, 'eps': 1e-6}),
    ('sgd', {'learning_rate': 0.1, 'momentum': 0.9}, torch.optim.SGD,
     {'lr': 0.1, 'momentum': 0.9}),
])
def test_optimizers_translate_optax_names(name, params, cls, want):
    p = torch.zeros(3, requires_grad=True)
    opt = OptimizerConfig.from_dict({'name': name, 'parameters': params}
                                    ).build([p])
    assert type(opt) is cls
    for key, value in want.items():
        assert opt.defaults[key] == value


def test_unknown_optimizer_parameter_is_refused():
    with pytest.raises(ConfigError, match='unsupported'):
        OptimizerConfig.from_dict(
            {'name': 'sgd', 'parameters': {'b1': 0.9}}).build(
            [torch.zeros(1, requires_grad=True)])


def test_streams():
    """The loader stream is the JAX package's SeedSequence; the torch
    streams are reproducible and differ from each other."""
    from mile_tpu.utils.keys import experiment_keys as jax_keys
    from mile_tpu_torch.utils.keys import experiment_keys

    ours, ref = experiment_keys(42), jax_keys(42)
    assert np.array_equal(ours.loader.generate_state(4),
                          ref.loader.generate_state(4))
    draws = [torch.rand(4, generator=g) for g in
             (ours.init, ours.train, ours.sample)]
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[1], draws[2])
    assert torch.equal(draws[2], torch.rand(4, generator=ours.sample))


def test_airfoil_split_is_bit_identical():
    from mile_tpu.config.data import DataConfig as JaxDataConfig
    from mile_tpu.config.data import Task as JaxTask
    from mile_tpu.data import TabularLoader as JaxLoader
    from mile_tpu.utils.keys import experiment_keys as jax_keys
    from mile_tpu_torch.config.data import DataConfig, Task
    from mile_tpu_torch.data import build_loader
    from mile_tpu_torch.utils.keys import experiment_keys

    ours = build_loader(DataConfig(task=Task.REGRESSION, **AIRFOIL),
                        experiment_keys(7).loader, 'cpu')
    ref = JaxLoader(JaxDataConfig(task=JaxTask.REGRESSION, **AIRFOIL),
                    jax_keys(7).loader)
    assert ours.n_features == 5
    for split, n in (('train', 1052), ('valid', 150), ('test', 301)):
        x, y = ours.arrays(split)
        rx, ry = ref.arrays(split)
        assert x.dtype == torch.float32 and x.shape == (n, 5)
        assert np.array_equal(x.numpy(), np.asarray(rx))
        assert np.array_equal(y.numpy(), np.asarray(ry))


def test_loader_puts_tensors_on_its_device():
    from mile_tpu_torch.config.data import DataConfig, Task
    from mile_tpu_torch.data import build_loader

    loader = build_loader(DataConfig(task=Task.REGRESSION, **AIRFOIL), 0,
                          device='meta')
    x, y = loader.arrays('test')
    assert x.device.type == 'meta' and y.device.type == 'meta'
