"""The port's image path against the JAX package: the image loader's splits,
the trainer end to end on LeNetti and LeNet (its draws read and evaluated
by the JAX package), NUTS and HMC on LeNetti, the empty test split, the
float32 rule of the warm start, and the models that once were not ported."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from _torch_parity import one_torch_thread  # noqa: F401
from jax.flatten_util import ravel_pytree

ROOT = Path(__file__).resolve().parents[1]


def archive(path, layout='xy', n=120, shape=(8, 8), n_classes=3,
            dtype=np.uint8, seed=0):
    """A synthetic image archive with a class-dependent mean (so that a
    model can learn something), as ``tests/test_modality_e2e.py`` makes
    one (there: 300 float32 images of 8x8 in 3 classes, seed 0).
    ``layout``: 'xy' (keys x, y) or 'split' (train_x ... test_y)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    x = rng.normal(size=(n, *shape)) * 20 + y.reshape(
        -1, *[1] * len(shape)) * min(40.0, 240.0 / n_classes)
    x = np.clip(x, 0, 255).astype(dtype)
    if layout == 'xy':
        np.savez(path, x=x, y=y)
    else:
        a, b = n // 2, 3 * n // 4
        np.savez(path, train_x=x[:a], train_y=y[:a], valid_x=x[a:b],
                 valid_y=y[a:b], test_x=x[b:], test_y=y[b:])
    return path


def data_configs(path, **fields):
    from mile_tpu.config.data import DataConfig as JaxDataConfig
    from mile_tpu_torch.config.data import DataConfig

    data = dict(path=str(path), data_type='image', task='class',
                train_split=0.7, valid_split=0.1, test_split=0.2, **fields)
    return DataConfig.from_dict(data), JaxDataConfig.from_dict(data)


@pytest.mark.parametrize('layout,shape,fields', [
    ('xy', (8, 8), {}),
    ('split', (8, 8), {}),
    ('xy', (3, 6, 6), {}),
    ('xy', (8, 8), {'datapoint_limit': 50}),
    ('split', (2, 5, 7), {'datapoint_limit': 77, 'normalize': False}),
], ids=['x-y NHW', 'pre-split NHW', 'x-y NCHW', 'limit', 'pre-split NCHW'])
def test_image_splits_are_bit_identical(tmp_path, layout, shape, fields):
    """Each split's images and labels equal the JAX ImageLoader's for the
    same seed, bit for bit: float32 NCHW images, int64 labels (int32 in
    JAX)."""
    from mile_tpu.data.image import ImageLoader as JaxImageLoader
    from mile_tpu.utils.keys import experiment_keys as jax_keys
    from mile_tpu_torch.data import build_loader
    from mile_tpu_torch.utils.keys import experiment_keys

    path = archive(tmp_path / 'imgs.npz', layout, shape=shape)
    ours_cfg, ref_cfg = data_configs(path, **fields)
    ours = build_loader(ours_cfg, experiment_keys(3).loader, 'cpu')
    ref = JaxImageLoader(ref_cfg, jax_keys(3).loader)
    image = shape if len(shape) == 3 else (1, *shape)
    assert ours.input_shape == image
    n = fields.get('datapoint_limit', 120)
    assert len(ours) == len(ref) == n
    for split in ('train', 'valid', 'test'):
        x, y = ours.arrays(split)
        rx, ry = ref.arrays(split)
        assert x.dtype == torch.float32 and y.dtype == torch.int64
        assert x.shape[1:] == image and x.shape[0] == rx.shape[0]
        assert np.array_equal(x.numpy(), np.asarray(rx))
        assert np.array_equal(y.numpy(), np.asarray(ry))
    assert ours.arrays('train')[0].shape[0] == int(n * 0.7)
    if fields.get('normalize', True):
        assert float(ours.arrays('train')[0].max()) <= 1.0


def test_torchvision_source_needs_the_package(tmp_path, monkeypatch):
    from mile_tpu_torch.data import build_loader

    monkeypatch.setitem(sys.modules, 'torchvision', None)
    cfg, _ = data_configs('FashionMNIST', source='torchvision')
    with pytest.raises(ImportError, match='torchvision package'):
        build_loader(cfg, 0)


def tiny_image_config(tmp_path, npz) -> dict:
    """The tiny LeNetti pipeline of ``tests/test_modality_e2e.py``."""
    return yaml.safe_load(f"""
saving_dir: '{tmp_path}/res'
experiment_name: 'img'
data:
  path: '{npz}'
  data_type: 'image'
  task: 'class'
  train_split: 0.7
  valid_split: 0.15
  test_split: 0.15
model:
  model: LeNetti
  out_dim: 3
  activation: relu
training:
  warmstart:
    include: true
    optimizer_config: {{name: adam, parameters: {{learning_rate: 0.01}}}}
    max_epochs: 8
    batch_size: 32
  sampler:
    name: mclmc
    warmup_steps: 300
    n_chains: 2
    n_samples: 200
    n_thinning: 4
    step_size_init: 0.001
rng: 0
logging: false
""")


def _with(cfg: dict, **updates) -> dict:
    for dotted, value in updates.items():
        *parents, key = dotted.split('.')
        node = cfg
        for p in parents:
            node = node[p]
        node[key] = value
    return cfg


def test_lenetti_trainer_end_to_end(tmp_path):
    """BDETrainer on the CPU on the tiny LeNetti config of
    ``tests/test_modality_e2e.py`` (300 images of 8x8, 3 classes): LPPD
    finite, accuracy and DE accuracy above 0.5; the JAX package reads the
    port's draws from the native sink's files, and its ``evaluate_bde`` of
    them on its own test split gives the port's LPPD within 1e-4."""
    from mile_tpu.config import Config as JaxConfig
    from mile_tpu.data.image import ImageLoader as JaxImageLoader
    from mile_tpu.inference.evaluation import evaluate_bde as jax_bde
    from mile_tpu.models import build_model as jax_build_model
    from mile_tpu.train import checkpoint as jax_ckpt
    from mile_tpu.utils.keys import experiment_keys as jax_keys
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    npz = archive(tmp_path / 'imgs.npz', n=300, dtype=np.float32)
    cfg = tiny_image_config(tmp_path, npz)
    trainer = BDETrainer(Config.from_dict(cfg), device='cpu')
    assert trainer.bayes.dim == 1 * 9 + 1 + 100 * 8 + 8 + 2 * 72 + 8 * 3 + 3
    metrics = trainer.train()
    assert np.isfinite(metrics['lppd'])
    assert metrics['acc'] > 0.5 and metrics['de_acc'] > 0.5

    samples = jax_ckpt.load_flat_samples(trainer.samples_dir)
    assert samples.shape == (2, 50, trainer.bayes.dim)
    assert trainer.sink.native and trainer.sink.rows_written == 50
    jcfg = JaxConfig.from_dict(cfg)
    loader = JaxImageLoader(jcfg.data, jax_keys(0).loader)
    x, y = loader.arrays('test')
    module = jax_build_model(jcfg.model)
    _, unravel = ravel_pytree(module.init(jax.random.PRNGKey(0),
                                          x[:1])['params'])
    _, ref = jax_bde(module, unravel, samples, x, y, jcfg.data.task)
    assert metrics['lppd'] == pytest.approx(ref['lppd'], abs=1e-4)


@pytest.mark.parametrize('sampler', ['nuts', 'hmc'])
def test_nuts_and_hmc_sample_lenetti(tmp_path, sampler):
    """NUTS (tree depth up to 4) and HMC run on the CNN through the same
    trainer: the tiny LeNetti config with 10 adaptation steps and 4 draws
    of 2 chains; finite metrics, the draws on disk."""
    from mile_tpu.train import checkpoint as jax_ckpt
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    npz = archive(tmp_path / 'imgs.npz', n=100, dtype=np.float32)
    cfg = _with(tiny_image_config(tmp_path, npz),
                **{'training.warmstart.max_epochs': 2,
                   'training.sampler.name': sampler,
                   'training.sampler.max_num_doublings': 4,
                   'training.sampler.warmup_steps': 10,
                   'training.sampler.n_samples': 4,
                   'training.sampler.n_thinning': 1})
    trainer = BDETrainer(Config.from_dict(cfg), device='cpu')
    metrics = trainer.train()
    for key in ('lppd', 'acc', 'de_lppd', 'de_acc'):
        assert np.isfinite(metrics[key]), key
    samples = jax_ckpt.load_flat_samples(trainer.samples_dir)
    assert samples.shape == (2, 4, trainer.bayes.dim)
    assert np.isfinite(samples).all()


def test_empty_test_split_fails_at_evaluation_as_in_jax(tmp_path):
    """``test_split: 0.0`` (as ``lenet_fmnist.yaml`` has): the JAX trainer's
    evaluation fails on the empty split (inside the network's reshape),
    after the warm start and the draws; the port's trainer runs both
    phases, writes the draws, then raises a ValueError naming the cause,
    and writes no metrics.pkl."""
    from mile_tpu.config import Config as JaxConfig
    from mile_tpu.train import checkpoint as jax_ckpt
    from mile_tpu.train.trainer import BDETrainer as JaxTrainer
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    npz = archive(tmp_path / 'imgs.npz', n=100)
    cfg = _with(tiny_image_config(tmp_path, npz),
                **{'data.train_split': 0.8, 'data.valid_split': 0.2,
                   'data.test_split': 0.0,
                   'training.warmstart.max_epochs': 1,
                   'training.sampler.warmup_steps': 10,
                   'training.sampler.n_samples': 4,
                   'training.sampler.n_thinning': 2})
    trainer = BDETrainer(Config.from_dict(cfg), device='cpu')
    assert trainer.loader.arrays('test')[0].shape == (0, 1, 8, 8)
    with pytest.raises(ValueError, match='test split is empty'):
        trainer.train()
    assert jax_ckpt.load_flat_samples(trainer.samples_dir).shape == (
        2, 2, trainer.bayes.dim)
    assert not (trainer.exp_dir / 'metrics.pkl').exists()

    jcfg = JaxConfig.from_dict(_with(cfg, **{'experiment_name': 'jax'}))
    ref = JaxTrainer(jcfg)
    members = jax.vmap(lambda k: ref.module.init(
        k, np.zeros((1, 1, 8, 8), np.float32))['params'])(
        jax.random.split(jax.random.PRNGKey(0), 2))
    with pytest.raises(ZeroDivisionError):
        ref.evaluate(members, None)


def test_warmstart_runs_in_float32(monkeypatch):
    """The TF32 rule: the warm start runs in exact float32, convolutions
    included (cuDNN's TF32 off, matmul precision 'highest'), whatever the
    process-wide defaults; they are restored afterwards."""
    from mile_tpu_torch.config.data import Task
    from mile_tpu_torch.config.models import LeNettiConfig
    from mile_tpu_torch.config.training import WarmstartConfig
    from mile_tpu_torch.models import build_model
    from mile_tpu_torch.train.warmstart import train_ensemble

    model = build_model(LeNettiConfig(out_dim=3), (1, 8, 8))
    seen = []
    forward = model.forward

    def recording(theta, x):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return forward(theta, x)

    monkeypatch.setattr(model, 'forward', recording)

    class Loader:
        def arrays(self, split):
            n = {'train': 64, 'valid': 16, 'test': 16}[split]
            gen = torch.Generator().manual_seed(n)
            return (torch.rand(n, 1, 8, 8, generator=gen),
                    torch.randint(0, 3, (n,), generator=gen))

    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    torch.set_float32_matmul_precision('high')
    try:
        cfg = WarmstartConfig.from_dict({
            'optimizer_config': {'name': 'adam',
                                 'parameters': {'learning_rate': 0.01}},
            'max_epochs': 2, 'batch_size': 16})
        params, store = train_ensemble(model, Loader(), cfg,
                                       Task.CLASSIFICATION, 2,
                                       torch.Generator().manual_seed(0))
        assert torch.get_float32_matmul_precision() == 'high'
    finally:
        torch.set_float32_matmul_precision('highest')
    assert torch.backends.cudnn.allow_tf32 is True
    assert len(seen) == 2 * 4 + 2 + 1   # steps, validations, test
    assert set(seen) == {(False, 'highest')}
    assert store.test.accuracy.shape == (2, 1)


@pytest.fixture
def lenet_cli_run(tmp_path):
    """``python -m mile_tpu_torch --device cpu`` on a copy of
    ``configs/additional_tasks/lenet_fmnist.yaml`` pointed at 200 synthetic
    28x28 images in 10 classes, with valid/test splits of 0.1 (the config
    has no test split) and the step counts and chains cut (30 tuner steps:
    the tuner's last tenth, which sets L from an effective sample size,
    needs a few steps); likelihood chunks of 64 (the config's 8192 is
    above the 160 training images)."""
    with open(ROOT / 'configs/additional_tasks/lenet_fmnist.yaml') as f:
        cfg = yaml.safe_load(f)
    npz = archive(tmp_path / 'fmnist.npz', n=200, shape=(28, 28),
                  n_classes=10)
    cfg = _with(cfg, **{
        'saving_dir': str(tmp_path / 'results'), 'experiment_name': 'lenet',
        'data.path': str(npz), 'data.valid_split': 0.1,
        'data.test_split': 0.1, 'training.warmstart.max_epochs': 1,
        'training.sampler.n_chains': 2,
        'training.sampler.warmup_steps': 30,
        'training.sampler.n_samples': 4, 'training.sampler.n_thinning': 2,
        'training.sampler.likelihood_chunk_size': 64})
    path = tmp_path / 'lenet.yaml'
    path.write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'mile_tpu_torch', '-c', str(path),
         '--device', 'cpu', '--silent'],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return tmp_path / 'results' / 'lenet'


def test_lenet_fmnist_config_runs_on_the_cpu(lenet_cli_run):
    """LeNet at full width (dim 61,706) through the CLI: metrics finite,
    the draws on disk in the JAX layout."""
    from mile_tpu.train import checkpoint as jax_ckpt

    with open(lenet_cli_run / 'metrics.pkl', 'rb') as f:
        metrics = pickle.load(f)
    for key in ('lppd', 'nll', 'acc', 'de_lppd', 'de_acc'):
        assert np.isfinite(metrics[key]), key
    samples = jax_ckpt.load_flat_samples(lenet_cli_run / 'samples')
    assert samples.shape == (2, 2, 61_706) and np.isfinite(samples).all()
    for name in ('warmstart/params_1.npz', 'warmstart/layout.json',
                 'warmup_params.txt', 'samples/info.pkl'):
        assert (lenet_cli_run / name).is_file(), name


@pytest.mark.parametrize('what', ['text loader', 'AttentionClassifier',
                                  'PretrainedAttentionClassifier',
                                  'EmbeddingClassifier', 'PartitionFCN'])
def test_text_path_and_partition_fcn_are_not_yet_ported(what, tmp_path):
    """Every feature this test once found missing is ported and builds
    here: the text loader and the three attention models (their parity
    tests are ``tests/test_torch_text.py`` and
    ``tests/test_torch_attention.py``) and PartitionFCN, an FCN with the
    same layout (``tests/test_torch_partition.py``)."""
    from mile_tpu_torch.config.data import DataConfig
    from mile_tpu_torch.config.models import ModelConfig
    from mile_tpu_torch.data import TextLoader, build_loader
    from mile_tpu_torch.models import build_model

    if what == 'PartitionFCN':
        from mile_tpu_torch.models import FCN, PartitionFCN

        model = build_model(ModelConfig.resolve({'model': what}), (5,))
        fcn = build_model(ModelConfig.resolve({'model': 'FCN'}), (5,))
        assert isinstance(model, PartitionFCN) and isinstance(model, FCN)
        assert model.layout.to_json() == fcn.layout.to_json()
    elif what == 'text loader':
        path = tmp_path / 't.csv'
        path.write_text('text,label\nab,0\nba,1\n')
        loader = build_loader(DataConfig.from_dict(
            {'path': str(path), 'data_type': 'text', 'task': 'class'}), 0)
        assert isinstance(loader, TextLoader)
        assert loader.input_shape == (64,)
    else:
        fields = {'model': what, 'context_len': 5}
        if what == 'PretrainedAttentionClassifier':
            np.save(tmp_path / 'emb.npy', np.ones((1000, 4), np.float32))
            np.save(tmp_path / 'pos_emb.npy', np.ones((5, 4), np.float32))
            fields['emb_path'] = str(tmp_path / 'emb.npy')
        model = build_model(ModelConfig.resolve(fields), (5,))
        assert model.dim > 0 and model.out_features == 2
