"""The port's text path against the JAX package: the tokenizers (ids,
vocabularies, the import gates), the text loader's splits and token ids
(csv, txt, string labels, rare characters, the tokenizer config's
parameters, a local csv through ``datasets``), and the trainer end to end
on a cut copy of ``configs/text_classifier.yaml``: MCLMC through the CLI,
NUTS and HMC in process, with the JAX package reading and evaluating the
port's draws."""
import pickle
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
ALPHABET = list('abcdefghijklmnopqrstuvwxyz ')


def corpus(n=120, seed=1):
    """``n`` (text, 'pos'/'neg') pairs; each class favours one half of the
    alphabet, so that a model can learn something; a few texts hold rare
    characters (digits, once each)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        label = int(rng.random() < 0.5)
        p = np.where(np.arange(len(ALPHABET)) < 13, 3.0 if label else 1.0,
                     1.0 if label else 3.0)
        text = ''.join(rng.choice(ALPHABET, rng.integers(3, 90),
                                  p=p / p.sum()))
        if i % 17 == 0:
            text += str(i % 10)
        rows.append((text, ['neg', 'pos'][label]))
    return rows


def write_csv(path, rows, text_col='text', label_col='label', numeric=False):
    lines = [f'{text_col},{label_col}']
    lines += [f'"{t}",{int(lab == "pos") if numeric else lab}'
              for t, lab in rows]
    path.write_text('\n'.join(lines) + '\n')
    return path


def loaders(path, tokenizer=None, seed=3, **fields):
    """(port TextLoader, JAX TextLoader) of the same config and seed."""
    from mile_tpu.config.data import DataConfig as JaxDataConfig
    from mile_tpu.config.training import TokenizerConfig as JaxTokenizer
    from mile_tpu.data.text import TextLoader as JaxTextLoader
    from mile_tpu.utils.keys import experiment_keys as jax_keys
    from mile_tpu_torch.config.data import DataConfig
    from mile_tpu_torch.config.training import TokenizerConfig
    from mile_tpu_torch.data import build_loader
    from mile_tpu_torch.utils.keys import experiment_keys

    data = {'path': str(path), 'data_type': 'text', 'task': 'class',
            'train_split': 0.7, 'valid_split': 0.1, 'test_split': 0.2,
            **fields}
    ours = build_loader(
        DataConfig.from_dict(data), experiment_keys(seed).loader, 'cpu',
        tokenizer_config=tokenizer and TokenizerConfig.from_dict(tokenizer))
    ref = JaxTextLoader(
        JaxDataConfig.from_dict(data), jax_keys(seed).loader,
        tokenizer_config=tokenizer and JaxTokenizer.from_dict(tokenizer))
    return ours, ref


def assert_same_splits(ours, ref):
    for split in ('train', 'valid', 'test'):
        x, y = ours.arrays(split)
        rx, ry = ref.arrays(split)
        assert x.dtype == torch.int64 and x.shape == rx.shape
        assert np.array_equal(x.numpy(), np.asarray(rx))
        assert np.array_equal(y.numpy(), np.asarray(ry))
    assert ours.input_shape == (ref.context_len,)


def test_single_char_tokenizer_matches_jax(tmp_path):
    """Sorted characters, id 0 for PAD: the same vocabulary, ids, padding
    and truncation as the JAX tokenizer; save/load round trip."""
    from mile_tpu.data.tokenizers import SingleCharTokenizer as Ref
    from mile_tpu_torch.data.tokenizers import SingleCharTokenizer

    texts = [t for t, _ in corpus(40)] + ['', 'zzé']
    ours, ref = SingleCharTokenizer(), Ref()
    ours.train(texts)
    ref.train(texts)
    assert ours.vocab_size == ref.vocab_size == len(set(''.join(texts))) + 1
    ids = ours.encode_batch(texts, 24)
    assert ids.dtype == np.int64 and ids.shape == (42, 24)
    np.testing.assert_array_equal(ids, ref.encode_batch(texts, 24))
    assert not ids[40].any()                          # all PAD
    assert ours.decode(ours.encode('hello')) == 'hello'
    ours.save(tmp_path / 'vocab.json')
    again = SingleCharTokenizer.load(tmp_path / 'vocab.json')
    np.testing.assert_array_equal(again.encode_batch(texts, 24), ids)
    assert not again.needs_training


def test_custom_bpe_ids_match_jax():
    """BPE trained on the same corpus through ``tokenizers``: the same
    vocabulary size and ids as the JAX package's."""
    pytest.importorskip('tokenizers')
    from mile_tpu.data.tokenizers import CustomBPETokenizer as Ref
    from mile_tpu_torch.data.tokenizers import build_tokenizer

    texts = [t for t, _ in corpus(60)]
    ours, ref = build_tokenizer('custom_bpe', vocab_size=80), Ref(80)
    ours.train(texts)
    ref.train(texts)
    assert ours.vocab_size == ref.vocab_size
    np.testing.assert_array_equal(ours.encode_batch(texts, 16),
                                  ref.encode_batch(texts, 16))


@pytest.mark.parametrize('name,package,message', [
    ('custom_bpe', 'tokenizers', 'CustomBPETokenizer requires the '
     '`tokenizers` package'),
    ('bpe', 'tiktoken', 'BPETokenizer requires `tiktoken`'),
    ('bert', 'transformers', 'BertTokenizer requires `transformers`')])
def test_tokenizer_import_gates(name, package, message, monkeypatch):
    """Without its package each tokenizer raises the JAX package's
    ImportError text; an unknown name raises a KeyError with the
    options."""
    from mile_tpu.data.tokenizers import build_tokenizer as ref_build
    from mile_tpu_torch.data.tokenizers import build_tokenizer

    monkeypatch.setitem(sys.modules, package, None)
    for build in (build_tokenizer, ref_build):
        with pytest.raises(ImportError) as err:
            build(name)
        assert str(err.value) == message
    with pytest.raises(KeyError, match='single_char'):
        build_tokenizer('wordpiece')


@pytest.mark.parametrize('case', [
    'csv', 'csv-numeric', 'txt', 'columns', 'omit_freq', 'limit',
    'regression'])
def test_text_splits_are_bit_identical(tmp_path, case):
    """Each split's token ids and labels equal the JAX TextLoader's for
    the same seed: csv with string (sorted into ``classes_``) or numeric
    labels, txt split on the last tab, named columns, rare characters
    dropped (``omit_freq``), ``datapoint_limit``, float labels for
    regression; ``context_len`` and ``omit_freq`` come from the tokenizer
    config's parameters."""
    rows = corpus()
    fields, tokenizer = {}, {'name': 'single_char',
                             'parameters': {'context_len': 32}}
    if case == 'txt':
        path = tmp_path / 'texts.txt'
        path.write_text('\n'.join(f'{t}\tx\t{lab}' for t, lab in rows)
                        + '\n\n')
    elif case == 'columns':
        path = write_csv(tmp_path / 'texts.csv', rows, 'review', 'stars')
        fields = {'features': ['review'], 'target_column': 'stars'}
    else:
        path = write_csv(tmp_path / 'texts.csv', rows,
                         numeric=case in ('csv-numeric', 'regression'))
    if case == 'omit_freq':
        tokenizer['parameters']['omit_freq'] = 2
    if case == 'limit':
        fields['datapoint_limit'] = 77
    if case == 'regression':
        fields['task'] = 'regr'
    ours, ref = loaders(path, tokenizer, **fields)
    assert_same_splits(ours, ref)
    assert ours.context_len == 32
    assert len(ours) == len(ref) == fields.get('datapoint_limit', 120)
    assert ours.tokenizer.vocab_size == ref.tokenizer.vocab_size
    digits = sum(ours.tokenizer.encode(str(d)) != [] for d in range(10))
    assert digits == (0 if case == 'omit_freq' else 8)
    if case in ('csv', 'txt', 'columns'):
        assert ours.classes_ == ref.classes_ == ['neg', 'pos']
    y = ours.arrays('train')[1]
    assert y.dtype == (torch.float32 if case == 'regression'
                       else torch.int64)


def test_defaults_without_tokenizer_config(tmp_path):
    """No tokenizer config: single_char with the JAX package's default
    context length, 64."""
    ours, ref = loaders(write_csv(tmp_path / 'texts.csv', corpus()))
    assert_same_splits(ours, ref)
    assert ours.input_shape == (64,)


def test_huggingface_local_csv(tmp_path):
    """``source: huggingface`` on a local csv goes through the
    ``datasets`` packaged csv loader (nothing is fetched): the same splits
    and token ids as the JAX package's."""
    pytest.importorskip('datasets')
    path = write_csv(tmp_path / 'texts.csv', corpus(), numeric=True)
    ours, ref = loaders(path, {'name': 'single_char',
                               'parameters': {'context_len': 20}},
                        source='huggingface')
    assert_same_splits(ours, ref)


def test_huggingface_needs_datasets(tmp_path, monkeypatch):
    from mile_tpu_torch.config.data import DataConfig
    from mile_tpu_torch.data import build_loader

    monkeypatch.setitem(sys.modules, 'datasets', None)
    cfg = DataConfig.from_dict({'path': 'imdb', 'source': 'huggingface',
                                'data_type': 'text', 'task': 'class'})
    with pytest.raises(ImportError, match='requires the `datasets` package'):
        build_loader(cfg, 0)


def text_config(tmp_path, csv, **sampler) -> dict:
    """``configs/text_classifier.yaml`` (dim 11,520) cut: a generated csv
    of 120 texts, 2 chains, 1 warm-start epoch, and few steps."""
    with open(ROOT / 'configs' / 'text_classifier.yaml') as f:
        cfg = yaml.safe_load(f)
    cfg['saving_dir'] = str(tmp_path / 'results')
    cfg['data']['path'] = str(csv)
    cfg['training']['warmstart'].update(max_epochs=1)
    cfg['training']['sampler'].update(
        dict(n_chains=2, warmup_steps=20, n_samples=8, n_thinning=2),
        **sampler)
    return cfg


@pytest.fixture(scope='module')
def text_cli_run(tmp_path_factory):
    """The CLI's ``main`` (what ``python -m mile_tpu_torch`` runs) with
    ``--device cpu`` on the cut text_classifier config, on one torch
    thread."""
    from mile_tpu_torch.cli import main

    tmp = tmp_path_factory.mktemp('text')
    csv = write_csv(tmp / 'texts.csv', corpus(), numeric=True)
    cfg = text_config(tmp, csv)
    path = tmp / 'text.yaml'
    path.write_text(yaml.safe_dump(cfg))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert main(['-c', str(path), '--device', 'cpu', '--silent']) == 0
    finally:
        torch.set_num_threads(prev)
    return cfg, tmp / 'results' / 'attention_classifier'


def test_text_config_runs_on_the_cpu(text_cli_run):
    """MCLMC on the text classifier through the CLI: finite metrics, the
    JAX files; the JAX package reads the draws, and its Flax module's
    predictions from them on its own loader's test split give the port's
    LPPD within 1e-4."""
    from mile_tpu.config import Config as JaxConfig
    from mile_tpu.data import build_loader as jax_build_loader
    from mile_tpu.models import build_model as jax_build_model
    from mile_tpu.train import checkpoint as jax_ckpt
    from mile_tpu.utils.keys import experiment_keys as jax_keys

    cfg, run = text_cli_run
    with open(run / 'metrics.pkl', 'rb') as f:
        metrics = pickle.load(f)
    for key in ('lppd', 'nll', 'acc', 'de_lppd', 'de_acc'):
        assert np.isfinite(metrics[key]), key
    for name in ('warmstart/params_1.npz', 'warmstart/layout.json',
                 'warmup_params.txt', 'samples/info.pkl'):
        assert (run / name).is_file(), name
    samples = jax_ckpt.load_flat_samples(run / 'samples')
    assert samples.shape == (2, 4, 11_520) and np.isfinite(samples).all()
    jcfg = JaxConfig.from_dict(cfg)
    loader = jax_build_loader(jcfg.data, jax_keys(jcfg.rng).loader,
                              tokenizer_config=jcfg.training.tokenizer)
    x, y = (np.asarray(a) for a in loader.arrays('test'))
    module = jax_build_model(jcfg.model)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), x[:1])['params'])
    _, unravel = ravel_pytree(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), shapes))
    logits = np.asarray(jax.jit(jax.vmap(
        lambda f: module.apply({'params': unravel(f)}, x)))(
        samples.reshape(-1, samples.shape[-1])), np.float64)
    log_pmf = logits - np.logaddexp.reduce(logits, axis=-1, keepdims=True)
    picked = np.take_along_axis(log_pmf, y[None, :, None], -1)[..., 0]
    lppd = np.mean(np.logaddexp.reduce(picked, axis=0)
                   - np.log(picked.shape[0]))
    assert metrics['lppd'] == pytest.approx(lppd, abs=1e-4)


def test_text_config_needs_a_gpu_unless_asked_for_the_cpu(text_cli_run,
                                                          tmp_path):
    """Without ``--device cpu``, on a machine without a GPU, the CLI
    raises."""
    from mile_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip('this machine has a GPU')
    cfg, _ = text_cli_run
    path = tmp_path / 'text.yaml'
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        main(['-c', str(path), '--silent'])


@pytest.mark.parametrize('sampler', ['nuts', 'hmc'])
def test_nuts_and_hmc_sample_the_text_classifier(tmp_path, sampler):
    """NUTS (tree depth up to 3) and HMC on the cut text classifier
    through the trainer: finite metrics, 2 x 4 finite draws on disk."""
    from mile_tpu.train import checkpoint as jax_ckpt
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    csv = write_csv(tmp_path / 'texts.csv', corpus(60), numeric=True)
    cfg = text_config(tmp_path, csv, name=sampler, max_num_doublings=3,
                      num_integration_steps=4, warmup_steps=6, n_samples=4,
                      n_thinning=1)
    trainer = BDETrainer(Config.from_dict(cfg), device='cpu')
    metrics = trainer.train()
    for key in ('lppd', 'acc', 'de_lppd', 'de_acc'):
        assert np.isfinite(metrics[key]), key
    samples = jax_ckpt.load_flat_samples(trainer.samples_dir)
    assert samples.shape == (2, 4, 11_520) and np.isfinite(samples).all()
