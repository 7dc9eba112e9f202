"""Text data loader: tokenized, padded classification corpora (counterpart
of ``mile_tpu/data/text.py``).

Local formats:

- ``.csv``: a header with the text column (``features[0]``, default
  ``text``) and the label column (``target_column``, default ``label``);
  labels may be string class names;
- ``.txt``: ``text<TAB>label`` per line, split on the last tab;
- ``source: huggingface``: through the ``datasets`` package (import-gated).
  A local ``.csv``/``.json``/``.jsonl`` goes through its packaged csv and
  json loaders; a bare dataset name is loaded from the hub by ``datasets``
  itself.

The rare-character filter, the tokenizer training, the padding to
``context_len``, the label encoding, the single seeded permutation,
``datapoint_limit`` and the fractional split are the JAX package's numpy
code, so with the same seed the splits and token ids are identical. Tokens
are int64 here (int32 in the JAX package). Local files are read as UTF-8
whatever the locale (the JAX package reads them in the locale's encoding,
which is UTF-8 where the two are compared).
"""
from __future__ import annotations

import csv
import os
import tempfile
from collections import Counter

import numpy as np
import torch

from mile_tpu_torch.config.data import DataConfig, DatasetType, Source, Task
from mile_tpu_torch.data.base import (
    BaseLoader,
    Split,
    check_seed,
    resolve_data_path,
)
from mile_tpu_torch.data.tokenizers import (
    SingleCharTokenizer,
    Tokenizer,
    build_tokenizer,
)


def omit_rare_chars(texts: list[str], min_freq: int) -> list[str]:
    """Drop characters rarer than ``min_freq`` in the corpus."""
    counts = Counter(''.join(texts))
    keep = {c for c, n in counts.items() if n >= min_freq}
    return [''.join(c for c in t if c in keep) for t in texts]


class TextLoader(BaseLoader):
    """The tokenizer is the config's (``training.tokenizer``), or the
    character tokenizer without one. ``context_len`` and ``omit_freq`` are
    popped from its parameters before it is built, with the JAX package's
    defaults 64 and 0."""

    def __init__(self, config: DataConfig, rng, tokenizer_config=None,
                 device: str | torch.device = 'cpu'):
        if config.data_type != DatasetType.TEXT:
            raise ValueError(f'TextLoader needs text data, got '
                             f'{config.data_type.value}')
        check_seed(rng)
        super().__init__(config, device)
        self._rng = np.random.default_rng(rng)
        params = dict(tokenizer_config.parameters) if tokenizer_config \
            else {}
        context_len = params.pop('context_len', 64)
        omit_freq = params.pop('omit_freq', 0)
        self.tokenizer: Tokenizer = (
            build_tokenizer(tokenizer_config.name, **params)
            if tokenizer_config else SingleCharTokenizer())
        self.context_len = int(context_len)

        texts, labels = self._load()
        if omit_freq:
            texts = omit_rare_chars(texts, omit_freq)
        if self.tokenizer.needs_training:
            self.tokenizer.train(texts)

        x = self.tokenizer.encode_batch(texts, self.context_len)
        y = self._encode_labels(labels)

        perm = self._rng.permutation(len(x))
        x, y = x[perm], y[perm]
        if config.datapoint_limit:
            x, y = x[: config.datapoint_limit], y[: config.datapoint_limit]
        n = len(x)
        n_train = int(n * config.train_split)
        n_valid = int(n * (config.train_split + config.valid_split))
        bounds = {'train': (0, n_train), 'valid': (n_train, n_valid),
                  'test': (n_valid, n)}
        self._x = {s: x[a:b] for s, (a, b) in bounds.items()}
        self._y = {s: y[a:b] for s, (a, b) in bounds.items()}

    # ------------------------------------------------------------ loading
    def _columns(self) -> tuple[str, str]:
        return ((self.config.features or ['text'])[0],
                self.config.target_column or 'label')

    def _load(self) -> tuple[list[str], list]:
        if self.config.source == Source.HUGGINGFACE:
            return self._load_hf()
        path = resolve_data_path(self.config.path)
        texts, labels = [], []
        if path.suffix == '.csv':
            text_col, label_col = self._columns()
            with open(path, newline='', encoding='utf-8') as f:
                for row in csv.DictReader(f):
                    texts.append(row[text_col])
                    labels.append(row[label_col])
        else:  # .txt: text<TAB>label
            for line in path.read_text(encoding='utf-8').splitlines():
                if not line.strip():
                    continue
                text, _, label = line.rpartition('\t')
                texts.append(text)
                labels.append(label)
        return texts, labels

    def _load_hf(self) -> tuple[list[str], list]:
        try:
            from datasets import load_dataset
        except ImportError as e:
            raise ImportError(
                'source=huggingface requires the `datasets` package'
            ) from e
        text_col, label_col = self._columns()
        path = str(self.config.path)
        if not os.path.exists(path):   # a dataset name: datasets' own cache
            ds = load_dataset(path, split='train')
            return list(ds[text_col]), list(ds[label_col])
        fmt = {'.csv': 'csv', '.json': 'json',
               '.jsonl': 'json'}.get(os.path.splitext(path)[1])
        if fmt is None:
            raise ValueError(
                f'source=huggingface with a local file needs .csv or '
                f'.json(l), got {path!r}')
        # the arrow cache that datasets makes of a local file lives only as
        # long as the columns are read out of it
        with tempfile.TemporaryDirectory() as cache:
            ds = load_dataset(fmt, data_files=path, split='train',
                              cache_dir=cache)
            return list(ds[text_col]), list(ds[label_col])

    def _encode_labels(self, labels: list) -> np.ndarray:
        """Float labels for regression; sorted string classes (kept in
        ``classes_``) or numeric labels for classification."""
        if self.config.task == Task.REGRESSION:
            return np.asarray([float(v) for v in labels], np.float32)
        if labels and isinstance(labels[0], str) and not _all_numeric(labels):
            self.classes_ = sorted(set(labels))
            index = {c: i for i, c in enumerate(self.classes_)}
            return np.asarray([index[v] for v in labels], np.int64)
        return np.asarray([int(float(v)) for v in labels], np.int64)

    # ----------------------------------------------------------- protocol
    def numpy_arrays(self, split: Split) -> tuple[np.ndarray, np.ndarray]:
        """(tokens ``(N, context_len)`` int64, labels) of a split."""
        return self._x[split], self._y[split]

    @property
    def input_shape(self) -> tuple[int, ...]:
        return (self.context_len,)

    def __len__(self):
        return sum(len(v) for v in self._x.values())


def _all_numeric(labels: list) -> bool:
    try:
        [float(v) for v in labels]
        return True
    except (TypeError, ValueError):
        return False
