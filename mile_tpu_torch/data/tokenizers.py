"""Tokenizers of the text path (counterpart of
``mile_tpu/data/tokenizers.py``).

The port's own copy: the same protocol, vocabularies and ids. The
character tokenizer needs nothing; the BPE and WordPiece tokenizers are
import-gated on their packages (``tokenizers``, ``tiktoken``,
``transformers``) and raise the JAX package's ``ImportError`` without them.
"""
from __future__ import annotations

import abc
import json
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

PAD_ID = 0


class Tokenizer(abc.ABC):
    """pad/encode/decode protocol shared by all tokenizers."""

    pad_id: int = PAD_ID

    @abc.abstractmethod
    def encode(self, text: str) -> list[int]:
        ...

    @abc.abstractmethod
    def decode(self, ids: Sequence[int]) -> str:
        ...

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int:
        ...

    @property
    def needs_training(self) -> bool:
        return False

    def train(self, corpus: Iterable[str]) -> None:
        pass

    def pad(self, ids: Sequence[int], context_len: int) -> list[int]:
        """Truncate or right-pad ``ids`` to ``context_len``."""
        ids = list(ids)[:context_len]
        return ids + [self.pad_id] * (context_len - len(ids))

    def encode_batch(self, texts: Sequence[str],
                     context_len: int) -> np.ndarray:
        """``(len(texts), context_len)`` int64 ids (int32 in the JAX
        package; the same values)."""
        return np.asarray(
            [self.pad(self.encode(t), context_len) for t in texts],
            dtype=np.int64).reshape(len(texts), context_len)


class SingleCharTokenizer(Tokenizer):
    """Character-level tokenizer trained on the corpus: its sorted
    characters take ids 1, 2, ...; id 0 is PAD."""

    def __init__(self, vocab: str | None = None):
        self._chars: list[str] = list(vocab) if vocab else []
        self._index = {c: i + 1 for i, c in enumerate(self._chars)}

    @property
    def needs_training(self) -> bool:
        return not self._chars

    def train(self, corpus: Iterable[str]) -> None:
        self._chars = sorted(set(''.join(corpus)))
        self._index = {c: i + 1 for i, c in enumerate(self._chars)}

    def encode(self, text: str) -> list[int]:
        return [self._index[c] for c in text if c in self._index]

    def decode(self, ids: Sequence[int]) -> str:
        return ''.join(self._chars[i - 1] for i in ids if i > 0)

    @property
    def vocab_size(self) -> int:
        return len(self._chars) + 1  # + PAD

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self._chars))

    @classmethod
    def load(cls, path: str | Path) -> 'SingleCharTokenizer':
        return cls(vocab=''.join(json.loads(Path(path).read_text())))


class CustomBPETokenizer(Tokenizer):
    """BPE trained on the corpus with Hugging Face's ``tokenizers``."""

    def __init__(self, vocab_size: int = 1000):
        try:
            from tokenizers import Tokenizer as HFTokenizer
            from tokenizers.models import BPE
            from tokenizers.pre_tokenizers import Whitespace
            from tokenizers.trainers import BpeTrainer
        except ImportError as e:
            raise ImportError(
                'CustomBPETokenizer requires the `tokenizers` package'
            ) from e
        self._tok = HFTokenizer(BPE(unk_token='[UNK]'))
        self._tok.pre_tokenizer = Whitespace()
        self._trainer = BpeTrainer(
            vocab_size=vocab_size, special_tokens=['[PAD]', '[UNK]'])

    @property
    def needs_training(self) -> bool:
        return True

    def train(self, corpus: Iterable[str]) -> None:
        self._tok.train_from_iterator(corpus, self._trainer)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids))

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()


class BPETokenizer(Tokenizer):
    """Pretrained BPE through ``tiktoken`` (the GPT-2 vocabulary)."""

    def __init__(self, encoding: str = 'gpt2'):
        try:
            import tiktoken
        except ImportError as e:
            raise ImportError('BPETokenizer requires `tiktoken`') from e
        self._enc = tiktoken.get_encoding(encoding)

    def encode(self, text: str) -> list[int]:
        return self._enc.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._enc.decode(list(ids))

    @property
    def vocab_size(self) -> int:
        return self._enc.n_vocab


class BertTokenizer(Tokenizer):
    """Pretrained WordPiece through ``transformers``."""

    def __init__(self, model_name: str = 'bert-base-uncased'):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError('BertTokenizer requires `transformers`') from e
        self._tok = AutoTokenizer.from_pretrained(model_name)
        self.pad_id = self._tok.pad_token_id or PAD_ID

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids))

    @property
    def vocab_size(self) -> int:
        return self._tok.vocab_size


TOKENIZERS = {
    'single_char': SingleCharTokenizer,
    'custom_bpe': CustomBPETokenizer,
    'bpe': BPETokenizer,
    'bert': BertTokenizer,
}


def build_tokenizer(name: str, **params) -> Tokenizer:
    """The tokenizer named ``name`` (a string or the config's enum value)
    built with ``params``."""
    try:
        cls = TOKENIZERS[str(name)]
    except KeyError:
        raise KeyError(
            f'unknown tokenizer {name!r}; options: {sorted(TOKENIZERS)}'
        ) from None
    return cls(**params)
