"""Attention-based text classifiers over flat, chain-batched parameters
(counterpart of ``mile_tpu/models/attention.py``): one multi-head
self-attention block over (pad-masked) token embeddings, a mean over the
positions, an MLP head.

Each reads a ``(C, dim)`` parameter tensor in the JAX package's flat
layout (``ravel_pytree`` order; ``TokenEmbedding_0`` sorts before
``_AttentionHead_0``) and tokens ``(N, T)`` shared by every chain or
``(C, N, T)``, one batch per chain (the warm start's members).

Parity with the Flax modules:

- A pad query's row of the mask is False whole; Flax fills masked scores
  with the most negative float, so that row's softmax is uniform over all
  T keys, pads included, and the mean over positions takes all T
  positions, pads included (see :func:`~mile_tpu_torch.models.blocks.
  multi_head_attention`).
- ``nn.gelu`` is the tanh approximation; torch's default is exact.
- Two errors are kept different on purpose: token ids past the embedding
  table raise a ``ValueError`` (the JAX gather fills them with NaN), and
  a context length other than the model's raises a ``ValueError`` that
  names the tokenizer parameter (JAX asserts).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mile_tpu_torch.config.models import (
    AttentionClassifierConfig,
    EmbeddingClassifierConfig,
    PretrainedAttentionClassifierConfig,
)
from mile_tpu_torch.models.blocks import (
    Init,
    PretrainedTokenEmbedding,
    TokenEmbedding,
    attention_inits,
    attention_params,
    dense,
    dense_params,
    init_flat,
    multi_head_attention,
)
from mile_tpu_torch.models.layout import FlatLayout

HEAD = '_AttentionHead_0'
EMBEDDING = 'TokenEmbedding_0'


def pad_mask(tokens: torch.Tensor, pad_id: int) -> torch.Tensor:
    """``(..., T)`` tokens -> ``(..., 1, T, T)`` mask, True where both
    the query and the key position hold a token."""
    valid = tokens != pad_id
    return (valid[..., :, None] & valid[..., None, :]).unsqueeze(-3)


class AttentionHead:
    """Flax's ``_AttentionHead`` (and ``EmbeddingClassifier``'s tail):
    attention ``MDPA`` with ``emb_size`` outputs, the mean over all T
    positions, the Dense ``projections`` each followed by gelu (tanh), and
    the Dense ``classifier``."""

    def __init__(self, in_features: int, n_heads: int, qkv_dim: int,
                 emb_size: int, projections: list[tuple[str, int]],
                 n_classes: int, bias: bool):
        self.in_features = in_features
        self.n_heads = n_heads
        self.qkv_dim = qkv_dim
        self.emb_size = emb_size
        self.projections = projections
        self.n_classes = n_classes
        self.bias = bias

    def _dense_layers(self):
        """(name, fan_in, width) of the Dense layers in order."""
        names = [n for n, _ in self.projections] + ['classifier']
        widths = [w for _, w in self.projections] + [self.n_classes]
        return zip(names, [self.emb_size] + widths[:-1], widths)

    def param_shapes(self) -> dict:
        shapes = {'MDPA': attention_params(self.in_features, self.n_heads,
                                           self.qkv_dim, self.emb_size,
                                           self.bias)}
        for name, fan_in, width in self._dense_layers():
            shapes[name] = dense_params(fan_in, width, self.bias)
        return shapes

    def param_inits(self, scope: str) -> dict[str, Init]:
        inits = attention_inits(self.prefix(scope, 'MDPA'), self.in_features,
                                self.qkv_dim)
        for name, fan_in, _ in self._dense_layers():
            inits[f'{self.prefix(scope, name)}/kernel'] = Init(fan_in)
        return inits

    @staticmethod
    def prefix(scope: str, name: str) -> str:
        return f'{scope}/{name}' if scope else name

    def __call__(self, theta: torch.Tensor, x: torch.Tensor,
                 mask: torch.Tensor, layout: FlatLayout,
                 scope: str) -> torch.Tensor:
        """``x`` ``(C, N, T, in)`` or ``(N, T, in)`` -> ``(C, N,
        n_classes)``."""
        h = multi_head_attention(theta, x, mask, layout,
                                 self.prefix(scope, 'MDPA'), self.n_heads,
                                 self.qkv_dim, self.emb_size, self.bias)
        h = h.mean(dim=2)
        for name, _ in self.projections:
            h = F.gelu(dense(theta, h, layout, self.prefix(scope, name),
                             self.bias), approximate='tanh')
        return dense(theta, h, layout, self.prefix(scope, 'classifier'),
                     self.bias)

    def activation_floats(self, t: int) -> float:
        """Floats of one observation's intermediates in the attention and
        the tail, op by op before any fusion, as the JAX package's traced
        plan counts them (a boolean counts a quarter): q, k, v, the scaled
        query, the weighted values and their transpose (6 T·qkv); the
        scores, the mask's broadcast, the filled scores and the softmax's
        subtract, exp and divide (6.25 heads·T², the attention weights'
        passes) and its row max, sum and broadcasts (6 heads·T); the out
        projection (T·emb); with biases, each bias reshaped and added; the
        mean's sum and divide (2 emb); each Dense layer's product (and bias
        reshape and add) and gelu's eight tanh-approximation passes."""
        qkv, heads, emb = self.qkv_dim, self.n_heads, self.emb_size
        floats = 6.25 * heads * t * t + 6 * heads * t + 6 * t * qkv \
            + t * emb + 2 + 2 * emb
        if self.bias:
            floats += 3 * qkv + 3 * t * qkv + emb + t * emb
        for _, _, width in self._dense_layers():
            floats += (1 + 2 * self.bias) * width
        floats += 8 * sum(width for _, width in self.projections)
        return floats


class ChainAttentionModel(nn.Module):
    """Common surface of the attention models: the flat layout, its dim,
    the output width, the initializer and the planner's float count."""

    layout: FlatLayout
    inits: dict[str, Init]

    @property
    def dim(self) -> int:
        return self.layout.dim

    @property
    def out_features(self) -> int:
        return self.config.n_classes

    def init(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """``n`` fresh members ``(n, dim)``, initialized as the Flax
        module's layers initialize theirs."""
        return init_flat(self.layout, self.inits, n, generator)

    def _head(self, config, in_features: int,
              projections: list[tuple[str, int]]) -> AttentionHead:
        return AttentionHead(in_features, config.n_heads, config.qkv_dim,
                             config.emb_size, projections, config.n_classes,
                             config.bias)


def token_model_floats(head: AttentionHead, t: int, emb: int) -> int:
    """The count of a model that embeds token ids: the pad mask (its
    compare, broadcasts and the pair mask, booleans: 0.75 T + 0.5 T²), the
    two gathers with their index arithmetic and the position add (3 T·emb +
    8.5 T), then the head's (:meth:`AttentionHead.activation_floats`)."""
    return math.ceil(0.75 * t + 0.5 * t * t + 3 * t * emb + 8.5 * t
                     + head.activation_floats(t))


def _check_context(t: int, context_len: int) -> None:
    if t != context_len:
        raise ValueError(
            f'the tokens have context length {t} but the model has '
            f'context_len {context_len}; set '
            f'training.tokenizer.parameters.context_len to {context_len} '
            f'(the text loader pads and truncates to it; its default is 64)')


class AttentionClassifier(ChainAttentionModel):
    """Token and position embeddings, then :class:`AttentionHead`."""

    def __init__(self, config: AttentionClassifierConfig,
                 input_shape: tuple[int, ...] | None = None):
        super().__init__()
        self.config = config
        if input_shape is not None:
            _check_context(input_shape[-1], config.context_len)
        self.embedding = TokenEmbedding(config.vocab_size, config.emb_size,
                                        config.context_len)
        self.head = self._head(config, config.emb_size, [
            (f'projection_{i}', d)
            for i, d in enumerate(config.projection_dim)])
        self.layout = FlatLayout({EMBEDDING: self.embedding.param_shapes(),
                                  HEAD: self.head.param_shapes()})
        self.inits = {**self.embedding.param_inits(EMBEDDING),
                      **self.head.param_inits(HEAD)}

    def forward(self, theta: torch.Tensor, x: torch.Tensor,
                pad_id: int = 0) -> torch.Tensor:
        """``theta`` (C, dim), ``x`` (N, T) or (C, N, T) token ids ->
        (C, N, n_classes)."""
        _check_context(x.shape[-1], self.config.context_len)
        emb = self.embedding(theta, x, self.layout, EMBEDDING)
        return self.head(theta, emb, pad_mask(x, pad_id), self.layout, HEAD)

    def activation_floats(self) -> int:
        """Floats of one (sample, observation) pair's intermediates, as
        the JAX package's traced plan counts them (see
        :func:`token_model_floats`). The evaluation's chunk planner
        budgets memory with it."""
        return token_model_floats(self.head, self.config.context_len,
                                  self.config.emb_size)


class PretrainedAttentionClassifier(ChainAttentionModel):
    """Frozen ``.npy`` embeddings (``emb_path``, and its ``pos_emb``
    sibling), then :class:`AttentionHead`; the flat vector holds the head
    only."""

    def __init__(self, config: PretrainedAttentionClassifierConfig,
                 input_shape: tuple[int, ...] | None = None):
        super().__init__()
        if not config.emb_path:
            raise ValueError('PretrainedAttentionClassifier needs '
                             'model.emb_path (a .npy embedding table)')
        self.config = config
        if input_shape is not None:
            _check_context(input_shape[-1], config.context_len)
        self.embedding = PretrainedTokenEmbedding(config.emb_path,
                                                  config.context_len)
        self.head = self._head(config, self.embedding.emb_size, [
            (f'projection_{i}', d)
            for i, d in enumerate(config.projection_dim)])
        self.layout = FlatLayout({HEAD: self.head.param_shapes()})
        self.inits = self.head.param_inits(HEAD)

    def forward(self, theta: torch.Tensor, x: torch.Tensor,
                pad_id: int = 0) -> torch.Tensor:
        _check_context(x.shape[-1], self.config.context_len)
        return self.head(theta, self.embedding(x), pad_mask(x, pad_id),
                         self.layout, HEAD)

    def activation_floats(self) -> int:
        return token_model_floats(self.head, self.config.context_len,
                                  self.embedding.emb_size)


class EmbeddingClassifier(ChainAttentionModel):
    """Attention over precomputed embeddings (no table): ``forward(theta,
    x, attn_mask)`` with ``x`` ``(N, T, F)`` or ``(C, N, T, F)`` and a
    boolean mask broadcastable to ``(C, N, heads, T, T)``. Its leaves are
    ``MDPA``, ``projection`` (width 2 emb) and ``classifier`` at the top
    level. ``input_shape`` is ``(T, F)``; ``F`` defaults to ``emb_size``."""

    def __init__(self, config: EmbeddingClassifierConfig,
                 input_shape: tuple[int, ...] | None = None):
        super().__init__()
        self.config = config
        in_features = (input_shape[-1] if input_shape and len(input_shape) == 2
                       else config.emb_size)
        self.head = self._head(config, in_features,
                               [('projection', 2 * config.emb_size)])
        self.layout = FlatLayout(self.head.param_shapes())
        self.inits = self.head.param_inits('')

    def forward(self, theta: torch.Tensor, x: torch.Tensor,
                attn_mask: torch.Tensor) -> torch.Tensor:
        return self.head(theta, x, attn_mask, self.layout, '')

    def activation_floats(self) -> int:
        return math.ceil(self.head.activation_floats(
            self.config.context_len))
