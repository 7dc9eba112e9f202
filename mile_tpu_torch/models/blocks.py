"""Network building blocks over flat, chain-batched parameters
(counterpart of ``mile_tpu/models/blocks.py``, and of the Flax layers the
JAX package builds its models from: Dense, Conv, Embed and
MultiHeadDotProductAttention)."""
from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from mile_tpu_torch.models.layout import FlatLayout
from mile_tpu_torch.utils.precision import arithmetic

# flax.linen.initializers.lecun_normal: a normal truncated to [-2, 2],
# rescaled by this constant so that its variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


class Init(NamedTuple):
    """How one leaf is drawn, with variance 1/fan_in: Flax's lecun_normal
    (``truncated``; Dense, DenseGeneral and Conv kernels) or ``nn.Embed``'s
    untruncated normal. The module that owns a leaf gives its rule."""

    fan_in: int
    truncated: bool = True


def lecun_normal(shape: tuple[int, ...], fan_in: int,
                 generator: torch.Generator) -> torch.Tensor:
    """Truncated-normal draws with variance 1/fan_in, as Flax's Dense
    initializes its kernels (inverse-CDF sampling, float32 result)."""
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(shape, generator=generator,
                                    dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).float()


def init_flat(layout: FlatLayout, inits: Mapping[str, Init], n: int,
              generator: torch.Generator) -> torch.Tensor:
    """``n`` fresh members ``(n, dim)``: each leaf whose path ``inits``
    names is drawn by its rule, leaf by leaf in layout order; every other
    leaf (the biases) is zero, as Flax's ``zeros`` bias initializer."""
    flat = torch.zeros(n, layout.dim)
    for leaf in layout.leaves:
        rule = inits.get(leaf.path)
        if rule is None:
            continue
        if rule.truncated:
            block = lecun_normal((n, leaf.size), rule.fan_in, generator)
        else:
            block = (torch.randn((n, leaf.size), generator=generator,
                                 dtype=torch.float64)
                     * math.sqrt(1.0 / rule.fan_in)).float()
        flat[:, leaf.offset:leaf.offset + leaf.size] = block
    return flat


def leaf_view(theta: torch.Tensor, layout: FlatLayout,
              path: str) -> torch.Tensor:
    """Every chain's leaf ``path``: ``(C, *shape)``, a view of ``theta``."""
    leaf = layout[path]
    return theta[:, leaf.offset:leaf.offset + leaf.size].view(
        theta.shape[0], *leaf.shape)


def dense_params(in_features: int, features: int, use_bias: bool) -> dict:
    """A Flax Dense layer's leaves: ``kernel (in, out)``, ``bias (out,)``."""
    shapes = {'kernel': (in_features, features)}
    if use_bias:
        shapes['bias'] = (features,)
    return shapes


# The one bfloat16 pass (XLA's DEFAULT on a TPU) on the card: a bf16
# tensor-core product with a float32 result, where this torch has the
# out_dtype overload of bmm (CUDA only); elsewhere the rounding route.
OUT_DTYPE_BMM = hasattr(torch.ops.aten.bmm, 'dtype')


def one_pass_route(device: torch.device | str) -> str:
    """``'out_dtype'``: ``torch.bmm(a_bf16, b_bf16, out_dtype=float32)``;
    ``'rounding'``: operands rounded to bfloat16 and back, then an exact
    float32 product. Chosen by the device and by what torch offers, never
    after a failed launch."""
    if torch.device(device).type == 'cuda' and OUT_DTYPE_BMM:
        return 'out_dtype'
    return 'rounding'


def _one_pass_bmm(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """bfloat16 ``a16`` (B, M, K) times ``b16`` (B, K, N): exact products,
    float32 sums and result (inside a scope, so TF32 is off)."""
    if one_pass_route(a16.device) == 'out_dtype':
        return torch.bmm(a16, b16, out_dtype=torch.float32)
    return torch.bmm(a16.float(), b16.float())


class OnePassProduct(torch.autograd.Function):
    """``bmm`` at one bfloat16 pass, its cotangent products too (grad·bᵀ
    and aᵀ·grad, the cotangent rounded as the operands), as JAX's
    transposed dots run under the forward's precision."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        return _one_pass_bmm(a16, b16)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        a16, b16 = ctx.saved_tensors
        g16 = grad.to(torch.bfloat16)
        da = (_one_pass_bmm(g16, b16.transpose(1, 2))
              if ctx.needs_input_grad[0] else None)
        db = (_one_pass_bmm(a16.transpose(1, 2), g16)
              if ctx.needs_input_grad[1] else None)
        return da, db


class OnePassConv(torch.autograd.Function):
    """``conv2d`` (no bias) at one bfloat16 pass: input, filter and, in
    the backward, the cotangent rounded to bfloat16, then float32
    convolutions with TF32 off (the rounding route; cuDNN has no float32
    result for bfloat16 operands). The gradients through
    ``torch.nn.grad``'s ``conv2d_input`` and ``conv2d_weight``."""

    @staticmethod
    def forward(ctx, h, w, padding, groups):
        h16, w16 = h.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(h16, w16)
        ctx.padding, ctx.groups = padding, groups
        return F.conv2d(h16.float(), w16.float(), None, padding=padding,
                        groups=groups)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        h16, w16 = ctx.saved_tensors
        g = grad.to(torch.bfloat16).float()
        dh = (torch.nn.grad.conv2d_input(
            h16.shape, w16.float(), g, padding=ctx.padding,
            groups=ctx.groups) if ctx.needs_input_grad[0] else None)
        dw = (torch.nn.grad.conv2d_weight(
            h16.float(), w16.shape, g, padding=ctx.padding,
            groups=ctx.groups) if ctx.needs_input_grad[1] else None)
        return dh, dw, None, None


def _one_pass(*operands: torch.Tensor) -> bool:
    return (arithmetic() == 'bfloat16'
            and all(t.dtype == torch.float32 for t in operands))


def product(a: torch.Tensor, b: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every product of the models: ``a`` (..., M, K) times ``b`` (...,
    K, N), the leading axes equal, plus ``bias`` broadcast to the result,
    at the scope's arithmetic (:func:`~mile_tpu_torch.utils.precision.
    arithmetic`). Under ``'bfloat16'`` float32 operands take one bfloat16
    pass and the bias is a float32 add after it (XLA's bias add is no
    dot); otherwise ``matmul`` or ``baddbmm`` at torch's float32
    precision, which the scope sets. bfloat16 operands (``compute_dtype``)
    never change."""
    if _one_pass(a, b):
        lead = a.shape[:-2]
        y = OnePassProduct.apply(a.reshape(-1, *a.shape[-2:]),
                                 b.reshape(-1, *b.shape[-2:]))
        y = y.view(*lead, *y.shape[-2:])
        return y if bias is None else y + bias
    if bias is None:
        return torch.matmul(a, b)
    return torch.baddbmm(bias, a, b)


# A Dense kernel's gradient sums over every row: per chain an (in, N) x
# (N, out) product with a long inner axis, which cuBLAS's batched gemm runs
# as one small tile a chain when the kernel is small (at 36,000 rows, 12
# chains and [16, 16, 16, 2] 1.2 ms a call, 83 % of a NUTS leaf's device
# time on an H100). Inside :func:`split_k_rows`, from SPLIT_K_MIN_ROWS rows
# on, for a kernel of at most SPLIT_K_MAX_KERNEL entries, the exact
# product's backward splits the rows into blocks of SPLIT_K_ROWS,
# multiplies the blocks in one batched gemm and sums their products. Only
# the NUTS leaf's CUDA graph enters that scope (``mcmc/nuts.py``): there
# ``experiments/torch_nuts_leaf_rate.py`` measured the split against the
# plain product at every NUTS study shape: 1.32x at 4,500 rows to 3.99x
# at 36,000, 0.91x and 1.00x at 537 and 1,052 rows; kernels up to 48 x 48
# entries, none wider. Run eagerly, the leaf lost by it at 4,500-18,000
# rows and on bikesharing, and no other path was measured with it.
SPLIT_K_ROWS = 512
SPLIT_K_MIN_ROWS = 4096
SPLIT_K_MAX_KERNEL = 48 * 48

_split_k = False        # inside a split_k_rows() scope


@contextlib.contextmanager
def split_k_rows():
    """Let a Dense layer take :class:`SplitKProduct` in this scope (see
    above); outside it every Dense layer takes :func:`product`."""
    global _split_k
    prev = _split_k
    _split_k = True
    try:
        yield
    finally:
        _split_k = prev


def split_k_weight_grad(h: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """``hᵀ · grad`` per chain, ``h`` (C, N, in) and ``grad`` (C, N, out)
    -> (C, in, out), over blocks of ``SPLIT_K_ROWS`` rows and the rest."""
    n_chains, n, _ = h.shape
    blocks = n // SPLIT_K_ROWS
    full = blocks * SPLIT_K_ROWS
    hb = h[:, :full].reshape(n_chains * blocks, SPLIT_K_ROWS, -1)
    gb = grad[:, :full].reshape(n_chains * blocks, SPLIT_K_ROWS, -1)
    dw = torch.bmm(hb.transpose(1, 2), gb).view(
        n_chains, blocks, h.shape[-1], grad.shape[-1]).sum(dim=1)
    if full < n:
        dw = dw + torch.bmm(h[:, full:].transpose(1, 2), grad[:, full:])
    return dw


class SplitKProduct(torch.autograd.Function):
    """The exact ``baddbmm(bias, h, w)`` (``bmm`` without a bias) of a
    Dense layer over many rows, its kernel's gradient by
    :func:`split_k_weight_grad`; the input's and the bias's gradients as
    autograd's."""

    @staticmethod
    def forward(ctx, h, w, bias):
        ctx.save_for_backward(h, w)
        ctx.has_bias = bias is not None
        return torch.bmm(h, w) if bias is None else torch.baddbmm(bias, h, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        h, w = ctx.saved_tensors
        dh = (torch.bmm(grad, w.transpose(1, 2))
              if ctx.needs_input_grad[0] else None)
        dw = (split_k_weight_grad(h, grad)
              if ctx.needs_input_grad[1] else None)
        db = (grad.sum(dim=1, keepdim=True)
              if ctx.has_bias and ctx.needs_input_grad[2] else None)
        return dh, dw, db


def conv(h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
         padding: int, groups: int) -> torch.Tensor:
    """Every convolution of the models, at the scope's arithmetic, as
    :func:`product`."""
    if _one_pass(h, w):
        y = OnePassConv.apply(h, w, padding, groups)
        return y if bias is None else y + bias.view(1, -1, 1, 1)
    return F.conv2d(h, w, bias, padding=padding, groups=groups)


def dense(theta: torch.Tensor, h: torch.Tensor, layout: FlatLayout,
          name: str, use_bias: bool = True) -> torch.Tensor:
    """The Dense layer ``name`` of every chain: ``h`` (C, N, in) ->
    (C, N, out). A Flax Dense kernel is ``(in, out)``, as ``bmm`` wants."""
    w = leaf_view(theta, layout, f'{name}/kernel')
    bias = (leaf_view(theta, layout, f'{name}/bias').unsqueeze(1)
            if use_bias else None)
    if (_split_k and h.dim() == 3 and h.shape[1] >= SPLIT_K_MIN_ROWS
            and w.shape[-2] * w.shape[-1] <= SPLIT_K_MAX_KERNEL
            and not _one_pass(h, w) and h.dtype == w.dtype):
        return SplitKProduct.apply(h, w, bias)
    return product(h, w, bias)


def conv2d(theta: torch.Tensor, h: torch.Tensor, layout: FlatLayout,
           name: str, padding: int, shared: bool) -> torch.Tensor:
    """The Conv layer ``name`` of every chain in one ``conv2d``, with the
    chain axis folded into the channels (chain-major): ``h`` is
    ``(N, C * in, H, W)``, or ``(N, in, H, W)`` shared by every chain
    (``shared``); the result is ``(N, C * out, H', W')``.

    Kernel layout: a Flax Conv kernel is ``(kh, kw, in, out)``; torch wants
    ``(out, in, kh, kw)``, here ``(C * out, in, kh, kw)``. A shared input
    meets every chain's filters in one dense convolution; chain-major input
    channels meet their own chain's filters with ``groups=C``."""
    n_chains = theta.shape[0]
    k, b = layout[f'{name}/kernel'], layout[f'{name}/bias']
    kh, kw, c_in, c_out = k.shape
    w = theta[:, k.offset:k.offset + k.size].view(
        n_chains, kh, kw, c_in, c_out).permute(0, 4, 3, 1, 2).reshape(
        n_chains * c_out, c_in, kh, kw)
    bias = theta[:, b.offset:b.offset + b.size].reshape(-1)
    return conv(h, w, bias, padding, 1 if shared else n_chains)


class FullyConnected(nn.Module):
    """Stack of Dense layers named ``layer{i}`` with an activation between,
    reading its weights from a flat ``(C, dim)`` tensor.

    Parameter names and shapes are Flax's (``kernel`` is ``(in, out)``),
    so the flat layout is the JAX package's.
    """

    def __init__(self, in_features: int, hidden_sizes: tuple[int, ...],
                 activation: Callable, use_bias: bool = True,
                 last_layer_activation: Optional[Callable] = None,
                 blockid: Optional[str] = None):
        super().__init__()
        self.in_features = in_features
        self.hidden_sizes = tuple(hidden_sizes)
        self.activation = activation
        self.use_bias = use_bias
        self.last_layer_activation = last_layer_activation
        prefix = f'{blockid}_' if blockid else ''
        self.layer_names = [f'{prefix}layer{i}'
                            for i in range(len(self.hidden_sizes))]

    def _fan_ins(self):
        return zip(self.layer_names, (self.in_features,)
                   + self.hidden_sizes[:-1], self.hidden_sizes)

    def param_shapes(self) -> dict:
        return {name: dense_params(fan_in, size, self.use_bias)
                for name, fan_in, size in self._fan_ins()}

    def param_inits(self, scope: str) -> dict[str, Init]:
        return {f'{scope}/{name}/kernel': Init(fan_in)
                for name, fan_in, _ in self._fan_ins()}

    def forward(self, theta: torch.Tensor, x: torch.Tensor,
                layout: FlatLayout, scope: str) -> torch.Tensor:
        """``theta`` (C, dim), ``x`` (N, F) shared by all chains or
        (C, N, F) -> (C, N, out)."""
        n_chains = theta.shape[0]
        h = x if x.dim() == 3 else x.unsqueeze(0).expand(n_chains, -1, -1)
        last = len(self.layer_names) - 1
        for i, name in enumerate(self.layer_names):
            h = dense(theta, h, layout, f'{scope}/{name}', self.use_bias)
            if i < last:
                h = self.activation(h)
            elif self.last_layer_activation is not None:
                h = self.last_layer_activation(h)
        return h


def check_token_ids(tokens: torch.Tensor, vocab_size: int,
                    what: str = 'the embedding table') -> None:
    """Token ids must index ``vocab_size`` rows. The JAX package's gather
    fills an id out of range with NaN; on the card it would index out of
    bounds, so here it raises."""
    if tokens.is_floating_point():
        raise ValueError(f'token ids must be integers, got {tokens.dtype}')
    if tokens.numel() == 0:
        return
    lo, hi = torch.stack(torch.aminmax(tokens)).tolist()   # one host read
    if lo < 0 or hi >= vocab_size:
        raise ValueError(
            f'token ids span [{lo}, {hi}] but {what} has {vocab_size} rows; '
            f'set the model\'s vocab_size to at least the tokenizer\'s '
            f'vocabulary ({hi + 1} or more)')


class TokenEmbedding:
    """Flax's ``TokenEmbedding``: an ``nn.Embed`` table ``Embedding
    (vocab, emb)`` and, with ``pos_size``, learned positions
    ``PositionEmbedding (pos_size, emb)``, read from flat chain-batched
    parameters."""

    def __init__(self, vocab_size: int, emb_size: int,
                 pos_size: Optional[int] = None):
        self.vocab_size = vocab_size
        self.emb_size = emb_size
        self.pos_size = pos_size

    def param_shapes(self) -> dict:
        shapes = {'Embedding': {'embedding': (self.vocab_size,
                                              self.emb_size)}}
        if self.pos_size:
            shapes['PositionEmbedding'] = {
                'embedding': (self.pos_size, self.emb_size)}
        return shapes

    def param_inits(self, scope: str) -> dict[str, Init]:
        """``nn.Embed``'s default: an untruncated normal, variance 1/emb."""
        return {f'{scope}/{name}/embedding': Init(self.emb_size, False)
                for name in self.param_shapes()}

    def __call__(self, theta: torch.Tensor, tokens: torch.Tensor,
                 layout: FlatLayout, scope: str) -> torch.Tensor:
        """``tokens`` ``(N, T)`` shared by every chain or ``(C, N, T)``
        -> ``(C, N, T, emb)``: each chain gathers from its own table."""
        check_token_ids(tokens, self.vocab_size)
        n_chains, t = theta.shape[0], tokens.shape[-1]
        table = leaf_view(theta, layout, f'{scope}/Embedding/embedding')
        # one gather from the chains' tables stacked (C * vocab, emb):
        # F.embedding's backward sums the rows of repeated ids segment by
        # segment, where an indexing backward serializes them
        offsets = torch.arange(n_chains, device=tokens.device)[:, None, None]
        emb = F.embedding(tokens + offsets * self.vocab_size,
                          table.reshape(n_chains * self.vocab_size,
                                        self.emb_size))
        if self.pos_size:
            pos = leaf_view(theta, layout,
                            f'{scope}/PositionEmbedding/embedding')
            emb = emb + pos[:, None, :t]
        return emb


class PretrainedTokenEmbedding(nn.Module):
    """Frozen embedding tables from ``.npy`` files (Flax's
    ``PretrainedTokenEmbedding``): not parameters, so not in the flat
    vector. The positions, with ``pos_size``, come from the sibling file
    whose basename has its first ``emb`` renamed ``pos_emb``
    (``emb.npy`` -> ``pos_emb.npy``); the directories keep their names."""

    def __init__(self, pretrained_weights_path: str,
                 pos_size: Optional[int] = None):
        super().__init__()
        self.pos_size = pos_size
        self.register_buffer('emb', torch.from_numpy(np.asarray(
            np.load(pretrained_weights_path), np.float32)))
        if pos_size:
            head, base = os.path.split(pretrained_weights_path)
            pos_path = os.path.join(head, base.replace('emb', 'pos_emb', 1))
            self.register_buffer('pos', torch.from_numpy(np.asarray(
                np.load(pos_path), np.float32)))

    @property
    def emb_size(self) -> int:
        return self.emb.shape[1]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens`` ``(..., T)`` -> ``(..., T, emb)``, on the tokens'
        device."""
        check_token_ids(tokens, self.emb.shape[0],
                        'the pretrained embedding table')
        emb = self.emb.to(tokens.device)[tokens]
        if self.pos_size:
            emb = emb + self.pos.to(tokens.device)[:tokens.shape[-1]]
        return emb


def attention_params(in_features: int, n_heads: int, qkv_dim: int,
                     out_features: int, bias: bool) -> dict:
    """The leaves of Flax's ``MultiHeadDotProductAttention``: DenseGeneral
    kernels ``query``/``key``/``value`` ``(in, heads, head_dim)`` and
    ``out`` ``(heads, head_dim, out)``, with biases ``(heads, head_dim)``
    and ``(out,)`` when ``bias``."""
    if qkv_dim % n_heads:
        raise ValueError(f'qkv_dim {qkv_dim} is not a multiple of n_heads '
                         f'{n_heads}')
    head_dim = qkv_dim // n_heads
    shapes = {}
    for name in ('query', 'key', 'value'):
        shapes[name] = {'kernel': (in_features, n_heads, head_dim)}
        if bias:
            shapes[name]['bias'] = (n_heads, head_dim)
    shapes['out'] = {'kernel': (n_heads, head_dim, out_features)}
    if bias:
        shapes['out']['bias'] = (out_features,)
    return shapes


def attention_inits(scope: str, in_features: int,
                    qkv_dim: int) -> dict[str, Init]:
    """DenseGeneral draws a kernel flattened to ``(prod(in axes),
    prod(out axes))``: fan-in ``in`` for query, key and value, and
    ``heads * head_dim`` for out."""
    inits = {f'{scope}/{name}/kernel': Init(in_features)
             for name in ('query', 'key', 'value')}
    inits[f'{scope}/out/kernel'] = Init(qkv_dim)
    return inits


def multi_head_attention(theta: torch.Tensor, x: torch.Tensor,
                         mask: Optional[torch.Tensor], layout: FlatLayout,
                         scope: str, n_heads: int, qkv_dim: int,
                         out_features: int, bias: bool) -> torch.Tensor:
    """Self-attention of every chain, as Flax's
    ``MultiHeadDotProductAttention`` computes it: ``x`` ``(C, N, T, F)``
    (or ``(N, T, F)`` shared by every chain), ``mask`` boolean and
    broadcastable to ``(C, N, heads, T, T)`` (True: attend) -> ``(C, N, T,
    out)``.

    The query is divided by sqrt(head_dim); masked scores are set to the
    dtype's most negative finite value, not -inf, and the softmax runs in
    float32. A row masked whole (a pad query) thus becomes uniform over
    all T keys, pads included, as in Flax; -inf would give NaN, and
    ``scaled_dot_product_attention`` zeros."""
    n_chains = theta.shape[0]
    if x.dim() == 3:
        x = x.expand(n_chains, *x.shape)
    _, n, t, f = x.shape
    head_dim = qkv_dim // n_heads
    h = x.reshape(n_chains, n * t, f)

    def project(name):
        w = leaf_view(theta, layout, f'{scope}/{name}/kernel')
        y = product(h, w.reshape(n_chains, f, qkv_dim))
        if bias:
            y = y + leaf_view(theta, layout, f'{scope}/{name}/bias').reshape(
                n_chains, 1, qkv_dim)
        # (C, N, T, heads, head_dim) -> (C, N, heads, T, head_dim)
        return y.view(n_chains, n, t, n_heads, head_dim).transpose(2, 3)

    q = project('query') / math.sqrt(head_dim)
    k, v = project('key'), project('value')
    scores = product(q, k.transpose(-1, -2))           # (C, N, H, T, T)
    if mask is not None:    # one pass; masked_fill would clone first
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    weights = F.softmax(scores, dim=-1, dtype=torch.float32).to(scores.dtype)
    y = product(weights, v).transpose(2, 3).reshape(
        n_chains, n * t, qkv_dim)
    w = leaf_view(theta, layout, f'{scope}/out/kernel').reshape(
        n_chains, qkv_dim, out_features)
    y = product(y, w, leaf_view(theta, layout, f'{scope}/out/bias')
                .unsqueeze(1) if bias else None)
    return y.view(n_chains, n, t, out_features)


class MaskedMultiHeadSelfAttention:
    """Flax's causal ``MaskedMultiHeadSelfAttention`` block: each position
    attends to itself and the positions before it (``nn.make_causal_mask``);
    its attention's leaves are ``MultiHeadDotProductAttention_0/...`` and
    its output has the input's width."""

    name = 'MultiHeadDotProductAttention_0'

    def __init__(self, in_features: int, n_heads: int, qkv_dim: int,
                 bias: bool):
        self.in_features = in_features
        self.n_heads = n_heads
        self.qkv_dim = qkv_dim
        self.bias = bias

    def param_shapes(self) -> dict:
        return {self.name: attention_params(
            self.in_features, self.n_heads, self.qkv_dim, self.in_features,
            self.bias)}

    def param_inits(self, scope: str) -> dict[str, Init]:
        prefix = f'{scope}/{self.name}' if scope else self.name
        return attention_inits(prefix, self.in_features, self.qkv_dim)

    def __call__(self, theta: torch.Tensor, x: torch.Tensor,
                 layout: FlatLayout, scope: str = '') -> torch.Tensor:
        t = x.shape[-2]
        causal = torch.ones(t, t, dtype=torch.bool,
                            device=x.device).tril()
        prefix = f'{scope}/{self.name}' if scope else self.name
        return multi_head_attention(theta, x, causal, layout, prefix,
                                    self.n_heads, self.qkv_dim,
                                    self.in_features, self.bias)
