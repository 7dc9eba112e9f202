"""The port's attention classifiers against the Flax modules of the JAX
package: the flat layout and its dims, the initializer's statistics per
leaf, the forward pass of all three models with pads and an all-pad row,
the causal block, the chunked log-density and its gradient over token ids,
AdamW warm-start steps, the evaluation's chunk plan, and the errors the
port raises where the JAX package fills NaN or asserts."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_parity import one_torch_thread, t  # noqa: F401
from jax.flatten_util import ravel_pytree

from mile_tpu.config import models as jax_models
from mile_tpu.models import build_model as jax_build_model
from mile_tpu_torch.config import models as torch_models
from mile_tpu_torch.models import build_model, flat_from_jax_params

SEQUENTIAL_MOD = dict(vocab_size=1000, context_len=70, emb_size=48,
                      n_heads=8, qkv_dim=64, bias=False, n_classes=2,
                      projection_dim=[32])
TEXT_CLASSIFIER = dict(vocab_size=128, context_len=70, emb_size=32,
                       n_heads=4, qkv_dim=32, n_classes=2,
                       projection_dim=[32])
SMALL = dict(vocab_size=30, context_len=12, emb_size=16, n_heads=4,
             qkv_dim=16, n_classes=3)
PRETRAINED_EMB = 10      # the width of the small pretrained tables


def pretrained_tables(tmp_path):
    """emb.npy (vocab, 10) and its pos_emb.npy sibling (context, 10), in a
    directory whose name holds 'emb' (only the basename is renamed)."""
    d = tmp_path / 'emb_dir'
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(11)
    for name, rows in (('emb', SMALL['vocab_size']),
                       ('pos_emb', SMALL['context_len'])):
        np.save(d / f'{name}.npy', rng.normal(
            size=(rows, PRETRAINED_EMB)).astype(np.float32))
    return str(d / 'emb.npy')


def pair(name, tmp_path=None, **fields):
    """(Flax module, port model, the JAX module's example inputs)."""
    cfg = {**SMALL, **fields}
    if name == 'PretrainedAttentionClassifier':
        cfg['emb_path'] = pretrained_tables(tmp_path)
    config = f'{name}Config'
    module = jax_build_model(getattr(jax_models, config)(**cfg))
    t_cfg = getattr(torch_models, config)(**cfg)
    n_ctx = cfg['context_len']
    if name == 'EmbeddingClassifier':
        model = build_model(t_cfg, (n_ctx, PRETRAINED_EMB))
        example = (jnp.zeros((1, n_ctx, PRETRAINED_EMB)),
                   jnp.ones((1, 1, n_ctx, n_ctx), bool))
    else:
        model = build_model(t_cfg, (n_ctx,))
        example = (jnp.zeros((1, n_ctx), jnp.int32),)
    return module, model, example


def jax_members(module, example, n, seed=0):
    """``n`` Flax inits: (stacked tree, flat (n, dim) numpy)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    tree = jax.jit(jax.vmap(lambda k: module.init(k, *example)['params']))(
        keys)
    return tree, np.asarray(jax.vmap(lambda p: ravel_pytree(p)[0])(tree))


def jax_params(module, example, n, seed=0, scale=0.3):
    """``n`` members of the Flax module's parameter tree, every entry
    (biases too) drawn N(0, scale^2) with numpy: (flat (n, dim) float32,
    unravel). The tree's structure comes from an abstract init, which
    compiles nothing."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *example)['params'])
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    flat, unravel = ravel_pytree(template)
    draws = np.random.default_rng(seed).normal(size=(n, flat.size)) * scale
    return draws.astype(np.float32), unravel


def tokens(n, vocab=SMALL['vocab_size'], t_len=SMALL['context_len'],
           seed=0):
    """Token ids with trailing pads of every length, one sequence all pads
    and one with leading pads."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, vocab, size=(n, t_len))
    lengths = rng.integers(1, t_len + 1, size=n)
    x[np.arange(t_len)[None, :] >= lengths[:, None]] = 0
    x[1] = 0
    x[2, :3] = 0
    return x


@pytest.mark.parametrize('widths,dim', [(SEQUENTIAL_MOD, 65_248),
                                        (TEXT_CLASSIFIER, 11_520)],
                         ids=['sequential_mod', 'text_classifier'])
def test_layout_matches_ravel_pytree(widths, dim):
    """Leaf paths and shapes in ravel_pytree order (``TokenEmbedding_0``
    before ``_AttentionHead_0``; key, out, query, value in ``MDPA``); the
    dims of the two configs; flat_from_jax_params gives ravel_pytree's
    vector, and the leading member axis is kept."""
    module = jax_build_model(jax_models.AttentionClassifierConfig(**widths))
    model = build_model(torch_models.AttentionClassifierConfig(**widths),
                        (70,))
    flat, unravel = jax_params(module, (jnp.zeros((1, 70), jnp.int32),), 2)
    tree = jax.tree.map(np.asarray, jax.vmap(unravel)(flat))
    one = jax.tree.map(lambda a: a[0], tree)
    leaves = jax.tree_util.tree_flatten_with_path(one)[0]
    assert [leaf.path for leaf in model.layout.leaves] == [
        '/'.join(str(k.key) for k in path) for path, _ in leaves]
    assert [leaf.shape for leaf in model.layout.leaves] == [
        v.shape for _, v in leaves]
    assert model.dim == dim == flat.shape[1]
    assert model.layout.leaves[0].path == \
        'TokenEmbedding_0/Embedding/embedding'
    np.testing.assert_array_equal(flat_from_jax_params(one, model.layout),
                                  flat[0])
    np.testing.assert_array_equal(flat_from_jax_params(tree, model.layout),
                                  flat)


MODELS = ['AttentionClassifier', 'PretrainedAttentionClassifier',
          'EmbeddingClassifier']


@pytest.mark.parametrize('name', MODELS)
@pytest.mark.parametrize('bias', [False, True], ids=['no-bias', 'bias'])
def test_forward_matches_flax(name, bias, tmp_path):
    """3 chains of random members (every entry N(0, 0.09)) with two
    projection layers on 9 sequences with pads, an all-pad sequence and
    leading pads, the tokens shared by every chain and one batch per
    chain: rtol 1e-5, atol 1e-6. EmbeddingClassifier takes embeddings and
    a mask with a masked-whole query row."""
    module, model, example = pair(name, tmp_path, bias=bias,
                                  projection_dim=[8, 6])
    flat, unravel = jax_params(module, example, 3, seed=1)
    x = tokens(3 * 9, seed=3)

    def jax_apply(theta, *args):
        return module.apply({'params': unravel(theta)}, *args)

    if name == 'EmbeddingClassifier':
        emb = np.random.default_rng(4).normal(
            size=(3 * 9, SMALL['context_len'], PRETRAINED_EMB)).astype(
            np.float32)
        valid = x != 0
        mask = (valid[:, :, None] & valid[:, None, :])[:, None]
        shared = (emb[:9], mask[:9])
        per_chain = (emb.reshape(3, 9, *emb.shape[1:]),
                     mask.reshape(3, 9, *mask.shape[1:]))
        to_torch = (t, torch.from_numpy)
    else:
        shared, per_chain = (x[:9],), (x.reshape(3, 9, -1),)
        to_torch = (torch.from_numpy,)
    want = jax.jit(jax.vmap(lambda f: jax_apply(f, *shared)))(flat)
    got = model(t(flat), *(f(a) for f, a in zip(to_torch, shared)))
    assert got.shape == (3, 9, 3)
    assert np.isfinite(got.detach().numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    want = jax.jit(jax.vmap(jax_apply))(flat, *per_chain)
    got = model(t(flat), *(f(a) for f, a in zip(to_torch, per_chain)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_pad_queries_attend_uniformly():
    """Flax fills masked scores with the most negative float: a query
    row masked whole (a pad query) softmaxes to uniform over all T keys,
    pads included, so every position of a sequence masked whole gets the
    same output, the mean of the values projected; finite, and not what
    the unmasked attention gives."""
    from mile_tpu_torch.models.blocks import multi_head_attention

    _, model, _ = pair('AttentionClassifier', projection_dim=[8])
    theta = model.init(2, torch.Generator().manual_seed(0))
    x = torch.randn(2, 1, 5, 16)
    mask = torch.zeros(1, 1, 1, 5, 5, dtype=torch.bool)
    args = (model.layout, '_AttentionHead_0/MDPA', 4, 16, 16, False)
    out = multi_head_attention(theta, x, mask, *args)
    ones = multi_head_attention(theta, x, torch.ones_like(mask), *args)
    # a masked-whole row attends uniformly: every position gets the mean
    # of the values, the same output everywhere
    assert torch.isfinite(out).all()
    assert torch.allclose(out, out[:, :, :1].expand_as(out), atol=1e-6)
    assert not torch.allclose(out, ones)


@pytest.mark.parametrize('bias', [False, True], ids=['no-bias', 'bias'])
def test_causal_block_matches_flax(bias):
    """MaskedMultiHeadSelfAttention (the causal mask of
    nn.make_causal_mask) on 2 chains of 5 sequences of 7 positions, width
    12: rtol 1e-5, atol 1e-6."""
    from mile_tpu.models.blocks import MaskedMultiHeadSelfAttention as JaxB
    from mile_tpu_torch.models.blocks import MaskedMultiHeadSelfAttention
    from mile_tpu_torch.models.layout import FlatLayout

    module = JaxB(n_heads=3, qkv_dim=12, bias=bias)
    x = np.random.default_rng(5).normal(size=(5, 7, 12)).astype(np.float32)
    flat, unravel = jax_params(module, (jnp.asarray(x[:1]),), 2, seed=6)
    block = MaskedMultiHeadSelfAttention(12, 3, 12, bias)
    layout = FlatLayout(block.param_shapes())
    assert layout.dim == flat.shape[1]
    want = jax.jit(jax.vmap(lambda f: module.apply({'params': unravel(f)},
                                                    x)))(flat)
    got = block(t(flat), t(x), layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the first position attends to itself alone: the result does not
    # change when later positions do
    x2 = x.copy()
    x2[:, 1:] += 1.0
    np.testing.assert_allclose(block(t(flat), t(x2), layout)[:, :, 0].numpy(),
                               got[:, :, 0].numpy(), rtol=1e-6, atol=1e-7)


def test_init_statistics_match_flax():
    """At sequential_mod widths, 8 members of the port's init against 8 of
    Flax's, leaf by leaf: the token and position embeddings N(0, 1/emb)
    untruncated (variance x 48 near 1, some |z| beyond the lecun
    truncation at 2); query, key and value lecun-normal with fan-in emb
    (variance x 48), out with fan-in heads x head_dim (x 64), the Dense
    kernels with their fan-in, all truncated at 2 standard deviations;
    the two draws' variances within 4 % of each other's target."""
    module = jax_build_model(jax_models.AttentionClassifierConfig(
        **SEQUENTIAL_MOD))
    model = build_model(torch_models.AttentionClassifierConfig(
        **SEQUENTIAL_MOD), (70,))
    tree, ref = jax_members(module, (jnp.zeros((1, 70), jnp.int32),), 8,
                            seed=8)
    ours = model.init(8, torch.Generator().manual_seed(8)).double().numpy()
    fan_ins = {'TokenEmbedding_0/Embedding/embedding': (48, False),
               'TokenEmbedding_0/PositionEmbedding/embedding': (48, False),
               '_AttentionHead_0/MDPA/key/kernel': (48, True),
               '_AttentionHead_0/MDPA/query/kernel': (48, True),
               '_AttentionHead_0/MDPA/value/kernel': (48, True),
               '_AttentionHead_0/MDPA/out/kernel': (64, True),
               '_AttentionHead_0/projection_0/kernel': (48, True),
               '_AttentionHead_0/classifier/kernel': (32, True)}
    assert {leaf.path for leaf in model.layout.leaves} == set(fan_ins)
    for leaf in model.layout.leaves:
        fan_in, truncated = fan_ins[leaf.path]
        for draws in (ours, ref):
            z = draws[:, leaf.offset:leaf.offset + leaf.size] * np.sqrt(
                fan_in)
            # 512 draws (the classifier) leave a standard error of 6 % on
            # the variance; every other leaf has at least 12,288
            tol = 0.25 if z.size < 1000 else 0.05
            assert z.var() == pytest.approx(1.0, rel=tol), leaf.path
            bound = 2.0 / 0.87962566103423978 * (1 + 1e-6)
            if truncated:
                assert np.abs(z).max() <= bound, leaf.path
            else:
                assert np.abs(z).max() > 3.0, leaf.path


def test_out_of_range_tokens_and_context_length_raise(tmp_path):
    """Ids past the table raise a ValueError in the port (JAX's gather
    fills NaN); a context length other than the model's raises a
    ValueError naming the tokenizer parameter, at build time from the
    loader's input shape and in the forward (JAX asserts)."""
    _, model, _ = pair('AttentionClassifier')
    theta = model.init(2, torch.Generator().manual_seed(0))
    x = torch.from_numpy(tokens(4))
    model(theta, x)
    x[0, 0] = SMALL['vocab_size']
    with pytest.raises(ValueError, match='vocab_size'):
        model(theta, x)
    with pytest.raises(ValueError, match='vocab_size'):
        model(theta, -x.abs())
    with pytest.raises(ValueError, match='tokenizer.parameters.context_len'):
        model(theta, torch.ones(4, 11, dtype=torch.long))
    with pytest.raises(ValueError, match='tokenizer.parameters.context_len'):
        build_model(torch_models.AttentionClassifierConfig(**SMALL), (64,))
    _, pre, _ = pair('PretrainedAttentionClassifier', tmp_path)
    with pytest.raises(ValueError, match='pretrained embedding table'):
        pre(pre.init(1, torch.Generator().manual_seed(0)),
            torch.full((2, 12), SMALL['vocab_size']))


def _bayes_pair(chunk, n, seed=0, bias=True):
    from mile_tpu.bayes import BayesianModel as JaxBayes
    from mile_tpu.bayes.priors import Prior as JaxPrior
    from mile_tpu.config.data import Task as JaxTask
    from mile_tpu.config.training import PriorDist as JaxPriorDist
    from mile_tpu_torch.bayes import BayesianModel
    from mile_tpu_torch.bayes.priors import Prior
    from mile_tpu_torch.config.data import Task
    from mile_tpu_torch.config.training import PriorDist

    module, model, example = pair('AttentionClassifier', bias=bias,
                                  projection_dim=[8])
    flat, unravel = jax_params(module, example, 1, seed=seed)
    template = unravel(flat[0])
    jax_bayes = JaxBayes(module, template,
                         JaxPrior.from_name(JaxPriorDist.STANDARD_NORMAL),
                         JaxTask.CLASSIFICATION, likelihood_chunk_size=chunk)
    bayes = BayesianModel(model, Prior.from_name(PriorDist.STANDARD_NORMAL),
                          Task.CLASSIFICATION, likelihood_chunk_size=chunk)
    x = tokens(n, seed=seed + 1)
    y = np.random.default_rng(seed + 2).integers(0, 3, n)
    return jax_bayes, bayes, x, y


def test_chunked_logdensity_and_gradient_match_jax():
    """The log-posterior over token ids and its gradient for 3 chains on
    40 sequences in chunks of 16 (2 recomputed full chunks and a remainder
    of 8), against the JAX package's BayesianModel with the same chunks:
    value rtol 1e-5, gradient atol 1e-5 max|g|; unchunked, the port agrees
    with itself to rtol 1e-6 and atol 1e-5 max|g|. The embedding rows of
    ids that no sequence holds get the prior's gradient alone."""
    jax_bayes, bayes, x, y = _bayes_pair(16, 40)
    theta = (np.random.default_rng(5).normal(size=(3, bayes.dim)) * 0.3
             ).astype(np.float32)
    logdensity = jax_bayes.logdensity_fn(jnp.asarray(x, jnp.int32),
                                         jnp.asarray(y, jnp.int32))
    want_v, want_g = jax.jit(jax.vmap(jax.value_and_grad(logdensity)))(
        theta)
    vg = bayes.logdensity_and_grad_fn(torch.from_numpy(x),
                                      torch.from_numpy(y))
    v, g = vg(t(theta))
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), rtol=1e-5)
    scale = float(np.abs(want_g).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-5 * scale)
    bayes.likelihood_chunk_size = None
    v1, g1 = bayes.logdensity_and_grad_fn(torch.from_numpy(x),
                                          torch.from_numpy(y))(t(theta))
    np.testing.assert_allclose(v1.numpy(), v.numpy(), rtol=1e-6)
    np.testing.assert_allclose(g1.numpy(), g.numpy(), rtol=0,
                               atol=1e-5 * scale)


def test_adamw_member_steps_match_optax():
    """Five AdamW steps of 3 members, each on its own batches of 8
    sequences (the port's per-member (M, B, T) tokens), through the warm
    start's member step, against ``optax.adamw`` on the same index plan
    and init: rtol 1e-5, atol 1e-5 (1e-3 of the learning rate), as the
    LeNetti Adam test: Adam scales each entry's step by its own gradient's
    size, so an entry whose batch gradient nearly cancels carries the
    float32 rounding of its terms into its step (one entry of 5,544 parts
    by 4e-6 here). Without biases: the key bias's gradient is zero in
    exact arithmetic (a softmax does not see a shift common to a row's
    scores), so its float32 value is rounding noise alone, which Adam
    scales up to steps of order the learning rate, different in each
    package."""
    from mile_tpu.config.training import OptimizerConfig as JaxOptimizer
    from mile_tpu.train import warmstart as jax_ws
    from mile_tpu_torch.config.data import Task
    from mile_tpu_torch.config.training import OptimizerConfig
    from mile_tpu_torch.train import warmstart as ws

    adamw = {'name': 'adamw', 'parameters': {
        'learning_rate': 0.01, 'weight_decay': 0.001}}
    module, model, example = pair('AttentionClassifier', bias=False,
                                  projection_dim=[8])
    init, unravel = jax_params(module, example, 3, seed=9)
    tree = jax.vmap(unravel)(init)
    n_members, n_steps, batch, n = 3, 5, 8, 48
    x = tokens(n, seed=10)
    y = np.random.default_rng(11).integers(0, 3, n)
    rng = np.random.default_rng(12)
    plan = np.stack([rng.permutation(n)[:n_steps * batch].reshape(
        n_steps, batch) for _ in range(n_members)])

    tx = JaxOptimizer.from_dict(adamw).build()
    jx, jy = jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32)

    def member_step(p, opt, rows):
        def lf(p):
            return jax_ws._class_loss(module.apply({'params': p}, jx[rows]),
                                      jy[rows])
        updates, opt = tx.update(jax.grad(lf)(p), opt, p)
        return optax.apply_updates(p, updates), opt

    params, opt = tree, jax.vmap(tx.init)(tree)
    step = jax.jit(jax.vmap(member_step))
    for s in range(n_steps):
        params, opt = step(params, opt, plan[:, s])
    want = flat_from_jax_params(jax.tree.map(np.asarray, params),
                                model.layout)

    flat = t(init).requires_grad_(True)
    optimizer = OptimizerConfig.from_dict(adamw).build([flat])
    loss_fn, metrics_fn, _ = ws.task_fns(Task.CLASSIFICATION)
    shards = ws.MemberShards(None, n_members, torch.from_numpy(x),
                             torch.from_numpy(y), Task.CLASSIFICATION)
    for s in range(n_steps):
        metrics = ws.member_step(model, flat, optimizer, loss_fn, metrics_fn,
                                 shards, torch.from_numpy(plan[:, s]),
                                 np.zeros(n_members, dtype=bool))
    assert set(metrics) == {'cross_entropy', 'accuracy'}
    np.testing.assert_allclose(flat.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('name', MODELS)
@pytest.mark.parametrize('bias', [False, True], ids=['no-bias', 'bias'])
def test_eval_chunk_plan_is_never_larger_than_jax(name, bias, tmp_path):
    """For the same budget and draw count, the port's (sample,
    observation) chunk is no larger than the JAX package's traced plan,
    for a budget of about ten observations' worth and for 4 GiB: the
    port's unit, its count plus 2 dim floats for the parameter leaves, is
    at least the traced unit, and without biases equal to it (the JAX
    trace reshapes no 1-D bias leaf)."""
    from mile_tpu.inference.evaluation import plan_eval_chunks as jax_plan
    from mile_tpu.inference.evaluation import unit_activation_bytes
    from mile_tpu_torch.inference.evaluation import plan_eval_chunks

    module, model, example = pair(name, tmp_path, bias=bias,
                                  projection_dim=[8, 6])
    _, unravel = jax_params(module, example, 1)
    x = jnp.zeros((3000, *example[0].shape[1:]), example[0].dtype)
    if name == 'EmbeddingClassifier':
        # the traced unit of the two-argument forward, the mask as given
        def unit(*_):
            ref = jax.make_jaxpr(lambda th, xx, m: module.apply(
                {'params': unravel(th)}, xx, m))(
                jax.ShapeDtypeStruct((model.dim,), jnp.float32), *example)
            from mile_tpu.inference.evaluation import _jaxpr_bytes
            return _jaxpr_bytes(ref.jaxpr)
        ref_unit = unit()
    else:
        ref_unit = unit_activation_bytes(module, unravel, model.dim, x)
    ours_unit = 4 * (model.activation_floats() + 2 * model.dim)
    assert ours_unit >= ref_unit
    if not bias:
        assert ours_unit == ref_unit
    if name == 'EmbeddingClassifier':
        return
    for n_samples in (7, 1000):
        for budget in (10 ** 5, 4 * 1024 ** 3):
            ours = plan_eval_chunks(model, x.shape[0], n_samples,
                                    memory_budget_bytes=budget)
            ref = jax_plan(module, unravel, model.dim, x, n_samples,
                           memory_budget_bytes=budget)
            assert ours[0] <= ref[0] and ours[1] <= ref[1], (n_samples,
                                                             budget)


def test_trainer_refuses_embedding_classifier(tmp_path):
    """EmbeddingClassifier's forward takes (x, attn_mask); no loader
    gives a mask, and the JAX trainer fails there too (its module.init
    gets one argument): the port's trainer raises a ValueError saying
    so."""
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    cfg = Config.from_dict({
        'saving_dir': str(tmp_path), 'experiment_name': 'emb',
        'data': {'path': 'texts.csv', 'data_type': 'text', 'task': 'class'},
        'model': {'model': 'EmbeddingClassifier', **SMALL}})
    with pytest.raises(ValueError, match=r'\(x, attn_mask\)'):
        BDETrainer(cfg, device='cpu')
