"""The port's matmul arithmetic against the JAX package's on the CPU.

``'bfloat16'`` is the TPU's one bfloat16 pass (XLA's ``DEFAULT``): each
operand of a product rounded to bfloat16, exact products, float32 sums
and result, the cotangent products of the backward pass too. On the CPU
the port rounds the operands and multiplies in exact float32, so each
product is held against ``jax.lax.dot_general`` of the bfloat16 operands
with a float32 result and against a float64 numpy product of the rounded
operands. Every tolerance is the float32 accumulation bound: a sum of K
exact products differs from the float64 sum by at most K·2⁻²⁴·Σ|a||b|,
so two float32 sums of the same products (the port's and JAX's, in other
orders) by at most twice that.

The scopes, what ``None`` stands for under both process settings, the
phases that stay exact whatever it stands for, and a whole
``BayesianModel.logdensity_and_grad_fn`` in both arithmetics are held
here too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _torch_parity import (  # noqa: F401
    jax_airfoil,
    one_torch_thread,
    t,
    torch_airfoil,
)

from mile_tpu_torch.models import blocks, flat_from_jax_params
from mile_tpu_torch.utils import precision
from mile_tpu_torch.utils.precision import matmul_precision

U = 2.0 ** -24


@pytest.fixture
def tpu_setting():
    """The process's ``None`` as the TPU's one pass, restored after."""
    before = precision.none_precision()
    precision.set_none_precision('bfloat16')
    yield
    precision.set_none_precision(before)


def rounded(a) -> np.ndarray:
    """``a`` rounded to bfloat16 (to nearest, ties to even), as float64."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16),
                      np.float64)


def bmm(a, b) -> np.ndarray:
    return np.einsum('bmk,bkn->bmn', a, b)


def within(got, want, bound, factor=1.0):
    """|got - want| ≤ factor · K·2⁻²⁴·Σ|a||b| (``bound`` = K·Σ|a||b|)."""
    excess = np.abs(np.asarray(got, np.float64) - want) - factor * U * bound
    assert excess.max() <= 0, excess.max()


def one_pass(fn, operands, cotangent):
    """``fn(*operands)`` under ``'bfloat16'`` and the operands' gradients
    for ``cotangent``, as float64 numpy arrays."""
    ts = [t(a).requires_grad_() for a in operands]
    with matmul_precision('bfloat16'):
        y = fn(*ts)
        y.backward(t(cotangent))
    return [v.detach().double().numpy() for v in (y, *(x.grad for x in ts))]


@pytest.mark.parametrize('shape', [(12, 1052, 5, 16), (12, 1052, 16, 16),
                                   (12, 1052, 16, 2), (3, 7, 40, 9)])
def test_the_dense_product_is_one_bf16_pass(shape):
    """FCN [16, 16, 2]'s and [16, 16, 16, 2]'s products at 12 chains of
    airfoil's 1052 rows: the output against JAX's one pass and a float64
    product of the rounded operands; the input gradient g·Wᵀ (K = out) and
    the weight gradient hᵀ·g (K = rows) against float64 products of the
    rounded cotangent and operand."""
    c, n, k, m = shape
    rng = np.random.default_rng(sum(shape))
    a = rng.standard_normal((c, n, k)).astype(np.float32)
    b = rng.standard_normal((c, k, m)).astype(np.float32)
    g = rng.standard_normal((c, n, m)).astype(np.float32)
    y, da, db = one_pass(blocks.product, (a, b), g)
    ra, rb, rg = rounded(a), rounded(b), rounded(g)
    ref = np.asarray(jax.lax.dot_general(
        jnp.asarray(a).astype(jnp.bfloat16),
        jnp.asarray(b).astype(jnp.bfloat16),
        (((2,), (1,)), ((0,), (0,))), preferred_element_type=jnp.float32))
    mass = k * bmm(np.abs(ra), np.abs(rb))
    within(y, ref, mass, 2)
    within(y, bmm(ra, rb), mass)
    tr = lambda x: x.transpose(0, 2, 1)
    within(da, bmm(rg, tr(rb)), m * bmm(np.abs(rg), np.abs(tr(rb))))
    within(db, bmm(tr(ra), rg), n * bmm(np.abs(tr(ra)), np.abs(rg)))
    # the rounding is real: the exact float32 product differs
    assert np.abs(bmm(a.astype(np.float64), b) - y).max() > 1e-4


def test_the_bias_is_a_float32_add_after_the_pass():
    """``product(a, b, bias)`` is the one pass plus the bias unrounded, as
    XLA adds a Dense bias outside the dot."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 6, 4)).astype(np.float32)
    b = rng.standard_normal((2, 4, 3)).astype(np.float32)
    bias = (1 + 2.0 ** -12) * np.ones((2, 1, 3), np.float32)
    with matmul_precision('bfloat16'):
        y = blocks.product(t(a), t(b), t(bias)).double().numpy()
    ra, rb = rounded(a), rounded(b)
    want = bmm(ra, rb) + bias        # a rounded bias would be 2⁻¹² off
    within(y, want, 4 * bmm(np.abs(ra), np.abs(rb)) + np.abs(want))


def test_the_grouped_convolution_is_one_bf16_pass():
    """LeNet's grouped convolution (3 chains, groups of 6 -> 16 channels,
    5 x 5, 14 x 14 inputs): output, input and filter gradients against
    JAX's one-pass convolution and float64 convolutions of the rounded
    operands (K = 6·25, 16·25 and images·10·10)."""
    chains, n = 3, 4
    rng = np.random.default_rng(7)
    h = rng.standard_normal((n, chains * 6, 14, 14)).astype(np.float32)
    w = rng.standard_normal((chains * 16, 6, 5, 5)).astype(np.float32) / 5
    g = rng.standard_normal((n, chains * 16, 10, 10)).astype(np.float32)
    y, dh, dw = one_pass(lambda x, f: blocks.conv(x, f, None, 0, chains),
                         (h, w), g)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(h).astype(jnp.bfloat16),
        jnp.asarray(w).astype(jnp.bfloat16), (1, 1), 'VALID',
        feature_group_count=chains, preferred_element_type=jnp.float32))
    d = lambda a: torch.from_numpy(a)
    rh, rw, rg = d(rounded(h)), d(rounded(w)), d(rounded(g))
    conv = lambda x, f: F.conv2d(x, f, groups=chains).numpy()
    mass = 150 * conv(rh.abs(), rw.abs())
    within(y, ref, mass, 2)
    within(y, conv(rh, rw), mass)
    grad_in = lambda f, z: torch.nn.grad.conv2d_input(
        rh.shape, f, z, groups=chains).numpy()
    grad_w = lambda x, z: torch.nn.grad.conv2d_weight(
        x, rw.shape, z, groups=chains).numpy()
    within(dh, grad_in(rw, rg), 400 * grad_in(rw.abs(), rg.abs()))
    within(dw, grad_w(rh, rg), n * 100 * grad_w(rh.abs(), rg.abs()))


def test_the_attention_products_are_one_bf16_pass():
    """The attention's q·kᵀ on (chains, sequences, heads, T, head_dim)
    tensors (5-D: reshaped to ``bmm`` for the pass; weights·v takes the
    same path) against JAX's one pass, its gradients against float64
    products."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 3, 4, 10, 8)).astype(np.float32)
    kt = rng.standard_normal((2, 3, 4, 8, 10)).astype(np.float32)
    g = rng.standard_normal((2, 3, 4, 10, 10)).astype(np.float32)
    y, dq, dk = one_pass(blocks.product, (q, kt), g)
    ref = np.asarray(jnp.einsum(
        'cnhtd,cnhds->cnhts', jnp.asarray(q).astype(jnp.bfloat16),
        jnp.asarray(kt).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32))
    flat = lambda a: a.reshape(-1, *a.shape[-2:])
    rq, rk, rg = (flat(rounded(a)) for a in (q, kt, g))
    mass = 8 * bmm(np.abs(rq), np.abs(rk)).reshape(y.shape)
    within(y, ref, mass, 2)
    within(y, bmm(rq, rk).reshape(y.shape), mass)
    tr = lambda x: x.transpose(0, 2, 1)
    within(dq, bmm(rg, tr(rk)).reshape(q.shape),
           10 * bmm(np.abs(rg), np.abs(tr(rk))).reshape(q.shape))
    within(dk, bmm(tr(rq), rg).reshape(kt.shape),
           10 * bmm(np.abs(tr(rq)), np.abs(rg)).reshape(kt.shape))


def test_ties_round_to_even():
    """Halfway cases go to the even bfloat16 neighbour, as XLA's convert:
    1 + 2⁻⁸ to 1, 1 + 3·2⁻⁸ to 1 + 2⁻⁶, and their negatives alike; a
    value past the half rounds up."""
    v = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8),
                  -(1 + 3 * 2 ** -8), 1 + 2 ** -8 + 2 ** -20],
                 np.float32).reshape(1, 5, 1)
    with matmul_precision('bfloat16'):
        y = blocks.product(t(v), torch.ones(1, 1, 1)).numpy().ravel()
    want = [1.0, 1 + 2 ** -6, -1.0, -(1 + 2 ** -6), 1 + 2 ** -7]
    np.testing.assert_array_equal(y, np.array(want, np.float32))
    np.testing.assert_array_equal(y, rounded(v).ravel())


def test_nested_scopes_restore_torch_and_cudnn():
    """Each scope sets torch's float32 precision, cuDNN's TF32 off and its
    arithmetic, and puts all three back on exit."""
    prev = torch.get_float32_matmul_precision()
    prev_cudnn = torch.backends.cudnn.allow_tf32
    try:
        torch.set_float32_matmul_precision('medium')
        torch.backends.cudnn.allow_tf32 = True
        with matmul_precision('bfloat16'):
            assert precision.arithmetic() == 'bfloat16'
            assert torch.get_float32_matmul_precision() == 'highest'
            assert torch.backends.cudnn.allow_tf32 is False
            with matmul_precision('tensorfloat32'):
                assert precision.arithmetic() == 'tensorfloat32'
                assert torch.get_float32_matmul_precision() == 'high'
                with matmul_precision('float32'):
                    assert precision.arithmetic() == 'float32'
                    assert torch.get_float32_matmul_precision() == 'highest'
                assert precision.arithmetic() == 'tensorfloat32'
            assert precision.arithmetic() == 'bfloat16'
            assert torch.backends.cudnn.allow_tf32 is False
        assert precision.arithmetic() == 'float32'
        assert torch.get_float32_matmul_precision() == 'medium'
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cudnn.allow_tf32 = prev_cudnn


def test_a_scope_raised_through_is_restored():
    with pytest.raises(RuntimeError):
        with matmul_precision('bfloat16'):
            raise RuntimeError('inside')
    assert precision.arithmetic() == 'float32'
    with pytest.raises(ValueError, match='precision must be one of'):
        with matmul_precision('float16'):
            pass


def test_none_under_both_process_settings(tpu_setting):
    """``None`` is exact float32 by default and the one pass under the TPU
    setting; a named precision never moves."""
    a = np.full((1, 2, 1), 1 + 2 ** -9, np.float32)
    with matmul_precision(None):
        assert precision.arithmetic() == 'bfloat16'
        assert blocks.product(t(a), torch.ones(1, 1, 1))[0, 0, 0] == 1.0
    with matmul_precision('float32'):
        assert blocks.product(t(a), torch.ones(1, 1, 1))[0, 0, 0] == a[0, 0, 0]
    precision.set_none_precision('float32')
    with matmul_precision(None):
        assert precision.arithmetic() == 'float32'
        assert blocks.product(t(a), torch.ones(1, 1, 1))[0, 0, 0] == a[0, 0, 0]
    with pytest.raises(ValueError):
        precision.set_none_precision('float64')


def test_bf16_compute_is_left_as_it_was(tpu_setting):
    """``compute_dtype: bfloat16`` passes bfloat16 operands: the scope
    changes nothing on its path, bit for bit."""
    _, _, bayes = torch_airfoil(hidden=(16, 16, 2))
    bayes.compute_dtype = torch.bfloat16
    x = t(np.random.default_rng(2).standard_normal((40, 5)))
    y = t(np.random.default_rng(3).standard_normal(40))
    theta = t(np.random.default_rng(4).standard_normal((3, bayes.dim)) * 0.3)
    outs = []
    for prec in ('float32', None):
        with matmul_precision(prec):
            v, g = bayes.logdensity_and_grad_fn(x, y)(theta)
        outs.append((v.numpy(), g.numpy()))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _spy(fn, seen):
    def spied(*args, **kwargs):
        seen.append(precision.arithmetic())
        return fn(*args, **kwargs)
    return spied


def test_evaluation_and_nuts_stay_exact(tpu_setting):
    """Under the TPU setting the evaluation's forwards and every
    NUTS/HMC density call run in exact float32, as the JAX package pins
    both; the MCLMC tuner at None runs the one pass."""
    from mile_tpu_torch.config.training import Sampler, SamplerConfig
    from mile_tpu_torch.inference.evaluation import predict_from_flat
    from mile_tpu_torch.train.sampling import warmup_mclmc
    from mile_tpu_torch.train.sampling_hmc import run_hmc_family

    loader, model, bayes = torch_airfoil(hidden=(16, 16, 2))
    x, y = loader.arrays('train')
    theta = torch.randn(2, bayes.dim,
                        generator=torch.Generator().manual_seed(0)) * 0.1
    seen = []
    model.forward = _spy(model.forward, seen)
    predict_from_flat(model, theta, x[:50])
    assert seen and set(seen) == {'float32'}

    seen.clear()
    vg = _spy(bayes.logdensity_and_grad_fn(x, y), seen)
    cfg = SamplerConfig(name=Sampler.NUTS, warmup_steps=3, n_chains=2,
                        n_samples=2, max_num_doublings=2)
    run_hmc_family(vg, cfg, torch.Generator().manual_seed(1), theta)
    assert seen and set(seen) == {'float32'}

    seen.clear()
    cfg = SamplerConfig(warmup_steps=3, n_chains=2, n_samples=2,
                        warmup_matmul_precision=None)
    warmup_mclmc(vg, cfg, torch.Generator().manual_seed(2), theta)
    assert seen and set(seen) == {'bfloat16'}


def _one_pass_dot(a, b):
    """JAX's dot of the TPU's DEFAULT precision on the CPU: bfloat16
    operands, float32 result; its cotangent dots the same way."""
    @jax.custom_vjp
    def dot(a, b):
        return jax.lax.dot_general(
            a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
            (((a.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)

    def fwd(a, b):
        return dot(a, b), (a, b)

    def bwd(res, g):
        a, b = res
        return dot(g, b.T), dot(a.T, g)

    dot.defvjp(fwd, bwd)
    return dot(a, b)


def test_the_posterior_in_both_arithmetics():
    """``BayesianModel.logdensity_and_grad_fn`` at FCN [16, 16, 2] on
    airfoil's 1052 training rows, 3 chains. Exact: against the JAX
    package's posterior with the weights carried by
    ``flat_from_jax_params`` (value rtol 1e-5, gradient rtol 1e-5 with a
    floor of 1e-5 of its largest entry: float32 sums in another order).
    One pass: against a JAX forward written here with one-pass dots
    (value rtol 1e-4, gradient rtol 1e-4 with the same relative floor: a
    bfloat16 rounding of an activation that float32 sums leave on the
    other side of a tie moves it by 2⁻⁸); and its gradient lies away from
    the exact one by more than 50 times that tolerance."""
    from mile_tpu.bayes.posterior import gaussian_loglik

    loader, module, template, jax_bayes = jax_airfoil(hidden=(16, 16, 2))
    t_loader, model, bayes = torch_airfoil(hidden=(16, 16, 2))
    xj, yj = loader.arrays('train')
    x, y = t_loader.arrays('train')
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    params = jax.vmap(lambda k: module.init(k, xj[:1])['params'])(
        jax.random.split(jax.random.PRNGKey(4), 3))
    flat = np.stack([np.asarray(jax_bayes.flatten(
        jax.tree_util.tree_map(lambda a, i=i: a[i], params)))
        for i in range(3)])
    theta = torch.from_numpy(flat_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), model.layout))

    def check(got, want, rtol):
        (v, g), (wv, wg) = got, want
        np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=rtol)
        wg = np.asarray(wg)
        np.testing.assert_allclose(g.numpy(), wg, rtol=rtol,
                                   atol=rtol * np.abs(wg).max())

    exact_ref = jax.vmap(jax.value_and_grad(
        jax_bayes.logdensity_fn(xj, yj)))(jnp.asarray(flat))
    with matmul_precision('float32'):
        exact = bayes.logdensity_and_grad_fn(x, y)(theta)
    check(exact, exact_ref, 1e-5)

    layers = sorted(jax_bayes.unravel(jnp.asarray(flat[0]))['fcn'],
                    key=lambda name: int(name.removeprefix('layer')))

    def one_pass_density(theta):
        p = jax_bayes.unravel(theta)['fcn']
        h = xj
        for i, name in enumerate(layers):
            h = _one_pass_dot(h, p[name]['kernel']) + p[name]['bias']
            if i < len(layers) - 1:
                h = jax.nn.relu(h)
        return (jax_bayes.log_prior(theta)
                + jax_bayes.n_batches * gaussian_loglik(h, yj))

    one_pass_ref = jax.vmap(jax.value_and_grad(one_pass_density))(
        jnp.asarray(flat))
    with matmul_precision('bfloat16'):
        got = bayes.logdensity_and_grad_fn(x, y)(theta)
    check(got, one_pass_ref, 1e-4)
    moved = np.abs(got[1].numpy() - exact[1].numpy()).max()
    assert moved > 50 * 1e-4 * np.abs(exact[1].numpy()).max()
