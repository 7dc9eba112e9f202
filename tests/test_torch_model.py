"""The port's flat-parameter FCN, prior and posterior against the JAX
package, on the airfoil data."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_airfoil, one_torch_thread, t, torch_airfoil  # noqa: F401
from jax.flatten_util import ravel_pytree

from mile_tpu_torch.models import flat_from_jax_params, jax_leaves_from_flat


@pytest.fixture(scope='module')
def pair():
    loader, module, template, bayes = jax_airfoil()
    t_loader, model, t_bayes = torch_airfoil()
    return dict(loader=loader, module=module, template=template, bayes=bayes,
                t_loader=t_loader, model=model, t_bayes=t_bayes)


def _thetas(n, dim, seed=0, scale=0.3):
    return (np.random.default_rng(seed).normal(size=(n, dim)) * scale
            ).astype(np.float32)


def test_layout_is_ravel_pytree_order(pair):
    model, template = pair['model'], pair['template']
    flat, unravel = ravel_pytree(template)
    assert model.dim == flat.size == 674
    np.testing.assert_array_equal(flat_from_jax_params(
        jax.tree.map(np.asarray, template), model.layout), np.asarray(flat))
    theta = _thetas(1, model.dim)[0]
    for ours, ref in zip(jax_leaves_from_flat(theta, model.layout),
                         jax.tree.leaves(unravel(jnp.asarray(theta)))):
        np.testing.assert_array_equal(ours, np.asarray(ref))
    assert [leaf.path for leaf in model.layout.leaves][:2] == [
        'fcn/layer0/bias', 'fcn/layer0/kernel']


def test_layer_names_sort_as_strings():
    """With more than ten layers ``layer10`` comes before ``layer2``, as
    in ravel_pytree."""
    from mile_tpu.config.models import FCNConfig as JaxFCNConfig
    from mile_tpu.models import build_model as jax_build
    from mile_tpu_torch.config.models import FCNConfig
    from mile_tpu_torch.models import build_model

    hidden = [3] * 11 + [2]
    model = build_model(FCNConfig(hidden_structure=hidden), 4)
    template = jax_build(JaxFCNConfig(hidden_structure=hidden)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4)))['params']
    flat, unravel = ravel_pytree(template)
    paths = [leaf.path for leaf in model.layout.leaves]
    assert paths.index('fcn/layer10/kernel') < paths.index('fcn/layer2/bias')
    theta = _thetas(2, model.dim, seed=3)
    x = np.random.default_rng(4).normal(size=(7, 4)).astype(np.float32)
    ref = jax.vmap(lambda th: jax_build(JaxFCNConfig(
        hidden_structure=hidden)).apply({'params': unravel(th)}, x))(theta)
    np.testing.assert_allclose(model(t(theta), t(x)).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_flat_from_jax_params_keeps_a_member_axis(pair):
    model = pair['model']
    rng = np.random.default_rng(1)
    members = jax.tree.map(lambda a: rng.normal(size=(3, *a.shape)).astype(
        np.float32), pair['template'])
    flat = flat_from_jax_params(jax.tree.map(np.asarray, members),
                                model.layout)
    assert flat.shape == (3, model.dim)
    for i in range(3):
        np.testing.assert_array_equal(flat[i], np.asarray(ravel_pytree(
            jax.tree.map(lambda a: a[i], members))[0]))
    with pytest.raises(ValueError):
        flat_from_jax_params({'fcn': {'layer0': {'bias': np.zeros(3)}}},
                             model.layout)


def test_fcn_forward_matches(pair):
    model, module, template = pair['model'], pair['module'], pair['template']
    _, unravel = ravel_pytree(template)
    x, _ = pair['loader'].arrays('train')
    theta = _thetas(3, model.dim, seed=1)
    ref = jax.vmap(lambda th: module.apply({'params': unravel(th)}, x))(theta)
    out = model(t(theta), t(x))
    assert out.shape == (3, 1052, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('chunk', [None, 200])
def test_logdensity_and_grad_match(pair, chunk):
    """C = 3 chains at once against jax.grad of the JAX posterior:
    value rtol 1e-5, gradient atol 1e-4·max|g|. ``chunk`` runs the
    port's checkpointed likelihood chunks (a remainder chunk included)."""
    x, y = pair['loader'].arrays('train')
    logdensity = pair['bayes'].logdensity_fn(x, y)
    theta = _thetas(3, pair['model'].dim, seed=2)
    ref_v, ref_g = jax.vmap(jax.value_and_grad(logdensity))(theta)
    t_bayes = pair['t_bayes']
    t_bayes.likelihood_chunk_size = chunk
    try:
        tx, ty = pair['t_loader'].arrays('train')
        v, g = t_bayes.logdensity_and_grad_fn(tx, ty)(t(theta))
    finally:
        t_bayes.likelihood_chunk_size = None
    assert v.shape == (3,) and g.shape == (3, 674)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g),
                               atol=1e-4 * float(np.abs(ref_g).max()))


def test_likelihoods_match_with_nans_and_classes():
    from mile_tpu.bayes.posterior import categorical_loglik as jax_cat
    from mile_tpu.bayes.posterior import gaussian_loglik as jax_gauss
    from mile_tpu_torch.bayes.posterior import (
        categorical_loglik,
        gaussian_loglik,
    )

    rng = np.random.default_rng(5)
    lvals = rng.normal(size=(4, 30, 2)).astype(np.float32) * 3
    lvals[0, 0, 1] = 40.0   # sigma clipped from above
    lvals[1, 0, 1] = -40.0  # and from below
    y = rng.normal(size=30).astype(np.float32)
    y[3] = np.nan
    ref = jax.vmap(jax_gauss, in_axes=(0, None))(lvals, y)
    np.testing.assert_allclose(gaussian_loglik(t(lvals), t(y)).numpy(),
                               np.asarray(ref), rtol=1e-5)
    logits = rng.normal(size=(4, 30, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 30)
    ref = jax.vmap(jax_cat, in_axes=(0, None))(logits, labels)
    np.testing.assert_allclose(
        categorical_loglik(t(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize('name,params', [('StandardNormal', {}),
                                         ('Normal', {'loc': 0.5,
                                                     'scale': 2.0}),
                                         ('Laplace', {'scale': 0.7})])
def test_priors_match(name, params):
    from mile_tpu.bayes.priors import Prior as JaxPrior
    from mile_tpu.config.training import PriorDist as JaxDist
    from mile_tpu_torch.bayes.priors import Prior
    from mile_tpu_torch.config.training import PriorDist

    theta = _thetas(3, 50, seed=6, scale=1.5)
    ref = jax.vmap(JaxPrior.from_name(JaxDist(name), **params).log_prior)(
        theta)
    ours = Prior.from_name(PriorDist(name), **params).log_prior(t(theta))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)


def test_bfloat16_forward_stays_close():
    """compute_dtype runs the network in bfloat16 and keeps the
    likelihood float32: about three decimal digits of agreement."""
    loader, model, bayes = torch_airfoil()
    x, y = loader.arrays('train')
    theta = t(_thetas(2, model.dim, seed=8))
    full = bayes.logdensity_fn(x, y)(theta)
    bayes.compute_dtype = torch.bfloat16
    half = bayes.logdensity_fn(x, y)(theta)
    assert half.dtype == torch.float32
    np.testing.assert_allclose(half.numpy(), full.numpy(), rtol=3e-2)


def test_members_initialize_like_flax_dense():
    """Lecun-normal kernels (a normal truncated at two standard deviations,
    rescaled to variance 1/fan_in) and zero biases."""
    from scipy import stats

    _, model, _ = torch_airfoil()
    flat = model.init(400, torch.Generator().manual_seed(0))
    for leaf in model.layout.leaves:
        block = flat[:, leaf.offset:leaf.offset + leaf.size].numpy()
        if leaf.path.endswith('bias'):
            assert not block.any()
            continue
        std = (1.0 / leaf.shape[0]) ** 0.5
        assert abs(block.std() / std - 1.0) < 0.05
        assert np.abs(block).max() <= 2.0 * std / 0.87962566103423978 + 1e-6
    # flax's draws of a (16, 16) kernel and ours: the same distribution
    flax_kernel = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (16, 16 * 400))).ravel()
    leaf = model.layout['fcn/layer1/kernel']
    ours = flat[:, leaf.offset:leaf.offset + leaf.size].numpy().ravel()
    assert stats.ks_2samp(ours, flax_kernel).pvalue > 1e-3


def test_layout_json_names_the_jax_leaves(pair):
    """``layout.json`` (written in place of the pickled treedef) lists the
    JAX leaves' paths and shapes in leaf order."""
    data = pair['model'].layout.to_json()
    paths, leaves = zip(*jax.tree_util.tree_flatten_with_path(
        pair['template'])[0])
    assert data['dim'] == 674
    assert [leaf['path'] for leaf in data['leaves']] == [
        '/'.join(k.key for k in path) for path in paths]
    assert [tuple(leaf['shape']) for leaf in data['leaves']] == [
        tuple(a.shape) for a in leaves]
