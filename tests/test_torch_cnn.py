"""The port's LeNet and LeNetti against the Flax modules of the JAX
package: layout, initialization, forward pass, the chunked log-density and
its gradient, an MCLMC trajectory, warm-start steps and the evaluation's
chunk plan."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_parity import one_torch_thread, t  # noqa: F401
from jax.flatten_util import ravel_pytree

from mile_tpu.config.models import Activation as JaxActivation
from mile_tpu.config.models import LeNetConfig as JaxLeNetConfig
from mile_tpu.config.models import LeNettiConfig as JaxLeNettiConfig
from mile_tpu.models import build_model as jax_build_model
from mile_tpu_torch.config.models import Activation, LeNetConfig, LeNettiConfig
from mile_tpu_torch.models import build_model, flat_from_jax_params

CONFIGS = {'LeNet': (JaxLeNetConfig, LeNetConfig),
           'LeNetti': (JaxLeNettiConfig, LeNettiConfig)}
DIMS = {'LeNet': 61_706, 'LeNetti': 7_452}


def pair(name, activation='relu', out_dim=10, image=(1, 28, 28)):
    """(Flax module, port model) of one configuration."""
    jax_cls, cls = CONFIGS[name]
    module = jax_build_model(jax_cls(activation=JaxActivation(activation),
                                     out_dim=out_dim))
    model = build_model(cls(activation=Activation(activation),
                            out_dim=out_dim), image)
    return module, model


def jax_members(module, n, seed=0, image=(1, 28, 28)):
    """``n`` members initialized by the Flax module: (stacked tree, flat
    (n, dim) numpy in the JAX layout)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    tree = jax.vmap(lambda k: module.init(k, jnp.zeros((1, *image)))[
        'params'])(keys)
    flat = jax.vmap(lambda p: ravel_pytree(p)[0])(tree)
    return tree, np.asarray(flat)


def images(n, seed=0, image=(1, 28, 28)):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, size=(n, *image)).astype(np.float32)


@pytest.mark.parametrize('name', ['LeNet', 'LeNetti'])
def test_layout_matches_ravel_pytree(name):
    """Leaf paths, shapes and offsets in ravel_pytree order; the dims are
    61,706 and 7,452 at 28x28; flat_from_jax_params reproduces
    ravel_pytree's vector."""
    module, model = pair(name)
    tree, flat = jax_members(module, 1)
    one = jax.tree.map(lambda a: np.asarray(a[0]), tree)
    paths = ['/'.join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(one)[0]]
    assert [leaf.path for leaf in model.layout.leaves] == paths
    assert model.dim == DIMS[name] == flat.shape[1]
    for leaf, (_, value) in zip(model.layout.leaves,
                                jax.tree_util.tree_flatten_with_path(one)[0]):
        assert leaf.shape == value.shape
    np.testing.assert_array_equal(flat_from_jax_params(one, model.layout),
                                  flat[0])


@pytest.mark.parametrize('name', ['LeNet', 'LeNetti'])
@pytest.mark.parametrize('activation', ['relu', 'sigmoid'])
@pytest.mark.parametrize('shared', [True, False], ids=['shared', 'member'])
def test_forward_matches_flax(name, activation, shared):
    """3 chains of JAX-initialized members on 24 images of 28x28, one batch
    shared by every chain or one per chain: rtol 1e-5, atol 1e-5."""
    module, model = pair(name, activation)
    tree, flat = jax_members(module, 3, seed=1)
    x = images(24 if shared else 3 * 24, seed=2)
    if shared:
        want = jax.vmap(lambda p: module.apply({'params': p}, x))(tree)
        got = model(t(flat), t(x))
    else:
        xs = x.reshape(3, 24, 1, 28, 28)
        want = jax.vmap(lambda p, xb: module.apply({'params': p}, xb))(
            tree, xs)
        got = model(t(flat), t(xs))
    assert got.shape == (3, 24, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_flatten_is_nhwc():
    """The flatten before fc1 is Flax's (h, w, c), not torch's NCHW
    (c, h, w): with only conv2's channel 3 lit (its bias, relu(1) = 1 at
    every position), fc1's input row 3 is lit ((0, 0, 3) in (h, w, c); in
    (c, h, w) it would be channel 0) and row 75 is dark (channel 3 at
    (0, 0) in (c, h, w); channel 11 at (0, 4) in (h, w, c))."""
    _, model = pair('LeNet')

    def output(fc1_row):
        theta = torch.zeros(1, model.dim)
        for path, index in (('conv2/bias', 3), ('fc1/kernel', fc1_row * 120),
                            ('fc2/kernel', 0), ('fc3/kernel', 0)):
            theta[0, model.layout[path].offset + index] = 1.0
        return float(model(theta, torch.zeros(1, 1, 28, 28))[0, 0, 0])

    assert output(3) == 1.0
    assert output(75) == 0.0


@pytest.mark.parametrize('name,fan_ins,n', [
    ('LeNet', {'conv1': 25, 'conv2': 150}, 150),
    ('LeNetti', {'conv1': 9}, 2500)])
def test_conv_init_statistics_match_flax(name, fan_ins, n):
    """Conv kernels are lecun-normal with fan_in = kh*kw*in (25 and 150 for
    LeNet, 9 for LeNetti), as the Flax module's own draws: over at least
    22,500 draws each, variance 1/fan_in within 4 % (4 standard errors or
    more), mean within 4 standard errors of 0, and truncated at 2 standard
    deviations of the underlying normal; biases are zero."""
    module, model = pair(name)
    tree, _ = jax_members(module, n, seed=3)
    flat = model.init(n, torch.Generator().manual_seed(3))
    for conv, fan_in in fan_ins.items():
        k = model.layout[f'{conv}/kernel']
        ours = flat[:, k.offset:k.offset + k.size].double().numpy()
        ref = np.asarray(tree[conv]['kernel'], np.float64)
        bound = 2.0 / 0.87962566103423978 / np.sqrt(fan_in) * (1 + 1e-6)
        for draws in (ours, ref):
            assert draws.var() * fan_in == pytest.approx(1.0, rel=0.04)
            assert abs(draws.mean()) * np.sqrt(fan_in) < 4 / np.sqrt(
                draws.size)
            assert np.abs(draws).max() <= bound
        b = model.layout[f'{conv}/bias']
        assert not flat[:, b.offset:b.offset + b.size].any()


def _bayes_pair(name, chunk, n_images, seed=0):
    from mile_tpu.bayes import BayesianModel as JaxBayes
    from mile_tpu.bayes.priors import Prior as JaxPrior
    from mile_tpu.config.data import Task as JaxTask
    from mile_tpu.config.training import PriorDist as JaxPriorDist
    from mile_tpu_torch.bayes import BayesianModel
    from mile_tpu_torch.bayes.priors import Prior
    from mile_tpu_torch.config.data import Task
    from mile_tpu_torch.config.training import PriorDist

    module, model = pair(name)
    tree, _ = jax_members(module, 1, seed=seed)
    template = jax.tree.map(lambda a: a[0], tree)
    jax_bayes = JaxBayes(module, template,
                         JaxPrior.from_name(JaxPriorDist.STANDARD_NORMAL),
                         JaxTask.CLASSIFICATION, likelihood_chunk_size=chunk)
    bayes = BayesianModel(model, Prior.from_name(PriorDist.STANDARD_NORMAL),
                          Task.CLASSIFICATION, likelihood_chunk_size=chunk)
    rng = np.random.default_rng(seed + 1)
    x = images(n_images, seed=seed + 2)
    y = rng.integers(0, 10, n_images)
    return jax_bayes, bayes, x, y


def test_chunked_logdensity_and_gradient_match_jax():
    """LeNet's log-posterior and its gradient for 3 chains on 40 images in
    chunks of 16 (2 recomputed full chunks and a remainder of 8), against
    the JAX package's BayesianModel with the same chunks: value rtol 1e-5,
    gradient atol 1e-5 * max|g|; unchunked, the port's value agrees to
    rtol 1e-6 and its gradient to atol 1e-4 * max|g|."""
    jax_bayes, bayes, x, y = _bayes_pair('LeNet', 16, 40)
    theta = (np.random.default_rng(5).normal(size=(3, bayes.dim)) * 0.1
             ).astype(np.float32)
    logdensity = jax_bayes.logdensity_fn(jnp.asarray(x),
                                         jnp.asarray(y, jnp.int32))
    want_v, want_g = jax.vmap(jax.value_and_grad(logdensity))(theta)
    vg = bayes.logdensity_and_grad_fn(t(x), torch.from_numpy(y))
    v, g = vg(t(theta))
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), rtol=1e-5)
    scale = float(np.abs(want_g).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-5 * scale)
    bayes.likelihood_chunk_size = None
    v1, g1 = bayes.logdensity_and_grad_fn(t(x), torch.from_numpy(y))(
        t(theta))
    np.testing.assert_allclose(v1.numpy(), v.numpy(), rtol=1e-6)
    # another order of summation over the images: the gradient's entries
    # are sums over 40 images that partly cancel
    np.testing.assert_allclose(g1.numpy(), g.numpy(), rtol=0,
                               atol=1e-4 * scale)


def test_lenetti_mclmc_trajectory_matches_jax():
    """15 MCLMC steps of 3 LeNetti chains on 48 images (chunks of 32 and a
    remainder), with the JAX normals of every refresh injected: positions
    atol 1e-4; ΔE within 4 units of 2^-23 |logp| (|logp| is about 7,300,
    mostly the prior's constant over 7,452 parameters: a unit is 8.7e-4),
    since ΔE is a difference of log-densities each rounded in float32 to
    about that unit."""
    from mile_tpu.mcmc import mclmc as jax_mclmc
    from mile_tpu_torch.mcmc import mclmc

    jax_bayes, bayes, x, y = _bayes_pair('LeNetti', 32, 48)
    logdensity = jax_bayes.logdensity_fn(jnp.asarray(x),
                                         jnp.asarray(y, jnp.int32))
    n_chains, n_steps, dim = 3, 15, bayes.dim
    theta = (np.random.default_rng(0).normal(size=(n_chains, dim)) * 0.3
             ).astype(np.float32)
    step_size = np.array([0.01, 0.02, 0.04], np.float32)
    L = np.array([0.5, 1.0, 2.0], np.float32)

    kernel = jax_mclmc.build_kernel(logdensity, integrator='mclachlan')
    init_keys = jax.random.split(jax.random.PRNGKey(1), n_chains)
    state = jax.vmap(lambda p, k: jax_mclmc.init(p, logdensity, k))(
        theta, init_keys)
    step_keys = jax.random.split(jax.random.PRNGKey(2), n_steps * n_chains
                                 ).reshape(n_steps, n_chains, -1)

    @jax.jit
    def run(state):
        def one(state, keys):
            state, info = jax.vmap(kernel)(keys, state, L, step_size)
            return state, (state.position, info.energy_change)
        return jax.lax.scan(one, state, step_keys)[1]

    ref_x, ref_de = run(state)
    noise = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (dim,))))(
        step_keys)

    vg = bayes.logdensity_and_grad_fn(t(x), torch.from_numpy(y))
    t_kernel = mclmc.build_kernel(vg, torch.Generator().manual_seed(0),
                                  noise=iter(t(z) for z in noise))
    t_state = mclmc.init(t(theta), vg, momentum=t(state.momentum))
    xs, des = [], []
    for _ in range(n_steps):
        t_state, info = t_kernel(t_state, t(L), t(step_size))
        xs.append(t_state.position)
        des.append(info.energy_change)
    np.testing.assert_allclose(torch.stack(xs).numpy(), np.asarray(ref_x),
                               atol=1e-4)
    unit = 2.0 ** -23 * float(np.abs(np.asarray(state.logdensity)).max())
    np.testing.assert_allclose(torch.stack(des).numpy(), np.asarray(ref_de),
                               atol=4 * unit)


def test_lenetti_warmstart_adam_steps_match_optax():
    """Four Adam steps of 3 sigmoid LeNetti members, each on its own
    batches of 16 images (the port's per-member (M, B, 1, 28, 28) input),
    through the warm start's member step, against ``optax.adam`` on the
    same index plan and init: rtol 1e-5, with atol 1e-5 (1e-3 of the
    learning rate). Adam scales each entry's step by its own gradient's
    size, so an entry whose batch gradient nearly cancels carries the
    float32 rounding of its terms into a step of order the learning rate:
    a few fc1 entries part by up to 4e-6 here, and by up to 3e-4 with relu,
    whose dead units leave more such entries."""
    from mile_tpu.config.training import OptimizerConfig as JaxOptimizer
    from mile_tpu.train import warmstart as jax_ws
    from mile_tpu_torch.config.data import Task
    from mile_tpu_torch.config.training import OptimizerConfig
    from mile_tpu_torch.train import warmstart as ws

    adam = {'name': 'adam', 'parameters': {'learning_rate': 0.01}}
    module, model = pair('LeNetti', 'sigmoid')
    tree, init = jax_members(module, 3, seed=4)
    n_members, n_steps, batch, n = 3, 4, 16, 96
    x = images(n, seed=5)
    y = np.random.default_rng(6).integers(0, 10, n)
    rng = np.random.default_rng(7)
    plan = np.stack([rng.permutation(n)[:n_steps * batch].reshape(
        n_steps, batch) for _ in range(n_members)])

    tx = JaxOptimizer.from_dict(adam).build()
    jx, jy = jnp.asarray(x), jnp.asarray(y, jnp.int32)

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
    optimizer = OptimizerConfig.from_dict(adam).build([flat])
    loss_fn, metrics_fn, _ = ws.task_fns(Task.CLASSIFICATION)
    shards = ws.MemberShards(None, n_members, t(x), torch.from_numpy(y),
                             Task.CLASSIFICATION)
    for s in range(n_steps):
        metrics = ws.member_step(model, flat, optimizer, loss_fn, metrics_fn,
                                 shards, torch.from_numpy(plan[:, s]),
                                 np.zeros(n_members, dtype=bool))
    assert set(metrics) == {'cross_entropy', 'accuracy'}
    np.testing.assert_allclose(flat.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('name', ['LeNet', 'LeNetti', 'FCN'])
def test_eval_chunk_plan_is_never_larger_than_jax(name):
    """For the same budget and draw count, the port's (sample, observation)
    chunk is no larger than the JAX package's traced plan, for each model
    and for budgets from one observation's worth up to 4 GiB."""
    from mile_tpu.inference.evaluation import plan_eval_chunks as jax_plan
    from mile_tpu_torch.inference.evaluation import plan_eval_chunks

    if name == 'FCN':
        from mile_tpu.config.models import FCNConfig as JaxFCNConfig
        from mile_tpu_torch.config.models import FCNConfig

        module = jax_build_model(JaxFCNConfig(hidden_structure=[16, 16, 2]))
        model = build_model(FCNConfig(hidden_structure=[16, 16, 2]), 5)
        x = jnp.zeros((3000, 5))
        template = module.init(jax.random.PRNGKey(0), x[:1])['params']
    else:
        module, model = pair(name)
        x = jnp.zeros((3000, 1, 28, 28))
        template = jax.tree.map(lambda a: a[0], jax_members(module, 1)[0])
    flat, unravel = ravel_pytree(template)
    for n_samples in (7, 100, 1000):
        for budget in (10 ** 5, 10 ** 7, 10 ** 9, 4 * 1024 ** 3):
            ours = plan_eval_chunks(model, x.shape[0], n_samples,
                                    memory_budget_bytes=budget)
            ref = jax_plan(module, unravel, flat.size, x, n_samples,
                           memory_budget_bytes=budget)
            assert ours[0] * ours[1] <= ref[0] * ref[1], (n_samples, budget)
            assert ours[0] <= ref[0] and ours[1] <= ref[1]
