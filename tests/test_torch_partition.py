"""The port's partition and frozen sampling against the JAX package's: layer
groups, masks and labels (at 4 and 12 layers, where layer names sort as
strings), split and merge, the partitioned log-density and its gradient,
the partition warm start, one partitioned MCLMC step, and the trainer on
the partition configs with MCLMC, NUTS and HMC and with ``params_frozen``.

Tolerances: masks, groups, labels, split and merge exact; the partitioned
value and gradient rtol 1e-5 (atol 1e-4 on the gradient, whose entries
reach 1e3); five partition warm-start steps rtol 1e-5 with atol 1e-6 (the
full warm start's tolerance), the hidden coordinates bit for bit; a
partitioned MCLMC step with the JAX normals injected atol 1e-5 on the
positions; every hidden coordinate of every draw bit for bit.
"""
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from _torch_parity import jax_airfoil, one_torch_thread, t, torch_airfoil  # noqa: F401
from jax.flatten_util import ravel_pytree

from mile_tpu.bayes import partition as jax_part
from mile_tpu.mcmc import mclmc as jax_mclmc
from mile_tpu.train import checkpoint as jax_ckpt
from mile_tpu.train import warmstart as jax_ws
from mile_tpu_torch.bayes import partition as part
from mile_tpu_torch.bayes.posterior import value_and_grad
from mile_tpu_torch.mcmc import mclmc
from mile_tpu_torch.models import flat_from_jax_params
from mile_tpu_torch.train import warmstart as ws

ROOT = Path(__file__).resolve().parents[1]
HIDDEN = {4: (16, 16, 16, 2), 12: (4,) * 11 + (2,)}


def fcn_pair(n_layers):
    """(JAX template params, port model) of an FCN on 5 features."""
    from mile_tpu.config.models import FCNConfig as JaxFCN
    from mile_tpu.models import build_model as jax_build
    from mile_tpu_torch.config.models import FCNConfig
    from mile_tpu_torch.models import build_model

    hidden = list(HIDDEN[n_layers])
    template = jax_build(JaxFCN(hidden_structure=hidden)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5)))['params']
    return template, build_model(FCNConfig(hidden_structure=hidden), (5,))


@pytest.mark.parametrize('n_layers', [4, 12])
def test_layer_groups_match_jax(n_layers):
    template, model = fcn_pair(n_layers)
    groups = part.layer_groups(model.layout)
    assert groups == jax_part.layer_groups(template)
    if n_layers == 12:   # flat order sorts the names as strings
        assert [g[0] for g in groups[:4]] == [
            'fcn/layer0', 'fcn/layer1', 'fcn/layer10', 'fcn/layer11']
        assert groups[-1][0] == 'fcn/layer9'


@pytest.mark.parametrize('n_layers', [4, 12])
def test_partition_mask_matches_jax(n_layers):
    """The first and last group in flat order: at 12 layers that is
    ``layer9``, not the output layer ``layer11`` (the JAX package's
    behaviour, kept)."""
    template, model = fcn_pair(n_layers)
    mask = part.partition_mask(model.layout)
    np.testing.assert_array_equal(
        mask, jax_part.partition_mask(template, model.dim))
    groups = dict((g[0], g[1:]) for g in part.layer_groups(model.layout))
    last = 'fcn/layer9' if n_layers == 12 else 'fcn/layer3'
    start, end = groups[last]
    assert mask[start:end].all()
    if n_layers == 12:
        start, end = groups['fcn/layer11']
        assert not mask[start:end].any()


@pytest.mark.parametrize('n_layers,names', [
    (4, ['layer1']), (12, ['layer1']), (12, ['layer3', 'layer7'])])
def test_frozen_mask_matches_jax(n_layers, names):
    """Names match groups by substring: at 12 layers ``layer1`` freezes
    ``layer10`` and ``layer11`` too (the JAX package's behaviour, kept)."""
    template, model = fcn_pair(n_layers)
    mask = part.frozen_mask(model.layout, names)
    np.testing.assert_array_equal(
        mask, jax_part.frozen_mask(template, model.dim, names))
    frozen = {g[0] for g in part.layer_groups(model.layout)
              if not mask[g[1]:g[2]].any()}
    if n_layers == 12 and names == ['layer1']:
        assert frozen == {'fcn/layer1', 'fcn/layer10', 'fcn/layer11'}


def test_frozen_mask_raises_when_no_name_matches():
    template, model = fcn_pair(4)
    with pytest.raises(ValueError) as ours:
        part.frozen_mask(model.layout, ['conv'])
    with pytest.raises(ValueError) as want:
        jax_part.frozen_mask(template, model.dim, ['conv'])
    assert str(ours.value) == str(want.value)


@pytest.mark.parametrize('n_layers', [4, 12])
def test_partition_labels_match_jax(n_layers):
    template, model = fcn_pair(n_layers)
    labels = jax_part.partition_labels(template)
    want = {'/'.join(k.key for k in path): label for path, label in
            jax.tree_util.tree_flatten_with_path(labels)[0]}
    assert part.partition_labels(model.layout) == want


def test_split_and_merge_match_jax():
    rng = np.random.default_rng(0)
    mask = rng.random(40) < 0.3
    theta = rng.normal(size=(3, 40)).astype(np.float32)
    z = rng.normal(size=(3, 5, int(mask.sum()))).astype(np.float32)
    want = np.asarray(jax_part.split(jnp.asarray(theta), mask))
    np.testing.assert_array_equal(part.split(theta, mask), want)
    np.testing.assert_array_equal(part.split(t(theta), mask).numpy(), want)
    merged = part.merge(theta, z, mask)
    np.testing.assert_array_equal(merged, jax_part.merge(theta, z, mask))
    assert merged.shape == (3, 5, 40)
    np.testing.assert_array_equal(merged[:, :, ~mask],
                                  np.broadcast_to(theta[:, None, ~mask],
                                                  (3, 5, int((~mask).sum()))))


def test_partitioned_value_and_grad_match_jax():
    """The airfoil posterior of 3 chains, each with its own frozen base:
    value and gradient with respect to z against ``jax.value_and_grad`` of
    ``make_partitioned_logdensity``; the base gets no gradient."""
    loader, _, template, bayes = jax_airfoil()
    t_loader, model, t_bayes = torch_airfoil()
    mask = part.partition_mask(model.layout)
    rng = np.random.default_rng(1)
    base = (rng.normal(size=(3, model.dim)) * 0.3).astype(np.float32)
    z = (rng.normal(size=(3, int(mask.sum()))) * 0.3).astype(np.float32)

    x, y = loader.arrays('train')
    pld = jax_part.make_partitioned_logdensity(bayes.logdensity_fn(x, y),
                                               mask)
    want_v, want_g = jax.vmap(jax.value_and_grad(pld))(z, base)

    tx, ty = t_loader.arrays('train')
    t_base = t(base).requires_grad_(True)
    v, g = value_and_grad(part.make_partitioned_logdensity(
        t_bayes.logdensity_fn(tx, ty), mask, t_base))(t(z))
    assert g.shape == z.shape and t_base.grad is None
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-4)
    # the full gradient at the sampled coordinates
    full = t_bayes.logdensity_and_grad_fn(tx, ty)(
        t(jax_part.merge(base, z[:, None], mask)[:, 0]))[1]
    np.testing.assert_allclose(g.numpy(), full[:, mask].numpy(), rtol=1e-6,
                               atol=1e-6)


def test_partition_warmstart_matches_jax():
    """Five partition warm-start steps of 3 members on the same index plan
    and init as the JAX package's ``partition_optimizer`` (AdamW with
    weight decay under ``optax.multi_transform``): the hidden coordinates
    stay at their initial values bit for bit in both, the others agree."""
    from mile_tpu.config.training import OptimizerConfig as JaxOptimizer
    from mile_tpu_torch.config.training import OptimizerConfig

    adamw = {'name': 'adamw', 'parameters': {
        'learning_rate': 0.01, 'b1': 0.9, 'b2': 0.999,
        'weight_decay': 0.001}}
    loader, module, template, _ = jax_airfoil()
    t_loader, model, _ = torch_airfoil()
    n_members, n_steps, batch = 3, 5, 32
    rng = np.random.default_rng(0)
    init = (rng.normal(size=(n_members, model.dim)) * 0.3).astype(np.float32)
    plan = rng.permuted(np.tile(np.arange(1052), (n_members, 1)), axis=1)[
        :, :n_steps * batch].reshape(n_members, n_steps, batch)

    x, y = loader.arrays('train')
    _, unravel = ravel_pytree(template)
    tx = jax_part.partition_optimizer(
        JaxOptimizer.from_dict(adamw).build(), template)

    def member_step(p, opt, rows):
        def lf(p):
            return jax_ws._regr_loss(module.apply({'params': p}, x[rows]),
                                     y[rows])
        updates, opt = tx.update(jax.grad(lf)(p), opt, p)
        return optax.apply_updates(p, updates), opt

    params = jax.vmap(unravel)(init)
    opt = jax.vmap(tx.init)(params)
    step = jax.jit(jax.vmap(member_step))
    for s in range(n_steps):
        params, opt = step(params, opt, plan[:, s])
    want = flat_from_jax_params(jax.tree.map(np.asarray, params),
                                model.layout)

    tx_, ty_ = t_loader.arrays('train')
    flat = t(init).requires_grad_(True)
    optimizer = OptimizerConfig.from_dict(adamw).build([flat])
    loss_fn, metrics_fn, _ = ws.task_fns(t_loader.config.task)
    hidden = ~part.partition_mask(model.layout)
    frozen = torch.as_tensor(np.nonzero(hidden)[0])
    shards = ws.MemberShards(None, n_members, tx_, ty_,
                             t_loader.config.task)
    for s in range(n_steps):
        ws.member_step(model, flat, optimizer, loss_fn, metrics_fn, shards,
                       torch.from_numpy(plan[:, s]),
                       np.zeros(n_members, dtype=bool), frozen)
    ours = flat.detach().numpy()
    np.testing.assert_array_equal(ours[:, hidden], init[:, hidden])
    np.testing.assert_array_equal(want[:, hidden], init[:, hidden])
    assert np.abs(ours[:, ~hidden] - init[:, ~hidden]).max() > 1e-3
    np.testing.assert_allclose(ours, want, rtol=1e-5, atol=1e-6)
    # the moments of the hidden coordinates were never touched
    state = optimizer.state[flat]
    assert float(state['exp_avg'][:, frozen].abs().max()) == 0.0


def test_partitioned_mclmc_step_matches_jax():
    """Three partitioned MCLMC steps of 3 chains, each chain with its own
    base, against the vmapped JAX kernel on the partitioned density, with
    the JAX normals injected."""
    loader, _, template, bayes = jax_airfoil()
    t_loader, model, t_bayes = torch_airfoil()
    mask = part.partition_mask(model.layout)
    d = int(mask.sum())
    rng = np.random.default_rng(2)
    base = (rng.normal(size=(3, model.dim)) * 0.3).astype(np.float32)
    z0 = base[:, mask]
    step_size = np.array([0.002, 0.004, 0.006], np.float32)
    L = np.array([0.05, 0.1, 0.2], np.float32)
    n_steps = 3

    x, y = loader.arrays('train')
    pld = jax_part.make_partitioned_logdensity(bayes.logdensity_fn(x, y),
                                               mask)
    state = jax.vmap(lambda p, k, b: jax_mclmc.init(
        p, lambda q: pld(q, b), k))(
        z0, jax.random.split(jax.random.PRNGKey(1), 3), base)
    keys = jax.random.split(jax.random.PRNGKey(2), n_steps * 3).reshape(
        n_steps, 3, -1)

    def one(key, state, L, eps, b):
        kernel = jax_mclmc.build_kernel(lambda q: pld(q, b),
                                        integrator='mclachlan')
        return kernel(key, state, L, eps)

    step = jax.jit(jax.vmap(one))
    ref = []
    for s in range(n_steps):
        state_next, _ = step(keys[s], state, L, step_size, base)
        ref.append(np.asarray(state_next.position))
        state = state_next
    noise = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (d,))))(keys)

    tx, ty = t_loader.arrays('train')
    vg = value_and_grad(part.make_partitioned_logdensity(
        t_bayes.logdensity_fn(tx, ty), mask, t(base)))
    kernel = mclmc.build_kernel(vg, torch.Generator().manual_seed(0),
                                noise=iter(t(n) for n in noise))
    first = jax.vmap(lambda p, k, b: jax_mclmc.init(
        p, lambda q: pld(q, b), k))(
        z0, jax.random.split(jax.random.PRNGKey(1), 3), base)
    t_state = mclmc.init(t(z0), vg, momentum=t(first.momentum))
    for s in range(n_steps):
        t_state, _ = kernel(t_state, t(L), t(step_size))
        np.testing.assert_allclose(t_state.position.numpy(), ref[s],
                                   atol=1e-5)


RUNS = {
    'mclmc': ('ablations/partition_airfoil.yaml',
              dict(warmup_steps=50, n_samples=40, n_thinning=4)),
    'nuts': ('replicate_uci/partition_nuts.yaml',
             dict(warmup_steps=10, n_samples=4, max_num_doublings=4)),
    'hmc': ('replicate_uci/partition_nuts.yaml',
            dict(name='hmc', warmup_steps=10, n_samples=4)),
    'frozen': ('ablations/partition_airfoil.yaml',
               dict(warmup_steps=50, n_samples=40, n_thinning=4,
                    partition_sampling=False, params_frozen=['layer1'])),
}


@pytest.fixture(scope='module', params=list(RUNS))
def partition_run(request, tmp_path_factory):
    """``BDETrainer`` on a partition config with 2 chains and the step
    counts cut (3 warm-start epochs; NUTS at depth 4), its three phases
    called one by one."""
    from mile_tpu_torch.config import Config
    from mile_tpu_torch.train.trainer import BDETrainer

    config, sampler = RUNS[request.param]
    with open(ROOT / 'configs' / config) as f:
        cfg = yaml.safe_load(f)
    cfg['saving_dir'] = str(tmp_path_factory.mktemp(request.param))
    cfg['training']['warmstart'].update(max_epochs=3)
    cfg['training']['sampler'].update(n_chains=2, **sampler)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = BDETrainer(Config.from_dict(cfg), device='cpu')
        members = trainer.train_warmstart()
        result = trainer.start_sampling(members)
        metrics = trainer.evaluate(members, result)
    finally:
        torch.set_num_threads(prev)
    return request.param, trainer, members.numpy(), result, metrics


def test_partition_draws_are_full_dim_with_members_frozen(partition_run):
    name, trainer, members, result, _ = partition_run
    mask = trainer.sampled_mask()
    n_kept = result.samples.shape[1]
    assert result.samples.shape == (2, n_kept, trainer.bayes.dim)
    hidden = ~mask
    np.testing.assert_array_equal(
        result.samples[:, :, hidden],
        np.broadcast_to(members[:, None, hidden],
                        (2, n_kept, int(hidden.sum()))))
    assert not np.array_equal(result.samples[:, 0, mask],
                              result.samples[:, -1, mask])
    if name == 'frozen':
        groups = {g[0]: g[1:] for g in part.layer_groups(trainer.model.layout)}
        start, end = groups['fcn/layer1']
        assert not mask[start:end].any() and mask.sum() == 674 - 272
    else:
        # the partition warm start left the hidden coordinates at init
        from mile_tpu_torch.utils.keys import experiment_keys

        init = trainer.model.init(
            2, experiment_keys(trainer.config.rng).train).numpy()
        np.testing.assert_array_equal(members[:, hidden], init[:, hidden])


def test_partition_draws_reach_the_jax_package(partition_run):
    """``samples.npy`` (no native sink in partition mode) in the JAX
    layout, which ``mile_tpu``'s ``load_flat_samples`` reads."""
    _, trainer, _, result, _ = partition_run
    assert (trainer.samples_dir / 'chain_1' / 'samples.npy').is_file()
    assert not list(trainer.samples_dir.rglob('samples.bin'))
    np.testing.assert_array_equal(
        jax_ckpt.load_flat_samples(trainer.samples_dir), result.samples)


def test_partition_tuning_runs_in_the_subspace(partition_run):
    """The tuned values and the per-draw statistics keep the subspace's
    width, as in the JAX package; the metrics are finite."""
    name, trainer, _, result, metrics = partition_run
    d = int(trainer.sampled_mask().sum())
    with open(trainer.samples_dir / 'info.pkl', 'rb') as f:
        info = pickle.load(f)
    key = 'sqrt_diag_cov' if name in ('mclmc', 'frozen') \
        else 'inverse_mass_matrix'
    assert info[key].shape == (2, d)
    assert result.final_state.position.shape == (2, d)
    for k in ('lppd', 'rmse', 'de_lppd', 'cal_error'):
        assert np.isfinite(metrics[k]), k
