"""The port's ensemble warm start and posterior-predictive evaluation
against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_parity import jax_airfoil, one_torch_thread, t, torch_airfoil  # noqa: F401
from jax.flatten_util import ravel_pytree

from mile_tpu.train import warmstart as jax_ws
from mile_tpu_torch.models import flat_from_jax_params
from mile_tpu_torch.train import warmstart as ws

ADAMW = {'name': 'adamw', 'parameters': {
    'learning_rate': 0.01, 'b1': 0.9, 'b2': 0.999, 'weight_decay': 0.001}}


def test_adamw_steps_match_optax():
    """Five AdamW steps of 3 members on the same index plan and init as
    ``optax.adamw``, through the warm start's own member step: rtol 1e-5
    on the parameters, with atol 1e-6 (1e-4 of the learning rate) for the
    entries near zero: each Adam step moves an entry by about lr·m/√v, and
    float32 rounding of a small gradient shifts that ratio."""
    from mile_tpu.config.training import OptimizerConfig as JaxOptimizer
    from mile_tpu_torch.config.training import OptimizerConfig

    loader, module, template, _ = jax_airfoil()
    t_loader, model, _ = torch_airfoil()
    n_members, n_steps, batch = 3, 5, 32
    rng = np.random.default_rng(0)
    init = (rng.normal(size=(n_members, model.dim)) * 0.3).astype(np.float32)
    plan = rng.permuted(np.tile(np.arange(1052), (n_members, 1)), axis=1)[
        :, :n_steps * batch].reshape(n_members, n_steps, batch)

    x, y = loader.arrays('train')
    _, unravel = ravel_pytree(template)
    tx = JaxOptimizer.from_dict(ADAMW).build()

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
    optimizer = OptimizerConfig.from_dict(ADAMW).build([flat])
    loss_fn, metrics_fn, _ = ws.task_fns(t_loader.config.task)
    stopped = np.zeros(n_members, dtype=bool)
    shards = ws.MemberShards(None, n_members, tx_, ty_, t_loader.config.task)
    for s in range(n_steps):
        metrics = ws.member_step(model, flat, optimizer, loss_fn, metrics_fn,
                                 shards, torch.from_numpy(plan[:, s]),
                                 stopped)
    assert set(metrics) == {'nlll', 'rmse'}
    np.testing.assert_allclose(flat.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_earlystop_mask_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(50):
        losses = rng.normal(size=(4, rng.integers(1, 12)))
        losses[:, -3:] += rng.integers(0, 2, size=(4, 1)) * 3.0
        for patience in (None, 1, 3, 5):
            np.testing.assert_array_equal(
                ws.earlystop_mask(losses, patience),
                jax_ws.earlystop_mask(losses, patience))


def test_stopped_members_keep_parameters_and_optimizer_state():
    _, model, _ = torch_airfoil()
    loader = torch_airfoil()[0]
    x, y = loader.arrays('train')
    flat = model.init(3, torch.Generator().manual_seed(0)).requires_grad_(True)
    optimizer = torch.optim.AdamW([flat], lr=0.01)
    loss_fn, metrics_fn, _ = ws.task_fns(loader.config.task)
    rows = torch.arange(96).reshape(3, 32)
    none = np.zeros(3, dtype=bool)
    shards = ws.MemberShards(None, 3, x, y, loader.config.task)
    ws.member_step(model, flat, optimizer, loss_fn, metrics_fn, shards, rows,
                   none)
    before = flat.detach().clone()
    state = {k: v.clone() for k, v in optimizer.state[flat].items()
             if torch.is_tensor(v) and v.shape == flat.shape}
    m = ws.member_step(model, flat, optimizer, loss_fn, metrics_fn, shards,
                       rows, np.array([False, True, False]))
    assert torch.equal(flat[1], before[1])
    assert not torch.equal(flat[0], before[0])
    for k, v in state.items():
        assert torch.equal(optimizer.state[flat][k][1], v[1])
        assert not torch.equal(optimizer.state[flat][k][0], v[0])
    assert torch.isnan(m['nlll'][1]) and torch.isfinite(m['nlll'][0])


def test_train_ensemble_stops_early_and_records_metrics():
    from mile_tpu_torch.config.training import WarmstartConfig

    loader, model, _ = torch_airfoil()
    cfg = WarmstartConfig.from_dict({'optimizer_config': ADAMW,
                                     'max_epochs': 40, 'batch_size': 256,
                                     'patience': 1})
    params, store = ws.train_ensemble(model, loader, cfg,
                                      loader.config.task, 2,
                                      torch.Generator().manual_seed(0))
    n_epochs = store.valid.nlll.shape[1]
    assert params.shape == (2, 674) and not params.requires_grad
    assert n_epochs < 40   # patience 1 stops both members early
    assert store.train.nlll.shape == (2, 4 * n_epochs)
    assert store.test.rmse.shape == (2, 1)
    assert np.isfinite(store.test.rmse).all()
    assert store.valid.nlll[:, 0].mean() > np.nanmin(store.valid.nlll)


@pytest.fixture(scope='module')
def jax_posterior():
    """Members initialized by the JAX package's module, and 24 draws per
    chain scattered around them by ``jax.random``: the evaluation needs
    only arrays in the JAX layout, and a JAX sampling run would spend most
    of this file's time compiling."""
    loader, module, template, bayes = jax_airfoil()
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    members = jax.vmap(lambda k: module.init(k, jnp.zeros((1, 5)))[
        'params'])(keys[:3])
    flat = jax.vmap(bayes.flatten)(members)
    samples = flat[:, None] + 0.05 * jax.random.normal(
        keys[3], (3, 24, bayes.dim))
    return loader, module, bayes, members, np.asarray(samples)


def test_evaluation_matches_jax(jax_posterior):
    """evaluate_de / evaluate_bde of the port on the JAX package's members
    and draws: lppd, nll, rmse, de_lppd, de_rmse and the function-space
    diagnostics to rtol 1e-5; coverages finite (the two packages draw the
    predictive samples from different generators)."""
    from mile_tpu.inference.evaluation import evaluate_bde as jax_bde
    from mile_tpu.inference.evaluation import evaluate_de as jax_de
    from mile_tpu_torch.inference.evaluation import evaluate_bde, evaluate_de

    loader, module, bayes, members, samples = jax_posterior
    t_loader, model, _ = torch_airfoil()
    x, y = loader.arrays('test')
    tx, ty = t_loader.arrays('test')
    nominal = [0.5, 0.75, 0.9, 0.95]
    _, ref = jax_de(module, members, x, y, loader.config.task, n_samples=20,
                    nominal_coverages=nominal)
    _, ref = jax_bde(module, bayes.unravel, jnp.asarray(samples), x, y,
                     loader.config.task, nominal_coverages=nominal,
                     metrics_dict=ref)
    flat_members = t(flat_from_jax_params(jax.tree.map(np.asarray, members),
                                          model.layout))
    _, ours = evaluate_de(model, flat_members, tx, ty, t_loader.config.task,
                          n_samples=20, nominal_coverages=nominal)
    preds, ours = evaluate_bde(model, t(samples), tx, ty,
                               t_loader.config.task,
                               nominal_coverages=nominal, metrics_dict=ours)
    assert preds.shape == (3, 24, 301, 2)
    for key in ('lppd', 'nll', 'rmse', 'de_lppd', 'de_rmse',
                'fs_split_rhat', 'fs_ess', 'fs_ess_per_chain'):
        assert ours[key] == pytest.approx(ref[key], rel=1e-5), key
    np.testing.assert_allclose(ours['lppd_per_chain'], ref['lppd_per_chain'],
                               rtol=1e-5)
    np.testing.assert_allclose(ours['running_lppd'], ref['running_lppd'],
                               rtol=1e-5, atol=1e-6)
    for prefix in ('', 'de_'):
        assert np.isfinite(ours[f'{prefix}cal_error'])
        for c in nominal:
            assert 0.0 <= ours[f'{prefix}coverage_{c}'] <= 1.0


def test_evaluation_excludes_nan_chains_and_chunks(jax_posterior):
    """A chain of NaN draws is left out of the pooled metrics, and a tiny
    memory budget (many chunks) changes nothing."""
    from mile_tpu_torch.inference.evaluation import evaluate_bde

    _, _, _, _, samples = jax_posterior
    t_loader, model, _ = torch_airfoil()
    tx, ty = t_loader.arrays('test')
    task = t_loader.config.task
    _, clean = evaluate_bde(model, t(samples[:2]), tx, ty, task)
    bad = samples.copy()
    bad[2] = np.nan
    _, out = evaluate_bde(model, t(bad), tx, ty, task,
                          memory_budget_bytes=50_000)
    assert out['lppd'] == pytest.approx(clean['lppd'], rel=1e-6)
    assert out['rmse'] == pytest.approx(clean['rmse'], rel=1e-6)
    assert np.isnan(out['lppd_per_chain'][2])
