"""The port's symmetric-split HMC against ``mile_tpu/mcmc/split_hmc.py`` and
``BayesianModel.shard_potential_fn``, its integrator's properties, and its
script ``experiments/torch_symmetric_splitting.py`` end to end.

The JAX kernel draws from threefry keys, so the tests replay its key split
(``split_hmc.py:117``: the momentum normals, then one uniform) and feed the
numbers to the port through its ``draws=`` source. Tolerances (float32 on
both sides, sums in another order): shard potentials rtol 1e-5; an
integrator or kernel step's end point within 1e-4 of the largest change a
coordinate made (the 8 shard gradients of a step partly cancel), the
energies rtol 1e-5, the accept decisions equal.
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_airfoil, one_torch_thread, t, torch_airfoil  # noqa: F401

from mile_tpu.mcmc import split_hmc as jax_split
from mile_tpu_torch.mcmc import split_hmc

ROOT = Path(__file__).resolve().parents[1]
DIM = 3
N_OBS = 64
M_SHARDS = 4
SIGMA = 0.5
STEP_RTOL = 1e-4


class ReplayDraws:
    """A ``draws=`` source handing out given arrays in call order."""

    def __init__(self, calls):
        self.calls = list(calls)

    def _next(self, kind, shape):
        want_kind, value = self.calls.pop(0)
        assert want_kind == kind and tuple(value.shape) == tuple(shape)
        return t(value)

    def normal(self, shape):
        return self._next('normal', shape)

    def uniform(self, shape):
        return self._next('uniform', shape)


def jax_step_draws(key, dim):
    """The numbers one JAX split-HMC step draws from ``key``, for one
    chain."""
    key_mom, key_acc = jax.random.split(key)
    return ReplayDraws([
        ('normal', np.asarray(jax.random.normal(key_mom, (dim,)))[None]),
        ('uniform', np.asarray(jax.random.uniform(key_acc))[None])])


def conjugate(seed=0):
    """y_i ~ N(theta, SIGMA^2 I), theta ~ N(0, I), in M_SHARDS shards: the
    JAX shard potential, the port's (batched over chains), the posterior
    mean and variance."""
    rng = np.random.default_rng(seed)
    theta_true = rng.normal(size=DIM)
    y = theta_true + SIGMA * rng.normal(size=(N_OBS, DIM))
    shards = y.reshape(M_SHARDS, N_OBS // M_SHARDS, DIM).astype(np.float32)
    jshards, tshards = jnp.asarray(shards), t(shards)

    def jax_potential(theta, j):
        ys = jax.lax.dynamic_index_in_dim(jshards, j, keepdims=False)
        loglik = -0.5 * jnp.sum((ys - theta) ** 2) / SIGMA**2
        return -(loglik - 0.5 * jnp.sum(theta**2) / M_SHARDS)

    def potential(theta, j):                 # (C, DIM) -> (C,)
        diff = tshards[j][None] - theta[:, None]
        loglik = -0.5 * torch.sum(diff * diff, dim=(1, 2)) / SIGMA**2
        return -(loglik - 0.5 * torch.sum(theta**2, dim=1) / M_SHARDS)

    precision = 1.0 + N_OBS / SIGMA**2
    post_mean = (y.sum(axis=0) / SIGMA**2) / precision
    return jax_potential, potential, post_mean, 1.0 / precision


def airfoil_shards(n_shards=4, batch=64, hidden=(8, 2)):
    """(JAX shard potential, the port's, dim) on the airfoil posterior's
    first ``n_shards * batch`` training rows."""
    loader, _, _, jax_bayes = jax_airfoil(hidden=hidden)
    t_loader, _, bayes = torch_airfoil(hidden=hidden)
    x, y = loader.arrays('train')
    tx, ty = t_loader.arrays('train')
    n = n_shards * batch
    jax_fn = jax_bayes.shard_potential_fn(
        x[:n].reshape(n_shards, batch, -1), y[:n].reshape(n_shards, batch))
    fn = bayes.shard_potential_fn(tx[:n].reshape(n_shards, batch, -1),
                                  ty[:n].reshape(n_shards, batch))
    return jax_fn, fn, bayes.dim


def close_step(ours, want, start):
    """End points within STEP_RTOL of the largest change."""
    change = np.abs(np.asarray(want) - np.asarray(start)).max()
    assert change > 0
    err = np.abs(np.asarray(ours) - np.asarray(want)).max()
    assert err <= STEP_RTOL * change, (err, change)


def test_state_and_info_match_jax():
    assert split_hmc.SplitHMCState._fields == jax_split.SplitHMCState._fields
    assert split_hmc.SplitHMCInfo._fields == jax_split.SplitHMCInfo._fields
    assert split_hmc.DIVERGENCE_THRESHOLD == jax_split.DIVERGENCE_THRESHOLD


@pytest.mark.parametrize('model', ['FCN', 'LeNet'])
def test_shard_potential_matches_jax(model):
    """``shard_potential_fn`` for one chain and for a batch of 3, every
    shard, against the JAX package's (FCN on airfoil rows; LeNet on 3
    shards of 8 images), and their sum against ``-log_posterior``."""
    if model == 'FCN':
        jax_fn, fn, dim = airfoil_shards()
        n_shards = 4
        theta = (np.random.default_rng(1).normal(size=(3, dim)) * 0.3
                 ).astype(np.float32)
    else:
        from test_torch_cnn import _bayes_pair, images

        jax_bayes, bayes, _, _ = _bayes_pair('LeNet', None, 1)
        x = images(24, seed=7).reshape(3, 8, 1, 28, 28)
        y = np.random.default_rng(8).integers(0, 10, (3, 8))
        jax_fn = jax_bayes.shard_potential_fn(jnp.asarray(x),
                                              jnp.asarray(y, jnp.int32))
        fn = bayes.shard_potential_fn(t(x), torch.from_numpy(y))
        n_shards, dim = 3, bayes.dim
        theta = (np.random.default_rng(9).normal(size=(3, dim)) * 0.1
                 ).astype(np.float32)
    for j in range(n_shards):
        want = np.asarray(jax.vmap(lambda q: jax_fn(q, j))(theta))
        np.testing.assert_allclose(fn(t(theta), j).numpy(), want, rtol=1e-5)
        np.testing.assert_allclose(float(fn(t(theta[0]), j)), want[0],
                                   rtol=1e-5)
    total = jax_split._full_potential(jax_fn, n_shards, jnp.asarray(theta[1]))
    ours = split_hmc._full_potential(fn, n_shards, t(theta))
    np.testing.assert_allclose(float(ours[1]), float(total), rtol=1e-5)


def test_full_potential_matches_jax_and_the_direct_sum():
    jax_potential, potential, _, _ = conjugate()
    theta = np.arange(DIM, dtype=np.float32)[None] * 0.3
    want = jax_split.init(jnp.asarray(theta[0]), jax_potential, M_SHARDS)
    state = split_hmc.init(t(theta), potential, M_SHARDS)
    direct = sum(float(potential(t(theta), j)) for j in range(M_SHARDS))
    np.testing.assert_allclose(float(state.potential[0]),
                               float(want.potential), rtol=1e-6)
    np.testing.assert_allclose(float(state.potential[0]), direct, rtol=1e-6)


def test_integrator_step_matches_jax():
    """One split-leapfrog step (8 shard gradients) on the airfoil FCN
    posterior, from the same theta and p."""
    jax_fn, fn, dim = airfoil_shards()
    rng = np.random.default_rng(2)
    theta = (rng.normal(size=dim) * 0.3).astype(np.float32)
    p = rng.normal(size=dim).astype(np.float32)
    imm = rng.uniform(0.5, 1.5, size=dim).astype(np.float32)
    want = jax.jit(jax_split.build_integrator(jax_fn, 4))(
        theta, p, jnp.float32(1e-3), imm)
    ours = split_hmc.build_integrator(fn, 4)(t(theta)[None], t(p)[None],
                                             1e-3, t(imm))
    close_step(ours[0][0].numpy(), want[0], theta)
    close_step(ours[1][0].numpy(), want[1], p)


@pytest.mark.parametrize('step_size,accepted', [(2e-4, True), (0.3, False)])
def test_kernel_step_matches_jax(step_size, accepted):
    """One kernel step (5 leapfrog steps) on the airfoil FCN posterior
    with the JAX draws injected: the accept decision, the acceptance rate,
    the energy and the new state. The large step is rejected (or diverges)
    in both."""
    jax_fn, fn, dim = airfoil_shards()
    rng = np.random.default_rng(4)
    theta = (rng.normal(size=dim) * 0.3).astype(np.float32)
    imm = np.full(dim, 1.0, np.float32)
    key = jax.random.PRNGKey(6)
    kernel = jax_split.build_kernel(jax_fn, 4, num_integration_steps=5)
    want_state, want = jax.jit(kernel)(
        key, jax_split.init(jnp.asarray(theta), jax_fn, 4),
        jnp.float32(step_size), imm)
    ours_state, ours = split_hmc.build_kernel(
        fn, 4, num_integration_steps=5, draws=jax_step_draws(key, dim))(
        split_hmc.init(t(theta)[None], fn, 4), step_size, t(imm))
    assert bool(want.is_accepted) is accepted
    assert bool(ours.is_accepted[0]) is accepted
    assert bool(ours.is_divergent[0]) == bool(want.is_divergent)
    assert int(ours.num_integration_steps[0]) == 5
    np.testing.assert_allclose(float(ours.acceptance_rate[0]),
                               float(want.acceptance_rate), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(float(ours.energy[0]), float(want.energy),
                               rtol=1e-5)
    if accepted:
        close_step(ours_state.position[0].numpy(), want_state.position,
                   theta)
    else:
        np.testing.assert_array_equal(ours_state.position[0].numpy(), theta)
    np.testing.assert_allclose(float(ours_state.potential[0]),
                               float(want_state.potential), rtol=1e-5)


def test_nan_proposal_is_rejected():
    """A proposal whose potential is NaN is a rejection: the state stays,
    the acceptance rate is 0."""
    _, potential, _, _ = conjugate()

    def nan_far_away(theta, j):
        u = potential(theta, j)
        return torch.where(theta.abs().amax(dim=1) > 1e-3,
                           torch.full_like(u, float('nan')), u)

    kernel = split_hmc.build_kernel(nan_far_away, M_SHARDS, 2,
                                    generator=torch.Generator().manual_seed(0))
    start = split_hmc.init(torch.zeros(2, DIM), nan_far_away, M_SHARDS)
    state, info = kernel(start, 0.1, torch.ones(DIM))
    assert not info.is_accepted.any()
    assert torch.equal(info.acceptance_rate, torch.zeros(2))
    assert torch.equal(state.position, start.position)
    assert torch.equal(state.potential, start.potential)


def test_integrator_is_reversible():
    """7 steps forward, then 7 from (theta', -p'), return to (theta, -p)."""
    _, potential, _, _ = conjugate()
    leapfrog = split_hmc.build_integrator(potential, M_SHARDS)
    theta0 = t(np.random.default_rng(1).normal(size=(2, DIM)))
    p0 = t(np.random.default_rng(2).normal(size=(2, DIM)))
    theta, p = theta0, p0
    for _ in range(7):
        theta, p = leapfrog(theta, p, 5e-3, torch.ones(DIM))
    back_t, back_p = theta, -p
    for _ in range(7):
        back_t, back_p = leapfrog(back_t, back_p, 5e-3, torch.ones(DIM))
    np.testing.assert_allclose(back_t.numpy(), theta0.numpy(), atol=1e-4)
    np.testing.assert_allclose(-back_p.numpy(), p0.numpy(), atol=1e-4)


def test_small_step_acceptance_near_one():
    _, potential, _, _ = conjugate()
    kernel = split_hmc.build_kernel(potential, M_SHARDS, 5,
                                    generator=torch.Generator().manual_seed(0))
    state = split_hmc.init(torch.zeros(4, DIM), potential, M_SHARDS)
    rates = []
    for _ in range(10):
        state, info = kernel(state, 1e-3, torch.ones(DIM))
        rates.append(info.acceptance_rate)
    assert float(torch.stack(rates).mean()) > 0.98


def test_recovers_conjugate_posterior():
    """4 chains of 400 draws after 100 burnt: the posterior mean and
    variance of the conjugate Gaussian."""
    _, potential, post_mean, post_var = conjugate()
    kernel = split_hmc.build_kernel(potential, M_SHARDS, 8,
                                    generator=torch.Generator().manual_seed(1))
    inv_mass = torch.full((DIM,), 1.0 / (1.0 + N_OBS / SIGMA**2))
    state = split_hmc.init(torch.zeros(4, DIM), potential, M_SHARDS)
    draws, accepted = [], []
    for i in range(500):
        state, info = kernel(state, 0.25, inv_mass)
        if i >= 100:
            draws.append(state.position)
            accepted.append(info.is_accepted)
    draws = torch.stack(draws).reshape(-1, DIM).numpy()
    assert float(torch.stack(accepted).float().mean()) > 0.5
    se_mean = np.sqrt(post_var / len(draws)) * 6 + 0.02
    np.testing.assert_allclose(draws.mean(axis=0), post_mean, atol=se_mean)
    np.testing.assert_allclose(draws.var(axis=0), post_var, rtol=0.5)


@pytest.fixture()
def image_npz(tmp_path):
    rng = np.random.default_rng(0)
    n, c, h, w = 256, 1, 14, 14
    y = rng.integers(0, 10, size=n)
    x = (rng.normal(size=(n, c, h, w)) * 20.0 + 100.0
         + 10.0 * y[:, None, None, None]).astype(np.float32)
    path = tmp_path / 'synth_images.npz'
    np.savez(path, x=x, y=y)
    return path


def test_script_end_to_end(image_npz, capsys):
    """The script on a synthetic local archive on the CPU (6 shards of 32,
    2 leapfrog steps): its JSON line, the same split of the data as the
    JAX loader's, and the refusal to run without a GPU unless asked."""
    sys.path.insert(0, str(ROOT / 'experiments'))
    try:
        import torch_symmetric_splitting as script
    finally:
        sys.path.pop(0)
    from mile_tpu.config import DataConfig, DatasetType, Source, Task
    from mile_tpu.data.image import ImageLoader

    argv = ['--dataset', str(image_npz), '--source', 'local',
            '--batch-size', '32', '--num-samples', '6', '--burn', '2',
            '--num-steps', '2', '--step-size', '1e-4']
    result = script.main(argv + ['--device', 'cpu'])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert 'Accuracy:' in out and 'LPPD:' in out
    assert 0.0 <= result['accuracy'] <= 1.0
    assert np.isfinite(result['lppd'])
    assert result['n_samples'] == 4
    assert 0.0 <= result['acceptance_rate'] <= 1.0

    jax_loader = ImageLoader(DataConfig(
        path=str(image_npz), source=Source.LOCAL,
        data_type=DatasetType.IMAGE, task=Task.CLASSIFICATION,
        train_split=0.77, valid_split=0.09, test_split=0.14), 0)
    n_train = jax_loader.arrays('train')[0].shape[0]
    n_test = jax_loader.arrays('test')[0].shape[0]
    assert (f'shards={n_train // 32} batch=32 train={n_train} '
            f'test={n_test}') in out

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            script.main(argv)
