"""The NUTS window adaptation and draws of both packages from the same
members, on the CPU, at two study cells (marked ``slow``: about a quarter
of an hour a case at protein n10000, over an hour at width 48; outside
tier-1).

``test_nuts_window_adaptation_from_the_same_members``: the ``datasize``
study's protein n10000 cell, from three sources of members: the port's
warm start of ``protein_nuts_n10000_r2``'s config on the CPU at the TPU's
one bfloat16 pass (the study's arithmetic), seed 2; and the members that
the port's ``protein_nuts_n10000_r2`` and ``_r3`` runs warm-started on the
card and sampled from (``tests/fixtures/card_members/``), each with its
own job's config and seed; and, the same way, the n40000 cell from the
card's ``protein_nuts_n40000_r1`` members.

``test_acceptance_over_a_jobs_draws_from_the_same_members``: from the
card's ``protein_nuts_n10000_r2`` members, four at a time (``SUBSETS``,
a case each, the same members in both packages), the job's whole run:
100 adaptation steps and its 1,000 draws.
Every port run of the study on the card lost acceptance over its draws
(0.84-0.93 in the first 100, 0.60-0.80 in the last 100); this case holds
the fall itself: each package's acceptance in windows of 100 draws, each
window's mean against three standard errors of the difference over the
chains, and each chain's drop from the first window to the last, paired
by member, against three standard errors of the paired difference.

``test_one_chain_of_a_target_acceptance_job``: one member of a
``nuts_ta`` job alone in both packages, at the job's own settings as the
runner loads them (depth 10, its target acceptance), 100 adaptation
steps and ``CHAIN_DRAWS`` draws: a chain that sticks on the card (its
acceptance far under the target, its divergences in the hundreds) either
sticks in both packages or is the port's.

``test_copies_of_one_member_of_a_target_acceptance_job``: the same member
copied into ``REPLICAS`` chains in each package, the same settings and
steps. NUTS adapts each chain on its own in both packages, so the copies
are independent runs of the member: the chains that stick
(``experiments/torch_nuts_members.py``'s rule, over the draws) are
compared by Fisher's two-sided exact test, and the mean log ε against
three standard errors of the difference.

``test_width_48_mean_ess_from_the_cards_members``: the ``complexity``
study's width-48 cell, from the members of the port's
``bike_nuts_48x48x48_r1`` run on the card; besides the NUTS table it
compares the draws' ``mean_ess`` (the study's: each layer's pooled ESS,
averaged over the layers) at the same draw count in both packages.

``test_airfoil_fs_split_rhat_from_the_cards_members``: the
``diagnostics`` study's airfoil NUTS cell (the deep-8 FCN, depth 10,
target 0.8 as its rows ran), from the members of the port's
``diag_nuts_airfoil_r2`` and ``_r1`` runs on the card, the job's 100 +
1,000 steps: besides the NUTS table it compares ``fs_split_rhat`` (the
split R-hat of the predictive mean on the test split, averaged over the
points) of both packages' draws, by the port's estimator, against three
of its jackknife standard errors over chains.

From the members each package runs its HMC-family runtime as the study
job does: the job's settings as both packages load them (the protein and
width-48 cells: NUTS at depth 8 in both phases, target acceptance 0.9),
the rows' 100 window-adaptation steps, then the test's draws, in exact
float32. The two draw from different generators, so the comparison is
statistical over the chains: the adapted ε paired by chain (the log
ratio's mean against three of its standard errors), the draws' mean
acceptance and leapfrog steps a draw against three standard errors of
their difference, and ``mean_ess`` against three of its jackknife
standard errors over chains. The port runs in a process of its own beside
the JAX package. The test prints every number (``-s``).
"""
import concurrent.futures
import json
import multiprocessing
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import _torch_card_members as card

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'experiments'))

import torch_nuts_members as nuts_members  # noqa: E402

pytestmark = pytest.mark.slow

JOB = 'protein_nuts_n10000_r2'
# member source -> the job whose config and seed the members go with
SOURCES = {'cpu_warm_start': JOB, 'card_r2': 'protein_nuts_n10000_r2',
           'card_r3': 'protein_nuts_n10000_r3',
           'card_n40000_r1': 'protein_nuts_n40000_r1'}
WIDTH_JOB = 'bike_nuts_48x48x48_r1'
DRAWS = 100
THREADS = 4
# the members that the long cases run, the same in both packages: a
# job's 1,000 draws of all 12 chains would take both packages about six
# hours on an 8-core box (100 + 100 steps of 12 chains took an hour at
# n10000), so a case keeps a third of the chains (about 1.5 hours). The
# n40000 leaf costs about four times n10000's, so its 100-draw case
# keeps the first four too.
SUBSETS = {'members_0-3': (0, 1, 2, 3), 'members_4-7': (4, 5, 6, 7)}
SUBSET = SUBSETS['members_0-3']
SUBSET_SOURCES = ('card_n40000_r1',)
JOB_DRAWS = 1000
WINDOW = nuts_members.WINDOW
# the protein cells' settings: (max_num_doublings,
# warmup_max_num_doublings, target_acceptance, warmup_steps)
DEPTH_8 = (8, 8, 0.9, 100)


def _se(v) -> float:
    v = np.asarray(v, dtype=np.float64)
    return float(v.std(ddof=1) / np.sqrt(len(v)))


def _updates(job, root: Path, draws: int) -> dict:
    return {'saving_dir': str(root), 'experiment_name': job.name,
            **job.overrides, 'training.sampler.n_samples': draws}


def _port_config(job, root: Path, draws: int):
    return job.config(root, tpu_arithmetic=True).replace(
        **_updates(job, root, draws))


def _warm_start(job, root: Path):
    """The port's warm start of ``job`` on the CPU at the TPU's one pass."""
    import torch

    from mile_tpu_torch.train.trainer import BDETrainer
    from mile_tpu_torch.utils import precision

    prev = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        precision.set_none_precision('bfloat16')
        trainer = BDETrainer(_port_config(job, root, DRAWS), device='cpu')
        return trainer.train_warmstart().numpy()
    finally:
        precision.set_none_precision('float32')
        torch.set_num_threads(prev)


def _port_nuts(name: str, members: np.ndarray, draws: int, root: str):
    """The port's runtime from ``members`` (in a process of its own)."""
    import torch

    from mile_tpu_torch.train.sampling_hmc import run_hmc_family
    from mile_tpu_torch.train.trainer import BDETrainer

    torch.set_num_threads(THREADS)
    job = card.catalogue_job(name)
    config = _port_config(job, Path(root), draws)
    scfg = config.training.sampler
    trainer = BDETrainer(config, device='cpu')
    x, y = trainer.loader.arrays('train')
    result = run_hmc_family(trainer.bayes.logdensity_and_grad_fn(x, y), scfg,
                            torch.Generator().manual_seed(7),
                            torch.from_numpy(members))
    settings = (scfg.max_num_doublings, scfg.warmup_max_num_doublings,
                scfg.target_acceptance, scfg.warmup_steps)
    return (settings, int(x.shape[0]), _stats(result),
            np.asarray(result.samples, np.float32))


def _stats(result) -> dict:
    info = result.info
    accept = np.asarray(info['acceptance_rate'], np.float64)  # (chains, draws)
    return {'eps': np.asarray(result.tuned['step_size'], np.float64),
            'accept': accept.mean(axis=1),
            'accept_draws': accept,
            'steps': np.asarray(info['num_integration_steps'],
                                np.float64).mean(axis=1),
            'divergent': int(np.sum(info['is_divergent'])),
            'divergent_chains': np.asarray(info['is_divergent'],
                                           np.int64).sum(axis=1),
            'divergent_draws': np.asarray(info['is_divergent'], np.int64),
            'steps_draws': np.asarray(info['num_integration_steps'],
                                      np.float64)}


def _job_settings(cfg) -> tuple:
    s = cfg.training.sampler
    return (s.max_num_doublings, s.warmup_max_num_doublings,
            s.target_acceptance, s.warmup_steps)


def _both_packages(name: str, members: np.ndarray, draws: int, root: Path,
                   jax_rows: dict | None = None):
    """(port, JAX): each package's statistics and draws from ``members``;
    the port in a spawned process while the JAX package runs here. Both
    run the job's settings as each package loads them (the JAX package's
    with ``jax_rows`` over them), and the port's must be the JAX
    package's (returned as ``settings``)."""
    import jax
    import jax.numpy as jnp

    from mile_tpu.config import Config as JaxConfig
    from mile_tpu.train.sampling_hmc import run_hmc_family as jax_run
    from mile_tpu.train.trainer import BDETrainer as JaxTrainer

    job = card.catalogue_job(name)
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context('spawn')) as pool:
        port = pool.submit(_port_nuts, name, members, draws,
                           str(root / 'port'))
        (jcfg,) = JaxConfig.from_file(ROOT / job.base)
        jcfg = jcfg.replace(**_updates(job, root / 'jax', draws),
                            **(jax_rows or {}))
        jtrainer = JaxTrainer(jcfg)
        jx, jy = jtrainer.loader.arrays('train')
        theirs = jax_run(jtrainer.bayes.logdensity_fn(jx, jy),
                         jcfg.training.sampler, jax.random.PRNGKey(7),
                         jnp.asarray(members))
        settings, n_train, ours, samples = port.result()
    assert settings == _job_settings(jcfg)
    assert jx.shape[0] == n_train == {JOB: 9000, WIDTH_JOB: 12165}.get(
        name, n_train)
    return ((ours, samples),
            (_stats(theirs), np.asarray(theirs.samples, np.float32)),
            settings)


def _compare(a: dict, b: dict, draws: int) -> None:
    """Print both packages' NUTS table and hold them to each other."""
    log_ratio = np.log(a['eps'] / b['eps'])
    print(f'\nport ε {a["eps"].mean():.6f} ± {_se(a["eps"]):.6f}, JAX '
          f'{b["eps"].mean():.6f} ± {_se(b["eps"]):.6f}; paired log ratio '
          f'{log_ratio.mean():+.4f} ± {_se(log_ratio):.4f}')
    for k in ('accept', 'steps'):
        print(f'{k}: port {a[k].mean():.4f} ± {_se(a[k]):.4f}, JAX '
              f'{b[k].mean():.4f} ± {_se(b[k]):.4f}')
    print(f'divergent over {draws} draws x {len(a["eps"])} chains: port '
          f'{a["divergent"]}, JAX {b["divergent"]}')
    assert abs(log_ratio.mean()) <= 3 * _se(log_ratio)
    for k in ('accept', 'steps'):
        assert abs(a[k].mean() - b[k].mean()) <= 3 * np.hypot(_se(a[k]),
                                                              _se(b[k]))


@pytest.mark.parametrize('source', list(SOURCES))
def test_nuts_window_adaptation_from_the_same_members(source, tmp_path):
    name = SOURCES[source]
    if source == 'cpu_warm_start':
        # no provider: the members are warm-started here
        members = _warm_start(card.catalogue_job(name), tmp_path / 'ws')
    else:
        members = card.members(name)
    chains = SUBSET if source in SUBSET_SOURCES else range(len(members))
    (ours, _), (theirs, _), settings = _both_packages(
        name, members[list(chains)], DRAWS, tmp_path)
    assert settings == DEPTH_8
    print(f'\nmembers: {source} ({name}), chains {list(chains)}')
    _compare(ours, theirs, DRAWS)


def _compare_windows(a: dict, b: dict) -> None:
    """Print both packages' acceptance by window of draws and hold each
    window's mean, and each chain's first-to-last drop, to each other."""
    wa, wb = (nuts_members.windows(a['accept_draws']),
              nuts_members.windows(b['accept_draws']))
    for k, (w, stats) in (('port', (wa, a)), ('JAX', (wb, b))):
        print(f'{k} acceptance by {WINDOW} draws: '
              + ' '.join(f'{m:.3f}' for m in w.mean(axis=0)))
        print(f'{k} per chain, first and last window: '
              + ' '.join(f'{f:.3f}->{l:.3f}' for f, l in zip(w[:, 0],
                                                             w[:, -1])))
        print(f'{k} divergent per chain: {stats["divergent_chains"].tolist()}')
    for i in range(wa.shape[1]):
        assert abs(wa[:, i].mean() - wb[:, i].mean()) <= 3 * np.hypot(
            _se(wa[:, i]), _se(wb[:, i])), i
    drop = (wa[:, 0] - wa[:, -1]) - (wb[:, 0] - wb[:, -1])
    print(f'first-to-last drop: port {(wa[:, 0] - wa[:, -1]).mean():+.4f}, '
          f'JAX {(wb[:, 0] - wb[:, -1]).mean():+.4f}; paired difference '
          f'{drop.mean():+.4f} ± {_se(drop):.4f}')
    assert abs(drop.mean()) <= 3 * _se(drop)


@pytest.mark.parametrize('subset', list(SUBSETS))
def test_acceptance_over_a_jobs_draws_from_the_same_members(subset,
                                                            tmp_path):
    chains = list(SUBSETS[subset])
    members = card.members('protein_nuts_n10000_r2')[chains]
    print(f'\nmembers: the card\'s protein_nuts_n10000_r2, chains '
          f'{chains} of 12; {JOB_DRAWS} draws')
    (ours, draws), (theirs, _), settings = _both_packages(
        'protein_nuts_n10000_r2', members, JOB_DRAWS, tmp_path)
    assert settings == DEPTH_8
    assert draws.shape == (len(chains), JOB_DRAWS, 738)
    assert ours['accept_draws'].shape == theirs['accept_draws'].shape == (
        len(chains), JOB_DRAWS)
    _compare(ours, theirs, JOB_DRAWS)
    _compare_windows(ours, theirs)


# (nuts_ta job, member) whose chain stuck on the card from its first
# draws: far under its target acceptance, with divergences in the
# hundreds (ta80_r2's member 5: 0.41 over 1,000 draws, 0.56, 0.42, 0.26
# in its first three windows of 100)
ONE_CHAIN = [('bike_nuts_ta80_r2', 5)]
CHAIN_DRAWS = 300
# copies of that member in each package: NUTS adapts each chain on its own
# in both, so they are independent runs of the same member
REPLICAS = 8


@pytest.mark.parametrize('job,member', ONE_CHAIN)
def test_one_chain_of_a_target_acceptance_job(job, member, tmp_path):
    provider = card.provider(job)
    members = card.members(provider)[[member]]
    (ours, _), (theirs, _), settings = _both_packages(
        job, members, CHAIN_DRAWS, tmp_path)
    target = settings[2]
    # no warm-up depth of its own: the adaptation's trees go to depth 10 too
    assert settings == (10, None, target, 100)
    print(f'\nmember {member} of the card\'s {provider}, {job}: target '
          f'{target}, {CHAIN_DRAWS} draws')
    stuck = {}
    for k, stats in (('port', ours), ('JAX', theirs)):
        w = nuts_members.windows(stats['accept_draws'])[0]
        stuck[k] = nuts_members.sticks(stats['accept'][0],
                                       stats['divergent'], target,
                                       CHAIN_DRAWS)
        print(f'{k}: ε {stats["eps"][0]:.6f}, acceptance '
              f'{stats["accept"][0]:.4f} (by {WINDOW} draws '
              + ' '.join(f'{m:.3f}' for m in w)
              + f'), evaluations a draw {stats["steps"][0]:.1f}, divergent '
              f'{stats["divergent"]}, sticks {stuck[k]}')
    assert stuck['port'] == stuck['JAX']


@pytest.mark.parametrize('job,member', ONE_CHAIN)
def test_copies_of_one_member_of_a_target_acceptance_job(job, member,
                                                        tmp_path):
    provider = card.provider(job)
    members = card.members(provider)[[member] * REPLICAS]
    t0 = time.perf_counter()
    (ours, _), (theirs, _), settings = _both_packages(
        job, members, CHAIN_DRAWS, tmp_path)
    target = settings[2]
    assert settings == (10, None, target, 100)
    print(f'\n{REPLICAS} copies of member {member} of the card\'s '
          f'{provider}, {job}: target {target}, {CHAIN_DRAWS} draws, '
          f'{time.perf_counter() - t0:.0f} s for both packages')
    records = {}
    for k, stats in (('port', ours), ('JAX', theirs)):
        records[k] = nuts_members.summarize(
            stats['eps'], stats['accept_draws'], stats['divergent_draws'],
            stats['steps_draws'], target)
        print(f'{k}: ' + json.dumps(records[k]))
        print(f'{k}: {records[k]["stuck_first"]} of {REPLICAS} stick; mean '
              f'log ε {records[k]["log_step_size_mean"]:.4f} ± '
              f'{records[k]["log_step_size_se"]:.4f}')
    verdict = nuts_members.compare(records['port'], records['JAX'])
    print('port vs JAX: ' + json.dumps(verdict))
    assert verdict['fisher_p'] >= 0.05
    assert verdict['within_3se']


def mean_ess(samples: np.ndarray, name: str) -> float:
    """The study's ``mean_ess``: each layer's pooled ESS over the chains
    (the port's estimator, which agrees with the JAX package's on the same
    draws), averaged over the layers."""
    from mile_tpu_torch.inference import reporting

    rows = reporting.compute_diagnostics(samples, card.layout(name),
                                         device='cpu')
    return float(np.mean([row['ess'] for row in rows.values()]))


def jackknife_se(samples: np.ndarray, name: str) -> float:
    """The jackknife standard error of ``mean_ess`` over the chains."""
    n = samples.shape[0]
    loo = np.array([mean_ess(np.delete(samples, c, axis=0), name)
                    for c in range(n)])
    return float(np.sqrt((n - 1) / n * np.sum((loo - loo.mean()) ** 2)))


def test_width_48_mean_ess_from_the_cards_members(tmp_path):
    members = card.members(WIDTH_JOB)
    (ours, port_draws), (theirs, jax_draws), settings = _both_packages(
        WIDTH_JOB, members, DRAWS, tmp_path)
    assert settings == DEPTH_8
    assert port_draws.shape == jax_draws.shape == (12, DRAWS, 5426)
    print(f'\nmembers: the card\'s {WIDTH_JOB}')
    ess = {k: (mean_ess(d, WIDTH_JOB), jackknife_se(d, WIDTH_JOB))
           for k, d in (('port', port_draws), ('JAX', jax_draws))}
    print('mean_ess over {} draws: port {:.3f} ± {:.3f}, JAX {:.3f} ± '
          '{:.3f}'.format(DRAWS, *ess['port'], *ess['JAX']))
    (a, sa), (b, sb) = ess['port'], ess['JAX']
    assert abs(a - b) <= 3 * np.hypot(sa, sb)
    _compare(ours, theirs, DRAWS)


# the diagnostics study's airfoil NUTS jobs whose fs_split_rhat lay
# outside the JAX seeds' interval on the card (r1 below it, r2 above)
RHAT_JOBS = ['diag_nuts_airfoil_r2', 'diag_nuts_airfoil_r1']


def fs_split_rhat(samples: np.ndarray, name: str, root: Path) -> tuple:
    """The study's ``fs_split_rhat`` of ``samples`` (chains, draws, dim)
    on the job's test split: the split R-hat (4 splits) of the predictive
    mean at each test point, averaged over the points, by the port's
    estimator for either package's draws; and its jackknife standard
    error over the chains."""
    import torch

    from mile_tpu_torch.inference import metrics as M
    from mile_tpu_torch.inference.evaluation import predict_bde
    from mile_tpu_torch.train.trainer import BDETrainer

    trainer = BDETrainer(_port_config(card.catalogue_job(name), root,
                                      samples.shape[1]), device='cpu')
    x, _ = trainer.loader.arrays('test')
    with torch.no_grad():
        fs = predict_bde(trainer.model, torch.from_numpy(samples), x)[..., 0]
    fs = fs[:, :fs.shape[1] - fs.shape[1] % 4]
    assert torch.isfinite(fs).all()

    def rhat(f) -> float:
        return float(torch.nanmean(M.gelman_split_r_hat(f, n_splits=4)))

    n = fs.shape[0]
    loo = np.array([rhat(torch.cat([fs[:c], fs[c + 1:]])) for c in range(n)])
    return rhat(fs), float(np.sqrt((n - 1) / n
                                   * np.sum((loo - loo.mean()) ** 2)))


@pytest.mark.parametrize('name', RHAT_JOBS)
def test_airfoil_fs_split_rhat_from_the_cards_members(name, tmp_path):
    import torch_run_catalog as cat

    members = card.members(name)
    t0 = time.perf_counter()
    (ours, port_draws), (theirs, jax_draws), settings = _both_packages(
        name, members, JOB_DRAWS, tmp_path, jax_rows=cat.TPU_ROWS_NUTS)
    assert settings == (10, None, 0.8, 100)
    assert port_draws.shape == jax_draws.shape == (12, JOB_DRAWS, 426)
    print(f'\nmembers: the card\'s {name}, {JOB_DRAWS} draws, '
          f'{time.perf_counter() - t0:.0f} s for both packages')
    rhat = {k: fs_split_rhat(d, name, tmp_path / 'eval')
            for k, d in (('port', port_draws), ('JAX', jax_draws))}
    print('fs_split_rhat: port {:.4f} ± {:.4f}, JAX {:.4f} ± {:.4f}'.format(
        *rhat['port'], *rhat['JAX']))
    for k, stats in (('port', ours), ('JAX', theirs)):
        print(f'{k}: ' + json.dumps(nuts_members.summarize(
            stats['eps'], stats['accept_draws'], stats['divergent_draws'],
            stats['steps_draws'], 0.8)))
    (a, sa), (b, sb) = rhat['port'], rhat['JAX']
    assert abs(a - b) <= 3 * np.hypot(sa, sb)
    _compare(ours, theirs, JOB_DRAWS)
