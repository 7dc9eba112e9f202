"""``experiments/torch_nuts_members.py`` on the CPU, cut to depth 3 and a
few steps: NUTS from copies of one of the card's warm-start members (the
``nuts_ta`` provider ``bike_mclmc_16x16x16_r2``, whose member 5 stuck on
the card in ``bike_nuts_ta80_r2``), its JSON line, the rule for a chain
that sticks, and the comparison of two runs."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_card_members as card

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / 'experiments' / 'torch_nuts_members.py'
sys.path.insert(0, str(ROOT / 'experiments'))

import torch_nuts_members as nm  # noqa: E402

JOB = 'bike_nuts_ta80_r2'
PROVIDER = 'bike_mclmc_16x16x16_r2'
REPLICAS = 3
CUT = ['--depth', '3', '--warmup-steps', '4', '--draws', '6']


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep torch to one thread: the suite runs several pytest workers."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(*args) -> subprocess.CompletedProcess:
    env = {**os.environ, 'OMP_NUM_THREADS': '1', 'MKL_NUM_THREADS': '1'}
    return subprocess.run([sys.executable, str(SCRIPT), *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope='module')
def record(tmp_path_factory):
    proc = _run('--job', JOB, '--members', str(card.directory(PROVIDER)),
                '--member', '5', '--replicas', str(REPLICAS), *CUT,
                '--device', 'cpu')
    assert proc.returncode == 0, proc.stderr[-3000:]
    path = tmp_path_factory.mktemp('nuts_members') / 'a.json'
    path.write_text(proc.stdout)
    return json.loads(proc.stdout.splitlines()[-1]), path


def test_the_json_line_has_one_entry_per_copy(record):
    rec, _ = record
    assert (rec['job'], rec['member'], rec['replicas']) == (JOB, 5, REPLICAS)
    # the job's settings as the runner loads them, the trees cut to 3
    assert (rec['target_acceptance'], rec['max_num_doublings'],
            rec['warmup_max_num_doublings'], rec['warmup_steps'],
            rec['draws']) == (0.8, 3, 3, 4, 6)
    assert (rec['dim'], rec['n_train'], rec['rng']) == (786, 12165, 2)
    for key in ('step_size', 'acceptance', 'acceptance_windows', 'divergent',
                'divergent_first', 'evaluations', 'sticks', 'sticks_first',
                'draw_sums'):
        assert len(rec[key]) == REPLICAS, key
    assert all(math.isfinite(e) and e > 0 for e in rec['step_size'])
    assert rec['log_step_size_mean'] == pytest.approx(
        np.mean(np.log(rec['step_size'])))
    # fewer draws than a window: one window of all of them
    assert rec['window'] == 6
    assert [w[0] for w in rec['acceptance_windows']] == pytest.approx(
        rec['acceptance'])
    assert rec['stuck'] == sum(rec['sticks'])
    assert rec['stuck_first'] == sum(rec['sticks_first'])


def test_the_copies_run_apart(record):
    rec, _ = record
    sums = rec['draw_sums']
    assert len(set(sums)) == REPLICAS
    assert len(set(rec['step_size'])) == REPLICAS


def test_the_copies_start_from_the_member():
    # two copies of one member, the job's rows and model
    out = nm.run_members(JOB, card.directory(PROVIDER), 5, 2, draws=2,
                         warmup_steps=2, depth=2, device='cpu',
                         keep_draws=True)
    assert out['samples'].shape == (2, 2, 786)
    assert np.isfinite(out['samples']).all()
    member = card.members(PROVIDER)[5]
    # one leapfrog step of ε ~ 1e-4 from the member: near it, not on it
    moved = np.abs(out['samples'][:, 0] - member).max(axis=1)
    assert (moved > 0).all() and (moved < 0.5).all()


def test_the_split_route_flag_is_restored_and_moves_nothing_on_the_cpu():
    from mile_tpu_torch.models import blocks

    before = blocks.SPLIT_K_MIN_ROWS
    kw = dict(draws=2, warmup_steps=2, depth=2, device='cpu')
    on = nm.run_members(JOB, card.directory(PROVIDER), 5, 2, **kw)
    off = nm.run_members(JOB, card.directory(PROVIDER), 5, 2, split_k=False,
                         **kw)
    assert blocks.SPLIT_K_MIN_ROWS == before
    # the CPU's leaves are eager, where the split-row gradient never runs
    assert (on['split_k'], off['split_k']) == (True, False)
    assert on['step_size'] == off['step_size']
    assert on['draw_sums'] == off['draw_sums']


@pytest.mark.parametrize('acceptance,divergent,stuck', [
    (0.45, 0, True),      # 0.35 under a target of 0.8
    (0.55, 0, False),     # 0.25 under it
    (0.85, 31, True),     # more than a tenth of 300 draws diverge
    (0.85, 30, False),    # exactly a tenth
])
def test_the_rule_for_a_chain_that_sticks(acceptance, divergent, stuck):
    assert nm.sticks(acceptance, divergent, 0.8, 300) is stuck


def test_a_hand_made_trace_sticks_and_does_not():
    draws = 400
    accept = np.full((3, draws), 0.9)
    div = np.zeros((3, draws), np.int64)
    accept[1, :] = 0.3                       # sticks from its first draw
    accept[2, 300:] = 0.0                    # sticks only after draw 300
    div[2, 300:] = 1
    rec = nm.summarize([1e-3, 2e-3, 4e-3], accept, div,
                       np.full((3, draws), 1023.0), 0.8)
    assert rec['sticks_first'] == [False, True, False]
    assert rec['sticks'] == [False, True, True]
    assert (rec['stuck_first'], rec['stuck']) == (1, 2)
    assert rec['divergent'] == [0, 0, 100]
    assert rec['divergent_first'] == [0, 0, 0]
    assert rec['acceptance_windows'][2] == pytest.approx([0.9] * 3 + [0.0])
    assert rec['log_step_size_mean'] == pytest.approx(np.log(2e-3))
    assert rec['log_step_size_se'] == pytest.approx(
        np.log([1e-3, 2e-3, 4e-3]).std(ddof=1) / np.sqrt(3))


@pytest.mark.parametrize('a,n_a,b,n_b', [
    (1, 12, 0, 8), (6, 12, 0, 8), (3, 12, 2, 8), (12, 12, 0, 8), (0, 12, 0, 8),
    (5, 9, 1, 11)])
def test_fisher_p_is_scipys(a, n_a, b, n_b):
    from scipy.stats import fisher_exact

    want = fisher_exact([[a, n_a - a], [b, n_b - b]])[1]
    assert nm.fisher_p(a, n_a, b, n_b) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize('p_a,n_a,p_b,n_b', [
    (0.5, 4, 0.1, 5), (0.78, 12, 0.125, 8), (0.3, 6, 0.3, 6)])
def test_fisher_power_sums_the_tables_scipy_rejects(p_a, n_a, p_b, n_b):
    from scipy.stats import binom, fisher_exact

    want = sum(binom.pmf(a, n_a, p_a) * binom.pmf(b, n_b, p_b)
               for a in range(n_a + 1) for b in range(n_b + 1)
               if fisher_exact([[a, n_a - a], [b, n_b - b]])[1] <= 0.05)
    assert nm.fisher_power(p_a, n_a, p_b, n_b) == pytest.approx(want,
                                                                rel=1e-9)


def test_the_smallest_stuck_share_the_test_can_tell():
    # twelve chains against eight that stick one in eight
    share = nm.detectable_share(12, 1 / 8, 8)
    assert nm.fisher_power(share, 12, 1 / 8, 8) >= nm.DETECT_POWER
    assert nm.fisher_power(share - 0.01, 12, 1 / 8, 8) < nm.DETECT_POWER
    # at equal shares the test rejects no more often than its level
    assert nm.fisher_power(1 / 8, 12, 1 / 8, 8) <= 0.05
    # two chains against two: no share is told apart with 80 % power
    assert nm.detectable_share(2, 0.5, 2) is None


def test_compare_of_two_json_lines(record, tmp_path):
    rec, path = record
    other = dict(rec, step_size=[e * 2 for e in rec['step_size']],
                 log_step_size_mean=rec['log_step_size_mean'] + math.log(2),
                 stuck_first=REPLICAS)
    (tmp_path / 'b.json').write_text('a line before\n' + json.dumps(other))
    proc = _run('--compare', str(path), str(tmp_path / 'b.json'))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out['stuck_first'] == [rec['stuck_first'], REPLICAS, REPLICAS,
                                  REPLICAS]
    assert out['log_step_size_diff'] == pytest.approx(-math.log(2))
    assert out['log_step_size_diff_se'] == pytest.approx(
        math.sqrt(2) * rec['log_step_size_se'])
    assert out['detectable_stuck_share'] == nm.detectable_share(
        REPLICAS, 1.0, REPLICAS)
    assert out == nm.compare(rec, other)


def test_a_run_needs_its_job_member_and_copies():
    proc = _run('--job', JOB, '--device', 'cpu')
    assert proc.returncode == 2
    assert '--members' in proc.stderr and '--replicas' in proc.stderr


def test_without_a_gpu_a_run_raises_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    proc = _run('--job', JOB, '--members', str(card.directory(PROVIDER)),
                '--member', '5', '--replicas', '2', *CUT)
    assert proc.returncode != 0
    assert 'no CUDA device' in proc.stderr
    assert proc.stdout == ''
