"""The port's study queue on the CPU: the relaunch loop
(``experiments/torch_catalog_queue.py``) with stub runners, and the
pooled-study comparison (``experiments/torch_compare_study.py``) on
hand-made CSVs.

A stub runner is a small Python script that records the arguments it was
launched with, counts its launches per study and exits with the codes the
test scripted; on exit 0 or 1 it leaves one finished experiment directory
(``config.yaml`` and ``metrics.pkl``) for the pooling to find. The loop
relaunches after 70 (cool-off 0 here), stops at once on 75 without pooling,
abandons a stage after three faults and goes on, passes the study's job
timeout and the device to the runner, and pools into the directory it is
given, never into ``aggr_results/``.
"""
import json
import math
import shlex
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from _torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'experiments'))

import torch_catalog_queue as tq  # noqa: E402
import torch_compare_study as tc  # noqa: E402

STUB = textwrap.dedent('''
    import argparse, json, pickle, sys
    from pathlib import Path

    state = Path({state!r})
    p = argparse.ArgumentParser()
    for flag in ('--root', '--only', '--name-filter', '--job-timeout',
                 '--device'):
        p.add_argument(flag)
    p.add_argument('--tpu-arithmetic', action='store_true')
    args = p.parse_args()
    with open(state / 'calls.jsonl', 'a') as f:
        f.write(json.dumps({{'argv': sys.argv[1:], **vars(args)}}) + '\\n')
    codes = json.loads((state / 'codes.json').read_text())[args.only]
    counter = state / f'count_{{args.only}}'
    n = int(counter.read_text()) if counter.exists() else 0
    counter.write_text(str(n + 1))
    rc = codes[min(n, len(codes) - 1)]
    print(f'stub runner: {{args.only}} launch {{n + 1}}, exit {{rc}}')
    if rc in (0, 1):
        exp = Path(args.root) / args.only / f'{{args.only}}_job_r1'
        exp.mkdir(parents=True, exist_ok=True)
        (exp / 'config.yaml').write_text(
            f'experiment_name: {{args.only}}_job_r1\\nrng: 1\\n')
        with open(exp / 'metrics.pkl', 'wb') as f:
            pickle.dump({{'lppd': 0.5, 'rmse': 0.25}}, f)
    sys.exit(rc)
''')


@pytest.fixture
def stub(tmp_path):
    """(runner command, scripting function, launches) of a stub runner."""
    state = tmp_path / 'stub'
    state.mkdir()
    script = state / 'runner.py'
    script.write_text(STUB.format(state=str(state)))

    def script_codes(**codes):
        (state / 'codes.json').write_text(json.dumps(codes))

    def launches():
        path = state / 'calls.jsonl'
        return ([json.loads(line) for line in path.read_text().splitlines()]
                if path.exists() else [])

    return [sys.executable, str(script)], script_codes, launches


def _queue(tmp_path, runner, **kwargs):
    kwargs.setdefault('cooloff_s', 0)
    kwargs.setdefault('device', 'cpu')
    return tq.Queue(tmp_path / 'root', aggr_dir=tmp_path / 'aggr',
                    runner=runner, **kwargs)


def test_a_fault_then_success_relaunches_once_and_pools(tmp_path, stub):
    runner, script, launches = stub
    script(dataset=[70, 0])
    queue = _queue(tmp_path, runner)
    assert queue.run([tq.Stage.parse('dataset:_r1$')]) == 0
    (result,) = queue.results
    assert result.exit_codes == [70, 0] and not result.abandoned
    assert len(launches()) == 2
    assert all(c['name_filter'] == '_r1$' for c in launches())
    assert result.pooled == tmp_path / 'aggr' / 'aggr_dataset.csv'
    df = pd.read_csv(result.pooled)
    assert list(df['experiment_name']) == ['dataset_job_r1']
    assert df['lppd'].tolist() == [0.5]
    log = (tmp_path / 'root' / 'queue_driver.log').read_text()
    assert 'device fault during: dataset:_r1$ (attempt 1); cooling off' in log
    assert 'stub runner: dataset launch 2, exit 0' in log


def test_stop_exits_75_at_once_without_pooling(tmp_path, stub):
    runner, script, launches = stub
    script(dataset=[75], feasibility=[0])
    queue = _queue(tmp_path, runner)
    assert queue.run([tq.Stage('dataset'), tq.Stage('feasibility')]) == 75
    (result,) = queue.results
    assert result.exit_codes == [75] and result.stopped
    assert result.pooled is None
    assert [c['only'] for c in launches()] == ['dataset']
    assert not (tmp_path / 'aggr').exists()
    assert 'STOP honored during: dataset' in (
        tmp_path / 'root' / 'queue_driver.log').read_text()


def test_three_faults_abandon_the_stage_and_the_next_runs(tmp_path, stub):
    runner, script, launches = stub
    script(dataset=[70], feasibility=[1])
    queue = _queue(tmp_path, runner)
    assert queue.run([tq.Stage('dataset'), tq.Stage('feasibility')]) == 0
    first, second = queue.results
    assert first.exit_codes == [70, 70, 70] and first.abandoned
    assert second.exit_codes == [1] and not second.abandoned
    assert [c['only'] for c in launches()] == ['dataset'] * 3 + [
        'feasibility']
    # both stages pooled, as the shell pools after an abandoned stage
    assert first.pooled == tmp_path / 'aggr' / 'aggr_dataset.csv'
    assert pd.read_csv(second.pooled)['experiment_name'].tolist() == [
        'feasibility_job_r1']
    log = (tmp_path / 'root' / 'queue_driver.log').read_text()
    assert log.count('cooling off') == 2
    assert 'stage abandoned after repeated device faults: dataset' in log


@pytest.mark.parametrize('study, device, want', [
    ('dataset', 'cpu', '7200'),
    ('tabular_classif', 'cuda', '1800'),
    ('dataset', 'cuda', '7200'),
    ('dtype_ab', 'cuda', '7200'),
    ('feasibility', 'cuda', '7200'),
])
def test_job_timeout_and_device_reach_the_runner(tmp_path, stub, study,
                                                 device, want):
    runner, script, launches = stub
    script(**{study: [0]})
    queue = _queue(tmp_path, runner, device=device)
    assert queue.run([tq.Stage(study)]) == 0
    (call,) = launches()
    assert call['argv'] == ['--root', str(tmp_path / 'root'), '--only',
                            study, '--job-timeout', want, '--device', device]


def test_the_tpu_arithmetic_reaches_the_runner(tmp_path, stub):
    """``--tpu-arithmetic`` goes to every launch of the runner, after the
    flags the loop always passes; without it the runner gets none."""
    runner, script, launches = stub
    script(dataset=[70, 0], yacht=[0])
    rc = tq.main(['--root', str(tmp_path / 'root'), '--stage', 'dataset',
                  '--aggr-dir', str(tmp_path / 'aggr'), '--cooloff', '0',
                  '--device', 'cpu', '--tpu-arithmetic',
                  '--runner', shlex.join(runner)])
    assert rc == 0
    calls = launches()
    assert [c['argv'][-1] for c in calls] == ['--tpu-arithmetic'] * 2
    assert all(c['tpu_arithmetic'] for c in calls)
    queue = _queue(tmp_path / 'plain', runner)
    assert queue.run([tq.Stage('yacht')]) == 0
    assert launches()[-1]['tpu_arithmetic'] is False


def test_the_dataset_timeout_fits_its_longest_job():
    """Protein's warm start at most (500 epochs of 1,001 batches at 3.6
    ms) plus 60,000 MCLMC steps at 100 steps/s, with room for a host 1.5x
    slower than that."""
    warm_start = 500 * math.ceil(0.7 * 45_730 / 32) * 3.6e-3
    sampling = (50_000 + 10_000) / 100
    assert tq.JOB_TIMEOUT_S['dataset'] >= 7200 >= 1.5 * (warm_start
                                                          + sampling)


def test_the_pool_never_lands_in_aggr_results(tmp_path, stub):
    runner, script, _ = stub
    with pytest.raises(ValueError, match='JAX package'):
        tq.Queue(tmp_path / 'root', aggr_dir=ROOT / 'aggr_results',
                 runner=runner)
    script(stubstudy=[0])
    before = sorted(p.name for p in (ROOT / 'aggr_results').iterdir())
    queue = tq.Queue(tmp_path / 'root', aggr_dir=tmp_path / 'aggr_torch',
                     runner=runner, cooloff_s=0, device='cpu')
    assert queue.run([tq.Stage('stubstudy')]) == 0
    assert (tmp_path / 'aggr_torch' / 'aggr_stubstudy.csv').exists()
    assert sorted(p.name for p in (ROOT / 'aggr_results').iterdir()) == before
    assert tq.AGGR_DIR == ROOT / 'aggr_results_torch'


def test_the_command_line(tmp_path, stub, capsys):
    runner, script, _ = stub
    script(dataset=[70, 0], feasibility=[0])
    rc = tq.main(['--root', str(tmp_path / 'root'), '--stage', 'dataset:_r1$',
                  '--stage', 'feasibility', '--aggr-dir',
                  str(tmp_path / 'aggr'), '--cooloff', '0', '--device', 'cpu',
                  '--runner', shlex.join(runner)])
    assert rc == 0
    out = capsys.readouterr().out
    assert (f'dataset:_r1$: runner exit codes 70 0; pooled: '
            f'{tmp_path / "aggr" / "aggr_dataset.csv"}') in out
    assert 'feasibility: runner exit codes 0; pooled:' in out


def test_a_missing_gpu_is_the_runners_error(tmp_path):
    """The real runner without ``--device cpu`` on a machine without a GPU
    raises (exit 1); the loop neither catches it nor falls back, and goes
    on."""
    queue = tq.Queue(tmp_path / 'root', aggr_dir=tmp_path / 'aggr',
                     cooloff_s=0)
    assert queue.device == 'cuda'
    assert queue.run([tq.Stage('dataset', '^uci_mclmc_yacht_r1$')]) == 0
    (result,) = queue.results
    assert result.exit_codes == [1]
    log = (tmp_path / 'root' / 'queue_driver.log').read_text()
    assert 'no CUDA device' in log
    assert not (tmp_path / 'root' / 'dataset').exists()


def test_the_scripts_import_neither_torch_nor_jax():
    code = textwrap.dedent('''
        import sys
        sys.path.insert(0, 'experiments')
        import torch_catalog_queue, torch_compare_study
        print(sorted({m.split('.')[0] for m in sys.modules} & {
            'torch', 'jax', 'mile_tpu', 'mile_tpu_torch'}))
    ''')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == '[]'


# ------------------------------------------------------------ comparison
# the metrics a regression study (dataset) compares, in their order
SIX = ['lppd', 'rmse', 'cal_error', 'coverage_0.9', 'step_size_mean',
       'L_mean']


def _study(tmp_path):
    """A JAX study of two groups x 3 seeds and a port study of one seed
    each: airfoil's lppd inside its interval, its rmse outside, concrete's
    cal_error not finite."""
    metrics = SIX
    jax_rows = []
    for group, base in (('uci_mclmc_airfoil', 1.0), ('uci_mclmc_concrete',
                                                     10.0)):
        for seed, delta in ((1, -1.0), (2, 0.0), (3, 1.0)):
            jax_rows.append({'experiment_name': f'{group}_r{seed}',
                             **{m: base + delta for m in metrics}})
    port_rows = [
        {'experiment_name': 'uci_mclmc_airfoil_r1',
         **{m: 1.0 for m in metrics}, 'lppd': 5.9, 'rmse': 7.0},
        {'experiment_name': 'uci_mclmc_concrete_r1',
         **{m: 10.0 for m in metrics}, 'cal_error': math.nan}]
    jax_csv, port_csv = tmp_path / 'jax.csv', tmp_path / 'port.csv'
    pd.DataFrame(jax_rows).to_csv(jax_csv, index=False)
    pd.DataFrame(port_rows).to_csv(port_csv, index=False)
    return jax_csv, port_csv


def test_the_prediction_interval_is_m_plus_minus_4_97_s():
    m, s, lo, hi = tc.prediction_interval([0.0, 1.0, 2.0])
    assert (m, s) == (1.0, 1.0)
    assert (hi - m) / s == pytest.approx(4.9683, abs=1e-3)
    assert (m - lo) / s == pytest.approx(4.9683, abs=1e-3)
    assert all(map(math.isnan, tc.prediction_interval([3.0])[2:]))


def test_the_comparison_finds_inside_and_outside(tmp_path):
    jax_csv, port_csv = _study(tmp_path)
    df = tc.compare(pd.read_csv(port_csv), pd.read_csv(jax_csv))
    assert len(df) == 2 * len(SIX)
    verdict = df.set_index(['experiment_name', 'metric'])['verdict']
    assert verdict['uci_mclmc_airfoil_r1', 'lppd'] == 'inside'     # 5.9
    assert verdict['uci_mclmc_airfoil_r1', 'rmse'] == 'outside'    # 7.0
    assert verdict['uci_mclmc_concrete_r1', 'cal_error'] == 'outside'
    assert (verdict == 'outside').sum() == 2
    row = df[(df['experiment_name'] == 'uci_mclmc_airfoil_r1')
             & (df['metric'] == 'lppd')].iloc[0]
    assert row['jax_same_name'] == 0.0 and row['jax_n'] == 3
    assert row['hi'] == pytest.approx(1.0 + 4.9683, abs=1e-3)
    assert tc.summary(df) == ('2 of 12 outside their 95 % intervals (0.6 '
                              'expected by chance)')


def test_the_comparison_exits_0_and_writes_its_table(tmp_path, capsys):
    jax_csv, port_csv = _study(tmp_path)
    out = tmp_path / 'compare.csv'
    assert tc.main(['dataset', '--port', str(port_csv), '--jax',
                    str(jax_csv), '--out', str(out)]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[-1] == ('2 of 12 outside their 95 % intervals (0.6 '
                           'expected by chance)')
    assert '| uci_mclmc_airfoil_r1 | rmse | 7 | 0 | ' in '\n'.join(printed)
    assert len(pd.read_csv(out)) == 12


def test_a_missing_jax_column_is_the_ports_fault(tmp_path):
    jax_csv, port_csv = _study(tmp_path)
    port = pd.read_csv(port_csv).rename(columns={'L_mean': 'L'})
    with pytest.raises(KeyError, match='L_mean'):
        tc.compare(port, pd.read_csv(jax_csv))


@pytest.mark.parametrize('study,metrics,groups,seeds', [
    ('dataset', SIX,
     [f'uci_mclmc_{d}' for d in ('airfoil', 'concrete', 'energy', 'yacht',
                                 'bikesharing', 'protein')], 3),
    ('tabular_classif', ['lppd', 'acc', 'step_size_mean', 'L_mean'],
     [f'{d}_mclmc' for d in ('sonar', 'heart', 'glass', 'australian',
                             'ionosphere', 'wine_red', 'wine_white')], 5)])
def test_the_jax_study_has_every_compared_column(study, metrics, groups,
                                                 seeds):
    """The metrics compared are the JAX study's own: ``dataset`` its six,
    ``tabular_classif`` LPPD, accuracy, ε and L (no RMSE, calibration or
    coverage columns there)."""
    jax = pd.read_csv(ROOT / 'aggr_results' / f'aggr_{study}.csv')
    assert tc.metrics_of(jax) == metrics
    assert not tc.one_run_a_job(jax)
    counts = jax['experiment_name'].map(tc.group_of).value_counts()
    assert sorted(counts.index) == sorted(groups)
    assert set(counts) == {seeds}


def test_the_five_seed_interval_is_m_plus_minus_2_776_s_sqrt_1_2():
    values = [0.0, 1.0, 2.0, 3.0, 4.0]
    m, s, lo, hi = tc.prediction_interval(values)
    assert (m, s) == (2.0, pytest.approx(np.std(values, ddof=1)))
    half = 2.7764451051977934 * s * math.sqrt(1.2)
    assert (lo, hi) == (pytest.approx(m - half), pytest.approx(m + half))


def test_a_classification_port_without_acc_raises():
    jax = pd.read_csv(ROOT / 'aggr_results' / 'aggr_tabular_classif.csv')
    df = tc.compare(jax, jax)
    assert len(df) == 35 * 4 and set(df['verdict']) == {'inside'}
    with pytest.raises(KeyError, match='acc'):
        tc.compare(jax.drop(columns=['acc']), jax)


def test_the_feasibility_values_compare_one_by_one(tmp_path, capsys):
    """``feasibility`` has one run a job: each value is held against the
    JAX row of its name. A hand-made port study: airfoil's naive arm fails
    as JAX's (NaN LPPD, ε 0), its tuned arm is finite where JAX's LPPD is
    NaN, bikesharing's naive arm finite with JAX's at twice its values."""
    jax_csv = ROOT / 'aggr_results' / 'aggr_feasibility.csv'
    jax = pd.read_csv(jax_csv)
    assert tc.one_run_a_job(jax) and len(jax) == 14
    assert tc.metrics_of(jax) == SIX
    ref = jax.set_index('experiment_name')
    port = pd.DataFrame([
        {'experiment_name': 'feas_mclmc_airfoil',
         **{m: ref.at['feas_mclmc_airfoil', m] for m in SIX}},
        {'experiment_name': 'feas_tuned_airfoil',
         **{m: 0.5 for m in SIX}},
        {'experiment_name': 'feas_mclmc_bikesharing',
         **{m: 2.0 * ref.at['feas_mclmc_bikesharing', m] for m in SIX}},
        {'experiment_name': 'feas_f32_protein', **{m: 1.0 for m in SIX}}])
    df = tc.compare_values(port, jax)
    verdict = df.set_index(['experiment_name', 'metric'])['verdict']
    ratio = df.set_index(['experiment_name', 'metric'])['ratio']
    assert len(df) == 3 * len(SIX)     # feas_f32_protein has no JAX row
    assert verdict['feas_mclmc_airfoil', 'lppd'] == 'both fail'
    assert verdict['feas_mclmc_airfoil', 'step_size_mean'] == 'both fail'
    assert verdict['feas_tuned_airfoil', 'lppd'] == 'differ'
    assert verdict['feas_tuned_airfoil', 'step_size_mean'] == 'differ'
    assert (verdict['feas_mclmc_bikesharing'] == 'both finite').all()
    assert ratio['feas_mclmc_bikesharing', 'lppd'] == pytest.approx(2.0)
    assert ratio['feas_mclmc_bikesharing', 'L_mean'] == pytest.approx(2.0)
    assert math.isnan(ratio['feas_tuned_airfoil', 'lppd'])
    port_csv = tmp_path / 'port.csv'
    port.to_csv(port_csv, index=False)
    assert tc.main(['feasibility', '--port', str(port_csv)]) == 0
    last = capsys.readouterr().out.splitlines()[-1]
    assert last == ('lppd finiteness agrees in 2 of 3 jobs; 4 of 18 values '
                    'differ (lppd 1, rmse 1, step_size_mean 1, L_mean 1)')


def test_the_dataset_comparison_is_unchanged():
    """``dataset`` keeps its six metrics and the committed verdicts."""
    here = ROOT / 'aggr_results_torch' / 'tpu_arithmetic'
    df = tc.compare(pd.read_csv(here / 'aggr_dataset.csv'),
                    pd.read_csv(ROOT / 'aggr_results' / 'aggr_dataset.csv'))
    committed = pd.read_csv(here / 'compare_dataset.csv')
    assert list(df['metric'].unique()) == SIX
    assert df['verdict'].tolist() == committed['verdict'].tolist()
    assert df['experiment_name'].tolist() == \
        committed['experiment_name'].tolist()


def test_jobs_side_by_side(tmp_path, stub):
    """``experiments/torch_study_side_by_side.sh``: one loop per spec,
    started together (a ``:tpu`` spec with ``--tpu-arithmetic``), each
    loop's exit code, then the root's study pooled and its runs copied to
    OUT without their draws and warm-start curves, members kept."""
    import os

    runner, script, launches = stub
    script(dataset=[0])
    root = tmp_path / 'root'
    out = tmp_path / 'out'
    job = root / 'dataset' / 'dataset_job_r1'
    for name in ('samples/samples.bin', 'warmstart/metrics.pkl',
                 'warmstart/params_0.npz'):
        (job / name).parent.mkdir(parents=True, exist_ok=True)
        (job / name).write_bytes(b'bytes')
    env = dict(os.environ, DEVICE='cpu', RUNNER=shlex.join(runner))
    proc = subprocess.run(
        ['bash', str(ROOT / 'experiments' / 'torch_study_side_by_side.sh'),
         str(out), '60', f'{root}:dataset:_r1$:tpu', f'{root}:dataset:_r2$'],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loops = (out / 'loops.txt').read_text().splitlines()
    assert [line.split()[-1] for line in loops[:2]] == ['0', '0']
    assert loops[2].startswith('wall_s ')
    flags = sorted(c['tpu_arithmetic'] for c in launches())
    assert flags == [False, True]
    pooled = pd.read_csv(out / 'root' / 'aggr_dataset.csv')
    assert pooled['experiment_name'].tolist() == ['dataset_job_r1']
    copied = out / 'root' / 'dataset' / 'dataset_job_r1'
    assert (copied / 'metrics.pkl').exists()
    assert (copied / 'warmstart' / 'params_0.npz').exists()
    assert not (copied / 'samples' / 'samples.bin').exists()
    assert not (copied / 'warmstart' / 'metrics.pkl').exists()
