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
    for study in args.only.split(',') if rc in (0, 1) else ():
        exp = Path(args.root) / study / f'{{study}}_job_r1'
        exp.mkdir(parents=True, exist_ok=True)
        (exp / 'config.yaml').write_text(
            f'experiment_name: {{study}}_job_r1\\nrng: 1\\n')
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


def test_a_stage_of_several_studies_runs_one_runner_and_pools_each(
        tmp_path, stub):
    """``STUDY,STUDY:REGEX``: one runner process for the jobs of both
    studies, with the larger job timeout, then each study pooled."""
    runner, script, launches = stub
    script(**{'hyper_params,datasize': [0]})
    queue = _queue(tmp_path, runner)
    stage = tq.Stage.parse('hyper_params,datasize:^(a|b)$')
    assert stage.studies == ['hyper_params', 'datasize']
    assert queue.run([stage]) == 0
    (result,) = queue.results
    (call,) = launches()
    assert call['only'] == 'hyper_params,datasize'
    assert call['name_filter'] == '^(a|b)$'
    assert call['job_timeout'] == '7200'
    aggr = tmp_path / 'aggr'
    assert result.pooled == aggr / 'aggr_hyper_params.csv'
    assert result.pooled_all == [aggr / 'aggr_hyper_params.csv',
                                 aggr / 'aggr_datasize.csv']
    for study in stage.studies:
        assert pd.read_csv(aggr / f'aggr_{study}.csv')[
            'experiment_name'].tolist() == [f'{study}_job_r1']
    with pytest.raises(ValueError):
        tq.Stage.parse('hyper_params,:x')


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
    # the chain diagnostics (a table of their own): the JAX rows' values
    for m in tc.DIAGNOSTICS:
        port[m] = [ref.at[name, m] if name in ref.index else 1.0
                   for name in port['experiment_name']]
    port.to_csv(port_csv, index=False)
    assert tc.main(['feasibility', '--port', str(port_csv)]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert ('lppd finiteness agrees in 2 of 3 jobs; 4 of 18 values '
            'differ (lppd 1, rmse 1, step_size_mean 1, L_mean 1)') in printed
    assert printed[-1] == '0 of 18 values differ'


def test_the_dataset_comparison_is_unchanged():
    """``dataset`` keeps its six metrics and the committed verdicts."""
    here = ROOT / 'aggr_results_torch' / 'tpu_arithmetic'
    df = tc.compare(pd.read_csv(here / 'aggr_dataset.csv'),
                    pd.read_csv(ROOT / 'aggr_results' / 'aggr_dataset.csv'))
    committed = pd.read_csv(here / 'compare_dataset.csv')
    committed = committed[committed['table'] == 'predictive']
    assert list(df['metric'].unique()) == SIX
    assert df['verdict'].tolist() == committed['verdict'].tolist()
    assert df['experiment_name'].tolist() == \
        committed['experiment_name'].tolist()


HYPER_PORT = ['bike_mclmc_ev100.0_0.05_r1', 'bike_mclmc_ev0.5_0.1_r2',
              'bike_mclmc_wu200000_r1', 'bike_mclmc_trust2.0_r3',
              'bike_de_r1']


def test_the_hyper_params_comparison_pools_each_grid_point(tmp_path,
                                                          capsys):
    """``hyper_params``: the JAX rows are 24 grid points of three seeds,
    the ``_rN`` suffix stripped and ``ev100.0_0.05``-style names whole. A
    port study of five of the real rows, one moved outside and the NUTS
    baseline absent: each run held against its own grid point's three
    seeds on both tables, no row for a group the port lacks, the counts by
    metric and by sweep."""
    jax = pd.read_csv(ROOT / 'aggr_results' / 'aggr_hyper_params.csv')
    counts = jax['experiment_name'].map(tc.group_of).value_counts()
    assert len(counts) == 24 and set(counts) == {3}
    assert {'bike_mclmc_ev100.0_0.05', 'bike_mclmc_ev0.5_0.1', 'bike_de',
            'bike_nuts_baseline'} <= set(counts.index)
    assert tc.metrics_of(jax) == SIX
    port = jax[jax['experiment_name'].isin(HYPER_PORT)].copy()
    moved = port['experiment_name'] == 'bike_mclmc_wu200000_r1'
    port.loc[moved, 'L_mean'] *= 10
    df, lines = tc.report(port, jax, by_sweep=True)
    pred = df[df['table'] == 'predictive']
    assert sorted(set(pred['experiment_name'])) == sorted(HYPER_PORT)
    assert sorted(set(pred['group'])) == sorted(
        tc.group_of(n) for n in HYPER_PORT)
    assert not df['group'].str.contains('nuts').any()
    assert (df['jax_n'] == 3).all()
    ev100 = pred[pred['group'] == 'bike_mclmc_ev100.0_0.05']
    want = jax[jax['experiment_name'].str.startswith(
        'bike_mclmc_ev100.0_0.05_r')]['step_size_mean']
    assert ev100[ev100['metric'] == 'step_size_mean']['jax_mean'].iloc[0] \
        == pytest.approx(want.mean())
    out = pred[pred['verdict'] == 'outside']
    assert out[['experiment_name', 'metric']].values.tolist() == [
        ['bike_mclmc_wu200000_r1', 'L_mean']]
    # the DE arm's L is NaN in every JAX row: no interval
    assert pred[(pred['group'] == 'bike_de')
                & (pred['metric'] == 'L_mean')]['verdict'].tolist() == [
        'no interval']
    sweeps = [line for line in lines if line.startswith('by sweep: ')]
    assert len(sweeps) == 2
    assert sweeps[0] == ('by sweep: bike_de 0 of 5 (0.2); bike_mclmc_ev 0 '
                         'of 12 (0.6); bike_mclmc_trust 0 of 6 (0.3); '
                         'bike_mclmc_wu 1 of 6 (0.3)')
    assert tc.main(['hyper_params', '--port', str(_write(tmp_path, port)),
                    '--by-sweep']) == 0
    assert 'by sweep: bike_de' in capsys.readouterr().out


DATASIZE_PORT = ['protein_nuts_n5000_r1', 'protein_nuts_n40000_r2',
                 'protein_nuts_n20000_r3', 'protein_mclmc_n5000_r1']


def test_the_nuts_table_holds_the_datasize_nuts_rows(tmp_path, capsys):
    """``datasize``'s NUTS arm: a port study of three real NUTS rows and
    one MCLMC row, one NUTS row's leapfrog steps moved to a depth-10
    tree's. The third table holds the NUTS rows alone against their own
    grid point's three seeds on the three tree statistics; the first
    keeps every row, with the NUTS rows' ε compared and their empty L
    read as no interval."""
    jax = pd.read_csv(ROOT / 'aggr_results' / 'aggr_datasize.csv')
    assert tc.metrics_of(jax, tc.NUTS_STATS) == list(tc.NUTS_STATS)
    port = jax[jax['experiment_name'].isin(DATASIZE_PORT)].copy()
    moved = port['experiment_name'] == 'protein_nuts_n40000_r2'
    port.loc[moved, 'mean_num_integration_steps'] = 1023.0
    df, lines = tc.report(port, jax)
    assert df['table'].unique().tolist() == ['predictive', 'diagnostics',
                                             'nuts']
    nuts = df[df['table'] == 'nuts']
    assert sorted(set(nuts['experiment_name'])) == sorted(
        n for n in DATASIZE_PORT if '_nuts_' in n)
    assert nuts['metric'].unique().tolist() == list(tc.NUTS_STATS)
    assert (nuts['jax_n'] == 3).all()
    assert nuts[nuts['verdict'] == 'outside'][
        ['experiment_name', 'metric']].values.tolist() == [
        ['protein_nuts_n40000_r2', 'mean_num_integration_steps']]
    pred = df[df['table'] == 'predictive']
    assert set(pred['experiment_name']) == set(DATASIZE_PORT)
    tree = pred[pred['experiment_name'].str.contains('_nuts_')]
    assert set(tree[tree['metric'] == 'L_mean']['verdict']) == {
        'no interval'}
    assert set(tree[tree['metric'] == 'step_size_mean']['verdict']) == {
        'inside'}
    title = lines.index('NUTS')
    assert lines[title - 1:title + 2] == ['', 'NUTS', '']
    assert lines[-1] == ('1 of 9 outside their 95 % intervals (0.5 '
                         'expected by chance; mean_num_integration_steps 1)')
    out = tmp_path / 'compare.csv'
    path = tmp_path / 'aggr_datasize.csv'
    port.to_csv(path, index=False)
    assert tc.main(['datasize', '--port', str(path), '--out', str(out)]) == 0
    assert 'NUTS' in capsys.readouterr().out.splitlines()
    assert pd.read_csv(out)['table'].value_counts().to_dict()['nuts'] == 9


@pytest.mark.parametrize('study', ['diagnostics', 'hyper_params',
                                   'datasize'])
def test_a_study_without_port_nuts_rows_compares_as_before(study):
    """A port study of MCLMC and DE rows alone, without the tree
    statistics' columns, where the JAX study has NUTS rows: no
    ``KeyError``, no third table, and (``diagnostics``, ``hyper_params``)
    the committed comparison unchanged line for line."""
    here = ROOT / 'aggr_results_torch' / 'tpu_arithmetic'
    jax = pd.read_csv(ROOT / 'aggr_results' / f'aggr_{study}.csv')
    assert tc.metrics_of(jax, tc.NUTS_STATS)
    port = pd.read_csv(here / f'aggr_{study}.csv')
    port = port[~port['training.sampler.name'].isin(tc.TREE_SAMPLERS)]
    port = port.drop(columns=[c for c in tc.NUTS_STATS
                              if c in port.columns])
    assert not port.empty and tc.tree_rows(port).empty
    df, lines = tc.report(port, jax, by_sweep=study == 'hyper_params')
    assert 'nuts' not in set(df['table']) and 'NUTS' not in lines
    if study != 'datasize':
        md = (here / f'compare_{study}.md').read_text()
        assert md == '\n'.join(lines) + '\n'
        committed = pd.read_csv(here / f'compare_{study}.csv')
        assert df['verdict'].tolist() == committed['verdict'].tolist()


def _write(tmp_path, df) -> Path:
    path = tmp_path / 'aggr_hyper_params.csv'
    df.to_csv(path, index=False)
    return path


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


def test_a_loop_of_several_stages_side_by_side(tmp_path, stub):
    """A spec ``ROOT:STUDY:REGEX:STUDY:REGEX:tpu`` is one loop that runs
    both stages in turn with ``--tpu-arithmetic``, beside a one-stage loop;
    each (root, study) is pooled once."""
    import os

    runner, script, launches = stub
    script(datasize=[0], complexity=[0], diagnostics=[0])
    root = tmp_path / 'root'
    out = tmp_path / 'out'
    env = dict(os.environ, DEVICE='cpu', RUNNER=shlex.join(runner))
    proc = subprocess.run(
        ['bash', str(ROOT / 'experiments' / 'torch_study_side_by_side.sh'),
         str(out), '60',
         f'{root}:datasize:^protein_mclmc_n40000_r1$:complexity:'
         f'^bike_de_8x8x8_r1$:tpu',
         f'{root}:diagnostics:^diag_mclmc_(airfoil|energy)_r[12]$'],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loops = (out / 'loops.txt').read_text().splitlines()
    assert [line.split()[-1] for line in loops[:2]] == ['0', '0']
    calls = {c['only']: c for c in launches()}
    assert sorted(calls) == ['complexity', 'datasize', 'diagnostics']
    assert calls['datasize']['name_filter'] == '^protein_mclmc_n40000_r1$'
    assert calls['complexity']['name_filter'] == '^bike_de_8x8x8_r1$'
    assert (calls['diagnostics']['name_filter']
            == '^diag_mclmc_(airfoil|energy)_r[12]$')
    assert calls['datasize']['tpu_arithmetic']
    assert calls['complexity']['tpu_arithmetic']
    assert not calls['diagnostics']['tpu_arithmetic']
    assert calls['datasize']['job_timeout'] == '7200'
    for study in calls:
        pooled = pd.read_csv(out / 'root' / f'aggr_{study}.csv')
        assert pooled['experiment_name'].tolist() == [f'{study}_job_r1']


def test_the_mixed_studies_timeouts_fit_protein_at_40000_rows():
    """``datasize``'s largest cell (36,000 training rows, 1,125 batches an
    epoch) at 500 epochs of 3.6 ms and 60,000 MCLMC steps at 100 steps/s,
    with room for a host 1.5x slower; ``diagnostics`` and ``complexity``
    run the same steps after smaller warm starts."""
    warm_start = 500 * math.ceil(0.9 * 40_000 / 32) * 3.6e-3
    sampling = (50_000 + 10_000) / 100
    for study in ('diagnostics', 'complexity', 'datasize'):
        assert tq.JOB_TIMEOUT_S[study] >= 1.5 * (warm_start + sampling)


def test_hyper_params_timeout_fits_the_largest_warm_up_budget():
    """``hyper_params``' ``wu200000`` jobs: 200,000 tuner and 10,000
    sampling steps at 100 steps/s after a bikesharing warm start of 500
    epochs of 267 batches at 3.6 ms (a consumer reuses its provider's),
    with room for a host 1.5x slower."""
    warm_start = 500 * math.ceil(0.7 * 12_165 / 32) * 3.6e-3
    sampling = (200_000 + 10_000) / 100
    assert tq.JOB_TIMEOUT_S['hyper_params'] >= 1.5 * (warm_start + sampling)


def test_nuts_ta_timeout_fits_a_depth_10_job():
    """``nuts_ta``: 100 adaptation steps and 1,000 draws of up to 1,023
    batched leaves at the eager airfoil leaf's 132 leaves/s, with room for
    a host 1.5x slower, not the runner's 1,800 s default."""
    leaves = (100 + 1_000) * 1_023
    assert tq.JOB_TIMEOUT_S['nuts_ta'] >= 1.5 * leaves / 132
