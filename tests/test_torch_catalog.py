"""The port's catalogue runner (``experiments/torch_run_catalog.py``)
against the JAX package's (``experiments/run_catalog.py``), on the CPU.

The two build the same 248 jobs, whose configs load to the same values,
and print the same dry run. The queue contract is the JAX runner's, as
``tests/test_catalog_harness.py`` checks it there, with the port's
``BDETrainer`` replaced: two strikes skip a job before a trainer is built,
legacy strike keys count, one strike does not skip, ``STOP`` gives 75 and
is consumed, a done job is skipped, a leftover directory is removed, a
missing warm-start provider runs the job without reuse. The device-fault
classification is CUDA's: CUDA's error texts, cuBLAS's and cuDNN's
statuses, ``torch.AcceleratorError`` and the port's kernel launch error
strike and exit 70; out of memory and a plain error fail the job and the
queue goes on. The watchdog runs in a subprocess. A warm-start provider
and its consumer, cut to a few steps, run end to end, and
``pool_results.pool`` reads their directories with the columns it reads
from a JAX experiment directory of the same cut config.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'experiments'))

import pool_results  # noqa: E402
import run_catalog  # noqa: E402
import summarize_study  # noqa: E402
import torch_run_catalog as cat  # noqa: E402

from mile_tpu_torch.train import trainer as trainer_mod  # noqa: E402

FIELDS = ('study', 'name', 'base', 'overrides', 'warmstart_from')
NUTS_JOB = r'^protein_nuts_n40000_r1$'
# the end-to-end cut: 2,000 rows, a few steps of 2 chains (patience under
# max_epochs: the JAX warm start fails otherwise, ROADMAP queue 3)
E2E_CUT = {'data.datapoint_limit': 2000,
           'training.warmstart.max_epochs': 2,
           'training.warmstart.patience': 1,
           'training.sampler.n_chains': 2,
           'training.sampler.warmup_steps': 30,
           'training.sampler.n_samples': 10,
           'training.sampler.n_thinning': 5}


def test_the_same_248_jobs():
    jax_jobs, jobs = run_catalog.build_jobs(), cat.build_jobs()
    assert len(jobs) == len(jax_jobs) == 248
    for mine, theirs in zip(jobs, jax_jobs):
        assert tuple(getattr(mine, f) for f in FIELDS) \
            == tuple(getattr(theirs, f) for f in FIELDS)


def test_the_job_configs_load_to_the_same_values(tmp_path):
    """One job of each (study, base, overridden fields, reuse), its
    directory and its provider resolved against the same root."""
    seen = set()
    for mine, theirs in zip(cat.build_jobs(), run_catalog.build_jobs()):
        key = (mine.study, mine.base, tuple(sorted(mine.overrides)),
               mine.warmstart_from is None)
        if key in seen:
            continue
        seen.add(key)
        assert mine.exp_dir(tmp_path) == theirs.exp_dir(tmp_path)
        assert mine.warmstart_dir(tmp_path) == theirs.warmstart_dir(tmp_path)
        assert mine.config(tmp_path).to_dict() \
            == theirs.config(tmp_path).to_dict(), mine.name
    assert len(seen) > 25


def test_the_jax_runner_imports_jax_only_inside_main():
    tree = ast.parse((ROOT / 'experiments' / 'run_catalog.py').read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
    assert not any(n.split('.')[0] in ('jax', 'mile_tpu') for n in names)
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == 'main')
    assert any(isinstance(n, ast.Import) and n.names[0].name == 'jax'
               for n in ast.walk(main))


@pytest.mark.parametrize('argv', [
    [],
    ['--only', 'datasize', '--name-filter', 'nuts', '--job-timeout', '5'],
    ['--mclmc-first', '--limit', '40'],
    ['--only', 'feasibility,diagnostics', '--name-filter', 'airfoil'],
])
def test_dry_run_prints_the_jax_lines(argv, tmp_path, monkeypatch, capsys):
    argv = ['--root', str(tmp_path), '--dry-run', *argv]
    monkeypatch.setattr(sys, 'argv', ['run_catalog.py', *argv])
    assert run_catalog.main() == 0
    want = capsys.readouterr().out
    assert cat.main(argv) == 0
    assert capsys.readouterr().out == want
    assert not any(tmp_path.iterdir())


# ------------------------------------------------------------ the queue
def _strikes(root, *records):
    root.mkdir(parents=True, exist_ok=True)
    (root / 'FAULTS.jsonl').write_text(
        ''.join(json.dumps(r) + '\n' for r in records))


def _run(root, *argv):
    return cat.main(['--root', str(root), '--device', 'cpu', *argv])


def _queue(root):
    return [json.loads(line) for line in
            (root / 'queue.jsonl').read_text().splitlines()]


class Boom:
    def __init__(self, *args, **kwargs):
        raise AssertionError('a skipped job must never build a trainer')


class Done:
    """A trainer whose job succeeds at once; records each config."""
    configs = []

    def __init__(self, config, device='cuda'):
        assert device == 'cpu'
        Done.configs.append(config)
        self.config = config

    def train(self, report=True):
        exp = Path(self.config.saving_dir) / self.config.experiment_name
        exp.mkdir(parents=True, exist_ok=True)
        (exp / 'metrics.pkl').write_bytes(b'')
        return {'lppd': -1.0, 'rmse': 0.5}


@pytest.fixture
def done(monkeypatch):
    Done.configs = []
    monkeypatch.setattr(trainer_mod, 'BDETrainer', Done)
    return Done


@pytest.mark.parametrize('records', [
    [{'study': 'datasize', 'job': 'protein_nuts_n40000_r1', 'wall_s': 242.0},
     {'study': 'datasize', 'job': 'protein_nuts_n40000_r1', 'wall_s': 1800.0,
      'hang': True}],
    # legacy entries, keyed by the bare job name, still count
    [{'job': 'protein_nuts_n40000_r1', 'wall_s': 1.0},
     {'study': 'datasize', 'job': 'protein_nuts_n40000_r1', 'wall_s': 2.0}],
], ids=['two strikes', 'legacy key'])
def test_two_strikes_skip_a_job_before_a_trainer(records, tmp_path,
                                                 monkeypatch):
    root = tmp_path / 'catalog'
    _strikes(root, *records)
    monkeypatch.setattr(trainer_mod, 'BDETrainer', Boom)
    assert _run(root, '--only', 'datasize', '--name-filter', NUTS_JOB) == 0
    assert not (root / 'datasize').exists()


def test_one_strike_does_not_skip(tmp_path, monkeypatch):
    root = tmp_path / 'catalog'
    _strikes(root, {'study': 'datasize', 'job': 'protein_nuts_n40000_r1',
                    'wall_s': 242.0})
    ran = []

    class Recorder:
        def __init__(self, config, device='cuda'):
            ran.append(config.experiment_name)
            raise RuntimeError('stop before any device work')

    monkeypatch.setattr(trainer_mod, 'BDETrainer', Recorder)
    assert _run(root, '--only', 'datasize', '--name-filter', NUTS_JOB) == 1
    assert ran == ['protein_nuts_n40000_r1']
    (rec,) = _queue(root)
    assert rec['ok'] is False and 'stop before any device work' in \
        rec['error']


def test_a_stop_file_gives_75_and_is_consumed(tmp_path, monkeypatch):
    root = tmp_path / 'catalog'
    root.mkdir()
    (root / 'STOP').touch()
    monkeypatch.setattr(trainer_mod, 'BDETrainer', Boom)
    assert _run(root, '--only', 'datasize', '--limit', '3') == 75
    assert not (root / 'STOP').exists()
    assert not (root / 'datasize').exists()


def test_done_jobs_are_skipped_and_leftovers_removed(tmp_path, done):
    root = tmp_path / 'catalog'
    first, second = (root / 'datasize' / 'protein_mclmc_n40000_r1',
                     root / 'datasize' / 'protein_nuts_n40000_r1')
    first.mkdir(parents=True)
    (first / 'metrics.pkl').write_bytes(b'')
    second.mkdir(parents=True)
    (second / 'leftover.txt').write_text('from a crashed run')
    assert _run(root, '--only', 'datasize', '--limit', '2') == 0
    assert [c.experiment_name for c in done.configs] == \
        ['protein_nuts_n40000_r1']
    assert not (second / 'leftover.txt').exists()
    (rec,) = _queue(root)
    assert rec['ok'] is True and rec['lppd'] == -1.0
    assert rec['launches'] == {'isokinetic_momentum': 0,
                               'partial_refresh': 0}
    # a second launch over the same root builds no trainer
    done.configs.clear()
    assert _run(root, '--only', 'datasize', '--limit', '2') == 0
    assert done.configs == []


def test_a_missing_provider_runs_the_job_without_reuse(tmp_path, done,
                                                       caplog):
    root = tmp_path / 'catalog'
    with caplog.at_level('ERROR', logger='catalog'):
        assert _run(root, '--only', 'datasize', '--name-filter',
                    NUTS_JOB) == 0
    (config,) = done.configs
    assert config.training.warmstart.warmstart_exp_dir is None
    assert 'provider protein_mclmc_n40000_r1 missing' in caplog.text
    # with the provider's warm start present, the job reuses it
    done.configs.clear()
    (root / 'datasize' / 'protein_nuts_n40000_r1' / 'metrics.pkl').unlink()
    (root / 'datasize' / 'protein_mclmc_n40000_r1' / 'warmstart').mkdir(
        parents=True)
    assert _run(root, '--only', 'datasize', '--name-filter', NUTS_JOB) == 0
    (config,) = done.configs
    assert config.training.warmstart.warmstart_exp_dir == \
        str(root / 'datasize' / 'protein_mclmc_n40000_r1')


def _launch_error():
    """The port's kernel launch error, as ``ops/build.py`` raises it."""
    from mile_tpu_torch.ops import build

    class Library:
        @staticmethod
        def mile_error_string(code):
            return b'an illegal memory access was encountered'

    saved = build.isokinetic_library
    build.isokinetic_library = lambda: Library
    try:
        build.raise_error(700, 'isokinetic_momentum')
    except RuntimeError as exc:
        return exc
    finally:
        build.isokinetic_library = saved


FAULTS = {
    'illegal address': RuntimeError(
        'CUDA error: an illegal memory access was encountered\nCUDA kernel '
        'errors might be asynchronously reported at some other API call'),
    'device-side assert': RuntimeError(
        'CUDA error: device-side assert triggered'),
    'launch failure': RuntimeError('CUDA error: unspecified launch failure'),
    'cuBLAS': RuntimeError('CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when '
                           'calling `cublasSgemmStridedBatched(...)`'),
    'cuDNN': RuntimeError('cuDNN error: CUDNN_STATUS_INTERNAL_ERROR'),
    'AcceleratorError': torch.AcceleratorError('CUDA error: misaligned '
                                               'address'),
    'the port\'s launch error': _launch_error(),
}
NOT_FAULTS = {
    'out of memory': torch.OutOfMemoryError(
        'CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total '
        'capacity of 79.19 GiB of which 1.06 GiB is free.'),
    'a plain error': ValueError('training.sampler: bad value'),
}


def test_the_classification():
    for name, exc in FAULTS.items():
        assert cat.is_device_fault(exc), name
    for name, exc in NOT_FAULTS.items():
        assert not cat.is_device_fault(exc), name
    try:   # a fault raised from inside another error is found
        try:
            raise FAULTS['illegal address']
        except RuntimeError as inner:
            raise ValueError('the report failed') from inner
    except ValueError as outer:
        assert cat.is_device_fault(outer)
    assert 'failed to launch: CUDA error 700' in str(FAULTS[
        'the port\'s launch error'])


def _raising(exc):
    built = []

    class Raising(Done):
        def __init__(self, config, device='cuda'):
            built.append(config.experiment_name)
            super().__init__(config, device)

        def train(self, report=True):
            if len(built) == 1:
                raise exc
            return super().train(report)

    return Raising, built


@pytest.mark.parametrize('name', list(FAULTS))
def test_a_device_fault_strikes_and_exits_70(name, tmp_path, monkeypatch):
    root = tmp_path / 'catalog'
    trainer, built = _raising(FAULTS[name])
    monkeypatch.setattr(trainer_mod, 'BDETrainer', trainer)
    assert _run(root, '--only', 'datasize', '--limit', '2') == 70
    assert built == ['protein_mclmc_n40000_r1']   # the queue stopped
    (strike,) = [json.loads(line) for line in
                 (root / 'FAULTS.jsonl').read_text().splitlines()]
    assert strike['study'] == 'datasize' and \
        strike['job'] == 'protein_mclmc_n40000_r1' and 'hang' not in strike
    (rec,) = _queue(root)
    assert rec['ok'] is False


@pytest.mark.parametrize('name', list(NOT_FAULTS))
def test_other_errors_fail_the_job_and_the_queue_goes_on(name, tmp_path,
                                                         monkeypatch):
    root = tmp_path / 'catalog'
    trainer, built = _raising(NOT_FAULTS[name])
    monkeypatch.setattr(trainer_mod, 'BDETrainer', trainer)
    assert _run(root, '--only', 'datasize', '--limit', '2') == 1
    assert built == ['protein_mclmc_n40000_r1', 'protein_nuts_n40000_r1']
    assert not (root / 'FAULTS.jsonl').exists()
    assert [r['ok'] for r in _queue(root)] == [False, True]


def test_the_watchdog_strikes_a_hang_and_exits_70(tmp_path):
    """A job that sleeps past ``--job-timeout 1`` in a subprocess: the
    watchdog writes a hang strike and a failed record and exits 70."""
    root = tmp_path / 'catalog'
    script = textwrap.dedent(f'''
        import sys, time
        sys.path.insert(0, {str(ROOT / 'experiments')!r})
        import torch_run_catalog as cat
        from mile_tpu_torch.train import trainer

        class Sleeper:
            def __init__(self, config, device='cuda'):
                time.sleep(60)

        trainer.BDETrainer = Sleeper
        sys.exit(cat.main(['--root', {str(root)!r}, '--device', 'cpu',
                           '--only', 'datasize', '--name-filter',
                           {NUTS_JOB!r}, '--job-timeout', '1']))
    ''')
    proc = subprocess.run([sys.executable, '-c', script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 70, proc.stderr[-2000:]
    (strike,) = [json.loads(line) for line in
                 (root / 'FAULTS.jsonl').read_text().splitlines()]
    assert strike['hang'] is True and strike['job'] == \
        'protein_nuts_n40000_r1' and strike['wall_s'] >= 1.0
    (rec,) = _queue(root)
    assert rec == {'job': 'protein_nuts_n40000_r1', 'study': 'datasize',
                   'ok': False, 'wall_s': rec['wall_s'], 'error': 'hang'}


def test_the_default_device_raises_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(trainer_mod, 'BDETrainer', Boom)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cat.main(['--root', str(tmp_path), '--only', 'datasize'])
    assert not any(tmp_path.iterdir())


# ---------------------------------------------------------- end to end
def _cut(job):
    return dataclasses.replace(job, overrides={**job.overrides, **E2E_CUT})


@pytest.fixture(scope='module')
def jax_pooled(tmp_path_factory):
    """``pool_results.pool`` over the JAX trainer's directory of the
    provider's cut config (through the JAX runner's job)."""
    from mile_tpu.train.trainer import BDETrainer

    root = tmp_path_factory.mktemp('jax_catalog')
    (job,) = [j for j in run_catalog.build_jobs()
              if j.name == 'bike_mclmc_ev0.5_0.1_r1']
    job.overrides = {**job.overrides, **E2E_CUT}
    BDETrainer(job.config(root)).train(report=True)
    return pool_results.pool(root)


def test_a_provider_and_its_consumer_end_to_end(tmp_path, jax_pooled):
    """``hyper_params/bike_mclmc_ev0.5_0.1_r1`` and its consumer
    ``bike_mclmc_trust2.0_r1``, cut, through ``run_queue`` on the CPU:
    both ok with finite metrics and tuned values, the consumer's members
    equal the provider's bit for bit, and the pooled table has the JAX
    directory's columns, one row per job."""
    root = tmp_path / 'catalog'
    jobs = [_cut(j) for j in cat.build_jobs() if j.name in
            ('bike_mclmc_ev0.5_0.1_r1', 'bike_mclmc_trust2.0_r1')]
    assert cat.run_queue(jobs, root, device='cpu') == 0
    records = _queue(root)
    assert [r['ok'] for r in records] == [True, True]
    assert all(np.isfinite(r['lppd']) for r in records)
    provider, consumer = (root / 'hyper_params' / j.name for j in jobs)
    for i in range(2):
        a = np.load(provider / 'warmstart' / f'params_{i}.npz')
        b = np.load(consumer / 'warmstart' / f'params_{i}.npz')
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    df = pool_results.pool(root)
    assert len(df) == 2
    assert sorted(df.columns) == sorted(jax_pooled.columns)
    assert np.isfinite(df['lppd']).all() and (df['time.sampling'] > 0).all()
    assert np.isfinite(df[['step_size_mean', 'L_mean']]).all(axis=None)
    table = summarize_study.summarize(
        df, ['experiment_name'], ['lppd', 'step_size_mean', 'L_mean'])
    assert 'bike_mclmc_trust2.0_r1' in table and '| n |' in table


@pytest.mark.parametrize('name,warmup', [
    ('airfoil_mclmc_f32def_r1', None),      # names None itself
    ('airfoil_mclmc_f32tune_r1', 'float32'),
    ('airfoil_mclmc_f32strict_r1', None),   # the JAX rows' default then
])
def test_the_tpu_arithmetic_gives_the_jax_rows_tuner(name, warmup,
                                                     tmp_path):
    """Under ``--tpu-arithmetic`` a job that names no tuner precision gets
    None, the JAX package's default when its pooled rows were taken; one
    that names it keeps it. Without the flag the port's default stays."""
    (job,) = [j for j in cat.build_jobs() if j.name == name]
    tpu = job.config(tmp_path, tpu_arithmetic=True).training.sampler
    assert tpu.warmup_matmul_precision == warmup
    assert tpu.matmul_precision == job.overrides.get(
        'training.sampler.matmul_precision')
    plain = job.config(tmp_path).training.sampler
    assert plain.warmup_matmul_precision == job.overrides.get(
        'training.sampler.warmup_matmul_precision', 'float32')


def test_a_job_under_the_tpu_arithmetic_records_it(tmp_path):
    """One cut job through ``run_queue(tpu_arithmetic=True)`` on the CPU:
    its config.yaml and its pooled row say ``none_precision: bfloat16``,
    its tuner ran at None, and the process's setting is restored."""
    import yaml

    from mile_tpu_torch.utils import precision

    root = tmp_path / 'catalog'
    jobs = [_cut(j) for j in cat.build_jobs()
            if j.name == 'uci_mclmc_yacht_r1']
    assert cat.run_queue(jobs, root, device='cpu', tpu_arithmetic=True) == 0
    assert precision.none_precision() == 'float32'
    exp = root / 'dataset' / 'uci_mclmc_yacht_r1'
    written = yaml.safe_load((exp / 'config.yaml').read_text())
    assert written['none_precision'] == 'bfloat16'
    assert written['training']['sampler']['warmup_matmul_precision'] is None
    assert 'matmul=bfloat16' in (exp / 'training.log').read_text()
    (row,) = pool_results.pool(root).to_dict('records')
    assert row['none_precision'] == 'bfloat16' and np.isfinite(row['lppd'])


# ------------------------------------------- every job at its row's settings
# What a pooled JAX row records of the settings its sampler read, by
# sampler: the dotted config paths, as the row's columns name them.
ROW_SETTINGS = ('training.sampler.name', 'training.sampler.warmup_steps',
                'training.sampler.n_samples', 'training.sampler.n_chains',
                'training.sampler.n_thinning',
                'training.sampler.step_size_init', 'data.datapoint_limit',
                'model.hidden_structure', 'rng')
ROW_SETTINGS_BY_SAMPLER = {
    'nuts': ('training.sampler.target_acceptance',
             'training.sampler.max_num_doublings',
             'training.sampler.warmup_max_num_doublings'),
    'mclmc': ('training.sampler.desired_energy_var_start',
              'training.sampler.desired_energy_var_end',
              'training.sampler.trust_in_estimate',
              'training.sampler.num_effective_samples')}
ROW_STUDIES = ('tabular_classif', 'hyper_params', 'complexity', 'datasize',
               'dtype_ab', 'nuts_ta', 'dataset', 'feasibility',
               'diagnostics')
# the uncapped NUTS jobs, whose rows were taken at a target acceptance of
# 0.8 (``cat.TPU_ROWS_NUTS``)
NUTS_AT_08 = {'complexity': 9, 'diagnostics': 9, 'hyper_params': 3}


def _setting(config: dict, path: str):
    for key in path.split('.'):
        config = config[key]
    return config


def _recorded(value) -> bool:
    """An empty cell of a pooled row is a setting it did not record."""
    return not (value is None or (isinstance(value, float)
                                  and np.isnan(value)))


def _same(mine, recorded) -> bool:
    if isinstance(mine, list):
        return str(mine) == str(recorded)
    if isinstance(mine, str) or isinstance(recorded, str):
        return str(mine) == str(recorded)
    return mine is not None and bool(np.isclose(float(mine),
                                                float(recorded)))


def row_mismatches(study: str, root: Path, tpu_arithmetic: bool = True):
    """(jobs of ``study`` with a JAX row, [(job, setting, the job's value,
    the row's)] for every recorded setting its sampler reads that the
    job's config does not give)."""
    import pandas as pd

    rows = pd.read_csv(ROOT / 'aggr_results' / f'aggr_{study}.csv'
                       ).set_index('experiment_name')
    jobs = [j for j in cat.build_jobs()
            if j.study == study and j.name in rows.index]
    wrong = []
    for job in jobs:
        config = job.config(root, tpu_arithmetic).to_dict()
        row = rows.loc[job.name]
        sampler = _setting(config, 'training.sampler.name')
        for path in ROW_SETTINGS + ROW_SETTINGS_BY_SAMPLER.get(sampler, ()):
            if path in row.index and _recorded(row[path]) \
                    and not _same(_setting(config, path), row[path]):
                wrong.append((job.name, path, _setting(config, path),
                              row[path]))
    return jobs, wrong


@pytest.mark.parametrize('study', ROW_STUDIES)
def test_every_job_runs_at_its_rows_settings(study, tmp_path):
    """Under ``--tpu-arithmetic`` each catalogue job with a pooled JAX row
    loads with every setting that row records of what its sampler reads:
    name, warm-up steps, draws, chains, thinning, initial step size, data
    limit, widths and seed; for NUTS the target acceptance and both depth
    caps; for MCLMC the energy-variance, trust and ESS knobs."""
    jobs, wrong = row_mismatches(study, tmp_path)
    assert jobs
    assert wrong == []


def test_244_jobs_have_a_row_to_hold_them_to(tmp_path):
    import pandas as pd

    names = {s: set(pd.read_csv(ROOT / 'aggr_results' / f'aggr_{s}.csv')
                    ['experiment_name']) for s in ROW_STUDIES}
    assert sum(j.name in names.get(j.study, ()) for j in cat.build_jobs()) \
        == 244


@pytest.mark.parametrize('study', sorted(NUTS_AT_08))
def test_without_the_tpu_arithmetic_the_nuts_jobs_load_at_0_9(study,
                                                              tmp_path):
    """Without ``--tpu-arithmetic`` the uncapped NUTS jobs load as the JAX
    runner's do, at the default of 0.9, and differ from their rows in the
    target acceptance alone; the depth-capped and ``nuts_ta`` jobs keep
    theirs either way."""
    jobs, wrong = row_mismatches(study, tmp_path, tpu_arithmetic=False)
    assert {w[1] for w in wrong} == {'training.sampler.target_acceptance'}
    assert len(wrong) == NUTS_AT_08[study]
    assert all((w[2], w[3]) == (0.9, 0.8) for w in wrong)
    by_name = {j.name: j for j in run_catalog.build_jobs()}
    for job in jobs:
        if job.name in {w[0] for w in wrong}:
            assert job.config(tmp_path).to_dict() == by_name[
                job.name].config(tmp_path).to_dict()
    for name in ('protein_nuts_n5000_r1', 'bike_nuts_48x48x48_r1',
                 'bike_nuts_ta95_r1'):
        (job,) = [j for j in cat.build_jobs() if j.name == name]
        assert job.config(tmp_path).training.sampler.target_acceptance \
            == job.config(tmp_path, tpu_arithmetic=True
                          ).training.sampler.target_acceptance
