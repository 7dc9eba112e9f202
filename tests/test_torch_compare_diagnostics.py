"""The chain diagnostics of a pooled study, on the CPU.

``experiments/torch_compare_study.py`` holds the port's ``DIAGNOSTICS``
(``mean_ess``, ``mean_split_rhat``, ``mean_bcv``, ``mean_wcv``,
``fs_ess``, ``fs_split_rhat``) against the JAX seeds' intervals in a
table and count line of their own, on hand-made frames: inside, outside,
a group whose JAX seeds are all NaN (no interval), ``running_lppd_mean``
never compared, and a ``KeyError`` when the port lacks a diagnostic that
the JAX study has. The committed comparisons of the seven studies run at
the TPU's arithmetic hold both tables as the script writes them.

Then where those columns come from: one cut ``tabular_classif/
sonar_mclmc_r1`` run of the port on the CPU, its draws diagnosed by both
packages (the JAX package's ``per_param_diagnostics`` and
``compute_diagnostics`` with the template of ``_rebuild_model``, the
port's with its ``layout.json``): the same rows of ``diagnostics.csv``,
by name and ``n_coords``, with the same values to rtol 1e-4, and so the
same pooled ``mean_*`` columns.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from _torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'experiments'))

import pool_results  # noqa: E402
import torch_compare_study as tc  # noqa: E402
import torch_run_catalog as cat  # noqa: E402

TPU_AGGR = ROOT / 'aggr_results_torch' / 'tpu_arithmetic'
STUDIES = ('dataset', 'dtype_ab', 'tabular_classif', 'feasibility',
           'diagnostics', 'complexity', 'datasize')
SONAR_CUT = {'training.warmstart.max_epochs': 2,
             'training.sampler.warmup_steps': 60,
             'training.sampler.n_samples': 64}


def _study(tmp_path):
    """A JAX study of two groups x 3 seeds with one metric and every
    diagnostic, and a port study of one seed each: airfoil's mean_ess
    inside, its mean_wcv outside, concrete's fs_ess with no interval (all
    three JAX seeds NaN), running_lppd_mean -inf on both sides."""
    names = ('lppd', *tc.DIAGNOSTICS, 'running_lppd_mean')
    jax_rows = []
    for group, base in (('uci_mclmc_airfoil', 1.0),
                        ('uci_mclmc_concrete', 10.0)):
        for seed, delta in ((1, -1.0), (2, 0.0), (3, 1.0)):
            row = {m: base + delta for m in names}
            row.update(experiment_name=f'{group}_r{seed}',
                       running_lppd_mean=-math.inf)
            if group == 'uci_mclmc_concrete':
                row['fs_ess'] = math.nan
            jax_rows.append(row)
    port_rows = [
        {'experiment_name': 'uci_mclmc_airfoil_r1',
         **{m: 1.0 for m in names}, 'mean_ess': 5.9, 'mean_wcv': 7.0,
         'running_lppd_mean': -math.inf},
        {'experiment_name': 'uci_mclmc_concrete_r1',
         **{m: 10.0 for m in names}, 'running_lppd_mean': -math.inf}]
    jax_csv, port_csv = tmp_path / 'jax.csv', tmp_path / 'port.csv'
    pd.DataFrame(jax_rows).to_csv(jax_csv, index=False)
    pd.DataFrame(port_rows).to_csv(port_csv, index=False)
    return jax_csv, port_csv


def test_the_diagnostics_are_compared_as_the_metrics_are(tmp_path):
    jax_csv, port_csv = _study(tmp_path)
    jax, port = pd.read_csv(jax_csv), pd.read_csv(port_csv)
    assert tc.metrics_of(jax, tc.DIAGNOSTICS) == list(tc.DIAGNOSTICS)
    assert tc.metrics_of(jax) == ['lppd']
    df = tc.compare(port, jax, tc.DIAGNOSTICS)
    assert len(df) == 2 * len(tc.DIAGNOSTICS)
    verdict = df.set_index(['experiment_name', 'metric'])['verdict']
    assert verdict['uci_mclmc_airfoil_r1', 'mean_ess'] == 'inside'  # 5.9
    assert verdict['uci_mclmc_airfoil_r1', 'mean_wcv'] == 'outside'  # 7.0
    assert verdict['uci_mclmc_concrete_r1', 'fs_ess'] == 'no interval'
    assert (verdict == 'outside').sum() == 1
    assert tc.summary(df, by_metric=True) == (
        '1 of 11 outside their 95 % intervals (0.6 expected by chance; '
        'mean_wcv 1)')


def test_running_lppd_mean_is_never_compared(tmp_path):
    jax_csv, port_csv = _study(tmp_path)
    df, _ = tc.report(pd.read_csv(port_csv), pd.read_csv(jax_csv))
    assert 'running_lppd_mean' not in set(df['metric'])
    assert 'running_lppd_mean' not in tc.METRICS + tc.DIAGNOSTICS


def test_the_diagnostics_have_their_own_table_and_count_line(tmp_path,
                                                            capsys):
    jax_csv, port_csv = _study(tmp_path)
    out = tmp_path / 'compare.csv'
    assert tc.main(['dataset', '--port', str(port_csv), '--jax',
                    str(jax_csv), '--out', str(out)]) == 0
    printed = capsys.readouterr().out.splitlines()
    first = printed.index('0 of 2 outside their 95 % intervals (0.1 '
                          'expected by chance)')
    assert printed[first + 1:first + 4] == ['', 'Chain diagnostics', '']
    assert printed[-1] == ('1 of 11 outside their 95 % intervals (0.6 '
                           'expected by chance; mean_wcv 1)')
    assert ('| uci_mclmc_airfoil_r1 | mean_wcv | 7 | 0 | '
            in '\n'.join(printed))
    written = pd.read_csv(out)
    assert written['table'].value_counts().to_dict() == {
        'predictive': 2, 'diagnostics': 12}


def test_a_port_without_a_diagnostic_raises(tmp_path):
    jax_csv, port_csv = _study(tmp_path)
    port = pd.read_csv(port_csv).drop(columns=['fs_split_rhat'])
    with pytest.raises(KeyError, match='fs_split_rhat'):
        tc.compare(port, pd.read_csv(jax_csv), tc.DIAGNOSTICS)
    with pytest.raises(KeyError, match='fs_split_rhat'):
        tc.report(port, pd.read_csv(jax_csv))


def test_the_value_mode_counts_diagnostics_without_lppd():
    """One run a job (``feasibility``): the diagnostics' count line has no
    LPPD part."""
    jax = pd.read_csv(ROOT / 'aggr_results' / 'aggr_feasibility.csv')
    port = jax.copy()
    port.loc[port['experiment_name'] == 'feas_mclmc_bikesharing',
             'mean_ess'] = math.nan
    df = tc.compare_values(port, jax, tc.DIAGNOSTICS)
    assert tc.summary_values(df) == '1 of 84 values differ (mean_ess 1)'


@pytest.mark.parametrize('study', STUDIES)
def test_the_committed_comparisons_hold_both_tables(study):
    """``aggr_results_torch/tpu_arithmetic/compare_<study>.{csv,md}`` are
    what the script gives on the committed pooled CSVs."""
    df, lines = tc.report(pd.read_csv(TPU_AGGR / f'aggr_{study}.csv'),
                          pd.read_csv(ROOT / 'aggr_results' /
                                      f'aggr_{study}.csv'))
    committed = pd.read_csv(TPU_AGGR / f'compare_{study}.csv')
    assert df['table'].tolist() == committed['table'].tolist()
    assert df['verdict'].tolist() == committed['verdict'].tolist()
    assert set(df[df['table'] == 'diagnostics']['metric']) == set(
        tc.DIAGNOSTICS)
    md = (TPU_AGGR / f'compare_{study}.md').read_text()
    assert md == '\n'.join(lines) + '\n'


# ------------------------------------------- diagnostics.csv of both packages
@pytest.fixture(scope='module')
def sonar_run(tmp_path_factory):
    """The port's ``sonar_mclmc_r1`` cut to SONAR_CUT (12 chains, dim
    1,282, 16 kept draws a chain) through ``run_queue`` on the CPU."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp('sonar')
    (job,) = [dataclasses.replace(j, overrides={**j.overrides, **SONAR_CUT})
              for j in cat.build_jobs() if j.name == 'sonar_mclmc_r1']
    try:
        assert cat.run_queue([job], root, device='cpu') == 0
    finally:
        torch.set_num_threads(prev)
    return job.exp_dir(root)


def test_both_packages_write_the_same_diagnostics_rows(sonar_run):
    from mile_tpu.config import Config as JaxConfig
    from mile_tpu.inference import reporting as jax_reporting

    from mile_tpu_torch.inference import reporting
    from mile_tpu_torch.train import checkpoint as ckpt

    samples = ckpt.load_flat_samples(sonar_run / 'samples')
    assert samples.shape == (12, 16, 1282)
    (jax_cfg,) = JaxConfig.from_file(sonar_run / 'config.yaml')
    template = jax_reporting._rebuild_model(jax_cfg)[2]
    jax_rows = jax_reporting.compute_diagnostics(
        samples, template, jax_reporting.per_param_diagnostics(samples))
    layout = ckpt.load_layout(sonar_run / 'samples')
    port_rows = reporting.compute_diagnostics(samples, layout, device='cpu')
    written = pd.read_csv(sonar_run / 'diagnostics.csv').set_index('layer')

    names = [f"['fcn']['layer{i}']['{leaf}']" for i in range(3)
             for leaf in ('bias', 'kernel')]
    assert list(jax_rows) == list(port_rows) == list(written.index) == names
    for name in names:
        for key in ('n_coords', 'layer_size'):
            assert jax_rows[name][key] == port_rows[name][key] \
                == written.at[name, key]
        for key in ('ess', 'split_rhat', 'bcv', 'wcv'):
            np.testing.assert_allclose(port_rows[name][key],
                                       jax_rows[name][key], rtol=1e-4)
            np.testing.assert_allclose(written.at[name, key],
                                       jax_rows[name][key], rtol=1e-4)
    assert [jax_rows[n]['n_coords'] for n in names] == [16, 960, 16, 256,
                                                        2, 32]
    (pooled,) = pool_results.pool(sonar_run.parent).to_dict('records')
    for key in ('ess', 'split_rhat', 'bcv', 'wcv'):
        np.testing.assert_allclose(
            pooled[f'mean_{key}'],
            np.mean([jax_rows[n][key] for n in names]), rtol=1e-4)
