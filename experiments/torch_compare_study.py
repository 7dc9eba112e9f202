#!/usr/bin/env python3
"""The PyTorch port's pooled study held against the JAX package's.

    python experiments/torch_compare_study.py STUDY
        [--port aggr_results_torch/tpu_arithmetic/aggr_STUDY.csv]
        [--jax aggr_results/aggr_STUDY.csv] [--out FILE.csv] [--by-sweep]
        [--by-target]

Reads both pooled CSVs (``experiments/pool_results.py``'s rows), joined on
``experiment_name``. The metrics compared are those of ``METRICS``
(``lppd``, ``rmse``, ``acc``, ``cal_error``, ``coverage_0.9``,
``step_size_mean``, ``L_mean``) that the JAX CSV has with a finite value
in some row: the six but ``acc`` for a regression study such as
``dataset``, ``lppd``, ``acc``, ε and L for ``tabular_classif``. A metric
the JAX CSV has and the port's lacks raises a ``KeyError``: the port's
pooled columns are the JAX package's. The two runtimes draw from
different generators (Threefry and Philox), so no draw, and no metric,
can match; the comparison is statistical, in one of two modes.

Seeds (a study whose jobs are named ``<group>_r<seed>``, e.g.
``uci_mclmc_airfoil_r1``, a group being one dataset's or grid point's
seeds). For each group and metric:

- m and s are the mean and sample standard deviation (ddof 1) of the JAX
  seeds' values, n their count (2 to 11);
- the 95 % prediction interval for one new run is
  m ± t(0.975, n - 1) · s · √(1 + 1/n): m ± 4.97 s for three seeds,
  m ± 2.776 · s · √1.2 for five;
- each port row of the group is printed with its value, the JAX value of
  the same name, the interval, and ``inside`` or ``outside`` (a value that
  is not finite is outside).

The table's count line gives the values outside against the count
expected by chance, 5 % of those compared. With ``--by-sweep`` a line
after it counts them by sweep, a grid point's group without its trailing
values (``bike_mclmc_ev100.0_0.05`` and ``bike_mclmc_ev0.5_0.1`` are the
sweep ``bike_mclmc_ev``; ``bike_mclmc_wu200000`` is ``bike_mclmc_wu``;
``bike_de`` is its own), each against its chance.

Values (a study with one run a job, such as ``feasibility``: no group has
two rows, so there is no interval). Each port job with a JAX row of its
name gets, per metric, ``both finite``, ``both fail`` or ``differ``: a
value fails when it is not finite, and an ε (``step_size_mean``) also
when it is below 1e-6, a step that moves no float32 weight. Where both
are finite the port/JAX ratio is printed. The table's count line gives
the jobs whose ``lppd`` finiteness agrees and the values that differ, by
metric.

Chain diagnostics. The chains' own statistics are compared the same way,
in a second table with its own count line (and, in the seeds mode, the
count by metric): those of ``DIAGNOSTICS`` that the JAX study has with a
finite value in some row. ``mean_ess``, ``mean_split_rhat``,
``mean_bcv`` and ``mean_wcv`` are the unweighted means over the rows of
each job's ``diagnostics.csv`` (one row per leaf of the flat parameter
vector, ``pool_results.py``); ``fs_ess`` and ``fs_split_rhat`` are the
evaluation's function-space ESS and split R-hat of the predictions. A
group whose JAX seeds are all NaN (the DE arm's L, the draws of a run
whose ε collapsed) has no interval, as in the first table.
``running_lppd_mean`` is left out: the mean over draws of the running
LPPD is -inf in both packages' rows whenever a first draw's predictive
density underflows (12 of the 18 ``dataset`` rows in each package), so it
reads the first draw and not the chains. A diagnostic the JAX CSV has and
the port's lacks raises a ``KeyError``, as a metric does.

NUTS. The trees' own statistics, ``NUTS_STATS`` (``mean_acceptance_rate``,
``mean_num_integration_steps``: leapfrog steps a draw, and
``n_divergent``: divergent steps over all chains and draws, as
``pool_results.py`` folds them from ``samples/info.pkl``), are compared
the same way in a third table with its own count line by metric, over
the port rows whose sampler is NUTS or HMC only; a study whose port rows
have none (all MCLMC or DE) has no third table and needs none of its
columns. NUTS rows stay in the first table for ``step_size_mean``; their
``L_mean`` is empty in both packages, which reads as no interval.

With ``--by-target`` (the ``nuts_ta`` study's own finding: divergences
fall as the target acceptance rises) a last table gives, for each target
acceptance of the NUTS and HMC rows of either package, each package's
runs and their mean ``n_divergent``, ``mean_acceptance_rate`` and
``mean_num_integration_steps``.

With ``--out`` the tables go to one CSV, told apart by its ``table``
column (``predictive``, ``diagnostics``, ``nuts`` or ``by_target``).

The script reports and gates nothing: it exits 0 whatever the verdicts.
It imports numpy and pandas only, so it runs anywhere.
"""
from __future__ import annotations

import argparse
import math
import re
import sys
from pathlib import Path

import numpy as np
import pandas as pd

ROOT = Path(__file__).resolve().parent.parent
METRICS = ('lppd', 'rmse', 'acc', 'cal_error', 'coverage_0.9',
           'step_size_mean', 'L_mean')
DIAGNOSTICS = ('mean_ess', 'mean_split_rhat', 'mean_bcv', 'mean_wcv',
               'fs_ess', 'fs_split_rhat')
NUTS_STATS = ('mean_acceptance_rate', 'mean_num_integration_steps',
              'n_divergent')
TREE_SAMPLERS = ('nuts', 'hmc')
TARGET = 'training.sampler.target_acceptance'
BY_TARGET_STATS = ('n_divergent', 'mean_acceptance_rate',
                   'mean_num_integration_steps')
SEED = re.compile(r'_r\d+$')
SWEEP = re.compile(r'\d[\d.x_]*$')
# Student's t, 0.975 quantile, by degrees of freedom
T975 = {1: 12.706204736174694, 2: 4.302652729749462, 3: 3.1824463052837078,
        4: 2.7764451051977934, 5: 2.5705818356363146, 6: 2.4469118511449786,
        7: 2.364624251592784, 8: 2.306004135204166, 9: 2.262157162798205,
        10: 2.228138851986274}
CHANCE = 0.05
EPS_FAILS_BELOW = 1e-6


def group_of(name: str) -> str:
    return SEED.sub('', name)


def sweep_of(group: str) -> str:
    """A grid point's sweep: its group without its trailing values."""
    return SWEEP.sub('', group)


def prediction_interval(values) -> tuple[float, float, float, float]:
    """(m, s, lo, hi) of the 95 % prediction interval for one new draw
    from the distribution of ``values`` (NaNs dropped); NaN bounds with
    fewer than two values."""
    v = np.asarray(values, dtype=np.float64)
    v = v[np.isfinite(v)]
    if len(v) < 2:
        return (float(v.mean()) if len(v) else math.nan, math.nan,
                math.nan, math.nan)
    m, s = float(v.mean()), float(v.std(ddof=1))
    half = T975[len(v) - 1] * s * math.sqrt(1 + 1 / len(v))
    return m, s, m - half, m + half


def metrics_of(jax: pd.DataFrame, candidates=METRICS) -> list[str]:
    """The metrics of ``candidates`` (``METRICS`` or ``DIAGNOSTICS``) that
    the JAX study has with a finite value in some row, in their order."""
    return [m for m in candidates if m in jax.columns
            and np.isfinite(pd.to_numeric(jax[m], errors='coerce')).any()]


def one_run_a_job(jax: pd.DataFrame) -> bool:
    """Whether no group of the JAX study has two rows (value mode)."""
    return int(jax['experiment_name'].map(group_of).value_counts().max()) < 2


def tree_rows(port: pd.DataFrame) -> pd.DataFrame:
    """The port rows whose sampler is NUTS or HMC (none when the pooled
    CSV does not name its samplers)."""
    if 'training.sampler.name' not in port.columns:
        return port.iloc[:0]
    return port[port['training.sampler.name'].isin(TREE_SAMPLERS)]


def _check_columns(port: pd.DataFrame, metrics) -> None:
    missing = [m for m in ('experiment_name', *metrics)
               if m not in port.columns]
    if missing:
        raise KeyError(f'the port\'s pooled CSV lacks the JAX columns '
                       f'{missing}')


def compare(port: pd.DataFrame, jax: pd.DataFrame,
            metrics=None) -> pd.DataFrame:
    """One row per (port row, metric): the values, the JAX seeds' interval
    and the verdict; ``metrics`` defaults to :func:`metrics_of` the JAX
    study."""
    metrics = metrics_of(jax) if metrics is None else list(metrics)
    _check_columns(port, metrics)
    jax = jax.assign(group=jax['experiment_name'].map(group_of))
    jax_by_name = jax.set_index('experiment_name')
    rows = []
    for name in sorted(port['experiment_name']):
        group = group_of(name)
        seeds = jax[jax['group'] == group]
        port_row = port[port['experiment_name'] == name].iloc[0]
        for metric in metrics:
            m, s, lo, hi = prediction_interval(seeds[metric])
            value = float(port_row[metric])
            if not math.isfinite(lo):
                verdict = 'no interval'
            elif math.isfinite(value) and lo <= value <= hi:
                verdict = 'inside'
            else:
                verdict = 'outside'
            rows.append({
                'experiment_name': name, 'group': group, 'metric': metric,
                'port': value,
                'jax_same_name': (float(jax_by_name.at[name, metric])
                                  if name in jax_by_name.index else math.nan),
                'jax_mean': m, 'jax_sd': s, 'jax_n': int(len(seeds)),
                'lo': lo, 'hi': hi, 'verdict': verdict})
    return pd.DataFrame(rows)


def fails(metric: str, value: float) -> bool:
    """A value that shows a failed run: not finite, or an ε below
    ``EPS_FAILS_BELOW``."""
    return not math.isfinite(value) or (metric == 'step_size_mean'
                                        and value < EPS_FAILS_BELOW)


def compare_values(port: pd.DataFrame, jax: pd.DataFrame,
                   metrics=None) -> pd.DataFrame:
    """One row per (port job with a JAX row of its name, metric): both
    values, the verdict (``both finite``, ``both fail``, ``differ``) and
    the port/JAX ratio where both are finite; ``metrics`` defaults to
    :func:`metrics_of` the JAX study."""
    metrics = metrics_of(jax) if metrics is None else list(metrics)
    _check_columns(port, metrics)
    jax_by_name = jax.set_index('experiment_name')
    rows = []
    for name in sorted(port['experiment_name']):
        if name not in jax_by_name.index:
            continue
        port_row = port[port['experiment_name'] == name].iloc[0]
        for metric in metrics:
            value = float(port_row[metric])
            ref = float(jax_by_name.at[name, metric])
            failed = (fails(metric, value), fails(metric, ref))
            verdict = ('both fail' if all(failed) else
                       'both finite' if not any(failed) else 'differ')
            rows.append({
                'experiment_name': name, 'metric': metric, 'port': value,
                'jax': ref, 'verdict': verdict,
                'ratio': (value / ref if verdict == 'both finite'
                          and ref != 0 else math.nan)})
    return pd.DataFrame(rows)


def table_values(df: pd.DataFrame) -> str:
    lines = ['| run | metric | port | JAX | verdict | port/JAX |',
             '|---|---|---|---|---|---|']
    for r in df.itertuples():
        lines.append(f'| {r.experiment_name} | {r.metric} | {r.port:.6g} | '
                     f'{r.jax:.6g} | {r.verdict} | {r.ratio:.4g} |')
    return '\n'.join(lines)


def _by_metric(rows: pd.DataFrame, order=None) -> str:
    """``'metric n, ...'``: the rows' count by metric, in ``order`` (by
    default in the order the metrics first appear)."""
    counts = rows['metric'].value_counts(sort=False)
    if order is not None:
        counts = counts.reindex([m for m in order if m in counts.index])
    return ', '.join(f'{m} {n}' for m, n in counts.items())


def summary_values(df: pd.DataFrame) -> str:
    """The value mode's count line: the jobs whose ``lppd`` finiteness
    agrees (when ``lppd`` was compared) and the values that differ."""
    differ = df[df['verdict'] == 'differ']
    by_metric = _by_metric(differ)
    line = (f'{len(differ)} of {len(df)} values differ'
            + (f' ({by_metric})' if by_metric else ''))
    lppd = df[df['metric'] == 'lppd']
    if lppd.empty:
        return line
    agree = int((lppd['verdict'] != 'differ').sum())
    jobs = df['experiment_name'].nunique()
    return f'lppd finiteness agrees in {agree} of {jobs} jobs; {line}'


def table(df: pd.DataFrame) -> str:
    lines = ['| run | metric | port | JAX, same name | JAX interval (95 %) '
             '| verdict |', '|---|---|---|---|---|---|']
    for r in df.itertuples():
        lines.append(f'| {r.experiment_name} | {r.metric} | {r.port:.6g} | '
                     f'{r.jax_same_name:.6g} | [{r.lo:.6g}, {r.hi:.6g}] | '
                     f'{r.verdict} |')
    return '\n'.join(lines)


def summary(df: pd.DataFrame, by_metric: bool = False) -> str:
    """The seeds mode's count line: the values outside against chance,
    and with ``by_metric`` the count outside of each metric."""
    compared = int((df['verdict'] != 'no interval').sum())
    outside = df[df['verdict'] == 'outside']
    counts = (_by_metric(outside, df['metric'].unique()) if by_metric
              else '')
    return (f'{len(outside)} of {compared} outside their 95 % intervals '
            f'({CHANCE * compared:.1f} expected by chance'
            + (f'; {counts}' if counts else '') + ')')


def summary_sweeps(df: pd.DataFrame) -> str:
    """The seeds mode's count by sweep: each sweep's values outside of
    those compared, against chance."""
    compared = df[df['verdict'] != 'no interval']
    parts = []
    for sweep, rows in compared.groupby(compared['group'].map(sweep_of),
                                        sort=True):
        outside = int((rows['verdict'] == 'outside').sum())
        parts.append(f'{sweep} {outside} of {len(rows)} '
                     f'({CHANCE * len(rows):.1f})')
    return 'by sweep: ' + '; '.join(parts)


def report(port: pd.DataFrame, jax: pd.DataFrame, by_sweep: bool = False
           ) -> tuple[pd.DataFrame, list[str]]:
    """The tables of a study: (the comparison, its ``table`` column
    naming ``predictive``, ``diagnostics`` or ``nuts`` rows; the printed
    lines). A table is left out when the JAX study has none of its
    columns, and the NUTS table also when no port row is NUTS or HMC.
    ``by_sweep``: each seeds-mode count line is followed by the count by
    sweep."""
    values = one_run_a_job(jax)
    frames, lines = [], []
    for name, candidates, rows, title in (
            ('predictive', METRICS, port, None),
            ('diagnostics', DIAGNOSTICS, port, 'Chain diagnostics'),
            ('nuts', NUTS_STATS, tree_rows(port), 'NUTS')):
        metrics = metrics_of(jax, candidates)
        if not metrics or (name == 'nuts' and rows.empty):
            continue
        if title:
            lines += ['', title, '']
        if values:
            df = compare_values(rows, jax, metrics)
            lines += [table_values(df), summary_values(df)]
        else:
            df = compare(rows, jax, metrics)
            lines += [table(df),
                      summary(df, by_metric=name != 'predictive')]
            if by_sweep:
                lines.append(summary_sweeps(df))
        frames.append(df.assign(table=name))
    return pd.concat(frames, ignore_index=True), lines


def by_target(port: pd.DataFrame, jax: pd.DataFrame
              ) -> tuple[pd.DataFrame, list[str]]:
    """The NUTS and HMC rows of both packages by target acceptance: one
    row per (package, target) with its runs and the mean of each of
    ``BY_TARGET_STATS``; and the printed table, a target a line."""
    rows = []
    for package, df in (('port', tree_rows(port)), ('jax', tree_rows(jax))):
        for target, runs in df.groupby(df[TARGET].astype(float), sort=True):
            rows.append({'package': package, 'target_acceptance': target,
                         'runs': len(runs),
                         **{k: float(pd.to_numeric(runs[k]).mean())
                            for k in BY_TARGET_STATS}})
    df = pd.DataFrame(rows)
    lines = ['| target | port runs | port divergent | port acceptance | '
             'port steps | JAX runs | JAX divergent | JAX acceptance | '
             'JAX steps |', '|---|---|---|---|---|---|---|---|---|']
    for target in sorted(df['target_acceptance'].unique()):
        cells = []
        for package in ('port', 'jax'):
            got = df[(df['package'] == package)
                     & (df['target_acceptance'] == target)]
            cells += (['0', '–', '–', '–'] if got.empty else [
                f'{got["runs"].item()}',
                f'{got["n_divergent"].item():.6g}',
                f'{got["mean_acceptance_rate"].item():.4f}',
                f'{got["mean_num_integration_steps"].item():.6g}'])
        lines.append(f'| {target:g} | ' + ' | '.join(cells) + ' |')
    return df, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('study', help='the study, e.g. dataset')
    p.add_argument('--port', type=Path, default=None,
                   help='default aggr_results_torch/tpu_arithmetic/'
                        'aggr_<study>.csv: the runs at the JAX rows\' '
                        'arithmetic')
    p.add_argument('--jax', type=Path, default=None,
                   help='default aggr_results/aggr_<study>.csv')
    p.add_argument('--out', type=Path, default=None,
                   help='also write the comparison as a CSV')
    p.add_argument('--by-sweep', action='store_true',
                   help='after each count line, the count by sweep')
    p.add_argument('--by-target', action='store_true',
                   help="then both packages' NUTS rows by target "
                        'acceptance')
    args = p.parse_args(argv)
    port = pd.read_csv(args.port or
                       ROOT / 'aggr_results_torch' / 'tpu_arithmetic' /
                       f'aggr_{args.study}.csv')
    jax = pd.read_csv(args.jax or
                      ROOT / 'aggr_results' / f'aggr_{args.study}.csv')
    df, lines = report(port, jax, by_sweep=args.by_sweep)
    if args.by_target:
        targets, target_lines = by_target(port, jax)
        lines += ['', 'By target acceptance', '', *target_lines]
        df = pd.concat([df, targets.assign(table='by_target')],
                       ignore_index=True)
    print('\n'.join(lines))
    if args.out is not None:
        df.to_csv(args.out, index=False)
    return 0


if __name__ == '__main__':
    sys.exit(main())
