#!/usr/bin/env python3
"""The PyTorch port's pooled study held against the JAX package's.

    python experiments/torch_compare_study.py STUDY
        [--port aggr_results_torch/tpu_arithmetic/aggr_STUDY.csv]
        [--jax aggr_results/aggr_STUDY.csv] [--out FILE.csv]

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

The last line counts the values outside against the count expected by
chance, 5 % of those compared.

Values (a study with one run a job, such as ``feasibility``: no group has
two rows, so there is no interval). Each port job with a JAX row of its
name gets, per metric, ``both finite``, ``both fail`` or ``differ``: a
value fails when it is not finite, and an ε (``step_size_mean``) also
when it is below 1e-6, a step that moves no float32 weight. Where both
are finite the port/JAX ratio is printed. The last line counts the jobs
whose ``lppd`` finiteness agrees and the values that differ, by metric.

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
SEED = re.compile(r'_r\d+$')
# Student's t, 0.975 quantile, by degrees of freedom
T975 = {1: 12.706204736174694, 2: 4.302652729749462, 3: 3.1824463052837078,
        4: 2.7764451051977934, 5: 2.5705818356363146, 6: 2.4469118511449786,
        7: 2.364624251592784, 8: 2.306004135204166, 9: 2.262157162798205,
        10: 2.228138851986274}
CHANCE = 0.05
EPS_FAILS_BELOW = 1e-6


def group_of(name: str) -> str:
    return SEED.sub('', name)


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


def metrics_of(jax: pd.DataFrame) -> list[str]:
    """The metrics of ``METRICS`` that the JAX study has with a finite
    value in some row, in ``METRICS``' order."""
    return [m for m in METRICS if m in jax.columns
            and np.isfinite(pd.to_numeric(jax[m], errors='coerce')).any()]


def one_run_a_job(jax: pd.DataFrame) -> bool:
    """Whether no group of the JAX study has two rows (value mode)."""
    return int(jax['experiment_name'].map(group_of).value_counts().max()) < 2


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


def compare_values(port: pd.DataFrame, jax: pd.DataFrame) -> pd.DataFrame:
    """One row per (port job with a JAX row of its name, metric of
    :func:`metrics_of` the JAX study): both values, the verdict (``both
    finite``, ``both fail``, ``differ``) and the port/JAX ratio where both
    are finite."""
    metrics = metrics_of(jax)
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


def summary_values(df: pd.DataFrame) -> str:
    jobs = df['experiment_name'].nunique()
    lppd = df[df['metric'] == 'lppd']
    agree = int((lppd['verdict'] != 'differ').sum())
    differ = df[df['verdict'] == 'differ']
    by_metric = ', '.join(f'{m} {n}' for m, n in
                          differ['metric'].value_counts(sort=False).items())
    return (f'lppd finiteness agrees in {agree} of {jobs} jobs; '
            f'{len(differ)} of {len(df)} values differ'
            + (f' ({by_metric})' if by_metric else ''))


def table(df: pd.DataFrame) -> str:
    lines = ['| run | metric | port | JAX, same name | JAX interval (95 %) '
             '| verdict |', '|---|---|---|---|---|---|']
    for r in df.itertuples():
        lines.append(f'| {r.experiment_name} | {r.metric} | {r.port:.6g} | '
                     f'{r.jax_same_name:.6g} | [{r.lo:.6g}, {r.hi:.6g}] | '
                     f'{r.verdict} |')
    return '\n'.join(lines)


def summary(df: pd.DataFrame) -> str:
    compared = int((df['verdict'] != 'no interval').sum())
    outside = int((df['verdict'] == 'outside').sum())
    return (f'{outside} of {compared} outside their 95 % intervals '
            f'({CHANCE * compared:.1f} expected by chance)')


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
    args = p.parse_args(argv)
    port = pd.read_csv(args.port or
                       ROOT / 'aggr_results_torch' / 'tpu_arithmetic' /
                       f'aggr_{args.study}.csv')
    jax = pd.read_csv(args.jax or
                      ROOT / 'aggr_results' / f'aggr_{args.study}.csv')
    if one_run_a_job(jax):
        df = compare_values(port, jax)
        print(table_values(df))
        print(summary_values(df))
    else:
        df = compare(port, jax)
        print(table(df))
        print(summary(df))
    if args.out is not None:
        df.to_csv(args.out, index=False)
    return 0


if __name__ == '__main__':
    sys.exit(main())
