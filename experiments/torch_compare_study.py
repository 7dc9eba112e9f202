#!/usr/bin/env python3
"""The PyTorch port's pooled study held against the JAX package's.

    python experiments/torch_compare_study.py dataset
        [--port aggr_results_torch/aggr_dataset.csv]
        [--jax aggr_results/aggr_dataset.csv] [--out FILE.csv]

Reads both pooled CSVs (``experiments/pool_results.py``'s rows), joined on
``experiment_name``: rows are named ``<group>_r<seed>``, e.g.
``uci_mclmc_airfoil_r1``, and a group is one dataset's (or grid point's)
seeds. The two runtimes draw from different generators (Threefry and
Philox), so no draw, and no metric, can match; the comparison is
statistical. For each group and each metric of ``METRICS``:

- m and s are the mean and sample standard deviation (ddof 1) of the JAX
  seeds' values, n their count;
- the 95 % prediction interval for one new run is
  m ± t(0.975, n - 1) · s · √(1 + 1/n): m ± 4.97 s for n = 3;
- each port row of the group is printed with its value, the JAX value of
  the same name, the interval, and ``inside`` or ``outside`` (a value that
  is not finite is outside).

The last line counts the values outside against the count expected by
chance, 5 % of those compared. The script reports and gates nothing: it
exits 0 whatever the verdicts. It imports numpy and pandas only, so it
runs anywhere. A metric missing from the port's CSV under the JAX column
name raises: the port's pooled columns are the JAX package's.
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
METRICS = ('lppd', 'rmse', 'cal_error', 'coverage_0.9', 'step_size_mean',
           'L_mean')
SEED = re.compile(r'_r\d+$')
# Student's t, 0.975 quantile, by degrees of freedom
T975 = {1: 12.706204736174694, 2: 4.302652729749462, 3: 3.1824463052837078,
        4: 2.7764451051977934, 5: 2.5705818356363146, 6: 2.4469118511449786,
        7: 2.364624251592784, 8: 2.306004135204166, 9: 2.262157162798205,
        10: 2.228138851986274}
CHANCE = 0.05


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


def compare(port: pd.DataFrame, jax: pd.DataFrame,
            metrics=METRICS) -> pd.DataFrame:
    """One row per (port row, metric): the values, the JAX seeds' interval
    and the verdict."""
    missing = [m for m in ('experiment_name', *metrics)
               if m not in port.columns]
    if missing:
        raise KeyError(f'the port\'s pooled CSV lacks the JAX columns '
                       f'{missing}')
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
                   help='default aggr_results_torch/aggr_<study>.csv')
    p.add_argument('--jax', type=Path, default=None,
                   help='default aggr_results/aggr_<study>.csv')
    p.add_argument('--out', type=Path, default=None,
                   help='also write the comparison as a CSV')
    args = p.parse_args(argv)
    port = pd.read_csv(args.port or
                       ROOT / 'aggr_results_torch' / f'aggr_{args.study}.csv')
    jax = pd.read_csv(args.jax or
                      ROOT / 'aggr_results' / f'aggr_{args.study}.csv')
    df = compare(port, jax)
    print(table(df))
    print(summary(df))
    if args.out is not None:
        df.to_csv(args.out, index=False)
    return 0


if __name__ == '__main__':
    sys.exit(main())
