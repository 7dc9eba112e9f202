#!/usr/bin/env python3
"""The study catalogue runner of the PyTorch port (counterpart of
``experiments/run_catalog.py``).

    python experiments/torch_run_catalog.py [--root results/torch_catalog]
        [--only STUDY[,STUDY]] [--name-filter REGEX] [--limit N]
        [--mclmc-first] [--job-timeout S] [--device cuda|cpu]
        [--tpu-arithmetic] [--dry-run]

Runs the same 248 jobs (studies, names, base configs, overrides with the
depth-8 NUTS caps, warm-start providers), serially in one process,
through the port's ``BDETrainer``, into ``<root>/<study>/<job>/``: the
experiment directories that ``pool_results.py``, ``summarize_study.py``,
``catalog_tables.py`` and ``plot_results.py`` read. The on-disk contract
and exit codes are the JAX runner's, so a relaunch wrapper such as
``experiments/r5_chip_queue.sh`` drives either:

- ``queue.jsonl``: one record per job run (``ok``, ``wall_s``, metrics or
  the error), and here also the K1/K3 launches the job made;
- a job whose directory holds ``metrics.pkl`` is skipped, an incomplete
  directory is removed and the job run again;
- a job whose warm-start provider has no ``warmstart/`` runs without
  reuse;
- ``STOP`` in the root is consumed between jobs: exit 75;
- ``FAULTS.jsonl``, keyed by ``study/job`` (bare legacy keys still
  count): a device fault writes a strike and exits 70, so that a wrapper
  relaunches a fresh process; a job with two strikes is skipped before a
  trainer is built;
- a watchdog writes a hang strike and exits 70 (``os._exit``) when a job
  outlives ``--job-timeout``;
- exit 0 when every job ran or was skipped, 1 when one failed.

A CUDA error is sticky: after an illegal address or a device-side assert
every later CUDA call in the process fails, so one faulted job would fail
every later job of the queue. :func:`is_device_fault` recognises CUDA's
own errors (``torch.AcceleratorError``, and the texts of
``FAULT_MARKERS``, which include the port's kernel launch error); an
out-of-memory error is not sticky, so that job is recorded as failed and
the queue goes on. The JAX runner's strike-less exit on gRPC's
``UNAVAILABLE`` (a blip of the link to a remote TPU worker) has no
counterpart: the card is local. The watchdog guards a job that stops
making progress without raising (a hung launch or collective) as it
guarded a client blocked on a dead TPU worker.

``--tpu-arithmetic`` runs the jobs at the arithmetic the JAX package's
pooled studies (``aggr_results/``) ran at on the TPU: a None matmul
precision stands for one bfloat16 pass
(``mile_tpu_torch.utils.precision.set_none_precision('bfloat16')``), so
the warm start, and the tuner and the draws wherever the config leaves
them at None, run at it, while the evaluation and NUTS/HMC stay exact
float32 as in the JAX package. A job whose overrides do not name
``training.sampler.warmup_matmul_precision`` gets None there
(``TPU_ROWS_WARMUP``): every pooled JAX row was taken while that knob
defaulted to None (the ``dtype_ab`` rows, 30cdad6) or did not exist yet
(``dataset``, ``tabular_classif``, ``feasibility``), so their tuners ran
at the chip's default. Each such job's ``config.yaml`` records the
setting (``none_precision: bfloat16``), and so does its pooled row. The
uncapped NUTS jobs also get the target acceptance of 0.8 that their rows
record (``TPU_ROWS_NUTS``), where the default has been 0.9 since 06d12c2.

Runs on the GPU unless ``--device cpu`` is given; without a CUDA device it
raises rather than run on the CPU unasked. There is no compilation cache
to set up: the port compiles only its two kernels, which
``mile_tpu_torch/ops/build.py`` caches by content.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import re
import shutil
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

logger = logging.getLogger('catalog')

CLASSIF_DATASETS = ['sonar', 'heart', 'glass', 'australian', 'ionosphere',
                    'wine_red', 'wine_white']  # covertype: data blob missing
CLASSIF_SEEDS = [1, 2, 3, 4, 5]          # reference repl_search.yaml
ABLATION_SEEDS = [1, 2, 3]

# reference search_desired_energy_var.yaml grid
EV_STARTS = [0.1, 0.5, 1.0, 10.0, 100.0]
EV_ENDS = [0.1, 0.05]
TRUSTS = [2.5, 2.0, 1.5, 1.0, 0.5]       # search_trust_in_estimate.yaml
ESS_TARGETS = [10, 50, 100, 150, 200]    # search_ess.yaml
WARMUP_BUDGETS = [10000, 50000, 100000, 150000, 200000]  # search_warmstart_budget
COMPLEXITY_STRUCTS = [[8, 8, 8, 2], [16, 16, 16, 2], [32, 32, 32, 2],
                      [48, 48, 48, 2]]   # complexity_search.yaml
DATASIZE_LIMITS = [40000, 30000, 20000, 10000, 5000]  # datasize_search.yaml
FEAS_DATASETS = ['airfoil', 'concrete', 'energy', 'yacht', 'bikesharing',
                 'protein']              # feas_search.yaml
DIAG_DATASETS = ['airfoil', 'bikesharing', 'energy']  # diagnostics_search

# The NUTS depth cap of the catalogue's widest cells (both phases at 8).
# The JAX runner added it after faults of the remote TPU worker; the port
# keeps it so that the two runtimes' pooled studies compare row for row.
NUTS_DEPTH_CAP = {'training.sampler.warmup_max_num_doublings': 8,
                  'training.sampler.max_num_doublings': 8}

# Error text of a sticky CUDA fault: CUDA's runtime errors as PyTorch
# reports them (or by their enum names, as some libraries do), cuBLAS's and
# cuDNN's statuses, and the port's own kernel launch error ("... failed to
# launch: CUDA error N (...)").
FAULT_MARKERS = ('CUDA error', 'device-side assert', 'illegal memory access',
                 'unspecified launch failure', 'cudaError', 'CUBLAS_STATUS_',
                 'CUDNN_STATUS_')

EXIT_FAULT, EXIT_STOP = 70, 75

# The tuner's precision of the JAX package's pooled rows (see the module
# docstring), given under --tpu-arithmetic to every job that names none.
TPU_ROWS_WARMUP = {'training.sampler.warmup_matmul_precision': None}

# The NUTS target acceptance of the JAX rows of the uncapped NUTS jobs
# (``complexity`` at widths 8-32, ``diagnostics``, ``hyper_params``'
# baseline): those rows were taken at 0.8, before 06d12c2 moved the
# default to 0.9, and record it. The depth-capped jobs' rows (``datasize``,
# ``complexity`` at width 48) record 0.9 and ``nuts_ta`` names its own, so
# under --tpu-arithmetic this goes to every NUTS job that names neither
# the target acceptance nor a depth cap.
TPU_ROWS_NUTS = {'training.sampler.target_acceptance': 0.8}


@dataclasses.dataclass
class Job:
    study: str
    name: str
    base: str
    overrides: dict
    # job NAME within the same study, or 'other_study/name' for a
    # cross-study provider (resolved against the root, so the queue is
    # relocatable)
    warmstart_from: Optional[str] = None

    def exp_dir(self, root: Path) -> Path:
        return root / self.study / self.name

    def warmstart_dir(self, root: Path) -> Optional[Path]:
        if self.warmstart_from is None:
            return None
        if '/' in self.warmstart_from:
            return root / self.warmstart_from
        return root / self.study / self.warmstart_from

    def config(self, root: Path, tpu_arithmetic: bool = False):
        """The base config with the job's directory, its overrides and its
        warm-start provider, as dotted-path updates; ``tpu_arithmetic``:
        the tuner's precision of the JAX rows where the job names none,
        and their target acceptance for the NUTS jobs of
        ``TPU_ROWS_NUTS``."""
        from mile_tpu_torch.config import Config

        from mile_tpu_torch.config.training import Sampler

        (cfg,) = Config.from_file(ROOT / self.base)
        rows = {}
        if tpu_arithmetic:
            rows.update(TPU_ROWS_WARMUP)
            if (cfg.training.sampler.name == Sampler.NUTS
                    and not {*TPU_ROWS_NUTS, *NUTS_DEPTH_CAP}
                    & set(self.overrides)):
                rows.update(TPU_ROWS_NUTS)
        updates = {'saving_dir': str(root / self.study),
                   'experiment_name': self.name, **rows, **self.overrides}
        ws = self.warmstart_dir(root)
        if ws is not None:
            updates['training.warmstart.warmstart_exp_dir'] = str(ws)
        return cfg.replace(**updates)


def build_jobs() -> list[Job]:
    """The catalogue in priority order (a copy of the JAX runner's)."""
    jobs: list[Job] = []

    # ---- 1. tabular classification suite (rng 1-5)
    for ds in CLASSIF_DATASETS:
        for rng in CLASSIF_SEEDS:
            jobs.append(Job('tabular_classif', f'{ds}_mclmc_r{rng}',
                            f'configs/tabular_classif/{ds}.yaml',
                            {'rng': rng}))

    # ---- 2. hyper-parameter ablations; the (0.5, 0.1) energy point is
    # the warm-start provider of its seed
    base = 'configs/ablations/complexity_bike_mclmc.yaml'
    for rng in ABLATION_SEEDS:
        jobs.append(Job('hyper_params', f'bike_mclmc_ev0.5_0.1_r{rng}',
                        base, {'rng': rng}))
    for rng in ABLATION_SEEDS:
        provider = f'bike_mclmc_ev0.5_0.1_r{rng}'
        for s in EV_STARTS:
            for e in EV_ENDS:
                if (s, e) == (0.5, 0.1):
                    continue  # the provider covers it
                jobs.append(Job(
                    'hyper_params', f'bike_mclmc_ev{s}_{e}_r{rng}', base,
                    {'rng': rng,
                     'training.sampler.desired_energy_var_start': s,
                     'training.sampler.desired_energy_var_end': e},
                    warmstart_from=provider))
        for t in TRUSTS:
            if t == 1.5:
                continue
            jobs.append(Job(
                'hyper_params', f'bike_mclmc_trust{t}_r{rng}', base,
                {'rng': rng, 'training.sampler.trust_in_estimate': t},
                warmstart_from=provider))
        for n in ESS_TARGETS:
            if n == 100:
                continue
            jobs.append(Job(
                'hyper_params', f'bike_mclmc_ess{n}_r{rng}', base,
                {'rng': rng, 'training.sampler.num_effective_samples': n},
                warmstart_from=provider))
        for w in WARMUP_BUDGETS:
            if w == 50000:
                continue
            jobs.append(Job(
                'hyper_params', f'bike_mclmc_wu{w}_r{rng}', base,
                {'rng': rng, 'training.sampler.warmup_steps': w},
                warmstart_from=provider))
        jobs.append(Job('hyper_params', f'bike_nuts_baseline_r{rng}',
                        'configs/ablations/complexity_bike_nuts.yaml',
                        {'rng': rng}, warmstart_from=provider))
        jobs.append(Job('hyper_params', f'bike_de_r{rng}',
                        'configs/ablations/complexity_bike_de.yaml',
                        {'rng': rng}))  # own optimizer -> own warm start

    # ---- 3. complexity ablation; NUTS at width 44 and more is capped at
    # depth 8 in both phases
    for struct in COMPLEXITY_STRUCTS:
        tag = 'x'.join(str(w) for w in struct[:-1])
        for rng in ABLATION_SEEDS:
            provider = f'bike_mclmc_{tag}_r{rng}'
            jobs.append(Job('complexity', provider,
                            'configs/ablations/complexity_bike_mclmc.yaml',
                            {'rng': rng, 'model.hidden_structure': struct}))
            nuts_over = {'rng': rng, 'model.hidden_structure': struct}
            if max(struct) >= 44:
                nuts_over.update(NUTS_DEPTH_CAP)
            jobs.append(Job('complexity', f'bike_nuts_{tag}_r{rng}',
                            'configs/ablations/complexity_bike_nuts.yaml',
                            nuts_over, warmstart_from=provider))
            jobs.append(Job('complexity', f'bike_de_{tag}_r{rng}',
                            'configs/ablations/complexity_bike_de.yaml',
                            {'rng': rng, 'model.hidden_structure': struct}))

    # ---- 4. datasize ablation; the whole NUTS arm capped at depth 8
    for limit in DATASIZE_LIMITS:
        for rng in ABLATION_SEEDS:
            provider = f'protein_mclmc_n{limit}_r{rng}'
            jobs.append(Job('datasize', provider,
                            'configs/ablations/datasize_protein_mclmc.yaml',
                            {'rng': rng, 'data.datapoint_limit': limit}))
            jobs.append(Job('datasize', f'protein_nuts_n{limit}_r{rng}',
                            'configs/ablations/datasize_protein_nuts.yaml',
                            {'rng': rng, 'data.datapoint_limit': limit,
                             **NUTS_DEPTH_CAP},
                            warmstart_from=provider))

    # ---- 4a2. MCLMC matmul-dtype A/B on the airfoil config
    for rng in ABLATION_SEEDS:
        for tag, overrides in (
                ('f32def',
                 {'training.sampler.warmup_matmul_precision': None}),
                ('f32strict',
                 {'training.sampler.matmul_precision': 'float32'}),
                ('bf16fwd',
                 {'training.sampler.compute_dtype': 'bfloat16',
                  'training.sampler.warmup_matmul_precision': None}),
                ('f32tune',
                 {'training.sampler'
                  '.warmup_matmul_precision': 'float32'})):
            jobs.append(Job(
                'dtype_ab', f'airfoil_mclmc_{tag}_r{rng}',
                'configs/illustrative_airfoil_mclmc.yaml',
                {'rng': rng, **overrides}))

    # ---- 4b. NUTS target-acceptance sweep over the complexity study's
    # 16x16x16 MCLMC warm starts
    for rng in ABLATION_SEEDS:
        for ta in (0.8, 0.9, 0.95):
            jobs.append(Job(
                'nuts_ta', f'bike_nuts_ta{int(ta * 100)}_r{rng}',
                'configs/ablations/complexity_bike_nuts.yaml',
                {'rng': rng, 'training.sampler.target_acceptance': ta},
                warmstart_from=f'complexity/bike_mclmc_16x16x16_r{rng}'))

    # ---- 4c. UCI regression dataset sweep
    for ds in FEAS_DATASETS:
        for rng in ABLATION_SEEDS:
            jobs.append(Job('dataset', f'uci_mclmc_{ds}_r{rng}',
                            'configs/replicate_uci/mclmc.yaml',
                            {'rng': rng, 'data.path': f'data/{ds}.data'}))

    # ---- 5. feasibility: the naive 10-layer arm, the tuned arm with
    # diagonal preconditioning, and the float32-compute arm
    for ds in FEAS_DATASETS:
        jobs.append(Job('feasibility', f'feas_mclmc_{ds}',
                        'configs/feasibility/feas.yaml',
                        {'data.path': f'data/{ds}.data'}))
        jobs.append(Job(
            'feasibility', f'feas_tuned_{ds}',
            'configs/feasibility/feas.yaml',
            {'data.path': f'data/{ds}.data',
             'training.sampler.diagonal_preconditioning': True},
            warmstart_from=f'feas_mclmc_{ds}'))
        jobs.append(Job(
            'feasibility', f'feas_f32_{ds}',
            'configs/feasibility/feas.yaml',
            {'data.path': f'data/{ds}.data',
             'training.sampler.diagonal_preconditioning': True,
             'training.sampler.compute_dtype': 'float32'},
            warmstart_from=f'feas_mclmc_{ds}'))

    # ---- 6. diagnostics study (deep-8 FCN, 3 datasets)
    for ds in DIAG_DATASETS:
        for rng in ABLATION_SEEDS:
            provider = f'diag_mclmc_{ds}_r{rng}'
            jobs.append(Job('diagnostics', provider,
                            'configs/diagnostics_study.yaml',
                            {'rng': rng, 'data.path': f'data/{ds}.data'}))
            jobs.append(Job('diagnostics', f'diag_nuts_{ds}_r{rng}',
                            'configs/diagnostics_nuts.yaml',
                            {'rng': rng, 'data.path': f'data/{ds}.data'},
                            warmstart_from=provider))
    return jobs


def select_jobs(jobs: list[Job], only: Optional[str] = None,
                name_filter: Optional[str] = None, mclmc_first: bool = False,
                limit: Optional[int] = None) -> list[Job]:
    """The JAX runner's filters, in its order: studies, a regex on the
    name, MCLMC (the providers) before DE before NUTS, then the limit."""
    if only:
        keep = set(only.split(','))
        jobs = [j for j in jobs if j.study in keep]
    if name_filter:
        jobs = [j for j in jobs if re.search(name_filter, j.name)]
    if mclmc_first:
        def rank(j: Job) -> int:
            return 0 if 'mclmc' in j.name or j.study == 'feasibility' \
                else (1 if '_de' in j.name else 2)
        jobs = sorted(jobs, key=rank)  # stable: keeps the order within
    if limit:
        jobs = jobs[:limit]
    return jobs


def is_device_fault(exc: BaseException) -> bool:
    """Whether ``exc`` (or an exception it was raised from) is a sticky
    CUDA fault: ``torch.AcceleratorError`` where the installed torch has
    it, or error text of ``FAULT_MARKERS``. Out of memory is not one."""
    import torch

    oom = getattr(torch, 'OutOfMemoryError', torch.cuda.OutOfMemoryError)
    accelerator = getattr(torch, 'AcceleratorError', None)
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, oom):
            return False
        if accelerator is not None and isinstance(exc, accelerator):
            return True
        if any(m in f'{type(exc).__name__}: {exc}' for m in FAULT_MARKERS):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def fault_counts(fault_log: Path) -> dict:
    """Strikes by ``study/job`` (bare job names for legacy entries)."""
    counts: dict = {}
    if fault_log.exists():
        for line in fault_log.read_text().splitlines():
            rec = json.loads(line)
            key = (f"{rec['study']}/{rec['job']}" if 'study' in rec
                   else rec['job'])
            counts[key] = counts.get(key, 0) + 1
    return counts


def _launches() -> dict:
    from mile_tpu_torch.ops import isokinetic as ops

    return {'isokinetic_momentum': ops.isokinetic_momentum.launches,
            'partial_refresh': ops.partial_refresh.launches}


def run_queue(jobs: list[Job], root: Path, *, job_timeout: float = 1800.0,
              device: str = 'cuda', tpu_arithmetic: bool = False) -> int:
    """Run ``jobs`` into ``root``; returns 0 (all ran or were skipped), 1
    (one failed), 70 (a device fault or a hang: relaunch) or 75 (``STOP``
    found and consumed). ``tpu_arithmetic``: as ``--tpu-arithmetic``, the
    process's setting restored on return."""
    from mile_tpu_torch.utils import precision
    from mile_tpu_torch.utils.device import resolve_device

    resolve_device(device)   # no GPU and not asked for the CPU: raise
    before = precision.none_precision()
    precision.set_none_precision('bfloat16' if tpu_arithmetic else before)
    try:
        return _run_queue(jobs, Path(root), job_timeout, device,
                          tpu_arithmetic)
    finally:
        precision.set_none_precision(before)


def _run_queue(jobs, root, job_timeout, device, tpu_arithmetic) -> int:
    from mile_tpu_torch.train import trainer as trainer_mod

    root.mkdir(parents=True, exist_ok=True)
    fault_log = root / 'FAULTS.jsonl'
    strikes_of = fault_counts(fault_log)
    done = skipped = failed = 0
    stopped = False
    with open(root / 'queue.jsonl', 'a') as qlog:
        def record(rec: dict) -> None:
            qlog.write(json.dumps(rec) + '\n')
            qlog.flush()

        def strike(job: Job, wall: float, **extra) -> None:
            with open(fault_log, 'a') as f:
                f.write(json.dumps({'study': job.study, 'job': job.name,
                                    'wall_s': round(wall, 1), **extra})
                        + '\n')

        for i, job in enumerate(jobs):
            where = f'[{i + 1}/{len(jobs)}] {job.study}/{job.name}'
            strikes = (strikes_of.get(f'{job.study}/{job.name}', 0)
                       + strikes_of.get(job.name, 0))
            if strikes >= 2:
                logger.error('%s skipped: faulted the device %d times (see '
                             '%s)', where, strikes, fault_log)
                skipped += 1
                continue
            if (root / 'STOP').exists():
                # between jobs only; consumed so that the next launch runs
                (root / 'STOP').unlink()
                stopped = True
                logger.info('STOP file found (consumed); exiting after %d '
                            'done', done)
                break
            exp_dir = job.exp_dir(root)
            if (exp_dir / 'metrics.pkl').exists():
                skipped += 1
                continue
            if exp_dir.exists():
                # an incomplete leftover (setup_dir would otherwise give
                # the rerun a time-stamped duplicate)
                shutil.rmtree(exp_dir)
            ws_dir = job.warmstart_dir(root)
            if ws_dir is not None and not (ws_dir / 'warmstart').exists():
                logger.error('%s: warm-start provider %s missing; running '
                             'WITHOUT reuse', where, job.warmstart_from)
                job = dataclasses.replace(job, warmstart_from=None)
            logger.info('%s starting', where)
            t0 = time.time()
            before = _launches()

            def hang_exit(job=job, t0=t0):
                # a job blocked in native code cannot be interrupted from
                # Python: strike, record and leave the process at once
                wall = time.time() - t0
                logger.error('%s HUNG for %.0fs: recording a strike and '
                             'exiting %d for relaunch', job.name, wall,
                             EXIT_FAULT)
                strike(job, wall, hang=True)
                record({'job': job.name, 'study': job.study, 'ok': False,
                        'wall_s': round(wall, 1), 'error': 'hang'})
                os._exit(EXIT_FAULT)

            watchdog = threading.Timer(job_timeout, hang_exit)
            watchdog.daemon = True
            watchdog.start()
            try:
                trainer = trainer_mod.BDETrainer(
                    job.config(root, tpu_arithmetic), device=device)
                metrics = trainer.train(report=True)
                wall = time.time() - t0
                done += 1
                rec = {'job': job.name, 'study': job.study, 'ok': True,
                       'wall_s': round(wall, 1),
                       **{k: metrics.get(k) for k in
                          ('lppd', 'de_lppd', 'acc', 'rmse')}}
            except Exception as exc:   # the queue goes on
                wall = time.time() - t0
                failed += 1
                logger.error('%s FAILED after %.0fs:\n%s', where, wall,
                             traceback.format_exc())
                rec = {'job': job.name, 'study': job.study, 'ok': False,
                       'wall_s': round(wall, 1), 'error': repr(exc)}
                if is_device_fault(exc):
                    # every later CUDA call of this process would fail:
                    # strike and leave for a fresh process
                    record(rec)
                    strike(job, wall)
                    logger.error('device fault: exiting %d for relaunch '
                                 '(done=%d skip=%d fail=%d)', EXIT_FAULT,
                                 done, skipped, failed)
                    return EXIT_FAULT
            finally:
                watchdog.cancel()
            rec['launches'] = {k: v - before[k]
                               for k, v in _launches().items()}
            record(rec)
            logger.info('%s done in %.0fs (done=%d skip=%d fail=%d)',
                        where, wall, done, skipped, failed)
    logger.info('queue complete: %d done, %d skipped, %d failed', done,
                skipped, failed)
    if stopped:
        return EXIT_STOP   # tells a multi-stage wrapper to stop
    return 0 if failed == 0 else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--root', default='results/torch_catalog')
    p.add_argument('--only', default=None,
                   help='comma-separated study filter')
    p.add_argument('--dry-run', action='store_true')
    p.add_argument('--limit', type=int, default=None)
    p.add_argument('--job-timeout', type=float, default=1800.0,
                   help='hard per-job wall limit (s); a job exceeding it '
                        'is treated as a device hang: strike + exit 70')
    p.add_argument('--name-filter', default=None,
                   help='regex on job name (e.g. "_r1$" runs one seed of '
                        'every SEEDED grid point; feasibility jobs carry '
                        'no _r<N> suffix and would be dropped)')
    p.add_argument('--mclmc-first', action='store_true',
                   help='run every MCLMC job (the warm-start providers) '
                        'before DE, before NUTS, within the filtered set')
    p.add_argument('--device', default='cuda',
                   help="torch device (default 'cuda'; 'cpu' to run on "
                        'the CPU)')
    p.add_argument('--tpu-arithmetic', action='store_true',
                   help='a None matmul precision is one bfloat16 pass, as '
                        "the JAX rows' on the TPU (see the docstring)")
    args = p.parse_args(argv)

    jobs = select_jobs(build_jobs(), args.only, args.name_filter,
                       args.mclmc_first, args.limit)
    if args.dry_run:
        for j in jobs:
            print(f'{j.study:16s} {j.name:34s} ws<-{j.warmstart_from}')
        print(f'{len(jobs)} jobs')
        return 0
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
    return run_queue(jobs, Path(args.root), job_timeout=args.job_timeout,
                     device=args.device, tpu_arithmetic=args.tpu_arithmetic)


if __name__ == '__main__':
    sys.exit(main())
