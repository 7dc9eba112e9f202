#!/usr/bin/env python3
"""The relaunch loop of the PyTorch port's study queue (counterpart of the
``run_catalog()`` function and the stage/pool pattern of
``experiments/r5_chip_queue.sh``).

    python experiments/torch_catalog_queue.py --root results/torch_catalog
        --stage 'dataset:_r1$' [--stage STUDY[:REGEX] ...]
        [--aggr-dir aggr_results_torch] [--cooloff S] [--device cuda|cpu]
        [--tpu-arithmetic] [--runner CMD]

Each stage is one study of the catalogue, or several joined by commas
(``STUDY,STUDY:REGEX``: one runner process for jobs of several studies),
optionally narrowed by a regex on the job name, run as a fresh process of
the runner,

    experiments/torch_run_catalog.py --root ROOT --only STUDY[,STUDY]
        [--name-filter REGEX] --job-timeout S --device D [--tpu-arithmetic]

and, when that process exits, handled as the shell function handles it:

- 75 (``STOP`` consumed): the loop stops at once and exits 75, without
  pooling;
- 70 (a device fault or a hang, with a strike in ``FAULTS.jsonl``): it
  cools off ``--cooloff`` seconds and launches the runner again, at most
  3 times in all; after the third the stage is abandoned and the
  loop goes on to the next (the runner skips a job with two strikes, so a
  job that faults twice is skipped by the third launch);
- 0 or 1 (every job ran, or one failed): it goes on.

After each stage that was not stopped it pools ``ROOT/STUDY`` of each of
its studies with ``experiments/pool_results.py`` into
``AGGR_DIR/aggr_<study>.csv``. The
default directory is ``aggr_results_torch/``; ``aggr_results/`` holds the
JAX package's pooled studies and is refused.

A CUDA error is sticky, so the loop itself never touches the card: it
imports neither torch nor JAX and runs everything as subprocesses. Without
``--device cpu`` the runner raises on a machine with no GPU (exit 1); the
loop passes that on like any failed stage and falls back to nothing.

Job timeouts. The runner's watchdog strikes a job that outlives its
``--job-timeout`` as a hang. The loop passes the figure of the stage's
study in ``JOB_TIMEOUT_S``, else the runner's default of 1800 s (the
largest of its studies' for a stage of several). The
``dataset`` study's jobs (``configs/replicate_uci/mclmc.yaml``, 12
chains) are each:

- a warm start of up to 500 epochs at batch 32; protein's 32,011
  training rows make 1,001 batches an epoch, so up to 500,500 AdamW
  steps of the 12 members, at about 3.6 ms a step on an H100 (3,370
  member-steps/s, ``bench_torch.py``): up to 1,800 s;
- 50,000 tuner and 10,000 sampling steps (``n_samples`` counts steps
  before the thinning by 10) at the trainer's 100-150 steps/s: 400-600 s;
- evaluation and the report over 12,000 draws: seconds.

That is up to about 2,400 s alone on the card. Hosts differ by up to 1.5x
on host-bound work, and jobs run side by side on one card share its
host (protein's warm start ran 3.3x slower with six jobs at once than
alone): 7,200 s leaves room for both. The longest job measured, protein
at seed 1 beside five others, took 1,185 s (``PERF.md``). The
``dtype_ab`` (airfoil) and ``feasibility`` jobs run the same 50,000 +
10,000 steps after the same warm start on the same sets, feasibility's
through a 10-layer FCN, and get the same figure. So do the MCLMC halves
of ``diagnostics`` (the deep-8 FCN on airfoil, bikesharing and energy),
``complexity`` (bikesharing at widths 8-48) and ``datasize`` (protein at
up to 40,000 rows, 36,000 of them training rows: 1,125 batches an
epoch, more than the ``dataset`` study's 1,001): the same step counts
after warm starts no longer than protein's, up to about 2,600 s alone.
``hyper_params`` (bikesharing, FCN [16, 16, 16, 2]) runs its warm-up
budget sweep up to 200,000 tuner and 10,000 sampling steps, 2,100 s at
100 steps/s, after the warm start of its seed's provider (267 batches an
epoch, up to 480 s): 7,200 s as well. ``nuts_ta`` (bikesharing, FCN
[16, 16, 16, 2], NUTS at tree depth 10 after the warm start of its
seed's ``complexity`` provider) takes up to 1,023 batched leaves a draw
over 100 adaptation steps and 1,000 draws, 1.13 M leaves: 8,500 s at the
132 leaves/s measured for the eager airfoil leaf (``PERF.md``), and with
room for a host 1.5x slower 14,400 s.

``--tpu-arithmetic`` is passed on to every runner: its jobs run at the
TPU's one bfloat16 pass wherever their precision is None (see the
runner).

The log (the runner's and the pooling's output, and the loop's own lines)
is appended to ``ROOT/queue_driver.log``; the loop prints, per stage, the
runner's exit codes and the pooled CSV's path.
"""
from __future__ import annotations

import argparse
import dataclasses
import shlex
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

ROOT = Path(__file__).resolve().parent.parent
RUNNER = (sys.executable, str(ROOT / 'experiments' / 'torch_run_catalog.py'))
POOL = ROOT / 'experiments' / 'pool_results.py'
AGGR_DIR = ROOT / 'aggr_results_torch'
JAX_AGGR_DIR = ROOT / 'aggr_results'

EXIT_FAULT, EXIT_STOP = 70, 75
ATTEMPTS = 3
COOLOFF_S = 180.0
DEFAULT_JOB_TIMEOUT_S = 1800.0
# per-study job timeouts (s); the derivation is in the module docstring
JOB_TIMEOUT_S = {'dataset': 7200.0, 'dtype_ab': 7200.0,
                 'feasibility': 7200.0, 'diagnostics': 7200.0,
                 'complexity': 7200.0, 'datasize': 7200.0,
                 'hyper_params': 7200.0, 'nuts_ta': 14400.0}


@dataclasses.dataclass
class Stage:
    study: str
    name_filter: Optional[str] = None

    @classmethod
    def parse(cls, spec: str) -> 'Stage':
        """``STUDY`` or ``STUDY:REGEX`` (split at the first colon); STUDY
        may join several studies with commas."""
        study, _, regex = spec.partition(':')
        if not all(study.split(',')):
            raise ValueError(f'stage {spec!r}: no study')
        return cls(study, regex or None)

    @property
    def studies(self) -> list:
        return self.study.split(',')

    def __str__(self) -> str:
        return self.study + (f':{self.name_filter}' if self.name_filter
                             else '')


@dataclasses.dataclass
class StageResult:
    stage: Stage
    exit_codes: list
    pooled: Optional[Path] = None     # the first study's pooled CSV
    pooled_all: list = dataclasses.field(default_factory=list)
    abandoned: bool = False
    stopped: bool = False


class Queue:
    """The stages' loop over one results root: ``run(stages)`` returns 75
    when a stage was stopped, 0 otherwise; ``results`` holds what each
    stage did."""

    def __init__(self, root: Path, *, aggr_dir: Path = AGGR_DIR,
                 device: str = 'cuda', cooloff_s: float = COOLOFF_S,
                 runner: Sequence[str] = RUNNER,
                 tpu_arithmetic: bool = False):
        self.root, self.aggr_dir = Path(root), Path(aggr_dir)
        if self.aggr_dir.resolve() == JAX_AGGR_DIR.resolve():
            raise ValueError(f'{self.aggr_dir} holds the JAX package\'s '
                             f'pooled studies; pool the port\'s elsewhere')
        self.device, self.cooloff_s = device, cooloff_s
        self.runner = list(runner)
        self.tpu_arithmetic = tpu_arithmetic
        self.log_path = self.root / 'queue_driver.log'
        self.results: list[StageResult] = []

    def say(self, line: str) -> None:
        stamped = f'{line} {time.strftime("%a %b %d %H:%M:%S %Y")}'
        print(stamped, flush=True)
        with open(self.log_path, 'a') as log:
            log.write(stamped + '\n')

    def call(self, cmd: list) -> int:
        """``cmd`` in a fresh process, its output appended to the log."""
        with open(self.log_path, 'a') as log:
            log.write(f'$ {shlex.join(cmd)}\n')
            log.flush()
            return subprocess.run(cmd, cwd=ROOT, stdout=log,
                                  stderr=subprocess.STDOUT).returncode

    def runner_cmd(self, stage: Stage) -> list:
        cmd = [*self.runner, '--root', str(self.root), '--only', stage.study]
        if stage.name_filter:
            cmd += ['--name-filter', stage.name_filter]
        job_timeout = max(JOB_TIMEOUT_S.get(study, DEFAULT_JOB_TIMEOUT_S)
                          for study in stage.studies)
        cmd += ['--job-timeout', f'{job_timeout:g}', '--device', self.device]
        return cmd + ['--tpu-arithmetic'] if self.tpu_arithmetic else cmd

    def run_stage(self, stage: Stage) -> StageResult:
        result = StageResult(stage, [])
        self.results.append(result)
        for attempt in range(1, ATTEMPTS + 1):
            rc = self.call(self.runner_cmd(stage))
            result.exit_codes.append(rc)
            if rc == EXIT_STOP:
                self.say(f'=== STOP honored during: {stage} - pipeline '
                         f'drained')
                result.stopped = True
                return result
            if rc != EXIT_FAULT:
                return result
            if attempt < ATTEMPTS:
                self.say(f'=== device fault during: {stage} (attempt '
                         f'{attempt}); cooling off {self.cooloff_s:g}s')
                time.sleep(self.cooloff_s)
            else:
                self.say(f'=== device fault during: {stage} (attempt '
                         f'{attempt})')
        self.say(f'=== stage abandoned after repeated device faults: '
                 f'{stage}')
        result.abandoned = True
        return result

    def pool(self, result: StageResult) -> None:
        self.aggr_dir.mkdir(parents=True, exist_ok=True)
        for i, study in enumerate(result.stage.studies):
            out = self.aggr_dir / f'aggr_{study}.csv'
            rc = self.call([sys.executable, str(POOL),
                            str(self.root / study), '-o', str(out)])
            if rc == 0:
                result.pooled_all.append(out)
                if i == 0:
                    result.pooled = out
            else:
                self.say(f'=== pooling {study} failed (exit {rc})')

    def run(self, stages: Sequence[Stage]) -> int:
        self.root.mkdir(parents=True, exist_ok=True)
        self.say(f'=== queue start: {", ".join(map(str, stages))}')
        for i, stage in enumerate(stages, 1):
            self.say(f'--- stage {i}: {stage}')
            result = self.run_stage(stage)
            if result.stopped:
                self.report(result)
                return EXIT_STOP
            self.pool(result)
            self.report(result)
        self.say('=== queue complete')
        return 0

    def report(self, result: StageResult) -> None:
        print(f'{result.stage}: runner exit codes '
              f'{" ".join(map(str, result.exit_codes))}'
              + (' (abandoned)' if result.abandoned else '')
              + (' (stopped, not pooled)' if result.stopped else
                 '; pooled: ' + (', '.join(map(str, result.pooled_all))
                                 or 'None')), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--root', type=Path, default=Path('results/torch_catalog'))
    p.add_argument('--stage', action='append', required=True,
                   type=Stage.parse, metavar='STUDY[,STUDY][:REGEX]',
                   help='a study (or several, joined by commas, in one '
                        'runner), and a regex on its job names; repeat '
                        'for more stages, run in the order given')
    p.add_argument('--aggr-dir', type=Path, default=AGGR_DIR,
                   help='where aggr_<study>.csv goes (never aggr_results/)')
    p.add_argument('--cooloff', type=float, default=COOLOFF_S,
                   help='seconds between a fault and the relaunch')
    p.add_argument('--device', default='cuda',
                   help="the runner's --device (default 'cuda'; 'cpu' to "
                        'run on the CPU)')
    p.add_argument('--tpu-arithmetic', action='store_true',
                   help="the runner's --tpu-arithmetic: a None matmul "
                        'precision is the TPU\'s one bfloat16 pass')
    p.add_argument('--runner', type=shlex.split, default=list(RUNNER),
                   help='the runner command, to which the loop appends '
                        '--root, --only, --name-filter, --job-timeout, '
                        '--device and --tpu-arithmetic (default: '
                        'torch_run_catalog.py)')
    args = p.parse_args(argv)
    queue = Queue(args.root, aggr_dir=args.aggr_dir, device=args.device,
                  cooloff_s=args.cooloff, runner=args.runner,
                  tpu_arithmetic=args.tpu_arithmetic)
    return queue.run(args.stage)


if __name__ == '__main__':
    sys.exit(main())
