#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mile_tpu_torch/csrc/`` with nvcc,
holds each kernel against its plain PyTorch version on the card (K1 with
and without the fused drift and ΔK sum, on every launch route; K3 with
injected noise and the fused ΔE, its Philox statistics, and its device
step counter replayed from a CUDA graph), drives the airfoil MCLMC
pipeline (``configs/illustrative_airfoil_mclmc.yaml``) at full width
through ``BDETrainer`` with only the step counts cut, checks that the
pipeline went through the kernels and streamed its draws to disk through
the native C++ sample sink, and times the kernels (eagerly and replayed
from a CUDA graph), the sampler and a profiled step.

The main path's ``train()`` writes its report on the card: the smoke
checks ``report.html``, ``diagnostics.csv`` and the wall times, and holds
the report's per-parameter diagnostics on the card against the CPU's. The
partition path (``configs/replicate_uci/partition_mclmc.yaml``: the
energy PartitionFCN, 12 chains, dim 2,082 of which 178 are sampled, step
counts cut as the main path's) runs K1 and K3 at (12, 178), and its checks
hold the frozen coordinates of the warm start and of every draw bit for
bit.

The image path (``configs/additional_tasks/lenet_fmnist.yaml``: LeNet,
10 chains, dim 61,706, 24,000 training images, likelihood chunks of 8192)
runs through ``BDETrainer`` on a synthetic FashionMNIST-shaped archive made
from a seed, with the step counts cut to ``IMAGE_CUT``: K1 and K3 on the
resident-cluster route, their launch counts, the metrics, the draws on
disk, one MCLMC step through the kernels against the same step through the
plain versions on the card, the log-density and gradient on the card
against the CPU's in float32, phase times, the gradient's time and a
profiled step.

The text path (``configs/additional_tasks/sequential_mod.yaml``: the
IMDB-width AttentionClassifier, 8 chains, dim 65,248, 7,000 training
sequences of 70 tokens, likelihood chunks of 4096) runs the same way on a
synthetic corpus of 10,000 texts made from a seed and tokenized by
characters,
with the step counts cut to ``TEXT_CUT``; K1 and K3 on the resident-cluster
route, and a batch with pads and an all-pad sequence held card against
CPU.

The NUTS path (``configs/illustrative_airfoil_nuts.yaml``, full width,
tree depth 10, step counts cut to ``NUTS_CUT``) runs through
``BDETrainer`` too, with its tree statistics, rates and a profiled draw
(its leaves graphed); each phase's leaves are replayed from the NUTS
kernel's CUDA graph, and one NUTS step on the card (graphed) is held
against the same step on the CPU (eager) with the same injected draws;
and a short HMC run follows. That path runs no
hand-written kernel (the JAX package's NUTS/HMC is plain XLA). The kernels
are timed at each of ``TIMED_SHAPES``.

Resume, streaming, warm-start reuse and split HMC: ``run_mclmc`` with a
checkpoint directory on the main path's posterior (12 chains, dim 674,
chunks of ``RESUME_CHUNK_KEPT`` kept draws) is stopped after chunk 2 and,
apart, inside chunk 0, and each resumed run is held bit for bit against an
uninterrupted one (draws, ΔE statistics, tuned ε and L), with K1 and K3
launched only for the steps it had left; NUTS at depth 5 is stopped after
chunk 1 of 3 and resumed, bit for bit; ``BDETrainer`` with
``stream_samples`` writes one ``samples/{c}/sample_{n}.npz`` per draw,
equal to ``samples.npy``, and a second trainer reuses its warm start
(``warmstart_exp_dir``) bit for bit; ``experiments/
torch_symmetric_splitting.py`` runs split HMC at LeNet width (49 shards of
64 images) with its time per shard gradient and per proposal, and one
split-leapfrog step on the card is held against the CPU's.

More than one device, on one card, with mesh entries that repeat cuda:0:
the MCLMC resume run again with ``checkpoint_format='orbax'`` (the
snapshot through torch.distributed.checkpoint), resumed bit for bit, and a
trainer writing ``warmstart/orbax/`` that a second trainer reuses; the
trainer with 13 chains over two entries, padded to 14, with 13 chains in
every result and on disk; ``run_mclmc`` on the main path's posterior over
a 4-entry chain mesh and a 2 x 2 chains x data mesh, and 10 steps on each
mesh held against the one-device steps; two processes joined over gloo
(this script run again with ``--multiprocess-worker RANK PORT``) whose
draws equal one process's, with the in-step check and a checkpoint both
ranks write; LeNet's full-batch gradient over two entries against the
unsharded one, with both times.

The experiment harness: ten jobs of the study catalogue (``experiments/
torch_run_catalog.py``, ``CATALOG_JOBS``) run by ``run_queue`` on the card
at their configs' full widths with the step counts cut (``CATALOG_CUT``),
each job's K1/K3 launches, K1 and K3 against their plain versions at
each job's shape (also timed there), the warm starts its consumers reuse,
the skip
of done jobs and the STOP file, then ``pool_results.pool`` and
``summarize_study.summarize`` over the results; the runner's fault
contract with a real device-side assert and a hang, in worker processes
(this script run again with ``--catalog-fault-worker MODE ROOT``); the
wide-FCN dtype A/B (``experiments/torch_dtype_ab_widefcn.py``) at width
512, dim 592,386, its four arms in subprocesses, K1 and K3 on the
streaming-cluster route, and one step there through the kernels against
the plain versions; the NUTS timing scripts. The mesh phase also warm
starts 13 members over two entries against one device, and the
multi-process phase warm starts the main path's members through
``BDETrainer`` over both ranks against the main path's.

The study queue: the relaunch loop (``experiments/torch_catalog_queue.py``)
over this script as its runner (``--catalog-fault-worker assert``): a real
device-side assert relaunched after each 70 until the job's second strike
makes the next launch skip it, the stage pooled, and a STOP file ending a
later stage with 75 unpooled; then one stage of five studies
(``QUEUE_STAGE``, one runner process: ``--catalog-cut-worker``) through
the loop, its jobs cut to ``CATALOG_CUT``: the dataset study's six r1
jobs, pooled and compared by ``experiments/torch_compare_study.py``, with
each job's K1/K3 launches and the kernels against their plain versions at
``DATASET_SHAPES``; the feasibility study's energy pair (the 10-layer FCN
at ``FEAS_SHAPE``, the tuned arm preconditioned), pooled and compared
value by value, with K1 and K3 against their plain versions at its shape;
and one cut job of each mixed study's MCLMC or DE half (the deep-8 FCN on
energy, the DE arm at width 48, protein at 5,000 rows), pooled and
compared with both of the script's tables (its predictive metrics and the
chains' diagnostics), K1 and K3 against their plain versions at
``MIXED_SHAPES``; with them the datasize study's NUTS job at 5,000 rows,
cut to ``CATALOG_NUTS_CUT``, reusing the warm start of its MCLMC provider
run before it in the same root, compared also on the third table (the
trees' acceptance, leapfrog steps and divergences). The catalogue's cut sonar job is pooled and compared
through the classification metric set (LPPD, accuracy, ε, L), and its two
cut ``hyper_params`` jobs through the regression set against the three
JAX seeds of their grid points. Every comparison also checks the
diagnostics table. A real preemption:
``BDETrainer`` with ``checkpoint_sampling`` in a worker (``--preempt-worker
ROOT``) killed with SIGKILL once a chunk is on disk and resumed here bit
for bit; and one trainer run with ``profile: true`` whose trace names both
kernels.

The TPU's arithmetic (``'bfloat16'``: one bfloat16 pass, XLA's default
on a TPU, where the JAX package's studies ran): the card's route (a bf16
tensor-core ``bmm`` with a float32 result where torch offers
``aten::bmm.dtype``, printed) against the CPU's rounding route, forward
and both gradients, at the dense shapes of FCN [16, 16, 2] and
[16, 16, 16, 2] (12 chains, 1052 rows) and of the complexity study's
[48, 48, 48, 2] on bikesharing (12 chains, 8515 rows), LeNet's grouped
convolution and
the text attention's q·kᵀ, each within 2·K·2⁻²⁴·Σ|a||b| of the CPU and
K·2⁻²⁴·Σ|a||b| of a float64 product of the rounded operands; a witness of
what torch's ``'medium'`` (the port's old mapping) computes on the card;
and the airfoil trainer cut to ``PRECISION_CUT`` at the exact default and
under the TPU setting (``torch_run_catalog.py --tpu-arithmetic``) in
turns, with K1/K3 launches, the one-pass products counted, the recorded
setting and each run's sampling chain-steps/s.

The headline bench: ``bench_torch.py``'s modes in this process at full
width with the step counts cut (``BENCH_*``): the headline at 12 and 48
chains after a tuner run, the warm start at 12 and 48 members, airfoil
chain scaling to 1,536 chains and wide-FCN scaling to 48, the LeNet and
wide-FCN bf16 points and the CPU denominators, each mode's K1/K3 launches;
K1 and K3 against their plain versions at each new shape
(``BENCH_SHAPES``, also timed), K3's noise across 1,536 chains with a
device step counter, and the bench's fault contract with real worker
processes (this script's ``bench_fault_drill`` and ``bench_oom_drill``).

It needs a CUDA device and the repository around it: without either it
exits non-zero and prints no result. It imports nothing of JAX or of the
JAX package. The second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``; any failed phase makes the exit code 1.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import textwrap
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / 'configs' / 'illustrative_airfoil_mclmc.yaml'
RESULTS = ROOT / 'results' / 'chip_smoke'

# The card's peaks are mile_tpu_torch.utils.card's (HBM bytes/s, and the
# float32 rate outside the tensor cores: both kernels' work is 32-bit
# arithmetic). 32-bit operations per element of the main path's calls (no
# preconditioner): K1 |g|^2 and u.g (2 fma), a g + b u (mul + fma),
# |u'|^2 (fma), scale (mul), x + (x_frac eps) u' (2 mul, add), an fma
# counted as 2; K3 Philox4x32-10 per group of 4 (10 rounds of 2 mul-hi,
# 2 mul-lo, 4 xor, 2 key adds: 25 an element), Box-Muller per pair
# (2 shifts, 2 int->float, 2 fma, log, mul, sqrt, sin and cos, 2 mul: 7 an
# element), the u == 0 select, u + nu z (fma), |w|^2 (fma), scale.
K1_OPS_PER_ELEM = 4 + 3 + 2 + 1 + 3
K3_OPS_PER_ELEM = 25 + 7 + 1 + 2 + 2 + 1
# an MCLMC step of the main path: the drifts, the sum of dK and dE are
# fused into K1 and K3, 10 launches fewer than the 224 of the unfused step
MAX_LAUNCHES_PER_STEP = 214
# the K1/K3 shapes of the catalogue phase's MCLMC jobs besides (12, 674)
CATALOG_SHAPES = [(12, 1_282), (12, 786), (12, 5_426), (12, 738),
                  (12, 2_306), (12, 426)]
# the K1/K3 shapes the bench phase adds: the airfoil chain scaling's counts
# past 12, the wide FCN's at 4 and 48 chains (the streaming route), LeNet's
# at 12 chains
BENCH_SHAPES = [(48, 674), (192, 674), (768, 674), (1_536, 674),
                (4, 592_386), (48, 592_386), (12, 61_706)]
# the K1/K3 shapes of the dataset study's jobs (FCN [16, 16, 2] over 5, 8,
# 8, 6, 12 and 9 features), in the catalogue's order of the six UCI sets:
# airfoil, concrete, energy, yacht, bikesharing, protein
DATASET_SHAPES = [(12, 402), (12, 450), (12, 450), (12, 418), (12, 514),
                  (12, 466)]
# the K1/K3 shape of the feasibility study's energy jobs (the 10-layer FCN
# over 8 features), which the study queue's phase runs cut
FEAS_SHAPE = (12, 2_354)
TIMED_SHAPES = [(12, 674), (1, 674), (12, 178), (10, 61_706),
                (8, 65_248), (2, 300_000), (12, 592_386), *CATALOG_SHAPES,
                *BENCH_SHAPES, *sorted(set(DATASET_SHAPES)), FEAS_SHAPE]

MAIN_SHAPE = (12, 674)
CUT = {'training.warmstart.max_epochs': 20,
       'training.sampler.warmup_steps': 200,
       'training.sampler.n_samples': 200,
       'training.sampler.n_thinning': 10}

# The per-parameter diagnostics of the report, card against CPU on the
# main path's draws: float32 FFTs and reductions in another order (the
# ranks are the same: both sort stably), so each value within DIAG_RTOL
# relative, with a floor of DIAG_ATOL of the largest value of its kind
DIAG_RTOL, DIAG_ATOL = 1e-4, 1e-6

# The partition path: configs/replicate_uci/partition_mclmc.yaml at full
# width (energy, 537 training rows, PartitionFCN [16 x 8, 2] relu: dim
# 2,082, of which layer0's 144 and layer8's 34 coordinates are sampled; 12
# chains; the partition warm start; use_warmup_as_init). Cut in memory,
# as CUT cuts the main path: the warm start to 20 epochs (of 500, patience
# 10), the tuner to 200 steps (of 50,000), the sampling to 200 steps
# thinned by 10 (of 10,000): 20 draws a chain.
PARTITION_CONFIG = ROOT / 'configs' / 'replicate_uci' / 'partition_mclmc.yaml'
PARTITION_RESULTS = ROOT / 'results' / 'chip_smoke_partition'
PARTITION_SHAPE = (12, 178)
PARTITION_DIM = 2_082
PARTITION_CUT = CUT

# The image path: LeNet on a synthetic archive of FashionMNIST's shape
# (70,000 28x28 grey images in 10 classes, made from IMAGE_SEED) at the
# config's full width: 10 chains, dim 61,706, train_split 0.8, likelihood
# chunks of 8192. Cut in memory: the data to datapoint_limit 30,000 (of
# 60,000: 24,000 training images, 3 likelihood chunks; a step over 48,000
# took 0.72 s), the step counts (one warm-start epoch; 30 tuner steps, whose
# last tenth sets L from an effective sample size; 10 sampling steps kept
# every 5th, 2 draws a chain), and valid/test splits of 0.1/0.1 where the
# config has 0.2/0.0, so that the evaluation has test images.
IMAGE_CONFIG = ROOT / 'configs' / 'additional_tasks' / 'lenet_fmnist.yaml'
IMAGE_RESULTS = ROOT / 'results' / 'chip_smoke_lenet'
IMAGE_ARCHIVE = ROOT / 'results' / 'chip_smoke_fmnist.npz'
IMAGE_SEED = 2024
IMAGE_SHAPE = (10, 61_706)
IMAGE_TRAIN = 24_000
IMAGE_CUT = {'data.datapoint_limit': 30_000,
             'training.warmstart.max_epochs': 1,
             'training.sampler.warmup_steps': 30,
             'training.sampler.n_samples': 10,
             'training.sampler.n_thinning': 5,
             'data.valid_split': 0.1, 'data.test_split': 0.1}
# The image and text paths' checks. One step through the kernels against
# the same step through the plain versions, both on the card: positions
# (entries up to a few units) within atol + rtol |x| of STEP_X_TOL,
# momenta (unit rows of about 60,000, entries of order 4e-3) within
# STEP_U_ATOL; the card's log-density and gradient on GRAD_ROWS training
# observations against the CPU's in float32: value rtol GRAD_RTOL,
# gradient atol GRAD_GTOL max|g| (the log-posterior's and, apart, the
# log-likelihood's)
STEP_X_TOL = (1e-6, 1e-6)
STEP_U_ATOL = 2e-6
GRAD_ROWS = 1024
GRAD_RTOL, GRAD_GTOL = 1e-5, 1e-4

# The text path: configs/additional_tasks/sequential_mod.yaml at full width
# (AttentionClassifier, vocabulary 1,000, context 70, emb 48, 8 heads, qkv
# 64, projection [32], 2 classes: dim 65,248; 8 chains; Normal(0, 0.2)
# prior; AdamW warm start at batch 256; datapoint_limit 50,000 split
# 0.7/0.1/0.2). Cut in memory (TEXT_CUT): the data (the config's Hugging
# Face imdb corpus is not in the repository: a synthetic corpus of
# TEXT_TEXTS texts written to results/, made from TEXT_SEED; IMDB has
# 50,000, and a step over 35,000 training sequences took 2.25 s), the
# tokenizer (single_char
# with context_len 70: custom_bpe needs the `tokenizers` package, and the
# config's `parameters: {}` would pad to the loader's default 64), the
# likelihood chunks (the config sets none; unchunked, the attention weights
# alone, 8 x 70 x 70 floats per chain and sequence, take 44 GB a tensor),
# and the step counts (5 warm-start epochs of 200, about as many AdamW
# steps as one epoch of 35,000; 30 tuner steps of 50,000, the fewest that
# give a finite L; 10 sampling steps thinned by 5, of 10,000 by 100: 2
# draws a chain).
TEXT_CONFIG = ROOT / 'configs' / 'additional_tasks' / 'sequential_mod.yaml'
TEXT_RESULTS = ROOT / 'results' / 'chip_smoke_text'
TEXT_CORPUS = ROOT / 'results' / 'chip_smoke_imdb.csv'
TEXT_SEED = 2025
TEXT_SHAPE = (8, 65_248)
TEXT_TEXTS = 10_000
TEXT_TRAIN = 7_000        # the config's split 0.7 / 0.1 / 0.2
TEXT_CHARS = 999          # + PAD: the model's vocabulary of 1,000
# each character comes from its class's own Zipf ranking with this
# probability, else from a ranking both classes share: a Bayes classifier
# of the first 70 characters is right about 88 % of the time (IMDB's
# attention classifiers reach about that), so the model's likelihood is
# not saturated (at accuracy 1 its float32 gradient carries 1 - p of p
# near 1, about 1e-4 relative noise, as a first corpus of disjoint
# classes showed)
TEXT_CLASS_MIX = 0.05
TEXT_CUT = {'data.source': 'local',
            'training.tokenizer.name': 'single_char',
            'training.tokenizer.parameters': {'context_len': 70},
            'training.sampler.likelihood_chunk_size': 4096,
            'training.warmstart.max_epochs': 5,
            'training.sampler.warmup_steps': 30,
            'training.sampler.n_samples': 10,
            'training.sampler.n_thinning': 5}
# a batch of training sequences with pads, and one all pads: the card's
# forward against the CPU's in float32, within TEXT_PAD_TOL
TEXT_PAD_TOL = 1e-5

# The NUTS path: the config's 12 chains, FCN [16,16,16,2] and tree depth 10
# (up to 1023 leapfrog steps a draw); only the step counts are cut (the
# warm start to 5 epochs, 6 adaptation steps, 2 draws), so that at that
# worst-case depth the phase stays within about a minute
NUTS_CONFIG = ROOT / 'configs' / 'illustrative_airfoil_nuts.yaml'
NUTS_RESULTS = ROOT / 'results' / 'chip_smoke_nuts'
NUTS_CUT = {'training.warmstart.max_epochs': 5,
            'training.sampler.warmup_steps': 6,
            'training.sampler.n_samples': 2}
# One NUTS step on the card against the same step on the CPU, from the
# card's state with the same draws, at tree depth 5 (31 leapfrog steps),
# the tuned step sizes, and two chains' step sizes raised 30 and 1000
# times (a short tree, a divergence): the trees must be the same and the
# positions (of order 1) within NUTS_STEP_ATOL. At the path's depth 10 the
# trees agree but 1023 float32 steps amplify the two paths' rounding until
# the multinomial choice of the proposal differs in some chains.
NUTS_STEP_DEPTH = 5
NUTS_STEP_EPS_SCALE = [1.0] * 10 + [30.0, 1000.0]
NUTS_STEP_ATOL = 1e-4
# the profiled NUTS draw: the sampling kernel at depth 7 (up to 127 batched
# leaves, each the same work as at depth 10): on an H100 host the
# profiler's own post-processing of a depth-10 draw (170,000 kernels)
# takes about 90 s
NUTS_PROFILE_DEPTH = 7
HMC_CUT = {'training.sampler.name': 'hmc',
           'training.sampler.warmup_steps': 30,
           'training.sampler.n_samples': 20}

# Mid-chain resume of run_mclmc on the main path's posterior and members
# (12 chains, dim 674, CUT's 200 tuner and 200 sampling steps thinned by
# 10: 20 kept draws) in chunks of RESUME_CHUNK_KEPT kept draws (4 chunks):
# an uninterrupted run, a run whose sink stops it after its second chunk,
# the resumed run; then a run stopped inside chunk 0 and its resumed run.
# Each is held bit for bit against the uninterrupted run.
RESUME_RESULTS = ROOT / 'results' / 'chip_smoke_resume'
RESUME_CHUNK_KEPT = 5
RESUME_SEED = 29
# NUTS resume on the NUTS path's posterior and members at tree depth 5 (the
# depth of the NUTS step check): 20 adaptation steps, 6 draws in 3 chunks
# of 2, stopped after the first chunk, resumed, held bit for bit
NUTS_RESUME_CUT = {'training.sampler.max_num_doublings': 5,
                   'training.sampler.warmup_steps': 20,
                   'training.sampler.n_samples': 6,
                   'training.sampler.n_thinning': 1}
NUTS_RESUME_CHUNK_KEPT = 2
# The trainer on the main path's config (CUT, the warm start cut further to
# STREAM_EPOCHS epochs) with stream_samples, then a second trainer that
# reuses the first one's warm start
STREAM_EPOCHS = 2
STREAM_RESULTS = ROOT / 'results' / 'chip_smoke_stream'
REUSE_RESULTS = ROOT / 'results' / 'chip_smoke_reuse'
# Symmetric-split HMC (experiments/torch_symmetric_splitting.py) at LeNet
# width (dim 61,706) on the image path's synthetic archive: the
# reference's batch 64, 30 leapfrog steps, step 5e-4 and mass 0.01, on
# 4,096 images (3,153 for training: 49 shards, 2 x 49 x 30 = 2,940 shard
# gradients a proposal), 2 proposals of which 1 is burnt (on an NVIDIA
# H100 80GB HBM3 at 700 W a proposal took 7.4-15.5 s, host-bound, and 6
# proposals, 2 burnt, made the phase 123 s on the slower host). One
# split-leapfrog step (98 shard gradients) on the card against the CPU's
# from the same theta and p in float32: the end point's change within
# SPLIT_STEP_RTOL of the largest change, for theta and p apart (the image
# path's likelihood gradient agrees card vs CPU to about 3e-5 of its max)
SPLIT_SCRIPT = ROOT / 'experiments' / 'torch_symmetric_splitting.py'
SPLIT_ARGS = ['--source', 'local', '--datapoint-limit', '4096',
              '--num-samples', '2', '--burn', '1']
SPLIT_SHAPE = (49, 64, 61_706)   # shards, batch, dim
SPLIT_STEP_RTOL = 1e-4
# More than one device, on one card: a mesh whose entries repeat cuda:0.
# The trainer on the main path's config (CUT) with MESH_CHAINS chains over
# MESH_ENTRIES entries: 13 chains do not divide over 2, so sampling pads
# them to 14 (7 an entry) and drops the pad chain from every result and
# from the sink. run_mclmc on the main path's posterior and members over a
# 4-entry chain mesh and a 2 x 2 chains x data mesh, step counts cut to
# MESH_RUN_CUT; then MESH_STEPS steps on each mesh, each from the
# one-device run's state with its injected normals, held against the
# one-device step as the main path's card-vs-CPU check holds them:
# positions within atol MESH_X_ATOL, dE within MESH_DE_UNITS float32
# units of |logp|+|logp'|+|dK| (the 2 x 2 mesh sums each chain's
# log-likelihood in two halves, which rounds otherwise). The image path's
# full-batch LeNet value and gradient at the tuned state over a chain mesh
# of cuda:0 twice against the unsharded one: value rtol GRAD_RTOL,
# gradient atol GRAD_GTOL max|g| (float32 both; cuDNN may pick other
# algorithms for 5 chains than for 10).
MESH_RESULTS = ROOT / 'results' / 'chip_smoke_mesh'
MESH_CHAINS, MESH_ENTRIES = 13, 2
MESH_RUN_CUT = {'training.sampler.warmup_steps': 50,
                'training.sampler.n_samples': 50,
                'training.sampler.n_thinning': 10}
MESH_STEPS = 10
MESH_X_ATOL, MESH_DE_UNITS = 1e-4, 64.0
# Two processes on cuda:0 joined over gloo (this script run again with
# --multiprocess-worker), each holding a chain mesh of cuda:0 twice: 4
# entries over both ranks; run_mclmc on the main path's posterior and
# members (MESH_RUN_CUT) gives rank 0 the draws of one process's mesh of 4
# entries, bit for bit; the in-step check raises on ranks that differ; the
# ensemble goes through torch.distributed.checkpoint written by both
# ranks and comes back equal; BDETrainer.train_warmstart over both ranks
# (the main path's config with the warm start cut to MP_WS_EPOCHS epochs,
# 128 AdamW steps, 12 members in rows of 3 over the 4 entries, every rank
# running the loop on the gathered gradients) gives one process's members
# of the same config within MESH_WS_RTOL.
MP_RESULTS = ROOT / 'results' / 'chip_smoke_multiprocess'
MP_SEED = 31
MP_TIMEOUT_S = 300
MP_WS_EPOCHS = 4
# checkpoint_format: orbax: the MCLMC resume runs stopped after chunk 2
# and inside chunk 0 with the snapshot as a torch.distributed.checkpoint,
# each resumed bit for bit; a trainer (CUT, STREAM_EPOCHS warm-start
# epochs) writing warmstart/orbax/ and a second one reusing it with its
# npz members gone
ORBAX_RESULTS = ROOT / 'results' / 'chip_smoke_orbax'
# The warm start over a chain mesh: train_ensemble on the padded mesh
# trainer's model and data (13 members, CUT's 20 epochs) over cuda:0 twice
# (rows of 7 and 6 members) against one device. The members agree within
# MESH_WS_RTOL of their largest entry: cuBLAS may pick other kernels for
# 7 rows of members than for 13, and AdamW's normalised step turns the
# float32 rounding of a gradient entry near 0 into a step of up to the
# learning rate
MESH_WS_RTOL = 1e-3

# The study catalogue (experiments/torch_run_catalog.py): ten jobs of
# build_jobs() run by run_queue on the card into CATALOG_RESULTS, each at
# its config's full width (sonar FCN [16, 16, 2], bikesharing FCN
# [16, 16, 16, 2] and [48, 48, 48, 2], protein at 40,000 rows, airfoil with
# a bf16 forward, the 10-layer feasibility FCN with and without diagonal
# preconditioning, the deep-8 diagnostics FCN; 12 chains each), the step
# counts cut in memory as CUT cuts the main path: the warm start to 2
# epochs, the tuner to 100 steps, sampling to 100 steps at the config's
# thinning; the NUTS job (depth capped at 8 by the catalogue) to 6
# adaptation steps and 8 draws (the fewest for which the diagnostics take
# a split R-hat). Three jobs reuse a provider's warm start.
CATALOG_RESULTS = RESULTS / 'catalog'
CATALOG_JOBS = ('tabular_classif/sonar_mclmc_r1',
                'hyper_params/bike_mclmc_ev0.5_0.1_r1',
                'hyper_params/bike_mclmc_trust2.0_r1',
                'complexity/bike_mclmc_48x48x48_r1',
                'complexity/bike_nuts_48x48x48_r1',
                'datasize/protein_mclmc_n40000_r1',
                'dtype_ab/airfoil_mclmc_bf16fwd_r1',
                'feasibility/feas_mclmc_airfoil',
                'feasibility/feas_tuned_airfoil',
                'diagnostics/diag_mclmc_airfoil_r1')
CATALOG_CUT = {'training.warmstart.max_epochs': 2,
               'training.sampler.warmup_steps': 100,
               'training.sampler.n_samples': 100}
CATALOG_NUTS_CUT = {'training.warmstart.max_epochs': 2,
                    'training.sampler.warmup_steps': 6,
                    'training.sampler.n_samples': 8}
# The runner's fault contract with real CUDA errors: this script run again
# with --catalog-fault-worker MODE ROOT, its trainer replaced by one that
# indexes out of range on the card (a device-side assert), three times
# over one root; then one whose job sleeps past --job-timeout
FAULT_RESULTS = ROOT / 'results' / 'chip_smoke_catalog_fault'
FAULT_JOB = ['--only', 'datasize', '--name-filter',
             '^protein_mclmc_n40000_r1$']
FAULT_HANG_TIMEOUT_S = 5
FAULT_WORKER_TIMEOUT_S = 300
# The study queue's relaunch loop (experiments/torch_catalog_queue.py) on
# the card: a drill with the assert worker above as its runner (cool-off
# 1 s), then a STOP file ending a later stage; then the dataset study's six
# r1 jobs with their step counts cut to CATALOG_CUT (this script run again
# with --catalog-cut-worker as the runner), pooled into QUEUE_AGGR (never
# aggr_results_torch/) and compared with torch_compare_study.py
QUEUE_DRILL_RESULTS = ROOT / 'results' / 'chip_smoke_queue_drill'
QUEUE_RESULTS = RESULTS / 'queue'
QUEUE_AGGR = RESULTS / 'queue_aggr'
QUEUE_COOLOFF_S = 1
QUEUE_STOP_STAGE = ('dataset', '^uci_mclmc_yacht_r1$')
# Then the comparison's other two modes: the catalogue phase's cut sonar
# job pooled and compared through the classification metric set, and the
# feasibility study's energy pair (the 10-layer FCN, dim 2,354, the tuned
# arm with diagonal preconditioning: K1's preconditioned route) cut to
# CATALOG_CUT through the loop, pooled and compared value by value
CLASSIF_JOBS = ['sonar_mclmc_r1']
CLASSIF_METRICS = ['lppd', 'acc', 'step_size_mean', 'L_mean']
FEAS_JOBS = ['feas_mclmc_energy', 'feas_tuned_energy']
FEAS_METRICS = ['lppd', 'rmse', 'cal_error', 'coverage_0.9',
                'step_size_mean', 'L_mean']
DATASET_SETS = ('airfoil', 'concrete', 'energy', 'yacht', 'bikesharing',
                'protein')
# Then one cut job of each mixed study's MCLMC or DE half through the loop
# (the deep-8 FCN on energy, the DE arm on bikesharing at width 48, protein
# at 5,000 rows) with their K1/K3 shapes, pooled and compared with the
# chains' diagnostics (the table that every comparison here also checks)
MIXED_STUDIES = ('diagnostics', 'complexity', 'datasize')
MIXED_SHAPES = {'diag_mclmc_energy_r1': (12, 450),
                'bike_de_48x48x48_r1': (12, 5_426),
                'protein_mclmc_n5000_r1': (12, 738)}
DIAGNOSTICS = ['mean_ess', 'mean_split_rhat', 'mean_bcv', 'mean_wcv',
               'fs_ess', 'fs_split_rhat']
# and the datasize study's NUTS job at 5,000 rows (depth 8), cut to
# CATALOG_NUTS_CUT, after its MCLMC provider in the same root, whose warm
# start it reuses: pooled and compared with the third table, the trees'
# statistics
QUEUE_NUTS_JOB, QUEUE_NUTS_PROVIDER = ('protein_nuts_n5000_r1',
                                       'protein_mclmc_n5000_r1')
NUTS_STATS = ['mean_acceptance_rate', 'mean_num_integration_steps',
              'n_divergent']
# The dataset jobs, the feasibility pair and the mixed studies' jobs go
# through the loop as one stage of five studies: one runner process (a
# runner takes about 13 s to reach the card; one stage a study made the
# phase 236 s)
QUEUE_STAGE = ('dataset,feasibility,' + ','.join(MIXED_STUDIES),
               '^(uci_mclmc_[a-z]+_r1|feas_(mclmc|tuned)_energy|'
               + '|'.join([*MIXED_SHAPES, QUEUE_NUTS_JOB]) + ')$')
# The catalogue phase's two cut hyper_params jobs (the energy-variance
# point that provides its seed's warm start, and a trust value reusing it)
# pooled and compared through both tables against the three JAX seeds
HYPER_JOBS = ['bike_mclmc_ev0.5_0.1_r1', 'bike_mclmc_trust2.0_r1']
HYPER_METRICS = ['lppd', 'rmse', 'cal_error', 'coverage_0.9',
                 'step_size_mean', 'L_mean']
# A real preemption: this script run again with --preempt-worker ROOT runs
# BDETrainer on the main path's config at CUT, its warm start cut to 2
# epochs, with checkpoint_sampling and 600 sampling steps in chunks of PREEMPT_CHUNK_KEPT kept draws (the
# trainer's 1 GiB chunks would hold the whole run in one), and is killed
# with SIGKILL once a chunk is on disk; then one trainer run with profile:
# true, its step counts cut to PROFILE_CUT
PREEMPT_RESULTS = ROOT / 'results' / 'chip_smoke_preempt'
PREEMPT_CUT = {**CUT, 'training.warmstart.max_epochs': 2,
               'training.sampler.n_samples': 600,
               'training.sampler.checkpoint_sampling': True}
PREEMPT_CHUNK_KEPT = 5
PREEMPT_TIMEOUT_S = 300
PROFILE_RESULTS = ROOT / 'results' / 'chip_smoke_profile'
PROFILE_CUT = {'training.warmstart.max_epochs': 1,
               'training.sampler.warmup_steps': 100,
               'training.sampler.n_samples': 50}
# The wide-FCN dtype A/B (experiments/torch_dtype_ab_widefcn.py) at the
# JAX script's width: FCN [512, 512, 512, 2] over 65,536 x 128 rows, 12
# chains, dim 592,386 (K1 and K3 on the streaming-cluster route), its four
# arms each in a subprocess, the tuner cut to 30 steps (of 500) and the
# timed block to 5 (of 10)
# The TPU's one bfloat16 pass: the card's route against the CPU's at the
# models' shapes (seeded inputs), and the airfoil trainer cut as the
# catalogue's jobs, with 500 sampling steps for a steadier rate, at the
# exact default and under the TPU setting in turns
PRECISION_SEED = 12
LENET_CONV2 = (6, 16, 5, 14, 0)   # in, out, kernel, input side, padding
PRECISION_RESULTS = ROOT / 'results' / 'chip_smoke_precision'
PRECISION_CUT = {**CATALOG_CUT, 'training.sampler.n_samples': 250}
AB_SCRIPT = ROOT / 'experiments' / 'torch_dtype_ab_widefcn.py'
AB_RESULTS = ROOT / 'results' / 'chip_smoke_dtype_ab.jsonl'
AB_WIDTH, AB_SHAPE = 512, (12, 592_386)
# (at 20 tuner steps phase 3 traces 2 steps, and a coordinate that does
# not move in them gives its chain L = NaN, as in the JAX tuner)
AB_WARMUP, AB_TIMED = 30, 2
AB_TIMEOUT_S = 900
# The NUTS timing scripts (no hand-written kernel) at tree depth 10, the
# step counts cut: a depth-10 step is up to 1023 batched leaves (about 5
# ms of host time each on the card eagerly, the NUTS path's), so 3 adaptation
# steps (of 500) run twice, and 3 adaptation steps (of 100) and 2 draws
# (of 200)
NUTS_SCRIPTS = {'torch_time_warmup.py': ['3', '8'],
                'torch_profile_nuts.py': ['--warmup-steps', '3',
                                          '--draws', '2']}
NUTS_SCRIPT_TIMEOUT_S = 600
# The bench phase: bench_torch.py's modes in this process at full width
# (the airfoil FCN, LeNet over 60,000 images, the wide FCN over 65,536
# rows), the step counts cut: the headline's tuner to 200 steps (of 2,000)
# and 3 timed blocks of 150 (of 7 of 3,000), the warm start to 10 epochs
# (of 200), the airfoil chain scaling to 50 steps (of 1,000), the wide
# FCN's to 3 (of 10), the LeNet and wide-FCN points to 3 (of 30 and 10),
# the CPU denominators to 50 steps
BENCH_RESULTS = ROOT / 'results' / 'chip_smoke_bench'
BENCH_HEADLINE = {'warmup_steps': 200, 'timed_steps': 150, 'n_repeats': 3}
BENCH_WS_EPOCHS = 10
BENCH_AIRFOIL = ([12, 48, 192, 768, 1_536], 50)
BENCH_FCN = ([4, 12, 48], 3)
BENCH_MFU_STEPS = 3
BENCH_CPU_STEPS = 50
# K3 at 1,536 chains: refreshes with a device step counter, whose per-chain
# noise is held against chance correlation
PHILOX_CHAINS_STEPS = 200


class SimulatedStop(Exception):
    """Stops a sampling run part way, as a preemption would."""


class StopAfter:
    """A sample sink that stops the run when it receives its ``n``-th
    chunk (after that chunk and its snapshot are on disk)."""

    def __init__(self, n: int):
        self.n, self.seen = n, 0

    def __call__(self, chunk, start):
        self.seen += 1
        if self.seen >= self.n:
            raise SimulatedStop(f'after chunk {self.seen}')


def kernel_bytes(n_chains: int, dim: int,
                 preconditioned: bool = False) -> tuple[int, int]:
    """Bytes that K1 and K3 must move in an MCLMC step's fused calls:
    K1 reads u, g, x (and the preconditioner) and eps and writes u' and
    x', the dK sum read and written; K3 reads u, eps, L, dK, logp' and
    logp and writes u' and dE, both sums and the counter read and
    written."""
    elems = n_chains * dim
    k1 = 4 * ((6 if preconditioned else 5) * elems + 3 * n_chains)
    k3 = 4 * (2 * elems + 10 * n_chains) + 16
    return k1, k3


def tuner_steps(warmup_steps: int, diagonal_preconditioning: bool) -> int:
    """MCLMC steps of the tuner: its three phases and, with diagonal
    preconditioning, the re-adjustment after phase 2 (as
    ``mclmc_tuning.mclmc_tune`` counts them)."""
    from mile_tpu_torch.mcmc.adaptation.mclmc_tuning import TuningConfig

    t1, t2, t3 = (int(warmup_steps * r) for r in TuningConfig().phase_ratio)
    return t1 + t2 + t3 + (t2 // 3 if diagonal_preconditioning else 0)


def mclmc_steps(scfg) -> int:
    """MCLMC steps of a run of sampler config ``scfg``: the tuner's, then
    the sampling steps up to the last kept draw."""
    return (tuner_steps(scfg.warmup_steps, scfg.diagonal_preconditioning)
            + math.ceil(scfg.n_samples / scfg.n_thinning) * scfg.n_thinning)


def fail(msg: str) -> None:
    print(f'chip_smoke: {msg}', file=sys.stderr)
    sys.exit(1)


class Smoke:
    def __init__(self, torch, device: str = 'cuda'):
        self.torch = torch
        self.dev = torch.device(device)
        self.failures: list[str] = []
        self.k1_err = 0.0
        self.k3_err = 0.0
        self.launches = {}
        self.path_launches = {}     # the image and text paths', by path
        self.timings = {}
        self.phase_s = {}           # each phase's seconds, by its name

    # ---------------------------------------------------------- helpers
    def check(self, ok: bool, what: str) -> None:
        print(f'  [{"ok" if ok else "FAIL"}] {what}')
        if not ok:
            self.failures.append(what)

    def phase(self, name: str, fn) -> bool:
        print(f'== {name}', flush=True)
        t0 = time.perf_counter()
        key = name.split(':')[0]
        try:
            fn()
            self.torch.cuda.synchronize()
        except Exception:
            traceback.print_exc(file=sys.stdout)
            self.failures.append(f'{name}: exception')
            self.phase_s[key] = time.perf_counter() - t0
            print(f'== {name}: FAILED after {self.phase_s[key]:.1f} s',
                  flush=True)
            return False
        self.phase_s[key] = time.perf_counter() - t0
        print(f'== {name}: {self.phase_s[key]:.1f} s', flush=True)
        return True

    def cuda_tensor(self, a):
        return self.torch.from_numpy(a).to(self.dev)

    # ------------------------------------------------------------ build
    def build(self):
        from mile_tpu_torch.ops import build

        path = build.build('isokinetic')
        print(f'  built isokinetic.cu -> {path.relative_to(ROOT)}')
        for line in path.with_suffix('.log').read_text().splitlines():
            if 'entry function' in line or 'registers' in line \
                    or 'spill' in line:
                print(f'    ptxas: {line.strip()}')
        build.isokinetic_library()

    # ----------------------------------------------------------- K1
    def k1(self):
        from mile_tpu_torch.ops import isokinetic as ops

        # the main path's shapes (12 and 1 chains of 674), a multiple of 4
        # (float4 loads), and the two cluster routes: resident in registers
        # (40,000) and streaming (300,000)
        for n_chains, dim in [MAIN_SHAPE, (1, 674), (5, 2048), (2, 40_000),
                              IMAGE_SHAPE, TEXT_SHAPE, (2, 300_000)]:
            route = ops.kernel_route(dim)
            print(f'  route at dim {dim}: {route}')
            if dim == 300_000:
                self.check(route.cluster > 1 and not route.resident,
                           f'dim {dim} takes the streaming cluster route')
            self._k1_check(n_chains, dim)
        for n_chains, dim in [(3, 128), (1, 674)]:
            u = self.torch.randn(n_chains, dim, device=self.dev)
            u = u / u.norm(dim=1, keepdim=True)
            ku, kdk = ops.isokinetic_momentum(
                u, self.torch.zeros_like(u),
                self.torch.full((n_chains,), 0.1, device=self.dev))
            err = float((ku - u).abs().max())
            # dK = (d-1)(log1p(1) - log 2): one float32 rounding of log 2,
            # times d-1
            bound = (dim - 1) * 1.2e-7
            self.check(err <= 1e-6 and float(kdk.abs().max()) <= bound,
                       f'K1 zero gradient ({n_chains}, {dim}): identity, '
                       f'max|du| {err:.1e} (atol 1e-6), max|dK| '
                       f'{float(kdk.abs().max()):.1e} (<= {bound:.1e})')
        u = self.torch.zeros(2, 16, device=self.dev)
        for what, args in (
                ('float64', (u.double(), u.double(), 0.1)),
                ('non-contiguous g', (u, u.t().contiguous().t(), 0.1)),
                ('(3, dim) sqrt_diag_cov for 2 chains',
                 (u, u, 0.1, self.torch.ones(3, 16, device=self.dev)))):
            try:
                ops.isokinetic_momentum(*args)
                refused = False
            except ValueError:
                refused = True
            self.check(refused, f'K1 refuses {what} before launching')

    def _k1_check(self, n_chains: int, dim: int) -> None:
        """K1 against its plain version at (n_chains, dim) on the card, with
        a per-chain, a shared and no sqrt_diag_cov, plain and with the
        drift and the dK sum fused in."""
        import numpy as np

        from mile_tpu_torch.ops import isokinetic as ops

        coef = 0.1931833275037836
        rng = np.random.default_rng(dim + n_chains)
        g = rng.normal(size=(n_chains, dim)).astype(np.float32)
        # u partly aligned with g, and delta = eps|g|/(d-1) of order 1,
        # keep dK = (d-1)(delta - log 2 + log1p(...)) away from the
        # cancellation where float32 rounding alone exceeds rtol 2e-4
        u = g + rng.normal(size=g.shape).astype(np.float32)
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        sdc = rng.uniform(0.5, 1.5, size=g.shape).astype(np.float32)
        eps = (rng.uniform(0.5, 2.0, n_chains)
               * dim ** 0.5 / coef).astype(np.float32)
        # the fused call: a sampler-sized step for the drift (so that
        # x' = x + 0.5 eps u' s stays near x, away from zero, and is held
        # to rtol 1e-6) and a large stage fraction for the rotation (the
        # same rotation as above)
        step = (eps * coef / dim ** 0.5 * 0.02).astype(np.float32)
        big_coef = dim ** 0.5 / 0.02
        x = (rng.choice([-1.0, 1.0], size=g.shape)
             * rng.uniform(0.5, 1.5, size=g.shape)).astype(np.float32)
        kinetic = rng.normal(size=n_chains).astype(np.float32) * 100.0
        u_t, g_t, eps_t, sdc_t, step_t, x_t, kin_t = map(
            self.cuda_tensor, (u, g, eps, sdc, step, x, kinetic))
        for label, sd in (('per-chain', sdc_t), ('shared', sdc_t[0]),
                          ('none', None)):
            ku, kdk = ops.isokinetic_momentum(u_t, g_t, eps_t, sd, coef)
            pu, pdk = ops.isokinetic_momentum_plain(u_t, g_t, eps_t, sd,
                                                    coef)
            kk, pk = kin_t.clone(), kin_t.clone()
            fu, fk, fx = ops.isokinetic_momentum(
                u_t, g_t, step_t, sd, big_coef, x=x_t, x_frac=0.5,
                kinetic=kk)
            qu, _, qx = ops.isokinetic_momentum_plain(
                u_t, g_t, step_t, sd, big_coef, x=x_t, x_frac=0.5,
                kinetic=pk)
            self.torch.cuda.synchronize()
            err = float(max((ku - pu).abs().max(), (fu - qu).abs().max()))
            rel = float(max(((kdk - pdk).abs()
                             / (1e-5 + 2e-4 * pdk.abs())).max(),
                            ((kk - pk).abs()
                             / (1e-5 + 2e-4 * pk.abs())).max()))
            x_rel = float(((fx - qx).abs() / qx.abs()).max())
            self.k1_err = max(self.k1_err, err)
            self.check(err <= 2e-5 and rel <= 1.0 and x_rel <= 1e-6
                       and fk is kk
                       and bool(self.torch.isfinite(kdk).all()),
                       f'K1 ({n_chains}, {dim}) sqrt_diag_cov {label}, '
                       f'plain and with drift + dK sum: max|du| '
                       f'{err:.2e} (atol 2e-5), dK within {rel:.2f} of '
                       f'rtol 2e-4 + atol 1e-5, x\' rel {x_rel:.1e} '
                       f'(rtol 1e-6), dK summed in place')

    # ----------------------------------------------------------- K3
    def k3(self):
        torch = self.torch
        from mile_tpu_torch.ops import isokinetic as ops

        gen = torch.Generator().manual_seed(3)

        def unit(n_chains, dim):
            u = torch.randn(n_chains, dim, generator=gen)
            return (u / u.norm(dim=1, keepdim=True)).to(self.dev)

        for n_chains, dim in [MAIN_SHAPE, (6, 674), (1, 674), (2, 40_000),
                              IMAGE_SHAPE, TEXT_SHAPE, (2, 300_000)]:
            self._k3_check(n_chains, dim, gen)

        # Philox mode: the statistics of tests/test_pallas_ops.py
        for n_chains, dim in [(6, 674), (1, 674)]:
            u = unit(n_chains, dim)
            eps = torch.full((n_chains,), 0.1, device=self.dev)
            L = torch.ones(n_chains, device=self.dev)
            dots, outs = [], []
            for seed in range(20):
                out = ops.partial_refresh(u, eps, L, seed=seed, counter=0)
                outs.append(out)
                dots.append((out * u).sum(dim=1))
            outs = torch.stack(outs)
            dots = torch.stack(dots)
            norm_err = float((outs.norm(dim=-1) - 1.0).abs().max())
            self.check(norm_err <= 1e-5, f'K3 Philox ({n_chains}, {dim}): '
                       f'unit norm, max err {norm_err:.1e} (1e-5)')
            nu2 = (math.exp(2 * 0.1 / 1.0) - 1.0) / dim
            want = 1.0 / math.sqrt(1.0 + nu2 * dim)
            got = float(dots.mean())
            self.check(abs(got - want) < 0.1 and float(dots.std()) > 1e-4,
                       f'K3 Philox ({n_chains}, {dim}): E<u,u\'> {got:.4f} '
                       f'vs {want:.4f} (0.1), std over seeds '
                       f'{float(dots.std()):.2e} (> 1e-4)')
            if n_chains > 1:
                corr = torch.corrcoef((outs[0] - u))
                off = corr[~torch.eye(n_chains, dtype=torch.bool,
                                      device=self.dev)]
                self.check(float(off.abs().max()) < 0.2,
                           f'K3 Philox ({n_chains}, {dim}): cross-chain '
                           f'|corr| {float(off.abs().max()):.3f} (< 0.2)')
            a = ops.partial_refresh(u, eps, L, seed=7, counter=0)
            b = ops.partial_refresh(u, eps, L, seed=7, counter=1)
            again = ops.partial_refresh(u, eps, L, seed=7, counter=0)
            self.check(bool(torch.equal(a, again)) and not torch.allclose(a, b),
                       f'K3 Philox ({n_chains}, {dim}): same key same noise, '
                       f'another step counter other noise')

        # the normals themselves: with nu^2 d >> 1 the refreshed vector is
        # nearly z/|z|, so sqrt(d) u' is nearly standard normal
        dim = 300_000
        u = torch.full((2, dim), dim ** -0.5, device=self.dev)
        eps, L = torch.full((2,), 5.0, device=self.dev), \
            torch.ones(2, device=self.dev)
        x = ops.partial_refresh(u, eps, L, seed=11, counter=3) * dim ** 0.5
        mean, var = float(x.mean()), float(x.var())
        kurt = float(((x - mean) ** 4).mean() / var ** 2)
        self.check(abs(mean) < 0.02 and abs(var - 1.0) < 0.02
                   and abs(kurt - 3.0) < 0.1,
                   f'K3 Philox normals (2, {dim}): mean {mean:.4f} (0.02), '
                   f'var {var:.4f} (1 +- 0.02), kurtosis {kurt:.3f} (3 +- 0.1)')
        # one Philox call gives a group of 4 normals: the cosine and sine of
        # two Box-Muller pairs. Over the 600k draws (300k pairs; sampling
        # sd of a correlation 1/sqrt(300k) = 0.0018), the pair's two
        # normals, their squares, and neighbours across pairs and groups
        # are uncorrelated.
        groups = x.reshape(-1, 4)

        def corr(a, b):
            return float(torch.corrcoef(torch.stack([a, b]))[0, 1])

        pairs = {'cos-sin': corr(groups[:, 0], groups[:, 1]),
                 'cos-sin, 2nd pair': corr(groups[:, 2], groups[:, 3]),
                 'squares': corr(groups[:, 0] ** 2, groups[:, 1] ** 2),
                 'across pairs': corr(groups[:, 1], groups[:, 2]),
                 'across groups': corr(groups[:-1, 3], groups[1:, 0])}
        self.check(all(abs(v) < 0.01 for v in pairs.values()),
                   'K3 Philox (2, 300000): correlations '
                   + ', '.join(f'{k} {v:+.4f}' for k, v in pairs.items())
                   + ' (each |corr| < 0.01)')
        self._k3_graph()

    def _k3_check(self, n_chains: int, dim: int, gen) -> None:
        """K3 with injected noise against its plain version at (n_chains,
        dim) on the card, plain and with dE and its sums fused in."""
        torch = self.torch
        from mile_tpu_torch.ops import isokinetic as ops

        u = torch.randn(n_chains, dim, generator=gen)
        u = (u / u.norm(dim=1, keepdim=True)).to(self.dev)
        z = torch.randn(n_chains, dim, generator=gen).to(self.dev)
        eps = torch.rand(n_chains, generator=gen).to(self.dev) * 0.2 + 0.05
        L = torch.rand(n_chains, generator=gen).to(self.dev) * 2.0 + 0.5
        out = ops.partial_refresh(u, eps, L, z=z)
        err = float((out - ops.partial_refresh_plain(u, eps, L, z))
                    .abs().max())
        # with dE fused in, and its running sums
        energy = [(torch.randn(n_chains, generator=gen) * 100.0)
                  .to(self.dev) for _ in range(5)]
        k_sums = (energy[3].clone(), energy[4].clone())
        p_sums = (energy[3].clone(), energy[4].clone())
        k_out, k_de = ops.partial_refresh(u, eps, L, z=z,
                                          energy=energy[:3],
                                          energy_sums=k_sums)
        p_out, p_de = ops.partial_refresh_plain(u, eps, L, z,
                                                energy=energy[:3],
                                                energy_sums=p_sums)
        err = max(err, float((k_out - p_out).abs().max()))
        same = (torch.equal(k_de, p_de) and torch.equal(k_sums[0], p_sums[0])
                and torch.equal(k_sums[1], p_sums[1]))
        self.k3_err = max(self.k3_err, err)
        self.check(err <= 1e-6 and same,
                   f'K3 injected noise ({n_chains}, {dim}), plain and '
                   f'with dE + its sums: max|du| {err:.2e} (atol 1e-6), '
                   f'dE and sums equal the plain version\'s: {same}')

    def _k3_graph(self):
        """K3 with a device step counter, captured in a CUDA graph and
        replayed three times: three different refreshes, each equal to
        the eager call at the counter's value for that replay."""
        torch = self.torch
        from mile_tpu_torch.ops import isokinetic as ops

        n_chains, dim = MAIN_SHAPE
        gen = torch.Generator().manual_seed(21)
        u = torch.randn(n_chains, dim, generator=gen)
        u = (u / u.norm(dim=1, keepdim=True)).to(self.dev)
        eps = torch.full((n_chains,), 0.1, device=self.dev)
        L = torch.ones(n_chains, device=self.dev)
        counter = ops.step_counter(0, self.dev)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):   # warm-up, as capture asks
            ops.partial_refresh(u, eps, L, 17, counter)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = ops.partial_refresh(u, eps, L, 17, counter)
        outs, values = [], []
        for _ in range(3):
            values.append(ops.counter_step(counter))
            graph.replay()
            outs.append(out.clone())
        torch.cuda.synchronize()
        fresh = all(not torch.equal(outs[i], outs[j])
                    for i, j in ((0, 1), (0, 2), (1, 2)))
        matched = all(torch.equal(o, ops.partial_refresh(u, eps, L, 17, v))
                      for o, v in zip(outs, values))
        last = ops.counter_step(counter)
        self.check(fresh and matched and last == values[-1] + 1
                   and int(counter) == last << 24,
                   f'K3 in a CUDA graph with a device counter: 3 replays at '
                   f'steps {values} -> {last}, fresh noise each: {fresh}, '
                   f'each equal to the eager call at its step: {matched}, '
                   f'ticket bits back to {int(counter) & 0xFFFFFF}')

    # ------------------------------------------------------- main path
    def main_path(self):
        import numpy as np
        import shutil

        torch = self.torch
        from mile_tpu_torch.config import Config
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.train.checkpoint import load_flat_samples
        from mile_tpu_torch.train.trainer import BDETrainer

        (config,) = Config.from_file(CONFIG)
        config = config.replace(saving_dir=str(RESULTS.parent),
                                experiment_name=RESULTS.name, **CUT)
        scfg = config.training.sampler
        shutil.rmtree(RESULTS, ignore_errors=True)
        trainer = BDETrainer(config, device=self.dev)
        self.check(trainer.bayes.dim == MAIN_SHAPE[1]
                   and scfg.n_chains == MAIN_SHAPE[0],
                   f'full width: dim {trainer.bayes.dim}, '
                   f'{scfg.n_chains} chains, '
                   f'{trainer.loader.arrays("train")[0].shape[0]} training '
                   f'rows')

        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        members, result, metrics, phase_s = self._train(trainer)
        self.launches = {'isokinetic_momentum': ops.isokinetic_momentum.launches,
                         'partial_refresh': ops.partial_refresh.launches}
        self.timings['main_path_peak_device_mib'] = \
            torch.cuda.max_memory_allocated() / 2 ** 20

        n_kept = math.ceil(scfg.n_samples / scfg.n_thinning)
        n_steps = scfg.warmup_steps + n_kept * scfg.n_thinning
        self.check(self.launches['isokinetic_momentum'] == 3 * n_steps
                   and self.launches['partial_refresh'] == n_steps,
                   f'launches in the main path: K1 '
                   f'{self.launches["isokinetic_momentum"]} (3 x {n_steps} '
                   f'MCLMC steps), K3 {self.launches["partial_refresh"]} '
                   f'(1 x {n_steps})')
        finite = {k: float(metrics[k]) for k in
                  ('lppd', 'rmse', 'de_lppd', 'cal_error', 'nll', 'de_rmse')}
        self.check(all(math.isfinite(v) for v in finite.values()),
                   f'finite metrics {finite}')
        for k in ('fs_split_rhat', 'fs_ess'):
            print(f'  {k}: {metrics.get(k)}')
        self._sink_check(trainer, n_kept)
        print(f'  tuned step_size {np.round(result.tuned["step_size"], 5)}')
        print(f'  tuned L {np.round(result.tuned["L"], 4)}')
        # the sampling phase of run_mclmc, after the tuner: every step,
        # the dE accumulation, the thinned writes and the copy to the host
        n_sampled = n_kept * scfg.n_thinning
        rate = MAIN_SHAPE[0] * n_sampled / result.seconds['sampling']
        self.timings.update({
            'main_path_s': {**phase_s,
                            **{f'run_mclmc_{k}': v
                               for k, v in result.seconds.items()}},
            'main_path_mclmc_steps': n_steps,
            'sampling_samples_per_s': rate,
            'sampling_step_ms': 1e3 * result.seconds['sampling'] / n_sampled})
        print(f'  sampling phase of run_mclmc: {n_sampled} steps of '
              f'{MAIN_SHAPE[0]} chains in {result.seconds["sampling"]:.3f} s,'
              f' {rate:.0f} samples/s')
        self._report_check('main', trainer)
        self._diagnostics_check(trainer)
        self._sampling_rates(trainer, members, rate)
        t0 = time.perf_counter()
        trainer.train_warmstart()     # again, with the card warmed up
        torch.cuda.synchronize()
        self.timings['main_path_s']['warmstart_repeat'] = \
            time.perf_counter() - t0
        self._agreement(trainer, result)
        self._profile(trainer, result)
        self.main_run = (trainer, members)
        self.main_result = result

    def _train(self, trainer):
        """``trainer.train()``, as a user calls it (report included), with
        each phase timed and the members and the sampling result kept (the
        trainer's phase methods are wrapped on the instance for the call).
        Returns (members, result, metrics, seconds by phase; the report's is
        the rest of train's wall time)."""
        torch = self.torch
        kept, seconds = {}, {}
        phases = {'train_warmstart': 'warmstart',
                  'start_sampling': 'warmup_and_sampling',
                  'evaluate': 'evaluation'}

        def wrap(name):
            fn = getattr(trainer, name)

            def timed(*args):
                t0 = time.perf_counter()
                kept[name] = fn(*args)
                torch.cuda.synchronize()
                seconds[phases[name]] = time.perf_counter() - t0
                return kept[name]
            setattr(trainer, name, timed)

        for name in phases:
            wrap(name)
        try:
            t0 = time.perf_counter()
            metrics = trainer.train()
            torch.cuda.synchronize()
            seconds['report'] = (time.perf_counter() - t0
                                 - sum(seconds.values()))
        finally:
            for name in phases:
                vars(trainer).pop(name, None)
        return (kept['train_warmstart'], kept['start_sampling'], metrics,
                seconds)

    def _report_check(self, key: str, trainer):
        """The report that ``train()`` wrote, checked file by file (the
        trainer logs a failed report and goes on, so a missing file would
        not show otherwise): ``report.html`` with its wall-times, metrics
        and per-layer diagnostics tables; ``diagnostics.csv`` with one row
        per leaf of the flat layout under the JAX package's names and
        finite ESS and split R-hat; ``time.warmstart`` and
        ``time.sampling`` in ``training.log``, merged into
        ``metrics.pkl``."""
        import pickle

        from mile_tpu_torch.inference.reporting import parse_times
        from mile_tpu_torch.models.layout import keystr

        exp = trainer.exp_dir
        page = ((exp / 'report.html').read_text()
                if (exp / 'report.html').exists() else '')
        sections = ('Wall times', 'Metrics', 'Chain diagnostics (per layer)')
        tables = all(f'<h2>{h}</h2><table' in page.replace('\n', '')
                     for h in sections)
        self.check(tables, f'{key}: report.html ({len(page)} bytes) holds '
                           f'the {", ".join(sections)} tables; plots '
                           f'{"embedded" if "<h2>Plots</h2>" in page else "absent (no matplotlib)"}')
        rows = []
        if (exp / 'diagnostics.csv').exists():
            lines = (exp / 'diagnostics.csv').read_text().splitlines()
            rows = [line.split(',') for line in lines[1:]]
        names = [keystr(leaf.path) for leaf in trainer.model.layout.leaves]
        finite = bool(rows) and all(
            math.isfinite(float(r[1])) and math.isfinite(float(r[4]))
            for r in rows)
        self.check([r[0] for r in rows] == names and finite,
                   f'{key}: diagnostics.csv has {len(rows)} rows, one per '
                   f'leaf ({len(names)}: {names[0]}, ...), ESS and split '
                   f'R-hat finite')
        times = parse_times(exp / 'training.log')
        with open(exp / 'metrics.pkl', 'rb') as f:
            metrics = pickle.load(f)
        merged = {k: metrics.get(k) for k in ('time.warmstart',
                                              'time.sampling')}
        self.check(all(k in times and merged[k] == times[k] for k in merged),
                   f'{key}: training.log times {times}, merged into '
                   f'metrics.pkl {merged}')

    def _diagnostics_check(self, trainer):
        """``per_param_diagnostics`` on the card against the same call on
        the CPU, on the main path's draws: every value within DIAG_RTOL
        relative (plus DIAG_ATOL of the largest value of its kind)."""
        import numpy as np

        from mile_tpu_torch.inference.reporting import per_param_diagnostics
        from mile_tpu_torch.train.checkpoint import load_flat_samples

        samples = load_flat_samples(trainer.samples_dir)
        times, out = [], {}
        for device in (self.dev, 'cpu', self.dev):
            t0 = time.perf_counter()
            out[str(device)] = per_param_diagnostics(samples, device=device)
            times.append(1e3 * (time.perf_counter() - t0))
        (card, coords), (cpu, cpu_coords) = out[str(self.dev)], out['cpu']
        errors = {k: float(np.max(np.abs(card[k] - cpu[k])
                                  / (np.abs(cpu[k]) + DIAG_ATOL
                                     * np.abs(cpu[k]).max())))
                  for k in cpu}
        self.timings['diagnostics_check'] = {
            'rel_err': errors, 'card_ms': times[2], 'cpu_ms': times[1],
            'shape': list(samples.shape)}
        self.check(np.array_equal(coords, cpu_coords)
                   and max(errors.values()) <= DIAG_RTOL,
                   f'per_param_diagnostics of the main path\'s draws '
                   f'{samples.shape}, card vs CPU: max relative error by '
                   f'kind {errors} (rtol {DIAG_RTOL:g}); card '
                   f'{times[2]:.1f} ms, CPU {times[1]:.1f} ms')

    def _sink_check(self, trainer, n_kept: int):
        """The draws went to disk through the native C++ sink while
        sampling ran: the library loaded, each chain's file holds its
        ``n_kept`` rows (``rows_written`` counts rows per chain, as the JAX
        package's sink does; 12 x n_kept rows in all), and
        ``load_flat_samples`` reads them back."""
        import numpy as np

        from mile_tpu_torch.native import native_available
        from mile_tpu_torch.train.checkpoint import load_flat_samples

        sink = trainer.sink
        n_chains, dim = MAIN_SHAPE
        rows = sum((trainer.samples_dir / f'chain_{c}' / 'samples.bin')
                   .stat().st_size for c in range(n_chains)) // (4 * dim)
        self.check(native_available() and sink is not None and sink.native,
                   'the native sample sink (g++, ctypes) loaded and took the '
                   'draws')
        self.check(sink is not None and sink.rows_written == n_kept
                   and rows == n_chains * n_kept,
                   f'sink rows_written {getattr(sink, "rows_written", None)} '
                   f'per chain (= {n_kept} kept draws), {rows} rows on disk '
                   f'(= {n_chains} x {n_kept})')
        samples = load_flat_samples(trainer.samples_dir)
        self.check(samples.shape == (n_chains, n_kept, dim)
                   and bool(np.isfinite(samples).all()),
                   f'load_flat_samples reads {samples.shape} from '
                   f'samples.bin, finite')

    def _sampling_rates(self, trainer, members, first: float,
                        runs: int = 5):
        """The rate of run_mclmc's sampling phase over ``runs`` runs of the
        main path's tuning and sampling (the first is the main path's own):
        median and spread, since the host-bound rate moves between runs."""
        from mile_tpu_torch.train.sampling import run_mclmc

        x, y = trainer.loader.arrays('train')
        scfg = trainer.config.training.sampler
        n_sampled = math.ceil(scfg.n_samples / scfg.n_thinning) \
            * scfg.n_thinning
        rates = [first]
        for _ in range(runs - 1):
            again = run_mclmc(trainer.bayes.logdensity_and_grad_fn(x, y),
                              scfg, trainer._gen_sample, members)
            rates.append(MAIN_SHAPE[0] * n_sampled / again.seconds['sampling'])
        self.timings['sampling_samples_per_s_runs'] = rates
        self.timings['sampling_samples_per_s_median'] = \
            statistics.median(rates)
        print(f'  run_mclmc sampling rate over {runs} runs: median '
              f'{statistics.median(rates):.0f} samples/s, min '
              f'{min(rates):.0f}, max {max(rates):.0f}')

    def _kernel(self, trainer, result, device, dtype, normals,
                subspace=None):
        """The main path's tuned MCLMC kernel on ``device`` in ``dtype``,
        fed the injected normals ``(C, dim)`` one per step (None: its own
        Philox noise, as in the main path); with ``subspace`` (the sampled
        mask and the members), the partitioned density's kernel. Returns
        ``(start, step, logdensity_and_grad)``: ``start(state)`` is a
        fresh state at another state's position and momentum,
        ``step(state)`` one step."""
        torch = self.torch
        from mile_tpu_torch.mcmc import mclmc

        scfg = trainer.config.training.sampler
        # features and labels in ``dtype``; token ids stay integers
        x, y = (torch.from_numpy(a).to(device, dtype if a.dtype.kind == 'f'
                                       else None)
                for a in trainer.loader.numpy_arrays('train'))
        vg = trainer.bayes.logdensity_and_grad_fn(x, y)
        if subspace is not None:
            from mile_tpu_torch.bayes import partition as part
            from mile_tpu_torch.bayes.posterior import value_and_grad

            mask, members = subspace
            vg = value_and_grad(part.make_partitioned_logdensity(
                trainer.bayes.logdensity_fn(x, y), mask,
                members.to(device, dtype)))
        kernel = mclmc.build_kernel(
            vg, torch.Generator().manual_seed(0), integrator=scfg.integrator,
            noise=None if normals is None else iter(
                [z.to(device, dtype) for z in normals]))
        tuned = {k: torch.as_tensor(v).to(device, dtype)
                 for k, v in result.tuned.items()}
        sdc = tuned['sqrt_diag_cov'] if scfg.diagonal_preconditioning \
            else None

        def start(state):
            return mclmc.init(state.position.to(device, dtype), vg,
                              momentum=state.momentum.to(device, dtype))

        def step(state):
            return kernel(state, tuned['L'], tuned['step_size'], sdc)

        return start, step, vg

    def _steps(self, trainer, result, device, dtype, state, normals):
        """``len(normals)`` steps of :meth:`_kernel` from ``state``, in
        exact float32 matmuls. Returns the states (the start included), the
        infos and the log-density."""
        from mile_tpu_torch.utils.precision import matmul_precision

        start, step, vg = self._kernel(trainer, result, device, dtype,
                                       normals)
        states, infos = [start(state)], []
        with matmul_precision('float32'):
            for _ in normals:
                state, info = step(states[-1])
                states.append(state)
                infos.append(info)
        return states, infos, vg

    def _agreement(self, trainer, result):
        """Ten MCLMC steps through the kernels on the card, from the main
        path's final state with injected normals, held against the plain
        versions on the CPU.

Step by step: each card step is held against the same step taken on
        the CPU in float32 from the card's own state (position and
        momentum). Starting every step from the card's state keeps the
        chaos of the dynamics, which amplifies rounding over the ten steps,
        out of the comparison (the ten-step trajectories, which part by
        1.5e-4 at the tuned step sizes of one run and 2e-5 at another's,
        are reported).

        Positions: each step's within atol 1e-4 of the CPU's, and the
        log-density of the card's final positions, computed on the CPU,
        agrees with the card's to rtol 1e-5.

        Energy: each card step's dE = dK - logp' + logp. dE cancels
        terms of the size of |logp| (10^2 to 10^3 here), so the bound is 64
        float32 units of their size, 64 * 2^-23 * (|logp| + |logp'| + |dK|).
        The same step in float64 is the witness: the card's and the CPU's
        float32 dE stand as far from it as each other, because what parts
        them from it (up to hundreds of these units at the cut tuner's
        large step sizes) is float32 rounding that both paths share."""
        torch = self.torch
        f32, f64 = torch.float32, torch.float64
        n_steps, bound_units = 10, 64.0
        gen = torch.Generator().manual_seed(5)
        normals = [torch.randn(*MAIN_SHAPE, generator=gen)
                   for _ in range(n_steps)]
        card_states, card_infos, _ = self._steps(
            trainer, result, self.dev, f32, result.final_state, normals)
        cpu_states, _, cpu_vg = self._steps(
            trainer, result, 'cpu', f32, result.final_state, normals)
        card_x = card_states[-1].position.cpu()
        trajectory_dx = float((card_x - cpu_states[-1].position).abs().max())
        cpu_logp = cpu_vg(card_x)[0]
        dlogp = float(((card_infos[-1].logdensity.cpu() - cpu_logp).abs()
                       / cpu_logp.abs()).max())

        units = {'card_vs_cpu': [], 'card_vs_f64': [], 'cpu_vs_f64': []}
        card_abs, step_dx = [], []
        for i in range(n_steps):
            card_de = card_infos[i].energy_change.cpu().double()
            one = {}
            for dtype in (f32, f64):
                states, (info,), _ = self._steps(
                    trainer, result, 'cpu', dtype, card_states[i],
                    normals[i:i + 1])
                one[dtype] = (states[0].logdensity.double(),
                              info.logdensity.double(),
                              info.kinetic_change.double(),
                              info.energy_change.double())
                if dtype is f32:
                    step_dx.append(float((card_states[i + 1].position.cpu()
                                          - states[-1].position).abs().max()))
            logp, logp_new, dk, cpu_de = one[f32]
            unit = 2.0 ** -23 * (logp.abs() + logp_new.abs() + dk.abs())
            f64_de = one[f64][3]
            card_abs.append(float((card_de - cpu_de).abs().max()))
            for key, diff in (('card_vs_cpu', card_de - cpu_de),
                              ('card_vs_f64', card_de - f64_de),
                              ('cpu_vs_f64', cpu_de - f64_de)):
                units[key].append(float((diff.abs() / unit).max()))
        dE = torch.stack([i.energy_change.cpu() for i in card_infos])
        self.check(max(step_dx) <= 1e-4 and dlogp <= 1e-5,
                   f'positions of each of {n_steps} card steps (kernels) vs '
                   f'the same step on the CPU (plain) from the card\'s state,'
                   f' same normals: max|dx| {max(step_dx):.2e} (atol 1e-4); '
                   f'logp of the card\'s final positions rel {dlogp:.2e} '
                   f'(rtol 1e-5); the {n_steps}-step trajectories part by '
                   f'{trajectory_dx:.2e}')
        self.timings['energy_check'] = {
            'step_max_dx': max(step_dx), 'trajectory_max_dx': trajectory_dx,
            **{f'{k}_max_units': max(v) for k, v in units.items()},
            'card_vs_cpu_max_abs': max(card_abs),
            'card_abs_dE_median': float(dE.abs().median()),
            'card_abs_dE_max': float(dE.abs().max())}
        self.check(max(units['card_vs_cpu']) <= bound_units,
                   f'dE of each of {n_steps} card steps vs the same step on '
                   f'the CPU from the card\'s state: max '
                   f'{max(units["card_vs_cpu"]):.1f} float32 units of '
                   f'|logp|+|logp\'|+|dK| (<= {bound_units:.0f}), max abs '
                   f'{max(card_abs):.2e} against median |dE| '
                   f'{float(dE.abs().median()):.2e}; witness, float64: card '
                   f'{max(units["card_vs_f64"]):.1f}, CPU float32 '
                   f'{max(units["cpu_vs_f64"]):.1f} units away')

    def _profiled(self, fn):
        """Run ``fn`` under the profiler with the card's clock and power
        sampled beside it. Returns the wall time (µs), the device's busy
        time (µs), the kernels as (device µs, launches, name) rows, largest
        first, and the nvidia-smi lines. ``self.sync_us`` keeps the host's
        time in reads of device values (waits included)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        card = subprocess.Popen(
            ['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
             '--format=csv,noheader', '-lms', '200'],
            stdout=subprocess.PIPE, text=True)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
        finally:
            card.terminate()
            lines = card.communicate(timeout=60)[0].strip().splitlines()
        rows, self.sync_us = [], 0.0
        for e in prof.key_averages():
            dev = getattr(e, 'self_device_time_total',
                          getattr(e, 'self_cuda_time_total', 0))
            if dev > 0 and e.device_type.name == 'CUDA':
                rows.append((dev, e.count, e.key))
            if e.key == 'aten::_local_scalar_dense':
                self.sync_us += e.cpu_time_total
        rows.sort(reverse=True)
        return wall_us, sum(r[0] for r in rows), rows, lines

    def _profile(self, trainer, result, n_steps: int = 50):
        """Where a step's time goes: device time by kernel over ``n_steps``
        bare MCLMC steps (the step alone, without run_mclmc's accumulation
        and copies), the device's busy share of their wall time, and the
        card's clock and power drawn meanwhile. The launches per step are
        checked; the rest is reported."""
        torch = self.torch
        try:
            from mile_tpu_torch.utils.precision import matmul_precision

            start, step, _ = self._kernel(trainer, result, self.dev,
                                          torch.float32, None)
            precision = trainer.config.training.sampler.matmul_precision
            state = start(result.final_state)
            with matmul_precision(precision):
                for _ in range(3):   # warm up
                    state, _ = step(state)

            def steps():
                nonlocal state
                with matmul_precision(precision):
                    for _ in range(n_steps):
                        state, _ = step(state)

            wall_us, busy, rows, card = self._profiled(steps)
            self.timings['card_during_profile'] = card
            self.timings['profile'] = {
                'steps': n_steps, 'wall_ms_per_step': wall_us / n_steps / 1e3,
                'device_ms_per_step': busy / n_steps / 1e3,
                'device_busy_share': busy / wall_us,
                'kernels_per_step': sum(r[1] for r in rows) / n_steps,
                'top': [{'name': k[:60], 'launches_per_step': c / n_steps,
                         'us_per_step': d / n_steps} for d, c, k in rows[:8]]}
            print(f'  profile {json.dumps(self.timings["profile"])}')
        except Exception as exc:
            print(f'  profiler unavailable: {exc!r}')
            return
        per_step = self.timings['profile']['kernels_per_step']
        self.check(per_step <= MAX_LAUNCHES_PER_STEP,
                   f'{per_step:g} kernel launches per bare MCLMC step '
                   f'(<= {MAX_LAUNCHES_PER_STEP})')

    # --------------------------------------------------- partition path
    @contextlib.contextmanager
    def _launch_shapes(self):
        """The shapes of the momenta that K1's and K3's wrappers are called
        with, recorded on the way through (the wrappers still count their
        own launches)."""
        from mile_tpu_torch.mcmc import integrators, mclmc

        shapes = set()
        saved = integrators.isokinetic_momentum, mclmc.partial_refresh

        def spy(fn):
            def call(u, *args, **kwargs):
                shapes.add((fn.__name__, tuple(u.shape)))
                return fn(u, *args, **kwargs)
            return call

        integrators.isokinetic_momentum, mclmc.partial_refresh = map(spy,
                                                                     saved)
        try:
            yield shapes
        finally:
            integrators.isokinetic_momentum, mclmc.partial_refresh = saved

    def partition_path(self):
        """BDETrainer.train() on partition_mclmc.yaml at full width, step
        counts cut to PARTITION_CUT, report included: K1 and K3 launched
        3 and 1 times a step at PARTITION_SHAPE; finite metrics; every
        hidden coordinate of every draw on disk equal to its warm-start
        member's, and every hidden coordinate of the members equal to its
        initial value, bit for bit; the report's files; one partitioned
        step kernels vs plain versions on the card; the partitioned value
        and gradient card vs CPU in float32."""
        import numpy as np
        import shutil

        torch = self.torch
        from mile_tpu_torch.bayes import partition as part
        from mile_tpu_torch.bayes.posterior import value_and_grad
        from mile_tpu_torch.config import Config
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.train.checkpoint import load_flat_samples
        from mile_tpu_torch.train.trainer import BDETrainer
        from mile_tpu_torch.utils.keys import experiment_keys
        from mile_tpu_torch.utils.precision import matmul_precision

        (config,) = Config.from_file(PARTITION_CONFIG)
        config = config.replace(saving_dir=str(PARTITION_RESULTS.parent),
                                experiment_name=PARTITION_RESULTS.name,
                                **PARTITION_CUT)
        scfg = config.training.sampler
        shutil.rmtree(PARTITION_RESULTS, ignore_errors=True)
        trainer = BDETrainer(config, device=self.dev)
        mask = trainer.sampled_mask()
        n_chains, d = PARTITION_SHAPE
        n_train = trainer.loader.arrays('train')[0].shape[0]
        groups = part.layer_groups(trainer.model.layout)
        self.check(trainer.bayes.dim == PARTITION_DIM
                   and scfg.n_chains == n_chains and int(mask.sum()) == d
                   and config.training.warmstart.partition_warmstart
                   and scfg.use_warmup_as_init,
                   f'partition at full width: {config.model.model} dim '
                   f'{trainer.bayes.dim}, {int(mask.sum())} sampled '
                   f'({groups[0][0]} and {groups[-1][0]}), '
                   f'{scfg.n_chains} chains, {n_train} training rows')

        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with self._launch_shapes() as shapes:
            members, result, metrics, phase_s = self._train(trainer)
        launches = {'isokinetic_momentum': ops.isokinetic_momentum.launches,
                    'partial_refresh': ops.partial_refresh.launches}
        self.path_launches['partition'] = launches
        n_kept = math.ceil(scfg.n_samples / scfg.n_thinning)
        n_sampled = n_kept * scfg.n_thinning
        n_steps = scfg.warmup_steps + n_sampled
        self.check(launches['isokinetic_momentum'] == 3 * n_steps
                   and launches['partial_refresh'] == n_steps
                   and {shape for _, shape in shapes} == {PARTITION_SHAPE},
                   f'launches in the partition path: K1 '
                   f'{launches["isokinetic_momentum"]} (3 x {n_steps} MCLMC '
                   f'steps), K3 {launches["partial_refresh"]} (1 x '
                   f'{n_steps}), at {sorted(shapes)}')
        values = {k: float(metrics[k]) for k in
                  ('lppd', 'nll', 'rmse', 'cal_error', 'de_lppd', 'de_rmse')}
        self.check(all(math.isfinite(v) for v in values.values()),
                   f'partition metrics finite: {values}')

        samples = load_flat_samples(trainer.samples_dir)
        host = members.cpu().numpy()
        init = trainer.model.init(
            n_chains, experiment_keys(config.rng).train).numpy()
        hidden = ~mask
        self.check(samples.shape == (n_chains, n_kept, PARTITION_DIM)
                   and bool(np.isfinite(samples).all())
                   and np.array_equal(samples[:, :, hidden],
                                      np.broadcast_to(host[:, None, hidden],
                                                      samples[:, :, hidden]
                                                      .shape)),
                   f'partition draws on disk {samples.shape}, finite; the '
                   f'{int(hidden.sum())} hidden coordinates of every draw '
                   f'equal their warm-start member\'s bit for bit')
        moved = float(np.abs(host[:, mask] - init[:, mask]).max())
        self.check(np.array_equal(host[:, hidden], init[:, hidden])
                   and moved > 0,
                   f'the partition warm start left the hidden coordinates '
                   f'at their initial values bit for bit (the sampled ones '
                   f'moved up to {moved:.3g})')
        self._report_check('partition', trainer)

        subspace = (mask, members)
        self._step_check('partition', 'partition', trainer, result,
                         PARTITION_SHAPE, subspace)
        x, y = trainer.loader.numpy_arrays('train')
        theta = result.final_state.position
        runs = {}
        for run, device in (('card', self.dev), ('cpu', 'cpu')):
            density = trainer.bayes.logdensity_fn(
                torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
            vg = value_and_grad(part.make_partitioned_logdensity(
                density, mask, members.to(device)))
            with matmul_precision('float32'):
                runs[run] = [a.cpu() for a in vg(theta.to(device))]
        (v, g), (rv, rg) = runs['card'], runs['cpu']
        value_rel = float(((v - rv).abs() / rv.abs()).max())
        grad_rel = float((g - rg).abs().max() / rg.abs().max())
        self.check(tuple(g.shape) == PARTITION_SHAPE
                   and value_rel <= GRAD_RTOL and grad_rel <= GRAD_GTOL,
                   f'partitioned log-density at the final state on all '
                   f'{x.shape[0]} rows, card vs CPU in float32: value rel '
                   f'{value_rel:.1e} (rtol {GRAD_RTOL:g}), gradient '
                   f'{tuple(g.shape)} {grad_rel:.1e} max|g| (atol '
                   f'{GRAD_GTOL:g} max|g|)')
        rate = n_chains * n_sampled / result.seconds['sampling']
        self.timings['partition'] = {
            'phase_s': {**phase_s, 'tuner': result.seconds['warmup'],
                        'sampling': result.seconds['sampling']},
            'mclmc_steps': n_steps, 'chain_steps_per_s': rate,
            'metrics': values, 'gradient_check': {'value_rel': value_rel,
                                                  'grad_over_max': grad_rel},
            'peak_device_mib': torch.cuda.max_memory_allocated() / 2 ** 20}
        print(f'  partition phases (s): '
              f'{json.dumps(self.timings["partition"]["phase_s"])}; sampling '
              f'{n_sampled} steps of {n_chains} chains: {rate:.0f} '
              f'chain-steps/s')

    # ------------------------------------------------------- image path
    def _image_archive(self):
        """A FashionMNIST-shaped archive: 70,000 28x28 uint8 images, labels
        0-9, each image its class's random template plus noise, so that the
        warm start learns something."""
        import numpy as np

        rng = np.random.default_rng(IMAGE_SEED)
        templates = rng.uniform(0.0, 255.0, size=(10, 28, 28))
        y = rng.integers(0, 10, 70_000)
        x = 0.6 * templates[y] + rng.normal(0.0, 40.0, size=(70_000, 28, 28))
        IMAGE_ARCHIVE.parent.mkdir(parents=True, exist_ok=True)
        np.savez(IMAGE_ARCHIVE, x=np.clip(x, 0, 255).astype(np.uint8), y=y)

    def image_path(self):
        """BDETrainer on LeNet at full width (IMAGE_SHAPE, IMAGE_TRAIN training
        images, likelihood chunks of 8192), step counts cut to IMAGE_CUT,
        through :meth:`_mclmc_path`."""
        import shutil

        from mile_tpu_torch.config import Config
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.train.trainer import BDETrainer

        self._image_archive()
        (config,) = Config.from_file(IMAGE_CONFIG)
        config = config.replace(saving_dir=str(IMAGE_RESULTS.parent),
                                experiment_name=IMAGE_RESULTS.name,
                                **{'data.path': str(IMAGE_ARCHIVE)},
                                **IMAGE_CUT)
        scfg = config.training.sampler
        shutil.rmtree(IMAGE_RESULTS, ignore_errors=True)
        trainer = BDETrainer(config, device=self.dev)
        n_chains, dim = IMAGE_SHAPE
        n_train = trainer.loader.arrays('train')[0].shape[0]
        route = ops.kernel_route(dim)
        self.check(trainer.bayes.dim == dim and scfg.n_chains == n_chains
                   and n_train == IMAGE_TRAIN
                   and scfg.likelihood_chunk_size == 8192
                   and route.cluster == 8 and route.resident,
                   f'LeNet at full width: dim {trainer.bayes.dim}, '
                   f'{scfg.n_chains} chains, {n_train} training images of '
                   f'{trainer.loader.input_shape}, likelihood chunks of '
                   f'{scfg.likelihood_chunk_size}; K1/K3 route {route}')
        result = self._mclmc_path('image', 'LeNet', trainer, IMAGE_SHAPE,
                                  chance=0.1)
        self.image_run = (trainer, result)

    def _mclmc_path(self, key: str, label: str, trainer, shape,
                    chance: float):
        """A path's BDETrainer phases, one by one and timed, with the launch
        counts set to 0 just before and read just after: K1 3 times and K3
        once per MCLMC step, finite metrics with accuracies above
        ``chance``, the draws on disk through the native sink; then one
        step kernels vs plain versions, the card vs the CPU in float32,
        the gradient's time and a profiled step. ``timings[key]`` keeps
        the numbers. Returns the sampling result."""
        import numpy as np

        torch = self.torch
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.train.checkpoint import load_flat_samples

        scfg = trainer.config.training.sampler
        n_chains, dim = shape
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        members = trainer.train_warmstart()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        result = trainer.start_sampling(members)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        metrics = trainer.evaluate(members, result)
        t3 = time.perf_counter()
        launches = {'isokinetic_momentum': ops.isokinetic_momentum.launches,
                    'partial_refresh': ops.partial_refresh.launches}
        self.path_launches[key] = launches

        n_kept = math.ceil(scfg.n_samples / scfg.n_thinning)
        n_sampled = n_kept * scfg.n_thinning
        n_steps = scfg.warmup_steps + n_sampled
        self.check(launches['isokinetic_momentum'] == 3 * n_steps
                   and launches['partial_refresh'] == n_steps,
                   f'launches in the {key} path: K1 '
                   f'{launches["isokinetic_momentum"]} (3 x {n_steps} MCLMC '
                   f'steps), K3 {launches["partial_refresh"]} (1 x '
                   f'{n_steps})')
        values = {k: float(metrics[k]) for k in
                  ('lppd', 'nll', 'acc', 'de_lppd', 'de_acc')}
        self.check(all(math.isfinite(v) for v in values.values())
                   and values['acc'] > chance and values['de_acc'] > chance,
                   f'{label} metrics finite, accuracies above chance '
                   f'({chance:g}): {values}')
        sink = trainer.sink
        rows = sum((trainer.samples_dir / f'chain_{c}' / 'samples.bin')
                   .stat().st_size for c in range(n_chains)) // (4 * dim)
        samples = load_flat_samples(trainer.samples_dir)
        self.check(sink is not None and sink.native
                   and sink.rows_written == n_kept
                   and rows == n_chains * n_kept
                   and samples.shape == (n_chains, n_kept, dim)
                   and bool(np.isfinite(samples).all()),
                   f'{label} draws through the native sink: rows_written '
                   f'{getattr(sink, "rows_written", None)} per chain (= '
                   f'{n_kept}), {rows} rows on disk, load_flat_samples '
                   f'{samples.shape}, finite')
        print(f'  tuned step_size {np.round(result.tuned["step_size"], 5)}')
        print(f'  tuned L {np.round(result.tuned["L"], 4)}')
        rate = n_chains * n_sampled / result.seconds['sampling']
        self.timings[key] = {
            'phase_s': {'warmstart': t1 - t0,
                        'tuner': result.seconds['warmup'],
                        'sampling': result.seconds['sampling'],
                        'warmup_and_sampling': t2 - t1,
                        'evaluation': t3 - t2},
            'mclmc_steps': n_steps, 'sampling_steps': n_sampled,
            'chain_steps_per_s': rate, 'metrics': values,
            'peak_device_mib': torch.cuda.max_memory_allocated() / 2 ** 20}
        print(f'  {label} phases (s): '
              f'{json.dumps(self.timings[key]["phase_s"])}; sampling '
              f'{n_sampled} steps of {n_chains} chains: {rate:.2f} '
              f'chain-steps/s; peak device memory '
              f'{self.timings[key]["peak_device_mib"]:.0f} MiB')
        self._step_check(key, label, trainer, result, shape)
        self._gradient_check(key, label, trainer, result)
        self._path_profile(key, label, trainer, result)
        return result

    @contextlib.contextmanager
    def _plain_ops(self):
        """The MCLMC step with K1 and K3 replaced by their plain versions
        (the comparison only; the wrappers are put back afterwards)."""
        from mile_tpu_torch.mcmc import integrators, mclmc
        from mile_tpu_torch.ops import isokinetic as ops

        def refresh(u, step_size, L, seed, counter, z=None, **kwargs):
            return ops.partial_refresh_plain(u, step_size, L, z, **kwargs)

        saved = integrators.isokinetic_momentum, mclmc.partial_refresh
        integrators.isokinetic_momentum = ops.isokinetic_momentum_plain
        mclmc.partial_refresh = refresh
        try:
            yield
        finally:
            integrators.isokinetic_momentum, mclmc.partial_refresh = saved

    def _step_check(self, key, label, trainer, result, shape,
                    subspace=None):
        """One MCLMC step on the card from the path's final state with the
        same injected normals, through the kernels and through the plain
        versions (both under the sampler's matmul precision): positions
        within STEP_X_TOL, momenta within STEP_U_ATOL, ΔE within
        64 float32 units of |logp| + |logp'| + |ΔK| (the bound of the
        airfoil check)."""
        torch = self.torch
        from mile_tpu_torch.utils.precision import matmul_precision

        z = torch.randn(*shape, generator=torch.Generator().manual_seed(23))
        precision = trainer.config.training.sampler.matmul_precision
        out = {}
        for kind in ('kernels', 'plain'):
            start, step, _ = self._kernel(trainer, result, self.dev,
                                          torch.float32, [z], subspace)
            with contextlib.ExitStack() as stack:
                if kind == 'plain':
                    stack.enter_context(self._plain_ops())
                stack.enter_context(matmul_precision(precision))
                state = start(result.final_state)
                out[kind] = (state, *step(state))
        (s0, ks, ki), (_, ps, pi) = out['kernels'], out['plain']
        x_atol, x_rtol = STEP_X_TOL
        dx = float(((ks.position - ps.position).abs()
                    / (x_atol + x_rtol * ps.position.abs())).max())
        du = float((ks.momentum - ps.momentum).abs().max())
        unit = 2.0 ** -23 * (s0.logdensity.abs() + pi.logdensity.abs()
                             + pi.kinetic_change.abs())
        de_units = float(((ki.energy_change - pi.energy_change).abs()
                          / unit).max())
        moved = float((ks.position - s0.position).abs().max())
        self.timings[f'{key}_step_check'] = {
            'x_within_tol': dx, 'max_du': du, 'dE_units': de_units,
            'moved': moved}
        self.check(dx <= 1.0 and du <= STEP_U_ATOL
                   and de_units <= 64.0,
                   f'one {label} MCLMC step {shape} on the card, kernels vs '
                   f'plain versions, same state and normals: positions '
                   f'within {dx:.2f} of atol {x_atol:g} + rtol {x_rtol:g} '
                   f'|x| (the step moved them up to {moved:.2e}), max|du| '
                   f'{du:.2e} (atol {STEP_U_ATOL:g}), dE '
                   f'{de_units:.1f} float32 units (<= 64)')

    def _gradient_check(self, key, label, trainer, result):
        """The log-posterior and the log-likelihood alone, with their
        gradients, at the tuned state on the first GRAD_ROWS training
        observations: on the card under the sampler's matmul precision, on
        the CPU in float32, and on the card with TF32 allowed in matmuls
        and convolutions (the witness). At the tuned state the likelihood
        is small beside the prior, so a TF32 error hides in the
        posterior's gradient; the likelihood's gradient is held apart, and
        the witness must exceed its tolerance, which shows the check can
        see TF32. Also times one full-batch value and gradient on the
        card."""
        torch = self.torch
        from mile_tpu_torch.bayes.posterior import value_and_grad
        from mile_tpu_torch.utils.precision import matmul_precision

        precision = trainer.config.training.sampler.matmul_precision
        theta = result.final_state.position
        x, y = trainer.loader.numpy_arrays('train')
        bayes = trainer.bayes

        @contextlib.contextmanager
        def tf32():
            with matmul_precision('tensorfloat32'):
                torch.backends.cudnn.allow_tf32 = True
                yield   # the scope puts cuDNN's switch back on exit

        runs = {}
        for run, device, scope in (
                ('card', self.dev, lambda: matmul_precision(precision)),
                ('cpu', torch.device('cpu'),
                 lambda: matmul_precision('float32')),
                ('card_tf32', self.dev, tf32)):
            xs = torch.from_numpy(x[:GRAD_ROWS]).to(device)
            ys = torch.from_numpy(y[:GRAD_ROWS]).to(device)
            fns = {'posterior': bayes.logdensity_fn(xs, ys),
                   'likelihood': lambda t: bayes.log_likelihood(t, xs, ys)}
            with scope():
                runs[run] = {k: [a.cpu() for a in value_and_grad(f)(
                    theta.to(device))] for k, f in fns.items()}
        errors = {}
        for run in ('card', 'card_tf32'):
            for k in ('posterior', 'likelihood'):
                (v, g), (rv, rg) = runs[run][k], runs['cpu'][k]
                errors[f'{run}_{k}'] = {
                    'value_rel': float(((v - rv).abs() / rv.abs()).max()),
                    'grad_over_max': float((g - rg).abs().max()
                                           / rg.abs().max())}
        self.timings[f'{key}_gradient_check'] = errors
        post, lik = errors['card_posterior'], errors['card_likelihood']
        witness = errors['card_tf32_likelihood']['grad_over_max']
        self.check(post['value_rel'] <= GRAD_RTOL
                   and post['grad_over_max'] <= GRAD_GTOL
                   and lik['grad_over_max'] <= GRAD_GTOL
                   and witness > GRAD_GTOL,
                   f'{label} at the tuned state on {GRAD_ROWS} '
                   f'observations, card vs CPU in float32: log-posterior rel '
                   f'{post["value_rel"]:.1e} (rtol {GRAD_RTOL:g}), its '
                   f'gradient {post["grad_over_max"]:.1e} max|g|; '
                   f'log-likelihood rel {lik["value_rel"]:.1e}, its gradient '
                   f'{lik["grad_over_max"]:.1e} max|g| (each gradient atol '
                   f'{GRAD_GTOL:g} max|g|); with TF32 on the card the '
                   f'likelihood gradient parts by {witness:.1e} max|g| (must '
                   f'exceed {GRAD_GTOL:g})')

        xs, ys = trainer.loader.arrays('train')
        vg = trainer.bayes.logdensity_and_grad_fn(xs, ys)
        times = []
        with matmul_precision(precision):
            vg(theta)
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vg(theta)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
        self.timings[key]['gradient_ms'] = times
        print(f'  full-batch value and gradient, {theta.shape[0]} chains x '
              f'{xs.shape[0]} observations: '
              f'{statistics.median(times):.1f} ms (median of {times})')

    def _path_profile(self, key, label, trainer, result, n_steps: int = 2):
        """Where a step's time goes: ``n_steps`` bare MCLMC steps at the
        tuned parameters under the profiler: wall and device time per
        step, the device's busy share and the 10 device operations that
        take the most time."""
        torch = self.torch
        try:
            from mile_tpu_torch.utils.precision import matmul_precision

            start, step, _ = self._kernel(trainer, result, self.dev,
                                          torch.float32, None)
            precision = trainer.config.training.sampler.matmul_precision
            state = start(result.final_state)

            def steps():
                nonlocal state
                with matmul_precision(precision):
                    for _ in range(n_steps):
                        state, _ = step(state)

            wall_us, busy, rows, card = self._profiled(steps)
            self.timings[f'{key}_profile'] = {
                'steps': n_steps, 'wall_ms_per_step': wall_us / n_steps / 1e3,
                'device_ms_per_step': busy / n_steps / 1e3,
                'device_busy_share': busy / wall_us,
                'kernels_per_step': sum(r[1] for r in rows) / n_steps,
                'card': card,
                'top': [{'name': k[:80], 'launches_per_step': c / n_steps,
                         'ms_per_step': d / n_steps / 1e3}
                        for d, c, k in rows[:10]]}
            print(f'  {label} profile '
                  f'{json.dumps(self.timings[f"{key}_profile"])}')
        except Exception as exc:
            print(f'  {label} profiler unavailable: {exc!r}')

    # -------------------------------------------------------- text path
    def _text_corpus(self):
        """A corpus of TEXT_TEXTS texts over TEXT_CHARS characters
        (U+4E00 onward), lengths uniform in 16-400, labels 0/1 balanced,
        the characters Zipf(1.1)-distributed over a random ranking: the
        class's own with probability TEXT_CLASS_MIX, else one both classes
        share, so that accuracy can rise above chance."""
        import numpy as np

        rng = np.random.default_rng(TEXT_SEED)
        n = TEXT_TEXTS
        y = rng.permutation(np.arange(n) % 2)
        lengths = rng.integers(16, 401, n)
        zipf = np.arange(1, TEXT_CHARS + 1) ** -1.1
        zipf /= zipf.sum()
        chars = np.empty(int(lengths.sum()), np.uint32)
        ends = np.cumsum(lengths)
        starts = ends - lengths
        shared = rng.permutation(TEXT_CHARS)
        for label in (0, 1):
            own = rng.permutation(TEXT_CHARS)
            rows = np.flatnonzero(y == label)
            index = np.concatenate([np.arange(starts[r], ends[r])
                                    for r in rows])
            rank = rng.choice(TEXT_CHARS, index.size, p=zipf)
            chars[index] = 0x4E00 + np.where(
                rng.random(index.size) < TEXT_CLASS_MIX, own[rank],
                shared[rank])
        text = chars.view(f'U{chars.size}')[0]
        TEXT_CORPUS.parent.mkdir(parents=True, exist_ok=True)
        with open(TEXT_CORPUS, 'w', encoding='utf-8') as f:
            f.write('text,label\n')
            f.writelines(f'{text[a:b]},{label}\n'
                         for a, b, label in zip(starts, ends, y))

    def text_path(self):
        """BDETrainer on the IMDB-width AttentionClassifier at full width
        (TEXT_SHAPE, TEXT_TRAIN training sequences of 70 tokens, likelihood
        chunks of 4096), step counts cut to TEXT_CUT, through
        :meth:`_mclmc_path`; and a batch with pads and an all-pad
        sequence, card against CPU."""
        import shutil

        from mile_tpu_torch.config import Config
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.train.trainer import BDETrainer

        t0 = time.perf_counter()
        self._text_corpus()
        (config,) = Config.from_file(TEXT_CONFIG)
        config = config.replace(saving_dir=str(TEXT_RESULTS.parent),
                                experiment_name=TEXT_RESULTS.name,
                                **{'data.path': str(TEXT_CORPUS)},
                                **TEXT_CUT)
        scfg = config.training.sampler
        shutil.rmtree(TEXT_RESULTS, ignore_errors=True)
        trainer = BDETrainer(config, device=self.dev)
        set_up = time.perf_counter() - t0
        n_chains, dim = TEXT_SHAPE
        x, _ = trainer.loader.numpy_arrays('train')
        route = ops.kernel_route(dim)
        pads = float((x == 0).any(axis=1).mean())
        print(f'  K1/K3 route at dim {dim}: {route}')
        self.check(trainer.bayes.dim == dim and scfg.n_chains == n_chains
                   and x.shape == (TEXT_TRAIN, 70)
                   and trainer.loader.tokenizer.vocab_size == 1000
                   and scfg.likelihood_chunk_size == 4096
                   and route.cluster == 8 and route.resident,
                   f'AttentionClassifier at full width: dim '
                   f'{trainer.bayes.dim}, {scfg.n_chains} chains, '
                   f'{x.shape[0]} training sequences of {x.shape[1]} '
                   f'tokens ({100 * pads:.1f} % padded), vocabulary '
                   f'{trainer.loader.tokenizer.vocab_size} (1000), '
                   f'likelihood chunks of {scfg.likelihood_chunk_size}; '
                   f'set-up (corpus, tokenizer, loader) {set_up:.1f} s')
        result = self._mclmc_path('text', 'AttentionClassifier', trainer,
                                  TEXT_SHAPE, chance=0.5)
        self.timings['text']['set_up_s'] = set_up
        self._pad_check(trainer, result.final_state.position)

    def _pad_check(self, trainer, theta):
        """Training sequences with pads and one all-pad sequence through
        the model at the tuned state: finite on the card, and the card's
        outputs equal to the CPU's within TEXT_PAD_TOL (exact float32
        matmuls on both)."""
        import numpy as np

        torch = self.torch
        from mile_tpu_torch.utils.precision import matmul_precision

        x, _ = trainer.loader.numpy_arrays('train')
        rows = np.flatnonzero((x == 0).any(axis=1))[:63]
        batch = np.concatenate([x[rows], np.zeros((1, x.shape[1]),
                                                  x.dtype)])
        with matmul_precision('float32'), torch.no_grad():
            card, cpu = (trainer.model(theta.to(device),
                                       torch.from_numpy(batch).to(device))
                         .cpu() for device in (self.dev, torch.device('cpu')))
        err = float((card - cpu).abs().max())
        self.timings['text_pad_check'] = {'max_abs_err': err,
                                          'max_abs': float(cpu.abs().max())}
        self.check(bool(torch.isfinite(card).all()) and err <= TEXT_PAD_TOL,
                   f'{len(batch) - 1} sequences with pads and one all pads, '
                   f'{theta.shape[0]} chains: finite on the card, max|card '
                   f'- CPU| {err:.1e} (atol {TEXT_PAD_TOL:g}) on outputs up '
                   f'to {float(cpu.abs().max()):.2f}')

    # -------------------------------------------------------- NUTS path
    @contextlib.contextmanager
    def _recording_nuts(self):
        """Keep every NUTSKernel call's info, by kernel (the window
        adaptation's kernel first, then the sampler's), for the tree
        statistics. Measurement only: the calls are unchanged."""
        from mile_tpu_torch.mcmc import nuts

        kernels = {}
        call = nuts.NUTSKernel.__call__

        def recorded(kernel, *args):
            state, info = call(kernel, *args)
            kernels.setdefault(kernel, []).append(info)
            return state, info

        nuts.NUTSKernel.__call__ = recorded
        try:
            yield kernels
        finally:
            nuts.NUTSKernel.__call__ = call

    def _tree_stats(self, kernel, infos, seconds: float) -> dict:
        """Per draw: tree depth and leapfrog steps per chain, and the
        batched gradient evaluations (each one full-batch value_and_grad of
        all chains). The batch takes a leaf while any chain is active, so a
        draw costs exactly the most steps any chain took."""
        torch = self.torch
        depth = torch.stack([i.num_trajectory_expansions
                             for i in infos]).float().cpu()
        steps = torch.stack([i.num_integration_steps for i in infos]).cpu()
        batched = int(steps.max(dim=1).values.sum())
        n = len(infos)
        return {'draws': n, 'seconds': seconds,
                'mean_depth': float(depth.mean()),
                'max_depth': int(depth.max()),
                'leapfrog_steps_per_draw': float(steps.float().mean()),
                'batched_gradient_evals_per_draw': batched / n,
                'gradient_evals_per_s': batched / seconds,
                'host_syncs_per_draw': kernel.host_syncs / n}

    def nuts_path(self):
        """The NUTS path: BDETrainer on the airfoil NUTS config at full
        width (12 chains, dim 674, all training rows, tree depth 10), with
        the step counts cut to NUTS_CUT. Checks finite metrics, the draws on
        disk through the native sink, a mean acceptance in (0, 1] and that
        no hand-written kernel ran on this path; reports the tree
        statistics and rates of the adaptation and the sampling."""
        import numpy as np
        import shutil

        torch = self.torch
        from mile_tpu_torch.config import Config
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.train.checkpoint import load_flat_samples
        from mile_tpu_torch.train.trainer import BDETrainer

        (config,) = Config.from_file(NUTS_CONFIG)
        config = config.replace(saving_dir=str(NUTS_RESULTS.parent),
                                experiment_name=NUTS_RESULTS.name, **NUTS_CUT)
        scfg = config.training.sampler
        shutil.rmtree(NUTS_RESULTS, ignore_errors=True)
        trainer = BDETrainer(config, device=self.dev)
        self.check(trainer.bayes.dim == MAIN_SHAPE[1]
                   and scfg.n_chains == MAIN_SHAPE[0]
                   and scfg.max_num_doublings == 10,
                   f'NUTS at full width: dim {trainer.bayes.dim}, '
                   f'{scfg.n_chains} chains, '
                   f'{trainer.loader.arrays("train")[0].shape[0]} training '
                   f'rows, max_num_doublings {scfg.max_num_doublings}, '
                   f'{scfg.warmup_steps} adaptation steps, {scfg.n_samples} '
                   f'draws')

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        members = trainer.train_warmstart()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with self._recording_nuts() as kernels:
            result = trainer.start_sampling(members)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        metrics = trainer.evaluate(members, result)
        t3 = time.perf_counter()
        launches = (ops.isokinetic_momentum.launches,
                    ops.partial_refresh.launches)
        self.check(launches == (0, 0),
                   f'launches in the NUTS path: K1 {launches[0]}, K3 '
                   f'{launches[1]} (no hand-written kernel on this path)')
        finite = {k: float(metrics[k]) for k in
                  ('lppd', 'rmse', 'de_lppd', 'cal_error', 'nll', 'de_rmse')}
        self.check(all(math.isfinite(v) for v in finite.values()),
                   f'NUTS finite metrics {finite}')
        n_kept = math.ceil(scfg.n_samples / scfg.n_thinning)
        self.check(trainer.sink is not None and trainer.sink.native
                   and trainer.sink.rows_written == n_kept,
                   f'NUTS draws through the native sink: rows_written '
                   f'{getattr(trainer.sink, "rows_written", None)} per chain')
        samples = load_flat_samples(trainer.samples_dir)
        self.check(samples.shape == (MAIN_SHAPE[0], n_kept, MAIN_SHAPE[1])
                   and bool(np.isfinite(samples).all()),
                   f'NUTS samples {samples.shape}, finite')
        acc = float(np.mean(result.info['acceptance_rate']))
        self.check(0.0 < acc <= 1.0,
                   f'NUTS mean acceptance {acc:.3f} in (0, 1] (target '
                   f'{scfg.target_acceptance}); divergent draws '
                   f'{int(np.sum(result.info["is_divergent"]))}')
        print(f'  tuned step_size {np.array2string(result.tuned["step_size"], precision=6)}')
        (warm_k, warm_i), (samp_k, samp_i) = kernels.items()
        self.check(warm_k.graphed and samp_k.graphed,
                   f'NUTS leaves replayed from a CUDA graph: adaptation '
                   f'{warm_k.graphed} ({warm_k.leaf_steps} leaves), sampling '
                   f'{samp_k.graphed} ({samp_k.leaf_steps} leaves)')
        phases = {'warmup': self._tree_stats(warm_k, warm_i,
                                             result.seconds['warmup']),
                  'sampling': self._tree_stats(samp_k, samp_i,
                                               result.seconds['sampling'])}
        for name, st in phases.items():
            print(f'  NUTS {name}: {st["draws"]} draws in '
                  f'{st["seconds"]:.2f} s, mean depth {st["mean_depth"]:.2f} '
                  f'(max {st["max_depth"]}), '
                  f'{st["leapfrog_steps_per_draw"]:.1f} leapfrog steps per '
                  f'chain and draw, {st["batched_gradient_evals_per_draw"]:.1f}'
                  f' batched gradient evaluations per draw, '
                  f'{st["gradient_evals_per_s"]:.0f} per s, '
                  f'{st["host_syncs_per_draw"]:.1f} host syncs per draw')
        self.timings['nuts'] = {
            'main_path_s': {'warmstart': t1 - t0, 'warmup_and_sampling':
                            t2 - t1, 'evaluation': t3 - t2},
            **phases, 'mean_acceptance': acc,
            'step_size': result.tuned['step_size'].tolist()}
        self.nuts_run = (trainer, members, result)
        self._nuts_agreement(trainer, result)
        self._nuts_profile(trainer, result)

    def _nuts_agreement(self, trainer, result):
        """One NUTS step on the card against the same step on the CPU in
        float32, from the card's final state with the same injected draws
        (drawn on a CPU generator and moved), at NUTS_STEP_DEPTH: the same
        tree, chain by chain (depth, steps, turning, divergence), and
        positions within NUTS_STEP_ATOL."""
        torch = self.torch
        from mile_tpu_torch.mcmc import hmc, nuts
        from mile_tpu_torch.utils.precision import matmul_precision

        eps = torch.from_numpy(result.tuned['step_size']) \
            * torch.tensor(NUTS_STEP_EPS_SCALE)
        imm = torch.from_numpy(result.tuned['inverse_mass_matrix'])
        start = result.final_state.position
        outs = {}
        for device in (self.dev, torch.device('cpu')):
            x, y = (torch.from_numpy(a).to(device)
                    for a in trainer.loader.numpy_arrays('train'))
            vg = trainer.bayes.logdensity_and_grad_fn(x, y)
            kernel = nuts.build_kernel(
                vg, max_depth=NUTS_STEP_DEPTH,
                draws=hmc.Draws(torch.Generator().manual_seed(13), device))
            with matmul_precision('float32'):
                t0 = time.perf_counter()
                outs[device.type] = kernel(nuts.init(start.to(device), vg),
                                           eps.to(device), imm.to(device))
                torch.cuda.synchronize()
                print(f'  one NUTS step on {device.type}: '
                      f'{time.perf_counter() - t0:.2f} s')
        (card_state, card), (cpu_state, cpu) = outs['cuda'], outs['cpu']
        fields = ('num_trajectory_expansions', 'num_integration_steps',
                  'is_turning', 'is_divergent')
        same = {f: bool(torch.equal(getattr(card, f).cpu(), getattr(cpu, f)))
                for f in fields}
        dx = (card_state.position.cpu() - cpu_state.position).abs().amax(1)
        moved = (cpu_state.position - start.cpu()).abs().amax(1)
        self.timings['nuts_step_check'] = {
            'depth': card.num_trajectory_expansions.tolist(),
            'steps': card.num_integration_steps.tolist(),
            'cpu_steps': cpu.num_integration_steps.tolist(),
            'max_dx_per_chain': dx.tolist(), 'moved_per_chain':
            moved.tolist()}
        self.check(all(same.values()) and float(dx.max()) <= NUTS_STEP_ATOL,
                   f'one NUTS step (depth {NUTS_STEP_DEPTH}), card vs CPU '
                   f'from the card\'s state with the same draws: tree '
                   f'identical {same}, depth '
                   f'{card.num_trajectory_expansions.tolist()}, steps '
                   f'{card.num_integration_steps.tolist()}; max|dx| '
                   f'{float(dx.max()):.2e} (atol {NUTS_STEP_ATOL:g}) while '
                   f'the chains moved up to {float(moved.max()):.2e}')

    def _nuts_profile(self, trainer, result):
        """Where a NUTS draw's time goes on the main path, its leaves
        replayed from the kernel's CUDA graph: one draw at the tuned
        parameters and NUTS_PROFILE_DEPTH to capture the graph, then one
        under the profiler: wall and device time, the device's busy share,
        kernels per batched leaf, host syncs and their time."""
        torch = self.torch
        from mile_tpu_torch.mcmc import nuts
        from mile_tpu_torch.utils.precision import matmul_precision

        try:
            x, y = trainer.loader.arrays('train')
            vg = trainer.bayes.logdensity_and_grad_fn(x, y)
            kernel = nuts.build_kernel(vg, torch.Generator().manual_seed(17),
                                       max_depth=NUTS_PROFILE_DEPTH)
            eps = torch.from_numpy(result.tuned['step_size']).to(self.dev)
            imm = torch.from_numpy(
                result.tuned['inverse_mass_matrix']).to(self.dev)
            state = result.final_state
            out = {}

            def draw():
                nonlocal state
                with matmul_precision('float32'):
                    state, out['info'] = kernel(state, eps, imm)

            draw()                              # captures the leaf's graph
            syncs = kernel.host_syncs
            wall_us, busy, rows, card = self._profiled(draw)
            leaves = int(out['info'].num_integration_steps.max())
            self.timings['nuts_profile'] = {
                'leaf': 'graphed' if kernel.graphed else 'eager',
                'max_depth': NUTS_PROFILE_DEPTH, 'wall_ms': wall_us / 1e3,
                'device_ms': busy / 1e3,
                'device_busy_share': busy / wall_us,
                'batched_leaves': leaves,
                'host_syncs': kernel.host_syncs - syncs,
                'host_sync_ms': self.sync_us / 1e3,
                'kernels': sum(r[1] for r in rows),
                'kernels_per_leaf': sum(r[1] for r in rows) / max(leaves, 1),
                'card': card,
                'top': [{'name': k[:60], 'launches': c, 'us': d}
                        for d, c, k in rows[:8]]}
            print(f'  NUTS profile {json.dumps(self.timings["nuts_profile"])}')
        except Exception as exc:
            print(f'  NUTS profiler unavailable: {exc!r}')

    def hmc_run(self):
        """A short HMC run on the NUTS path's posterior and warm-start
        members (run_sampler, config name hmc): finite draws of the right
        shape and a mean acceptance in (0, 1]."""
        import numpy as np

        from mile_tpu_torch.train.sampling import run_sampler

        trainer, members, _ = self.nuts_run
        scfg = trainer.config.replace(**HMC_CUT).training.sampler
        x, y = trainer.loader.arrays('train')
        result = run_sampler(trainer.bayes.logdensity_and_grad_fn(x, y), scfg,
                             self.torch.Generator().manual_seed(19), members)
        acc = float(np.mean(result.info['acceptance_rate']))
        self.check(result.samples.shape == (MAIN_SHAPE[0], scfg.n_samples,
                                            MAIN_SHAPE[1])
                   and bool(np.isfinite(result.samples).all())
                   and 0.0 < acc <= 1.0,
                   f'HMC ({scfg.num_integration_steps} leapfrog steps a '
                   f'draw): samples {result.samples.shape}, finite, mean '
                   f'acceptance {acc:.3f} in (0, 1]; adaptation '
                   f'{result.seconds["warmup"]:.2f} s, {scfg.n_samples} draws '
                   f'{result.seconds["sampling"]:.2f} s')
        self.timings['hmc'] = {**result.seconds, 'mean_acceptance': acc,
                               'step_size': result.tuned['step_size'].tolist()}

    # ------------------------------------------------------------ resume
    def _equal(self, a, b, keys) -> dict:
        """Bitwise equality of two sampling results: the draws and the
        named ``info`` and ``tuned`` arrays."""
        import numpy as np

        out = {'samples': bool(np.array_equal(a.samples, b.samples))}
        for where, key in keys:
            out[key] = bool(np.array_equal(getattr(a, where)[key],
                                           getattr(b, where)[key]))
        return out

    def _launches(self) -> tuple:
        from mile_tpu_torch.ops import isokinetic as ops

        return (ops.isokinetic_momentum.launches,
                ops.partial_refresh.launches)

    def mclmc_resume(self):
        """run_mclmc with ``checkpoint_dir`` on the main path's posterior
        and members, in RESUME_CHUNK_KEPT-draw chunks: an uninterrupted
        run, a run stopped by its sink after chunk 2 and its resumed run,
        a run stopped inside chunk 0 (before its first drain) and its
        resumed run. Each resumed run's draws, ΔE statistics and tuned
        step size and L equal the uninterrupted run's bit for bit, and it
        launches K1 3 times and K3 once per step it had left (the tuner
        is skipped)."""
        import json as _json
        import shutil

        torch = self.torch
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.train import sampling

        trainer, members = self.main_run
        scfg = trainer.config.training.sampler
        x, y = trainer.loader.arrays('train')
        vg = trainer.bayes.logdensity_and_grad_fn(x, y)
        n_chains, dim = MAIN_SHAPE
        thin = scfg.n_thinning
        n_kept = math.ceil(scfg.n_samples / thin)
        n_chunks = math.ceil(n_kept / RESUME_CHUNK_KEPT)
        self.check(n_chunks >= 4 and members.shape == (n_chains, dim),
                   f'resume at full width: {tuple(members.shape)} members, '
                   f'{n_kept} kept draws in {n_chunks} chunks of '
                   f'{RESUME_CHUNK_KEPT}')
        shutil.rmtree(RESUME_RESULTS, ignore_errors=True)
        seconds = {}

        def run(name, label=None, **kwargs):
            t0 = time.perf_counter()
            out = sampling.run_mclmc(
                vg, scfg, torch.Generator().manual_seed(RESUME_SEED),
                members, max_chunk_bytes=RESUME_CHUNK_KEPT * n_chains * dim
                * 4, checkpoint_dir=RESUME_RESULTS / name, **kwargs)
            torch.cuda.synchronize()
            seconds[label or name] = time.perf_counter() - t0
            return out

        def kept_done(name) -> int:
            meta = RESUME_RESULTS / name / 'sampler_meta.json'
            return _json.loads(meta.read_text())['kept_done']

        keys = [('info', 'energy_change'), ('info', 'energy_change_sq'),
                ('tuned', 'step_size'), ('tuned', 'L')]
        ops.reset_launch_counts()
        full = run('full')
        self.resume_run = (vg, scfg, members, full)
        self.check(not (RESUME_RESULTS / 'full').exists(),
                   'the uninterrupted run removed its checkpoint directory')
        stops = {'after chunk 2': ('stop2', StopAfter(2)),
                 'inside chunk 0': ('stop0', None)}
        for label, (name, sink) in stops.items():
            push = sampling.Drain.push
            if sink is None:   # stop before the first chunk is drained
                def halt(*args, **kwargs):
                    raise SimulatedStop('inside chunk 0')
                sampling.Drain.push = halt
            try:
                run(name, sample_sink=sink)
                stopped = False
            except SimulatedStop:
                stopped = True
            finally:
                sampling.Drain.push = push
            done = kept_done(name)
            chunks = len(list((RESUME_RESULTS / name).glob('chunk_*.npz')))
            before = self._launches()
            resumed = run(name, f'{name} resumed')
            k1, k3 = (a - b for a, b in zip(self._launches(), before))
            left = (n_kept - done) * thin
            same = self._equal(resumed, full, keys)
            self.check(stopped and done == chunks * RESUME_CHUNK_KEPT
                       and all(same.values()) and (k1, k3) == (3 * left,
                                                               left)
                       and not (RESUME_RESULTS / name).exists(),
                       f'MCLMC stopped {label} (snapshot at {done} kept '
                       f'draws, {chunks} chunks on disk) and resumed: '
                       f'bitwise equal to the uninterrupted run {same}; '
                       f'resumed run launched K1 {k1} (3 x {left} steps '
                       f'left) and K3 {k3} (1 x {left}): the tuner was '
                       f'skipped; checkpoint removed on success')
        self.path_launches['resume'] = dict(zip(
            ('isokinetic_momentum', 'partial_refresh'), self._launches()))
        self.timings['mclmc_resume_s'] = seconds
        print(f'  run_mclmc wall times (s): {json.dumps(seconds)}')

    def nuts_resume(self):
        """run_hmc_family (NUTS, depth 5) with ``checkpoint_dir`` on the
        NUTS path's posterior and members: stopped after chunk 1 of 3 and
        resumed, its draws and every per-draw statistic bit for bit the
        uninterrupted run's, with the sampling generator's state restored
        on the card."""
        import numpy as np
        import shutil

        torch = self.torch
        from mile_tpu_torch.train.sampling_hmc import run_hmc_family

        trainer, members, _ = self.nuts_run
        scfg = trainer.config.replace(**NUTS_RESUME_CUT).training.sampler
        x, y = trainer.loader.arrays('train')
        vg = trainer.bayes.logdensity_and_grad_fn(x, y)
        root = RESUME_RESULTS / 'nuts'
        shutil.rmtree(root, ignore_errors=True)
        seconds = {}

        def run(name, label=None, **kwargs):
            t0 = time.perf_counter()
            out = run_hmc_family(
                vg, scfg, torch.Generator().manual_seed(RESUME_SEED),
                members, max_chunk_bytes=NUTS_RESUME_CHUNK_KEPT
                * MAIN_SHAPE[0] * MAIN_SHAPE[1] * 4,
                checkpoint_dir=root / name, **kwargs)
            torch.cuda.synchronize()
            seconds[label or name] = time.perf_counter() - t0
            return out

        full = run('full')
        try:
            run('stop', sample_sink=StopAfter(1))
            stopped = False
        except SimulatedStop:
            stopped = True
        chunks = len(list((root / 'stop').glob('chunk_*.npz')))
        resumed = run('stop', 'stop resumed')
        same = self._equal(resumed, full, [('info', k) for k in full.info]
                           + [('tuned', 'step_size'),
                              ('tuned', 'inverse_mass_matrix')])
        n_kept = scfg.n_samples
        self.check(stopped and chunks == 1 and all(same.values())
                   and full.samples.shape == (MAIN_SHAPE[0], n_kept,
                                              MAIN_SHAPE[1])
                   and bool(np.isfinite(full.samples).all()),
                   f'NUTS (depth {scfg.max_num_doublings}, {n_kept} draws '
                   f'in chunks of {NUTS_RESUME_CHUNK_KEPT}) stopped after '
                   f'chunk 1 and resumed: bitwise equal {same}')
        self.timings['nuts_resume_s'] = seconds
        print(f'  run_hmc_family wall times (s): {json.dumps(seconds)}')

    def stream_and_reuse(self):
        """BDETrainer on the main path's config with ``stream_samples``:
        one ``samples/{c}/sample_{n}.npz`` per draw, its entries named as
        the JAX package names the leaves, row for row equal to
        ``chain_{c}/samples.npy``; then a second trainer whose
        ``warmstart_exp_dir`` is the first run: its members, and the
        copies it saves, equal the first run's bit for bit."""
        import numpy as np
        import shutil

        torch = self.torch
        from mile_tpu_torch.config import Config
        from mile_tpu_torch.models.layout import jax_leaves_from_flat, keystr
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.train import checkpoint as ckpt
        from mile_tpu_torch.train.trainer import BDETrainer

        (config,) = Config.from_file(CONFIG)
        config = config.replace(
            saving_dir=str(STREAM_RESULTS.parent),
            experiment_name=STREAM_RESULTS.name,
            **{**CUT, 'training.sampler.stream_samples': True,
               'training.warmstart.max_epochs': STREAM_EPOCHS})
        for path in (STREAM_RESULTS, REUSE_RESULTS):
            shutil.rmtree(path, ignore_errors=True)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = BDETrainer(config, device=self.dev)
        metrics = trainer.train()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.path_launches['stream'] = dict(zip(
            ('isokinetic_momentum', 'partial_refresh'), self._launches()))
        scfg = config.training.sampler
        n_chains, dim = MAIN_SHAPE
        n_kept = math.ceil(scfg.n_samples / scfg.n_thinning)
        layout = trainer.model.layout
        names = [keystr(leaf.path) for leaf in layout.leaves]
        files = ok = 0
        for c in range(n_chains):
            rows = np.load(trainer.samples_dir / f'chain_{c}' / 'samples.npy')
            for n in range(n_kept):
                path = trainer.samples_dir / f'{c}' / f'sample_{n}.npz'
                if not path.exists():
                    continue
                files += 1
                with np.load(path) as d:
                    want = jax_leaves_from_flat(rows[n], layout)
                    ok += (list(d.files) == names and all(
                        np.array_equal(d[k], w) for k, w in zip(names, want)))
        self.check(trainer.sink is None and files == ok == n_chains * n_kept
                   and rows.shape == (n_kept, dim)
                   and math.isfinite(float(metrics['lppd'])),
                   f'stream_samples: {files} files samples/{{c}}/sample_{{n}}'
                   f'.npz (= {n_chains} x {n_kept}), {ok} with the JAX '
                   f'leaf names ({names[0]}, ...) equal row for row to '
                   f'chain_{{c}}/samples.npy; no native sink; lppd '
                   f'{float(metrics["lppd"]):.4f}')

        reuse = config.replace(
            experiment_name=REUSE_RESULTS.name,
            **{'training.sampler.stream_samples': False,
               'training.warmstart.warmstart_exp_dir': str(trainer.exp_dir)})
        second = BDETrainer(reuse, device=self.dev)
        members = second.train_warmstart().cpu().numpy()
        t2 = time.perf_counter()
        ids = list(range(n_chains))
        first = ckpt.load_params_batch(trainer.warmstart_dir, ids)
        again = ckpt.load_params_batch(second.warmstart_dir, ids)
        self.check(np.array_equal(members, first)
                   and np.array_equal(again, first),
                   f'warmstart_exp_dir: the second trainer\'s '
                   f'{members.shape} members and the copies it saved equal '
                   f'the first run\'s bit for bit')
        self.timings['stream_and_reuse_s'] = {'stream_train': t1 - t0,
                                              'reuse_warmstart': t2 - t1}

    # ---------------------------------------------------- more devices
    def _card(self):
        torch = self.torch
        return torch.device('cuda', torch.cuda.current_device())

    def mesh_path(self):
        """More than one device on one card (mesh entries repeat cuda:0).
        BDETrainer on the main path's config with MESH_CHAINS chains over
        MESH_ENTRIES entries: sampling pads them to a multiple of the
        entries and drops the pad chains from the draws, the tuned values,
        the final state and the sink's files; K1 and K3 launched 3 and 1
        times a step for the padded batch on the first device. Then
        run_mclmc on the main path's posterior over a 4-entry chain mesh
        and a 2 x 2 chains x data mesh against one device, and MESH_STEPS
        steps on each mesh held against the one-device steps."""
        import numpy as np
        import shutil

        torch = self.torch
        from mile_tpu_torch.config import Config
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.parallel.mesh import chain_data_mesh, chain_mesh
        from mile_tpu_torch.train.checkpoint import load_flat_samples
        from mile_tpu_torch.train.sampling import run_mclmc
        from mile_tpu_torch.train.trainer import BDETrainer

        card = self._card()
        (config,) = Config.from_file(CONFIG)
        config = config.replace(
            saving_dir=str(MESH_RESULTS.parent),
            experiment_name=MESH_RESULTS.name,
            **{**CUT, 'training.sampler.n_chains': MESH_CHAINS})
        scfg = config.training.sampler
        shutil.rmtree(MESH_RESULTS, ignore_errors=True)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = BDETrainer(config, devices=[card] * MESH_ENTRIES)
        members = trainer.train_warmstart()
        result = trainer.start_sampling(members)
        metrics = trainer.evaluate(members, result)
        torch.cuda.synchronize()
        seconds = {'trainer': time.perf_counter() - t0}
        k1, k3 = self._launches()
        n_kept = math.ceil(scfg.n_samples / scfg.n_thinning)
        n_steps = scfg.warmup_steps + n_kept * scfg.n_thinning
        n_run = MESH_CHAINS + trainer._pad_chains
        shapes = {'samples': result.samples.shape[0],
                  'on disk': load_flat_samples(trainer.samples_dir).shape[0],
                  'chain dirs': len(list(trainer.samples_dir.glob(
                      'chain_*'))),
                  **{f'tuned {k}': v.shape[0]
                     for k, v in result.tuned.items()},
                  **{f'info {k}': v.shape[0] for k, v in result.info.items()},
                  **{f'final {k}': v.shape[0] for k, v in
                     result.final_state._asdict().items()}}
        self.check(trainer.mesh.size == 1 and trainer._pad_chains == 1
                   and trainer._sampling_mesh.size == MESH_ENTRIES
                   and set(shapes.values()) == {MESH_CHAINS},
                   f'{MESH_CHAINS} chains over {MESH_ENTRIES} entries of '
                   f'{card}: divisor mesh {trainer.mesh.size}, sampling mesh '
                   f'{trainer._sampling_mesh.size}, {n_run} chains run; '
                   f'chains in every result and on disk {shapes}')
        self.check(k1 == 3 * n_steps and k3 == n_steps
                   and bool(np.isfinite(result.samples).all())
                   and math.isfinite(float(metrics['lppd'])),
                   f'padded trainer: K1 {k1} (3 x {n_steps} steps), K3 {k3} '
                   f'(1 x {n_steps}) on the first device for the ({n_run}, '
                   f'{MAIN_SHAPE[1]}) batch; finite draws; lppd '
                   f'{float(metrics["lppd"]):.4f}')
        self._mesh_warm_start(trainer, config, card, seconds)

        main_trainer, main_members = self.main_run
        rcfg = main_trainer.config.replace(**MESH_RUN_CUT).training.sampler
        x, y = main_trainer.loader.arrays('train')
        meshes = {'one device': None,
                  '4-entry chain mesh': chain_mesh(4, [card] * 4),
                  '2 x 2 chains x data mesh': chain_data_mesh(2, 2,
                                                              [card] * 4)}
        runs, launches = {}, {}
        for label, mesh in meshes.items():
            before = self._launches()
            t0 = time.perf_counter()
            runs[label] = run_mclmc(
                main_trainer.bayes.logdensity_and_grad_fn(x, y, mesh), rcfg,
                torch.Generator().manual_seed(MP_SEED), main_members,
                mesh=mesh)
            torch.cuda.synchronize()
            seconds[label] = time.perf_counter() - t0
            launches[label] = tuple(a - b for a, b in
                                    zip(self._launches(), before))
        self.path_launches['mesh'] = dict(zip(
            ('isokinetic_momentum', 'partial_refresh'), self._launches()))
        n_run_steps = rcfg.warmup_steps + rcfg.n_samples
        ref = runs['one device']
        for label, mesh in meshes.items():
            run = runs[label]
            same = bool(np.array_equal(run.samples, ref.samples))
            apart = float(np.abs(run.samples - ref.samples).max())
            eps = float(np.abs(run.tuned['step_size']
                               - ref.tuned['step_size']).max())
            self.check(launches[label] == (3 * n_run_steps, n_run_steps)
                       and run.samples.shape[0] == MAIN_SHAPE[0]
                       and bool(np.isfinite(run.samples).all()),
                       f'run_mclmc over the {label}: K1/K3 {launches[label]}'
                       f' (3 and 1 x {n_run_steps} steps), finite draws '
                       f'{run.samples.shape}; against one device: '
                       + ('bit for bit' if same else
                          f'draws apart by {apart:.2e}, tuned eps by '
                          f'{eps:.2e} (the tuner amplifies float32 '
                          f'rounding)') + f'; {seconds[label]:.2f} s')
        self.timings['mesh_s'] = seconds
        self._mesh_steps(main_trainer, self.main_result,
                         {k: v for k, v in meshes.items() if v is not None})

    def _mesh_warm_start(self, trainer, config, card, seconds):
        """The warm start over a chain mesh of cuda:0 twice: train_ensemble
        on the padded trainer's model and data (the trainer itself warm
        starts on its divisor mesh of one entry, as the JAX trainer does)
        against one device, within MESH_WS_RTOL, with both times."""
        torch = self.torch
        from mile_tpu_torch.parallel.mesh import chain_mesh
        from mile_tpu_torch.train.warmstart import train_ensemble

        members = {}
        for label, mesh in (('one device', None),
                            (f'{MESH_ENTRIES} entries',
                             chain_mesh(MESH_ENTRIES,
                                        [card] * MESH_ENTRIES))):
            t0 = time.perf_counter()
            members[label], _ = train_ensemble(
                trainer.model, trainer.loader, config.training.warmstart,
                config.data.task, MESH_CHAINS,
                torch.Generator().manual_seed(MP_SEED), mesh=mesh)
            torch.cuda.synchronize()
            seconds[f'warm start, {label}'] = time.perf_counter() - t0
        alone, sharded = members.values()
        scale = float(alone.abs().max())
        apart = float((sharded - alone).abs().max())
        n_steps = config.training.warmstart.max_epochs * (
            trainer.loader.arrays('train')[0].shape[0]
            // config.training.warmstart.batch_size)
        self.timings['mesh_warm_start'] = {
            'max_abs_diff': apart, 'max_abs': scale,
            'bitwise': bool(torch.equal(sharded, alone))}
        self.check(apart <= MESH_WS_RTOL * scale,
                   f'warm start of {MESH_CHAINS} members ({n_steps} AdamW '
                   f'steps) over {MESH_ENTRIES} entries of {card} against '
                   f'one device: max|d theta| {apart:.2e} (<= '
                   f'{MESH_WS_RTOL:g} x max|theta| {scale:.3g}); '
                   + ('bit for bit; ' if torch.equal(sharded, alone) else '')
                   + f'{seconds["warm start, one device"]:.2f} s against '
                   f'{seconds[f"warm start, {MESH_ENTRIES} entries"]:.2f} s')

    def _mesh_steps(self, trainer, result, meshes):
        """MESH_STEPS steps on each mesh, each from the one-device run's
        state with the same injected normals, against the one-device
        step: positions and dE (see MESH_X_ATOL, MESH_DE_UNITS)."""
        torch = self.torch
        from mile_tpu_torch.mcmc import mclmc
        from mile_tpu_torch.utils.precision import matmul_precision

        gen = torch.Generator().manual_seed(11)
        normals = [torch.randn(*MAIN_SHAPE, generator=gen)
                   for _ in range(MESH_STEPS)]
        ref_states, ref_infos, _ = self._steps(
            trainer, result, self.dev, torch.float32, result.final_state,
            normals)
        scfg = trainer.config.training.sampler
        x, y = trainer.loader.arrays('train')
        tuned = {k: torch.as_tensor(v).to(self.dev)
                 for k, v in result.tuned.items()}
        sdc = (tuned['sqrt_diag_cov'] if scfg.diagonal_preconditioning
               else None)
        out = {}
        for label, mesh in meshes.items():
            vg = trainer.bayes.logdensity_and_grad_fn(x, y, mesh)
            kernel = mclmc.build_kernel(
                vg, torch.Generator().manual_seed(0),
                integrator=scfg.integrator,
                noise=iter([z.to(self.dev) for z in normals]))
            dx, units, bitwise = [], [], True
            with matmul_precision('float32'):
                for i in range(MESH_STEPS):
                    start = mclmc.init(ref_states[i].position, vg,
                                       momentum=ref_states[i].momentum)
                    state, info = kernel(start, tuned['L'],
                                         tuned['step_size'], sdc)
                    want, want_info = ref_states[i + 1], ref_infos[i]
                    dx.append(float((state.position - want.position)
                                    .abs().max()))
                    unit = 2.0 ** -23 * (start.logdensity.abs()
                                         + info.logdensity.abs()
                                         + info.kinetic_change.abs())
                    units.append(float(((info.energy_change
                                         - want_info.energy_change).abs()
                                        / unit).max()))
                    bitwise = bitwise and torch.equal(
                        state.position, want.position) and torch.equal(
                        info.energy_change, want_info.energy_change)
            out[label] = {'max_dx': max(dx), 'max_dE_units': max(units),
                          'bitwise': bitwise}
            self.check(max(dx) <= MESH_X_ATOL and max(units) <= MESH_DE_UNITS,
                       f'{MESH_STEPS} steps over the {label}, each from the '
                       f'one-device state with the same normals: max|dx| '
                       f'{max(dx):.2e} (atol {MESH_X_ATOL:g}), dE '
                       f'{max(units):.1f} float32 units (<= '
                       f'{MESH_DE_UNITS:g}); '
                       + ('bit for bit' if bitwise else 'not bit for bit'))
        self.timings['mesh_steps'] = out

    def image_mesh_gradient(self):
        """The image path's full-batch LeNet value and gradient at the
        tuned state (IMAGE_SHAPE, IMAGE_TRAIN images) over a chain mesh of
        cuda:0 twice (5 chains a shard) against the unsharded one, with
        the times of both (median of 3 after one warm-up call)."""
        torch = self.torch
        from mile_tpu_torch.parallel.mesh import chain_mesh
        from mile_tpu_torch.utils.precision import matmul_precision

        trainer, result = self.image_run
        card = self._card()
        x, y = trainer.loader.arrays('train')
        theta = result.final_state.position
        fns = {'unsharded': trainer.bayes.logdensity_and_grad_fn(x, y),
               'mesh': trainer.bayes.logdensity_and_grad_fn(
                   x, y, chain_mesh(2, [card] * 2))}
        out, times = {}, {}
        with matmul_precision(trainer.config.training.sampler
                              .matmul_precision):
            for key, vg in fns.items():
                vg(theta)
                times[key] = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out[key] = vg(theta)
                    torch.cuda.synchronize()
                    times[key].append(1e3 * (time.perf_counter() - t0))
        (v0, g0), (v1, g1) = out['unsharded'], out['mesh']
        value_rel = float(((v1 - v0).abs() / v0.abs()).max())
        grad = float((g1 - g0).abs().max() / g0.abs().max())
        ms = {k: statistics.median(v) for k, v in times.items()}
        self.timings['image_mesh_gradient'] = {
            'ms': times, 'value_rel': value_rel, 'grad_over_max': grad,
            'bitwise': bool(torch.equal(v0, v1) and torch.equal(g0, g1))}
        self.check(value_rel <= GRAD_RTOL and grad <= GRAD_GTOL,
                   f'LeNet value and gradient {tuple(theta.shape)} on '
                   f'{x.shape[0]} images over a chain mesh of {card} twice '
                   f'vs unsharded: value rel {value_rel:.1e} (rtol '
                   f'{GRAD_RTOL:g}), gradient {grad:.1e} max|g| (atol '
                   f'{GRAD_GTOL:g}); {ms["mesh"]:.1f} ms on the mesh, '
                   f'{ms["unsharded"]:.1f} ms unsharded (medians of 3)')

    def multiprocess(self):
        """Two processes (this script with --multiprocess-worker) joined
        over gloo, each with a chain mesh of cuda:0 twice: rank 0's draws
        equal one process's over 4 entries bit for bit, the in-step check
        raised on differing arrays, the members came back from the
        checkpoint both ranks wrote, and the trainer's warm start over both
        ranks gave one process's members within MESH_WS_RTOL, with both
        times."""
        import numpy as np
        import shutil
        import socket

        torch = self.torch
        from mile_tpu_torch.parallel.mesh import chain_mesh
        from mile_tpu_torch.train.trainer import BDETrainer

        card = self._card()
        shutil.rmtree(MP_RESULTS, ignore_errors=True)
        MP_RESULTS.mkdir(parents=True)
        members = self.main_run[1]
        np.save(MP_RESULTS / 'members.npy', members.cpu().numpy())
        with socket.socket() as sock:
            sock.bind(('localhost', 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / 'chip_smoke.py'),
             '--multiprocess-worker', str(rank), str(port)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(2)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=MP_TIMEOUT_S)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        workers_s = time.perf_counter() - t0
        for rank, (proc, log) in enumerate(zip(procs, logs)):
            for line in log.splitlines()[-6:]:
                print(f'    rank {rank}: {line}')
        ok = all(p.returncode == 0 and f'rank {r} ok' in log
                 for r, (p, log) in enumerate(zip(procs, logs)))
        self.check(ok, f'two worker processes over gloo exited 0 '
                       f'({[p.returncode for p in procs]}) in '
                       f'{workers_s:.1f} s')
        if not ok:
            return
        bayes, x, y, scfg = airfoil_posterior(card)
        before = self._launches()
        t0 = time.perf_counter()
        ref = multiprocess_run(bayes, x, y, scfg, members,
                               chain_mesh(4, [card] * 4))
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        self.path_launches['multiprocess'] = dict(zip(
            ('isokinetic_momentum', 'partial_refresh'),
            (a - b for a, b in zip(self._launches(), before))))
        with np.load(MP_RESULTS / 'rank0.npz') as got:
            got = dict(got)
        n_steps = scfg.warmup_steps + scfg.n_samples
        same = bool(np.array_equal(got['samples'], ref.samples))
        apart = float(np.abs(got['samples'] - ref.samples).max())
        self.check(same and int(got['mesh_size']) == 4
                   and tuple(got['launches']) == (3 * n_steps, n_steps),
                   f'rank 0 of 2 (mesh of {int(got["mesh_size"])} entries '
                   f'over both ranks) vs one process over 4 entries: draws '
                   f'{got["samples"].shape} '
                   + ('equal bit for bit' if same else
                      f'apart by {apart:.2e}') + f'; rank 0 launched K1/K3 '
                   f'{tuple(got["launches"])} (3 and 1 x {n_steps}); one '
                   f'process {one_s:.2f} s')
        self.check(bool(got['guard_raised']),
                   'the in-step check raised on ranks holding different '
                   'arrays')
        self.check(np.array_equal(got['restored'], members.cpu().numpy()),
                   'the members written by both ranks through '
                   'torch.distributed.checkpoint came back equal')
        one = BDETrainer(multiprocess_warmstart_config('warmstart_one'),
                         device=card)
        t0 = time.perf_counter()
        alone = one.train_warmstart().cpu().numpy()
        alone_s = time.perf_counter() - t0
        scale = float(np.abs(alone).max())
        apart = float(np.abs(got['warm'] - alone).max())
        warm_s = float(got['warm_s'])
        self.check(int(got['warm_mesh_size']) == 4
                   and apart <= MESH_WS_RTOL * scale,
                   f'BDETrainer.train_warmstart over 2 ranks (mesh of '
                   f'{int(got["warm_mesh_size"])} entries, {MP_WS_EPOCHS} '
                   f'epochs) against one process: max|d theta| '
                   f'{apart:.2e} (<= {MESH_WS_RTOL:g} x max|theta| '
                   f'{scale:.3g}); '
                   + ('bit for bit; ' if np.array_equal(got['warm'], alone)
                      else '')
                   + f'{warm_s:.2f} s on rank 0 against {alone_s:.2f} s in '
                   f'one process')
        self.timings['multiprocess_s'] = {'workers': workers_s,
                                          'one_process': one_s,
                                          'warm_start_2_ranks': warm_s,
                                          'warm_start_one_process': alone_s}
        self.timings['multiprocess_warm_start'] = {
            'max_abs_diff': apart, 'max_abs': scale,
            'bitwise': bool(np.array_equal(got['warm'], alone))}

    def orbax_format(self):
        """``checkpoint_format='orbax'``: the MCLMC resume runs again, stopped
        after chunk 2 and, apart, inside chunk 0, with the snapshot in
        torch.distributed.checkpoint's format, each resumed bit for bit
        with K1/K3 launched 3 and 1 times per step left; a trainer writing
        warmstart/orbax/ and a second trainer reusing it with the npz
        members gone, bit for bit."""
        import shutil

        torch = self.torch
        from mile_tpu_torch.config import Config
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.train import sampling
        from mile_tpu_torch.train.trainer import BDETrainer

        vg, scfg, members, full = self.resume_run
        n_chains, dim = MAIN_SHAPE
        shutil.rmtree(ORBAX_RESULTS, ignore_errors=True)
        ckpt_dir = ORBAX_RESULTS / 'resume'

        def run(**kwargs):
            return sampling.run_mclmc(
                vg, scfg, torch.Generator().manual_seed(RESUME_SEED),
                members, max_chunk_bytes=RESUME_CHUNK_KEPT * n_chains * dim
                * 4, checkpoint_dir=ckpt_dir, checkpoint_format='orbax',
                **kwargs)

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        n_kept = math.ceil(scfg.n_samples / scfg.n_thinning)
        keys = [('info', 'energy_change'), ('info', 'energy_change_sq'),
                ('tuned', 'step_size'), ('tuned', 'L')]
        stops = {'after chunk 2': (StopAfter(2), 2 * RESUME_CHUNK_KEPT),
                 'inside chunk 0': (None, 0)}
        for label, (sink, done) in stops.items():
            push = sampling.Drain.push
            if sink is None:   # stop before the first chunk is drained
                def halt(*args, **kwargs):
                    raise SimulatedStop('inside chunk 0')
                sampling.Drain.push = halt
            try:
                run(sample_sink=sink)
                stopped = False
            except SimulatedStop:
                stopped = True
            finally:
                sampling.Drain.push = push
            snapshot = (ckpt_dir / 'sampler_state_orbax' / 'step_0'
                        / '.metadata').is_file() and not (
                            ckpt_dir / 'sampler_state.npz').exists()
            before = self._launches()
            resumed = run()
            k1, k3 = (a - b for a, b in zip(self._launches(), before))
            left = (n_kept - done) * scfg.n_thinning
            same = self._equal(resumed, full, keys)
            self.check(stopped and snapshot and all(same.values())
                       and (k1, k3) == (3 * left, left)
                       and not ckpt_dir.exists(),
                       f'MCLMC with checkpoint_format orbax stopped {label} '
                       f'(snapshot as a torch.distributed.checkpoint: '
                       f'{snapshot}) and resumed: bitwise equal to the '
                       f'uninterrupted run {same}; K1 {k1} (3 x {left} '
                       f'steps left), K3 {k3}; checkpoint removed')
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.path_launches['orbax'] = dict(zip(
            ('isokinetic_momentum', 'partial_refresh'), self._launches()))

        (config,) = Config.from_file(CONFIG)
        config = config.replace(
            saving_dir=str(ORBAX_RESULTS), experiment_name='first',
            **{**CUT, 'training.warmstart.max_epochs': STREAM_EPOCHS,
               'training.checkpoint_format': 'orbax'})
        first = BDETrainer(config, device=self.dev)
        written = first.train_warmstart()
        metadata = (first.warmstart_dir / 'orbax' / 'step_0'
                    / '.metadata').is_file()
        for path in first.warmstart_dir.glob('params_*.npz'):
            path.unlink()
        second = BDETrainer(config.replace(
            experiment_name='second',
            **{'training.warmstart.warmstart_exp_dir': str(first.exp_dir)}),
            device=self.dev)
        reused = second.train_warmstart()
        torch.cuda.synchronize()
        self.check(metadata and torch.equal(written, reused)
                   and (second.warmstart_dir / 'params_0.npz').is_file(),
                   f'checkpoint_format orbax: warmstart/orbax/ written '
                   f'({metadata}); a second trainer reused it with the npz '
                   f'members gone: {tuple(reused.shape)} members bit for '
                   f'bit')
        self.timings['orbax_format_s'] = {
            'resume': t1 - t0, 'trainers': time.perf_counter() - t1}

    # ---------------------------------------------------------- split HMC
    def _split_module(self):
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            'torch_symmetric_splitting', SPLIT_SCRIPT)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def split_hmc(self):
        """experiments/torch_symmetric_splitting.py on the card at LeNet
        width (SPLIT_ARGS on the image path's synthetic archive, the
        reference's hyperparameters): its JSON line, finite accuracy and
        LPPD, no hand-written kernel; the time of a shard gradient and of
        a proposal; one split-leapfrog step on the card against the CPU's
        from the same theta and p in float32."""
        import contextlib as _contextlib
        import io

        torch = self.torch
        from mile_tpu_torch.mcmc import split_hmc
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.utils.precision import matmul_precision

        if not IMAGE_ARCHIVE.exists():
            self._image_archive()
        module = self._split_module()
        argv = ['--dataset', str(IMAGE_ARCHIVE), *SPLIT_ARGS]
        args = module.parse_args(argv + ['--device', self.dev.type])
        ops.reset_launch_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with _contextlib.redirect_stdout(out):
            result = module.main(argv + ['--device', self.dev.type])
        wall = time.perf_counter() - t0
        lines = out.getvalue().strip().splitlines()
        for line in lines:
            print(f'    {line}')
        launches = self._launches()
        values = (result['accuracy'], result['lppd'])
        self.check(json.loads(lines[-1]) == result
                   and all(math.isfinite(v) for v in values)
                   and 0.0 <= result['acceptance_rate'] <= 1.0
                   and result['n_samples'] == args.num_samples - args.burn
                   and launches == (0, 0),
                   f'torch_symmetric_splitting.py on the card: last line '
                   f'{lines[-1]}; K1/K3 launches {launches} (plain torch)')

        card = module.setup(args)
        n_shards, batch, dim = SPLIT_SHAPE
        self.check((card.n_shards, args.batch_size, card.bayes.dim)
                   == SPLIT_SHAPE and args.num_steps == 30
                   and args.step_size == 5e-4 and args.mass == 0.01,
                   f'split HMC at LeNet width: {card.n_shards} shards of '
                   f'{args.batch_size} ({card.n_train} training images), dim '
                   f'{card.bayes.dim}, {args.num_steps} leapfrog steps of '
                   f'{args.step_size:g}, mass {args.mass:g}')
        n_shards = card.n_shards
        cpu = module.setup(module.parse_args(argv + ['--device', 'cpu']))
        gen = torch.Generator().manual_seed(37)
        p = torch.randn(1, dim, generator=gen) / 10.0
        theta = card.theta0.cpu()
        imm = card.inverse_mass_matrix.cpu()
        ends, times = {}, {}
        with matmul_precision('float32'):
            for name, problem in (('card', card), ('cpu', cpu)):
                step = split_hmc.build_integrator(problem.shard_potential,
                                                  problem.n_shards)
                dev = problem.device
                t0 = time.perf_counter()
                ends[name] = [v.cpu() for v in step(
                    theta.to(dev), p.to(dev), args.step_size, imm.to(dev))]
                times[name] = time.perf_counter() - t0
            # the card's step again, warm: 2 x 49 shard gradients
            step = split_hmc.build_integrator(card.shard_potential, n_shards)
            reps = 2
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                step(card.theta0, p.to(self.dev), args.step_size,
                     card.inverse_mass_matrix)
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / reps
            # where a shard gradient's time goes: one profiled step
            try:
                wall_us, busy, rows, _ = self._profiled(
                    lambda: step(card.theta0, p.to(self.dev),
                                 args.step_size, card.inverse_mass_matrix))
                n_grads = 2 * n_shards
                profile = {
                    'wall_ms_per_shard_gradient': wall_us / 1e3 / n_grads,
                    'device_ms_per_shard_gradient': busy / 1e3 / n_grads,
                    'device_busy_share': busy / wall_us,
                    'kernels_per_shard_gradient':
                        sum(r[1] for r in rows) / n_grads,
                    'top': [{'name': k[:60], 'launches': c, 'us': d}
                            for d, c, k in rows[:6]]}
            except Exception as exc:   # reported, not fatal
                profile = {'unavailable': repr(exc)}
        # the script's own sampling time (to 0.1 s) over its proposals
        proposal_s = result['sampling_time_s'] / args.num_samples
        errors = {}
        for i, name in enumerate(('theta', 'p')):
            start = theta if name == 'theta' else p
            change = float((ends['cpu'][i] - start).abs().max())
            errors[name] = float((ends['card'][i] - ends['cpu'][i])
                                 .abs().max()) / change
        self.check(max(errors.values()) <= SPLIT_STEP_RTOL,
                   f'one split-leapfrog step ({2 * n_shards} shard '
                   f'gradients), card vs CPU in float32: max error of the '
                   f'end point over the largest change {errors} (rtol '
                   f'{SPLIT_STEP_RTOL:g}); card {times["card"]:.2f} s cold, '
                   f'CPU {times["cpu"]:.2f} s')
        shard_ms = 1e3 * step_s / (2 * n_shards)
        self.timings['split_hmc'] = {
            'script_wall_s': wall, 'result': result,
            'shard_gradient_ms': shard_ms, 'leapfrog_step_s': step_s,
            'proposal_s': proposal_s, 'step_check_rel_err': errors,
            'profile': profile,
            'cpu_step_s': times['cpu']}
        print(f'  split HMC: a shard gradient (LeNet, batch {batch}) '
              f'{shard_ms:.3f} ms, a split-leapfrog step {step_s:.3f} s, a '
              f'proposal ({args.num_steps} steps, '
              f'{2 * n_shards * args.num_steps} shard gradients, then the '
              f'full potential) {proposal_s:.2f} s; the script '
              f'{wall:.1f} s')
        print(f'  split HMC profile {json.dumps(profile)}')

    # -------------------------------------------------- experiment harness
    def _experiments(self, name: str):
        """A module of the checkout's ``experiments/``."""
        import importlib

        if str(ROOT / 'experiments') not in sys.path:
            sys.path.insert(0, str(ROOT / 'experiments'))
        return importlib.import_module(name)

    def catalog(self):
        """CATALOG_JOBS through ``run_queue`` on the card: every job ok with
        a finite LPPD (sonar's accuracy above chance), K1 and K3 launched 3
        and 1 times per MCLMC step of each MCLMC job and never in the NUTS
        job, K1 and K3 against their plain versions at each MCLMC job's
        shape, each consumer's warm start its provider's bit for bit; a
        second ``run_queue`` skips all without a trainer, a STOP file gives
        75 and is consumed; ``pool_results.pool`` gives one row per job and
        ``summarize_study.summarize`` a table of it."""
        import dataclasses
        import pickle
        import shutil

        import numpy as np

        torch = self.torch
        cat = self._experiments('torch_run_catalog')
        pool_results = self._experiments('pool_results')
        summarize_study = self._experiments('summarize_study')
        from mile_tpu_torch.config import Sampler, Task
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.train import trainer as trainer_mod
        from mile_tpu_torch.utils.card import HBM_BYTES_PER_S

        by_key = {f'{j.study}/{j.name}': j for j in cat.build_jobs()}
        jobs = [dataclasses.replace(by_key[key], overrides={
            **by_key[key].overrides,
            **(CATALOG_NUTS_CUT if '_nuts_' in key else CATALOG_CUT)})
            for key in CATALOG_JOBS]
        root = CATALOG_RESULTS
        shutil.rmtree(root, ignore_errors=True)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cat.run_queue(jobs, root, device=self.dev.type)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self._launches()
        self.path_launches['catalog'] = dict(zip(
            ('isokinetic_momentum', 'partial_refresh'), launches))
        records = {r['job']: r for r in map(json.loads, (
            root / 'queue.jsonl').read_text().splitlines())}
        self.check(rc == 0 and len(records) == len(jobs)
                   and all(r['ok'] for r in records.values()),
                   f'run_queue over {len(jobs)} jobs on the card: exit {rc},'
                   f' {sum(r["ok"] for r in records.values())} ok in '
                   f'{wall:.1f} s')
        summed = tuple(sum(r['launches'][k] for r in records.values())
                       for k in ('isokinetic_momentum', 'partial_refresh'))
        self.check(summed == launches,
                   f'the jobs\' launches {summed} are the run\'s {launches}')
        per_job = {}
        for job in jobs:
            exp = job.exp_dir(root)
            rec = records[job.name]
            config = job.config(root)
            scfg = config.training.sampler
            with open(exp / 'metrics.pkl', 'rb') as f:
                metrics = pickle.load(f)
            dim = sum(a.size for a in np.load(
                exp / 'warmstart' / 'params_0.npz').values())
            if scfg.name == Sampler.MCLMC:
                steps = mclmc_steps(scfg)
                want = {'isokinetic_momentum': 3 * steps,
                        'partial_refresh': steps}
            else:
                steps = scfg.warmup_steps + scfg.n_samples
                want = {'isokinetic_momentum': 0, 'partial_refresh': 0}
            ok = (rec['launches'] == want
                  and math.isfinite(float(metrics['lppd'])))
            what = (f'{job.study}/{job.name}: ({scfg.n_chains}, {dim}), '
                    f'{scfg.name.value} {steps} steps, K1/K3 '
                    f'{rec["launches"]["isokinetic_momentum"]}/'
                    f'{rec["launches"]["partial_refresh"]} (want '
                    f'{want["isokinetic_momentum"]}/'
                    f'{want["partial_refresh"]}), lppd '
                    f'{float(metrics["lppd"]):.4f}')
            if config.data.task == Task.CLASSIFICATION:
                ok = ok and float(metrics['acc']) > 0.5
                what += f', accuracy {float(metrics["acc"]):.3f} (> 0.5)'
            k1_bytes, k3_bytes = kernel_bytes(
                scfg.n_chains, dim, scfg.diagonal_preconditioning)
            per_job[job.name] = {
                'shape': [scfg.n_chains, dim], 'steps': steps,
                'wall_s': rec['wall_s'], 'launches': rec['launches'],
                'lppd': float(metrics['lppd']),
                'bound_us': {'isokinetic_momentum':
                             1e6 * k1_bytes / HBM_BYTES_PER_S,
                             'partial_refresh':
                             1e6 * k3_bytes / HBM_BYTES_PER_S}}
            self.check(ok, what + f'; {rec["wall_s"]} s')
            if job.warmstart_from is not None:
                provider = job.warmstart_dir(root) / 'warmstart'
                same = all(
                    all(np.array_equal(a[k], b[k]) for k in a.files)
                    for a, b in ((np.load(provider / f'params_{i}.npz'),
                                  np.load(exp / 'warmstart' /
                                          f'params_{i}.npz'))
                                 for i in range(scfg.n_chains)))
                self.check(same, f'{job.name} reuses '
                                 f'{job.warmstart_from}\'s members bit for '
                                 f'bit')

        # K1 and K3 against their plain versions at each MCLMC job's shape
        # (K1 with a per-chain sqrt_diag_cov too: feas_tuned_airfoil's)
        shapes = {tuple(row['shape']) for row in per_job.values()
                  if row['launches']['partial_refresh']}
        self.check(shapes == {MAIN_SHAPE, *CATALOG_SHAPES},
                   f'the MCLMC jobs\' shapes {sorted(shapes)} are '
                   f'CATALOG_SHAPES and {MAIN_SHAPE}')
        gen = torch.Generator().manual_seed(5)
        for n_chains, dim in sorted(shapes):
            self._k1_check(n_chains, dim)
            self._k3_check(n_chains, dim, gen)

        class Boom:
            def __init__(self, *args, **kwargs):
                raise AssertionError('a skipped job built a trainer')

        saved = trainer_mod.BDETrainer
        trainer_mod.BDETrainer = Boom
        try:
            again = cat.run_queue(jobs, root, device=self.dev.type)
            n_records = len((root / 'queue.jsonl').read_text().splitlines())
            (root / 'STOP').touch()
            stop = cat.run_queue(jobs, root, device=self.dev.type)
        finally:
            trainer_mod.BDETrainer = saved
        self.check(again == 0 and n_records == len(jobs),
                   f'a second run_queue over the same root: exit {again}, '
                   f'every job skipped without a trainer')
        self.check(stop == 75 and not (root / 'STOP').exists(),
                   f'a STOP file: exit {stop}, consumed')

        df = pool_results.pool(root)
        mclmc = df['training.sampler.name'] == 'mclmc'
        for job in jobs:
            row = df[df['experiment_name'] == job.name]
            sampling = float(row['time.sampling'].iloc[0])
            per_job[job.name]['time_sampling_s'] = sampling
            per_job[job.name]['chain_steps_per_s'] = (
                per_job[job.name]['shape'][0] * per_job[job.name]['steps']
                / sampling)
        self.check(len(df) == len(jobs)
                   and set(df['experiment_name']) == {j.name for j in jobs}
                   and bool(np.isfinite(df['lppd']).all())
                   and bool((df['time.sampling'] > 0).all())
                   and {'step_size_mean', 'L_mean'} <= set(df.columns)
                   and bool(np.isfinite(df.loc[mclmc, 'step_size_mean'])
                            .all())
                   and bool(df.loc[mclmc, 'L_mean'].notna().all()),
                   f'pool_results.pool: {len(df)} rows of {len(df.columns)}'
                   f' columns, lppd and time.sampling in every row, '
                   f'step_size_mean and L_mean in the '
                   f'{int(mclmc.sum())} MCLMC rows (L_mean finite in '
                   f'{int(np.isfinite(df.loc[mclmc, "L_mean"]).sum())})')
        table = summarize_study.summarize(
            df, ['experiment_name'],
            ['lppd', 'time.sampling', 'step_size_mean', 'L_mean'])
        print(textwrap.indent(table, '  '))
        self.check(len(table.splitlines()) == len(jobs) + 2,
                   'summarize_study.summarize: a table of every job')
        for name, row in per_job.items():
            print(f'  {name}: {row["wall_s"]} s, sampling '
                  f'{row["time_sampling_s"]:.2f} s, '
                  f'{row["chain_steps_per_s"]:.0f} chain-steps/s')
        self.timings['catalog'] = {'wall_s': wall, 'jobs': per_job}

    def _fault_worker(self, mode: str, root: Path) -> tuple:
        """This script as a catalogue worker (``mode`` 'assert' or 'hang')
        over ``root``: (exit code, strikes, queue records, output)."""
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             '--catalog-fault-worker', mode, str(root)],
            cwd=ROOT, capture_output=True, text=True,
            timeout=FAULT_WORKER_TIMEOUT_S)

        def lines(name):
            path = root / name
            return ([json.loads(x) for x in path.read_text().splitlines()]
                    if path.exists() else [])

        return (proc.returncode, lines('FAULTS.jsonl'),
                lines('queue.jsonl'), proc.stdout + proc.stderr)

    def catalog_fault(self):
        """The runner's fault contract with a real device-side assert, in
        worker processes: the first launch exits 70 with one strike and a
        failed record, the second 70 with two strikes, the third skips the
        job without a trainer and exits 0; a job that sleeps past
        ``--job-timeout`` exits 70 with a hang strike."""
        import shutil

        for root in (FAULT_RESULTS / 'assert', FAULT_RESULTS / 'hang'):
            shutil.rmtree(root, ignore_errors=True)
        runs, seconds = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            runs.append(self._fault_worker('assert', FAULT_RESULTS / 'assert'))
            seconds.append(time.perf_counter() - t0)
        (rc1, s1, q1, out1), (rc2, s2, q2, out2), (rc3, s3, q3, out3) = runs
        error = q1[0]['error'] if q1 else ''
        self.check(rc1 == 70 and len(s1) == 1 and len(q1) == 1
                   and q1[0]['ok'] is False and 'CUDA error' in error,
                   f'launch 1: exit {rc1}, {len(s1)} strike, record '
                   f'{error[:120]!r}')
        self.check(rc2 == 70 and len(s2) == 2 and len(q2) == 2,
                   f'launch 2: exit {rc2}, {len(s2)} strikes')
        self.check(rc3 == 0 and len(s3) == 2 and len(q3) == 2,
                   f'launch 3: exit {rc3}, the job skipped without a '
                   f'trainer ({len(q3)} records)')
        t0 = time.perf_counter()
        rc, strikes, queue, out = self._fault_worker('hang',
                                                     FAULT_RESULTS / 'hang')
        seconds.append(time.perf_counter() - t0)
        self.check(rc == 70 and len(strikes) == 1
                   and strikes[0].get('hang') is True
                   and queue and queue[0]['error'] == 'hang',
                   f'a job sleeping past --job-timeout '
                   f'{FAULT_HANG_TIMEOUT_S}: exit {rc}, strikes {strikes}')
        for rc_, text in ((rc1, out1), (rc2, out2), (rc3, out3), (rc, out)):
            if rc_ not in (0, 70):
                print(textwrap.indent(text[-3000:], '    '))
        self.timings['catalog_fault_s'] = seconds

    def catalog_queue(self):
        """The study queue's relaunch loop on the card. A drill: with the
        assert worker as its runner, launches 1 and 2 exit 70 (a real
        device-side assert, one strike each) and are relaunched after the
        cool-off, launch 3 skips the twice-struck job and exits 0, and the
        stage is pooled; then, with a STOP file in the root, that stage
        exits 0 and is pooled again, and a later stage exits 75, is not
        pooled, and ends the loop with 75. Then one stage of five studies
        (QUEUE_STAGE) through the loop with the real runner, one process:
        the dataset study's six r1 jobs, cut to CATALOG_CUT (exit 0, one
        pooled row each, every compared metric finite in
        ``torch_compare_study.py``'s table, K1 and K3 launched 3 and 1
        times per MCLMC step of each job at DATASET_SHAPES, and held
        against their plain versions there), the feasibility energy pair's
        and one cut job of each mixed study's, each comparison with its
        chain diagnostics. And the catalogue phase's cut sonar and
        hyper_params jobs pooled and compared."""
        tq = self._experiments('torch_catalog_queue')
        drill_s = self._queue_drill(tq)
        run = self._queue_run(tq)
        self._queue_dataset(run)
        self.timings['catalog_queue']['drill_s'] = drill_s
        self.timings['catalog_queue']['classif_s'] = self._queue_catalog(
            'tabular_classif', CLASSIF_JOBS, CLASSIF_METRICS, 5)
        self.timings['catalog_queue']['hyper_params_s'] = self._queue_catalog(
            'hyper_params', HYPER_JOBS, HYPER_METRICS, 3)
        self._queue_feasibility(run)
        self.timings['catalog_queue']['mixed'] = self._queue_mixed(run)

    def _queue_run(self, tq) -> dict:
        """QUEUE_STAGE through the loop, the cut worker its runner: the
        loop's exit code, its stage result, the wall time and each job's
        record in ``queue.jsonl``."""
        import shutil

        shutil.rmtree(QUEUE_RESULTS, ignore_errors=True)
        shutil.rmtree(QUEUE_AGGR, ignore_errors=True)
        queue = tq.Queue(QUEUE_RESULTS, aggr_dir=QUEUE_AGGR,
                         device=self.dev.type, cooloff_s=QUEUE_COOLOFF_S,
                         runner=[sys.executable,
                                 str(Path(__file__).resolve()),
                                 '--catalog-cut-worker'])
        t0 = time.perf_counter()
        rc = queue.run([tq.Stage(*QUEUE_STAGE)])
        wall = time.perf_counter() - t0
        (result,) = queue.results
        records = {r['job']: r for r in map(json.loads, (
            QUEUE_RESULTS / 'queue.jsonl').read_text().splitlines())} \
            if (QUEUE_RESULTS / 'queue.jsonl').exists() else {}
        if result.exit_codes != [0]:
            print(textwrap.indent(queue.log_path.read_text()[-3000:], '    '))
        return {'rc': rc, 'result': result, 'wall_s': wall,
                'records': records,
                'job_timeout_s': tq.JOB_TIMEOUT_S['dataset']}

    def _queue_through(self, run: dict, what: str, names) -> dict:
        """Checks that ``names`` ran in ``run``'s one stage, each ok: their
        records."""
        result = run['result']
        records = {n: run['records'][n] for n in names
                   if n in run['records']}
        self.check(run['rc'] == 0 and result.exit_codes == [0]
                   and sorted(records) == sorted(names)
                   and all(r['ok'] for r in records.values()),
                   f'{what} through the loop\'s one stage: runner exit '
                   f'codes {result.exit_codes}, '
                   f'{sum(r["ok"] for r in records.values())} of '
                   f'{len(names)} ok (the stage\'s {len(run["records"])} '
                   f'jobs in {run["wall_s"]:.1f} s, timeout '
                   f'{run["job_timeout_s"]:g} s a job)')
        return records

    def _queue_job_shape(self, name: str, records: dict, shape) -> dict:
        """One cut job of ``QUEUE_STAGE``: its (chains, dim) against
        ``shape`` and its K1/K3 launches against 3 and 1 a step; its
        entry of the phase's timings."""
        import dataclasses

        import numpy as np

        cat = self._experiments('torch_run_catalog')
        job = {j.name: j for j in cat.build_jobs()}[name]
        job = dataclasses.replace(job, overrides={**job.overrides,
                                                  **CATALOG_CUT})
        scfg = job.config(QUEUE_RESULTS).training.sampler
        dim = sum(a.size for a in np.load(
            job.exp_dir(QUEUE_RESULTS) / 'warmstart' /
            'params_0.npz').values())
        steps = mclmc_steps(scfg)
        launches = records[name]['launches']
        self.check(launches == {'isokinetic_momentum': 3 * steps,
                                'partial_refresh': steps}
                   and (scfg.n_chains, dim) == tuple(shape),
                   f'{name}: ({scfg.n_chains}, {dim}) (want '
                   f'{tuple(shape)}), {steps} steps, K1/K3 '
                   f'{launches["isokinetic_momentum"]}/'
                   f'{launches["partial_refresh"]} (3 and 1 a step), '
                   f'{records[name]["wall_s"]} s')
        for k in ('isokinetic_momentum', 'partial_refresh'):
            self.path_launches['catalog_queue'][k] += launches[k]
        return {'shape': [scfg.n_chains, dim], 'steps': steps,
                'wall_s': records[name]['wall_s'], 'launches': launches}

    def _compare(self, study: str, port_csv: Path, finite: bool = True):
        """``torch_compare_study.py STUDY`` on ``port_csv``: the process,
        its predictive table (None if it wrote none) and that table's
        count line. Its chain diagnostics are checked here: every one of
        DIAGNOSTICS for each job, its count line, and with ``finite`` the
        ESS and split R-hat values finite (not the variances, NaN when one
        chain's tuning collapsed, as in some of the studies' own rows; and
        not where a cut run's steps collapse on most chains, as in the
        10-layer feasibility nets)."""
        import numpy as np
        import pandas as pd

        out = RESULTS / f'queue_compare_{study}.csv'
        out.unlink(missing_ok=True)
        proc = subprocess.run(
            [sys.executable, str(ROOT / 'experiments' /
                                 'torch_compare_study.py'), study,
             '--port', str(port_csv), '--out', str(out)],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            print(textwrap.indent(proc.stderr[-3000:], '    '))
        df = pd.read_csv(out) if out.exists() else None
        lines = proc.stdout.strip().splitlines()
        head = (lines.index('Chain diagnostics')
                if 'Chain diagnostics' in lines else len(lines))
        tail = lines.index('NUTS') if 'NUTS' in lines else len(lines)
        last = ([line for line in lines[:head] if line] or [''])[-1]
        diag_last = ([line for line in lines[head + 1:tail] if line]
                     or [''])[-1]
        diag = None if df is None else df[df['table'] == 'diagnostics']
        count = (r'\d+ of \d+ values differ.*' if 'values differ' in last
                 else r'\d+ of \d+ outside their 95 % intervals \(.*\)')
        self.check(proc.returncode == 0 and diag is not None
                   and sorted(set(diag['metric'])) == sorted(DIAGNOSTICS)
                   and set(diag['experiment_name'])
                   == set(df[df['table'] == 'predictive']['experiment_name'])
                   and (not finite or bool(np.isfinite(diag['port'][
                       ~diag['metric'].isin(['mean_bcv', 'mean_wcv'])]).all()))
                   and re.fullmatch(count, diag_last) is not None,
                   f'torch_compare_study.py {study} (exit '
                   f'{proc.returncode}): the chain diagnostics table, '
                   f'{None if diag is None else sorted(set(diag["metric"]))}'
                   f' (want {DIAGNOSTICS}), ESS and R-hat finite'
                   f'{"" if finite else " (not held)"}: {diag_last!r}')
        table = (None if df is None else
                 df[df['table'] == 'predictive'].drop(columns='table')
                 .reset_index(drop=True))
        return proc, table, last

    def _queue_catalog(self, study: str, jobs, metrics, seeds: int
                       ) -> float:
        """The catalogue phase's cut ``jobs`` of ``study`` pooled and
        compared through both of ``torch_compare_study.py``'s tables: the
        predictive ``metrics`` of each job against ``seeds`` JAX seeds'
        interval, every value finite; its seconds."""
        import numpy as np

        t0 = time.perf_counter()
        aggr = QUEUE_AGGR / f'aggr_{study}.csv'
        pool = subprocess.run(
            [sys.executable, str(ROOT / 'experiments' / 'pool_results.py'),
             str(CATALOG_RESULTS / study), '-o', str(aggr)],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        proc, table, last = self._compare(study, aggr)
        seconds = time.perf_counter() - t0
        n = len(jobs) * len(metrics)
        chance = f'{0.05 * n:.1f}'.replace('.', r'\.')
        self.check(pool.returncode == 0 and proc.returncode == 0
                   and table is not None
                   and all(table[table['experiment_name'] == job][
                       'metric'].tolist() == metrics for job in jobs)
                   and sorted(set(table['experiment_name'])) == sorted(jobs)
                   and bool(np.isfinite(table['port']).all())
                   and (table['jax_n'] == seeds).all()
                   and re.fullmatch(rf'\d+ of {n} outside their 95 % '
                                    rf'intervals \({chance} expected by '
                                    r'chance\)', last) is not None,
                   f'the cut {study} jobs {jobs} pooled (exit '
                   f'{pool.returncode}) and compared (exit '
                   f'{proc.returncode}) through '
                   f'{None if table is None else sorted(set(table["metric"]))}'
                   f' (want {metrics}), every value finite, {seeds} JAX '
                   f'seeds an interval: {last!r}, {seconds:.1f} s')
        return seconds

    def _queue_dataset(self, run: dict):
        """The dataset study's r1 jobs of ``run``, pooled and compared; K1
        and K3 at their shapes."""
        import numpy as np
        import pandas as pd

        from mile_tpu_torch.utils.card import HBM_BYTES_PER_S

        names = [f'uci_mclmc_{ds}_r1' for ds in DATASET_SETS]
        records = self._queue_through(run, 'the dataset study\'s r1 jobs',
                                      names)
        self.path_launches['catalog_queue'] = {'isokinetic_momentum': 0,
                                               'partial_refresh': 0}
        per_job = {}
        for name, shape in zip(names, DATASET_SHAPES):
            if name not in records:
                continue
            row = per_job[name] = self._queue_job_shape(name, records, shape)
            k1_bytes, k3_bytes = kernel_bytes(*row['shape'])
            row['bound_us'] = {
                'isokinetic_momentum': 1e6 * k1_bytes / HBM_BYTES_PER_S,
                'partial_refresh': 1e6 * k3_bytes / HBM_BYTES_PER_S}

        pooled = pd.read_csv(QUEUE_AGGR / 'aggr_dataset.csv')
        for name in per_job:
            row = pooled[pooled['experiment_name'] == name]
            if len(row):
                sampling_s = float(row['time.sampling'].iloc[0])
                per_job[name]['time_sampling_s'] = sampling_s
                per_job[name]['time_warmstart_s'] = float(
                    row['time.warmstart'].iloc[0])
                per_job[name]['chain_steps_per_s'] = (
                    per_job[name]['shape'][0] * per_job[name]['steps']
                    / sampling_s)
        self.check(sorted(pooled['experiment_name']) == sorted(names),
                   f'pooled into {QUEUE_AGGR / "aggr_dataset.csv"}: a row '
                   f'for each set ({len(pooled)} rows)')
        proc, table, last = self._compare('dataset',
                                          QUEUE_AGGR / 'aggr_dataset.csv')
        self.check(proc.returncode == 0 and table is not None
                   and len(table) == 6 * len(names)
                   and bool(np.isfinite(table['port']).all())
                   and sorted(set(table['group'])) == sorted(
                       f'uci_mclmc_{ds}' for ds in DATASET_SETS),
                   f'torch_compare_study.py: exit {proc.returncode}, '
                   f'{0 if table is None else len(table)} comparisons, '
                   f'every compared metric finite (at cut step counts the '
                   f'verdicts mean nothing: {last!r})')

        # K1 and K3 against their plain versions at the jobs' shapes
        gen = self.torch.Generator().manual_seed(11)
        for n_chains, dim in sorted(set(DATASET_SHAPES)):
            self._k1_check(n_chains, dim)
            self._k3_check(n_chains, dim, gen)
        for name, row in per_job.items():
            print(f'  {name}: {row["wall_s"]} s, sampling '
                  f'{row.get("time_sampling_s", float("nan")):.2f} s, '
                  f'{row.get("chain_steps_per_s", float("nan")):.0f} '
                  f'chain-steps/s')
        self.timings['catalog_queue'] = {'wall_s': run['wall_s'],
                                         'jobs': per_job}

    def _queue_feasibility(self, run: dict):
        """The feasibility study's energy pair of ``run``, pooled and
        compared value by value; K1 (preconditioned too) and K3 at its
        shape."""
        records = self._queue_through(
            run, 'the feasibility study\'s energy pair', FEAS_JOBS)
        per_job = {name: self._queue_job_shape(name, records, FEAS_SHAPE)
                   for name in FEAS_JOBS if name in records}
        proc, table, last = self._compare(
            'feasibility', QUEUE_AGGR / 'aggr_feasibility.csv', finite=False)
        verdicts = set() if table is None else set(table['verdict'])
        self.check(proc.returncode == 0 and table is not None
                   and sorted(set(table['experiment_name'])) == FEAS_JOBS
                   and table[table['experiment_name'] == FEAS_JOBS[0]][
                       'metric'].tolist() == FEAS_METRICS
                   and verdicts <= {'both finite', 'both fail', 'differ'}
                   and re.fullmatch(r'lppd finiteness agrees in \d of 2 '
                                    r'jobs; \d+ of 12 values differ.*', last)
                   is not None,
                   f'torch_compare_study.py feasibility (exit '
                   f'{proc.returncode}), value by value through '
                   f'{FEAS_METRICS}: verdicts {sorted(verdicts)}, {last!r}')
        self._k1_check(*FEAS_SHAPE)
        self._k3_check(*FEAS_SHAPE, self.torch.Generator().manual_seed(13))
        self.timings['catalog_queue']['feasibility'] = {'jobs': per_job}

    def _queue_mixed(self, run: dict) -> dict:
        """One cut job of each mixed study's MCLMC or DE half
        (MIXED_SHAPES) and datasize's cut NUTS job (QUEUE_NUTS_JOB) of
        ``run``: every job ok, K1 and K3 launched 3 and 1 times a step at
        MIXED_SHAPES, each study pooled and compared with both tables of
        ``torch_compare_study.py`` (datasize also with the NUTS table); K1
        and K3 against their plain versions at those shapes. Returns each
        job's record."""
        cat = self._experiments('torch_run_catalog')
        records = self._queue_through(
            run, 'one cut job of each mixed study and datasize\'s NUTS job',
            [*MIXED_SHAPES, QUEUE_NUTS_JOB])
        per_job = {name: self._queue_job_shape(name, records, shape)
                   for name, shape in MIXED_SHAPES.items()
                   if name in records}
        if QUEUE_NUTS_JOB in records:
            per_job[QUEUE_NUTS_JOB] = self._queue_nuts_job(
                records[QUEUE_NUTS_JOB])
        by_key = {j.name: j for j in cat.build_jobs()}
        for study in MIXED_STUDIES:
            proc, table, last = self._compare(
                study, QUEUE_AGGR / f'aggr_{study}.csv')
            jobs = sorted(n for n in [*MIXED_SHAPES, QUEUE_NUTS_JOB]
                          if by_key[n].study == study)
            self.check(proc.returncode == 0 and table is not None
                       and sorted(set(table['experiment_name'])) == jobs
                       and len(table) == 6 * len(jobs)
                       and (table['jax_n'] == 3).all(),
                       f'torch_compare_study.py {study} (exit '
                       f'{proc.returncode}): {jobs} against three JAX '
                       f'seeds on six metrics: {last!r}')
            if QUEUE_NUTS_JOB in jobs:
                self._compare_nuts(study, proc)
        gen = self.torch.Generator().manual_seed(17)
        for shape in sorted(set(MIXED_SHAPES.values())):
            self._k1_check(*shape)
            self._k3_check(*shape, gen)
        return {'jobs': per_job}

    def _queue_nuts_job(self, record: dict) -> dict:
        """The cut NUTS job of ``QUEUE_STAGE``: no K1/K3 launch, and the
        warm start of its provider in the same root reused (its
        ``training.log`` says so, and its config names the provider);
        its entry of the phase's timings."""
        import yaml

        exp = QUEUE_RESULTS / 'datasize' / QUEUE_NUTS_JOB
        provider = QUEUE_RESULTS / 'datasize' / QUEUE_NUTS_PROVIDER
        config = yaml.safe_load((exp / 'config.yaml').read_text())
        log = (exp / 'training.log').read_text()
        reused = (config['training']['warmstart']['warmstart_exp_dir']
                  == str(provider)
                  and f'reusing warmstart checkpoints from '
                  f'{provider / "warmstart"}' in log)
        sampler = config['training']['sampler']
        self.check(record['launches'] == {'isokinetic_momentum': 0,
                                          'partial_refresh': 0}
                   and reused and sampler['name'] == 'nuts'
                   and sampler['max_num_doublings'] == 8,
                   f'{QUEUE_NUTS_JOB} (NUTS, depth '
                   f'{sampler["max_num_doublings"]}, '
                   f'{sampler["warmup_steps"]} + {sampler["n_samples"]} '
                   f'steps): K1/K3 {record["launches"]} (none on NUTS), the '
                   f'warm start of {QUEUE_NUTS_PROVIDER} reused: {reused}, '
                   f'{record["wall_s"]} s')
        return {'wall_s': record['wall_s'], 'reused_warmstart': reused,
                'launches': record['launches']}

    def _compare_nuts(self, study: str, proc):
        """The NUTS table of ``_compare``'s run on ``study``: the NUTS job
        alone, on NUTS_STATS, against three JAX seeds, every value finite,
        and its count line."""
        import numpy as np
        import pandas as pd

        df = pd.read_csv(RESULTS / f'queue_compare_{study}.csv')
        nuts = df[df['table'] == 'nuts']
        lines = proc.stdout.strip().splitlines()
        last = lines[-1] if 'NUTS' in lines else ''
        self.check(nuts['experiment_name'].unique().tolist()
                   == [QUEUE_NUTS_JOB]
                   and nuts['metric'].tolist() == NUTS_STATS
                   and (nuts['jax_n'] == 3).all()
                   and bool(np.isfinite(nuts['port']).all())
                   and re.fullmatch(r'\d of 3 outside their 95 % intervals '
                                    r'\(0\.2 expected by chance.*\)', last)
                   is not None,
                   f'torch_compare_study.py {study}: the NUTS table holds '
                   f'{nuts["experiment_name"].unique().tolist()} on '
                   f'{nuts["metric"].tolist()} (want {NUTS_STATS}), '
                   f'finite: '
                   + ', '.join(f'{r.metric} {r.port:.4g}'
                               for r in nuts.itertuples())
                   + f'; {last!r}')

    def _queue_drill(self, tq) -> list:
        """The loop's fault drill and STOP (``catalog_queue``'s first
        half): the seconds of each of its two runs."""
        import shutil

        root, aggr = QUEUE_DRILL_RESULTS, QUEUE_DRILL_RESULTS / 'aggr'
        shutil.rmtree(root, ignore_errors=True)
        fault_stage = tq.Stage(FAULT_JOB[1], FAULT_JOB[3])
        worker = [sys.executable, str(Path(__file__).resolve()),
                  '--catalog-fault-worker', 'assert', str(root)]
        drill = tq.Queue(root, aggr_dir=aggr, device=self.dev.type,
                         cooloff_s=QUEUE_COOLOFF_S, runner=worker)
        t0 = time.perf_counter()
        rc = drill.run([fault_stage])
        drill_s = time.perf_counter() - t0
        (result,) = drill.results
        strikes = (root / 'FAULTS.jsonl').read_text().splitlines() \
            if (root / 'FAULTS.jsonl').exists() else []
        log = drill.log_path.read_text()
        self.check(rc == 0 and result.exit_codes == [70, 70, 0]
                   and len(strikes) == 2 and 'CUDA error' in log
                   and log.count('cooling off') == 2
                   and result.pooled == aggr / f'aggr_{fault_stage.study}.csv'
                   and result.pooled.exists(),
                   f'the loop over the assert worker: runner exit codes '
                   f'{result.exit_codes} (want 70 70 0: relaunched after '
                   f'each fault, the job skipped at its second strike), '
                   f'{len(strikes)} strikes, pooled into {result.pooled}, '
                   f'{drill_s:.1f} s')
        (root / 'STOP').touch()
        stop = tq.Queue(root, aggr_dir=aggr, device=self.dev.type,
                        cooloff_s=QUEUE_COOLOFF_S, runner=worker)
        t0 = time.perf_counter()
        rc = stop.run([fault_stage, tq.Stage(*QUEUE_STOP_STAGE)])
        stop_s = time.perf_counter() - t0
        codes = [r.exit_codes for r in stop.results]
        pooled = [r.pooled is not None for r in stop.results]
        self.check(rc == 75 and codes == [[0], [75]]
                   and pooled == [True, False]
                   and not (aggr / f'aggr_{QUEUE_STOP_STAGE[0]}.csv').exists()
                   and not (root / 'STOP').exists(),
                   f'a STOP file: the stages exit {codes} (want [0] and '
                   f'[75]), pooled {pooled} (want the first only); the '
                   f'loop exits {rc}, {stop_s:.1f} s')
        if rc != 75 or result.exit_codes != [70, 70, 0]:
            print(textwrap.indent(log[-3000:], '    '))
        return [drill_s, stop_s]

    def preemption(self):
        """A real preemption and ``profile: true`` on the card. A worker
        process (this script with ``--preempt-worker ROOT``) runs
        BDETrainer on the main path's config with checkpoint_sampling and
        is killed with SIGKILL once ``sampler_ckpt/`` holds a chunk; the
        run is resumed here through ``run_mclmc(checkpoint_dir=)`` from the
        worker's warm start and checkpoint, and its draws, ΔE statistics
        and tuned ε and L equal an uninterrupted run's bit for bit, with K1
        and K3 launched 3 and 1 times per step it had left. Then one
        trainer run with ``profile: true``: its ``profile/trace.json``
        parses and names both kernels."""
        import shutil
        import signal

        import numpy as np

        torch = self.torch
        from mile_tpu_torch.config import Config
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.train import sampling
        from mile_tpu_torch.train.checkpoint import load_params_batch
        from mile_tpu_torch.train.trainer import BDETrainer
        from mile_tpu_torch.utils.keys import experiment_keys

        shutil.rmtree(PREEMPT_RESULTS, ignore_errors=True)
        PREEMPT_RESULTS.mkdir(parents=True)
        config = preempt_config(PREEMPT_RESULTS)
        exp, scfg = config.experiment_dir, config.training.sampler
        ckpt_dir = exp / 'sampler_ckpt'
        t0 = time.perf_counter()
        with open(PREEMPT_RESULTS / 'worker.log', 'w') as log:
            proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 '--preempt-worker', str(PREEMPT_RESULTS),
                 self.dev.type],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
            while (proc.poll() is None and not (ckpt_dir /
                                                'chunk_000000.npz').exists()
                   and time.perf_counter() - t0 < PREEMPT_TIMEOUT_S):
                time.sleep(0.002)
            alive = proc.poll() is None
            proc.kill()
            rc = proc.wait(timeout=60)
        killed_s = time.perf_counter() - t0
        chunks = sorted(p.name for p in ckpt_dir.glob('chunk_*.npz'))
        # the count the snapshot holds (the meta file's may be older: the
        # kill can land between the two)
        snapshot = ckpt_dir / 'sampler_state.npz'
        done = None
        if snapshot.exists():
            with np.load(snapshot) as d:
                done = int(d['meta_kept_done'])
        self.check(alive and rc == -signal.SIGKILL and len(chunks) >= 1
                   and done is not None,
                   f'the worker killed with SIGKILL after {killed_s:.1f} s '
                   f'(exit {rc}) with {len(chunks)} chunk(s) on disk, the '
                   f'snapshot at {done} kept draws')
        if not (alive and chunks):
            print(textwrap.indent(
                (PREEMPT_RESULTS / 'worker.log').read_text()[-3000:], '    '))
            return

        bayes, x, y = posterior_of(config, self.dev)
        vg = bayes.logdensity_and_grad_fn(x, y)
        members = torch.from_numpy(load_params_batch(
            exp / 'warmstart', range(scfg.n_chains))).to(self.dev)
        n_chains, dim = members.shape
        chunk_bytes = PREEMPT_CHUNK_KEPT * n_chains * dim * 4
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        resumed = sampling.run_mclmc(
            vg, scfg, experiment_keys(config.rng).sample, members,
            max_chunk_bytes=chunk_bytes, checkpoint_dir=ckpt_dir)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        k1, k3 = self._launches()
        full = sampling.run_mclmc(
            vg, scfg, experiment_keys(config.rng).sample, members,
            max_chunk_bytes=chunk_bytes)
        torch.cuda.synchronize()
        self.path_launches['preemption'] = dict(zip(
            ('isokinetic_momentum', 'partial_refresh'), self._launches()))
        thin = scfg.n_thinning
        left = (math.ceil(scfg.n_samples / thin) - done) * thin
        same = self._equal(resumed, full, [
            ('info', 'energy_change'), ('info', 'energy_change_sq'),
            ('tuned', 'step_size'), ('tuned', 'L')])
        self.check(all(same.values()) and (k1, k3) == (3 * left, left)
                   and resumed.samples.shape == full.samples.shape
                   and not ckpt_dir.exists(),
                   f'resumed from the killed worker\'s checkpoint at '
                   f'({n_chains}, {dim}) in {resume_s:.1f} s: bitwise equal '
                   f'to an uninterrupted run {same}; K1 {k1} (3 x {left} '
                   f'steps left), K3 {k3}; checkpoint removed')

        shutil.rmtree(PROFILE_RESULTS, ignore_errors=True)
        (profile_cfg,) = Config.from_file(CONFIG)
        profile_cfg = profile_cfg.replace(
            saving_dir=str(PROFILE_RESULTS), experiment_name='profile',
            profile=True, **PROFILE_CUT)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = BDETrainer(profile_cfg, device=self.dev.type)
        trainer.train(report=False)
        torch.cuda.synchronize()
        profile_s = time.perf_counter() - t0
        launches = self._launches()
        self.path_launches['profile'] = dict(zip(
            ('isokinetic_momentum', 'partial_refresh'), launches))
        trace_path = trainer.exp_dir / 'profile' / 'trace.json'
        text = trace_path.read_text() if trace_path.exists() else '{}'
        events = json.loads(text).get('traceEvents', [])
        kernels = [e.get('name', '') for e in events
                   if e.get('cat') == 'kernel']
        counts = tuple(sum(name in k for k in kernels)
                       for name in ('isokinetic_momentum', 'partial_refresh'))
        self.check(all(counts) and all(launches),
                   f'profile: true: profile/trace.json '
                   f'({len(text) / 1e6:.1f} MB) parses, {len(events)} '
                   f'events, {len(kernels)} kernels, K1 {counts[0]} '
                   f'and K3 {counts[1]} of them (the wrappers counted '
                   f'{launches[0]} and {launches[1]}), {profile_s:.1f} s')
        self.timings['preemption'] = {
            'killed_after_s': killed_s, 'chunks_on_disk': len(chunks),
            'kept_done': done, 'resume_s': resume_s,
            'profile_s': profile_s, 'profile_kernel_events': counts,
            'profile_launches': launches}

    # -------------------------------------------------------- precision
    def precision(self):
        """The TPU's one bfloat16 pass (``'bfloat16'``): the card's route
        against the CPU's at the models' shapes, forward and gradients; a
        witness of what torch's ``'medium'`` computes on the card; and the
        airfoil trainer cut to ``PRECISION_CUT`` under the TPU setting,
        beside the exact run in turns."""
        from mile_tpu_torch.models import blocks

        route = blocks.one_pass_route(self.dev)
        print(f'  one-pass route on the card: {route} (aten::bmm.dtype '
              f'{"offered" if blocks.OUT_DTYPE_BMM else "absent"} in torch '
              f'{self.torch.__version__})')
        self.timings['precision'] = {'route': route}
        self._one_pass_products()
        self._medium_witness()
        self._tpu_trainer()

    def _one_pass_pair(self, fn, operands, grad_shape, seed):
        """``fn(*operands)`` and its gradients by a seeded cotangent under
        ``'bfloat16'``, on the card and on the CPU: (card, cpu, cotangent),
        each a list [out, *grads] of float64 numpy arrays."""
        import numpy as np

        torch = self.torch
        from mile_tpu_torch.utils.precision import matmul_precision

        g = np.random.default_rng(seed).standard_normal(
            grad_shape).astype(np.float32)
        runs = []
        for device in (self.dev, torch.device('cpu')):
            ts = [torch.from_numpy(a).to(device).requires_grad_()
                  for a in operands]
            with matmul_precision('bfloat16'):
                y = fn(*ts)
                y.backward(torch.from_numpy(g).to(device))
            runs.append([t.detach().cpu().double().numpy()
                         for t in (y, *(t.grad for t in ts))])
        return runs[0], runs[1], g

    def _one_pass_check(self, label, card, cpu, exact, sums, ks):
        """Each of out and gradients: card vs CPU within
        2·K·2⁻²⁴·Σ|a||b| and card vs float64 within K·2⁻²⁴·Σ|a||b| a
        value (both float32 sums of the same exact products, in other
        orders)."""
        import numpy as np

        u = 2.0 ** -24
        worst = {}
        for what, c, p, e, s, k in zip(('out', 'grad a', 'grad b'), card,
                                       cpu, exact, sums, ks):
            d_cpu = float(np.max(np.abs(c - p) - 2 * k * u * s))
            d_exact = float(np.max(np.abs(c - e) - k * u * s))
            err = float(np.max(np.abs(c - p)))
            worst[what] = err
            self.check(d_cpu <= 0 and d_exact <= 0,
                       f'{label} {what}: card vs CPU max|d| {err:.3g} within'
                       f' 2·{k}·2^-24·Σ|a||b|, card vs float64 within '
                       f'{k}·2^-24·Σ|a||b| (excess {max(d_cpu, d_exact):.3g})')
        return worst

    def _one_pass_products(self):
        """The dense products of FCN [16, 16, 2] and [16, 16, 16, 2] (12
        chains, airfoil's 1052 rows) and of the complexity study's [48, 48, 48, 2] (12
        chains, bikesharing's 8515 training rows), LeNet's grouped
        convolution and the text attention's q·kᵀ."""
        import numpy as np
        import torch.nn.functional as F

        torch = self.torch
        from mile_tpu_torch.models import blocks

        def bf16(a):
            return torch.from_numpy(a).bfloat16().double()

        def bmm_exact(a, b, g):
            a16, b16, g16 = bf16(a), bf16(b), bf16(g)
            ab = lambda x, y: torch.bmm(x, y).numpy()
            tr = lambda x: x.transpose(1, 2)
            return ([ab(a16, b16), ab(g16, tr(b16)), ab(tr(a16), g16)],
                    [ab(a16.abs(), b16.abs()), ab(g16.abs(), tr(b16).abs()),
                     ab(tr(a16).abs(), g16.abs())])

        rng = np.random.default_rng(PRECISION_SEED)
        errs = {}
        # airfoil's 5 features and 1052 rows at width 16; bikesharing's 12
        # features and 8515 rows at the complexity study's width 48
        widths = [(1052, 5, 16), (1052, 16, 16), (1052, 16, 2),
                  (8515, 12, 48), (8515, 48, 48), (8515, 48, 2)]
        for i, (rows, k, n) in enumerate(widths):
            a = rng.standard_normal((12, rows, k)).astype(np.float32)
            b = rng.standard_normal((12, k, n)).astype(np.float32)
            card, cpu, g = self._one_pass_pair(
                blocks.product, (a, b), (12, rows, n), PRECISION_SEED + i)
            exact, sums = bmm_exact(a, b, g)
            errs[f'dense ({rows}, {k}, {n})'] = self._one_pass_check(
                f'dense (12, {rows}, {k}) x (12, {k}, {n})', card, cpu,
                exact, sums, (k, n, rows))

        # LeNet's grouped convolution: 10 chains, 64 images of the first
        # convolution's pooled output
        n_img, chains, (c_in, c_out, kk, hw, pad) = 64, 10, LENET_CONV2
        h = rng.standard_normal((n_img, chains * c_in, hw, hw)).astype(
            np.float32)
        w = rng.standard_normal((chains * c_out, c_in, kk, kk)).astype(
            np.float32) / kk
        hw_out = hw + 2 * pad - kk + 1
        conv = lambda x, y: blocks.conv(x, y, None, pad, chains)
        card, cpu, g = self._one_pass_pair(
            conv, (h, w), (n_img, chains * c_out, hw_out, hw_out),
            PRECISION_SEED + 7)
        h16, w16, g16 = bf16(h), bf16(w), bf16(g)

        def conv_all(x, y, z):
            return [F.conv2d(x, y, padding=pad, groups=chains).numpy(),
                    torch.nn.grad.conv2d_input(x.shape, y, z, padding=pad,
                                               groups=chains).numpy(),
                    torch.nn.grad.conv2d_weight(x, y.shape, z, padding=pad,
                                                groups=chains).numpy()]
        exact = conv_all(h16, w16, g16)
        sums = conv_all(h16.abs(), w16.abs(), g16.abs())
        errs['lenet conv'] = self._one_pass_check(
            f'LeNet grouped conv ({n_img}, {chains * c_in}, {hw}, {hw}) * '
            f'({chains * c_out}, {c_in}, {kk}, {kk}), groups {chains}',
            card, cpu, exact, sums,
            (c_in * kk * kk, c_out * kk * kk, n_img * hw_out * hw_out))

        # the text attention's q·kᵀ: 8 chains, 16 sequences, 8 heads of 8,
        # context 70
        c, n, heads, t, hd = 8, 16, 8, 70, 8
        q = rng.standard_normal((c, n, heads, t, hd)).astype(np.float32)
        kt = rng.standard_normal((c, n, heads, hd, t)).astype(np.float32)
        card, cpu, g = self._one_pass_pair(
            blocks.product, (q, kt), (c, n, heads, t, t), PRECISION_SEED + 8)
        flat = lambda a: a.reshape(-1, *a.shape[-2:])
        exact, sums = bmm_exact(flat(q), flat(kt), flat(g))
        shapes = (card[0].shape, q.shape, kt.shape)
        exact = [e.reshape(s) for e, s in zip(exact, shapes)]
        sums = [s_.reshape(s) for s_, s in zip(sums, shapes)]
        errs['attention q·kᵀ'] = self._one_pass_check(
            f'attention q·kᵀ {q.shape} x {kt.shape}', card, cpu, exact, sums,
            (hd, t, t))
        self.timings['precision']['max_abs_card_vs_cpu'] = errs

    def _medium_witness(self):
        """torch's ``'medium'`` (the port's old mapping of ``'bfloat16'``)
        against the one pass: 1 + 2⁻⁹ + 2⁻¹² is exact in float32, 1 + 2⁻⁹
        in TF32 (10 mantissa bits) and 1 in bfloat16 (7)."""
        torch = self.torch
        from mile_tpu_torch.models import blocks
        from mile_tpu_torch.utils.precision import matmul_precision

        v = 1 + 2.0 ** -9 + 2.0 ** -12
        a = torch.full((4, 64, 64), v, device=self.dev)
        eye = torch.eye(64, device=self.dev).expand(4, 64, 64).contiguous()
        names = {v: 'float32', 1 + 2.0 ** -9: 'TF32', 1.0: 'bfloat16'}
        prev = torch.get_float32_matmul_precision()
        try:
            torch.set_float32_matmul_precision('medium')
            medium = torch.bmm(a, eye)
        finally:
            torch.set_float32_matmul_precision(prev)
        with matmul_precision('bfloat16'):
            one_pass = blocks.product(a, eye)
        got = {}
        for key, y in (('medium', medium), ('one_pass', one_pass)):
            vals = set(y.unique().tolist())
            got[key] = names.get(vals.pop(), 'other') if len(vals) == 1 \
                else 'mixed'
        print(f"  torch's 'medium' on the card gave {got['medium']}; the "
              f"port's 'bfloat16' gave {got['one_pass']}")
        self.timings['precision']['medium_gave'] = got['medium']
        self.check(got['medium'] in ('TF32', 'bfloat16')
                   and got['one_pass'] == 'bfloat16',
                   f"witness: 'medium' is {got['medium']} (not exact "
                   f"float32), the one pass rounds to bfloat16 "
                   f"({got['one_pass']})")

    def _tpu_trainer(self):
        """The airfoil trainer cut to ``PRECISION_CUT`` at the port's exact
        default and under the TPU setting (as ``torch_run_catalog.py
        --tpu-arithmetic``), in turns: exact, TPU, TPU, exact. K1/K3
        launches of the TPU runs, the one-pass products counted, the
        recorded setting, chain-steps/s of each run's sampling phase."""
        import shutil

        import yaml

        torch = self.torch
        from mile_tpu_torch.config import Config
        from mile_tpu_torch.models import blocks
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.train.trainer import BDETrainer
        from mile_tpu_torch.utils import precision

        cat = self._experiments('torch_run_catalog')
        (base,) = Config.from_file(CONFIG)
        one_pass = blocks.OnePassProduct.apply
        calls = [0]

        def counted(*args):
            calls[0] += 1
            return one_pass(*args)

        rates = {'exact': [], 'tpu': []}
        launches = {'isokinetic_momentum': 0, 'partial_refresh': 0}
        for i, arm in enumerate(('exact', 'tpu', 'tpu', 'exact')):
            tpu = arm == 'tpu'
            name = f'{PRECISION_RESULTS.name}_{i}_{arm}'
            config = base.replace(
                saving_dir=str(PRECISION_RESULTS.parent),
                experiment_name=name,
                **(cat.TPU_ROWS_WARMUP if tpu else {}), **PRECISION_CUT)
            shutil.rmtree(PRECISION_RESULTS.parent / name,
                          ignore_errors=True)
            calls[0] = 0
            before = precision.none_precision()
            blocks.OnePassProduct.apply = counted
            try:
                if tpu:
                    precision.set_none_precision('bfloat16')
                trainer = BDETrainer(config, device=self.dev)
                ops.reset_launch_counts()
                _, result, metrics, _ = self._train(trainer)
                n_launch = {'isokinetic_momentum':
                            ops.isokinetic_momentum.launches,
                            'partial_refresh': ops.partial_refresh.launches}
            finally:
                blocks.OnePassProduct.apply = one_pass
                precision.set_none_precision(before)
            scfg = config.training.sampler
            steps = mclmc_steps(scfg)
            n_sampled = math.ceil(scfg.n_samples / scfg.n_thinning) \
                * scfg.n_thinning
            rate = scfg.n_chains * n_sampled / result.seconds['sampling']
            rates[arm].append(rate)
            recorded = yaml.safe_load(
                (trainer.exp_dir / 'config.yaml').read_text())
            lppd = float(metrics['lppd'])
            self.check(n_launch == {'isokinetic_momentum': 3 * steps,
                                    'partial_refresh': steps}
                       and (calls[0] > 0) == tpu
                       and recorded.get('none_precision')
                       == ('bfloat16' if tpu else None)
                       and math.isfinite(lppd),
                       f'{arm} run {i}: K1/K3 '
                       f'{n_launch["isokinetic_momentum"]}/'
                       f'{n_launch["partial_refresh"]} (3 and 1 x {steps} '
                       f'steps), {calls[0]} one-pass products, config.yaml '
                       f'none_precision {recorded.get("none_precision")}, '
                       f'lppd {lppd:.4f}, ε '
                       f'{float(result.tuned["step_size"].mean()):.5f}, '
                       f'{rate:.0f} chain-steps/s sampling')
            if tpu:
                for k in launches:
                    launches[k] += n_launch[k]
        self.path_launches['precision'] = launches
        self.timings['precision']['chain_steps_per_s'] = rates
        print(f"  sampling chain-steps/s, exact {rates['exact']}, TPU "
              f"setting {rates['tpu']} (a record: each cast is a launch on "
              f"a host-bound step)")

    def dtype_ab(self):
        """The dtype A/B at W = 512 (AB_SHAPE, the streaming route), its
        four arms in subprocesses: each ok, K1/K3 launched 3 and 1 times
        per MCLMC step, 12 finite step sizes in the float32 arms; then one
        MCLMC step at AB_SHAPE through the kernels against the plain
        versions on the card."""
        torch = self.torch
        ab = self._experiments('torch_dtype_ab_widefcn')
        from mile_tpu_torch.ops import isokinetic as ops

        route = ops.kernel_route(AB_SHAPE[1])
        self.check(route.cluster > 1 and not route.resident,
                   f'dim {AB_SHAPE[1]} takes the streaming cluster route '
                   f'{route}')
        AB_RESULTS.unlink(missing_ok=True)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(AB_SCRIPT), '--out', str(AB_RESULTS),
             '--warmup-steps', str(AB_WARMUP), '--timed-steps',
             str(AB_TIMED), '--device', self.dev.type], cwd=ROOT,
            capture_output=True, text=True, timeout=AB_TIMEOUT_S,
            env=dict(os.environ, MILE_AB_WIDTH=str(AB_WIDTH)))
        wall = time.perf_counter() - t0
        print(textwrap.indent(proc.stdout.strip(), '  '))
        records = ([json.loads(x) for x in AB_RESULTS.read_text()
                    .splitlines()] if AB_RESULTS.exists() else [])
        self.check(proc.returncode == 0 and len(records) == len(ab.ARMS)
                   and not any('verdict' in r for r in records),
                   f'{len(records)} arms recorded, exit {proc.returncode}, '
                   f'{wall:.1f} s')
        if proc.returncode != 0 or any('verdict' in r for r in records):
            print(textwrap.indent(proc.stderr[-3000:], '    '))
            for r in records:
                print(textwrap.indent(r.get('error', '')[-2000:], '    '))
        # the tuner, then a warm block and the timed block
        steps = tuner_steps(AB_WARMUP, False) + 2 * AB_TIMED
        totals = [0, 0]
        for rec in (r for r in records if 'verdict' not in r):
            k1 = rec['launches']['isokinetic_momentum']
            k3 = rec['launches']['partial_refresh']
            totals[0] += k1
            totals[1] += k3
            f32 = rec['arm'].split('_')[0] != 'bf16fwd'
            self.check(rec['dim'] == AB_SHAPE[1] and k1 == 3 * steps
                       and k3 == steps and (not f32 or rec[
                           'finite_eps_chains'] == AB_SHAPE[0]),
                       f'{rec["arm"]}: K1 {k1}, K3 {k3} (3 and 1 x {steps} '
                       f'steps) at ({rec["n_chains"]}, {rec["dim"]}); '
                       f'finite eps in {rec["finite_eps_chains"]} chains; '
                       f'{rec["steps_per_sec"]} chain-steps/s, '
                       f'{rec["model_tflops_per_sec"]} TFLOP/s, '
                       f'{rec["mfu_vs_arm_peak"]} of the '
                       f'{rec["matmul_type"]} peak {rec["peak_tflops"]}; '
                       f'tuner {rec["warmup_wall_s"]} s, eps '
                       f'{rec["eps_mean"]:.3g}, L {rec["L_mean"]:.3g}')
        # launched in the arms' processes, counted there by the wrappers
        self.path_launches['dtype_ab'] = {'isokinetic_momentum': totals[0],
                                          'partial_refresh': totals[1]}
        self.timings['dtype_ab'] = {'wall_s': wall, 'arms': records}
        self._ab_step_check(ab, records)

    def _ab_step_check(self, ab, records):
        """One MCLMC step at AB_SHAPE (the f32strict arm's posterior, its
        tuned mean ε and L) from a random state with injected normals,
        through the kernels and through the plain versions on the card:
        positions within STEP_X_TOL, momenta within STEP_U_ATOL, ΔE within
        64 float32 units of |logp| + |logp'| + |ΔK|."""
        torch = self.torch
        from mile_tpu_torch.mcmc import mclmc
        from mile_tpu_torch.utils.precision import matmul_precision

        bayes, x, y = ab.build(None, self.dev, width=AB_WIDTH)
        vg = bayes.logdensity_and_grad_fn(x, y)
        gen = torch.Generator().manual_seed(37)
        position = (0.02 * torch.randn(*AB_SHAPE, generator=gen)).to(self.dev)
        momentum = torch.randn(*AB_SHAPE, generator=gen)
        momentum = (momentum / momentum.norm(dim=1, keepdim=True)).to(
            self.dev)
        z = torch.randn(*AB_SHAPE, generator=gen).to(self.dev)
        tuned = next((r for r in records if r['arm'].startswith('f32strict')
                      and math.isfinite(r.get('eps_mean', math.nan))
                      and math.isfinite(r.get('L_mean', math.nan))), None)
        self.check(tuned is not None, 'the f32strict arm gave a finite '
                                      'mean eps and L for the step check')
        if tuned is None:
            return
        eps = torch.full((AB_SHAPE[0],), tuned['eps_mean'], device=self.dev)
        L = torch.full((AB_SHAPE[0],), tuned['L_mean'], device=self.dev)
        out = {}
        for kind in ('kernels', 'plain'):
            kernel = mclmc.build_kernel(vg, torch.Generator().manual_seed(0),
                                        noise=iter([z]))
            with contextlib.ExitStack() as stack:
                if kind == 'plain':
                    stack.enter_context(self._plain_ops())
                stack.enter_context(matmul_precision('float32'))
                start = mclmc.init(position, vg, momentum=momentum)
                out[kind] = (start, *kernel(start, L, eps))
        (s0, ks, ki), (_, ps, pi) = out['kernels'], out['plain']
        x_atol, x_rtol = STEP_X_TOL
        dx = float(((ks.position - ps.position).abs()
                    / (x_atol + x_rtol * ps.position.abs())).max())
        du = float((ks.momentum - ps.momentum).abs().max())
        unit = 2.0 ** -23 * (s0.logdensity.abs() + pi.logdensity.abs()
                             + pi.kinetic_change.abs())
        de_units = float(((ki.energy_change - pi.energy_change).abs()
                          / unit).max())
        self.timings['dtype_ab_step_check'] = {
            'x_within_tol': dx, 'max_du': du, 'dE_units': de_units}
        self.check(dx <= 1.0 and du <= STEP_U_ATOL and de_units <= 64.0,
                   f'one MCLMC step {AB_SHAPE} on the streaming route, '
                   f'kernels vs plain versions, same state and normals: '
                   f'positions within {dx:.2f} of atol {x_atol:g} + rtol '
                   f'{x_rtol:g} |x|, max|du| {du:.2e} (atol '
                   f'{STEP_U_ATOL:g}), dE {de_units:.1f} float32 units')

    def nuts_scripts(self):
        """``torch_time_warmup.py`` and ``torch_profile_nuts.py`` on the
        card (NUTS_SCRIPTS' step counts): both exit 0 and print finite
        times."""
        number = r'([0-9.]+(?:e-?[0-9]+)?)'
        patterns = {
            'torch_time_warmup.py': {
                'first_run_s': rf'compile\+run={number}s',
                'run_s': rf'  run={number}s'},
            'torch_profile_nuts.py': {
                'value_and_grad_ms': rf'value_and_grad \(12 chains\): '
                                     rf'{number} ms',
                'leapfrog_ms': rf'leapfrog \(12 chains\): {number} ms',
                'nuts_run_s': rf'chains in {number}s',
                'mean_tree': rf'mean tree size: {number} leapfrogs'}}
        out = {}
        for script, args in NUTS_SCRIPTS.items():
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(ROOT / 'experiments' / script), *args,
                 '--device', self.dev.type], cwd=ROOT, capture_output=True, text=True,
                timeout=NUTS_SCRIPT_TIMEOUT_S)
            wall = time.perf_counter() - t0
            print(textwrap.indent(proc.stdout.strip(), '  '))
            found = {k: re.search(v, proc.stdout)
                     for k, v in patterns[script].items()}
            values = {k: float(m.group(1)) for k, m in found.items() if m}
            ok = (proc.returncode == 0 and len(values) == len(found)
                  and all(math.isfinite(v) and v > 0
                          for v in values.values()))
            if not ok:
                print(textwrap.indent(proc.stderr[-3000:], '    '))
            self.check(ok, f'{script} {" ".join(args)}: exit '
                           f'{proc.returncode}, {values}, {wall:.1f} s')
            out[script] = {**values, 'wall_s': wall}
        self.timings['nuts_scripts'] = out

    # ------------------------------------------------------------ bench
    def bench(self):
        """bench_torch.py's modes in this process at full width with the
        step counts cut (BENCH_*): the headline at 12 and 48 chains, the
        warm start at 12 and 48 members, airfoil and wide-FCN chain
        scaling, the LeNet and wide-FCN bf16 points and the CPU
        denominators, each with finite rates and energies and K1/K3
        launched 3 and 1 times per MCLMC step; the chain-scaling lines read
        back as plot_chain_scaling reads them. Then K1 and K3 against their
        plain versions at BENCH_SHAPES, K3's noise across 1,536 chains, and
        the fault drill with real worker processes."""
        import bench_torch as bench

        torch = self.torch
        from mile_tpu_torch.ops import isokinetic as ops

        BENCH_RESULTS.mkdir(parents=True, exist_ok=True)
        dev = self.dev.type
        totals = [0, 0]
        out = {}

        def drive(key, steps, fn, *args, **kwargs):
            """``fn(*args, **kwargs)`` with the launch counts set to 0 just
            before and read just after, held to 3 and 1 per MCLMC step:
            its result."""
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k1, k3 = self._launches()
            totals[0] += k1
            totals[1] += k3
            out[key] = {'wall_s': wall, 'launches': [k1, k3],
                        'result': result}
            self.check((k1, k3) == (3 * steps, steps),
                       f'{key}: K1/K3 {k1}/{k3} (3 and 1 x {steps} MCLMC '
                       f'steps), {wall:.1f} s')
            return result

        def finite(*values):
            return all(v is not None and math.isfinite(v) and v > 0
                       for v in values)

        cut = BENCH_HEADLINE
        steps = (tuner_steps(cut['warmup_steps'], False)
                 + (1 + cut['n_repeats']) * cut['timed_steps'])
        for n_chains in (bench.N_CHAINS, bench.BEST_PER_CHIP_CHAINS):
            head = drive(f'headline_{n_chains}', steps,
                         bench.measure_throughput, n_chains, device=dev,
                         **cut)
            self.check(finite(head['median'], head['min'], head['max'])
                       and head['energy_change_finite'],
                       f'headline at {n_chains} chains: median '
                       f'{head["median"]:.1f} samples/s, IQR '
                       f'{head["iqr"]:.1f}, min {head["min"]:.1f}, max '
                       f'{head["max"]:.1f}; energies finite: '
                       f'{head["energy_change_finite"]}')
        for n_members in (bench.N_CHAINS, bench.BEST_PER_CHIP_CHAINS):
            ws = drive(f'warmstart_{n_members}', 0, bench.measure_warmstart,
                       n_members, BENCH_WS_EPOCHS, device=dev)
            self.check(finite(ws['member_steps_per_sec'], ws['wall_s'])
                       and ws['params_finite'],
                       f'warm start of {n_members} members, '
                       f'{BENCH_WS_EPOCHS} epochs: '
                       f'{ws["member_steps_per_sec"]} member-steps/s, '
                       f'{ws["wall_s"]} s, members finite')

        for workload, (counts, n_steps) in (('airfoil', BENCH_AIRFOIL),
                                            ('fcn', BENCH_FCN)):
            lines = io.StringIO()
            with contextlib.redirect_stdout(lines):
                records = drive(f'chain_scaling_{workload}',
                                2 * n_steps * len(counts), bench.chain_scaling,
                                workload, counts, n_steps, device=dev)
            path = BENCH_RESULTS / f'scale_{workload}.jsonl'
            path.write_text(lines.getvalue())
            print(textwrap.indent(lines.getvalue().strip(), '  '))
            points, dim = self._chain_scaling_points(path)
            self.check([n for n, _ in points] == counts
                       and dim == (674 if workload == 'airfoil' else
                                   AB_SHAPE[1])
                       and all(finite(r['value'], r['per_chain'])
                               and r['energy_change_finite']
                               for r in records[:-1]),
                       f'{workload} chain scaling: points {points} at dim '
                       f'{dim} read back as plot_chain_scaling reads them, '
                       f'rates and energies finite')
        mfu_steps = 2 * BENCH_MFU_STEPS + 1    # warm, timed, counted
        for key, fn in (('lenet_mfu', bench.lenet_mfu),
                        ('fcn_mfu', bench.fcn_mfu)):
            rec = drive(key, mfu_steps, fn, 'bfloat16',
                        n_steps=BENCH_MFU_STEPS, device=dev)
            print(f'  {json.dumps(rec)}')
            dtypes = rec['matmul_input_dtypes']
            self.check(finite(rec['value'], rec['model_tflops_per_sec'],
                              rec['hw_tflops_per_sec'],
                              rec['mfu_vs_bf16_peak'])
                       and rec['mfu_vs_bf16_peak'] < 1.0
                       and rec['energy_change_finite']
                       and all(v == ['torch.bfloat16']
                               for v in dtypes.values()),
                       f'{key} bf16: {rec["value"]} steps/s, '
                       f'{rec["model_tflops_per_sec"]} model TFLOP/s, '
                       f'{rec["mfu_vs_bf16_peak"]} of the BF16 peak, '
                       f'{rec["hw_tflops_per_sec"]} counted; bf16 inputs '
                       f'to every convolution and product: {dtypes}')
        reference = drive('reference_style_baseline', 0,
                          bench.reference_style_baseline, BENCH_CPU_STEPS,
                          device='cpu')
        own = drive('own_path_baseline', 0, bench.own_path_baseline,
                    BENCH_CPU_STEPS, device='cpu')
        self.check(finite(reference['value'], own['value'])
                   and reference['callbacks_received']
                   == bench.N_CHAINS * BENCH_CPU_STEPS,
                   f'CPU denominators: reference style '
                   f'{reference["value"]} samples/s '
                   f'({reference["callbacks_received"]} callbacks), own '
                   f'path {own["value"]}')
        # launched while driving the modes above, not by the checks below
        self.path_launches['bench'] = dict(zip(
            ('isokinetic_momentum', 'partial_refresh'), totals))

        gen = torch.Generator().manual_seed(43)
        for n_chains, dim in BENCH_SHAPES:
            self._k1_check(n_chains, dim)
            self._k3_check(n_chains, dim, gen)
        out['philox_1536'] = self._k3_many_chains(BENCH_SHAPES[3])
        out['drill'] = self._bench_drills(bench)
        self.timings['bench'] = out

    def _chain_scaling_points(self, path: Path):
        """(points, dim) of chain-scaling lines: through
        ``plot_chain_scaling.load_points`` where matplotlib is installed
        (it imports it), else by reading the same keys."""
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            records = [json.loads(line) for line in
                       path.read_text().splitlines() if line.startswith('{')]
            return (sorted((r['n_chains'], r['value']) for r in records
                           if 'n_chains' in r),
                    next(r['dim'] for r in records
                         if r['metric'].endswith('_summary')))
        return self._experiments('plot_chain_scaling').load_points(path)

    def _k3_many_chains(self, shape) -> dict:
        """K3 at ``shape`` (1,536 chains) with a device step counter,
        launched PHILOX_CHAINS_STEPS times at eps/L = 5 (nu^2 dim = e^10 -
        1, so u' is z/|z| to 0.7 %): the counter advances exactly once a
        launch with its ticket bits back to 0, the first and last launch
        equal the eager calls at their steps, and the largest correlation
        between two chains' noise over all launches is at the level chance
        gives (under 7 standard deviations of a correlation of that many
        pairs)."""
        torch = self.torch
        from mile_tpu_torch.ops import isokinetic as ops

        n_chains, dim = shape
        gen = torch.Generator().manual_seed(47)
        u = torch.randn(n_chains, dim, generator=gen)
        u = (u / u.norm(dim=1, keepdim=True)).to(self.dev)
        eps = torch.full((n_chains,), 5.0, device=self.dev)
        L = torch.ones(n_chains, device=self.dev)
        counter = ops.step_counter(0, self.dev)
        n = PHILOX_CHAINS_STEPS
        outs = torch.empty(n, n_chains, dim, device=self.dev)
        for i in range(n):
            outs[i] = ops.partial_refresh(u, eps, L, 23, counter)
        step, ticket = ops.counter_step(counter), int(counter) & 0xFFFFFF
        same = (torch.equal(outs[0], ops.partial_refresh(u, eps, L, 23, 0))
                and torch.equal(outs[-1],
                                ops.partial_refresh(u, eps, L, 23, n - 1)))
        z = outs.permute(1, 0, 2).reshape(n_chains, -1)
        z = z - z.mean(dim=1, keepdim=True)
        z = z / z.norm(dim=1, keepdim=True)
        corr = z @ z.T
        corr.fill_diagonal_(0.0)
        max_corr = float(corr.abs().max())
        limit = 7.0 / math.sqrt(n * dim)
        self.check(step == n and ticket == 0 and same and max_corr < limit,
                   f'K3 {shape} with a device counter, {n} launches: '
                   f'counter at step {step} (want {n}), ticket bits '
                   f'{ticket}, first and last equal the eager calls: '
                   f'{same}, largest |corr| between two chains\' noise '
                   f'{max_corr:.4f} (< {limit:.4f}, 7 sd of chance)')
        return {'max_abs_corr': max_corr, 'limit': limit, 'steps': step}

    def _bench_drill(self, bench, fn: str, marker: Path) -> tuple:
        """bench_torch.headline with its 12-chain measurement run by
        ``fn`` of this script in real worker processes (each call counted
        in ``marker``), every other measurement stubbed, no cool-off:
        (exit code, stdout, stderr, workers started)."""
        stand_in = {'median': 1.0, 'iqr': 0.0, 'min': 1.0, 'max': 1.0,
                    'n_repeats': 1}
        names = ('_measure_throughput', '_measure_warmstart',
                 'reference_style_baseline', 'own_path_baseline',
                 'BENCH_COOLOFF_S')
        saved = {name: getattr(bench, name) for name in names}
        marker.unlink(missing_ok=True)
        bench._measure_throughput = lambda n, device: (
            bench.run_worker(f'chip_smoke:{fn}', {'marker': str(marker),
                                                  'device': device})
            if n == bench.N_CHAINS else stand_in)
        bench._measure_warmstart = lambda n, device: {
            'member_steps_per_sec': 1.0, 'epochs_per_sec': 1.0,
            'wall_s': 1.0}
        bench.reference_style_baseline = bench.own_path_baseline = \
            lambda *args, **kwargs: {'value': 1.0}
        bench.BENCH_COOLOFF_S = 0.0
        stdout, stderr = io.StringIO(), io.StringIO()
        try:
            with contextlib.redirect_stdout(stdout), \
                    contextlib.redirect_stderr(stderr):
                rc = bench.headline(self.dev.type)
        finally:
            for name, value in saved.items():
                setattr(bench, name, value)
        return (rc, stdout.getvalue(), stderr.getvalue(),
                int(marker.read_text()))

    def _bench_drills(self, bench) -> dict:
        """The headline's fault contract with real workers: a worker that
        hits a real device-side assert on its first attempt is a fault,
        the retry in a fresh worker succeeds, and exactly one JSON line
        comes out; a worker out of memory is not retried, and the one
        JSON line carries the error, exit 1."""
        drills = {}
        for name, fn in (('fault', 'bench_fault_drill'),
                         ('oom', 'bench_oom_drill')):
            t0 = time.perf_counter()
            rc, stdout, stderr, workers = self._bench_drill(
                bench, fn, BENCH_RESULTS / f'{name}_attempts')
            lines = [json.loads(line) for line in stdout.splitlines()
                     if line.startswith('{')]
            retried = 'headline-12 attempt 1/' in stderr
            drills[name] = {'rc': rc, 'workers': workers, 'lines': lines,
                            'wall_s': time.perf_counter() - t0}
            if name == 'fault':
                ok = (rc == 0 and workers == 2 and retried
                      and 'device-side assert' in stderr
                      and len(lines) == 1 and lines[0]['value'] == 1.0)
            else:
                ok = (rc == 1 and workers == 1 and not retried
                      and len(lines) == 1 and lines[0]['value'] is None
                      and 'out of memory' in lines[0].get('error', ''))
            if not ok:
                print(textwrap.indent(stderr[-3000:], '    '))
            self.check(ok, f'bench drill {name}: exit {rc}, {workers} '
                           f'worker(s), retried: {retried}, '
                           f'{len(lines)} JSON line(s): '
                           f'{json.dumps(lines)[:200]}')
        return drills

    # ---------------------------------------------------------- timings
    def _time_ms(self, fn, n: int = 500, reps: int = 5,
                 warm: int = 20) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / n)
        return statistics.median(out)

    def _graph_ms(self, fn, n: int = 200) -> float | None:
        """Device time per call with the launches replayed from a CUDA
        graph, so that host launch cost is out of the measurement."""
        torch = self.torch
        try:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                for _ in range(3):
                    fn()
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(n):
                    fn()
            # the capture ran each call once: two replays warm the graph
            return self._time_ms(graph.replay, n=5, reps=5, warm=2) / n
        except Exception as exc:   # reported, not fatal: an extra column
            print(f'  graph timing unavailable: {exc!r}')
            return None

    def kernel_timings(self):
        """The main path's calls of K1 (drift and dK sum fused in) and K3
        (device step counter, dE and its sums fused in) and the plain calls
        without them, eagerly and replayed from a CUDA graph, with their
        plain versions and bounds, at each of TIMED_SHAPES (C = 1 is the
        K2/K4 case)."""
        torch = self.torch
        from mile_tpu_torch.ops import isokinetic as ops
        from mile_tpu_torch.utils.card import HBM_BYTES_PER_S, PEAK_FLOPS

        b1 = 0.1931833275037836
        for n_chains, dim in TIMED_SHAPES:
            # calls a timed window: a fifth past 2M elements, where a call
            # takes 0.04-1.2 ms (the windows stay over 4 ms)
            calls = 500 if n_chains * dim <= 2_000_000 else 100
            gen = torch.Generator().manual_seed(9)
            u = torch.randn(n_chains, dim, generator=gen)
            u = (u / u.norm(dim=1, keepdim=True)).to(self.dev)
            g, x, z = (torch.randn(n_chains, dim, generator=gen).to(self.dev)
                       for _ in range(3))
            eps = torch.full((n_chains,), 0.05, device=self.dev)
            L = torch.full((n_chains,), 1.5, device=self.dev)
            scalars = [torch.randn(n_chains, generator=gen).to(self.dev)
                       for _ in range(3)]
            kinetic, total, total_sq = (torch.zeros(n_chains, device=self.dev)
                                        for _ in range(3))
            counter = ops.step_counter(0, self.dev)
            elems = n_chains * dim
            # the main path has no preconditioner
            k1_bytes, k3_bytes = kernel_bytes(n_chains, dim)
            cases = {
                'isokinetic_momentum': (
                    lambda: ops.isokinetic_momentum(
                        u, g, eps, None, b1, x=x, x_frac=0.5,
                        kinetic=kinetic),
                    lambda: ops.isokinetic_momentum_plain(
                        u, g, eps, None, b1, x=x, x_frac=0.5,
                        kinetic=kinetic),
                    k1_bytes, K1_OPS_PER_ELEM * elems),
                'partial_refresh': (
                    lambda: ops.partial_refresh(
                        u, eps, L, 1, counter,
                        energy=scalars, energy_sums=(total, total_sq)),
                    lambda: ops.partial_refresh_plain(
                        u, eps, L, z, energy=scalars,
                        energy_sums=(total, total_sq)),
                    k3_bytes, K3_OPS_PER_ELEM * elems),
                # the calls without the fused options
                'isokinetic_momentum, unfused': (
                    lambda: ops.isokinetic_momentum(u, g, eps, None, b1),
                    None, 4 * (3 * elems + 2 * n_chains), None),
                'partial_refresh, unfused': (
                    lambda: ops.partial_refresh(u, eps, L, seed=1, counter=2),
                    None, 4 * (2 * elems + 2 * n_chains), None),
            }
            for name, (kernel, plain, nbytes, nops) in cases.items():
                t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
                t_ops = 1e3 * (nops or 0) / PEAK_FLOPS['float32']
                row = {'ms': self._time_ms(kernel, n=calls),
                       'graph_ms': self._graph_ms(kernel, n=calls * 2 // 5),
                       'bound_ms': max(t_bytes, t_ops),
                       'bound_by': 'bytes' if t_bytes >= t_ops
                       else 'operations',
                       'bytes': nbytes, 'operations': nops}
                if plain is not None:   # 0.3-1.2 ms a call, 10-20 kernels
                    row.update(plain_ms=self._time_ms(plain, n=calls // 5),
                               plain_graph_ms=self._graph_ms(
                                   plain, n=calls // 10))
                key = f'{name} ({n_chains}, {dim})'
                self.timings[key] = row
                print(f'  {key} {json.dumps(row)}')


def posterior_of(config, device):
    """(bayes, x, y): the posterior of ``config`` and its training split on
    ``device``, built as the trainer builds them."""
    from mile_tpu_torch.bayes import BayesianModel
    from mile_tpu_torch.data import build_loader
    from mile_tpu_torch.utils.keys import experiment_keys

    scfg = config.training.sampler
    loader = build_loader(config.data, experiment_keys(config.rng).loader,
                          device, target_len=config.data.target_len,
                          tokenizer_config=config.training.tokenizer)
    bayes = BayesianModel(
        config.get_model(loader.input_shape), scfg.prior_config.build(),
        config.data.task, likelihood_chunk_size=scfg.likelihood_chunk_size,
        compute_dtype=scfg.compute_dtype)
    x, y = loader.arrays('train')
    return bayes, x, y


def airfoil_posterior(device):
    """The main path's posterior (airfoil, FCN [16, 16, 16, 2], the config's
    data split) on ``device``, built as the trainer builds it, and the
    sampler config at CUT and MESH_RUN_CUT: (bayes, x, y, sampler config).
    """
    from mile_tpu_torch.config import Config

    (config,) = Config.from_file(CONFIG)
    config = config.replace(**{**CUT, **MESH_RUN_CUT})
    return (*posterior_of(config, device), config.training.sampler)


def preempt_config(root: Path):
    """The main path's config at PREEMPT_CUT, its experiment ``preempt``
    under ``root``."""
    from mile_tpu_torch.config import Config

    (config,) = Config.from_file(CONFIG)
    return config.replace(saving_dir=str(root), experiment_name='preempt',
                          **PREEMPT_CUT)


def multiprocess_run(bayes, x, y, scfg, members, mesh):
    """run_mclmc of the multi-process phase over ``mesh``."""
    import torch

    from mile_tpu_torch.train.sampling import run_mclmc

    return run_mclmc(bayes.logdensity_and_grad_fn(x, y, mesh), scfg,
                     torch.Generator().manual_seed(MP_SEED), members,
                     mesh=mesh)


def multiprocess_warmstart_config(name: str):
    """The main path's config with the warm start cut to MP_WS_EPOCHS
    epochs, its experiment ``name`` under MP_RESULTS."""
    from mile_tpu_torch.config import Config

    (config,) = Config.from_file(CONFIG)
    return config.replace(
        saving_dir=str(MP_RESULTS), experiment_name=name,
        **{**CUT, 'training.warmstart.max_epochs': MP_WS_EPOCHS})


def multiprocess_worker(rank: int, port: int) -> int:
    """One rank of the multi-process phase: join the gloo group of 2 at
    ``localhost:port``, run :func:`multiprocess_run` over a chain mesh of
    cuda:0 twice on each rank, try the in-step check on arrays that differ
    by rank, write and read the members through torch.distributed.
    checkpoint with the other rank, warm start
    :func:`multiprocess_warmstart_config` through BDETrainer over both
    ranks; rank 0 writes what it got."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from mile_tpu_torch.ops import isokinetic as ops
    from mile_tpu_torch.parallel import distributed
    from mile_tpu_torch.parallel.mesh import chain_mesh
    from mile_tpu_torch.train.checkpoint_orbax import (
        load_ensemble,
        save_ensemble,
    )
    from mile_tpu_torch.train.trainer import BDETrainer

    distributed.initialize_distributed(f'localhost:{port}', 2, rank)
    group = distributed.process_group()
    card = torch.device('cuda', torch.cuda.current_device())
    bayes, x, y, scfg = airfoil_posterior(card)
    members = torch.from_numpy(np.load(MP_RESULTS / 'members.npy')).to(card)
    mesh = chain_mesh(devices=[card] * 2, group=group)
    ops.reset_launch_counts()
    result = multiprocess_run(bayes, x, y, scfg, members, mesh)
    torch.cuda.synchronize()
    launches = (ops.isokinetic_momentum.launches, ops.partial_refresh.launches)
    try:
        distributed.check_in_step(np.full(3, rank), group)
        guard_raised = False
    except RuntimeError as exc:
        guard_raised = 'out of step' in str(exc)
    save_ensemble(MP_RESULTS / 'dcp', {'members': members})
    restored = load_ensemble(MP_RESULTS / 'dcp')['members']
    trainer = BDETrainer(multiprocess_warmstart_config('warmstart'),
                         devices=[card] * 2)
    t0 = time.perf_counter()
    warm = trainer.train_warmstart()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if rank == 0:
        np.savez(MP_RESULTS / 'rank0.npz', samples=result.samples,
                 restored=restored.numpy(), launches=np.array(launches),
                 guard_raised=guard_raised, mesh_size=mesh.size,
                 warm=warm.cpu().numpy(), warm_s=warm_s,
                 warm_mesh_size=trainer.mesh.size)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f'rank {rank} ok', flush=True)
    return 0


def _count_call(marker: str) -> int:
    """One more call counted in the file ``marker``: the count."""
    path = Path(marker)
    n = int(path.read_text()) + 1 if path.exists() else 1
    path.write_text(str(n))
    return n


def bench_fault_drill(marker: str, device: str = 'cuda') -> dict:
    """A measurement for bench_torch's workers (the fault drill): its first
    call indexes out of range on the card, a device-side assert; later
    calls return a stand-in headline result."""
    import torch

    n = _count_call(marker)
    if n == 1:
        values = torch.zeros(4, device=device)
        index = torch.full((1,), 1 << 20, dtype=torch.long, device=device)
        values[index].sum().item()
        raise AssertionError('indexing out of range did not fault')
    return {'median': 1.0, 'iqr': 0.0, 'min': 1.0, 'max': 1.0,
            'n_repeats': 1, 'calls': n}


def bench_oom_drill(marker: str, device: str = 'cuda') -> dict:
    """A measurement for bench_torch's workers that asks the card for 1 PiB:
    out of memory, which is no fault."""
    import torch

    _count_call(marker)
    torch.empty(1 << 50, dtype=torch.uint8, device=device)
    raise AssertionError('allocating 1 PiB did not fail')


def catalog_fault_worker(mode: str, root: str, extra=()) -> int:
    """The catalogue runner over ``root`` on FAULT_JOB, with its trainer
    replaced by one whose job indexes out of range on the card (a
    device-side assert; ``mode`` 'assert') or sleeps past the job timeout
    (``mode`` 'hang'). Returns the runner's exit code."""
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / 'experiments'))
    import torch_run_catalog as cat

    from mile_tpu_torch.train import trainer as trainer_mod

    class Faulting:
        def __init__(self, config, device='cuda'):
            self.device = torch.device(device)

        def train(self, report=True):
            if mode == 'hang':
                time.sleep(10 * FAULT_HANG_TIMEOUT_S)
            values = torch.zeros(4, device=self.device)
            index = torch.full((1,), 1 << 20, dtype=torch.long,
                               device=self.device)
            values[index].sum().item()
            raise AssertionError('indexing out of range did not fault')

    trainer_mod.BDETrainer = Faulting
    timeout = FAULT_HANG_TIMEOUT_S if mode == 'hang' else \
        FAULT_WORKER_TIMEOUT_S
    # a relaunch loop appends its own --root, --only, --name-filter,
    # --job-timeout and --device, which take the place of these
    return cat.main(['--root', root, *FAULT_JOB, '--job-timeout',
                     str(timeout), *extra])


def catalog_cut_worker(argv: list) -> int:
    """The catalogue runner with ``argv``, every job's step counts cut to
    CATALOG_CUT, a NUTS job's to CATALOG_NUTS_CUT (the runner of the
    catalog_queue phase's stage). Returns the runner's exit code."""
    import dataclasses

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / 'experiments'))
    import torch_run_catalog as cat

    every_job = cat.build_jobs
    cat.build_jobs = lambda: [
        dataclasses.replace(j, overrides={
            **j.overrides,
            **(CATALOG_NUTS_CUT if '_nuts_' in j.name else CATALOG_CUT)})
        for j in every_job()]
    return cat.main(argv)


def preempt_worker(root: str, device: str = 'cuda') -> int:
    """BDETrainer on :func:`preempt_config` under ``root`` on ``device``,
    its sampling in chunks of PREEMPT_CHUNK_KEPT kept draws, until the
    parent kills it. Returns 0 if it was not killed."""
    sys.path.insert(0, str(ROOT))
    from mile_tpu_torch.train import sampling
    from mile_tpu_torch.train.trainer import BDETrainer

    config = preempt_config(Path(root))
    run_mclmc = sampling.run_mclmc

    def chunked(vg, cfg, generator, positions, **kwargs):
        kwargs['max_chunk_bytes'] = PREEMPT_CHUNK_KEPT * positions.numel() * 4
        return run_mclmc(vg, cfg, generator, positions, **kwargs)

    sampling.run_mclmc = chunked
    BDETrainer(config, device=device).train(report=False)
    print('preempt worker: the run ended before it was killed', flush=True)
    return 0


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        fail(f'PyTorch is not importable: {exc}')
    if not torch.cuda.is_available():
        fail('no CUDA device: this script only runs on the GPU')
    if not (ROOT / 'mile_tpu_torch' / 'csrc').is_dir() or not CONFIG.exists():
        fail(f'the repository is not around this script ({ROOT})')
    sys.path.insert(0, str(ROOT))
    import mile_tpu_torch

    if Path(mile_tpu_torch.__file__).resolve().parents[1] != ROOT:
        fail(f'imported mile_tpu_torch from {mile_tpu_torch.__file__}, '
             f'not from {ROOT}')
    if any(m == 'jax' or m.startswith(('jax.', 'mile_tpu.'))
           or m == 'mile_tpu' for m in sys.modules):
        fail('JAX or the JAX package was imported')

    from mile_tpu_torch.utils.card import card_line

    t_start = time.perf_counter()
    smoke = Smoke(torch)
    card = card_line()
    print(card, flush=True)
    if smoke.phase('build (nvcc, sm_90a)', smoke.build):
        smoke.phase('K1 isokinetic_momentum vs plain', smoke.k1)
        smoke.phase('K3 partial_refresh vs plain, Philox statistics',
                    smoke.k3)
        if smoke.phase('main path: BDETrainer on airfoil, 12 chains, dim '
                       '674', smoke.main_path):
            if smoke.phase('MCLMC resume: run_mclmc stopped and resumed on '
                           'the main path\'s posterior, 12 chains, dim 674',
                           smoke.mclmc_resume):
                smoke.phase('orbax format: the resume snapshot and the warm '
                            'start through torch.distributed.checkpoint',
                            smoke.orbax_format)
            smoke.phase('mesh: 13 chains over cuda:0 twice, the warm start '
                        'over 2 entries, run_mclmc over 4 and 2 x 2 entries, '
                        '12 chains, dim 674', smoke.mesh_path)
            smoke.phase('multi-process: 2 ranks over gloo on cuda:0, the '
                        'warm start and run_mclmc, 12 chains, dim 674',
                        smoke.multiprocess)
        smoke.phase('stream_samples and warmstart_exp_dir: BDETrainer on '
                    'airfoil, 12 chains, dim 674', smoke.stream_and_reuse)
        smoke.phase('partition path: BDETrainer on energy PartitionFCN, 12 '
                    'chains, dim 2,082, subspace 178', smoke.partition_path)
        if smoke.phase('image path: BDETrainer on LeNet, 10 chains, dim '
                       '61,706', smoke.image_path):
            smoke.phase('image gradient on a mesh: LeNet, 10 chains, dim '
                        '61,706, over cuda:0 twice', smoke.image_mesh_gradient)
        smoke.phase('text path: BDETrainer on AttentionClassifier, 8 chains, '
                    'dim 65,248', smoke.text_path)
        if smoke.phase('NUTS path: BDETrainer on airfoil NUTS, 12 chains, '
                       'dim 674, depth 10', smoke.nuts_path):
            smoke.phase('NUTS resume: depth 5, stopped after chunk 1 of 3 '
                        'and resumed', smoke.nuts_resume)
            smoke.phase('HMC: a short run on the same posterior',
                        smoke.hmc_run)
        smoke.phase('split HMC: torch_symmetric_splitting.py on LeNet, dim '
                    '61,706, 49 shards of 64', smoke.split_hmc)
        smoke.phase(f'catalogue: torch_run_catalog.run_queue over '
                    f'{len(CATALOG_JOBS)} jobs at full width', smoke.catalog)
        smoke.phase('catalogue faults: a device-side assert in worker '
                    'processes, strikes, skip, hang', smoke.catalog_fault)
        smoke.phase('study queue: torch_catalog_queue.py relaunching a '
                    'device-side assert, STOP; the dataset study\'s six r1 '
                    'jobs cut, pooled and compared; K1/K3 at their shapes; '
                    'sonar compared through the classification metrics; '
                    'feasibility\'s energy pair cut, compared value by '
                    'value', smoke.catalog_queue)
        smoke.phase('preemption: BDETrainer with checkpoint_sampling killed '
                    'with SIGKILL and resumed bit for bit; profile: true',
                    smoke.preemption)
        smoke.phase('precision: the one bfloat16 pass on the card vs the '
                    'CPU at the models\' shapes, forward and gradients; '
                    '\'medium\' witness; airfoil under the TPU setting',
                    smoke.precision)
        smoke.phase('dtype A/B: torch_dtype_ab_widefcn.py, FCN [512 x 3, 2],'
                    ' 12 chains, dim 592,386, the streaming route',
                    smoke.dtype_ab)
        smoke.phase('NUTS scripts: torch_time_warmup.py and '
                    'torch_profile_nuts.py on bikesharing',
                    smoke.nuts_scripts)
        smoke.phase('bench: bench_torch.py\'s modes at full width, step '
                    'counts cut; K1/K3 at the new shapes; the fault drill',
                    smoke.bench)
        smoke.phase('timings at ' + ', '.join(
            f'({c}, {d})' for c, d in TIMED_SHAPES), smoke.kernel_timings)
    if any(m == 'jax' or m.startswith(('jax.', 'mile_tpu.'))
           or m == 'mile_tpu' for m in sys.modules):
        smoke.failures.append('JAX or the JAX package was imported')

    timings = smoke.timings
    print(json.dumps({'timings': timings, 'card': card,
                      'phase_s': smoke.phase_s,
                      'wall_s': time.perf_counter() - t_start}))
    kernels = []
    for name, source_fn, replaces, err in (
            ('isokinetic_momentum', 'isokinetic_momentum_kernel',
             'mile_tpu/ops/isokinetic.py:121 (_batched_momentum_kernel, '
             'pallas_call :154); :72 (_momentum_kernel) with C = 1',
             smoke.k1_err),
            ('partial_refresh', 'partial_refresh_kernel',
             'mile_tpu/ops/isokinetic.py:314 (_batched_refresh_kernel, '
             'pallas_call :342); :266 (_refresh_kernel) with C = 1',
             smoke.k3_err)):
        t = timings.get(f'{name} {MAIN_SHAPE}', {})
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'mile_tpu_torch/csrc/isokinetic.cu ({source_fn})',
            'replaces': replaces,
            # the airfoil, partition, image and text paths, the MCLMC
            # resume phase, the streaming trainer, the mesh, the
            # multi-process phase's one-process run, the orbax resume, the
            # catalogue's MCLMC jobs, the dtype A/B's arms and the study
            # queue's dataset jobs (both counted in their processes), the
            # bench, the resumed preemption, the profiled trainer and the
            # precision phase's runs under the TPU setting
            'launches': smoke.launches.get(name, 0) + sum(
                path.get(name, 0) for path in smoke.path_launches.values()),
            'max_abs_err': err,
            'ms': t.get('ms'), 'plain_ms': t.get('plain_ms'),
            'bound_ms': t.get('bound_ms'), 'bound_by': t.get('bound_by'),
            # no single PyTorch call computes either op
            'library_ms': None})
    print(json.dumps({'kernels': kernels}))
    if smoke.failures:
        print('chip_smoke: FAILED: ' + '; '.join(smoke.failures),
              file=sys.stderr)
        return 1
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--multiprocess-worker']:
        sys.exit(multiprocess_worker(int(sys.argv[2]), int(sys.argv[3])))
    if sys.argv[1:2] == ['--catalog-fault-worker']:
        sys.exit(catalog_fault_worker(sys.argv[2], sys.argv[3],
                                      sys.argv[4:]))
    if sys.argv[1:2] == ['--catalog-cut-worker']:
        sys.exit(catalog_cut_worker(sys.argv[2:]))
    if sys.argv[1:2] == ['--preempt-worker']:
        sys.exit(preempt_worker(*sys.argv[2:4]))
    sys.exit(main())
