"""Mid-chain sampler checkpoint and resume (counterpart of
``mile_tpu/train/resume.py``).

The chunked egress of the sampling runtimes doubles as a checkpoint
boundary: after every drained chunk the directory atomically receives

- the sampler state as of the end of that chunk (position, momentum for
  MCLMC, log-density, gradient),
- the random state as of the same moment, and the tuned hyperparameters,
- the kept-draw counter and the drained chunks themselves,

so that a run that was stopped resumes where it stopped, skips the warmup,
and gives draws bit-identical to an uninterrupted run.

The file names and formats are the JAX package's, with two differences.
Where the JAX snapshot stores the chains' threefry keys (``key_data``),
the port stores its own random state as ``rng_*`` entries:

- MCLMC: the refresh kernel's run seed and its step counter's step
  (``rng_seed``, ``rng_step``), which key the refresh noise on the card
  (Philox in K3) and on the CPU (``refresh_noise_cpu``);
- NUTS and HMC: the sampling ``Draws`` generator's ``get_state()``
  (``rng_generator_state``), put back with ``set_state`` on a generator of
  the chains' device.

And the snapshot holds its own kept-draw count (``meta_kept_done``), which
is what a resume reads: the snapshot and ``sampler_meta.json`` are two
files, each replaced atomically but not both at once, so a run killed
between the two (a SIGKILL can land there) would otherwise resume the new
state at the old count. A resume loads only the chunks that count covers:
a run killed between a chunk and the snapshot after it leaves one chunk
more. (The JAX package reads the count from the meta file and loads every
chunk file, so a kill in either window gives its resumed run wrong draws.)

With ``fmt='orbax'`` the snapshot (state, random state and tuned values)
goes through :mod:`mile_tpu_torch.train.checkpoint_orbax` into
``sampler_state_orbax/step_0/``, as the JAX package routes it through
orbax; the drained chunks stay npz in both formats.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

_SNAPSHOT = 'sampler_state.npz'
_SNAPSHOT_ORBAX = 'sampler_state_orbax'
_META = 'sampler_meta.json'
_WARMUP_TRACE = 'warmup_trace.npy'


def generator_digest(generator: torch.Generator) -> str:
    """A digest of a generator's state: the fingerprint's stand-in for the
    JAX run key, so that a run resumes only from a checkpoint made with the
    same random stream."""
    return hashlib.sha256(generator.get_state().numpy().tobytes()).hexdigest()


class SamplerCheckpoint:
    """Atomic snapshot and drained-chunk store under one directory.

    Every write goes to a ``.tmp`` file (or directory) first and is moved
    over the target. ``fmt``: ``'npz'`` or ``'orbax'`` (the snapshot as a
    ``torch.distributed.checkpoint``). ``writer=False`` (the ranks other
    than 0 of a multi-process run) makes every write a no-op: the ranks
    share the directory, and rank 0 writes it."""

    def __init__(self, directory: str | Path, fingerprint: dict,
                 fmt: str = 'npz', writer: bool = True):
        if fmt not in ('npz', 'orbax'):
            raise ValueError(f"checkpoint format must be 'npz' or 'orbax', "
                             f'got {fmt!r}')
        self.dir = Path(directory)
        self.fmt, self.writer = fmt, writer
        if writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        # every value that decides the draws is in the fingerprint: a
        # checkpoint made under other settings is ignored
        self.fingerprint = {k: (v.tolist() if isinstance(v, np.ndarray)
                                else v) for k, v in fingerprint.items()}

    def _write(self, name: str, write) -> None:
        if not self.writer:
            return
        tmp = self.dir / (name + '.tmp')
        with open(tmp, 'wb') as f:
            write(f)
        os.replace(tmp, self.dir / name)

    # ------------------------------------------------------------- save
    def save(self, state_leaves: dict, rng: dict, tuned: dict,
             kept_done: int) -> None:
        """Atomically overwrite the snapshot, with its kept-draw count,
        then the meta file."""
        parts = {'state': state_leaves, 'rng': rng, 'tuned': tuned,
                 'meta': {'kept_done': np.int64(kept_done)}}
        if self.fmt == 'orbax':
            if self.writer:
                from mile_tpu_torch.train.checkpoint_orbax import save_ensemble

                save_ensemble(self.dir / _SNAPSHOT_ORBAX, {
                    part: {k: np.asarray(v) for k, v in leaves.items()}
                    for part, leaves in parts.items()}, step=0,
                    collective=False)
        else:
            arrays = {f'{part}_{k}': np.asarray(v)
                      for part, leaves in parts.items()
                      for k, v in leaves.items()}
            self._write(_SNAPSHOT, lambda f: np.savez(f, **arrays))
        meta = {'fingerprint': self.fingerprint, 'kept_done': int(kept_done)}
        self._write(_META, lambda f: f.write(json.dumps(meta).encode()))

    def save_warmup_trace(self, trace: np.ndarray) -> None:
        """The thinned warmup trajectory, so that a resumed run returns the
        same ``warmup_trace`` as an uninterrupted one."""
        self._write(_WARMUP_TRACE, lambda f: np.save(f, np.asarray(trace)))

    def load_warmup_trace(self) -> np.ndarray | None:
        path = self.dir / _WARMUP_TRACE
        return np.load(path) if path.exists() else None

    def save_chunk(self, index: int, positions: np.ndarray,
                   aux: dict) -> None:
        """``aux``: the chunk's per-draw statistics (a flat dict)."""
        arrays = {f'aux_{k}': np.asarray(v) for k, v in aux.items()}
        self._write(f'chunk_{index:06d}.npz',
                    lambda f: np.savez(f, positions=positions, **arrays))

    # ------------------------------------------------------------- load
    def load(self):
        """(state_leaves, rng, tuned, kept_done), or None when there is no
        snapshot or it belongs to another run (logged as a warning)."""
        meta_path = self.dir / _META
        snap_path = self.dir / (_SNAPSHOT_ORBAX if self.fmt == 'orbax'
                                else _SNAPSHOT)
        if not (meta_path.exists() and snap_path.exists()):
            return None
        meta = json.loads(meta_path.read_text())
        if meta.get('fingerprint') != self.fingerprint:
            logger.warning(
                'sampler checkpoint at %s belongs to a different run '
                '(fingerprint mismatch) — ignoring it', self.dir)
            return None
        if self.fmt == 'orbax':
            from mile_tpu_torch.train.checkpoint_orbax import load_ensemble

            tree = load_ensemble(snap_path, collective=False)
            parts = {part: {k: v.numpy()
                            for k, v in tree.get(part, {}).items()}
                     for part in ('state', 'rng', 'tuned', 'meta')}
        else:
            with np.load(snap_path) as d:
                parts = {part: {k[len(part) + 1:]: d[k] for k in d.files
                                if k.startswith(part + '_')}
                         for part in ('state', 'rng', 'tuned', 'meta')}
        # the snapshot's own count (a snapshot written before it held one:
        # the meta file's)
        kept_done = int(parts['meta'].get('kept_done', meta['kept_done']))
        logger.info('resuming sampler from %s at %d kept draws',
                    self.dir, kept_done)
        return parts['state'], parts['rng'], parts['tuned'], kept_done

    def load_chunks(self, n_chunks: int) -> tuple[list, list]:
        """The first ``n_chunks`` drained chunks of the stopped run, in
        order: positions, and the per-draw statistics as :meth:`save_chunk`
        received them. A chunk is written before the snapshot that points
        past it, so a run killed between the two leaves one chunk more
        than its snapshot counts; that chunk is run again, not loaded (the
        JAX package loads every chunk file, and its resumed run would hold
        that chunk twice)."""
        host_chunks, aux_chunks = [], []
        for i in range(n_chunks):
            with np.load(self.dir / f'chunk_{i:06d}.npz') as d:
                host_chunks.append(d['positions'])
                aux_chunks.append({k[len('aux_'):]: d[k] for k in d.files
                                   if k.startswith('aux_')})
        return host_chunks, aux_chunks

    # ---------------------------------------------------------- cleanup
    def clear(self) -> None:
        """Remove the snapshot and the chunks after a successful run, and
        the directory if nothing else is in it."""
        if not self.writer:
            return
        shutil.rmtree(self.dir / _SNAPSHOT_ORBAX, ignore_errors=True)
        for path in self.dir.glob('chunk_*.npz'):
            path.unlink()
        for name in (_SNAPSHOT, _META, _WARMUP_TRACE):
            (self.dir / name).unlink(missing_ok=True)
        try:
            self.dir.rmdir()
        except OSError:
            pass  # foreign files in it: leave it


def restore_generator(state: np.ndarray, device) -> torch.Generator:
    """A generator of ``device`` at the saved ``get_state()``."""
    generator = torch.Generator(device=device)
    generator.set_state(torch.from_numpy(np.asarray(state, np.uint8)))
    return generator
