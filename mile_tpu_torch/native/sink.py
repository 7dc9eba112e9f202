"""ctypes bindings for the C++ async sample sink (the port's copy of
``mile_tpu/native/sink.py``: the same files, protocol and fallback).

The library is built with ``g++`` at first use into ``mile_tpu_torch/
build/`` (:func:`mile_tpu_torch.ops.build.compile_library`). When it cannot
be built or loaded, :func:`native_available` is false and a warning is
logged; :class:`NativeSampleSink` then writes the same files synchronously
with numpy.
"""
from __future__ import annotations

import ctypes
import functools
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from mile_tpu_torch.ops.build import compile_library

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / 'sample_sink.cpp'
GXX_FLAGS = ['-O2', '-shared', '-fPIC', '-pthread']


@functools.cache
def _library() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(compile_library(SOURCE, 'g++', GXX_FLAGS)))
    except (RuntimeError, OSError) as e:
        logger.warning('native sample sink unavailable (%s); '
                       'falling back to numpy writer', e)
        return None
    lib.sink_create.restype = ctypes.c_void_p
    lib.sink_create.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long]
    lib.sink_write.restype = ctypes.c_int
    lib.sink_write.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long]
    lib.sink_rows_written.restype = ctypes.c_long
    lib.sink_rows_written.argtypes = [ctypes.c_void_p]
    lib.sink_flush.restype = ctypes.c_int
    lib.sink_flush.argtypes = [ctypes.c_void_p]
    lib.sink_destroy.restype = None
    lib.sink_destroy.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """Whether the C++ library builds and loads here."""
    return _library() is not None


class NativeSampleSink:
    """Async chunk writer matching the runtime's ``sample_sink`` protocol,
    ``sink(chunk (n_chains, block, dim), start)``.

    Writes each chain's draws to ``chain_{c}/samples.bin`` (raw float32
    rows) + ``samples.meta`` on a background C++ thread. ``close()``
    drains the queue; :func:`mile_tpu_torch.train.checkpoint.
    load_flat_samples` (and the JAX package's) reads the format back.
    ``rows_written`` counts the rows of each chain on disk (-1 for the numpy
    fallback) and keeps its final value after ``close()``.
    """

    def __init__(self, directory: str | Path, n_chains: int, dim: int):
        self.directory = Path(directory)
        self.n_chains = n_chains
        self.dim = dim
        self._lib = _library()
        self._handle = None
        self._files = []
        self._rows_at_close = -1
        self.directory.mkdir(parents=True, exist_ok=True)
        if self._lib is not None:
            self._handle = self._lib.sink_create(
                str(self.directory).encode(), n_chains, dim)
        else:  # numpy fallback: synchronous append
            for c in range(n_chains):
                d = self.directory / f'chain_{c}'
                d.mkdir(parents=True, exist_ok=True)
                (d / 'samples.meta').write_text(
                    f'{{"dim": {dim}, "dtype": "float32"}}\n')
                self._files.append(open(d / 'samples.bin', 'wb'))

    @property
    def native(self) -> bool:
        """Whether the draws go through the C++ writer thread."""
        return self._lib is not None

    def __call__(self, chunk: np.ndarray, start: int) -> None:
        chunk = np.ascontiguousarray(chunk, dtype=np.float32)
        c, block, dim = chunk.shape
        if c > self.n_chains or dim != self.dim:
            raise ValueError(f'chunk of shape {chunk.shape} does not fit a '
                             f'sink of {self.n_chains} chains of dim '
                             f'{self.dim}')
        if self._handle is not None:
            ptr = chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            rc = self._lib.sink_write(self._handle, ptr, c, block, dim, start)
            if rc != 0:
                raise IOError('native sample sink write failed')
        else:
            for i, f in enumerate(self._files[:c]):
                chunk[i].tofile(f)

    @property
    def rows_written(self) -> int:
        if self._handle is not None:
            return int(self._lib.sink_rows_written(self._handle))
        return self._rows_at_close

    def close(self) -> None:
        if self._handle is not None:
            failed = self._lib.sink_flush(self._handle) != 0
            self._rows_at_close = int(
                self._lib.sink_rows_written(self._handle))
            self._lib.sink_destroy(self._handle)
            self._handle = None
            if failed:
                raise IOError('native sample sink flush failed')
        else:
            for f in self._files:
                f.close()
            self._files = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
