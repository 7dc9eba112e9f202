"""Build and load the port's CUDA kernels.

Each source under ``mile_tpu_torch/csrc/`` is compiled at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
placed in ``mile_tpu_torch/build/`` under a name that carries a hash of
the source and flags (a stale build is never loaded), and bound with
``ctypes``. Nothing is built or imported while a module is imported: the
CPU tests import every module and have no ``nvcc``. The host-side C++ of
``mile_tpu_torch/native/`` is built the same way with ``g++``
(:func:`compile_library`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / 'csrc'
BUILD_DIR = _PKG / 'build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']


def nvcc_path() -> str:
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    for candidate in (Path(home) / 'bin' / 'nvcc', shutil.which('nvcc')):
        if candidate and Path(candidate).exists():
            return str(candidate)
    raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, '
                       '/usr/local/cuda/bin and PATH); the CUDA kernels '
                       'can only be built where the CUDA toolkit is')


def library_path(src: Path, flags: list[str]) -> Path:
    """Where ``src`` builds to (the name hashes source + flags)."""
    digest = hashlib.sha256(src.read_bytes()
                            + ' '.join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{src.stem}_{digest}.so'


def compile_library(src: Path, compiler: str, flags: list[str]) -> Path:
    """Compile ``src`` into a shared library in ``BUILD_DIR`` unless it
    exists; the compiler's report is kept beside it as ``.log``. Raises
    ``RuntimeError`` when the compiler fails."""
    out = library_path(src, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    proc = subprocess.run([compiler, *flags, '-o', str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'{Path(compiler).name} failed building '
                           f'{src.name} ({proc.returncode}):\n{proc.stderr}')
    out.with_suffix('.log').write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)   # atomic: a concurrent build never loads a stub
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` with nvcc unless its library exists; the
    compiler's report (registers, spills) is kept beside it as ``.log``."""
    return compile_library(CSRC_DIR / f'{name}.cu', nvcc_path(), NVCC_FLAGS)


_P, _I32, _I64, _U64, _F32 = (ctypes.c_void_p, ctypes.c_int32,
                              ctypes.c_int64, ctypes.c_uint64,
                              ctypes.c_float)


@functools.cache
def isokinetic_library() -> ctypes.CDLL:
    """The built ``csrc/isokinetic.cu``, with its C signatures declared."""
    lib = ctypes.CDLL(str(build('isokinetic')))
    lib.mile_isokinetic_momentum.argtypes = [
        _P, _P, _P, _I64, _P, _F32, _P, _F32, _P, _P, _P, _I32, _I32, _I64,
        _I32, _I32, _I64, _I32, _P]
    lib.mile_isokinetic_momentum.restype = ctypes.c_int
    lib.mile_partial_refresh.argtypes = [
        _P, _P, _P, _P, _U64, _U64, _P, _P, _P, _P, _P, _P, _P, _P, _I32,
        _I64, _I32, _I32, _I64, _I32, _P]
    lib.mile_partial_refresh.restype = ctypes.c_int
    lib.mile_error_string.argtypes = [ctypes.c_int]
    lib.mile_error_string.restype = ctypes.c_char_p
    return lib


def raise_error(code: int, what: str) -> None:
    """Raise for the CUDA error ``code`` that launching ``what`` returned."""
    message = isokinetic_library().mile_error_string(code).decode()
    raise RuntimeError(f'{what} failed to launch: CUDA error {code} '
                       f'({message})')
