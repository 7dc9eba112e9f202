"""Wall-time measurement (counterpart of ``mile_tpu/utils/timing.py``).

The report parses ``<name> took <X> seconds`` lines from ``training.log``
(:data:`mile_tpu_torch.inference.reporting.TIME_RE`), so the format is a
contract shared with the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import time

logger = logging.getLogger('mile_tpu_torch')


@contextlib.contextmanager
def measure_time(name: str):
    """Context manager logging ``{name} took Xs`` (parseable by reporting)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        logger.info('%s took %.4f seconds', name, elapsed)


def timed(name: str):
    """Decorator flavour of :func:`measure_time`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with measure_time(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
