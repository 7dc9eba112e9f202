"""Warm-start members that the port made on the card, kept as test fixtures.

``tests/fixtures/card_members/<job>/`` holds the ``warmstart/`` directory
(``layout.json`` and ``params_{0..11}.npz``, as the port writes them) of
thirteen catalogue jobs that the port ran at full counts under
``--tpu-arithmetic`` on an NVIDIA H100 80GB HBM3 (700 W): the ``datasize``
study's ``protein_nuts_n10000_r{1,2,3}`` and ``protein_nuts_n40000_r{1,2}``
and the ``complexity`` study's ``bike_nuts_48x48x48_r{1,2,3}``, each of
which warm-started its own 12 members and sampled from them; and the
``complexity`` study's ``bike_mclmc_16x16x16_r{1,2}``, the providers whose
members the ``nuts_ta`` study's seeds 1 and 2 (and ``complexity``'s
``bike_nuts_16x16x16_r{1,2}``) sample from; and the ``diagnostics``
study's ``diag_nuts_airfoil_r{1,2,3}``, which warm-started their own
(the deep-8 FCN). So these are the members
behind the port's pooled rows of those jobs.

:func:`members` gives them as the flat ``(12, dim)`` float32 array that
both packages' runtimes take (``mile_tpu_torch.train.sampling_hmc.
run_hmc_family`` as a tensor, ``mile_tpu.train.sampling_hmc.
run_hmc_family`` as a JAX array): the port's flat layout, which is
``jax.flatten_util.ravel_pytree``'s order of the JAX model's parameters.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / 'fixtures' / 'card_members'

# job -> (study, flat dimension of its network)
JOBS = {
    'protein_nuts_n10000_r1': ('datasize', 738),
    'protein_nuts_n10000_r2': ('datasize', 738),
    'protein_nuts_n10000_r3': ('datasize', 738),
    'protein_nuts_n40000_r1': ('datasize', 738),
    'protein_nuts_n40000_r2': ('datasize', 738),
    'bike_nuts_48x48x48_r1': ('complexity', 5426),
    'bike_nuts_48x48x48_r2': ('complexity', 5426),
    'bike_nuts_48x48x48_r3': ('complexity', 5426),
    'bike_mclmc_16x16x16_r1': ('complexity', 786),
    'bike_mclmc_16x16x16_r2': ('complexity', 786),
    'diag_nuts_airfoil_r1': ('diagnostics', 426),
    'diag_nuts_airfoil_r2': ('diagnostics', 426),
    'diag_nuts_airfoil_r3': ('diagnostics', 426),
}


def directory(job: str) -> Path:
    return FIXTURES / job


def layout(job: str):
    """The members' ``FlatLayout``, read from their ``layout.json``."""
    from mile_tpu_torch.train import checkpoint as ckpt

    return ckpt.load_layout(directory(job))


def members(job: str) -> np.ndarray:
    """The job's 12 members, flat ``(12, dim)`` float32 in the JAX
    package's ``ravel_pytree`` order."""
    from mile_tpu_torch.train import checkpoint as ckpt

    src = directory(job)
    flat = ckpt.load_params_batch(src, ckpt.list_checkpoints(src))
    if flat.shape != (12, layout(job).dim):
        raise ValueError(f'{src}: members of shape {flat.shape}, expected '
                         f'(12, {layout(job).dim})')
    return flat.astype(np.float32)


def _find(job: str):
    sys.path.insert(0, str(ROOT / 'experiments'))
    import torch_run_catalog as cat

    (found,) = [j for j in cat.build_jobs() if j.name == job]
    return found


def catalogue_job(job: str):
    """The port's catalogue job of that name, without a warm-start
    provider (the members stand in for it)."""
    import dataclasses

    return dataclasses.replace(_find(job), warmstart_from=None)


def provider(job: str) -> str:
    """The name of the catalogue job whose warm start ``job`` reuses."""
    return Path(_find(job).warmstart_from).name
