#!/usr/bin/env python3
"""Time the PyTorch port's two CUDA kernels of one checkout on one GPU.

    python experiments/torch_kernel_times.py --root <checkout> [--out FILE]
        [--shapes 12x674,1x674,2x300000]

Imports ``mile_tpu_torch`` from ``--root`` (so one call can time two
checkouts in turn, e.g. parent, change, change, parent), builds its kernels
and times, at each (chains, dim) of ``--shapes`` (default (12, 674),
(1, 674) and (2, 300000)) float32:

- ``k1``: ``isokinetic_momentum(u, g, eps, None, b1)`` and ``k3``:
  ``partial_refresh(u, eps, L, seed=1, counter=2)``, the call signatures
  that every version of the port takes;
- where the checkout has them, the fused calls of the main path:
  ``k1_fused`` (with ``x=``, ``x_frac=`` and ``kinetic=``) and
  ``k3_fused`` (a device step counter, ``energy=`` and
  ``energy_sums=``), and each option alone (``k1 +x``, ``k1 +kinetic``,
  ``k3 +counter``, ``k3 +energy``), K1's fused call with a per-chain
  diagonal preconditioner (``k1_precond``, the route of a tuner with
  ``diagonal_preconditioning``), and the plain PyTorch versions of the
  two fused calls (``k1_plain``, ``k3_plain``) on the same inputs;
- ``floor``: PyTorch's ``fill_`` of C floats, the least a launch costs.

Each is timed eagerly (median of 5 runs of 500 calls, 100 for a plain
version, CUDA events) and replayed from a CUDA graph of 200 calls (host
launch cost out). The fused calls and their plain versions also get
their bound: the larger of the bytes they must move (each input read and
each output written once: the checkout's ``chip_smoke.kernel_bytes``)
over the card's memory rate and their operations over its float32 peak
(``chip_smoke``'s counts an element). Prints one JSON line with the
card's name and power limit; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = [(12, 674), (1, 674), (2, 300_000)]
B1 = 0.1931833275037836
def parse_shapes(text: str) -> list[tuple[int, int]]:
    """``'12x674,1x674'`` -> [(12, 674), (1, 674)]."""
    return [tuple(int(v) for v in item.split('x'))
            for item in text.split(',') if item]


def time_ms(torch, fn, n: int = 500, reps: int = 5) -> float:
    for _ in range(20):
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


def graph_ms(torch, fn, n: int = 200) -> float:
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
    return time_ms(torch, graph.replay, n=5, reps=5) / n


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--root', required=True, type=Path)
    parser.add_argument('--out', type=Path)
    parser.add_argument('--shapes', type=parse_shapes, default=SHAPES,
                        help='CxD,... (default 12x674,1x674,2x300000)')
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from chip_smoke import K1_OPS_PER_ELEM, K3_OPS_PER_ELEM, kernel_bytes
    from mile_tpu_torch.ops import isokinetic as ops
    from mile_tpu_torch.utils.card import HBM_BYTES_PER_S, PEAK_FLOPS

    assert Path(ops.__file__).resolve().is_relative_to(root), ops.__file__
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fused_k1 = 'x' in inspect.signature(ops.isokinetic_momentum).parameters
    fused_k3 = 'energy' in inspect.signature(ops.partial_refresh).parameters
    dev = torch.device('cuda')
    results = {'root': str(args.root), 'card': card}
    for n_chains, dim in args.shapes:
        plain, bounds = set(), {}
        gen = torch.Generator().manual_seed(9)
        u = torch.randn(n_chains, dim, generator=gen)
        u = (u / u.norm(dim=1, keepdim=True)).to(dev)
        g = torch.randn(n_chains, dim, generator=gen).to(dev)
        x = torch.randn(n_chains, dim, generator=gen).to(dev)
        eps = torch.full((n_chains,), 0.05, device=dev)
        L = torch.full((n_chains,), 1.5, device=dev)
        small = torch.zeros(n_chains, device=dev)
        cases = {
            'floor': lambda: small.fill_(1.0),
            'k1': lambda: ops.isokinetic_momentum(u, g, eps, None, B1),
            'k3': lambda: ops.partial_refresh(u, eps, L, seed=1, counter=2)}
        if fused_k1:
            kinetic = torch.zeros(n_chains, device=dev)
            cases.update({
                'k1_fused': lambda: ops.isokinetic_momentum(
                    u, g, eps, None, B1, x=x, x_frac=0.5, kinetic=kinetic),
                'k1 +x': lambda: ops.isokinetic_momentum(
                    u, g, eps, None, B1, x=x, x_frac=0.5),
                'k1 +kinetic': lambda: ops.isokinetic_momentum(
                    u, g, eps, None, B1, kinetic=kinetic),
                'k1_precond': lambda: ops.isokinetic_momentum(
                    u, g, eps, precond, B1, x=x, x_frac=0.5,
                    kinetic=kinetic),
                'k1_plain': lambda: ops.isokinetic_momentum_plain(
                    u, g, eps, None, B1, x=x, x_frac=0.5, kinetic=kinetic)})
            precond = torch.rand(n_chains, dim, generator=gen).add_(0.5)
            precond = precond.to(dev)
            plain.add('k1_plain')
            k1_bytes, _ = kernel_bytes(n_chains, dim)
            k1p_bytes, _ = kernel_bytes(n_chains, dim, preconditioned=True)
            ops_k1 = K1_OPS_PER_ELEM * n_chains * dim
            bounds.update({'k1_fused': (k1_bytes, ops_k1),
                           'k1_plain': (k1_bytes, ops_k1),
                           'k1_precond': (k1p_bytes, ops_k1)})
        if fused_k3:
            counter = ops.step_counter(0, dev)
            scalars = [torch.randn(n_chains, generator=gen).to(dev)
                       for _ in range(3)]
            sums = (torch.zeros(n_chains, device=dev),
                    torch.zeros(n_chains, device=dev))
            cases.update({
                'k3_fused': lambda: ops.partial_refresh(
                    u, eps, L, 1, counter, energy=scalars,
                    energy_sums=sums),
                'k3 +counter': lambda: ops.partial_refresh(
                    u, eps, L, 1, counter),
                'k3 +energy': lambda: ops.partial_refresh(
                    u, eps, L, 1, 2, energy=scalars, energy_sums=sums),
                'k3_plain': lambda: ops.partial_refresh_plain(
                    u, eps, L, z, energy=scalars, energy_sums=sums)})
            z = torch.randn(n_chains, dim, generator=gen).to(dev)
            plain.add('k3_plain')
            _, k3_bytes = kernel_bytes(n_chains, dim)
            ops_k3 = K3_OPS_PER_ELEM * n_chains * dim
            bounds.update({'k3_fused': (k3_bytes, ops_k3),
                           'k3_plain': (k3_bytes, ops_k3)})
        for name, fn in cases.items():
            row = {'ms': time_ms(torch, fn, n=100 if name in plain else 500),
                   'graph_ms': graph_ms(torch, fn)}
            if name in bounds:
                nbytes, nops = bounds[name]
                t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
                t_ops = 1e3 * nops / PEAK_FLOPS['float32']
                row.update(bytes=nbytes, operations=nops,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by='bytes' if t_bytes >= t_ops
                           else 'operations')
            results[f'{name} ({n_chains}, {dim})'] = row
    line = json.dumps(results)
    print(line)
    if args.out:
        with args.out.open('a') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
