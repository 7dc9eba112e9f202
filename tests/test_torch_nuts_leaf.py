"""The port's NUTS leaf and the Dense gradient it spends its time in, on
the CPU.

- The leaf's slot table is the checkpoint arithmetic of iterative NUTS:
  the odd leaf ``n`` stores at slot ``popcount(n-1)``, the even leaf ``n``
  checks the slots of every complete subtree ending at it.
- In a batch each chain counts its own leaves: a chain that diverges at
  its first leaf reports one integration step while the batch goes on to
  the depth cap for the others (the pooled ``mean_num_integration_steps``
  would otherwise sit at the cap).
- The same step run twice, with the leaf's graph switch on and off, gives
  the same trees and positions (off CUDA both run the leaf eagerly; on the
  card ``chip_smoke.py`` and ``experiments/torch_nuts_leaf_rate.py`` hold
  the graph against the eager leaf and the CPU).
- The leaves are rebuilt when the arithmetic or the float32 matmul
  precision changes (a captured graph keeps the route of its products).
- The Dense kernel's gradient over many rows, by blocks of rows
  (``split_k_weight_grad``), equals autograd's product within float32
  rounding, and a Dense layer takes that route from
  ``SPLIT_K_MIN_ROWS`` rows on inside ``split_k_rows`` only.
- ``experiments/torch_nuts_leaf_rate.py`` runs on the CPU at a cut size.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

from mile_tpu_torch.mcmc import hmc, nuts
from mile_tpu_torch.models import blocks

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'experiments'))


def _popcount(n: int) -> int:
    return bin(n).count('1')


@pytest.mark.parametrize('max_depth', [1, 3, 8, 10])
def test_the_leaf_table_is_the_checkpoint_arithmetic(max_depth):
    store, check = nuts._leaf_table(max_depth, 'cpu')
    assert store.shape == check.shape == (1 << (max_depth - 1), max_depth)
    for n in range(1, store.shape[0] + 1):
        if n % 2:
            assert store[n - 1].nonzero().flatten().tolist() == [
                _popcount(n - 1)]
            assert not check[n - 1].any()
        else:
            hi = _popcount(n - 1) - 1
            tz = (n & -n).bit_length() - 1
            assert check[n - 1].nonzero().flatten().tolist() == list(
                range(max(hi - tz + 1, 0), hi + 1))
            assert not store[n - 1].any()


def _gaussian(dim: int):
    scale = torch.linspace(0.5, 2.0, dim)

    def vg(theta):
        return -0.5 * torch.sum((theta / scale) ** 2, dim=-1), \
            -theta / scale ** 2

    return vg


def test_each_chain_counts_its_own_leaves():
    """Chain 0 at a small step runs to the depth cap, chain 1's huge step
    diverges at its first leaf: the batch takes 2**depth - 1 leaves, chain
    1 reports one integration step and a divergence, chain 0 the cap."""
    depth, dim = 4, 6
    vg = _gaussian(dim)
    kernel = nuts.build_kernel(
        vg, max_depth=depth,
        draws=hmc.Draws(torch.Generator().manual_seed(3)))
    theta = torch.full((2, dim), 0.3)
    eps = torch.tensor([1e-3, 1e4])
    _, info = kernel(nuts.init(theta, vg), eps, torch.ones(2, dim))
    assert info.num_integration_steps.tolist() == [2 ** depth - 1, 1]
    assert info.is_divergent.tolist() == [False, True]
    assert info.num_trajectory_expansions.tolist() == [depth, 1]
    assert kernel.leaf_steps == 2 ** depth - 1


def test_the_graph_switch_changes_no_draw_off_cuda():
    vg = _gaussian(5)
    theta = torch.randn(3, 5, generator=torch.Generator().manual_seed(1))
    eps = torch.tensor([0.05, 0.2, 0.9])
    out = []
    for graph in (True, False):
        kernel = nuts.build_kernel(
            vg, max_depth=6, graph=graph,
            draws=hmc.Draws(torch.Generator().manual_seed(9)))
        state = nuts.init(theta, vg)
        for _ in range(3):
            state, info = kernel(state, eps, torch.ones(3, 5))
        out.append((state.position, info, kernel.graphed))
    (p1, i1, g1), (p2, i2, g2) = out
    assert not g1 and not g2
    assert torch.equal(p1, p2)
    for field in i1._fields:
        assert torch.equal(getattr(i1, field), getattr(i2, field)), field


def test_a_changed_arithmetic_rebuilds_the_leaves():
    """The same kernel under another arithmetic or float32 matmul
    precision builds new leaves (on the card their graph would replay the
    products' old route); under the same scope it keeps them."""
    from mile_tpu_torch.utils.precision import matmul_precision

    vg = _gaussian(4)
    kernel = nuts.build_kernel(
        vg, max_depth=3, draws=hmc.Draws(torch.Generator().manual_seed(5)))
    state = nuts.init(torch.zeros(2, 4), vg)
    eps, imm = torch.tensor([0.1, 0.2]), torch.ones(2, 4)
    built = []
    for precision in ('float32', 'float32', 'bfloat16', 'tensorfloat32',
                      'float32'):
        with matmul_precision(precision):
            state, _ = kernel(state, eps, imm)
        built.append(kernel._leaves)
        # outside any scope the arithmetic is float32 at 'highest'
        assert kernel._leaves.fits(state.position) == (precision == 'float32')
    assert built[0] is built[1]
    assert len({id(b) for b in built[1:]}) == 4
    with matmul_precision('bfloat16'):
        assert built[2].key[3:] == ('bfloat16', 'highest')
        assert built[2].fits(state.position)


@pytest.mark.parametrize('rows', [blocks.SPLIT_K_MIN_ROWS, 4500, 9000])
def test_the_split_k_gradient_is_autograds(rows):
    """Over ``rows`` rows (whole blocks of ``SPLIT_K_ROWS`` and a rest),
    float32: the kernel's, the input's and the bias's gradients within
    float32 rounding of autograd's ``baddbmm``, the forward bit for bit;
    the expanded first-layer input (stride 0 over the chains) too."""
    g = torch.Generator().manual_seed(rows)
    h = torch.randn(3, rows, 9, generator=g).requires_grad_(True)
    w = torch.randn(3, 9, 16, generator=g).requires_grad_(True)
    b = torch.randn(3, 1, 16, generator=g).requires_grad_(True)
    cot = torch.randn(3, rows, 16, generator=g)
    y = blocks.SplitKProduct.apply(h, w, b)
    ours = torch.autograd.grad(y, (h, w, b), cot)
    ref_y = torch.baddbmm(b, h, w)
    ref = torch.autograd.grad(ref_y, (h, w, b), cot)
    assert torch.equal(y, ref_y)
    exact = torch.bmm(h.detach().double().transpose(1, 2), cot.double())
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-3)
    # no worse than autograd's long sums against a float64 product
    assert (ours[1].double() - exact).abs().max() \
        <= (ref[1].double() - exact).abs().max() + 1e-3
    x = torch.randn(rows, 9, generator=g).expand(3, -1, -1)
    (dw,) = torch.autograd.grad(blocks.SplitKProduct.apply(x, w, None), w,
                                cot)
    np.testing.assert_allclose(dw.numpy(), torch.bmm(
        x.transpose(1, 2), cot).numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize('rows,width,scoped,split', [
    (blocks.SPLIT_K_MIN_ROWS - 1, 3, True, False),
    (blocks.SPLIT_K_MIN_ROWS, 3, True, True),
    (blocks.SPLIT_K_MIN_ROWS, 3, False, False),   # outside the scope
    (blocks.SPLIT_K_MIN_ROWS, 48, True, True),    # a 48 x 48 kernel
    (blocks.SPLIT_K_MIN_ROWS, 49, True, False)])  # a 48 x 49 kernel
def test_a_dense_layer_splits_from_the_row_threshold(rows, width, scoped,
                                                     split):
    """Inside ``split_k_rows`` a small kernel over ``SPLIT_K_MIN_ROWS``
    rows or more takes the split route; fewer rows, a kernel over
    ``SPLIT_K_MAX_KERNEL`` entries, or any layer outside the scope take
    autograd's product."""
    import contextlib

    from mile_tpu_torch.models.layout import FlatLayout

    fan_in = 4 if width < 48 else 48
    layout = FlatLayout({'fcn': {'layer0': blocks.dense_params(
        fan_in, width, True)}})
    theta = torch.randn(2, layout.dim).requires_grad_(True)
    h = torch.randn(2, rows, fan_in)
    with blocks.split_k_rows() if scoped else contextlib.nullcontext():
        y = blocks.dense(theta, h, layout, 'fcn/layer0')
    assert ('SplitKProduct' in type(y.grad_fn).__name__) == split
    (grad,) = torch.autograd.grad(y.sum(), theta)
    assert torch.isfinite(grad).all()


def test_the_leaf_rate_script_on_the_cpu():
    import torch_nuts_leaf_rate as rate

    out = rate.measure('protein_nuts_n5000_r1', steps=1, n_chains=2,
                       depth=3, device='cpu')
    assert out['same_trees'] and out['max_abs_dposition'] == 0.0
    assert (out['dim'], out['n_train']) == (738, 4500)
    assert out['graph_leaves'] == out['eager_route_leaves'] \
        == out['eager_leaves'] > 0
    assert not out['graph_graphed'] and out['card'] is None
    assert not out['graph_splits'] and out['split_over_plain_graphed'] \
        is None and 'graph_other_leaves' not in out
