"""The port's headline bench (``bench_torch.py``) on the CPU, against
``bench.py`` at small sizes.

The airfoil workload's log-density and gradient are held against
``bench.build_workload()``'s; the headline line's keys against
``bench.main()``'s with both modules' measurements stubbed; the FLOP counts
against ``bench.py``'s formulas; the chain-scaling lines against what
``experiments/plot_chain_scaling.py`` reads; the fault retries, with real
worker processes, against the contract ``tests/test_bench_resilience.py``
holds ``bench.py`` to. Rates measured here are rates of PyTorch's CPU
kernels, checked only for being finite.
"""
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import bench_torch  # noqa: E402

from mile_tpu_torch.models import flat_from_jax_params  # noqa: E402

THROUGHPUT_KEYS = {'median', 'iqr', 'min', 'max', 'n_repeats'}
WARMSTART_KEYS = {'member_steps_per_sec', 'epochs_per_sec', 'wall_s'}
# a module a worker imports: fails with CUDA's text of a sticky fault on its
# first call, returns on later ones (calls counted in a marker file)
DRILL = '''
from pathlib import Path

def fault_once(marker, device='cpu'):
    path = Path(marker)
    n = int(path.read_text()) + 1 if path.exists() else 1
    path.write_text(str(n))
    if n == 1:
        raise RuntimeError('CUDA error: an illegal memory access was '
                           'encountered')
    return {'attempts': n}
'''


def test_workload_density_matches_bench():
    """The airfoil posterior at the JAX template carried across and at
    three seeded positions: the value at rtol 1e-5, the gradient at rtol
    1e-5 with a floor of 1e-5 of its largest entry (float32 sums in
    another order)."""
    jax_bayes, logdensity = bench.build_workload()
    bayes, x, y, template = bench_torch.build_workload('cpu')
    assert bayes.dim == jax_bayes.dim == template.shape[0] == 674
    from mile_tpu.config import FCNConfig
    from mile_tpu.models import build_model

    jax_template = build_model(FCNConfig(hidden_structure=bench.HIDDEN)).init(
        jax.random.PRNGKey(1), jnp.asarray(x.numpy())[:1])['params']
    carried = flat_from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax_template), bayes.model.layout)
    np.testing.assert_array_equal(
        carried, np.asarray(jax_bayes.flatten(jax_template)))
    rng = np.random.default_rng(7)
    theta = np.concatenate([carried[None], 0.1 * rng.standard_normal(
        (3, bayes.dim))]).astype(np.float32)
    want_v, want_g = jax.vmap(jax.value_and_grad(logdensity))(
        jnp.asarray(theta))
    got_v, got_g = bayes.logdensity_and_grad_fn(x, y)(torch.from_numpy(theta))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-5,
                               atol=1e-5 * np.abs(want_g).max())


def _last_json(text: str) -> dict:
    lines = [line for line in text.splitlines() if line.startswith('{')]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_headline_keys_are_bench_main_keys_and_card(monkeypatch, capsys):
    """Both modules' measurements stubbed: bench_torch's headline line has
    every key of bench.main()'s and ``card``, and besides them only the
    CPU rates it divided by, measured in the same run."""
    throughput = {'median': 1000.0, 'iqr': 10.0, 'min': 990.0,
                  'max': 1010.0, 'n_repeats': 7}
    warmstart = {'member_steps_per_sec': 5000.0, 'epochs_per_sec': 2.0,
                 'wall_s': 3.0}
    monkeypatch.setattr(bench, '_measure_throughput',
                        lambda n, *a, **k: throughput)
    monkeypatch.setattr(bench, '_measure_warmstart', lambda n: warmstart)
    bench.main()
    want = _last_json(capsys.readouterr().out)
    monkeypatch.setattr(bench_torch, '_measure_throughput',
                        lambda n, device: throughput)
    monkeypatch.setattr(bench_torch, '_measure_warmstart',
                        lambda n, device: warmstart)
    monkeypatch.setattr(bench_torch, 'CPU_BLOCK_STEPS', 3)
    assert bench_torch.main(['--cpu']) == 0
    got = _last_json(capsys.readouterr().out)
    assert set(want) | {'card'} <= set(got)
    assert set(got) - set(want) == {
        'card', 'reference_style_cpu_samples_per_sec',
        'own_cpu_samples_per_sec', 'cpu_block_steps'}
    assert got['card'] == 'cpu' and got['value'] == 1000.0
    reference = got['reference_style_cpu_samples_per_sec']
    assert math.isfinite(reference) and reference > 0
    assert got['vs_baseline'] == got['vs_reference_style'] == round(
        1000.0 / reference, 2)
    assert got['vs_own_cpu'] == round(1000.0 / got['own_cpu_samples_per_sec'],
                                      2)


@pytest.mark.parametrize('width', [64, 512])
def test_flop_counts_are_bench_formulas(width):
    """bench.py's hand counts, exactly: LeNet's 2 x 3 x 833,040 FLOPs an
    image (bench.py:419-420) and the wide FCN's 2 x 3 forwards of
    2 rows (128 w + 2 w^2 + 2 w) (bench.py:512-513)."""
    n_rows, n_feat = 65_536, 128
    fwd = 2 * n_rows * (n_feat * width + 2 * width * width + width * 2)
    assert bench_torch.wide_fcn.model_flops_per_step(width) == float(
        2 * 3 * fwd)
    assert bench_torch.lenet_step_flops(60_000) == float(
        2 * 3 * 833_040 * 60_000)


@pytest.mark.parametrize('model', ['lenet', 'fcn'])
def test_counted_flops_cover_the_model_count(model):
    """FlopCounterMode over one chunked step (3 chains, two gradients) on
    the CPU: each gradient counts the forward, its recomputation in the
    backward and the backward, which skips the first layer's input
    gradient: 2 (4 F - F1) a chain, F the forward's FLOPs and F1 its first
    layer's, at least the model count 6 F. Exact, so a grouped
    convolution's weight gradient (LeNet's second convolution, one group
    per chain) is counted once per group. The bf16 forward's convolutions
    and products get bf16 inputs."""
    from mile_tpu_torch.bayes import BayesianModel, Prior
    from mile_tpu_torch.config import PriorDist, Task
    from mile_tpu_torch.config.models import LeNetConfig
    from mile_tpu_torch.models import build_model

    n_chains, gen = 3, torch.Generator().manual_seed(0)
    if model == 'lenet':
        n = 64
        rs = np.random.RandomState(0)
        x = torch.from_numpy(rs.rand(n, 1, 28, 28).astype(np.float32))
        y = torch.from_numpy(rs.randint(0, 10, size=(n,)).astype(np.int32))
        bayes = BayesianModel(
            build_model(LeNetConfig(out_dim=10), (1, 28, 28)),
            Prior.from_name(PriorDist.STANDARD_NORMAL), Task.CLASSIFICATION,
            likelihood_chunk_size=16, compute_dtype='bfloat16')
        model_flops = bench_torch.lenet_step_flops(n)
        first = 28 * 28 * 6 * 25 * 2 * n
    else:
        n, width = 256, 16
        bayes, x, y = bench_torch.wide_fcn.build('bfloat16', 'cpu', width, n,
                                                 chunk=64)
        model_flops = bench_torch.wide_fcn.model_flops_per_step(width, n)
        first = 2 * n * 128 * width
    run = bench_torch._timed_block(bayes, x, y, n_chains, 1, 1.0, 1e-4, 0.05,
                                   torch.device('cpu'), gen, count_flops=True)
    forward = model_flops / 6
    assert run['hw_flops_per_step'] == n_chains * 2 * (4 * forward - first)
    assert run['hw_flops_per_step'] >= n_chains * model_flops
    dtypes = run['matmul_input_dtypes']
    assert {'bmm', 'baddbmm'} <= set(dtypes)
    if model == 'lenet':
        assert {'convolution', 'convolution_backward'} <= set(dtypes)
    assert all(v == ['torch.bfloat16'] for v in dtypes.values()), dtypes


def test_chain_scaling_lines_load_as_points(tmp_path, capsys):
    """Airfoil chain scaling at 2 and 3 chains, 5 steps: the printed lines
    are what ``plot_chain_scaling.load_points`` reads, two points at dim
    674, with finite rates and energies."""
    sys.path.insert(0, str(ROOT / 'experiments'))
    import plot_chain_scaling

    lines = bench_torch.chain_scaling('airfoil', [2, 3], 5, device='cpu')
    path = tmp_path / 'scale_airfoil.jsonl'
    path.write_text(capsys.readouterr().out)
    points, dim = plot_chain_scaling.load_points(path)
    assert dim == 674 and [n for n, _ in points] == [2, 3]
    assert all(math.isfinite(v) and v > 0 for _, v in points)
    assert all(line['energy_change_finite'] for line in lines[:-1])
    assert lines[-1]['points'] == points


def test_device_fault_is_retried_in_a_fresh_worker(tmp_path, monkeypatch,
                                                   capsys):
    """A worker whose measurement fails with CUDA's text of an illegal
    address exits as a device fault; the retry runs in a new worker
    process and its result comes back."""
    (tmp_path / 'bench_drill.py').write_text(DRILL)
    monkeypatch.setenv('PYTHONPATH', str(tmp_path))
    monkeypatch.setattr(bench_torch, 'BENCH_ATTEMPTS', 3)
    monkeypatch.setattr(bench_torch, 'BENCH_COOLOFF_S', 0.0)
    marker = tmp_path / 'attempts'
    result = bench_torch._with_retries(lambda: bench_torch.run_worker(
        'bench_drill:fault_once', {'marker': str(marker), 'device': 'cpu'}),
        'drill')
    assert result == {'attempts': 2} and marker.read_text() == '2'
    err = capsys.readouterr().err
    assert 'drill attempt 1/3 hit a device fault' in err
    assert 'illegal memory access' in err


@pytest.mark.parametrize('exc', [
    ValueError('shape mismatch'),
    torch.OutOfMemoryError('CUDA out of memory. Tried to allocate 4.00 PiB'),
    RuntimeError('CUDA out of memory. Tried to allocate 4.00 PiB'),
    bench_torch.WorkerFailed('measure_throughput: exit 1: OutOfMemoryError:'
                             ' CUDA out of memory.'),
], ids=['value', 'oom', 'oom-text', 'worker-failed'])
def test_non_faults_are_raised_at_once(exc, monkeypatch):
    """A ValueError and out of memory (deterministic: no retry) are raised
    on the first attempt."""
    monkeypatch.setattr(bench_torch, 'BENCH_COOLOFF_S', 0.0)
    calls = []

    def boom():
        calls.append(1)
        raise exc

    with pytest.raises(type(exc)):
        bench_torch._with_retries(boom, 'x')
    assert len(calls) == 1


@pytest.mark.parametrize('exc', [
    RuntimeError('CUDA error: device-side assert triggered'),
    RuntimeError('cuBLAS call failed: cudaErrorLaunchFailure'),
    bench_torch.DeviceFault('measure_throughput: no result after 3600 s'),
], ids=['cuda-text', 'cuda-enum', 'worker-fault'])
def test_faults_are_retried(exc, monkeypatch):
    """CUDA's error text and a worker's fault (or hang) get a new attempt."""
    monkeypatch.setattr(bench_torch, 'BENCH_ATTEMPTS', 3)
    monkeypatch.setattr(bench_torch, 'BENCH_COOLOFF_S', 0.0)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise exc
        return 'ok'

    assert bench_torch._with_retries(flaky, 'x') == 'ok'
    assert len(calls) == 3


def test_final_failure_prints_one_json_line(monkeypatch, capsys):
    """Every attempt faulted: one parseable JSON line with ``error``, the
    card and no value, and exit 1."""
    monkeypatch.setattr(bench_torch, 'BENCH_ATTEMPTS', 2)
    monkeypatch.setattr(bench_torch, 'BENCH_COOLOFF_S', 0.0)
    calls = []

    def always(n, device):
        calls.append(n)
        raise bench_torch.DeviceFault('measure_throughput: CUDA error: '
                                      'unspecified launch failure')

    monkeypatch.setattr(bench_torch, '_measure_throughput', always)
    assert bench_torch.main(['--cpu']) == 1
    rec = _last_json(capsys.readouterr().out)
    assert rec['metric'] == 'mclmc_airfoil_samples_per_sec'
    assert rec['value'] is None and rec['card'] == 'cpu'
    assert 'unspecified launch failure' in rec['error']
    assert calls == [12, 12]


def test_donate_is_refused():
    with pytest.raises(ValueError, match='no counterpart'):
        bench_torch.main(['--fcn-mfu', '--donate', '--cpu'])


@pytest.mark.parametrize('argv', [[], ['--lenet-mfu'], ['--fcn-mfu'],
                                  ['--chain-scaling', 'fcn']],
                         ids=['headline', 'lenet', 'fcn', 'scaling'])
def test_no_gpu_without_cpu_flag_raises(argv):
    """Without a GPU every device mode raises unless --cpu asks for the
    CPU: nothing falls back to it."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bench_torch.main(argv)


def test_measurements_on_the_cpu():
    """measure_throughput at 2 chains (20 tuner steps, 2 blocks of 5) and
    measure_warmstart at 2 members and 1 epoch give bench.py's keys, with
    finite values."""
    head = bench_torch.measure_throughput(2, 2, warmup_steps=20,
                                          timed_steps=5, device='cpu')
    assert THROUGHPUT_KEYS <= set(head) and head['n_repeats'] == 2
    assert all(math.isfinite(head[k]) for k in THROUGHPUT_KEYS)
    assert head['min'] <= head['median'] <= head['max']
    assert head['energy_change_finite']
    ws = bench_torch.measure_warmstart(2, 1, device='cpu')
    assert WARMSTART_KEYS <= set(ws) and ws['params_finite']
    assert all(math.isfinite(ws[k]) and ws[k] > 0 for k in WARMSTART_KEYS)
