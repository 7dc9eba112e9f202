"""The port's experiment scripts on the CPU: the dtype A/B's wide FCN
against the JAX package's, one A/B arm end to end, the A/B's handling of
its children (a failed arm runs again; a child must print exactly one
record), and the NUTS timing scripts at a few steps.

The wide FCN's log-posterior and gradient (W = 16 on 256 of the A/B's
synthetic rows; the JAX script builds the same posterior) are held
against the JAX package's FCN with the same parameters, carried across
with the port's weight function. The scripts' timings on the CPU are
times of PyTorch's CPU kernels, checked only for being printed and
finite.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'experiments'))

import torch_dtype_ab_widefcn as ab  # noqa: E402
import torch_profile_nuts  # noqa: E402
import torch_time_warmup  # noqa: E402

from mile_tpu_torch.models import flat_from_jax_params  # noqa: E402

NUMBER = r'(-?[0-9.]+(?:e-?[0-9]+)?)'


def test_wide_fcn_density_matches_jax():
    """FCN [16, 16, 16, 2] over 256 rows of 128 features, 3 chains: the
    value at rtol 1e-5, the gradient at rtol 1e-5 with a floor of 1e-5
    of its largest entry (float32 sums in another order)."""
    from mile_tpu.bayes import BayesianModel, Prior
    from mile_tpu.config import FCNConfig, PriorDist, Task
    from mile_tpu.models import build_model

    bayes, x, y = ab.build(None, 'cpu', width=16, n_rows=256)
    assert bayes.dim == 128 * 16 + 16 + 2 * (16 * 16 + 16) + 16 * 2 + 2
    module = build_model(FCNConfig(hidden_structure=[16] * 3 + [2]))
    xj, yj = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    params = jax.vmap(lambda k: module.init(k, xj[:1])['params'])(
        jax.random.split(jax.random.PRNGKey(1), 3))
    template = jax.tree_util.tree_map(lambda a: a[0], params)
    jax_bayes = BayesianModel(module, template,
                              Prior.from_name(PriorDist.STANDARD_NORMAL),
                              Task.REGRESSION, likelihood_chunk_size=8192)
    flat = np.stack([np.asarray(jax_bayes.flatten(
        jax.tree_util.tree_map(lambda a, i=i: a[i], params)))
        for i in range(3)])
    want_v, want_g = jax.vmap(jax.value_and_grad(
        jax_bayes.logdensity_fn(xj, yj)))(jnp.asarray(flat))
    theta = torch.from_numpy(flat_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), bayes.model.layout))
    np.testing.assert_array_equal(theta.numpy(), flat)
    value, grad = bayes.logdensity_and_grad_fn(x, y)(theta)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_v), rtol=1e-5)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(grad.numpy(), want_g, rtol=1e-5,
                               atol=1e-5 * np.abs(want_g).max())


def test_an_arm_end_to_end(tmp_path, monkeypatch, capsys):
    """The f32tune arm alone at W = 16 over the full 65,536 x 128 rows, 3
    tuner steps and 1 timed step, in its own subprocess: every JSON field of
    the JAX script's record, the port's own beside them, 12 finite ε;
    the H100's peak share is not computed from a CPU run."""
    monkeypatch.setattr(ab, 'WIDTH', 16)
    monkeypatch.setattr(ab, 'ARMS', {'f32tune': ab.ARMS['f32tune']})
    out = tmp_path / 'ab.jsonl'
    assert ab.main(['--device', 'cpu', '--warmup-steps', '3',
                    '--timed-steps', '1', '--out', str(out)]) == 0
    assert 'f32tune: ok' in capsys.readouterr().out
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    for key in ('arm', 'dim', 'n_chains', 'warmup_steps', 'warmup_wall_s',
                'eps_mean', 'eps_std', 'L_mean', 'L_std', 'steps_per_sec',
                'model_tflops_per_sec', 'finite_eps_chains',
                'mfu_vs_arm_peak', 'peak_tflops', 'matmul_type', 'launches'):
        assert key in rec, key
    assert rec['arm'] == 'f32tune_w16' and rec['dim'] == 2642
    assert rec['finite_eps_chains'] == rec['n_chains'] == 12
    assert rec['steps_per_sec'] > 0 and rec['device'] == 'cpu'
    assert rec['matmul_type'] == 'float32'
    assert rec['mfu_vs_arm_peak'] is None and rec['peak_tflops'] is None
    # on the CPU the wrappers compute the plain versions: no launches
    assert rec['launches'] == {'isokinetic_momentum': 0,
                               'partial_refresh': 0}
    # a recorded arm is skipped on the next launch
    assert ab.main(['--device', 'cpu', '--out', str(out)]) == 0
    assert 'already recorded, skip' in capsys.readouterr().out


def _fake_children(monkeypatch, outputs):
    """Replace the A/B's child processes: ``outputs[tag]`` is the (exit
    code, stdout) of arm ``tag``'s child. Returns the tags launched."""
    launched = []

    def run(cmd, **kwargs):
        tag = cmd[cmd.index('--arm') + 1]
        launched.append(tag)
        rc, out = outputs[tag]
        return subprocess.CompletedProcess(cmd, rc, out, 'child stderr')

    monkeypatch.setattr(ab.subprocess, 'run', run)
    monkeypatch.setattr(ab, 'ARMS', {t: ab.ARMS[t] for t in outputs})
    return launched


def _ok(tag):
    return 0, f'progress line\n{json.dumps({"arm": f"{tag}_w512"})}\n'


def test_the_tpu_arithmetic_reaches_each_arm(tmp_path, monkeypatch):
    """``--tpu-arithmetic`` goes to every child, and its arms are recorded
    apart from the exact arms: ids ending in ``_tpu``."""
    seen = []

    def run(cmd, **kwargs):
        seen.append(cmd)
        tag = cmd[cmd.index('--arm') + 1]
        return subprocess.CompletedProcess(
            cmd, 0, json.dumps({'arm': f'{tag}_w512_tpu'}) + '\n', '')

    monkeypatch.setattr(ab.subprocess, 'run', run)
    monkeypatch.setattr(ab, 'ARMS', {'f32def': ab.ARMS['f32def']})
    out = tmp_path / 'ab.jsonl'
    out.write_text(json.dumps({'arm': 'f32def_w512'}) + '\n')
    assert ab.main(['--device', 'cpu', '--out', str(out),
                    '--tpu-arithmetic']) == 0
    (cmd,) = seen
    assert cmd[-1] == '--tpu-arithmetic'
    assert ab.done_arms(out) == {'f32def_w512', 'f32def_w512_tpu'}


def test_an_arm_records_what_none_stood_for():
    """One arm in process (W = 16 over the 65,536 rows, 2 tuner steps)
    under the TPU setting: the record says ``bfloat16``, and the process's
    setting is back to exact float32 afterwards."""
    from mile_tpu_torch.utils import precision

    rec = ab.run_arm('f32def', warmup_steps=2, timed_steps=1, device='cpu',
                     width=16, tpu_arithmetic=True)
    assert rec['arm'] == 'f32def_w16_tpu'
    assert rec['none_precision'] == 'bfloat16'
    assert rec['matmul_type'] == 'float32'      # the CPU's rounding route
    assert precision.none_precision() == 'float32'


@pytest.mark.parametrize('verdict', ['timeout', 'error', 'kernel_fault'])
def test_a_failed_arm_runs_again(verdict, tmp_path, monkeypatch):
    """Only records without a ``verdict`` count as done: an arm whose last
    launch left a failure record runs on the next launch; an arm with a
    result is skipped."""
    out = tmp_path / 'ab.jsonl'
    out.write_text(json.dumps({'arm': 'f32def_w512', 'steps_per_sec': 1.0})
                   + '\n' + json.dumps({'arm': 'f32tune_w512', 'verdict':
                                        verdict, 'rc': -1}) + '\n')
    launched = _fake_children(monkeypatch, {'f32def': _ok('f32def'),
                                            'f32tune': _ok('f32tune')})
    assert ab.main(['--device', 'cpu', '--out', str(out)]) == 0
    assert launched == ['f32tune']
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert records[-1] == {'arm': 'f32tune_w512'}
    assert ab.done_arms(out) == {'f32def_w512', 'f32tune_w512'}


@pytest.mark.parametrize('stdout', [
    '',                                       # no line at all
    'no record, only a log line\n',
    '{"arm": "f32def_w512"}\n{"arm": "f32def_w512"}\n',   # two
    '{"logged": "by a library"}\n',           # a JSON line without arm
    '{not json\n',
])
def test_a_child_without_one_record_is_a_failure(stdout, tmp_path,
                                                 monkeypatch):
    """A child that exits 0 must print exactly one JSON line with ``arm``
    (``bench_torch.run_worker``'s rule): anything else is a failure record
    with the exit code and the output's tail, and the next arm runs."""
    out = tmp_path / 'ab.jsonl'
    launched = _fake_children(monkeypatch, {'f32def': (0, stdout),
                                            'f32tune': _ok('f32tune')})
    assert ab.main(['--device', 'cpu', '--out', str(out)]) == 0
    assert launched == ['f32def', 'f32tune']
    failed, ok = [json.loads(line) for line in out.read_text().splitlines()]
    assert failed['arm'] == 'f32def_w512' and failed['verdict'] == 'error'
    assert failed['rc'] == 0 and failed['output'] == stdout
    assert 'child stderr' in failed['error']
    assert ok == {'arm': 'f32tune_w512'}
    assert ab.done_arms(out) == {'f32tune_w512'}


def test_arm_peaks():
    """float32 arms against 67 TFLOP/s, the bf16 forward against the
    BF16 tensor-core peak; ``None`` is exact float32 in the port by
    default. Where ``None`` stands for the TPU's one bfloat16 pass, the
    arms that sample at ``None`` run bf16 tensor-core products on the
    card's out_dtype route, and float32 products of bf16-rounded operands
    on the rounding route."""
    assert {tag: ab.arm_peak(c, s)[0] for tag, (c, _, s) in
            ab.ARMS.items()} == {'f32def': 'float32', 'f32strict': 'float32',
                                 'bf16fwd': 'bfloat16', 'f32tune': 'float32'}
    assert ab.arm_peak(None, 'tensorfloat32') == ('tensorfloat32', 494.7e12)
    assert {tag: ab.arm_peak(c, s, 'bfloat16')[0] for tag, (c, _, s) in
            ab.ARMS.items()} == {'f32def': 'bfloat16',
                                 'f32strict': 'float32',
                                 'bf16fwd': 'bfloat16',
                                 'f32tune': 'bfloat16'}
    assert ab.arm_peak(None, None, 'bfloat16') == ('bfloat16', 989.4e12)
    assert {tag: ab.arm_peak(c, s, 'bfloat16', 'rounding')[0]
            for tag, (c, _, s) in ab.ARMS.items()} == {
        'f32def': 'float32', 'f32strict': 'float32', 'bf16fwd': 'bfloat16',
        'f32tune': 'float32'}
    assert ab.model_flops_per_step(512) == 2 * 3 * 2 * 65_536 * (
        128 * 512 + 2 * 512 * 512 + 1024)


def test_time_warmup_runs(capsys):
    assert torch_time_warmup.main(['2', '2', '--device', 'cpu']) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == 'dim=514 n_train=640 warmup_steps=2 chains=2'
    first, run = re.match(rf'compile\+run={NUMBER}s  run={NUMBER}s  eps=\[',
                          out[1]).groups()
    assert float(first) > 0 and float(run) > 0


def test_profile_nuts_runs(monkeypatch, capsys):
    """At tree depth 3: at the script's depth 10 a CPU draw takes tens of
    seconds."""
    monkeypatch.setattr(torch_profile_nuts, 'MAX_NUM_DOUBLINGS', 3)
    assert torch_profile_nuts.main(
        ['--warmup-steps', '3', '--draws', '2', '--device', 'cpu']) == 0
    out = capsys.readouterr().out
    assert 'dim=514 n_train=12165 chains=12' in out
    grad = re.search(rf'value_and_grad \(12 chains\): {NUMBER} ms', out)
    leap = re.search(rf'leapfrog \(12 chains\): {NUMBER} ms/step', out)
    tree = re.search(rf'mean tree size: {NUMBER} leapfrogs/draw', out)
    assert all(np.isfinite(float(m.group(1))) and float(m.group(1)) > 0
               for m in (grad, leap, tree))
    assert re.search(r'NUTS run: 2 draws x 12 chains in [0-9.]+s \(incl. '
                     r'3-step window adaptation\)', out)
    assert re.search(rf'acceptance {NUMBER}, divergent', out)


def test_tune_members_runs_the_trainers_tuner(tmp_path, capsys):
    """``torch_tune_members.py`` on a 3-member warm start of the airfoil
    config, 50 tuner steps: one JSON line whose ε and L are the port's
    tuner's on the same members with the run's sample stream, bit for bit;
    without ``--device cpu`` and a GPU it raises."""
    import torch_tune_members

    from mile_tpu_torch.config import Config
    from mile_tpu_torch.mcmc.adaptation.mclmc_tuning import mclmc_tune
    from mile_tpu_torch.train.sampling import tuning_config
    from mile_tpu_torch.train.trainer import BDETrainer
    from mile_tpu_torch.utils.keys import experiment_keys

    config = 'configs/illustrative_airfoil_mclmc.yaml'
    (cfg,) = Config.from_file(ROOT / config)
    cfg = cfg.replace(**{'saving_dir': str(tmp_path), 'experiment_name': 'ws',
                         'rng': 2, 'training.warmstart.max_epochs': 2,
                         'training.sampler.n_chains': 3,
                         'training.sampler.warmup_steps': 50})
    trainer = BDETrainer(cfg, device='cpu')
    members = trainer.train_warmstart()
    x, y = trainer.loader.arrays('train')
    _, want = mclmc_tune(trainer.bayes.logdensity_and_grad_fn(x, y),
                         members.clone(), experiment_keys(2).sample,
                         tuning_config(cfg.training.sampler))
    args = ['--config', str(ROOT / config), '--members', str(trainer.exp_dir),
            '--steps', '50', '--set', 'rng=2', '--set',
            'training.sampler.n_chains=3']
    assert torch_tune_members.main([*args, '--device', 'cpu']) == 0
    (line,) = capsys.readouterr().out.splitlines()
    record = json.loads(line)
    assert record['dim'] == 674 and record['phase3_draws'] == 5
    assert record['tuner_arithmetic'] == 'float32'
    assert record['step_size'] == want.step_size.double().tolist()
    assert record['L'] == want.L.double().tolist()
    assert record['L_mean'] == pytest.approx(want.L.double().mean().item())
    assert len(record['ess_harmonic']) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            torch_tune_members.main(args)


def test_the_kernel_times_script_parses_its_shapes():
    """``experiments/torch_kernel_times.py``: ``--shapes`` parses to
    (chains, dim) pairs, and without a GPU it exits 1 before it times
    anything."""
    import torch_kernel_times as kt

    assert kt.parse_shapes('12x426,1x674') == [(12, 426), (1, 674)]
    assert kt.parse_shapes('12x5426,') == [(12, 5426)]
    if not torch.cuda.is_available():
        proc = subprocess.run(
            [sys.executable, str(ROOT / 'experiments' /
                                 'torch_kernel_times.py'), '--root',
             str(ROOT), '--shapes', '12x426'],
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 1 and 'no CUDA device' in proc.stderr
