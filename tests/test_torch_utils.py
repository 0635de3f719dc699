"""aptai_tpu_torch's ``utils`` against the JAX package's, on the CPU: the
step timer's statistics, the profiler context (a trace written, nothing
when disabled, the body's own exception propagating), the tree counts of
a model's converted parameters, the host fetch's pass-through of host
leaves, the int8 peak table, and the F0 plot with its deferred
matplotlib import."""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from aptai_tpu.utils import plotting as jplotting
from aptai_tpu.utils import profiling as jprofiling
from aptai_tpu.utils import trees as jtrees
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models.convert import (state_dict_from_jax,
                                            w2v2_pr_state_dict_from_jax)
from aptai_tpu_torch.train import checkpoints as tckpt
from aptai_tpu_torch.utils import flops as tflops
from aptai_tpu_torch.utils import plotting as tplotting
from aptai_tpu_torch.utils import profiling as tprofiling
from aptai_tpu_torch.utils import trees as ttrees

from _torch_port import random_jax_aptai_params, random_jax_w2v2_pr_params

REPO = Path(__file__).resolve().parent.parent


def _timed(timer_cls, warmup, durations, monkeypatch):
    """A timer of ``timer_cls`` over blocks lasting ``durations``, on a
    clock that advances by exactly those."""
    clock = iter(np.cumsum([0.0] + [x for d in durations
                                    for x in (d, 1.0)]).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timer = timer_cls(warmup_steps=warmup)
    for _ in durations:
        with timer:
            pass
    monkeypatch.undo()
    return timer


@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_step_timer_summary_matches_jax(monkeypatch, warmup):
    """The same four block times give the JAX timer's summary (warmup
    blocks untimed; ``p50`` is ``sorted[len // 2]``); an empty timer's
    statistics are NaN in both."""
    durations = [0.5, 0.125, 0.25, 0.375]
    got = _timed(tprofiling.StepTimer, warmup, durations, monkeypatch)
    want = _timed(jprofiling.StepTimer, warmup, durations, monkeypatch)
    assert got.times == want.times == durations[warmup:]
    g, w = got.summary(units_per_step=40.0), want.summary(40.0)
    assert list(g) == list(w)
    for k in w:
        assert g[k] == w[k] or (np.isnan(g[k]) and np.isnan(w[k])), k
    empty = tprofiling.StepTimer().summary()
    assert empty["steps_timed"] == 0
    assert all(np.isnan(empty[k]) for k in list(empty)[1:])


def test_trace_profile_writes_a_trace_on_the_cpu(tmp_path):
    """A TensorBoard-loadable ``*.pt.trace.json`` naming the block's ops."""
    with tprofiling.trace_profile(tmp_path):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert "aten::matmul" in traces[0].read_text()


def test_trace_profile_disabled_does_nothing(tmp_path, monkeypatch):
    def no_profiler(*a, **k):
        raise AssertionError("the profiler was started")

    monkeypatch.setattr(torch.profiler, "profile", no_profiler)
    ran = []
    with tprofiling.trace_profile(tmp_path / "off", enabled=False):
        ran.append(1)
    assert ran == [1] and not (tmp_path / "off").exists()


def test_trace_profile_lets_the_body_raise(tmp_path, monkeypatch, capsys):
    """The deliberate divergence (ROADMAP Queue 3): the block's own
    exception propagates, where the JAX package's context catches it and
    yields a second time, which ``contextlib`` turns into a
    ``RuntimeError``. A profiler that cannot start is the one failure
    caught: the block runs untraced."""
    with pytest.raises(ValueError, match="the body's"):
        with tprofiling.trace_profile(tmp_path / "port"):
            raise ValueError("the body's")

    class _NoTrace:
        def __init__(self, log_dir):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    import jax

    monkeypatch.setattr(jax.profiler, "trace", _NoTrace)
    with pytest.raises(RuntimeError, match="didn't stop after throw"):
        with jprofiling.trace_profile(tmp_path / "jax"):
            raise ValueError("the body's")

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with tprofiling.trace_profile(tmp_path / "broken"):
        ran.append(1)
    assert ran == [1]
    assert "profiling unavailable (no profiler here)" in capsys.readouterr().out


@pytest.mark.parametrize("family", ["aptai", "w2v2_pr"])
def test_param_count_and_tree_bytes_match_jax(family):
    """A tiny model's JAX parameters and the state dict the bridge makes of
    them count the same elements and bytes; an Adam state's counts hold
    its step scalars and both moments."""
    cfg = tcfg.tiny_config()
    if family == "aptai":
        params = random_jax_aptai_params(cfg, 11, seed=2)
        sd = state_dict_from_jax(params)
    else:
        params = random_jax_w2v2_pr_params(cfg, seed=2)
        sd = w2v2_pr_state_dict_from_jax(params)
    assert ttrees.param_count(sd) == jtrees.param_count(params)
    assert ttrees.tree_bytes(sd) == jtrees.tree_bytes(params)
    tensors = {k: torch.zeros_like(v) for k, v in sd.items()}
    opt = torch.optim.Adam(tensors.values())
    for p in opt.param_groups[0]["params"]:
        p.grad = torch.ones_like(p)
    opt.step()
    state = opt.state_dict()["state"]
    n = ttrees.param_count(sd)
    assert ttrees.param_count(state) == 2 * n + len(sd)
    assert ttrees.tree_bytes(state) == 4 * (2 * n + len(sd))


def test_fetch_pytree_passes_host_leaves_through():
    """Host tensors come back detached (the same storage), numpy arrays,
    scalars and ``None`` as they are, mappings as dicts and sequences as
    their type; the checkpoint writer's host copy is this function."""
    w = torch.ones(3, requires_grad=True)
    a = np.arange(4)
    tree = {"w": w, "deep": {"a": a, "s": 2.5, "none": None},
            "seq": [torch.zeros(2), (1, "x")]}
    out = ttrees.fetch_pytree(tree)
    assert type(out) is dict and type(out["seq"]) is list
    assert type(out["seq"][1]) is tuple and out["seq"][1] == (1, "x")
    assert not out["w"].requires_grad
    assert out["w"].data_ptr() == w.data_ptr()
    assert out["deep"]["a"] is a and out["deep"]["s"] == 2.5
    assert out["deep"]["none"] is None
    assert tckpt.to_host is ttrees.fetch_pytree


def test_device_peak_int8_tops(monkeypatch):
    """The H100 SXM's dense int8 peak by its name, no guess for another
    card; with no argument, CUDA device 0's name."""
    assert tflops.device_peak_int8_tops("NVIDIA H100 80GB HBM3") == 1979.0
    assert tflops.device_peak_int8_tops("NVIDIA A100-SXM4-80GB") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tflops.device_peak_int8_tops() == 1979.0
    assert tflops.device_peak_int8_tops(0) == 1979.0


def test_plot_f0_wav_draws_the_jax_figure(tmp_path):
    """The same curves, labels and title as the JAX package's figure, saved
    to the path given."""
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    f0 = 100 + 20 * rng.random(20)
    wav = rng.standard_normal(20 * 256) * 0.1
    figs = [mod.plot_f0_wav(f0, wav, 16000, save_path=tmp_path / f"{n}.png")
            for n, mod in (("port", tplotting), ("jax", jplotting))]
    assert (tmp_path / "port.png").stat().st_size > 0

    def drawn(fig):
        return [(ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                 [(ln.get_color(), ln.get_xdata().tolist(),
                   ln.get_ydata().tolist()) for ln in ax.get_lines()])
                for ax in fig.axes]

    assert drawn(figs[0]) == drawn(figs[1])


def test_utils_import_loads_no_matplotlib():
    """Importing the package's utils (and its re-exports) in a fresh
    process leaves matplotlib unloaded."""
    code = ("import sys; import aptai_tpu_torch.utils as u; "
            "from aptai_tpu_torch.utils import (RunLogger, init_logger, "
            "plot_f0_wav, StepTimer, trace_profile, param_count, "
            "tree_bytes); print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'matplotlib'), u.__all__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("[] ['RunLogger', 'init_logger', "
                                 "'plot_f0_wav', 'StepTimer', "
                                 "'trace_profile', 'param_count', "
                                 "'tree_bytes']"), out.stdout
