"""Whole runs at a tiny size on the CPU, past the harness's look for a card:
a cell, a configuration and a per-layer metric added as new files are
found; the import rule holds; and a run whose timed path is broken, or the
control put in the program's place, comes out not correct."""

import io
import json
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from port_bench import core
from port_bench.tests.tiny import ROOT, make_root

EXTRA = ("frames_served.serve", '''"""A metric added as a new file."""


def read(obs):
    return float(obs["traced_units"])
''')


def run_cell(root, cell, trace=0, seconds=1.5, seed=2**31 + 7):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = core.main(["--workload", cell, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       device="cpu", root=root)
    assert rc == 0, err.getvalue()[-2000:]
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1])


def add_cell(root):
    """A new configuration, a new cell and a new per-layer metric, as new
    files and new entries."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "port_bench/configs/aptai-large.json")
                     .read_text())
    cfg.update(name="aptai-narrow", num_hidden_layers=1)
    (root / "port_bench/configs/aptai-narrow.json").write_text(
        json.dumps(cfg))
    spec = json.loads((root / "port_bench/workloads/aptai-serve-offline.json")
                      .read_text())
    spec["config"] = "aptai-narrow"
    (root / "port_bench/workloads/narrow-offline.json").write_text(
        json.dumps(spec))
    bench["configs"].append({"name": "aptai-narrow", "source": "test",
                             "file": "port_bench/configs/aptai-narrow.json",
                             "reduced": ["num_hidden_layers"], "why": "t"})
    bench["workloads"].append({"name": "narrow-offline",
                               "config": "aptai-narrow",
                               "traffic": spec["traffic"], "chips": 1,
                               "why": "t"})
    bench["end_to_end"][0]["workloads"].append("narrow-offline")
    bench["per_layer"].append({"name": EXTRA[0], "unit": "batches",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "predictor",
                               "moves": "serve_audio_per_s",
                               "workloads": ["narrow-offline"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_are_found(tmp_path, one_thread):
    root = make_root(tmp_path, extra_metrics=[EXTRA])
    add_cell(root)
    res = run_cell(root, "narrow-offline", trace=1, seconds=4.0)
    assert res["correct"] is True
    assert res["metrics"][EXTRA[0]]["value"] >= 1
    assert list(res)[-1] == "compared"


def test_no_jax_in_a_run():
    """Every module of the benchmark imported in a fresh process, then a
    tiny run: no top-level jax, jaxlib, flax or aptai_tpu."""
    code = f"""
import sys, pathlib, importlib
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from port_bench import core
from port_bench.tests import tiny
for p in sorted(pathlib.Path({str(ROOT / 'port_bench')!r}).rglob('*.py')):
    if 'tests' in p.parts:
        continue
    core.load_module(p, 'm_' + p.stem.replace('.', '_').replace('-', '_'))
import tempfile
root = tiny.make_root(pathlib.Path(tempfile.mkdtemp()))
rc = core.main(['--workload', 'aptai-train', '--seed', '11',
                '--seconds', '0.5', '--trace', '0'], device='cpu', root=root)
print('LOADED', core.forbidden_loaded(), rc)
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert "LOADED [] 0" in res.stdout, res.stderr[-2000:]


def test_reference_imports_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import port_bench.reference.train, port_bench.reference.draws
print('TOPS', sorted({{m.split('.')[0] for m in sys.modules}}
                     & {{'aptai_tpu_torch', 'aptai_tpu', 'jax'}}))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert "TOPS []" in res.stdout, res.stderr[-2000:]


def test_refuses_without_a_card(tmp_path):
    """Without a card the command prints no result and exits non-zero."""
    root = make_root(tmp_path)
    res = subprocess.run(
        [sys.executable, str(ROOT / "port_bench/run.py"), "--workload",
         "aptai-serve-offline", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=root)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert res.returncode != 0 and res.stdout.strip() == ""


def _altered_predict(original):
    def predict(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        out["tvs_pred"] = out["tvs_pred"].clone()
        out["tvs_pred"][0] += 0.5 * out["tvs_pred"][0].abs().mean()
        return out
    return predict


def test_served_answer_altered_is_incorrect(tmp_path, monkeypatch,
                                            one_thread):
    from aptai_tpu_torch.models.aptai import APTAI

    root = make_root(tmp_path)
    # a window long enough to complete batches on a loaded CPU
    assert run_cell(root, "aptai-serve-offline", seconds=4.0)[
        "correct"] is True
    monkeypatch.setattr(APTAI, "predict", _altered_predict(APTAI.predict))
    assert run_cell(root, "aptai-serve-offline", seconds=4.0)[
        "correct"] is False


@pytest.mark.parametrize("cell", ["aptai-train", "w2v2pr-train"])
def test_step_leaving_state_unchanged_is_incorrect(cell, tmp_path,
                                                   monkeypatch, one_thread):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, c=None: None)
    res = run_cell(make_root(tmp_path), cell)
    assert res["correct"] is False
    value = res["compared"]["update_gap"]["value"]
    assert value == "not finite" or value >= 1.0


def test_dropout_at_another_rate_is_incorrect(tmp_path, monkeypatch,
                                              one_thread):
    """The program's dropout drawing at half the configured rate: the
    masks' kept share gives it away, whatever the losses read."""
    import torch.nn.functional as F

    dropout = F.dropout

    def halved(input, p=0.5, training=True, inplace=False):
        return dropout(input, p / 2, training, inplace)

    root = make_root(tmp_path)
    assert run_cell(root, "aptai-train")["correct"] is True
    monkeypatch.setattr(F, "dropout", halved)
    res = run_cell(root, "aptai-train")
    assert res["correct"] is False
    assert res["compared"]["loss_gap"]["value"] == "not finite"


@pytest.mark.parametrize("cell", ["aptai-train", "w2v2pr-train"])
def test_half_batch_is_incorrect(cell, tmp_path, monkeypatch, one_thread):
    """The loss over the first half of each batch, the mean over it."""
    from aptai_tpu_torch.train import harness

    forward = harness._LossModule.forward

    def half(self, batch, generator):
        b = next(iter(batch.values())).shape[0] // 2
        return forward(self, {k: v[:b] for k, v in batch.items()},
                       generator)

    root = make_root(tmp_path)
    monkeypatch.setattr(harness._LossModule, "forward", half)
    assert run_cell(root, cell)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", ["aptai-train", "w2v2pr-train"])
def test_training_control_is_incorrect(cell, card):
    """At the cell's own size on the card, with its own limits: the
    reference through float8 in the program's place is not correct."""
    from port_bench import compare

    c = core.Cell(cell)
    run = core.Run(c, 2**31 + 9, 1.0, False, card, 0.0)
    kind = c.kind_module.Kind(run)
    gaps = compare.train_gaps(kind.reference("fp8"), kind.reference())
    numbers = [(k, gaps[k], run.limits[k]) for k in run.limits]
    assert core.check_line(numbers)[0] is False, numbers
    assert np.isfinite([v for _, v, _ in numbers]).all()


@pytest.mark.card
@pytest.mark.parametrize("cell", ["aptai-serve-offline"])
def test_serving_control_is_incorrect(cell, card):
    """At the cell's own size on the card, with its own limits: the
    reference through fp8 in the program's place is not correct."""
    c = core.Cell(cell)
    run = core.Run(c, 2**31 + 9, 8.0, False, card, 0.0)
    kind = c.kind_module.Kind(run)
    kind.window(8.0)
    kind.free()
    numbers = kind.check(control=True)
    assert core.check_line(numbers)[0] is False, numbers


def test_serving_control_departs_at_tiny_size(tmp_path, one_thread):
    """The same at the CPU tests' tiny size, against their limits."""
    c = core.Cell("aptai-serve-offline", make_root(tmp_path))
    run = core.Run(c, 2**31 + 9, 3.0, False, "cpu", 0.0)
    kind = c.kind_module.Kind(run)
    kind.window(3.0)
    kind.free()
    numbers = kind.check(control=True)
    assert core.check_line(numbers)[0] is False, numbers
    assert core.check_line(kind.check())[0] is True
