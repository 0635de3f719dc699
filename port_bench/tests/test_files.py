"""The benchmark's files: every configuration and workload parses and agrees
with ``BENCHMARK.json``, which keeps to its contract's shape."""

import json
import re

import pytest

from port_bench.core import ROOT, Cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_parse(cell):
    c = Cell(cell)
    assert c.workload["config"] == c.entry["config"]
    assert set(c.workload["limits"]) and all(
        v > 0 for v in c.workload["limits"].values())
    assert hasattr(c.kind_module, "Kind")
    for m in c.per_layer():
        assert callable(c.reader(m["name"]))
    e2e = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer()


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"] == []
    from port_bench.weights import backbone_config

    wcfg = backbone_config(body)
    assert (wcfg.hidden_size, wcfg.num_hidden_layers,
            wcfg.num_attention_heads, wcfg.intermediate_size) == (
                1024, 24, 16, 4096)
