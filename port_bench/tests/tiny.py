"""A checkout in miniature for the CPU tests: a ``BENCHMARK.json`` of tiny
cells beside new configuration and workload files, the benchmark's own
traffic kinds and per-layer readers reached through links. It adds files and
edits none, as a later change that adds a cell would."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# PyTorch's CPU bf16 grouped conv1d is wrong at 8 and 4 channels a group
# (kernel 16): the positional conv here has 2
TINY = {
    "hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 2,
    "intermediate_size": 256, "conv_dim": [128, 128, 128],
    "conv_kernel": [10, 3, 3], "conv_stride": [5, 2, 2],
    "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 64,
}

TINY_PARAMS = {
    "serve_closed": {"batch": 4, "min_s": 0.2, "max_s": 1.4,
                     "pool_batches": 3, "ahead": 2,
                     "fields": ["tvs_pred", "phn_fc_logits"],
                     "trace_batches": 2, "check_batches": 2},
    "train_steps": {"batch": 4, "min_s": 0.2, "max_s": 0.9,
                    "pool_batches": 4, "check_steps": 3, "trace_steps": 1,
                    "labels_per_s": 12.0},
}

# the tiny models in bf16 on the CPU against the float32 reference: loose,
# for tests of faults that read far above them
TINY_LIMITS = {"tv_err": 0.05, "logit_err": 0.05, "loss_gap": 0.02,
               "loss1_gap": 0.02, "grad_gap": 0.1, "update_gap": 0.1}


def tiny_config(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(TINY)
    cfg["name"] = f"tiny-{name}"
    return cfg


def make_root(tmp: Path, extra_metrics=()) -> Path:
    """A checkout at ``tmp``: the real cells' entries, with tiny files."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = tmp / "port_bench"
    (out / "configs").mkdir(parents=True)
    (out / "workloads").mkdir()
    (out / "traffic").symlink_to(BENCH / "traffic")
    (out / "metrics").mkdir()
    for f in (BENCH / "metrics").glob("*.py"):
        (out / "metrics" / f.name).symlink_to(f)
    for name, body in extra_metrics:
        (out / "metrics" / f"{name}.py").write_text(body)
    for c in bench["configs"]:
        (out / "configs" / Path(c["file"]).name).write_text(
            json.dumps(tiny_config(c["name"])))
    for w in bench["workloads"]:
        spec = json.loads((BENCH / "workloads" /
                           f"{w['name']}.json").read_text())
        params = copy.deepcopy(TINY_PARAMS[spec["kind"]])
        if "rate_metric" in spec["params"]:
            params["rate_metric"] = spec["params"]["rate_metric"]
        spec["params"] = params
        spec["limits"] = {k: TINY_LIMITS[k] for k in spec["limits"]}
        (out / "workloads" / f"{w['name']}.json").write_text(
            json.dumps(spec))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
