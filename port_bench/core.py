"""The harness: finds a cell's files by name, runs its traffic kind, reads the
per-layer metrics, and prints the result line.

A run, in order: set-up (the kind builds the program, its weights from the
seed and its inputs, and warms up every shape the cell's traffic uses), the
measured window of ``--seconds``, with ``--trace 1`` a traced segment under
the profiler, then the correctness check against the plain reference, and
the last line of standard output: one JSON object.

Everything that belongs to one configuration, cell, traffic kind or
per-layer metric is a file of its own, found by the name ``BENCHMARK.json``
gives:

* ``configs/<config>.json``: the configuration as it is run;
* ``workloads/<cell>.json``: the cell's config, traffic mix, traffic kind,
  the kind's parameters and the correctness limits;
* ``traffic/<kind>.py``: a class ``Kind`` (see :class:`KindBase`);
* ``metrics/<metric>.py``: ``read(obs) -> float | None``, ``obs`` being the
  observations the kind and the trace made (:mod:`port_bench.trace`).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the top-level modules no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "aptai_tpu")


class Refused(RuntimeError):
    """A run that cannot give a result: it exits non-zero, printing none."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A module of the benchmark by file path (names may hold dots and
    dashes)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One cell's entries and files, found by name."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        self.bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise Refused(f"no cell {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        bench_dir = root / self.bench["paths"][0]
        self.dir = bench_dir
        self.workload = load_json(bench_dir / "workloads" / f"{name}.json")
        for key in ("config", "traffic"):
            if self.workload[key] != self.entry[key]:
                raise Refused(f"workloads/{name}.json says {key} "
                              f"{self.workload[key]!r}, BENCHMARK.json "
                              f"{self.entry[key]!r}")
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(root / configs[self.entry["config"]]["file"])
        self.kind_module = load_module(
            bench_dir / "traffic" / f"{self.workload['kind']}.py",
            f"port_bench_kind_{self.workload['kind']}")

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        mine = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.bench["per_layer"]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif m["moves"] in mine:
                out.append(m)
        return out

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           f"port_bench_metric_{metric}").read


class KindBase:
    """A traffic kind. ``__init__(run)`` is the set-up: it builds the
    program and the inputs and warms up every shape the traffic uses.
    ``window(seconds)`` runs the measured window and returns the end-to-end
    values by metric name (``setup_s`` aside); ``traced()`` runs the traced
    segment under the profiler; ``free()`` drops the program's state;
    ``check()`` compares with the reference and returns the numbers
    compared, each ``(name, value, limit)``. ``obs`` collects what the
    per-layer readers read."""

    def __init__(self, run: "Run"):
        self.run = run
        self.obs: Dict[str, object] = {}

    def window(self, seconds: float) -> Dict[str, float]:
        raise NotImplementedError

    def traced(self) -> None:
        raise NotImplementedError

    def free(self) -> None:
        pass

    def check(self) -> List[Tuple[str, float, float]]:
        raise NotImplementedError


class Run:
    """One run's arguments and its cell."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, started: float):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.started = started
        self.params = cell.workload["params"]
        self.cfg = cell.config
        self.limits = cell.workload["limits"]
        self.phases: List[Tuple[str, float]] = []
        self.kernels: Dict[str, dict] = {}  # the port's kernels, traced

    def phase(self, name: str) -> None:
        """Mark the end of a step of set-up (printed to standard error)."""
        self.phases.append((name, time.perf_counter() - self.started))

    def seed_for(self, purpose: str) -> int:
        """A seed of its own for each use, from the run's seed."""
        import zlib

        return (self.seed * 1_000_003 + zlib.crc32(purpose.encode())) % (
            1 << 62)


def forbidden_loaded() -> List[str]:
    """The forbidden top-level modules in ``sys.modules``, compared by
    whole top-level name."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def device_info(device: str) -> dict:
    """The result's ``device``: a run uses one card."""
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def check_line(numbers: List[Tuple[str, float, float]]) -> Tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at most its
    limit, and finite."""
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in numbers)
    # JSON has no infinity: a number that could not be read prints so
    return ok and bool(numbers), {
        n: {"value": v if math.isfinite(v) else "not finite", "limit": lim}
        for n, v, lim in numbers}


def execute(run: Run) -> dict:
    """Set-up, window, traced segment, check: the result object."""
    cell = run.cell
    run.phase("imports, the cell's files")
    kind = cell.kind_module.Kind(run)
    setup_s = time.perf_counter() - run.started
    values = kind.window(run.seconds)
    attempted = int(kind.obs.get("attempted", 0))
    failed = int(kind.obs.get("failed", 0))
    metrics: Dict[str, dict] = {}
    if run.trace:
        from port_bench import trace

        trace.traced_segment(kind)
        kind.obs["cfg"] = run.cfg
        run.kernels = {k: v for k, v in kind.obs["kernels"].items()
                       if any(n in k for n in ("flash", "fused_conv",
                                               "dgrad"))}
        for m in cell.per_layer():
            value = cell.reader(m["name"])(kind.obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values["setup_s"] = setup_s
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    info = device_info(run.device)
    if run.trace:
        info["busy_s"] = kind.obs["busy_s"]
        info["window_s"] = kind.obs["window_s"]
    kind.free()
    numbers = kind.check()
    correct, compared = check_line(numbers)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": info}
    if run.trace and "breakdown" in kind.obs:
        result["breakdown"] = kind.obs["breakdown"]
    result["compared"] = compared
    return result


def main(argv: Optional[List[str]] = None, started: Optional[float] = None,
         device: Optional[str] = None, root: Path = ROOT) -> int:
    """The command line: ``--workload --seed --seconds --trace``. Prints
    the result as the last line of standard output and the numbers
    compared as the last lines of standard error."""
    import argparse

    started = time.perf_counter() if started is None else started
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Cell(args.workload, root)
        if device is None:
            device = cuda_device(cell.entry["chips"])
        run = Run(cell, args.seed, args.seconds, bool(args.trace), device,
                  started)
        result = execute(run)
    except Refused as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    found = forbidden_loaded()
    if found:
        print(f"port_bench: the run holds {found} in sys.modules",
              file=sys.stderr)
        return 3
    for name, at in run.phases:
        print(f"set-up: {name} done at {at:.3f} s", file=sys.stderr)
    for name, rec in sorted(run.kernels.items()):
        print(f"traced kernel {name[:90]}: {rec['seconds']:.6f} s in "
              f"{rec['launches']} launches", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


def cuda_device(chips: int) -> str:
    """The card, or a refusal when there are fewer cards than the cell
    asks for: a run never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards, "
                      f"{torch.cuda.device_count()} are present")
    return "cuda"


class float32_numerics:
    """Plain float32 products for the reference: TF32 off in matmuls and
    cuDNN, restored after."""

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        import torch

        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def cache_dirs(root: Path = ROOT) -> None:
    """The run's environment, set before torch is imported: build caches
    inside the checkout at fixed paths (the port's own kernels build into
    ``aptai_tpu_torch/_build`` there), no JAX for any library."""
    cache = root / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

