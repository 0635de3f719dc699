"""The readings the correctness limits are set from, for one cell, on several
seeds in one process (run it on the card; it is not a benchmark run):

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3
        [--seconds 3] [--out chiprun_out/calibrate.jsonl]

For each seed, after the cell's set-up and a window of ``--seconds``:

* ``program``: the numbers a run compares (the program against the
  reference);
* ``control``: the same numbers for the control, the reference computed
  a precision below the configuration's bf16 (every product through
  float8, ``reference/encoder.py``) in the program's place; serving also
  reads the program's own int8 path (``quant="w8a8"``, ``program_w8a8``),
  which quantizes only the FFN and the attention's projections;
* training's ``half_batch`` fault: the reference that leaves out half of
  each batch and takes its means over the rest, in the program's place. (A
  step that leaves its state unchanged reads 1 in ``update_gap`` with no
  run.)
* with ``--what f32``, training only: the program computing in float32
  (``dtype="float32"``), a witness that sides with the reference or not.

One JSON line a reading, on standard output and appended to ``--out``.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from port_bench import compare, core  # noqa: E402


def readings(run, what: str):
    """(what, numbers) pairs for one seed."""
    cell = run.cell
    kind_name = cell.workload["kind"]
    out = []
    if kind_name == "train_steps":
        if what == "f32":  # a witness: the program computing in float32
            kind = cell.kind_module.Kind(run, {"dtype": "float32"})
            kind.free()
            return [("program_f32", compare.train_gaps(kind.prog,
                                                       kind.reference()))]
        kind = cell.kind_module.Kind(run)
        kind.free()
        ref = kind.reference()
        out.append(("program", compare.train_gaps(kind.prog, ref)))
        if what in ("all", "control"):
            out.append(("control", compare.train_gaps(
                kind.reference("fp8"), ref)))
            b = run.params["batch"]
            out.append(("half_batch", compare.train_gaps(
                kind.reference(rows=range(b // 2)), ref)))
        return out
    kind = cell.kind_module.Kind(run)
    kind.window(run.seconds)
    kind.free()
    out.append(("program", {n: v for n, v, _ in kind.check()}))
    if what in ("all", "control"):
        out.append(("control", {n: v for n, v, _ in
                                kind.check(control=True)}))
        del kind
        # the program's own int8 path, which reads too near bf16 to serve
        # as the control (PERF.md)
        kind = cell.kind_module.Kind(run, {"quant": "w8a8"})
        kind.window(run.seconds)
        kind.free()
        out.append(("program_w8a8", {n: v for n, v, _ in kind.check()}))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--what", default="all",
                    choices=("all", "control", "program", "f32"))
    ap.add_argument("--out", default="chiprun_out/calibrate.jsonl")
    args = ap.parse_args()
    core.cache_dirs(ROOT)
    cell = core.Cell(args.workload, ROOT)
    device = core.cuda_device(cell.entry["chips"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = core.Run(cell, seed, args.seconds, False, device,
                       time.perf_counter())
        for label, numbers in readings(run, args.what):
            line = json.dumps({"cell": args.workload, "seed": seed,
                               "reading": label, "numbers": numbers})
            print(line, flush=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
