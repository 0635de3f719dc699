"""The benchmark of aptai_tpu_torch: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Runs from the root of a checkout on a machine with the cards the cell asks
for, and prints one JSON object as the last line of standard output (see
``port_bench/core.py`` and PERF.md). With no card it exits non-zero and
prints no result.
"""

import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this directory, so that a module here never
# shadows one of the standard library
sys.path[0] = str(ROOT)

from port_bench import core  # noqa: E402

if __name__ == "__main__":
    core.cache_dirs(ROOT)
    sys.exit(core.main(started=STARTED, root=ROOT))
