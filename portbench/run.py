"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA devices.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks``: each number compared beside its limit); the
same comparisons end standard error.  See ``portbench/README.md``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# One host thread for the program's CPU work.  Under torch's default pool
# (8 threads on one H100's host) refine's host loop ran slower and spread
# five times wider between runs: PERF.md, section 6.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
