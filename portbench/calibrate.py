"""The readings that a cell's limits are set from, in one process a cell.
For each seed, a run of the cell as the benchmark makes it, its window the
mix's ``trace_calls`` calls: the program's comparison with the reference;
on the first ``--control`` seeds also the control's, the reference itself
in the program's place, computed in float32 with TF32 matrix products
(the nearest precision below the configuration's float32 with TF32 off);
and with ``--faults``, the same run again with each fault of
``faults.py`` planted in the program.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        [--control 3] [--faults track.half ...] [--out FILE]

One JSON line a seed (``program``, ``control`` and ``fault.<name>``: each
compared number), to standard output and, with ``--out``, to that file.
It needs the cell's CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults as FAULTS  # noqa: E402
from portbench import harness as H  # noqa: E402


def numbers(checks):
    return {n: v for n, v, _ in checks}


def readings(cell, seed, device, control: bool, faults=()):
    calls = cell.traffic["trace_calls"]
    out = {"cell": cell.name, "seed": seed, "calls": calls}
    t0 = time.perf_counter()
    run = H.run_cell(cell, seed, 0.0, False, device, t0, calls=calls)
    out["program"] = numbers(run.checks)
    out["program_s"] = time.perf_counter() - t0
    if control:
        t0 = time.perf_counter()
        out["control"] = numbers(cell.call.check(
            run.scene, cell.config, cell.traffic, run.records, seed, device,
            cell.limits, control=True))
        out["control_s"] = time.perf_counter() - t0
    for name in faults:
        with FAULTS.planted(name):
            bad = H.run_cell(cell, seed, 0.0, False, device,
                             time.perf_counter(), calls=calls)
        out["fault." + name] = numbers(bad.checks)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=[],
                    choices=sorted(FAULTS.FAULTS))
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # as a run has it (run.py)
    cell = H.resolve(H.read_json(H.ROOT / "BENCHMARK.json"), args.workload)
    device = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None
    try:
        for k, seed in enumerate(args.seeds):
            line = json.dumps(readings(cell, seed, device,
                                       k < args.control, args.faults))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
