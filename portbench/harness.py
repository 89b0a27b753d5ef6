"""The benchmark's harness: everything found by name from ``BENCHMARK.json``.

A cell (``workloads``) names a configuration and a traffic mix.  The
harness reads the configuration's file (``configs/<config>.json``) and the
mix's (``traffic/<mix>.json``); the mix names the entry of the program it
drives, whose module (``calls/<call>.py``) makes the calls, reads the
end-to-end numbers from them and compares what they produced with the
plain reference.  Each per-layer metric is a module of its own,
``metrics/<metric>.py``, whose ``read(ctx)`` returns its number or None.
The limits that decide ``correct`` are the cell's data too,
``limits/<cell>.json``.  A new configuration, mix, entry, metric or cell
adds files and edits none.

A run makes its inputs from the seed, loads the program from the checkout
(its kernels build into ``build/`` there), makes one warm-up call, then
calls back to back for ``seconds`` (with ``trace``, for the mix's
``trace_calls`` calls under ``torch.profiler``), and only then, with the
program's state freed, compares a sample of what the window produced with
the plain reference.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "polychase_tpu")
PROGRAM = "polychase_tpu_torch"


def load_module(path: Path):
    """The module in ``path`` (its name may hold dots, as a metric's
    does)."""
    name = "portbench_" + path.parent.name + "_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    call: object           # the module calls/<call>.py
    end_to_end: list       # the cell's end-to-end metric entries
    per_layer: list        # the cell's per-layer metric entries
    limits: dict
    metric_files: dict     # per-layer metric name → its reader's file


def _applies(entry: dict, cell: str, reported) -> bool:
    """An end-to-end metric applies where it lists the cell, or lists
    none; a per-layer one, where it lists the cell, or lists none and the
    cell reports the metric it moves."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry["moves"] in reported


def resolve(bench: dict, cell_name: str, root: Path = HERE,
            checkout: Path = ROOT) -> Cell:
    """The cell ``cell_name`` of ``bench`` with every file it names, under
    the benchmark's folder ``root`` of ``checkout``."""
    work = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in work:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    w = work[cell_name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = read_json(checkout / cfg["file"])
    traffic = read_json(root / "traffic" / f"{w['traffic']}.json")
    call = load_module(root / "calls" / f"{traffic['call']}.py")
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell_name, None)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, cell_name, names)]
    limits = read_json(root / "limits" / f"{cell_name}.json")
    files = {m["name"]: root / "metrics" / f"{m['name']}.py" for m in layer}
    for path in files.values():
        if not path.is_file():
            raise FileNotFoundError(path)
    return Cell(cell_name, config, traffic, call, e2e, layer, limits, files)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_program(root: Path = ROOT):
    """Import the program from ``root`` and nowhere else."""
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import importlib

    mod = importlib.import_module(PROGRAM)
    where = Path(mod.__file__).resolve()
    if root not in where.parents:
        raise ImportError(f"{PROGRAM} loaded from {where}, not from {root}")
    return mod


@dataclass
class Ctx:
    """What a per-layer metric reads: the trace and what the calls
    recorded (``layer``, from the call module's ``layer_context``)."""

    trace: object
    layer: dict = field(default_factory=dict)


@dataclass
class Outcome:
    result: dict
    checks: list   # [(name, value, limit)]
    notes: list    # lines for standard error
    scene: object  # the inputs the run made from its seed
    records: list  # what each call of the window recorded


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, calls: int | None = None) -> Outcome:
    """One run of ``cell``.  ``device`` is where the program runs: the card
    in a benchmark run, the CPU in the harness's own tests.  The window
    lasts ``seconds``, or with ``trace`` the mix's ``trace_calls`` calls,
    or ``calls`` calls where that is given (``calibrate.py``'s readings)."""
    import torch

    from portbench.gen.scene import make_scene, write_db

    notes = []
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        scene = make_scene(cell.config, seed)
        db_path = os.path.join(tmp, "flow.db")
        write_db(scene, db_path)
        check_program()
        caller = cell.call.Caller(scene, cell.config, cell.traffic, device,
                                  db_path, seed)
        cuda = torch.device(device).type == "cuda"

        def sync():
            if cuda:
                torch.cuda.synchronize(device)

        t_warm = time.perf_counter()
        caller.call(-1)  # the warm-up call: every shape the window uses
        sync()
        setup_s = time.perf_counter() - t_start
        notes.append(f"set-up {setup_s:.3f} s, of which the warm-up call "
                     f"{time.perf_counter() - t_warm:.3f} s")
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)

        records, failed = [], 0

        def window(limit_calls=None):
            nonlocal failed
            t0 = time.perf_counter()
            i = 0
            while True:
                try:
                    records.append(caller.call(i))
                except Exception as exc:  # a failed call: counted, shown
                    failed += 1
                    notes.append(f"call {i} failed: {exc!r}")
                sync()
                i += 1
                if limit_calls is not None:
                    if i >= limit_calls:
                        break
                elif time.perf_counter() - t0 >= seconds:
                    break
            return time.perf_counter() - t0

        tr = None
        if trace:
            from portbench.trace import traced

            window_s, tr = traced(
                lambda: window(cell.traffic["trace_calls"]), device)
        else:
            window_s = window(calls)
        attempted = len(records) + failed
        mem_peak = (torch.cuda.max_memory_allocated(device) if cuda else 0)

        metrics = {}
        if trace:
            ctx = Ctx(tr, caller.layer_context(records))
            for m in cell.per_layer:
                mod = load_module(cell.metric_files[m["name"]])
                v = mod.read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
        else:
            e2e = caller.end_to_end(records, window_s)
            e2e["setup_s"] = setup_s
            for m in cell.end_to_end:
                if m["name"] in e2e:
                    metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                          "unit": m["unit"]}
        notes.extend(caller.notes(records))

        caller.release()
        del caller
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = cell.call.check(scene, cell.config, cell.traffic, records,
                                 seed, device, cell.limits)
        notes.append(f"window {window_s:.3f} s; the reference's comparison "
                     f"{time.perf_counter() - t_check:.3f} s")
        if trace:
            labels = {k: round(v, 3) for k, v in tr.labels.items()
                      if k.startswith(("refine.", "bench."))}
            notes.append(f"label device ms: {labels}")
        correct = (failed == 0 and bool(records)
                   and all(v <= lim for _, v, lim in checks))
        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(device) if cuda
                                else "cpu"),
                       "count": 1, "memory_peak_bytes": int(mem_peak)}
        if trace:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
        result = {"correct": correct, "attempted": attempted,
                  "failed": failed, "metrics": metrics,
                  "device": device_info}
        if trace:
            result["breakdown"] = {"device_ops": tr.device_ops(),
                                   "idle_gaps": tr.idle_gaps}
        result["checks"] = {n: {"value": float(v), "limit": float(lim)}
                            for n, v, lim in checks}
        return Outcome(result, checks, notes, scene, records)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None, t_start=None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # The program's caches stay at fixed paths inside the checkout (its
    # kernels build into build/ there by themselves).
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

    bench = read_json(ROOT / "BENCHMARK.json")
    cell = resolve(bench, args.workload)
    work = {w["name"]: w for w in bench["workloads"]}[args.workload]

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < work["chips"]:
        print(f"portbench: the cell needs {work['chips']} CUDA device(s); "
              f"this process sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for line in out.notes:
        print(line, file=sys.stderr)
    for name, v, lim in out.checks:
        print(f"check {name} = {float(v)!r} (limit {float(lim)!r})",
              file=sys.stderr)
    print(json.dumps(out.result))
    return 0
