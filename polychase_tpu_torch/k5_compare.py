"""The ray cast's time in a checkout of this repository, on a CUDA card.

Usage, on a machine with a CUDA card, once per checkout to compare:

    python3 polychase_tpu_torch/k5_compare.py ROOT [--plans]

ROOT is the root of a checkout (``.``, or a ``git archive`` of another
commit unpacked into a directory that ``.gitignore`` lists).  The script
imports ``polychase_tpu_torch`` and ``chip_smoke`` from ROOT and, on the same
seeded scenes, times ROOT's ``engine.raycast.raycast_grouped`` (the entry
point every design of the cast has) with one harness: CUDA events around 20
calls queued behind a device sleep.  The scenes: a tracking frame's shape
(4 groups of 2048 rays over the 80×128 UV sphere, 20,224 triangles), the
same with 48 rays a group, config 4's prim refresh (250 × 128 rays over
the 24×32 sphere, 1,472 triangles) and its rays as 32,000 groups of one.
For each it prints the time and what one call queued and ran on the device
(``device_work`` of the ``timing.py`` beside this script, under
``torch.profiler``): the launches, copies and fills, and the kernels by
name with their times.  Then the digest of config 4's refine truth DB as
ROOT's ``chip_smoke.refine_inputs`` casts it (through the plain route on
the card in checkouts before the grid cast, on a CPU copy of the mesh
since), so that two checkouts can be shown to write the same bits.
``--plans`` also times ROOT's K5 call (``kernels.raycast_sweep``'s
``raycast_hits``, which ROOT must have) at its own launch plan and at
forced ones (rays a thread × cluster) on the four scenes.  Run it for two
checkouts in turns (A, B, B, A) within one call to compare them.
"""

from __future__ import annotations

import hashlib
import runpy
import sqlite3
import subprocess
import sys
import tempfile
from pathlib import Path

REPS = 20


def db_digest(path) -> str:
    """sha256 of every row of every table of a flow DB, in rowid order."""
    h = hashlib.sha256()
    con = sqlite3.connect(path)
    try:
        tables = [r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table' "
            "ORDER BY name")]
        for table in tables:
            h.update(table.encode())
            for row in con.execute(f"SELECT * FROM {table} ORDER BY rowid"):
                h.update(repr(row).encode())
    finally:
        con.close()
    return h.hexdigest()


def scene(device, G, K, sphere, seed=0):
    import numpy as np
    import torch
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.synthetic import uv_sphere

    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, G)
    o = np.stack([4 * np.sin(ang), rng.uniform(-0.5, 0.5, G),
                  -4 * np.cos(ang)], -1).astype(np.float32)
    d = (rng.normal(size=(G, K, 3)) * 0.7 - o[:, None]).astype(np.float32)
    mesh = Mesh.create(*uv_sphere(*sphere), device=device)
    return (mesh, torch.as_tensor(o, device=device),
            torch.as_tensor(d, device=device))


def main() -> None:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k5_compare: no CUDA device; this runs only on a "
                         "GPU")
    import chip_smoke as cs
    from polychase_tpu_torch.engine import raycast as R

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; checkout {root}")
    device = torch.device("cuda")
    # timing.py beside this script (it imports nothing of the port), so
    # that every checkout is timed by one harness.
    timing = runpy.run_path(Path(__file__).with_name("timing.py"))
    event_ms, device_work = timing["event_ms"], timing["device_work"]
    frame = scene(device, 4, 2048, (80, 128))
    k48 = scene(device, 4, 48, (80, 128))
    refresh = scene(device, 250, 128, (24, 32))
    mesh, o, d = refresh
    n = 32_000
    flat = (mesh, o[:, None, :].expand(d.shape).reshape(-1, 3)[:n]
            .contiguous(), d.reshape(-1, 1, 3)[:n].contiguous())
    scenes = (("tracking frame", frame), ("tracking frame, K 48", k48),
              ("config 4 refresh", refresh), ("groups of one ray", flat))
    for label, (mesh, o, d) in scenes:
        whole = event_ms(lambda: R.raycast_grouped(mesh, o, d),
                                REPS)
        queued, ran, _ = device_work(lambda: R.raycast_grouped(mesh, o, d))
        print(f"  {label} (G {d.shape[0]}, K {d.shape[1]}, T "
              f"{mesh.num_triangles}): raycast_grouped {whole:.4f} ms; one "
              f"call queued {len(queued)} launches, copies and fills; the "
              f"device ran {len(ran)}, {sum(ms for _, ms in ran):.4f} ms in "
              f"all: " + ", ".join(f"{name[:40]} {ms:.4f}" for name, ms in
                                   sorted(ran, key=lambda x: -x[1])[:4]))
    if "--plans" in sys.argv[2:]:
        from polychase_tpu_torch.kernels import raycast_sweep as RS

        for label, (mesh, o, d) in scenes:
            args = (o, d, mesh.vertices, mesh.triangles,
                    mesh.masked_triangles, True)
            G, K = d.shape[:2]
            chosen = RS.launch_plan(G, K, mesh.num_triangles,
                                    RS._sm_count(device))
            ms = event_ms(lambda: RS.raycast_hits(*args), REPS)
            print(f"  {label} at launch_plan's {chosen}: {ms:.4f} ms")
            packed = K < RS.PACKED_BELOW
            for r in (4,) if packed else (2, 4):
                per = 32 * r
                blocks = -(-G * K // per) if packed else -(-K // per)
                for c in (1, 2, 4, 8):
                    plan = RS.Plan(r, packed, blocks, c)
                    ms = event_ms(lambda: RS._launch(*args, plan),
                                         REPS)
                    print(f"  {label} at {plan}: {ms:.4f} ms")
    with tempfile.TemporaryDirectory() as workdir:
        refine, _ = cs.refine_inputs(device, workdir)
        print(f"  config 4's refine truth DB, as ROOT's refine_inputs "
              f"casts it: sha256 {db_digest(refine['db'])}")


if __name__ == "__main__":
    main()
