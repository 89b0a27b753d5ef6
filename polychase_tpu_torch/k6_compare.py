"""The grid cast's time in a checkout of this repository, on a CUDA card.

Usage, on a machine with a CUDA card, once per checkout to compare:

    python3 polychase_tpu_torch/k6_compare.py ROOT [--teams] [--counts] [--k5]

ROOT is the root of a checkout (``.``, or a ``git archive`` of another
commit unpacked into a directory that ``.gitignore`` lists).  The script
imports ``polychase_tpu_torch`` from ROOT and, on the same seeded scenes,
times ROOT's ``engine.gridcast.grid_raycast`` (the entry point every design
of K6 has, one launch a call) with one harness: ``event_ms`` of the
``timing.py`` beside this script, CUDA events around 20 calls queued behind
a device sleep.  The scenes are ``crossover``'s: a tracking frame's rays
(4 cameras of the clip × 2048 rays, as flat rays) on UV spheres of 1,472,
20,224, 399,000 and 1,998,000 triangles, and config 4's refresh rays (250
× 128) on the 1,472-triangle sphere; and two of ``chip_smoke.py``'s K6
scenes, made the same way from their own seed: 8192 rays into a soup of
20,000 triangles, and 4096 rays at a UV sphere over a huge ground
triangle, whose grid (33 × 43 × 1) holds the sphere in a few dense cells
among many of one candidate; the same ground under a 179,400-triangle
sphere (above ``raycast.GRID_TRIANGLE_THRESHOLD``) with 8192 rays, a soup
of 200,000 in the same box; and the frame on the benchmark's 1,087,716.
For each it prints the time and a digest of every field of the hits, so
that two checkouts can be shown to write the same bits; then the
registers and spills that ``nvcc`` reported for ROOT's kernel.

``--teams`` also times ROOT's K6 at each team width it has
(``kernels.grid_cast.TEAMS``, forced through ``_launch``), beside the width
``team_width`` picks.  ``--counts`` prints the work each scene's walks
take, from ROOT's ``grid_plain_counted`` (per-ray counts) on the card: the
candidate tests and the cell actions through empty and through full cells
a ray (mean, p99, max), the candidates a non-empty cell of the grid holds
(mean, p99, max), the grid's entries the walks read, and the bound
ROOT's ``chip_smoke.k6_bound`` gives.  ``--k5`` also times ROOT's K5
(``kernels.raycast_sweep.raycast_hits``) on each scene's rays as groups
of one, the sweep's cast of the same rays, with the share of equal ids.
Run it for two checkouts in turns (A, B, B, A) within one call to compare
them.
"""

from __future__ import annotations

import hashlib
import runpy
import subprocess
import sys
import time
from pathlib import Path

REPS = 20
SPHERES = ((24, 32), (80, 128), (400, 500), (564, 966), (1000, 1000))


def digest(hits) -> str:
    """sha256 of every field of the hits, on the host."""
    h = hashlib.sha256()
    for f in ("pos", "normal", "barycentric", "t", "prim_id", "valid"):
        h.update(getattr(hits, f).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def scenes(device):
    """(label, mesh, accel, origins, dirs, grid build ms) of each scene."""
    import numpy as np
    import torch
    from polychase_tpu_torch.crossover import _clip_rays
    from polychase_tpu_torch.engine import refiner as R
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.engine.gridcast import build_grid_accel
    from polychase_tpu_torch.synthetic import uv_sphere

    eye = torch.eye(4, device=device)

    def flat(groups, keypoints):
        data, params = _clip_rays(device, groups, keypoints)
        o, d = R._all_rays(params, data, eye)
        return (o[:, None, :].expand(d.shape).reshape(-1, 3).contiguous(),
                d.reshape(-1, 3).contiguous())

    def mesh_of(verts, tris):
        return Mesh.create(verts, tris, device=device)

    def from_sphere(n, radius, spread):
        o = rng.normal(size=(n, 3))
        o = radius * o / np.linalg.norm(o, axis=-1, keepdims=True)
        d = rng.normal(0, spread, (n, 3)) - o
        return (torch.as_tensor(o, dtype=torch.float32, device=device),
                torch.as_tensor(d, dtype=torch.float32, device=device))

    frame, refresh = flat(4, 2048), flat(250, 128)
    rng = np.random.default_rng(11)
    centers = rng.uniform(-2, 2, (20_000, 1, 3))
    soup = ((centers + rng.normal(0, 0.1, (20_000, 3, 3))).reshape(-1, 3),
            np.arange(60_000).reshape(-1, 3))
    hv, ht = uv_sphere(16, 24)
    hv = np.concatenate([hv, [[-50, -50, -2], [50, -50, -2], [0, 80, -2]]])
    huge = (hv, np.concatenate([ht, [[len(hv) - 3, len(hv) - 2,
                                      len(hv) - 1]]]))
    ho, hd = from_sphere(4096, 8.0, 0.8)
    hd[:1024] = torch.tensor([0.1, 0.05, -1.0])
    bv, bt = uv_sphere(300, 300)
    bv = np.concatenate([bv, [[-50, -50, -2], [50, -50, -2], [0, 80, -2]]])
    big = (bv, np.concatenate([bt, [[len(bv) - 3, len(bv) - 2,
                                     len(bv) - 1]]]))
    out = [("soup of 20,000", mesh_of(*soup),
            build_grid_accel(*soup, device=device),
            *from_sphere(8192, 6.0, 1.0), 0.0),
           ("huge triangle", mesh_of(*huge),
            build_grid_accel(*huge, device=device), ho, hd, 0.0)]
    bo, bd = from_sphere(8192, 8.0, 0.8)
    bd[:2048] = torch.tensor([0.1, 0.05, -1.0])
    out.append(("huge triangle under 179,400", mesh_of(*big),
                build_grid_accel(*big, device=device), bo, bd, 0.0))
    centers = rng.uniform(-2, 2, (200_000, 1, 3))
    soup2 = ((centers + rng.normal(0, 0.1, (200_000, 3, 3))).reshape(-1, 3),
             np.arange(600_000).reshape(-1, 3))
    out.append(("soup of 200,000", mesh_of(*soup2),
                build_grid_accel(*soup2, device=device),
                *from_sphere(8192, 6.0, 1.0), 0.0))
    for sphere in SPHERES:
        verts, tris = uv_sphere(*sphere)
        mesh = Mesh.create(verts, tris, device=device)
        t0 = time.perf_counter()
        accel = build_grid_accel(verts, tris, device=device)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out.append((f"frame, {mesh.num_triangles} triangles", mesh, accel,
                    *frame, ms))
        if sphere == SPHERES[0]:
            out.append((f"config 4 refresh, {mesh.num_triangles} triangles",
                        mesh, accel, *refresh, ms))
    return out


def spread(x):
    """'mean m, p99 p, max x' of a per-ray count tensor."""
    x = x.double()
    return (f"mean {float(x.mean()):.2f}, p99 "
            f"{float(x.quantile(0.99)):.0f}, max {int(x.max())}")


def counts(label, mesh, accel, o, d):
    import numpy as np
    import chip_smoke as cs
    from polychase_tpu_torch.engine.gridcast import grid_plain_counted

    arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
    hits, walks, its, found, reads = grid_plain_counted(o, d, accel, *arrays)
    tests = int(walks.tests.sum())
    steps = int((walks.empty + walks.full).sum())
    bound = cs.k6_bound(o.shape[0], mesh, found, hits.valid, True, tests,
                        steps, reads)
    per_cell = np.diff(accel.cell_start.cpu().numpy().astype(np.int64))
    full = per_cell[per_cell > 0]
    tested = int(walks.full.sum())
    print(f"    {label} walks (grid {accel.res.tolist()}, "
          f"{accel.items.shape[0]} items, {full.size} of {per_cell.size} "
          f"cells non-empty; {its} lockstep iterations): tests a ray "
          f"{spread(walks.tests)}; steps through empty cells "
          f"{spread(walks.empty)}; through full cells {spread(walks.full)}; "
          f"tests a full cell left {tests / max(tested, 1):.2f}; candidates "
          f"a non-empty cell of the grid: mean {full.mean():.2f}, p99 "
          f"{np.quantile(full, 0.99):.0f}, max {full.max()}; {tests} tests, "
          f"{steps} cell actions; read {reads.cell_start} cell_start "
          f"entries, {reads.items} items, {reads.rows} rows; bound "
          f"{bound[0]:.6f} ms ({bound[1]})", flush=True)


def main() -> None:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k6_compare: no CUDA device; this runs only on a "
                         "GPU")
    from polychase_tpu_torch.engine.gridcast import grid_raycast
    from polychase_tpu_torch.kernels import build, grid_cast as GK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; checkout {root}", flush=True)
    device = torch.device("cuda")
    # timing.py beside this script (it imports nothing of the port), so
    # that every checkout is timed by one harness.
    event_ms = runpy.run_path(Path(__file__).with_name("timing.py"))[
        "event_ms"]
    GK.load()
    for label, mesh, accel, o, d, build_ms in scenes(device):
        ms = event_ms(lambda: grid_raycast(mesh, accel, o, d), REPS)
        print(f"  {label} (N {o.shape[0]}, grid build {build_ms:.1f} ms "
              f"host): grid_raycast {ms:.4f} ms; hits "
              f"{digest(grid_raycast(mesh, accel, o, d))}", flush=True)
        if "--teams" in sys.argv[2:]:
            arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
            chosen = GK.team_width(accel)
            for team in GK.TEAMS:
                ms = event_ms(lambda: GK._launch(
                    o, d, accel, *arrays, True, 4, 200_000, team), REPS)
                print(f"    team of {team}"
                      + (" (team_width's)" if team == chosen else "")
                      + f": {ms:.4f} ms", flush=True)
        if "--k5" in sys.argv[2:]:
            from polychase_tpu_torch.kernels.raycast_sweep import raycast_hits

            arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
            d1 = d[:, None, :].contiguous()
            ms = event_ms(lambda: raycast_hits(o, d1, *arrays), REPS)
            same = (raycast_hits(o, d1, *arrays).prim_id[:, 0]
                    == grid_raycast(mesh, accel, o, d).prim_id)
            print(f"    K5, groups of one: {ms:.4f} ms; ids equal K6's on "
                  f"{float(same.float().mean()):.5f}", flush=True)
        if "--counts" in sys.argv[2:]:
            counts(label, mesh, accel, o, d)
    for line in build.load("grid_cast.cu").build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  {line.strip()}")


if __name__ == "__main__":
    main()
