"""The route crossovers of refine and pin mode, measured on a CUDA card.

Usage, from the root of a checkout on a machine with a CUDA card:

    python3 -m polychase_tpu_torch.crossover [refresh] [frame] [pin]

(the tables named, all three without a name).

1. Refine's prim refresh by three routes: the device sweep (K5 on the
   card), the uniform grid (``engine.gridcast``, K6 on the card) and the
   host BVH, for config 4's rays (250 frames × 128 keypoints of the
   1920×1080, f = 1800 orbit clip) on UV spheres from 1,472 to ~2M
   triangles.  Each route is timed as the LM driver calls it (rays, cast,
   prims back on the device, the cost after it), host clock ending in a
   synchronise, median of 3 after a warm-up, in turns (sweep, grid, BVH,
   BVH, grid, sweep); the grid's and the BVH's builds, once per refine,
   are printed apart, with the share of the grid's and the BVH's prims
   equal to the sweep's.
2. One tracking frame's grouped cast (4 groups of 2048 rays from the
   clip's first cameras) by the sweep (``raycast.sweep_grouped``, K5) and
   the grid (``grid_raycast_grouped``, K6) at the same mesh sizes, CUDA
   events behind a device sleep, in turns (K5, K6, K6, K5), and each
   call's host clock ending in a synchronise; the grid's build (host
   clock, median of 3 after a first), and K6's time a frame with the
   build spread over a 120-frame pass; with the share of equal ids.
3. Pin mode's ≥ 3-pin solve: the host route (float64 numpy) against the
   device route (``solve_pnp``, K1 on the card) at 3 to 16,384 points.

``refiner.BVH_TRIANGLE_THRESHOLD`` is set from the first table, and
``raycast.GRID_TRIANGLE_THRESHOLD`` from the second: the least count from
which K6 with its build spread over a pass beats K5, on the device and on
the call's host clock.
``pinmode.HOST_PIN_MAX`` is not set from the third: it is the JAX
package's default, 4096, kept for the reference's answer, which the
float32 device route leaves (``tests/pin_route_scan.py``).  The pin table
gives what the float64 host route costs a drag, and so what a float64
device route would have to beat.
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np
import torch

PIN_COUNTS = (3, 4, 8, 64, 512, 4096, 16384)
# (n_lat, n_lon) of the UV spheres: 1,472, 5,040, 10,780, 14,160, 20,224,
# 130,560, 399,000, 1,258,200 and 1,998,000 triangles.
SPHERES = ((24, 32), (36, 72), (50, 110), (60, 120), (80, 128), (256, 256),
           (400, 500), (700, 900), (1000, 1000))
# The frame table's: those and 2,320, 3,360, 6,864, 8,448, 32,512, 44,700,
# 64,440 and 79,600 triangles, around the grouped cast's crossovers.
FRAME_SPHERES = tuple(sorted(SPHERES + (
    (30, 40), (36, 48), (40, 88), (45, 96), (128, 128), (150, 150),
    (180, 180), (200, 200)), key=lambda s: 2 * s[1] * (s[0] - 1)))
WIDTH, HEIGHT, FOCAL = 1920, 1080, 1800.0
PASS_FRAMES = 120  # frames of a tracking pass over which a build is spread


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_ms(fn, device, reps):
    fn()
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def pin_scene(device, n, seed=0):
    """Config 2's scene: ``n`` surface pins of the 24×32 sphere seen from
    the clip's first frame, and that frame's scene as CPU tensors (the
    UI's state)."""
    from .engine.camera import OPENCV, Intrinsics
    from .engine.geometry import Mesh, SceneTransformations
    from .engine.pose import quat_to_mat_np
    from .synthetic import orbit_poses, surface_pins, uv_sphere

    q, t = orbit_poses(1)[0]
    mesh = Mesh.create(*uv_sphere(24, 32), device=device)
    pins = surface_pins(mesh, (q, t), FOCAL, WIDTH, HEIGHT,
                        np.random.default_rng(seed), n)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = quat_to_mat_np(q)
    view[:3, 3] = t
    intr = Intrinsics.create(FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2, 1.0,
                             WIDTH, HEIGHT, OPENCV, device="cpu")
    scene = SceneTransformations(torch.eye(4), torch.as_tensor(view), intr)
    return pins, scene


def pin_drag(pins, scene, k, device):
    """One Camera-type drag of pin 2, as ``run_all.py:252-256``."""
    from .engine.geometry import TRANSFORM_CAMERA
    from .engine.pinmode import PinUpdate, find_transformation

    return find_transformation(
        pins, scene, scene,
        PinUpdate(2, np.array([955.0 + k, 542.0], np.float32)),
        TRANSFORM_CAMERA, device=device,
    )


def pin_route_table(device, counts=PIN_COUNTS, reps=5):
    """[(points, host ms, device ms)] per drag, each route forced by
    ``pinmode.HOST_PIN_MAX``."""
    from .engine import pinmode

    rows = []
    saved = pinmode.HOST_PIN_MAX
    try:
        for n in counts:
            pins, scene = pin_scene(device, n)
            ms = []
            for limit in (1 << 30, 0):
                pinmode.HOST_PIN_MAX = limit
                ms.append(_median_ms(
                    lambda: pin_drag(pins, scene, 0, device), device, reps))
            rows.append((len(pins), ms[0], ms[1]))
    finally:
        pinmode.HOST_PIN_MAX = saved
    return rows


def _clip_rays(device, frames, keypoints):
    """The refiner's inputs for ``frames`` frames of the clip with
    ``keypoints`` keypoints each, uniform over the image's centre: its
    data and parameters (the truth)."""
    from .engine import refiner as R
    from .synthetic import orbit_poses

    rng = np.random.default_rng(0)
    poses = orbit_poses(frames)
    pix = rng.uniform((WIDTH * 0.3, HEIGHT * 0.3), (WIDTH * 0.7, HEIGHT * 0.7),
                      (frames, keypoints, 2)).astype(np.float32)
    dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    data = R.RefinerData(
        kps=dev(pix), kp_valid=dev(np.ones((frames, keypoints), bool)),
        src_frame=dev(np.zeros(1, np.int64)),
        tgt_frame=dev(np.ones(1, np.int64)),
        src_kp=dev(np.zeros((1, 1), np.int64)),
        tgt_px=dev(np.zeros((1, 1, 2), np.float32)),
        match_valid=dev(np.zeros((1, 1), bool)),
        edge_weight=dev(np.zeros(1, np.float32)),
        edge_valid=dev(np.zeros(1, bool)),
        anchor=dev(np.zeros(frames, bool)),
        aspect=dev(np.float32(1.0)), conv_sign=dev(np.float32(1.0)),
    )
    f = np.full(frames, FOCAL, np.float32)
    params = R.TrajParams(
        dev(np.stack([q for q, _ in poses])),
        dev(np.stack([t for _, t in poses])), dev(f), dev(f),
        dev(np.full(frames, WIDTH / 2, np.float32)),
        dev(np.full(frames, HEIGHT / 2, np.float32)),
    )
    return data, params


def refresh_route_table(device, spheres=SPHERES, frames=250, keypoints=128,
                        reps=3):
    """[(triangles, sweep ms turns, grid ms turns, BVH ms turns, grid build
    ms, BVH build ms, grid prim agreement, BVH prim agreement)] for one
    prim refresh of config 4's rays, the routes timed in turns (sweep,
    grid, BVH, BVH, grid, sweep), each agreement the share of the sweep's
    prims it gives."""
    from . import native

    from .engine import refiner as R
    from .engine.geometry import Mesh
    from .engine.gridcast import build_grid_accel, grid_raycast_grouped
    from .engine.raycast import sweep_grouped
    from .synthetic import uv_sphere

    if not native.available():
        raise RuntimeError("the native BVH library is unavailable")
    data, params = _clip_rays(device, frames, keypoints)
    eye = torch.eye(4, device=device)
    rows = []
    for n_lat, n_lon in spheres:
        verts, tris = uv_sphere(n_lat, n_lon)
        mesh = Mesh.create(verts, tris, device=device)
        tri = mesh.triangle_corners()
        args = (data, mesh, eye, eye, tri, 1.0, 2)
        t0 = time.perf_counter()
        accel = build_grid_accel(verts, tris, device=device)
        _sync(device)
        grid_build = (time.perf_counter() - t0) * 1e3
        route = functools.partial(
            R.refresh_prims_and_cost, data=data, mesh=mesh, model=eye,
            model_inv=eye, tri_corners=tri, loss_scale=1.0, loss_type=2)
        sweep = functools.partial(route, cast=sweep_grouped)
        grid = functools.partial(
            route, cast=lambda m, o, d: grid_raycast_grouped(m, accel, o, d))
        t0 = time.perf_counter()
        bvh = R._make_prim_refresher(*args, routing=True)
        bvh_build = (time.perf_counter() - t0) * 1e3
        routes = dict(sweep=sweep, grid=grid, bvh=bvh)
        ms = {k: [] for k in routes}
        for route in ("sweep", "grid", "bvh", "bvh", "grid", "sweep"):
            fn = routes[route]
            ms[route].append(_median_ms(lambda: fn(params), device, reps))
        want = sweep(params)[0]
        agree = [float((routes[k](params)[0] == want).float().mean())
                 for k in ("grid", "bvh")]
        rows.append((mesh.num_triangles, ms["sweep"], ms["grid"], ms["bvh"],
                     grid_build, bvh_build, *agree))
    return rows


def frame_route_table(device, spheres=FRAME_SPHERES, groups=4, keypoints=2048,
                      reps=20):
    """[(triangles, K5 ms turns, K6 ms turns, K5 host ms turns, K6 host ms
    turns, grid build ms, id agreement)] for one tracking frame's grouped
    cast (``groups`` cameras of the clip, ``keypoints`` rays each) by
    ``raycast.sweep_grouped`` (K5) and ``grid_raycast_grouped`` (K6):
    device time by CUDA events behind a device sleep
    (``timing.event_ms``), and a call's host clock ending in a synchronise
    (median of ``reps``), each in turns (K5, K6, K6, K5); the build is the
    median of 3 host-clock builds after a first."""
    from .engine import refiner as R
    from .engine.geometry import Mesh
    from .engine.gridcast import build_grid_accel, grid_raycast_grouped
    from .engine.raycast import sweep_grouped
    from .synthetic import uv_sphere
    from .timing import event_ms

    data, params = _clip_rays(device, groups, keypoints)
    origins, dirs = R._all_rays(params, data, torch.eye(4, device=device))
    rows = []
    for n_lat, n_lon in spheres:
        verts, tris = uv_sphere(n_lat, n_lon)
        mesh = Mesh.create(verts, tris, device=device)
        build = functools.partial(build_grid_accel, verts, tris,
                                  device=device)
        accel = build()
        builds = []
        for _ in range(3):
            t0 = time.perf_counter()
            build()
            _sync(device)
            builds.append((time.perf_counter() - t0) * 1e3)
        casts = dict(
            k5=lambda: sweep_grouped(mesh, origins, dirs),
            k6=lambda: grid_raycast_grouped(mesh, accel, origins, dirs))
        ms = {k: [] for k in casts}
        host = {k: [] for k in casts}
        for k in ("k5", "k6", "k6", "k5"):
            ms[k].append(event_ms(casts[k], reps))
            host[k].append(_median_ms(casts[k], device, reps))
        a, b = casts["k5"](), casts["k6"]()
        agree = float((a.prim_id == b.prim_id).float().mean())
        rows.append((mesh.num_triangles, ms["k5"], ms["k6"], host["k5"],
                     host["k6"], float(np.median(builds)), agree))
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("crossover: no CUDA device; this runs only on a GPU")
    import subprocess

    from .backend import require_cuda
    from .kernels import grid_cast, pnp_lm, raycast_sweep

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    device = require_cuda()
    pnp_lm.load()
    raycast_sweep.load()
    grid_cast.load()
    tables = set(sys.argv[1:]) or {"refresh", "frame", "pin"}
    if "refresh" in tables:
        print("prim refresh, config 4's 32,000 rays (ms per refresh; sweep, "
              "grid, BVH, BVH, grid, sweep):", flush=True)
        for (tris, s_ms, g_ms, b_ms, g_build, b_build, g_agree,
             b_agree) in refresh_route_table(device):
            print(f"  {tris:7d} triangles: device sweep {s_ms[0]:.3f}, grid "
                  f"{g_ms[0]:.3f}, host BVH {b_ms[0]:.3f}, {b_ms[1]:.3f}, "
                  f"grid {g_ms[1]:.3f}, device sweep {s_ms[1]:.3f} (builds: "
                  f"grid {g_build:.3f}, BVH {b_build:.3f}); prims equal the "
                  f"sweep's: grid {g_agree:.5f}, BVH {b_agree:.5f}",
                  flush=True)
    if "frame" in tables:
        print("a tracking frame's grouped cast, 4 x 2048 rays (device ms, "
              "K5, K6, K6, K5; host ms a call, the same turns; the grid's "
              f"build, host ms; K6 with the build over {PASS_FRAMES} "
              "frames):", flush=True)
        for (tris, k5_ms, k6_ms, k5_host, k6_host, build_ms,
             agree) in frame_route_table(device):
            spread = build_ms / PASS_FRAMES
            dev = (min(k6_ms) + spread, min(k5_ms))
            host = (min(k6_host) + spread, min(k5_host))
            print(f"  {tris:7d} triangles: K5 {k5_ms[0]:.4f}, K6 "
                  f"{k6_ms[0]:.4f}, {k6_ms[1]:.4f}, K5 {k5_ms[1]:.4f}; host "
                  f"K5 {k5_host[0]:.4f}, K6 {k6_host[0]:.4f}, "
                  f"{k6_host[1]:.4f}, K5 {k5_host[1]:.4f}; build "
                  f"{build_ms:.3f}; K6 + build / {PASS_FRAMES} against K5: "
                  + "; ".join(f"{clock} {a:.4f} / {b:.4f} "
                              f"({'K6' if a < b else 'K5'})"
                              for clock, (a, b) in (("device", dev),
                                                    ("host", host)))
                  + f"; ids equal {agree:.5f}", flush=True)
    if "pin" in tables:
        print("pin drag, >= 3 pins (ms per drag):")
        for n, h_ms, d_ms in pin_route_table(device):
            print(f"  {n:6d} points: host {h_ms:.4f}, device {d_ms:.4f}")


if __name__ == "__main__":
    main()
