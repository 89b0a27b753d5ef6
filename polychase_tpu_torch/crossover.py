"""The route crossovers of refine and pin mode, measured on a CUDA card.

Usage, from the root of a checkout on a machine with a CUDA card:

    python3 -m polychase_tpu_torch.crossover

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
2. One tracking frame's cast (4 groups of 2048 rays from the clip's first
   cameras) by K5 (``raycast_grouped``) and K6 (``grid_raycast_grouped``)
   at the same mesh sizes, CUDA events behind a device sleep, in turns
   (K5, K6, K6, K5), with the share of equal ids.
3. Pin mode's ≥ 3-pin solve: the host route (float64 numpy) against the
   device route (``solve_pnp``, K1 on the card) at 3 to 16,384 points.

``refiner.BVH_TRIANGLE_THRESHOLD`` is set from the first table; no route of
refine takes the grid yet.
``pinmode.HOST_PIN_MAX`` is not set from the second: it is the JAX
package's default, 4096, kept for the reference's answer, which the
float32 device route leaves (``tests/pin_route_scan.py``).  The pin table
gives what the float64 host route costs a drag, and so what a float64
device route would have to beat.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

PIN_COUNTS = (3, 4, 8, 64, 512, 4096, 16384)
# (n_lat, n_lon) of the UV spheres: 1,472, 5,040, 10,780, 14,160, 20,224,
# 130,560, 399,000, 1,258,200 and 1,998,000 triangles.
SPHERES = ((24, 32), (36, 72), (50, 110), (60, 120), (80, 128), (256, 256),
           (400, 500), (700, 900), (1000, 1000))
WIDTH, HEIGHT, FOCAL = 1920, 1080, 1800.0


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
        sweep = R._make_prim_refresher(*args, routing=False)
        t0 = time.perf_counter()
        accel = build_grid_accel(verts, tris, device=device)
        _sync(device)
        grid_build = (time.perf_counter() - t0) * 1e3
        grid = functools.partial(
            R.refresh_prims_and_cost, data=data, mesh=mesh, model=eye,
            model_inv=eye, tri_corners=tri, loss_scale=1.0, loss_type=2,
            cast=lambda m, o, d: grid_raycast_grouped(m, accel, o, d))
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


def frame_route_table(device, spheres=SPHERES, groups=4, keypoints=2048,
                      reps=20):
    """[(triangles, K5 ms turns, K6 ms turns, id agreement)] for one
    tracking frame's cast (``groups`` cameras of the clip, ``keypoints``
    rays each) by ``raycast_grouped`` (K5) and ``grid_raycast_grouped``
    (K6), CUDA events behind a device sleep (``timing.event_ms``), in
    turns (K5, K6, K6, K5)."""
    from .engine import refiner as R
    from .engine.geometry import Mesh
    from .engine.gridcast import build_grid_accel, grid_raycast_grouped
    from .engine.raycast import raycast_grouped
    from .synthetic import uv_sphere
    from .timing import event_ms

    data, params = _clip_rays(device, groups, keypoints)
    origins, dirs = R._all_rays(params, data, torch.eye(4, device=device))
    rows = []
    for n_lat, n_lon in spheres:
        verts, tris = uv_sphere(n_lat, n_lon)
        mesh = Mesh.create(verts, tris, device=device)
        accel = build_grid_accel(verts, tris, device=device)
        casts = dict(
            k5=lambda: raycast_grouped(mesh, origins, dirs),
            k6=lambda: grid_raycast_grouped(mesh, accel, origins, dirs))
        ms = {k: [] for k in casts}
        for k in ("k5", "k6", "k6", "k5"):
            ms[k].append(event_ms(casts[k], reps))
        a, b = casts["k5"](), casts["k6"]()
        agree = float((a.prim_id == b.prim_id).float().mean())
        rows.append((mesh.num_triangles, ms["k5"], ms["k6"], agree))
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
    print("prim refresh, config 4's 32,000 rays (ms per refresh; sweep, "
          "grid, BVH, BVH, grid, sweep):", flush=True)
    for (tris, s_ms, g_ms, b_ms, g_build, b_build, g_agree,
         b_agree) in refresh_route_table(device):
        print(f"  {tris:7d} triangles: device sweep {s_ms[0]:.3f}, grid "
              f"{g_ms[0]:.3f}, host BVH {b_ms[0]:.3f}, {b_ms[1]:.3f}, grid "
              f"{g_ms[1]:.3f}, device sweep {s_ms[1]:.3f} (builds: grid "
              f"{g_build:.3f}, BVH {b_build:.3f}); prims equal the sweep's: "
              f"grid {g_agree:.5f}, BVH {b_agree:.5f}", flush=True)
    print("a tracking frame's cast, 4 x 2048 rays (device ms; K5, K6, K6, "
          "K5):", flush=True)
    for tris, k5_ms, k6_ms, agree in frame_route_table(device):
        print(f"  {tris:7d} triangles: K5 {k5_ms[0]:.4f}, K6 {k6_ms[0]:.4f}, "
              f"{k6_ms[1]:.4f}, K5 {k5_ms[1]:.4f}; ids equal {agree:.5f}",
              flush=True)
    print("pin drag, >= 3 pins (ms per drag):")
    for n, h_ms, d_ms in pin_route_table(device):
        print(f"  {n:6d} points: host {h_ms:.4f}, device {d_ms:.4f}")


if __name__ == "__main__":
    main()
