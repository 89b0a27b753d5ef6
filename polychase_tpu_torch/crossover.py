"""The route crossovers of refine and pin mode, measured on a CUDA card.

Usage, from the root of a checkout on a machine with a CUDA card:

    python3 -m polychase_tpu_torch.crossover

1. Refine's prim refresh: the device sweep (K5 on the card) against the
   host BVH for config 4's rays (250 frames × 128 keypoints of the
   1920×1080, f = 1800 orbit clip) on UV spheres from 1,472 to ~2M
   triangles.  Each route is timed as the LM driver calls it (rays, cast,
   prims back on the device, the cost after it), host clock ending in a
   synchronise, median of 3 after a warm-up, in turns (sweep, BVH, BVH,
   sweep); the BVH's build, once per refine, is printed apart.
2. Pin mode's ≥ 3-pin solve: the host route (float64 numpy) against the
   device route (``solve_pnp``, K1 on the card) at 3 to 16,384 points.

``refiner.BVH_TRIANGLE_THRESHOLD`` is set from the first table.
``pinmode.HOST_PIN_MAX`` is not set from the second: it is the JAX
package's default, 4096, kept for the reference's answer, which the
float32 device route leaves (``tests/pin_route_scan.py``).  The pin table
gives what the float64 host route costs a drag, and so what a float64
device route would have to beat.
"""

from __future__ import annotations

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


def refresh_route_table(device, spheres=SPHERES, frames=250, keypoints=128,
                        reps=3):
    """[(triangles, device ms turns, BVH ms turns, BVH build ms, prim
    agreement)] for one prim refresh of config 4's rays, the routes timed
    in turns (sweep, BVH, BVH, sweep)."""
    from . import native

    from .engine import refiner as R
    from .engine.geometry import Mesh
    from .synthetic import orbit_poses, uv_sphere

    if not native.available():
        raise RuntimeError("the native BVH library is unavailable")
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
    eye = torch.eye(4, device=device)
    rows = []
    for n_lat, n_lon in spheres:
        mesh = Mesh.create(*uv_sphere(n_lat, n_lon), device=device)
        tri = mesh.triangle_corners()
        args = (data, mesh, eye, eye, tri, 1.0, 2)
        sweep = R._make_prim_refresher(*args, routing=False)
        t0 = time.perf_counter()
        bvh = R._make_prim_refresher(*args, routing=True)
        build_ms = (time.perf_counter() - t0) * 1e3
        d_ms, b_ms = [], []
        for route in ("sweep", "bvh", "bvh", "sweep"):
            fn = sweep if route == "sweep" else bvh
            (d_ms if route == "sweep" else b_ms).append(
                _median_ms(lambda: fn(params), device, reps))
        agree = float((sweep(params)[0] == bvh(params)[0]).float().mean())
        rows.append((mesh.num_triangles, d_ms, b_ms, build_ms, agree))
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("crossover: no CUDA device; this runs only on a GPU")
    import subprocess

    from .backend import require_cuda
    from .kernels import pnp_lm, raycast_sweep

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    device = require_cuda()
    pnp_lm.load()
    raycast_sweep.load()
    print("prim refresh, config 4's 32,000 rays (ms per refresh; sweep, "
          "BVH, BVH, sweep):")
    for tris, d_ms, b_ms, build_ms, agree in refresh_route_table(device):
        print(f"  {tris:7d} triangles: device sweep {d_ms[0]:.3f}, host BVH "
              f"{b_ms[0]:.3f}, {b_ms[1]:.3f}, device sweep {d_ms[1]:.3f} "
              f"(BVH build {build_ms:.3f}), prims equal {agree:.5f}")
    print("pin drag, >= 3 pins (ms per drag):")
    for n, h_ms, d_ms in pin_route_table(device):
        print(f"  {n:6d} points: host {h_ms:.4f}, device {d_ms:.4f}")


if __name__ == "__main__":
    main()
