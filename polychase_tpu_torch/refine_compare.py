"""Refine's wall time and its solves in a checkout of this repository, on a
CUDA card.

Usage, on a machine with a CUDA card, once per checkout to compare:

    python3 polychase_tpu_torch/refine_compare.py ROOT

ROOT is the root of a checkout (``.``, or a ``git archive`` of another
commit unpacked into a directory that ``.gitignore`` lists).  The script
imports ``polychase_tpu_torch`` and ``chip_smoke`` from ROOT and runs that
checkout's refine on config 4 (``chip_smoke.refine_inputs``, seeded):

- ``refine_trajectory``, its wall seconds (host clock ending in a
  synchronise; 3 runs after a warm-up, each from a fresh noisy start) and
  one profiled run's device ms of its ``refine.solve`` stage (the banded
  solve at nb = 32);
- ``refine_segments`` split at ``chip_smoke.REFINE_KEYS`` (5 segments, the
  batched banded solve), wall seconds, 3 runs after a warm-up;
- one normal system of config 4 solved banded and dense
  (``chip_smoke.band_solve_check``, CUDA events), and the dense
  ``levmarq.damped_cholesky_solve`` on a batch of 5 seeded SPD systems of
  P = 459 (the size of a segment's system), CUDA events.

Prints the card, then one line per measurement.  Run it for two checkouts
in turns (A, B, B, A) within one call to compare them.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

RUNS = 3


def main() -> None:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("refine_compare: no CUDA device; this runs only on "
                         "a GPU")
    import chip_smoke as cs
    from polychase_tpu_torch.engine import refiner as R
    from polychase_tpu_torch.engine.camera import (
        OPENCV, CameraState, Intrinsics,
    )
    from polychase_tpu_torch.engine.levmarq import (
        CAUCHY, BundleOptions, damped_cholesky_solve,
    )
    from polychase_tpu_torch.engine.pose import Pose
    from polychase_tpu_torch.engine.trajectory import CameraTrajectory
    from polychase_tpu_torch.parallel.segments import refine_segments

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; checkout {root}")
    device = torch.device("cuda")
    eye = np.eye(4, dtype=np.float32)
    opts = BundleOptions(loss_type=CAUCHY, loss_scale=1.0,
                         max_iterations=cs.REFINE_ITERS)
    with tempfile.TemporaryDirectory() as workdir:
        refine, mesh = cs.refine_inputs(device, workdir)
        db, poses, noisy = refine["db"], refine["poses"], refine["noisy"]

        def whole():
            traj = noisy()
            t0 = time.perf_counter()
            R.refine_trajectory(db, traj, eye, mesh,
                                optimize_focal_length=True,
                                bundle_opts=opts, device=device)
            torch.cuda.synchronize(device)
            return time.perf_counter() - t0

        intr = Intrinsics.create(cs.FOCAL, cs.FOCAL, cs.WIDTH / 2,
                                 cs.HEIGHT / 2, 1.0, cs.WIDTH, cs.HEIGHT,
                                 OPENCV, device="cpu")
        keys = cs.REFINE_KEYS

        def segments():
            start = noisy()
            segs = []
            for a, b in zip(keys[:-1], keys[1:]):
                traj = CameraTrajectory(a, b - a + 1)
                for f in range(a, b + 1):
                    s = start.get(f)
                    q, t = ((torch.tensor(np.asarray(poses[f][0], np.float32)),
                             torch.tensor(np.asarray(poses[f][1], np.float32)))
                            if f in keys else
                            (s.pose.q.clone(), s.pose.t.clone()))
                    traj.set(f, CameraState(intr if f in keys
                                            else s.intrinsics, Pose(q, t)))
                segs.append(traj)
            t0 = time.perf_counter()
            refine_segments(db, segs, eye, mesh, optimize_focal_length=True,
                            bundle_opts=opts, device=device)
            torch.cuda.synchronize(device)
            return time.perf_counter() - t0

        whole()
        walls = [whole() for _ in range(RUNS)]
        _, stages, _, _ = cs.profile_split(whole, device)
        print("  refine_trajectory s: "
              + ", ".join(f"{w:.4f}" for w in walls)
              + f"; profiled run's refine.solve {stages['refine.solve']:.4f} "
              f"ms of device time")
        segments()
        walls = [segments() for _ in range(RUNS)]
        print("  refine_segments s (5 segments): "
              + ", ".join(f"{w:.4f}" for w in walls))
        band, n0, band_ms, dense_ms, rel = cs.band_solve_check(
            device, db, noisy(), mesh)
        print(f"  config 4's system (P = {n0}, band {band}): banded "
              f"{band_ms:.4f} ms, dense {dense_ms:.4f} ms a solve")

    rng = np.random.default_rng(0)
    S, P = 5, 459
    a = rng.standard_normal((S, P, P + 8)).astype(np.float32)
    JtJ = torch.as_tensor(a @ a.transpose(0, 2, 1), device=device)
    Jtr = torch.as_tensor(rng.standard_normal((S, P)).astype(np.float32),
                          device=device)
    lam = torch.full((S,), 1e-4, device=device)
    ms = cs.event_ms(lambda: damped_cholesky_solve(JtJ, Jtr, lam), 10)
    print(f"  damped_cholesky_solve, {S} systems of P = {P}: {ms:.4f} ms")


if __name__ == "__main__":
    main()
