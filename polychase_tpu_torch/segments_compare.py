"""``refine_segments`` against the sequential refines on config 4, over
seeds, noisy starts and the device that casts the flow DB, on a CUDA card.

Usage, from the root of a checkout on a machine with a CUDA card:

    python3 -m polychase_tpu_torch.segments_compare

For each seed, config 4's flow DB (``chip_smoke.refine_inputs``' clip) is
cast twice by the plain sweep, once from the mesh on the card and once from
a CPU copy (as ``chip_smoke.refine_inputs`` casts it): the same pixels and
noise draws, hits that differ in their last bits.  Five noisy starts are
drawn after each build, as ``chip_smoke.refine_inputs``' ``noisy`` draws
them, and split at ``chip_smoke.REFINE_KEYS`` (true keyframes) as
``chip_smoke.py``'s segments phase splits them; ``refine_segments`` and one
``refine_trajectory`` a segment refine them under the default relative
function tolerance and, for seed 2, with it off
(``POLYCHASE_REFINE_FTOL=0``).  One line a case: the largest |dt| that
``chip_smoke.refine_seq_gate`` holds against ``chip_smoke.REFINE_SEQ_ATOL``
(the two paths' accepted states up to the first refresh whose prims
differ), the largest |dt| of the refined outputs, each segment's LM
iterations in the two paths, the refresh at which each segment's prims
first differ with the share of the valid prims that differ there (held
against ``chip_smoke.REFINE_SPLIT_SHARE``), and the first iteration at
which the two paths' accept/reject decisions differ.  Where a segment's
held |dt| is over the gate, the cost history of both paths follows.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

SEEDS = (2, 3, 4, 5)
STARTS = 5


def _first_split(a, b):
    """The first iteration whose accept/reject decision differs between two
    cost histories (the start's cost, then the cost after each iteration; a
    path that stopped keeps its last cost), else None."""
    n = max(len(a), len(b))
    a, b = (list(h) + [h[-1]] * (n - len(h)) for h in (a, b))
    for i in range(1, n):
        if (a[i] != a[i - 1]) != (b[i] != b[i - 1]):
            return i
    return None


def _split(split, moved, cs):
    """A segment's first refresh whose prims differ and the share of the
    valid prims that differ there, marked where the gate refuses it."""
    if split is None:
        return "-"
    over = split == 0 or moved > cs.REFINE_SPLIT_SHARE
    return f"{split} ({moved:.3g}{' > gate' if over else ''})"


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("segments_compare: no CUDA device; this runs only "
                         "on a GPU")
    import chip_smoke as cs
    from .engine import refiner as R
    from .engine.camera import OPENCV, CameraState, Intrinsics
    from .engine.geometry import Mesh
    from .engine.levmarq import CAUCHY, BundleOptions
    from .engine.pose import Pose
    from .engine.trajectory import CameraTrajectory
    from .parallel.segments import refine_segments
    from .synthetic import (
        build_flow_db, noisy_trajectory, orbit_poses, uv_sphere,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    device = torch.device("cuda")
    eye = np.eye(4, dtype=np.float32)
    keys = cs.REFINE_KEYS
    bounds = list(zip(keys[:-1], keys[1:]))
    intr = Intrinsics.create(cs.FOCAL, cs.FOCAL, cs.WIDTH / 2, cs.HEIGHT / 2,
                             1.0, cs.WIDTH, cs.HEIGHT, OPENCV, device="cpu")
    opts = BundleOptions(loss_type=CAUCHY, loss_scale=1.0,
                         max_iterations=cs.REFINE_ITERS)

    # The lockstep's state vectors (cost, ..., counted iterations), the
    # start's and each iteration's.
    history = []
    real_iterate = R.LockstepLM.iterate

    def iterate(self, scal_h):
        if not history:
            history.append(scal_h.copy())
        real_iterate(self, scal_h)
        history.append(self.scal.cpu().numpy())

    R.LockstepLM.iterate = iterate

    def build(seed, cast, workdir):
        rng = np.random.default_rng(seed)
        verts, tris = uv_sphere(*cs.REFINE_SPHERE)
        mesh = Mesh.create(verts, tris, device=device)
        poses = orbit_poses(cs.REFINE_FRAMES)
        path = os.path.join(workdir, f"refine-{seed}-{cast}.db")
        with cs.plain_route():  # K5 set aside: the card's plain route
            build_flow_db(path, mesh if cast == "card" else
                          Mesh.create(verts, tris, device="cpu"), cs.FOCAL,
                          cs.WIDTH, cs.HEIGHT, poses, rng,
                          cs.REFINE_KEYPOINTS, cs.NOISE_PX)
        starts = [noisy_trajectory(poses, intr, rng, cs.REFINE_T_SIGMA)
                  for _ in range(STARTS)]
        return path, mesh, poses, starts

    def segments(poses, start):
        out = []
        for a, b in bounds:
            traj = CameraTrajectory(a, b - a + 1)
            for f in range(a, b + 1):
                s = start.get(f)
                q, t = ((torch.tensor(np.asarray(poses[f][0], np.float32)),
                         torch.tensor(np.asarray(poses[f][1], np.float32)))
                        if f in keys else (s.pose.q.clone(), s.pose.t.clone()))
                traj.set(f, CameraState(intr if f in keys else s.intrinsics,
                                        Pose(q, t)))
            out.append(traj)
        return out

    def case(path, mesh, poses, start):
        history.clear()
        segs = segments(poses, start)
        with cs.refine_records() as (lock_states, seq_states):
            out = refine_segments(path, segs, eye, mesh,
                                  optimize_focal_length=True,
                                  bundle_opts=opts, device=device)
            lock = np.stack(history)  # (iterations + 1, segments, 8)
            rows = []
            for k, traj in enumerate(segments(poses, start)):
                seq = []
                R.refine_trajectory(
                    path, traj, eye, mesh, optimize_focal_length=True,
                    bundle_opts=opts, device=device,
                    callback=lambda u: seq.append(
                        (int(u.stats.iterations),
                         float(u.stats.initial_cost),
                         float(u.stats.cost))) or True)
                a, b = bounds[k]
                dt = max(float(np.abs(out[k].get(f).pose.t.numpy()
                                      - traj.get(f).pose.t.numpy()).max())
                         for f in range(a, b + 1))
                held, split, moved, _, _ = cs.refine_seq_gate(
                    lock_states[0][k], seq_states[k])
                # Both histories as the start's cost and the cost after
                # each iteration (a sequential update reports the
                # iteration's cost).
                costs_s = ([seq[0][1]]
                           + list({i: c for i, _, c in seq}.values()))
                costs_l = [float(c) for c in lock[:, k, 0]]
                rows.append((held, dt, split, costs_l, costs_s,
                             int(lock[-1, k, 6]), seq[-1][0], moved))
        return rows

    with tempfile.TemporaryDirectory() as workdir:
        for seed in SEEDS:
            for cast in ("card", "host"):
                path, mesh, poses, starts = build(seed, cast, workdir)
                for i, start in enumerate(starts):
                    for ftol in (("1e-5", "0") if seed == 2 else ("1e-5",)):
                        os.environ["POLYCHASE_REFINE_FTOL"] = ftol
                        rows = case(path, mesh, poses, start)
                        held = max(r[0] for r in rows)
                        dt = max(r[1] for r in rows)
                        its = " ".join(f"{r[5]}/{r[6]}" for r in rows)
                        splits = " ".join(_split(r[2], r[7], cs)
                                          for r in rows)
                        print(f"seed {seed}, DB cast on the {cast}, start {i}, "
                              f"ftol {ftol}: held |dt| {held:.3g}"
                              f"{' > gate' if held > cs.REFINE_SEQ_ATOL else ''}"
                              f", outputs' |dt| {dt:.3g}; segments' "
                              f"iterations (lockstep / sequential) {its}; "
                              f"prims first differ at refresh {splits}",
                              flush=True)
                        for k, (d, _, _, cl, cseq, _, _, _) in enumerate(
                                rows):
                            if d <= cs.REFINE_SEQ_ATOL:
                                continue
                            print(f"  segment {k}: |dt| {d:.3g}, decisions "
                                  f"part at iteration "
                                  f"{_first_split(cl, cseq)}; costs "
                                  f"lockstep "
                                  + " ".join(f"{c:.9g}" for c in cl)
                                  + "; sequential "
                                  + " ".join(f"{c:.9g}" for c in cseq))
        os.environ.pop("POLYCHASE_REFINE_FTOL", None)


if __name__ == "__main__":
    main()
