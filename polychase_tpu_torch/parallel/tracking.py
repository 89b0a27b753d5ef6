"""Segment-parallel forward tracking.

Port of ``polychase_tpu/parallel/tracking.py``.  Tracking a segment is
sequential (each frame warm-starts from its neighbour), but segments are
independent given their seed keyframes.  So S segments step together: at
each frame step every segment solves its next frame, with one ray cast of
all S segments' flow groups and one batched PnP solve of S solves, which on
a card is one launch of K1 (``kernels/pnp_lm.py``) with the segments as its
grid.  The step is ``engine.tracker._cast_and_solve``, the one the
sequential tracker takes with S = 1.

The reference's semantics, which a loop over ``track_camera_trajectory``
would not keep: a segment's chain starts from its seed (first) frame alone;
a frame with fewer than 3 correspondences keeps its warm start and the
chain goes on; the counts come back to the caller.  The TPU padding of the
group count (a multiple of 8) and the bucketed K is layout and is left
out: G and K are the stack's maxima.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..engine.levmarq import CAUCHY, BundleOptions
from ..engine.pnp import normalize_bundle_opts, result_camera
from ..engine.tracker import (
    MAX_INLIER_ERROR,
    TrackingError,
    _cast_and_solve,
    _check_flow_indices,
    _host,
    _plan,
    pack_steps,
)
from ..engine.geometry import Mesh
from ..engine.trajectory import CameraTrajectory
from ..io.database import Database
from ..backend import current
from . import mesh_on, resolve_devices, shards


def _segment_plan(database: Database, traj: CameraTrajectory):
    """One segment's frame steps: each frame after the seed, its warm
    start and its flows from the seed and the frames solved before it."""
    first = traj.first_frame
    if not traj.is_frame_filled(first):
        raise TrackingError(f"segment at {first}: seed frame has no pose")
    frames = list(range(first + 1, first + traj.count))
    return _plan(database, traj, frames, 1, available={first})


def _seed_intrinsics(trajs):
    """Every segment's seed camera on the host; all segments must share the
    clip's aspect, size and sign (the solve shares them)."""
    seeds = [t.get(t.first_frame) for t in trajs]
    fixed = lambda i: tuple(float(v) for v in (  # noqa: E731
        i.aspect_ratio, i.width, i.height, i.sign))
    ref = fixed(seeds[0].intrinsics)
    for s, seed in enumerate(seeds[1:], 1):
        if fixed(seed.intrinsics) != ref:
            raise TrackingError(
                f"segment {s}: seed intrinsics convention/size differs from "
                "segment 0 (all segments must share one clip)")
    return seeds


def track_segments(
    database,
    trajs: Sequence[CameraTrajectory],
    model_matrix,
    mesh: Mesh,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    bundle_opts: BundleOptions = BundleOptions(loss_type=CAUCHY),
    *,
    device,
) -> np.ndarray:
    """Track every segment forward from its filled first frame, all of them
    in lockstep.  Poses are written into each trajectory (as CPU tensors)
    for the frames solved with at least 3 correspondences; returns
    ``counts`` (S, steps), the correspondences of each segment's solve at
    each step (a frame with fewer than 3 keeps its warm start; callers
    decide whether that is an error).

    ``database`` is a :class:`Database` or a path.  ``device`` is one
    device or a sequence of devices; with several, the segments are split
    into contiguous shards, one per device.  ``mesh`` is copied to each
    device that does not hold it.  ``bundle_opts`` is taken as given: no
    function tolerance is added.
    """
    devices = resolve_devices(device)
    if not trajs:
        return np.zeros((0, 0), np.int32)
    opts = normalize_bundle_opts(bundle_opts)
    opt_f, opt_pp = bool(optimize_focal_length), bool(optimize_principal_point)

    own_db = isinstance(database, str)
    if own_db:
        database = Database(database)
    try:
        plans, kps = [], []
        for traj in trajs:
            plan = _segment_plan(database, traj)
            src = sorted({s for _, _, gs in plan for s, _, _ in gs})
            k = database.read_keypoints_range(min(src, default=0),
                                              max(src, default=0))
            _check_flow_indices(plan, k)
            plans.append(plan)
            kps.append({f: k.get(f, np.empty((0, 2), np.float32))
                        for f in src})
    finally:
        if own_db:
            database.close()
    seeds = _seed_intrinsics(trajs)

    # The stack's shapes, shared by every shard.
    S = len(trajs)
    n_steps = max(t.count - 1 for t in trajs)
    if n_steps == 0:
        return np.zeros((S, 0), np.int32)
    G = max([len(gs) for p in plans for _, _, gs in p] + [1])
    K = max([g[1].shape[0] for p in plans for _, _, gs in p for g in gs]
            + [1])
    Fmax = max(t.count for t in trajs)
    Kmax = max([k.shape[0] for ks in kps for k in ks.values()] + [1])

    cpu = torch.device("cpu")
    steps, kps_all = [], np.zeros((S, Fmax, Kmax, 2), np.float32)
    q0 = np.zeros((S, Fmax, 4), np.float32)
    t0 = np.zeros((S, Fmax, 3), np.float32)
    in0 = np.zeros((S, Fmax, 4), np.float32)
    for s, (traj, plan, seed) in enumerate(zip(trajs, plans, seeds)):
        first = traj.first_frame
        # Rows past a segment's end repeat its last frame with no flows:
        # no correspondences, so they leave the carry alone.
        last = plan[-1][:2] if plan else (first, first)
        plan = plan + [(*last, [])] * (n_steps - len(plan))
        steps.append(pack_steps(plan, first, G, K, cpu))
        for f, k in kps[s].items():
            kps_all[s, f - first, : k.shape[0]] = k
        # Every frame's carry starts at the seed camera.
        it = seed.intrinsics
        q0[s], t0[s] = _host(seed.pose.q), _host(seed.pose.t)
        in0[s] = [float(it.fx), float(it.fy), float(it.cx), float(it.cy)]
    steps = [torch.stack(parts, dim=1) for parts in zip(*steps)]  # (T, S, …)
    ci = seeds[0].intrinsics
    const5 = torch.tensor(
        [float(ci.aspect_ratio), float(ci.width), float(ci.height),
         float(ci.sign), MAX_INLIER_ERROR], dtype=torch.float32)
    model = np.asarray(_host(model_matrix), np.float32)
    model_inv = np.linalg.inv(np.asarray(model, np.float64)).astype(
        np.float32)

    runs = []
    for dev, (lo, hi) in zip(devices, shards(S, len(devices))):
        on = lambda a: torch.as_tensor(a).to(dev).contiguous()  # noqa: E731
        runs.append(dict(
            dev=dev, mesh=mesh_on(mesh, dev), model=on(model),
            model_inv=on(model_inv),
            const5=on(const5), kps=on(kps_all[lo:hi]),
            carry=tuple(on(a[lo:hi]) for a in (q0, t0, in0)),
            steps=[on(a[:, lo:hi]) for a in steps], counts=[],
        ))
    # Step r of every shard before step r + 1 of any: the launches are
    # asynchronous, so the devices step together.
    for r in range(n_steps):
        for run in runs:
            with current(run["dev"]):
                _, count = _cast_and_solve(
                    run["mesh"], run["model"], run["model_inv"],
                    run["carry"], run["const5"], run["kps"],
                    *(a[r] for a in run["steps"]), opt_f, opt_pp, opts,
                )
            run["counts"].append(count)

    counts = np.concatenate(
        [torch.stack(run["counts"], dim=1).cpu().numpy() for run in runs])
    q_all, t_all, in_all = (
        np.concatenate([run["carry"][i].cpu().numpy() for run in runs])
        for i in range(3))
    for s, (traj, seed) in enumerate(zip(trajs, seeds)):
        for r in range(traj.count - 1):
            if counts[s, r] < 3:
                continue
            i = r + 1  # the frame solved at step r
            vec = np.concatenate([q_all[s, i], t_all[s, i], in_all[s, i]])
            traj.set(traj.first_frame + i,
                     result_camera(vec, seed.intrinsics.to("cpu")))
    return counts.astype(np.int32)
