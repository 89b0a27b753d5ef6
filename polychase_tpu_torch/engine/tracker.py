"""Sequential frame-by-frame pose tracking.

Port of ``polychase_tpu/engine/tracker.py``.  The chain is sequential (each
frame warm-starts from its neighbour), and everything inside a frame runs on
the device:

- the rays of every flow into the frame are built from the carried source
  poses and cast at once (``raycast_grouped``);
- the PnP solve is one launch of the whole-solve LM kernel on a CUDA device
  (``kernels/pnp_lm.py``), or its plain torch version on the CPU.

The reference's ``lax.scan`` over 32-frame chunks becomes a Python loop over
frames on one stream, with the carry ``(q_all, t_all, in_all)`` on the
device and the ``count >= 3`` fallback a ``torch.where``.  Results come to
the host once per ``FLUSH_FRAMES`` frames, for the callback and the
trajectory, with the reference's streaming and cancel semantics.  One path
serves every segment length.  The frame step (``_cast_and_solve``) has a
leading segment axis: the sequential chain steps one segment,
``parallel.tracking`` steps S of them with one ray cast and one PnP launch.

The chain's host phases are ``torch.profiler`` spans, so that a trace
charges each idle stretch of the device to the phase the host was in:
``track.setup`` (the plan, the initial carry and the uploads, once a pass),
``track.pack`` (a chunk's inputs), ``track.step`` (one frame step) and
``track.deliver`` (a chunk's results to the callback and the trajectory).
The read of a chunk's results lies outside them: the host waits there
while the device works.  A span opens once a frame or a chunk, not once a
pass: the benchmark's reduction (``portbench/trace.py``) looks for the
span open at an idle moment only among the 4096 host events before it.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..io.database import Database

from ..backend import as_device
from ..kernels.pnp_lm import solve_arrays_lm
from . import camera as C
from . import pose as P
from .geometry import Mesh, SceneTransformations
from .levmarq import BundleOptions, BundleStats
from .pnp import normalize_bundle_opts, result_camera, result_stats
from .raycast import raycast_grouped
from .trajectory import CameraTrajectory


@dataclass
class FrameTrackingResult:
    """Per-frame tracking output."""

    frame: int
    pose: P.Pose
    intrinsics: C.Intrinsics
    bundle_stats: BundleStats
    inlier_ratio: float


# TrackingCallback: FrameTrackingResult -> continue?
TrackingCallback = Callable[[FrameTrackingResult], bool]

# Max reprojection error (px) for the inlier ratio.
MAX_INLIER_ERROR = 12.0

# Frames whose results come to the host together: the callback and cancel
# granularity of a run.
FLUSH_FRAMES = 32

_log = logging.getLogger(__name__)


class TrackingError(RuntimeError):
    pass


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t))


def unproject_np(intrinsics: C.Intrinsics, pixels: np.ndarray) -> np.ndarray:
    """Host float64 copy of ``camera.unproject``."""
    s = float(intrinsics.sign)
    p = np.asarray(pixels, np.float64).reshape(-1, 2)
    return np.stack(
        [
            s * (p[:, 0] - float(intrinsics.cx)) / float(intrinsics.fx),
            s * (p[:, 1] - float(intrinsics.cy)) / float(intrinsics.fy),
            np.full(p.shape[0], s),
        ],
        axis=-1,
    )


def _cast_and_solve(mesh, model, model_inv, carry, const5, kps_all, src_idx,
                    kp_idx, cnt, tgt, tgt_i, warm_i, opt_f, opt_pp, opts):
    """One frame step of S chains on the device: rays from the carried
    source cameras, one ray cast of all S·G groups, one batched PnP solve
    (S solves of G·K points), and the carry update (in place) where a
    solve had at least 3 correspondences.

    ``carry`` is (q (S, F, 4), t (S, F, 3), intrinsics (S, F, 4)),
    ``kps_all`` (S, F, Kmax, 2); ``src_idx``, ``cnt`` (S, G), ``kp_idx``
    (S, G, K), ``tgt`` (S, G, K, 2); ``tgt_i`` and ``warm_i`` (S,).
    Returns the (S, 19) results and the (S,) correspondence counts, both
    on the device."""
    q_all, t_all, in_all = carry
    S, G, K = kp_idx.shape
    s_idx = torch.arange(S, device=kp_idx.device)
    kp = kps_all[s_idx[:, None, None], src_idx[:, :, None], kp_idx]
    val = torch.arange(K, device=kp.device) < cnt[:, :, None]
    qs = q_all[s_idx[:, None], src_idx].reshape(S * G, 4)
    ts = t_all[s_idx[:, None], src_idx].reshape(S * G, 3)
    ins = in_all[s_idx[:, None], src_idx].reshape(S * G, 4)
    intr_b = C.Intrinsics(
        fx=ins[:, 0, None], fy=ins[:, 1, None], cx=ins[:, 2, None],
        cy=ins[:, 3, None], aspect_ratio=const5[0], width=const5[1],
        height=const5[2], sign=const5[3],
    )
    dir_cam = C.unproject(intr_b, kp.reshape(S * G, K, 2))  # (S·G, K, 3)
    dir_w = P.quat_rotate(P.quat_conj(qs)[:, None, :], dir_cam)
    origin_w = P.pose_center(P.Pose(qs, ts))               # (S·G, 3)
    origin_o = origin_w @ model_inv[:3, :3].T + model_inv[:3, 3]
    dir_o = dir_w @ model_inv[:3, :3].T

    hits = raycast_grouped(mesh, origin_o, dir_o, True)
    m = (hits.valid & val.reshape(S * G, K)).reshape(S, G * K)
    X = hits.pos.reshape(S, G * K, 3) @ model[:3, :3].T + model[:3, 3]
    weights = m.to(torch.float32)
    params = torch.cat(
        [q_all[s_idx, warm_i], t_all[s_idx, warm_i], in_all[s_idx, warm_i],
         const5.expand(S, 5)], dim=1,
    )  # the 16-float solve_arrays layout
    vec = solve_arrays_lm(
        X, tgt.reshape(S, G * K, 2), weights, m, params,
        opt_f=opt_f, opt_pp=opt_pp, opts=opts,
    )
    count = m.sum(dim=1)
    ok = (count >= 3)[:, None]
    q_all[s_idx, tgt_i] = torch.where(ok, vec[:, 0:4], q_all[s_idx, tgt_i])
    t_all[s_idx, tgt_i] = torch.where(ok, vec[:, 4:7], t_all[s_idx, tgt_i])
    in_all[s_idx, tgt_i] = torch.where(ok, vec[:, 7:11],
                                       in_all[s_idx, tgt_i])
    return vec, count


def _check_flow_indices(plan, kps) -> None:
    """The device gather does not check its indices: check the DB's."""
    for _, _, gs in plan:
        for src_f, idx, _ in gs:
            if int(idx.max()) >= kps.get(src_f, np.empty((0, 2))).shape[0]:
                raise TrackingError(
                    f"flow from frame {src_f} indexes past its keypoints"
                )


def pack_steps(plan, first: int, G: int, K: int, dev):
    """The per-step inputs of one chain's ``plan`` (``_plan``'s rows), padded
    to G groups of K keypoints, on ``dev``: ``src_idx``, ``cnt`` (T, G),
    ``kp_idx`` (T, G, K), ``tgt`` (T, G, K, 2), ``tgt_i`` and ``warm_i``
    (T,), frames counted from ``first``."""
    T = len(plan)
    src_idx = np.zeros((T, G), np.int64)
    kp_idx = np.zeros((T, G, K), np.int64)
    cnt = np.zeros((T, G), np.int64)
    tgt = np.zeros((T, G, K, 2), np.float32)
    tgt_i = np.zeros((T,), np.int64)
    warm_i = np.zeros((T,), np.int64)
    for r, (frame_id, warm, groups) in enumerate(plan):
        tgt_i[r], warm_i[r] = frame_id - first, warm - first
        for g, (src_f, idx, tpx) in enumerate(groups):
            n = idx.shape[0]
            src_idx[r, g] = src_f - first
            kp_idx[r, g, :n] = idx
            cnt[r, g] = n
            tgt[r, g, :n] = tpx
    return tuple(torch.as_tensor(a, device=dev) for a in (
        src_idx, kp_idx, cnt, tgt, tgt_i, warm_i))


def _plan(database: Database, camera_traj: CameraTrajectory, frames,
          direction: int, available=None):
    """Host half of the gather: for each frame, its warm-start frame and
    the flows into it from frames that will be solved by then.  Those are
    the frames in ``available`` (by default every filled frame of the
    trajectory) and the frames solved before it."""
    first = camera_traj.first_frame
    if available is None:
        available = {
            fid for fid in range(first, first + camera_traj.count)
            if camera_traj.is_frame_filled(fid)
        }
    available = set(available)
    flows_by_tgt = database.read_flows_to_image_range(
        first, first + camera_traj.count - 1
    )
    plan = []
    for frame_id in frames:
        groups = []
        for flow in flows_by_tgt.get(frame_id, ()):
            if flow.image_id_from == frame_id:
                raise TrackingError("self-flow in database")
            if flow.image_id_from not in available:
                continue
            if flow.src_kps_indices.size == 0:
                continue
            groups.append(
                (flow.image_id_from, flow.src_kps_indices, flow.tgt_kps)
            )
        for cand in (frame_id, frame_id - 1, frame_id + 1):
            if cand in available:
                warm = cand
                break
        else:
            warm = frame_id - direction
        plan.append((frame_id, warm, groups))
        available.add(frame_id)
    return plan


def _track_chain(database, camera_traj, frames, direction, model_matrix,
                 mesh: Mesh, callback, opt_f, opt_pp, opts, device):
    first = camera_traj.first_frame
    F = camera_traj.count
    with record_function("track.setup"):
        plan = _plan(database, camera_traj, frames, direction)

        ci = camera_traj.get(frames[0] - direction).intrinsics.to("cpu")
        const5 = torch.tensor(
            [float(ci.aspect_ratio), float(ci.width), float(ci.height),
             float(ci.sign), MAX_INLIER_ERROR],
            dtype=torch.float32, device=device,
        )
        # Initial carry from the host trajectory.
        q0 = np.zeros((F, 4), np.float32)
        q0[:, 0] = 1.0
        t0 = np.zeros((F, 3), np.float32)
        in0 = np.zeros((F, 4), np.float32)
        in0[:] = [float(ci.fx), float(ci.fy), float(ci.cx), float(ci.cy)]
        for i, state in enumerate(camera_traj.states):
            if state is not None:
                q0[i] = _host(state.pose.q)
                t0[i] = _host(state.pose.t)
                it = state.intrinsics
                in0[i] = [float(it.fx), float(it.fy), float(it.cx),
                          float(it.cy)]
        dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        carry = (dev(q0[None]), dev(t0[None]), dev(in0[None]))

        # One padded shape for the run: G groups of K keypoints per frame.
        G = max([len(gs) for _, _, gs in plan] + [1])
        K = max([g[1].shape[0] for _, _, gs in plan for g in gs] + [1])

        # Clip-wide keypoint table on the device; each frame gathers its
        # source keypoints by index.
        src_frames = sorted({s for _, _, gs in plan for s, _, _ in gs})
        kps = database.read_keypoints_range(
            min(src_frames, default=0), max(src_frames, default=0)
        )
        Kmax = max([kps.get(f, np.empty((0, 2))).shape[0] for f in src_frames]
                   + [1])
        kps_all = np.zeros((1, F, Kmax, 2), np.float32)
        for f in src_frames:
            k = kps.get(f, np.empty((0, 2), np.float32))
            kps_all[0, f - first, : k.shape[0]] = k
        _check_flow_indices(plan, kps)
        kps_all = dev(kps_all)

        model = dev(np.asarray(_host(model_matrix), np.float32))
        model_inv = dev(
            np.linalg.inv(np.asarray(_host(model_matrix), np.float64)).astype(
                np.float32
            )
        )

    for c0 in range(0, len(plan), FLUSH_FRAMES):
        chunk = plan[c0:c0 + FLUSH_FRAMES]
        # Exact-f32 per-chunk inputs, uploaded once per chunk.
        with record_function("track.pack"):
            steps = pack_steps(chunk, first, G, K, device)
        vecs, counts = [], []
        for r in range(len(chunk)):
            with record_function("track.step"):
                vec, count = _cast_and_solve(
                    mesh, model, model_inv, carry, const5, kps_all,
                    *(a[r:r + 1] for a in steps), opt_f, opt_pp, opts,
                )
            vecs.append(vec)
            counts.append(count)
        vecs_h = torch.cat(vecs).cpu().numpy()
        counts_h = torch.cat(counts).cpu().numpy()

        with record_function("track.deliver"):
            for r, (frame_id, _, _) in enumerate(chunk):
                vec, count = vecs_h[r], int(counts_h[r])
                if count < 3:
                    _log.info(
                        "frame %d: only %d correspondences, cannot solve",
                        frame_id, count,
                    )
                    raise TrackingError(
                        f"Could not track to frame: {frame_id}. "
                        "Not enough features."
                    )
                camera = result_camera(vec, ci)
                if callback is not None:
                    ok = callback(
                        FrameTrackingResult(
                            frame=frame_id, pose=camera.pose,
                            intrinsics=camera.intrinsics,
                            bundle_stats=result_stats(vec),
                            inlier_ratio=float(vec[18]),
                        )
                    )
                    if not ok:
                        return
                camera_traj.set(frame_id, camera)


def track_camera_trajectory(
    database: Database,
    camera_traj: CameraTrajectory,
    frame_from: int,
    frame_to_inclusive: int,
    model_matrix,
    mesh: Mesh,
    callback: Optional[TrackingCallback] = None,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    bundle_opts: BundleOptions = BundleOptions(),
    *,
    device,
) -> None:
    """Chain solves frame by frame from ``frame_from`` to
    ``frame_to_inclusive`` on ``device`` (the mesh must live there).

    The callback may return False to stop; solved poses are written into
    ``camera_traj`` (as CPU tensors) as they are produced.  A frame with
    fewer than 3 correspondences raises :class:`TrackingError`.

    Unless ``bundle_opts`` sets ``function_tol``, solves stop at a relative
    function tolerance of ``POLYCHASE_TRACK_FTOL`` (default 1e-5; 0 gives
    the reference's exits exactly).
    """
    device = as_device(device)
    if mesh.vertices.device != device:
        raise ValueError(f"mesh is on {mesh.vertices.device}, not {device}")
    first = min(frame_from, frame_to_inclusive)
    last = max(frame_from, frame_to_inclusive)
    direction = 1 if frame_from < frame_to_inclusive else -1
    if not (camera_traj.is_valid_frame(first)
            and camera_traj.is_valid_frame(last)):
        raise TrackingError("tracking range outside trajectory")
    if not camera_traj.is_frame_filled(frame_from):
        raise TrackingError("start frame has no pose")

    frames = list(
        range(frame_from + direction, frame_to_inclusive + direction,
              direction)
    )
    if not frames:
        return
    opts = normalize_bundle_opts(bundle_opts)
    if opts.function_tol == 0.0:
        ftol = float(os.environ.get("POLYCHASE_TRACK_FTOL", "1e-5"))
        if ftol > 0.0:
            opts = replace(opts, function_tol=ftol)
    _track_chain(
        database, camera_traj, frames, direction, model_matrix, mesh,
        callback, bool(optimize_focal_length),
        bool(optimize_principal_point), opts, device,
    )


def track_sequence(
    database_path: str,
    frame_from: int,
    frame_to_inclusive: int,
    scene_transform: SceneTransformations,
    mesh: Mesh,
    callback: Optional[TrackingCallback] = None,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    bundle_opts: BundleOptions = BundleOptions(),
    *,
    device,
) -> None:
    """Seed a trajectory from the scene transform and track."""
    db = Database(database_path)
    try:
        traj = CameraTrajectory(
            min(frame_from, frame_to_inclusive),
            abs(frame_to_inclusive - frame_from) + 1,
        )
        view = torch.as_tensor(_host(scene_transform.view_matrix),
                               dtype=torch.float32)
        traj.set(
            frame_from,
            C.CameraState(scene_transform.intrinsics, P.pose_from_rt(view)),
        )
        track_camera_trajectory(
            db, traj, frame_from, frame_to_inclusive,
            _host(scene_transform.model_matrix), mesh, callback,
            optimize_focal_length, optimize_principal_point, bundle_opts,
            device=device,
        )
    finally:
        db.close()
