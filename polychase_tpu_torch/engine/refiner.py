"""Trajectory refinement: global bundle adjustment over a frame segment.

Port of ``polychase_tpu/engine/refiner.py``.  Every frame's camera is
re-solved jointly against all flow edges of the segment:

- all (edge, match) residuals and their analytic Jacobian chains
  (unproject → center/derotate → ray-plane intersect → apply → project) are
  evaluated in one batch of torch ops;
- JᵀJ is assembled dense with ``index_put_(accumulate=True)`` and solved by
  the damped Cholesky, or by the block-tridiagonal solve when every edge
  spans few frames (``compute_band``);
- the per-(frame, keypoint) intersection cache is a prim-id tensor (-1 for
  none) refreshed by one ray-cast sweep at the start and after every
  accepted step; between refreshes the cached triangle is intersected
  analytically, bounded for the cost's validity and as a plane for the
  Jacobians;
- the first and last frames are anchors: zero Jacobians, never stepped;
- edge weight 1/(1 + distance of the source frame from the nearer end),
  and each edge's cost normalised by its valid match count.

The LM schedule is the reference's host driver: each iteration enqueues the
rebuild (when needed), the solve, the step and the candidate cost, and reads
back one vector of scalars, its one host sync.  The refreshed cost of an
accepted step rides in the next iteration's read; the progress callback of
that step runs once it has landed, before anything of the next iteration is
applied, so callback, cancel and stats keep the reference's semantics.
``refine_trajectory``'s host phases are ``torch.profiler`` spans beside
the device stages' labels: ``refine.data`` (the DB read),
``refine.setup`` (the uploads, the first refresh and its cost),
``refine.iteration`` (one pass of the LM loop) and ``refine.finish`` (the
last read and the write-back), so that a trace charges each idle stretch
of the device to one of them.
The prim refresh casts on the device (``raycast_grouped``, whose route
the mesh's size picks: K5's sweep, or K6's walk through the mesh's grid),
or through the host BVH of the port's ``native`` for meshes of
``BVH_TRIANGLE_THRESHOLD`` triangles or more that the grid route does not
take on a card (``_bvh_refresh``).

Given several devices, ``refine_trajectory`` takes the reference's
multi-device path (its ``device_mesh``): the normal equations are built
with the flow edges split over the devices (``parallel.sharded``) and the
device prim refresh casts its frames' ray groups split over them
(``parallel.raycast.split_cast``, where the reference casts each ray as a
group of one); the host BVH route, the LM driver and the band choice stay
as they are.

:class:`LockstepLM` is the reference's device-resident LM schedule
(``lm_chunk_device``) with a leading segment axis: S independent segments
stacked into one problem of S·F frames, each with its own state vector and
its own accept, reject and exit decisions, one iteration of all of them per
step.  ``parallel.segments.refine_segments`` runs it.

Not ported, by design: ``POLYCHASE_DEVICE_LM`` and ``POLYCHASE_LM_CHUNK``
(the reference's chunked replay of that schedule inside
``refine_trajectory``, a TPU answer to dispatch cost that its tests hold
equal to the host driver); the fused ``rebuild_and_try_lm_step`` (one jit
instead of two; here a plain sequence of calls); ``_pad_edges_to`` (TPU
layout: the edge shards may be uneven); ``POLYCHASE_BAND_SOLVE``; and the
TPU padding of K, M and E, which is layout, not semantics.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..io.database import Database

from ..backend import HostCopy, as_device, current
from ..parallel import resolve_devices
from . import camera as C
from . import pose as P
from .geometry import Mesh
from .levmarq import (
    BundleOptions,
    BundleStats,
    damped_block_tridiag_solve,
    damped_cholesky_solve,
    loss_value,
    loss_weight,
)
from .pnp import normalize_bundle_opts
from .raycast import (
    INVALID_ID,
    grid_route,
    intersect_ray_plane_jac,
    intersect_ray_triangle,
    raycast_grouped,
)
from .trajectory import CameraTrajectory

_INVALID = -1
_log = logging.getLogger(__name__)

# Triangle count from which the prim refresh casts through the host BVH
# instead of the device sweep (K5 on a card).  For config 4's
# 32,000 rays on an NVIDIA H100 80GB HBM3 at 700.00 W, in turns, the sweep
# won up to 1,258,200 triangles (59.4-59.6 ms per refresh against the
# single-threaded host BVH's 69.5-72.3; 4.2-6.5 ms against 24.6-36.1 from
# 1,472 to 20,224) and the BVH at 1,998,000 (85.1-85.5 ms against
# 93.4-93.6); the two cross near 1.7M, the BVH's build (0.54-0.85 s there,
# once a refine) not counted (``crossover.py``; PERF.md, section 6).  A
# mesh on the CPU, which only a caller that asks for the CPU gives, takes
# the same threshold; its own crossover is not measured.
BVH_TRIANGLE_THRESHOLD = 1_600_000


class RefineTrajectoryUpdate(NamedTuple):
    """Progress message."""

    progress: float
    message: str
    stats: Optional[BundleStats]


RefineTrajectoryCallback = Callable[[RefineTrajectoryUpdate], bool]


# ---------------------------------------------------------------------------
# Problem data (host-side packing)
# ---------------------------------------------------------------------------


@dataclass
class TrajParams:
    """Per-frame camera parameters as stacked tensors (the BA unknowns)."""

    q: torch.Tensor   # (F, 4)
    t: torch.Tensor   # (F, 3)
    fx: torch.Tensor  # (F,)
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor


@dataclass
class RefinerData:
    """The problem on the device.  Index tensors are int64."""

    kps: torch.Tensor          # (F, K, 2) filtered source keypoints
    kp_valid: torch.Tensor     # (F, K) bool
    src_frame: torch.Tensor    # (E,) frame index (0-based)
    tgt_frame: torch.Tensor    # (E,)
    src_kp: torch.Tensor       # (E, M) index into kps[src_frame]
    tgt_px: torch.Tensor       # (E, M, 2)
    match_valid: torch.Tensor  # (E, M) bool
    edge_weight: torch.Tensor  # (E,)
    edge_valid: torch.Tensor   # (E,) bool
    anchor: torch.Tensor       # (F,) bool, ground-truth frames
    aspect: torch.Tensor       # () aspect ratio, or (F,) in a stack
    conv_sign: torch.Tensor    # () +1 OpenCV / -1 OpenGL, or (F,)


_STATE_FIELDS = {
    "q": lambda s: s.pose.q, "t": lambda s: s.pose.t,
    "fx": lambda s: s.intrinsics.fx, "fy": lambda s: s.intrinsics.fy,
    "cx": lambda s: s.intrinsics.cx, "cy": lambda s: s.intrinsics.cy,
    "aspect": lambda s: s.intrinsics.aspect_ratio,
    "width": lambda s: s.intrinsics.width,
    "height": lambda s: s.intrinsics.height,
    "sign": lambda s: s.intrinsics.sign,
}


def _host_states(traj: CameraTrajectory) -> dict:
    """Every frame's camera as host float32 arrays, one copy per field:
    ``q`` (F, 4), ``t`` (F, 3) and (F,) for the rest."""
    states = [traj.get(f) for f in range(traj.first_frame,
                                         traj.last_frame + 1)]
    out = {}
    for name, get in _STATE_FIELDS.items():
        ts = [torch.as_tensor(get(s)).reshape(-1) for s in states]
        if all(t.device == ts[0].device for t in ts):
            arr = torch.stack(ts).cpu().numpy()
        else:
            arr = np.stack([t.cpu().numpy() for t in ts])
        arr = arr.astype(np.float32)
        out[name] = arr if name in ("q", "t") else arr[:, 0]
    return out


def _compute_bbox(fx, fy, cx, cy, q, t, mesh_bbox_h, model_matrix):
    """Image-space mesh bbox plus a 20 px pad, host float64."""
    intr = C.Intrinsics(fx, fy, cx, cy, None, None, None, None)
    rt = np.eye(4)
    rt[:3, :3] = P.quat_to_mat_np(q)
    rt[:3, 3] = np.asarray(t, np.float64)
    mvp = (C.proj_matrix_4x4_np(intr) @ rt
           @ np.asarray(model_matrix, np.float64))
    lo = np.asarray(mesh_bbox_h[0], np.float64)
    hi = np.asarray(mesh_bbox_h[1], np.float64)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    hom = np.concatenate([corners, np.ones((8, 1))], axis=-1) @ mvp.T
    xy = hom[:, :2] / hom[:, 3:4]
    pad = 20.0
    return xy.min(axis=0) - pad, xy.max(axis=0) + pad


def build_refiner_data(database: Database, traj: CameraTrajectory,
                       mesh: Mesh, model_matrix: np.ndarray, *,
                       device) -> RefinerData:
    """Load and filter the database into tensors on ``device``: keypoints
    inside each frame's padded mesh bbox, and the flow edges between
    frames of the segment, remapped to the kept keypoints."""
    device = as_device(device)
    first, last = traj.first_frame, traj.last_frame
    F = traj.count
    h = _host_states(traj)
    mesh_bbox_h = (mesh.bbox_min.cpu().numpy(), mesh.bbox_max.cpu().numpy())

    kps_list, remaps = [], []
    for i, frame_id in enumerate(range(first, last + 1)):
        kps = database.read_keypoints(frame_id)
        pmin, pmax = _compute_bbox(h["fx"][i], h["fy"][i], h["cx"][i],
                                   h["cy"][i], h["q"][i], h["t"][i],
                                   mesh_bbox_h, model_matrix)
        inside = (
            (kps[:, 0] > pmin[0]) & (kps[:, 0] < pmax[0])
            & (kps[:, 1] > pmin[1]) & (kps[:, 1] < pmax[1])
        )
        remap = np.full(len(kps), -1, np.int64)
        remap[inside] = np.arange(int(inside.sum()))
        kps_list.append(kps[inside])
        remaps.append(remap)

    K = max([len(k) for k in kps_list] + [1])
    kps_arr = np.zeros((F, K, 2), np.float32)
    kp_valid = np.zeros((F, K), bool)
    for i, k in enumerate(kps_list):
        kps_arr[i, :len(k)] = k
        kp_valid[i, :len(k)] = True

    edges = []
    for frame_id in range(first, last + 1):
        for tgt_id in database.find_optical_flows_from_image(frame_id):
            if not first <= tgt_id <= last:
                continue
            flow = database.read_image_pair_flow(frame_id, tgt_id)
            if flow.src_kps_indices.size == 0:
                continue
            new_idx = remaps[frame_id - first][flow.src_kps_indices]
            keep = new_idx >= 0
            if not keep.any():
                continue
            edges.append((frame_id - first, tgt_id - first, new_idx[keep],
                          flow.tgt_kps[keep]))

    E = max(len(edges), 1)
    M = max([len(e[2]) for e in edges] + [1])
    src_frame = np.zeros(E, np.int64)
    tgt_frame = np.zeros(E, np.int64)
    src_kp = np.zeros((E, M), np.int64)
    tgt_px = np.zeros((E, M, 2), np.float32)
    match_valid = np.zeros((E, M), bool)
    edge_weight = np.zeros(E, np.float32)
    edge_valid = np.zeros(E, bool)
    for i, (sf, tf, idx, px) in enumerate(edges):
        src_frame[i], tgt_frame[i] = sf, tf
        src_kp[i, :len(idx)] = idx
        tgt_px[i, :len(idx)] = px
        match_valid[i, :len(idx)] = True
        # The source frame's weight: 1 / (1 + distance to the nearer end).
        edge_weight[i] = 1.0 / (min(sf, (F - 1) - sf) + 1.0)
        edge_valid[i] = True

    anchor = np.zeros(F, bool)
    anchor[0] = anchor[F - 1] = True
    dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return RefinerData(
        kps=dev(kps_arr), kp_valid=dev(kp_valid),
        src_frame=dev(src_frame), tgt_frame=dev(tgt_frame),
        src_kp=dev(src_kp), tgt_px=dev(tgt_px),
        match_valid=dev(match_valid), edge_weight=dev(edge_weight),
        edge_valid=dev(edge_valid), anchor=dev(anchor),
        aspect=dev(np.float32(h["aspect"][0])),
        conv_sign=dev(np.float32(h["sign"][0])),
    )


def traj_to_params(traj: CameraTrajectory, *, device) -> TrajParams:
    h = _host_states(traj)
    dev = lambda a: torch.as_tensor(a, device=as_device(device))  # noqa
    return TrajParams(*(dev(h[f]) for f in ("q", "t", "fx", "fy", "cx",
                                             "cy")))


def params_to_traj(params: TrajParams,
                   traj: CameraTrajectory) -> CameraTrajectory:
    """A copy of ``traj`` with ``params`` written in, as CPU tensors; each
    frame keeps its aspect, size and sign."""
    out = CameraTrajectory(traj.first_frame, traj.count)
    h = _host_states(traj)
    q, t, fx, fy, cx, cy = (a.cpu().numpy() for a in (
        params.q, params.t, params.fx, params.fy, params.cx, params.cy))
    s = lambda a: torch.tensor(np.float32(a))  # noqa: E731
    for i, fid in enumerate(range(traj.first_frame, traj.last_frame + 1)):
        intr = C.Intrinsics(
            s(fx[i]), s(fy[i]), s(cx[i]), s(cy[i]), s(h["aspect"][i]),
            s(h["width"][i]), s(h["height"][i]), s(h["sign"][i]),
        )
        pose = P.Pose(torch.as_tensor(q[i].copy()),
                      torch.as_tensor(t[i].copy()))
        out.set(fid, C.CameraState(intr, pose))
    return out


# ---------------------------------------------------------------------------
# Device programs
# ---------------------------------------------------------------------------


def _frame_intrinsics(params: TrajParams, data: RefinerData,
                      idx: torch.Tensor) -> C.Intrinsics:
    """Intrinsics gathered for frame indices ``idx``; width and height are
    unused by projection and left zero."""
    zeros = torch.zeros_like(params.fx[idx])

    def shared(v):  # one value for the segment, or one per stacked frame
        return v[idx] if v.dim() else v + zeros

    return C.Intrinsics(
        fx=params.fx[idx], fy=params.fy[idx],
        cx=params.cx[idx], cy=params.cy[idx],
        aspect_ratio=shared(data.aspect), width=zeros, height=zeros,
        sign=shared(data.conv_sign),
    )


def _column(intr: C.Intrinsics) -> C.Intrinsics:
    """(n,) intrinsics as (n, 1), to broadcast over the keypoints."""
    return C.Intrinsics(*(getattr(intr, f)[:, None] for f in (
        "fx", "fy", "cx", "cy", "aspect_ratio", "width", "height", "sign")))


def _all_rays(params: TrajParams, data: RefinerData, model_inv):
    """Object-space rays of every (frame, keypoint): origins (F, 3) and
    directions (F, K, 3)."""
    F = data.kps.shape[0]
    fidx = torch.arange(F, device=data.kps.device)
    intr = _column(_frame_intrinsics(params, data, fidx))
    dir_cam = C.unproject(intr, data.kps)
    origin_w = P.pose_center(P.Pose(params.q, params.t))
    dir_world = P.quat_rotate(P.quat_conj(params.q)[:, None, :], dir_cam)
    origin_o = origin_w @ model_inv[:3, :3].T + model_inv[:3, 3]
    dir_o = dir_world @ model_inv[:3, :3].T
    return origin_o, dir_o


def _bvh_refresh(device_type: str, num_triangles: int) -> bool:
    """True when the prim refresh of a mesh of ``num_triangles`` on a
    device of ``device_type`` belongs on the host BVH: from
    ``BVH_TRIANGLE_THRESHOLD`` triangles, but for a card's mesh that the
    cast layer sends to the grid (``raycast.grid_route``), which casts a
    refresh faster on the card than the BVH on the host."""
    if num_triangles < BVH_TRIANGLE_THRESHOLD:
        return False
    return not (device_type == "cuda" and grid_route(num_triangles))


def _refresh_routing(mesh: Mesh) -> bool:
    """True when the prim refresh casts through the host BVH: where
    :func:`_bvh_refresh` says so and the native library loads."""
    if not _bvh_refresh(mesh.vertices.device.type, mesh.num_triangles):
        return False
    from .. import native

    return native.available()


def _sweep_cast(mesh: Mesh, origins, dirs):
    return raycast_grouped(mesh, origins, dirs, check_mask=True)


def refresh_prims(params: TrajParams, data: RefinerData, mesh: Mesh,
                  model_inv, cast=_sweep_cast) -> torch.Tensor:
    """Ray cast of every (frame, keypoint) ray → prim ids (F, K), -1 where
    the ray misses, hits a masked triangle or has no keypoint.  ``cast(mesh,
    origins (F, 3), dirs (F, K, 3))`` returns the grouped ``RayHits``: the
    device sweep, ``raycast_grouped``, unless the caller gives another."""
    with record_function("refine.raycast"):
        origin_o, dir_o = _all_rays(params, data, model_inv)
        hits = cast(mesh, origin_o, dir_o)
        return torch.where(hits.valid & data.kp_valid, hits.prim_id,
                           _INVALID)


def refresh_prims_and_cost(params, data: RefinerData, mesh: Mesh, model,
                           model_inv, tri_corners, loss_scale, *,
                           loss_type: int, cast=_sweep_cast):
    """The accepted-step update: the prim refresh (by ``cast``, as
    :func:`refresh_prims` takes it) and the cost after it."""
    prims = refresh_prims(params, data, mesh, model_inv, cast)
    cost = total_cost(params, data, prims, tri_corners, model, model_inv,
                      loss_scale, loss_type=loss_type)
    return prims, cost


def _make_prim_refresher(data: RefinerData, mesh: Mesh, model, model_inv,
                         tri_corners, loss_scale, loss_type: int,
                         routing: Optional[bool] = None, devices=None):
    """``refresh(params) -> (prims, cost)`` on the route the mesh's size
    selects (``_refresh_routing``): the device sweep, or the host BVH with
    the rays copied to the host and the prims back.  With several
    ``devices`` the device sweep's ray groups, one a frame, are split over
    them."""
    if routing is None:
        routing = _refresh_routing(mesh)
    if not routing and devices is not None and len(devices) > 1:
        from ..parallel import mesh_on
        from ..parallel.raycast import split_cast

        meshes = [mesh_on(mesh, dev) for dev in devices]  # once per refine

        def cast(_, origins, dirs):
            return split_cast(devices, meshes, origins, dirs,
                              check_mask=True)
    elif not routing:
        cast = _sweep_cast
    if not routing:
        def refresh(params):
            return refresh_prims_and_cost(
                params, data, mesh, model, model_inv, tri_corners,
                loss_scale, loss_type=loss_type, cast=cast,
            )
        return refresh

    from .. import native

    bvh = native.BvhRaycaster(
        mesh.vertices.cpu().numpy(),
        mesh.triangles.cpu().numpy().astype(np.uint32),
    )
    masked_bits = mesh.to_numpy_mask()
    if not masked_bits.any():
        masked_bits = None
    kp_valid = data.kp_valid.cpu().numpy()
    F, K = kp_valid.shape
    device = data.kps.device

    def refresh(params):
        with record_function("refine.raycast"):
            origin_o, dir_o = _all_rays(params, data, model_inv)
            o = origin_o.cpu().numpy()
            d = dir_o.cpu().numpy()
            o_flat = np.ascontiguousarray(
                np.broadcast_to(o[:, None, :], (F, K, 3)).reshape(-1, 3))
            prim = bvh.raycast(o_flat, d.reshape(-1, 3), masked_bits)[4]
            prim = prim.reshape(F, K)
            valid = (prim != np.uint32(INVALID_ID)) & kp_valid
            prims = torch.as_tensor(
                np.where(valid, prim.astype(np.int64), _INVALID),
                device=device,
            )
        cost = total_cost(params, data, prims, tri_corners, model, model_inv,
                          loss_scale, loss_type=loss_type)
        return prims, cost

    return refresh


def _edge_eval(params: TrajParams, data: RefinerData, prims: torch.Tensor,
               tri_corners, model, model_inv, with_jac: bool, opt_f: bool,
               opt_pp: bool):
    """Every (edge, match) residual and, with ``with_jac``, its Jacobians.

    Returns ``res`` (E, M, 2), ``valid`` (E, M) and ``J_src``/``J_tgt``
    (E, M, 2, 9) or None."""
    sf, tf = data.src_frame, data.tgt_frame
    src_q, src_t = params.q[sf], params.t[sf]
    tgt_q, tgt_t = params.q[tf], params.t[tf]
    src_intr = _column(_frame_intrinsics(params, data, sf))
    tgt_intr = _column(_frame_intrinsics(params, data, tf))

    src_px = data.kps[sf[:, None], data.src_kp]            # (E, M, 2)
    prim = prims[sf[:, None], data.src_kp]                  # (E, M)
    prim_ok = prim != _INVALID
    safe_prim = torch.where(prim_ok, prim, 0)

    # The source ray in world space.
    R_src = P.quat_to_mat(src_q)                            # (E, 3, 3)
    dir_cam, _, dDirCam_dInt = C.unproject_with_jac(src_intr, src_px)
    origin, dOrigin_dR, dOrigin_dt = P.center_with_jac(R_src, src_t)
    Rt_src = R_src.transpose(-1, -2)
    dir_world = torch.einsum("eij,emj->emi", Rt_src, dir_cam)
    dDirWorld_dR = P.skew(dir_world)                        # (E, M, 3, 3)

    # The cached triangle in world space.
    p1o, p2o, p3o = tri_corners
    t1, t2, t3 = p1o[safe_prim], p2o[safe_prim], p3o[safe_prim]
    t1w = t1 @ model[:3, :3].T + model[:3, 3]
    # Normals transform with the inverse transpose.
    normal_w = P.cross(t2 - t1, t3 - t1) @ model_inv[:3, :3]

    origin_b = origin[:, None, :].expand_as(dir_world)
    X, dX_dOrigin, dX_dDir, isect_ok = intersect_ray_plane_jac(
        origin_b, dir_world, t1w, normal_w
    )

    # The target camera.
    R_tgt = P.quat_to_mat(tgt_q)
    XCam, dXCam_dX, dXCam_dR, _ = P.apply_with_jac(
        R_tgt[:, None].expand(*X.shape, 3), tgt_t[:, None, :].expand_as(X), X
    )
    behind = C.is_behind(tgt_intr, XCam)
    p, dp_dXCam, dp_dInt = C.project_with_jac(tgt_intr, XCam)
    res = p - data.tgt_px

    valid = data.match_valid & prim_ok & isect_ok & ~behind
    if not with_jac:
        # The cost also needs the ray to hit the bounded cached triangle,
        # tested, as in the reference, with the world-space ray against
        # the object-space corners.
        _, tri_ok = intersect_ray_triangle(origin_b, dir_world, t1, t2, t3)
        return res, valid & tri_ok, None, None

    ein = torch.einsum
    dp_dX = ein("emij,emjk->emik", dp_dXCam, dXCam_dX)
    # The source block.
    dX_dR = (ein("emij,ejk->emik", dX_dOrigin, dOrigin_dR)
             + ein("emij,emjk->emik", dX_dDir, dDirWorld_dR))
    Js_rot = ein("emij,emjk->emik", dp_dX, dX_dR)
    Js_t = ein("emij,emjk,ekl->emil", dp_dX, dX_dOrigin, dOrigin_dt)
    Js_int = ein("emij,emjk,ekl,emln->emin", dp_dX, dX_dDir, Rt_src,
                 dDirCam_dInt)
    # The target block.
    Jt_rot = ein("emij,emjk->emik", dp_dXCam, dXCam_dR)
    Jt_t, Jt_int = dp_dXCam, dp_dInt
    if not (opt_f or opt_pp):
        Js_int = torch.zeros_like(Js_int)
        Jt_int = torch.zeros_like(Jt_int)
    else:
        if not opt_f:
            Js_int[..., 0] = 0.0
            Jt_int[..., 0] = 0.0
        if not opt_pp:
            Js_int[..., 1:] = 0.0
            Jt_int[..., 1:] = 0.0

    J_src = torch.cat([Js_rot, Js_t, Js_int], dim=-1)      # (E, M, 2, 9)
    J_tgt = torch.cat([Jt_rot, Jt_t, Jt_int], dim=-1)
    # Anchor frames contribute no Jacobian.
    J_src = torch.where(data.anchor[sf][:, None, None, None], 0.0, J_src)
    J_tgt = torch.where(data.anchor[tf][:, None, None, None], 0.0, J_tgt)
    return res, valid, J_src, J_tgt


def _edge_costs(params, data: RefinerData, prims, tri_corners, model,
                model_inv, loss_scale, loss_type: int) -> torch.Tensor:
    """Each edge's weighted, per-edge-normalised robust cost, (E,)."""
    res, valid, _, _ = _edge_eval(
        params, data, prims, tri_corners, model, model_inv,
        with_jac=False, opt_f=False, opt_pp=False,
    )
    r2 = torch.sum(res * res, dim=-1)
    cost_m = torch.where(valid, loss_value(loss_type, loss_scale, r2), 0.0)
    n_valid = torch.clamp(valid.sum(dim=-1), min=1)
    edge_cost = cost_m.sum(dim=-1) / n_valid
    return torch.where(data.edge_valid, data.edge_weight * edge_cost, 0.0)


def total_cost(params, data: RefinerData, prims, tri_corners, model,
               model_inv, loss_scale, *, loss_type: int) -> torch.Tensor:
    """The per-edge-normalised robust cost, a 0-d tensor."""
    with record_function("refine.cost"):
        return _edge_costs(params, data, prims, tri_corners, model,
                           model_inv, loss_scale, loss_type).sum()


def segment_costs(params, data: RefinerData, prims, tri_corners, model,
                  model_inv, loss_scale, *, loss_type: int,
                  S: int) -> torch.Tensor:
    """:func:`total_cost` of each segment of a stack of S, (S,); each
    segment owns a contiguous run of the stack's edges."""
    with record_function("refine.cost"):
        return _edge_costs(params, data, prims, tri_corners, model,
                           model_inv, loss_scale, loss_type).reshape(
                               S, -1).sum(dim=1)


def _pair_systems(params, data: RefinerData, prims, tri_corners, model,
                  model_inv, loss_scale, loss_type: int, opt_f: bool,
                  opt_pp: bool, ppc: int):
    """Each edge's contribution to the normal equations: JᵀJ (E, 2·ppc,
    2·ppc) and Jᵀr (E, 2·ppc) over its source and target cameras, and the
    rows of the frame-major parameter vector they land on, (E, 2·ppc)."""
    res, valid, J_src, J_tgt = _edge_eval(
        params, data, prims, tri_corners, model, model_inv,
        with_jac=True, opt_f=opt_f, opt_pp=opt_pp,
    )
    E, M = valid.shape
    r2 = torch.sum(res * res, dim=-1)
    w = torch.where(valid, loss_weight(loss_type, loss_scale, r2), 0.0)

    n2 = 2 * ppc
    J_pair = torch.cat([J_src[..., :ppc], J_tgt[..., :ppc]], dim=-1)
    Jw = (J_pair * w[:, :, None, None]).reshape(E, M * 2, n2)
    JtJ_pair = Jw.transpose(1, 2) @ J_pair.reshape(E, M * 2, n2)
    Jtr_pair = torch.einsum("eki,ek->ei", Jw, res.reshape(E, M * 2))
    n_valid = torch.clamp(valid.sum(dim=-1), min=1).to(torch.float32)
    scale = torch.where(data.edge_valid, data.edge_weight / n_valid, 0.0)
    off = torch.arange(ppc, device=res.device)
    rows = torch.cat([data.src_frame[:, None] * ppc + off,
                      data.tgt_frame[:, None] * ppc + off], dim=1)
    return JtJ_pair * scale[:, None, None], Jtr_pair * scale[:, None], rows


def build_normal_equations(params, data: RefinerData, prims, tri_corners,
                           model, model_inv, loss_scale, *, loss_type: int,
                           opt_f: bool, opt_pp: bool, ppc: int):
    """Dense JᵀJ (P, P) and Jᵀr (P,) over all edges, P = F·ppc."""
    with record_function("refine.normal_equations"):
        JtJ_pair, Jtr_pair, rows = _pair_systems(
            params, data, prims, tri_corners, model, model_inv, loss_scale,
            loss_type, opt_f, opt_pp, ppc)
        E, n2 = rows.shape
        Pn = params.q.shape[0] * ppc
        # Scatter-add into the dense (F·ppc)² system.
        JtJ = torch.zeros((Pn, Pn), dtype=torch.float32, device=rows.device)
        JtJ.index_put_(
            (rows[:, :, None].expand(E, n2, n2),
             rows[:, None, :].expand(E, n2, n2)),
            JtJ_pair, accumulate=True,
        )
        Jtr = torch.zeros((Pn,), dtype=torch.float32, device=rows.device)
        Jtr.index_put_((rows,), Jtr_pair, accumulate=True)
        return JtJ, Jtr


def segment_normal_equations(params, data: RefinerData, prims, tri_corners,
                             model, model_inv, loss_scale, *, loss_type: int,
                             opt_f: bool, opt_pp: bool, ppc: int, S: int):
    """:func:`build_normal_equations` of each segment of a stack of S:
    JᵀJ (S, P, P) and Jᵀr (S, P), P = F·ppc of one segment."""
    with record_function("refine.normal_equations"):
        JtJ_pair, Jtr_pair, rows = _pair_systems(
            params, data, prims, tri_corners, model, model_inv, loss_scale,
            loss_type, opt_f, opt_pp, ppc)
        E, n2 = rows.shape
        P = params.q.shape[0] // S * ppc
        # A stacked row s·P + r is row r of segment s's system.
        seg = torch.arange(E, device=rows.device) // (E // S)
        local = rows - (seg * P)[:, None]
        flat = ((seg * P * P)[:, None, None] + local[:, :, None] * P
                + local[:, None, :])
        JtJ = torch.zeros((S * P * P,), dtype=torch.float32,
                          device=rows.device)
        JtJ.index_put_((flat.reshape(-1),), JtJ_pair.reshape(-1),
                       accumulate=True)
        Jtr = torch.zeros((S * P,), dtype=torch.float32, device=rows.device)
        Jtr.index_put_((rows.reshape(-1),), Jtr_pair.reshape(-1),
                       accumulate=True)
        return JtJ.reshape(S, P, P), Jtr.reshape(S, P)


def solve_step(JtJ, Jtr, lam: float, band: tuple):
    """The damped step of one (P, P) system, and its ``ok``: ``band`` =
    ``(nb, bs)`` takes the block-tridiagonal solve on the system
    zero-padded to nb·bs, ``()`` the dense one."""
    if not band:
        lam_t = torch.full((1,), lam, dtype=JtJ.dtype, device=JtJ.device)
        step, ok = damped_cholesky_solve(JtJ[None], Jtr[None], lam_t)
        return step[0], ok[0]
    nb, bs = band
    n0, n = JtJ.shape[0], nb * bs
    JtJ_p = torch.zeros((n, n), dtype=JtJ.dtype, device=JtJ.device)
    JtJ_p[:n0, :n0] = JtJ
    Jtr_p = torch.zeros((n,), dtype=Jtr.dtype, device=Jtr.device)
    Jtr_p[:n0] = Jtr
    step, ok = damped_block_tridiag_solve(JtJ_p, Jtr_p, lam, nb=nb, bs=bs)
    return step[:n0], ok


def try_lm_step(JtJ, Jtr, params, data: RefinerData, prims, tri_corners,
                model, model_inv, loss_scale, lam: float, bounds: C.Bounds,
                *, loss_type: int, opt_f: bool, opt_pp: bool, ppc: int,
                band: tuple = ()):
    """Solve, step and candidate cost.  Returns ``(params_new, vec)`` with
    ``vec = [grad_norm, solve_ok, step_norm, cost_new, expected_decrease]``
    on the device.  ``band`` = ``(nb, bs)`` takes the block-tridiagonal
    solve, ``()`` the dense one."""
    with record_function("refine.solve"):
        step, ok = solve_step(JtJ, Jtr, lam, band)
    with record_function("refine.step"):
        step_norm = torch.linalg.vector_norm(step)
        params_new = apply_step(params, data, step, bounds, opt_f=opt_f,
                                opt_pp=opt_pp, ppc=ppc)
        expected = torch.dot(step, 2.0 * Jtr + JtJ @ step)
    cost_new = total_cost(params_new, data, prims, tri_corners, model,
                          model_inv, loss_scale, loss_type=loss_type)
    vec = torch.stack([
        torch.linalg.vector_norm(Jtr), ok.to(torch.float32), step_norm,
        cost_new, expected,
    ])
    return params_new, vec


def apply_step(params: TrajParams, data: RefinerData, step,
               bounds: C.Bounds, *, opt_f: bool, opt_pp: bool,
               ppc: int) -> TrajParams:
    """Step every non-anchor camera; f and pp are clamped to the bounds."""
    F = params.q.shape[0]
    dp = torch.where(data.anchor[:, None], 0.0, step.reshape(F, ppc))
    q = P.quat_step_post(params.q, dp[:, 0:3])
    t = params.t + dp[:, 3:6]
    fx, fy, cx, cy = params.fx, params.fy, params.cx, params.cy
    if opt_f:
        fy = torch.clamp(fy + dp[:, 6], bounds.f_low, bounds.f_high)
        fx = torch.clamp(fy * data.aspect, bounds.f_low, bounds.f_high)
    if opt_pp:
        cx = torch.clamp(cx + dp[:, 7], bounds.cx_low, bounds.cx_high)
        cy = torch.clamp(cy + dp[:, 8], bounds.cy_low, bounds.cy_high)
    return TrajParams(q, t, fx, fy, cx, cy)


def compute_band(data: RefinerData, F: int, ppc: int) -> tuple:
    """``(nb, bs)`` for the block-tridiagonal solve, or ``()`` for dense.

    When every edge spans at most S frames, super-blocks of S frames make
    the normal matrix block-tridiagonal.  Segments of fewer than 6 blocks
    keep the dense solve."""
    span_arr = (torch.abs(data.src_frame - data.tgt_frame)
                * data.edge_valid).cpu().numpy()
    span = max(int(span_arr.max()) if span_arr.size else 1, 1)
    nb = -(-F // span)
    if nb < 6:
        return ()
    return (nb, span * ppc)


# ---------------------------------------------------------------------------
# Lockstep LM over a stack of segments
# ---------------------------------------------------------------------------

# Columns of a segment's state vector (the reference's ``scal``).
COST, LAM, V, REBUILD, DONE, INVALID, ITERS, BUDGET = range(8)


class LockstepLM:
    """The reference's device-resident LM schedule (``lm_chunk_device``,
    ``polychase_tpu/engine/refiner.py:868-1002``) on a stack of S segments.

    ``params`` and ``data`` hold S segments of F frames each, frame-major
    (frame f of segment s at s·F + f, every edge of segment s among edges
    [s·E, (s+1)·E) and indexing its own frames); ``prims`` (S·F, K) are
    their cached hits; ``scal`` (S, 8) is each segment's state [cost, λ, v,
    rebuild, done, invalid steps, counted iterations, budget]; ``bounds``
    holds one value per stacked frame; ``tol`` = (gradient_tol, step_tol,
    min_lambda, max_lambda, function_tol), ``function_tol`` 0 disabling the
    stagnation exit.  A segment's iteration follows the reference rule by
    rule: the normal equations are rebuilt where ``rebuild`` is set, the
    gradient exit is tested only then; an invalid solve, the step exit, an
    improved or a rejected step, the λ exit; ρ and the Nielsen factor;
    stagnation on an improved or rejected step; the budget of counted
    iterations; the prims refreshed after an improved step.  A done
    segment keeps its state.  Each iteration runs for every live segment,
    as the reference's ``vmap`` of its ``cond`` does, and is decided on the
    device; :meth:`iterate` only skips the rebuild when no live segment
    needs one.
    """

    def __init__(self, params: TrajParams, prims, scal, data: RefinerData,
                 mesh: Mesh, model, model_inv, tri_corners,
                 loss_scale: float, bounds: C.Bounds, tol, *,
                 loss_type: int, opt_f: bool, opt_pp: bool, ppc: int,
                 band: tuple = ()):
        self.params, self.prims, self.scal = params, prims, scal
        self.S = int(scal.shape[0])
        self.F = int(params.q.shape[0]) // self.S
        P = self.F * ppc
        f32 = dict(dtype=torch.float32, device=scal.device)
        self.JtJ = torch.zeros((self.S, P, P), **f32)
        self.Jtr = torch.zeros((self.S, P), **f32)
        self.data, self.mesh, self.bounds, self.band = data, mesh, bounds, band
        self.geom = (tri_corners, model, model_inv, loss_scale)
        self.model_inv = model_inv
        self.tol = tuple(float(t) for t in tol)
        self.kw = dict(loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp,
                       ppc=ppc)

    def _solve(self):
        lam = self.scal[:, LAM]
        if not self.band:
            return damped_cholesky_solve(self.JtJ, self.Jtr, lam)
        nb, bs = self.band
        P, n = self.JtJ.shape[1], nb * bs
        JtJ = self.JtJ.new_zeros((self.S, n, n))
        JtJ[:, :P, :P] = self.JtJ
        Jtr = self.Jtr.new_zeros((self.S, n))
        Jtr[:, :P] = self.Jtr
        step, ok = damped_block_tridiag_solve(JtJ, Jtr, lam, nb=nb, bs=bs)
        return step[:, :P], ok

    def iterate(self, scal_h: np.ndarray) -> None:
        """One LM iteration of every live segment.  ``scal_h`` is the host
        copy of ``scal`` at this point; it is read only to skip the rebuild
        when no live segment needs one."""
        S, F, kw = self.S, self.F, self.kw
        gtol, step_tol, min_lam, max_lam, ftol = self.tol
        data, params, prims = self.data, self.params, self.prims
        sc = self.scal
        cost, lam, v = sc[:, COST], sc[:, LAM], sc[:, V]
        rebuild, live = sc[:, REBUILD] > 0, sc[:, DONE] <= 0
        if ((scal_h[:, DONE] <= 0) & (scal_h[:, REBUILD] > 0)).any():
            JtJ, Jtr = segment_normal_equations(
                params, data, prims, *self.geom, S=S, **kw)
            sel = rebuild & live
            self.JtJ = torch.where(sel[:, None, None], JtJ, self.JtJ)
            self.Jtr = torch.where(sel[:, None], Jtr, self.Jtr)
        JtJ, Jtr = self.JtJ, self.Jtr
        with record_function("refine.solve"):
            step, ok = self._solve()
        with record_function("refine.step"):
            step_norm = torch.linalg.vector_norm(step, dim=1)
            grad_norm = torch.linalg.vector_norm(Jtr, dim=1)
            params_new = apply_step(params, data, step.reshape(-1),
                                    self.bounds, opt_f=kw["opt_f"],
                                    opt_pp=kw["opt_pp"], ppc=kw["ppc"])
            expected = (step * (2.0 * Jtr
                                + (JtJ @ step[:, :, None])[:, :, 0])).sum(1)
        cost_new = segment_costs(params_new, data, prims, *self.geom, S=S,
                                 loss_type=kw["loss_type"])

        grad_break = rebuild & (grad_norm < gtol)
        invalid = ~ok & ~grad_break
        stepped = ~grad_break & ~invalid
        step_break = stepped & (step_norm < step_tol)
        improved = stepped & ~step_break & (cost_new < cost)
        reject = stepped & ~step_break & ~improved
        bad = invalid | reject
        lam_break = bad & (lam >= max_lam)
        rho = torch.where(expected != 0.0, (cost_new - cost) / expected,
                          torch.full_like(cost, -1.0))
        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_accept = torch.where(
            rho > 0.0, torch.clamp(lam * factor, min_lam, max_lam), lam)
        lam_bad = torch.clamp(lam * v, max=max_lam)
        bad_cont = bad & ~lam_break

        # The prim refresh after an improved step, for every segment, kept
        # where the step improved.
        prims_new = refresh_prims(params_new, data, self.mesh,
                                  self.model_inv)
        cost_ref = segment_costs(params_new, data, prims_new, *self.geom,
                                 S=S, loss_type=kw["loss_type"])
        take = live & improved
        take_f = take.repeat_interleave(F)
        self.params = TrajParams(*(
            torch.where(take_f.reshape(-1, *[1] * (a.dim() - 1)), a, b)
            for a, b in zip(_fields(params_new), _fields(params))))
        self.prims = torch.where(take_f[:, None], prims_new, prims)

        counted = improved | ((reject | invalid) & ~lam_break)
        iters = sc[:, ITERS] + counted.to(torch.float32)
        stagnated = (torch.abs(cost_new - cost) <= ftol * cost if ftol > 0.0
                     else torch.zeros_like(live))
        done = (grad_break | step_break | lam_break
                | ((improved | reject) & stagnated) | (iters >= sc[:, BUDGET]))
        two = torch.full_like(v, 2.0)
        out = torch.stack([
            torch.where(improved, cost_ref, cost),
            torch.where(improved, lam_accept,
                        torch.where(bad_cont, lam_bad, lam)),
            torch.where(improved, two, torch.where(bad_cont, v * 2.0, v)),
            torch.where(improved, torch.ones_like(v),
                        torch.where(bad_cont, torch.zeros_like(v),
                                    sc[:, REBUILD])),
            done.to(torch.float32),
            sc[:, INVALID] + bad.to(torch.float32),
            iters,
            sc[:, BUDGET],
        ], dim=1)
        self.scal = torch.where(live[:, None], out, sc)


def _fields(p: TrajParams):
    return (p.q, p.t, p.fx, p.fy, p.cx, p.cy)


def run_lockstep(lms, n_iters: int) -> None:
    """Up to ``n_iters`` iterations of each :class:`LockstepLM` in ``lms``
    (one per device), interleaved so that the devices work together.  Each
    iteration reads each stack's state vector once, and a stack whose
    segments are all done stops; its results are then those of the full
    ``n_iters``."""
    live = list(lms)
    for _ in range(n_iters):
        reads = [(lm, HostCopy(lm.scal)) for lm in live]
        live = []
        for lm, read in reads:
            (scal_h,) = read.numpy()
            if (scal_h[:, DONE] > 0).all():
                continue
            with current(lm.scal.device):
                lm.iterate(scal_h)
            live.append(lm)
        if not live:
            break


# ---------------------------------------------------------------------------
# Host LM driver
# ---------------------------------------------------------------------------


def _read_scalars(vec: torch.Tensor) -> list:
    """The LM driver's one host sync per iteration."""
    return vec.cpu().tolist()


def refine_trajectory(database, traj: CameraTrajectory, model_matrix,
                      mesh: Mesh, optimize_focal_length: bool = False,
                      optimize_principal_point: bool = False,
                      callback: Optional[RefineTrajectoryCallback] = None,
                      bundle_opts: BundleOptions = BundleOptions(), *,
                      device) -> CameraTrajectory:
    """Refine a fully filled trajectory segment on ``device``; the refined
    states (CPU tensors) are written into ``traj``, which is returned.

    ``device`` is one device or a sequence of them.  With several, the
    normal equations and the device prim refresh are split over them (the
    module docstring) and everything else runs on the first; one device,
    or a list of one, is the single-device path.  ``database`` is a
    :class:`Database` or a path; ``mesh`` must live on the (first) device.
    Unless ``bundle_opts`` sets ``function_tol``, LM stops at a relative
    function tolerance of ``POLYCHASE_REFINE_FTOL`` (default 1e-5; 0 gives
    the reference's exits exactly).  ``callback`` receives a
    :class:`RefineTrajectoryUpdate` after every counted iteration and once
    at the end; returning False cancels."""
    devices = resolve_devices(device)
    device = devices[0]
    if traj.count <= 2:
        raise ValueError("refinement needs more than 2 frames")
    for fid in range(traj.first_frame, traj.last_frame + 1):
        if not traj.is_frame_filled(fid):
            raise ValueError(f"frame {fid} has no pose")
    if mesh.vertices.device != device:
        raise ValueError(f"mesh is on {mesh.vertices.device}, not {device}")

    opts = normalize_bundle_opts(bundle_opts)
    if opts.function_tol == 0.0:
        ftol = float(os.environ.get("POLYCHASE_REFINE_FTOL", "1e-5"))
        if ftol > 0.0:
            opts = replace(opts, function_tol=ftol)

    with record_function("refine.data"):
        own_db = isinstance(database, str)
        if own_db:
            database = Database(database)
        try:
            data = build_refiner_data(database, traj, mesh, model_matrix,
                                      device=device)
        finally:
            if own_db:
                database.close()

    with record_function("refine.setup"):
        opt_f = bool(optimize_focal_length)
        opt_pp = bool(optimize_principal_point)
        ppc = 9 if (opt_f or opt_pp) else 6
        loss_type, loss_scale = int(opts.loss_type), float(opts.loss_scale)
        model = torch.as_tensor(np.asarray(model_matrix, np.float32),
                                device=device)
        model_inv = torch.as_tensor(
            np.linalg.inv(np.asarray(model_matrix, np.float64)).astype(
                np.float32), device=device)
        tri_corners = mesh.triangle_corners()
        bounds = C.intrinsics_bounds(
            traj.get(traj.first_frame).intrinsics.to(device))
        _log.info("refine segment [%d, %d]: %d frames, %d edges, %d keypoint "
                  "slots", traj.first_frame, traj.last_frame, traj.count,
                  int(data.src_frame.shape[0]), int(data.kps.shape[1]))

        params = traj_to_params(traj, device=device)
        refresh = _make_prim_refresher(data, mesh, model, model_inv,
                                       tri_corners, loss_scale, loss_type,
                                       devices=devices)
        kw = dict(loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp, ppc=ppc)
        if len(devices) > 1:
            from ..parallel.sharded import EdgeShards

            edges = EdgeShards(devices, data, tri_corners, model, model_inv)

            def normal_equations(p, pr):
                return edges.normal_equations(p, pr, loss_scale, **kw)
        else:
            def normal_equations(p, pr):
                return build_normal_equations(p, data, pr, tri_corners, model,
                                              model_inv, loss_scale, **kw)
        prims, cost0 = refresh(params)
        cost = float(cost0)
        band = compute_band(data, traj.count, ppc)
        stats = dict(iterations=0, initial_cost=cost, cost=cost,
                     lambda_=float(opts.initial_lambda), invalid_steps=0,
                     step_norm=-1.0, grad_norm=-1.0)

    def emit() -> bool:
        if callback is None:
            return True
        return callback(RefineTrajectoryUpdate(
            progress=stats["iterations"] / max(opts.max_iterations, 1),
            message=(f"Cost: {stats['cost']:.02f} "
                     f"(Initial: {stats['initial_cost']:.02f})"),
            stats=BundleStats(
                iterations=np.int32(stats["iterations"]),
                initial_cost=np.float32(stats["initial_cost"]),
                cost=np.float32(stats["cost"]),
                lambda_=np.float32(stats["lambda_"]),
                invalid_steps=np.int32(stats["invalid_steps"]),
                step_norm=np.float32(stats["step_norm"]),
                grad_norm=np.float32(stats["grad_norm"]),
            ),
        ))

    v, rebuild, lam = 2.0, True, float(opts.initial_lambda)
    JtJ = Jtr = None
    # The refreshed cost of an accepted step, read with the next iteration's
    # scalars; that step's progress report waits for it.
    pending_cost = None
    stagnated = False
    while stats["iterations"] < opts.max_iterations:
        with record_function("refine.iteration"):
            if rebuild:
                JtJ, Jtr = normal_equations(params, prims)
            params_new, vec = try_lm_step(
                JtJ, Jtr, params, data, prims, tri_corners, model, model_inv,
                loss_scale, lam, bounds, band=band, **kw)
            if pending_cost is not None:
                vec = torch.cat([vec, pending_cost.reshape(1)])
            h = _read_scalars(vec)
            if pending_cost is not None:
                pending_cost = None
                stats["cost"] = h[5]
                if not emit():
                    break
            grad_norm, solve_ok, step_norm, cost_new, expected = h[:5]
            if rebuild:
                stats["grad_norm"] = grad_norm
                if grad_norm < opts.gradient_tol:
                    break

            if solve_ok == 0.0:
                stats["invalid_steps"] += 1
                if lam >= opts.max_lambda:
                    break
                lam = min(opts.max_lambda, lam * v)
                v *= 2.0
                rebuild = False
                stats["iterations"] += 1
                continue

            stats["step_norm"] = step_norm
            if step_norm < opts.step_tol:
                break
            # Cost stagnation: |attempted change| <= ftol·cost (0 disables).
            stagnated = opts.function_tol > 0.0 and (
                abs(cost_new - stats["cost"])
                <= opts.function_tol * stats["cost"]
            )
            if cost_new < stats["cost"]:
                actual = cost_new - stats["cost"]
                rho = actual / expected if expected != 0 else -1.0
                if rho > 0:
                    factor = max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                    lam = float(np.clip(lam * factor, opts.min_lambda,
                                        opts.max_lambda))
                params = params_new
                v, rebuild = 2.0, True
                # The parameters moved: refresh the intersection cache.
                prims, pending_cost = refresh(params)
            else:
                stats["invalid_steps"] += 1
                if lam >= opts.max_lambda:
                    break
                lam = min(opts.max_lambda, lam * v)
                v *= 2.0
                rebuild = False

            stats["iterations"] += 1
            stats["lambda_"] = lam
            if stagnated:
                break
            if pending_cost is None and not emit():
                break

    with record_function("refine.finish"):
        if pending_cost is not None:
            # The loop ended on an accepted step: its cost is still on the
            # device, and it was reported only if the loop ran out of
            # iterations (a stagnation exit reports only at the end).
            stats["cost"] = float(pending_cost)
            if not stagnated:
                emit()

        stats["lambda_"] = lam
        _log.info("refine done: cost %.4f -> %.4f in %d iterations (%d "
                  "invalid steps)", stats["initial_cost"], stats["cost"],
                  stats["iterations"], stats["invalid_steps"])
        emit()

        refined = params_to_traj(params, traj)
        for fid in range(traj.first_frame, traj.last_frame + 1):
            traj.set(fid, refined.get(fid))
    return traj
