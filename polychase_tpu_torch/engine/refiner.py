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
The prim refresh casts on the device, or through the host BVH of
``polychase_tpu.native`` for meshes of ``BVH_TRIANGLE_THRESHOLD`` triangles
or more.

Not ported, by design: the device-resident LM chunk program
(``lm_chunk_device``, ``POLYCHASE_DEVICE_LM``, ``POLYCHASE_LM_CHUNK``), a
TPU answer to dispatch cost that its tests hold equal to the host driver;
the fused ``rebuild_and_try_lm_step`` (one jit instead of two; here a plain
sequence of calls); the ``device_mesh`` path and ``_pad_edges_to`` (the
multi-device work of a later slice); ``POLYCHASE_BAND_SOLVE``; and the TPU
padding of K, M and E, which is layout, not semantics.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from polychase_tpu.io.database import Database

from ..backend import as_device
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
    intersect_ray_plane_jac,
    intersect_ray_triangle,
    raycast_grouped,
)
from .trajectory import CameraTrajectory

_INVALID = -1
_log = logging.getLogger(__name__)

# Triangle count from which the prim refresh casts through the host BVH
# instead of the device sweep.  For config 4's 32,000 rays on an NVIDIA
# H100 80GB HBM3 at 700 W the plain torch sweep won at 5,040 triangles
# (20.5-20.8 ms per refresh against 33.8-34.8) and the single-threaded
# host BVH from 10,780 (33.6-35.7 ms against 42.5-42.7); the two cross
# near 8.7k (PERF.md, section 6).
BVH_TRIANGLE_THRESHOLD = 8192


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
    aspect: torch.Tensor       # () aspect ratio (shared)
    conv_sign: torch.Tensor    # () +1 OpenCV / -1 OpenGL


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
    return C.Intrinsics(
        fx=params.fx[idx], fy=params.fy[idx],
        cx=params.cx[idx], cy=params.cy[idx],
        aspect_ratio=data.aspect + zeros, width=zeros, height=zeros,
        sign=data.conv_sign + zeros,
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


def _refresh_routing(mesh: Mesh) -> bool:
    """True when the prim refresh casts through the host BVH: from
    ``BVH_TRIANGLE_THRESHOLD`` triangles, where the native library loads."""
    if mesh.num_triangles < BVH_TRIANGLE_THRESHOLD:
        return False
    from polychase_tpu import native

    return native.available()


def refresh_prims(params: TrajParams, data: RefinerData, mesh: Mesh,
                  model_inv) -> torch.Tensor:
    """Ray cast of every (frame, keypoint) ray → prim ids (F, K), -1 where
    the ray misses, hits a masked triangle or has no keypoint."""
    with record_function("refine.raycast"):
        origin_o, dir_o = _all_rays(params, data, model_inv)
        hits = raycast_grouped(mesh, origin_o, dir_o, check_mask=True)
        return torch.where(hits.valid & data.kp_valid, hits.prim_id,
                           _INVALID)


def refresh_prims_and_cost(params, data: RefinerData, mesh: Mesh, model,
                           model_inv, tri_corners, loss_scale, *,
                           loss_type: int):
    """The accepted-step update: the prim refresh and the cost after it."""
    prims = refresh_prims(params, data, mesh, model_inv)
    cost = total_cost(params, data, prims, tri_corners, model, model_inv,
                      loss_scale, loss_type=loss_type)
    return prims, cost


def _make_prim_refresher(data: RefinerData, mesh: Mesh, model, model_inv,
                         tri_corners, loss_scale, loss_type: int,
                         routing: Optional[bool] = None):
    """``refresh(params) -> (prims, cost)`` on the route the mesh's size
    selects (``_refresh_routing``): the device sweep, or the host BVH with
    the rays copied to the host and the prims back."""
    if routing is None:
        routing = _refresh_routing(mesh)
    if not routing:
        def refresh(params):
            return refresh_prims_and_cost(
                params, data, mesh, model, model_inv, tri_corners,
                loss_scale, loss_type=loss_type,
            )
        return refresh

    from polychase_tpu import native

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


def total_cost(params, data: RefinerData, prims, tri_corners, model,
               model_inv, loss_scale, *, loss_type: int) -> torch.Tensor:
    """The per-edge-normalised robust cost, a 0-d tensor."""
    with record_function("refine.cost"):
        res, valid, _, _ = _edge_eval(
            params, data, prims, tri_corners, model, model_inv,
            with_jac=False, opt_f=False, opt_pp=False,
        )
        r2 = torch.sum(res * res, dim=-1)
        cost_m = torch.where(valid, loss_value(loss_type, loss_scale, r2),
                             0.0)
        n_valid = torch.clamp(valid.sum(dim=-1), min=1)
        edge_cost = cost_m.sum(dim=-1) / n_valid
        return torch.where(data.edge_valid, data.edge_weight * edge_cost,
                           0.0).sum()


def build_normal_equations(params, data: RefinerData, prims, tri_corners,
                           model, model_inv, loss_scale, *, loss_type: int,
                           opt_f: bool, opt_pp: bool, ppc: int):
    """Dense JᵀJ (P, P) and Jᵀr (P,) over all edges, P = F·ppc."""
    with record_function("refine.normal_equations"):
        res, valid, J_src, J_tgt = _edge_eval(
            params, data, prims, tri_corners, model, model_inv,
            with_jac=True, opt_f=opt_f, opt_pp=opt_pp,
        )
        F = params.q.shape[0]
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
        JtJ_pair = JtJ_pair * scale[:, None, None]
        Jtr_pair = Jtr_pair * scale[:, None]

        # Scatter-add into the dense (F·ppc)² system.
        off = torch.arange(ppc, device=res.device)
        rows = torch.cat([data.src_frame[:, None] * ppc + off,
                          data.tgt_frame[:, None] * ppc + off], dim=1)
        Pn = F * ppc
        JtJ = torch.zeros((Pn, Pn), dtype=torch.float32, device=res.device)
        JtJ.index_put_(
            (rows[:, :, None].expand(E, n2, n2),
             rows[:, None, :].expand(E, n2, n2)),
            JtJ_pair, accumulate=True,
        )
        Jtr = torch.zeros((Pn,), dtype=torch.float32, device=res.device)
        Jtr.index_put_((rows,), Jtr_pair, accumulate=True)
        return JtJ, Jtr


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

    ``database`` is a :class:`Database` or a path; ``mesh`` must live on
    ``device``.  Unless ``bundle_opts`` sets ``function_tol``, LM stops at a
    relative function tolerance of ``POLYCHASE_REFINE_FTOL`` (default 1e-5;
    0 gives the reference's exits exactly).  ``callback`` receives a
    :class:`RefineTrajectoryUpdate` after every counted iteration and once
    at the end; returning False cancels."""
    device = as_device(device)
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

    own_db = isinstance(database, str)
    if own_db:
        database = Database(database)
    try:
        data = build_refiner_data(database, traj, mesh, model_matrix,
                                  device=device)
    finally:
        if own_db:
            database.close()

    opt_f, opt_pp = bool(optimize_focal_length), bool(optimize_principal_point)
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
    refresh = _make_prim_refresher(data, mesh, model, model_inv, tri_corners,
                                   loss_scale, loss_type)
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
    kw = dict(loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp, ppc=ppc)
    while stats["iterations"] < opts.max_iterations:
        if rebuild:
            JtJ, Jtr = build_normal_equations(
                params, data, prims, tri_corners, model, model_inv,
                loss_scale, **kw)
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
            abs(cost_new - stats["cost"]) <= opts.function_tol * stats["cost"]
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
    if pending_cost is not None:
        # The loop ended on an accepted step: its cost is still on the
        # device, and it was reported only if the loop ran out of
        # iterations (a stagnation exit reports only at the end).
        stats["cost"] = float(pending_cost)
        if not stagnated:
            emit()

    stats["lambda_"] = lam
    _log.info("refine done: cost %.4f -> %.4f in %d iterations (%d invalid "
              "steps)", stats["initial_cost"], stats["cost"],
              stats["iterations"], stats["invalid_steps"])
    emit()

    refined = params_to_traj(params, traj)
    for fid in range(traj.first_frame, traj.last_frame + 1):
        traj.set(fid, refined.get(fid))
    return traj
