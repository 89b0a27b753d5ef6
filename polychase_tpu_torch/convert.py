"""State carried across from the JAX package into the port.

Each function takes an object of the JAX package (a ``Mesh``,
``Intrinsics``, ``Pose``, ``CameraState``, ``CameraTrajectory``,
``BundleOptions``, ``SceneTransformations``, ``LKOptions``,
``GFTTOptions``, ``VideoInfo``, ``PyramidCache``, ``PinUpdate``,
``RefinerData``, ``TrajParams`` or ``GridAccel``) and reads its fields as numpy arrays,
so this module never imports jax: anything with the same field names whose
values ``numpy.asarray`` accepts will do.  The port has no weights;
this is how the tests put both packages on the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import as_device
from .engine import camera as C
from .engine import gftt as G
from .engine import gridcast as GC
from .engine import lk as L
from .engine import opticalflow as O
from .engine import pose as P
from .engine import refiner as R
from .engine.geometry import Mesh, SceneTransformations
from .engine.levmarq import BundleOptions
from .engine.pinmode import PinUpdate
from .engine.pnp import normalize_bundle_opts
from .engine.trajectory import CameraTrajectory


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def mesh(m, *, device) -> Mesh:
    """Vertices, triangles and the packed ``uint32`` mask words."""
    return Mesh.create(
        np.asarray(m.vertices), np.asarray(m.triangles),
        np.asarray(m.masked_triangles), device=device,
    )


def intrinsics(i, *, device) -> C.Intrinsics:
    device = as_device(device)
    return C.Intrinsics(
        *(_f32(getattr(i, f), device) for f in (
            "fx", "fy", "cx", "cy", "aspect_ratio", "width", "height", "sign"
        ))
    )


def pose(p, *, device) -> P.Pose:
    device = as_device(device)
    return P.Pose(_f32(p.q, device), _f32(p.t, device))


def camera_state(c, *, device) -> C.CameraState:
    return C.CameraState(
        intrinsics(c.intrinsics, device=device), pose(c.pose, device=device)
    )


def camera_trajectory(traj, *, device) -> CameraTrajectory:
    out = CameraTrajectory(traj.first_frame_id, len(traj.states))
    out.states = [
        None if s is None else camera_state(s, device=device)
        for s in traj.states
    ]
    return out


def bundle_options(b) -> BundleOptions:
    return normalize_bundle_opts(b)


def scene_transformations(s, *, device) -> SceneTransformations:
    device = as_device(device)
    return SceneTransformations(
        model_matrix=_f32(s.model_matrix, device),
        view_matrix=_f32(s.view_matrix, device),
        intrinsics=intrinsics(s.intrinsics, device=device),
    )


def lk_options(o) -> L.LKOptions:
    return L.LKOptions(*(getattr(o, f) for f in L.LKOptions._fields))


def gftt_options(o) -> G.GFTTOptions:
    return G.GFTTOptions(*(getattr(o, f) for f in G.GFTTOptions._fields))


def video_info(v) -> O.VideoInfo:
    return O.VideoInfo(*(int(getattr(v, f)) for f in O.VideoInfo._fields))


def pin_update(u) -> PinUpdate:
    return PinUpdate(int(u.pin_idx), np.array(u.pos, np.float32).reshape(2))


def refiner_data(d, *, device) -> R.RefinerData:
    """A ``RefinerData`` of either package on ``device``, index fields as
    int64; the reference's padding is kept (it carries no valid entry)."""
    device = as_device(device)
    out = {}
    for f in R.RefinerData.__dataclass_fields__:
        a = _host(getattr(d, f))
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        elif a.dtype.kind == "f":
            a = a.astype(np.float32)
        out[f] = torch.as_tensor(np.array(a), device=device)
    return R.RefinerData(**out)


def traj_params(p, *, device) -> R.TrajParams:
    device = as_device(device)
    return R.TrajParams(*(_f32(_host(getattr(p, f)), device)
                          for f in ("q", "t", "fx", "fy", "cx", "cy")))


def refiner_entries(d) -> dict:
    """The valid entries of a ``RefinerData`` of either package, as host
    arrays, for a field-by-field comparison: each frame's valid keypoints,
    and for each valid edge its frames, weight, and the source keypoint
    index and target pixel of each valid match."""
    kp_valid = _host(d.kp_valid)
    kps = _host(d.kps)
    ev = _host(d.edge_valid)
    mv = _host(d.match_valid)[ev]
    return dict(
        kps=[kps[f][kp_valid[f]] for f in range(kp_valid.shape[0])],
        src_frame=_host(d.src_frame)[ev].astype(np.int64),
        tgt_frame=_host(d.tgt_frame)[ev].astype(np.int64),
        edge_weight=_host(d.edge_weight)[ev],
        src_kp=[r[m].astype(np.int64)
                for r, m in zip(_host(d.src_kp)[ev], mv)],
        tgt_px=[r[m] for r, m in zip(_host(d.tgt_px)[ev], mv)],
        anchor=_host(d.anchor),
        aspect=float(_host(d.aspect)),
        conv_sign=float(_host(d.conv_sign)),
    )


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def grid_accel(a, *, device) -> GC.GridAccel:
    """A uniform grid of the JAX package.  Its per-item rows ``[p1, e1,
    e2, id + 2**23, 0, 0]`` become the port's per-triangle rows (every
    triangle has at least one item); the empty mesh's grid keeps one zero
    row."""
    device = as_device(device)
    items = _host(a.items).astype(np.int32)
    data = _host(a.item_data).astype(np.float32)
    rows = np.zeros((int(items.max()) + 1, 12), np.float32)
    rows[items, :9] = data[:, :9]
    cell_start = _host(a.cell_start).astype(np.int32)
    return GC.GridAccel(
        cell_start=torch.as_tensor(cell_start, device=device),
        items=torch.as_tensor(items, device=device),
        tri_rows=torch.as_tensor(rows, device=device),
        lo=_f32(_host(a.lo), device), h=_f32(_host(a.h), device),
        res=torch.as_tensor(_host(a.res).astype(np.int32), device=device),
        cell_load=GC.cell_load(cell_start),
    )


def pyramid(p, *, device) -> L.PyramidCache:
    """A prepared pyramid of the reference's XLA flavor: the padded image,
    dx and dy of each level and its (H, W).  The Pallas flavor's 16-px,
    128-aligned padding is TPU layout and is refused."""
    if getattr(p, "flavor", "xla") != "xla":
        raise ValueError(f"pyramid flavor {p.flavor!r} is not the XLA one")
    device = as_device(device)
    levels = []
    for img, dx, dy, shape in p.levels:
        H, W = (int(v) for v in np.asarray(shape))
        levels.append((_f32(img, device), _f32(dx, device), _f32(dy, device),
                       (H, W)))
    return L.PyramidCache(levels, int(p.num_levels), lk_options(p.opts))
