"""State carried across from the JAX package into the port.

Each function takes an object of the JAX package (a ``Mesh``,
``Intrinsics``, ``Pose``, ``CameraState``, ``CameraTrajectory``,
``BundleOptions``, ``SceneTransformations``, ``LKOptions``,
``GFTTOptions``, ``VideoInfo`` or ``PyramidCache``) and reads its fields as
numpy arrays, so this module never imports jax: anything with the same field names
whose values ``numpy.asarray`` accepts will do.  The port has no weights;
this is how the tests put both packages on the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import as_device
from .engine import camera as C
from .engine import gftt as G
from .engine import lk as L
from .engine import opticalflow as O
from .engine import pose as P
from .engine.geometry import Mesh, SceneTransformations
from .engine.levmarq import BundleOptions
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
