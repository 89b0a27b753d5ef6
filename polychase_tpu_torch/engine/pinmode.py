"""Interactive pin-mode pose solving (drag pins → pose update).

Port of ``polychase_tpu/engine/pinmode.py``.  Dispatch on the pin count:

- 1 pin: depth-preserving translation along the drag ray;
- 2 pins: rotation about the view axis through the anchor pin plus a
  scale about it, as a camera-distance change;
- ≥ 3 pins: project the pins with the *initial* transform, override the
  dragged pin's 2D target, warm-start from the *current* transform, run an
  iterative PnP (Trivial loss) in camera space, and recompose into a model-
  or view-matrix update.

The 1- and 2-pin updates and the matrix algebra are float64 host numpy.
The ≥ 3-pin solve runs on the host (``pnp_host``, float64) up to
``HOST_PIN_MAX`` points, as the reference does, and above it through
``pnp.solve_pnp`` on the
caller's ``device``, which on a CUDA device is the whole-solve kernel K1
and on the CPU its plain torch version.  The result is always a host
value: CPU tensors, for the UI.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..backend import as_device
from . import camera as C
from . import pose as P
from .geometry import SceneTransformations, TRANSFORM_MODEL
from .levmarq import BundleOptions, TRIVIAL
from .pnp import PnPOptions, solve_pnp
from .pnp_host import solve_pnp_host

# The largest point count solved on the host; above it the solve runs on
# the device.  The float32 device solve, the reference's or the port's,
# leaves the float64 host solve's answer by more than 1e-4 in the view
# matrix at 4 to 2,048 config-2 pins (up to 1.4e-2 with a free focal; within
# 6e-5 at 3 and 4,096), while the two host routes agree to the bit
# (tests/pin_route_scan.py).  The limit is the reference's own default
# (``POLYCHASE_HOST_PIN_MAX``), so the port gives the reference's answer
# wherever the reference solves on its host; it is not fitted to the
# failing sizes.  The device route is faster (1.01 ms against 7.43 ms per
# 8-pin drag, 1.47 against 40.05 ms at 4,096 pins, on an NVIDIA H100 80GB
# HBM3 at 700 W and its host: ``python3 -m polychase_tpu_torch.crossover``)
# but gives another pose.
HOST_PIN_MAX = 4096


class PinUpdate(NamedTuple):
    """One dragged pin."""

    pin_idx: int
    pos: np.ndarray  # (2,) new pixel position


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _np4(mat) -> np.ndarray:
    return _np(mat).reshape(4, 4)


def _host_scene(model, view,
                intrinsics: C.Intrinsics) -> SceneTransformations:
    t = lambda m: torch.as_tensor(np.asarray(m, np.float32))  # noqa: E731
    return SceneTransformations(t(model), t(view), intrinsics.to("cpu"))


def _ray_world(scene: SceneTransformations, pos):
    """Pixel → world ray, host float64."""
    view_inv = np.linalg.inv(_np4(scene.view_matrix))
    intr = scene.intrinsics
    s = float(intr.sign)
    px, py = (float(v) for v in np.asarray(pos, np.float64).reshape(2))
    d = np.array(
        [
            s * (px - float(intr.cx)) / float(intr.fx),
            s * (py - float(intr.cy)) / float(intr.fy),
            s,
        ]
    )
    return view_inv[:3, 3], view_inv[:3, :3] @ d


def _find_transformation_1(object_points, scene: SceneTransformations,
                           update: PinUpdate, trans_type):
    """Depth-preserving translation."""
    origin, direction = _ray_world(scene, update.pos)
    model = _np4(scene.model_matrix)
    p_obj = np.asarray(object_points[0], np.float64)
    p_world = model[:3, :3] @ p_obj + model[:3, 3]

    depth = np.linalg.norm(p_world - origin)
    translated = origin + depth * direction / np.linalg.norm(direction)
    new_model = model.copy()
    new_model[:3, 3] += translated - p_world

    view = _np4(scene.view_matrix)
    if trans_type == TRANSFORM_MODEL:
        return _host_scene(new_model, view, scene.intrinsics)
    return _host_scene(model, view @ new_model @ np.linalg.inv(model),
                       scene.intrinsics)


def _find_transformation_2(object_points, scene: SceneTransformations,
                           update: PinUpdate, trans_type):
    """Rotate about the view axis through the anchor and scale about it."""
    origin, direction = _ray_world(scene, update.pos)
    view = _np4(scene.view_matrix)
    view_inv = np.linalg.inv(view)
    camera_center = view_inv[:3, 3]
    model = _np4(scene.model_matrix)

    moving = model[:3, :3] @ np.asarray(
        object_points[update.pin_idx], np.float64) + model[:3, 3]
    anchor = model[:3, :3] @ np.asarray(
        object_points[1 - update.pin_idx], np.float64) + model[:3, 3]

    depth = np.linalg.norm(moving - origin)
    translated_moving = origin + depth * direction / np.linalg.norm(direction)

    du = moving - anchor
    dv = translated_moving - anchor
    dn_unit = view_inv[:3, 2] / np.linalg.norm(view_inv[:3, 2])
    du_unit = du / np.linalg.norm(du)
    dv_unit = dv / np.linalg.norm(dv)
    angle = np.arctan2(
        np.dot(np.cross(du_unit, dv_unit), dn_unit), np.dot(du_unit, dv_unit)
    )
    # Rodrigues rotation about dn_unit
    K = np.array(
        [
            [0, -dn_unit[2], dn_unit[1]],
            [dn_unit[2], 0, -dn_unit[0]],
            [-dn_unit[1], dn_unit[0], 0],
        ]
    )
    R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
    scale_inv = np.linalg.norm(du) / np.linalg.norm(dv)
    new_anchor = camera_center + (anchor - camera_center) * scale_inv

    update_mat = np.eye(4)
    update_mat[:3, :3] = R
    update_mat[:3, 3] = new_anchor - R @ anchor
    if trans_type == TRANSFORM_MODEL:
        return _host_scene(update_mat @ model, view, scene.intrinsics)
    return _host_scene(model, view @ update_mat, scene.intrinsics)


def _find_transformation_n(object_points, initial: SceneTransformations,
                           current: SceneTransformations, update: PinUpdate,
                           trans_type, optimize_focal_length,
                           optimize_principal_point, device):
    """General case: iterative PnP in camera space."""
    X = np.asarray(object_points, np.float64).reshape(-1, 3)
    initial_view = _np4(initial.view_matrix)
    model_view = initial_view @ _np4(initial.model_matrix)
    mv_R, mv_t = model_view[:3, :3], model_view[:3, 3]

    X_cam = X @ mv_R.T + mv_t
    ii = initial.intrinsics
    Kp = np.array(
        [
            [float(ii.fx), 0.0, float(ii.cx)],
            [0.0, float(ii.fy), float(ii.cy)],
            [0.0, 0.0, 1.0],
        ],
        np.float64,
    )
    proj = X_cam @ Kp.T
    image_points = (proj[:, :2] / proj[:, 2:3]).astype(np.float32)
    image_points[update.pin_idx] = np.asarray(update.pos, np.float32)

    # Warm start: the delta that maps the initial model-view to the current.
    current_model = _np4(current.model_matrix)
    initial_pose_mat = (
        _np4(current.view_matrix) @ current_model @ np.linalg.inv(model_view)
    )
    q0 = P.mat_to_quat_np(initial_pose_mat[:3, :3]).astype(np.float32)
    t0 = initial_pose_mat[:3, 3].astype(np.float32)
    cam0 = C.CameraState(
        current.intrinsics.to("cpu"),
        P.Pose(torch.as_tensor(q0), torch.as_tensor(t0)),
    )
    opts = PnPOptions(
        bundle_opts=BundleOptions(loss_type=TRIVIAL),
        max_inlier_error=0.0,
        optimize_focal_length=optimize_focal_length,
        optimize_principal_point=optimize_principal_point,
    )
    Xc = X_cam.astype(np.float32)
    if len(X_cam) <= HOST_PIN_MAX:
        result = solve_pnp_host(Xc, image_points, cam0, opts)
    else:
        result = solve_pnp(Xc, image_points, cam0, opts, device=device)

    R = P.quat_to_mat_np(result.camera.pose.q.numpy())
    t = result.camera.pose.t.numpy().astype(np.float64)
    intr = result.camera.intrinsics
    if trans_type == TRANSFORM_MODEL:
        new_mv = np.eye(4)
        new_mv[:3, :3] = R @ mv_R
        new_mv[:3, 3] = R @ mv_t + t
        model = np.linalg.inv(initial_view) @ new_mv
        return _host_scene(model, _np4(current.view_matrix), intr)
    upd = np.eye(4)
    upd[:3, :3] = R
    upd[:3, 3] = t
    return _host_scene(current_model, upd @ initial_view, intr)


def find_transformation(object_points,
                        initial_scene_transform: SceneTransformations,
                        current_scene_transform: SceneTransformations,
                        update: PinUpdate, trans_type: int,
                        optimize_focal_length: bool = False,
                        optimize_principal_point: bool = False, *,
                        device) -> SceneTransformations:
    """Pose update from a pin drag.  ``object_points`` (N, 3) are the pins
    in object space; ``device`` is where a solve above ``HOST_PIN_MAX``
    points runs.  Returns the updated scene as CPU tensors."""
    device = as_device(device)
    object_points = np.asarray(object_points, np.float32).reshape(-1, 3)
    n = object_points.shape[0]
    if not 0 <= int(update.pin_idx) < n:
        raise ValueError("pin_idx out of range")
    if n == 1:
        return _find_transformation_1(
            object_points, initial_scene_transform, update, trans_type
        )
    if n == 2:
        # Started from the current transform, not the initial one, as in
        # the reference.
        return _find_transformation_2(
            object_points, current_scene_transform, update, trans_type
        )
    return _find_transformation_n(
        object_points, initial_scene_transform, current_scene_transform,
        update, trans_type, optimize_focal_length, optimize_principal_point,
        device,
    )
