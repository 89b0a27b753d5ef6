"""Addon-side engine glue (rebuild of blender_addon/core.py).

Bridges Blender objects to the ``polychase_core`` engine: builds the
accelerated mesh from the evaluated depsgraph geometry (triangles sorted
by polygon so polygon masking is contiguous runs), converts Blender
cameras to core intrinsics (negated OpenGL convention,
reference core.py:301-387), and manages per-tracker cached state and pin
arrays persisted as bytes blobs.
"""

from __future__ import annotations

import typing

import bpy
import mathutils
import numpy as np

from .. import polychase_core as pc
from . import utils

# The device of every engine call the add-on makes.  None is the CUDA card
# (every visible card for analyze and refine), as the facade's default;
# the CPU tests set it to ``torch.device("cpu")``.
DEVICE = None


# ---------------------------------------------------------------------------
# Intrinsics conversion (reference core.py:301-387)
# ---------------------------------------------------------------------------


def camera_intrinsics_expanded(
    lens, shift_x, shift_y, sensor_width, sensor_height, sensor_fit,
    width=1.0, height=1.0, scale_x=1.0, scale_y=1.0,
) -> pc.CameraIntrinsics:
    fx, fy, cx, cy = utils.calc_camera_params_expanded(
        lens, shift_x, shift_y, sensor_width, sensor_height, sensor_fit,
        width, height, scale_x, scale_y,
    )
    # Blender's projection looks down -Z with positive focal; the core's
    # OpenGL convention carries negated fx, fy, cx, cy.
    return pc.CameraIntrinsics(
        fx=-fx, fy=-fy, cx=-cx, cy=-cy,
        aspect_ratio=fx / fy,
        width=width, height=height,
        convention=pc.CameraConvention.OpenGL,
    )


def camera_intrinsics(camera, width=1.0, height=1.0, scale_x=1.0,
                      scale_y=1.0) -> pc.CameraIntrinsics:
    data = camera.data
    return camera_intrinsics_expanded(
        data.lens, data.shift_x, data.shift_y,
        data.sensor_width, data.sensor_height, data.sensor_fit,
        width, height, scale_x, scale_y,
    )


def set_camera_intrinsics(camera, intrinsics: pc.CameraIntrinsics) -> None:
    utils.set_camera_params(
        camera, intrinsics.width, intrinsics.height,
        -intrinsics.fx, -intrinsics.fy, -intrinsics.cx, -intrinsics.cy,
    )


def fold_scale(model_matrix, view_matrix):
    """The reference's scale-folding factorization
    (operators/tracking.py:195-220): core model matrix = diag(scale of
    the geometry's world matrix); core view matrix = modelview with the
    scale stripped.  The solved pose then stays a rigid transform while
    the mesh is ray-cast at its true scaled size.

    Returns ``(scale_matrix, modelview_no_scale)`` as mathutils matrices.
    """
    import mathutils

    scale_matrix = mathutils.Matrix.Diagonal(
        model_matrix.to_scale().to_4d()
    )
    model_view = view_matrix @ model_matrix
    loc, rot, _scale = model_view.decompose()
    model_view_no_scale = mathutils.Matrix.LocRotScale(loc, rot, None)
    return scale_matrix, model_view_no_scale


def scene_transformations(tracker, width, height) -> pc.SceneTransformations:
    """Current scene → core transform, scale folded into the model matrix
    (reference operators/tracking.py:195-220)."""
    geometry, camera = tracker.geometry, tracker.camera
    view = utils.get_camera_view_matrix(camera)
    scale_matrix, mv_no_scale = fold_scale(geometry.matrix_world, view)
    return pc.SceneTransformations(
        model_matrix=np.array(scale_matrix, np.float32),
        view_matrix=np.array(mv_no_scale, np.float32),
        intrinsics=camera_intrinsics(camera, width, height),
    )


# ---------------------------------------------------------------------------
# Pin storage (bytes blob ↔ numpy, reference core.py:49-176)
# ---------------------------------------------------------------------------


class PinModeData:
    """Pins for one tracker, synced with the persisted bytes blob."""

    def __init__(self, tracker):
        self._version = -1
        self._points = np.empty((0, 3), np.float32)
        self.sync(tracker)

    def sync(self, tracker) -> bool:
        """Reload from the blob if the version changed (undo-safe).
        Returns True when a reload happened."""
        if tracker.pins_version == self._version:
            return False
        blob = bytes(tracker.pins_data)
        self._points = (
            np.frombuffer(blob, np.float32).reshape(-1, 3).copy()
            if blob else np.empty((0, 3), np.float32)
        )
        self._version = tracker.pins_version
        return True

    @property
    def points(self) -> np.ndarray:
        return self._points

    @property
    def count(self) -> int:
        return len(self._points)

    def write(self, tracker, points: np.ndarray) -> None:
        self._points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        tracker.pins_data = self._points.tobytes()
        tracker.pins_version += 1
        self._version = tracker.pins_version

    def add_pin(self, tracker, point) -> int:
        pts = np.concatenate(
            [self._points, np.asarray(point, np.float32).reshape(1, 3)]
        )
        self.write(tracker, pts)
        return len(pts) - 1

    def remove_pin(self, tracker, idx: int) -> None:
        pts = np.delete(self._points, idx, axis=0)
        self.write(tracker, pts)


# ---------------------------------------------------------------------------
# Tracker cache: accelerated mesh + pins (reference core.py:25-46,179-289)
# ---------------------------------------------------------------------------


class Tracker:
    def __init__(self, tracker_props):
        self.id = int(tracker_props.id)
        self.pins = PinModeData(tracker_props)
        self._accel_mesh: typing.Optional[pc.AcceleratedMesh] = None
        self._polygon_runs: typing.Optional[np.ndarray] = None
        self.rebuild_mesh(tracker_props)

    # -- mesh ---------------------------------------------------------------

    def rebuild_mesh(self, tracker_props) -> None:
        geometry = tracker_props.geometry
        if geometry is None:
            self._accel_mesh = None
            return
        depsgraph = bpy.context.evaluated_depsgraph_get()
        eval_obj = geometry.evaluated_get(depsgraph)
        mesh = eval_obj.to_mesh()
        try:
            mesh.calc_loop_triangles()
            n_verts = len(mesh.vertices)
            n_tris = len(mesh.loop_triangles)
            verts = np.empty(n_verts * 3, np.float32)
            mesh.vertices.foreach_get("co", verts)
            tris = np.empty(n_tris * 3, np.int32)
            mesh.loop_triangles.foreach_get("vertices", tris)
            polys = np.empty(n_tris, np.int32)
            mesh.loop_triangles.foreach_get("polygon_index", polys)

            # Sort triangles by polygon index so each polygon's triangles
            # are one contiguous run (polygon masking = run masking,
            # reference core.py:191-245).
            order = np.argsort(polys, kind="stable")
            tris = tris.reshape(-1, 3)[order]
            polys = polys[order]
            self._polygon_runs = polys

            masked = (
                np.frombuffer(bytes(tracker_props.masked_triangles),
                              np.uint32).copy()
                if tracker_props.masked_triangles else None
            )
            self._accel_mesh = pc.AcceleratedMesh(
                verts.reshape(-1, 3), tris.astype(np.uint32), masked
            )
        finally:
            eval_obj.to_mesh_clear()

    @property
    def accel_mesh(self) -> typing.Optional[pc.AcceleratedMesh]:
        return self._accel_mesh

    def polygon_of_triangle(self, tri_idx: int) -> int:
        return int(self._polygon_runs[tri_idx])

    def triangles_of_polygon(self, poly_idx: int) -> np.ndarray:
        return np.nonzero(self._polygon_runs == poly_idx)[0]

    def mask_polygon(self, tracker_props, poly_idx: int,
                     mask: bool = True) -> None:
        mesh = self._accel_mesh.inner_mut()
        for tri in self.triangles_of_polygon(poly_idx):
            if mask:
                mesh.mask_triangle(int(tri))
            else:
                mesh.unmask_triangle(int(tri))
        tracker_props.masked_triangles = mesh.masked_triangles.tobytes()

    # -- picking ------------------------------------------------------------

    def ray_cast(self, tracker_props, context, region, rv3d, x, y,
                 check_mask=True):
        """Screen pixel → mesh hit via the core ray caster
        (reference core.py:247-263)."""
        if self._accel_mesh is None:
            return None
        width, height = region.width, region.height
        proj = rv3d.window_matrix
        # GL projection → pixel-unit OpenGL intrinsics (negative focals,
        # engine project: px = fx·X/Z + cx with region coords y-up):
        # px = (x_ndc/2 + 1/2)·W - 1/2 = (-P00·W/2)·X/Z + W/2·(1-P02) - 1/2.
        # The reference passes NDC coords instead (core.py:373-387 with
        # utils.ndc); here the pick pixel stays in region units.
        intr = pc.CameraIntrinsics(
            fx=-proj[0][0] * width / 2.0,
            fy=-proj[1][1] * height / 2.0,
            cx=-proj[0][2] * width / 2.0 + width / 2.0 - 0.5,
            cy=-proj[1][2] * height / 2.0 + height / 2.0 - 0.5,
            aspect_ratio=(proj[0][0] * width) / (proj[1][1] * height),
            width=width, height=height,
            convention=pc.CameraConvention.OpenGL,
        )
        scene = pc.SceneTransformations(
            model_matrix=np.array(
                tracker_props.geometry.matrix_world, np.float32
            ),
            view_matrix=np.array(rv3d.view_matrix, np.float32),
            intrinsics=intr,
        )
        return pc.ray_cast(
            self._accel_mesh, scene, np.array([x, y], np.float32), check_mask,
            device=DEVICE,
        )


class Trackers:
    """Cache of Tracker instances keyed by tracker id
    (reference core.py:25-46)."""

    _cache: dict[int, Tracker] = {}

    @classmethod
    def get(cls, tracker_props) -> typing.Optional[Tracker]:
        if tracker_props is None or tracker_props.geometry is None:
            return None
        tracker = cls._cache.get(tracker_props.id)
        if tracker is None:
            tracker = Tracker(tracker_props)
            cls._cache[tracker_props.id] = tracker
        else:
            tracker.pins.sync(tracker_props)
        return tracker

    @classmethod
    def invalidate(cls, tracker_id: int) -> None:
        cls._cache.pop(tracker_id, None)

    @classmethod
    def clear(cls) -> None:
        cls._cache.clear()
