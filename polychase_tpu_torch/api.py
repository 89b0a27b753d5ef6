"""The ``polychase_core``-shaped public API surface of the port.

Port of ``polychase_tpu/api.py``: the class and function names, argument
names and defaults of the reference's pybind11 module
(cpp/polychase_pybind.cc:29-348), so the Blender addon can import it as a
drop-in ``polychase_core``.  The value classes are mutable host objects
holding numpy arrays, as in the reference; conversion to the engine's types
(CPU tensors, the mesh on the device) happens at the call boundaries.

Every free function takes a trailing keyword-only ``device``.  ``None``, the
default, means the card (``backend.surface_device``): the addon passes no
device and gets the card, and a process without one gets a
:class:`CppException`, never a run on the CPU.  The tests pass
``device="cpu"``, which runs the kernels' plain torch versions.  As the
JAX package shards them over ``jax.devices()``,
``generate_optical_flow_database`` and ``refine_trajectory`` take every
visible card for ``None`` (``backend.surface_devices``; one card is a list
of one, the single-device path) and accept a sequence of devices.

The reference's multi-device extensions are here too: ``device_count``,
and ``refine_segments`` and ``track_segments``, which solve independent
keyframe segments together.  Their ``device=None`` means every visible card
(again a :class:`CppException` without one); a sequence of devices splits
the segments over them.
"""

from __future__ import annotations

import enum
import functools
from typing import Callable, List, Optional

import numpy as np
import torch

from .backend import surface_device, surface_devices
from .engine import camera as _camera
from .engine import geometry as _geometry
from .engine import gftt as _gftt
from .engine import levmarq as _levmarq
from .engine import lk as _lk
from .engine import opticalflow as _opticalflow
from .engine import pinmode as _pinmode
from .engine import pose as _pose
from .engine import raycast as _raycast
from .engine import refiner as _refiner
from .engine import tracker as _tracker
from .engine import trajectory as _trajectory
from .io import database as _database

__all__ = [
    "Mesh", "AcceleratedMesh", "SceneTransformations", "RayHit", "PinUpdate",
    "Database", "ImagePairFlow", "VideoInfo", "GFTTOptions",
    "OpticalFlowOptions", "TransformationType", "CameraConvention",
    "CameraIntrinsics", "Pose", "CameraState", "LossType", "BundleOptions",
    "BundleStats", "PnPResult", "FrameTrackingResult", "CameraTrajectory",
    "RefineTrajectoryUpdate", "CppException",
    "ray_cast", "find_transformation", "generate_optical_flow_database",
    "track_sequence", "refine_trajectory",
]


class CppException(RuntimeError):
    """Engine-side failure (the reference binds std::exception with a
    ``what()`` accessor, cpp/polychase_pybind.cc:311-312).  Engine
    RuntimeErrors crossing the facade's free functions are re-raised as
    this type so ``except CppException`` keeps the pybind contract."""

    def what(self) -> str:
        return str(self)


def _engine_errors(fn):
    """Re-raise engine RuntimeErrors as CppException (reference semantics:
    any std::exception surfaces as the bound CppException)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except CppException:
            raise
        except RuntimeError as e:
            raise CppException(str(e)) from e

    return wrapper


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _cpu(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# Enums
# ---------------------------------------------------------------------------


class TransformationType(enum.Enum):
    Camera = 0
    Model = 1


class CameraConvention(enum.Enum):
    OpenGL = 0
    OpenCV = 1


class LossType(enum.Enum):
    Trivial = 0
    Huber = 1
    Cauchy = 2


# ---------------------------------------------------------------------------
# Value types
# ---------------------------------------------------------------------------


class CameraIntrinsics:
    """Mutable pinhole intrinsics (cpp/polychase_pybind.cc:202-215)."""

    def __init__(self, fx, fy, cx, cy, aspect_ratio, width, height,
                 convention=CameraConvention.OpenGL):
        self.fx = float(fx)
        self.fy = float(fy)
        self.cx = float(cx)
        self.cy = float(cy)
        self.aspect_ratio = float(aspect_ratio)
        self.width = float(width)
        self.height = float(height)
        self.convention = convention

    def _to_engine(self) -> _camera.Intrinsics:
        conv = (
            _camera.OPENCV
            if self.convention == CameraConvention.OpenCV
            else _camera.OPENGL
        )
        return _camera.Intrinsics.create(
            self.fx, self.fy, self.cx, self.cy, self.aspect_ratio,
            self.width, self.height, conv, device="cpu",
        )

    @staticmethod
    def _from_engine(intr: _camera.Intrinsics,
                     like: "CameraIntrinsics" = None) -> "CameraIntrinsics":
        conv = (
            CameraConvention.OpenCV
            if float(intr.sign) > 0
            else CameraConvention.OpenGL
        )
        width = float(intr.width) if like is None else like.width
        height = float(intr.height) if like is None else like.height
        return CameraIntrinsics(
            float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy),
            float(intr.aspect_ratio), width, height, conv,
        )

    def __repr__(self):
        return (
            f"CameraIntrinsics(fx={self.fx}, fy={self.fy}, cx={self.cx}, "
            f"cy={self.cy}, aspect_ratio={self.aspect_ratio}, "
            f"width={self.width}, height={self.height}, "
            f"convention={self.convention})"
        )


class Pose:
    """Quaternion (w, x, y, z) + translation
    (cpp/polychase_pybind.cc:217-233)."""

    def __init__(self, q=None, t=None):
        self.q = (
            np.array([1.0, 0, 0, 0], np.float32)
            if q is None else np.asarray(q, np.float32).reshape(4).copy()
        )
        self.t = (
            np.zeros(3, np.float32)
            if t is None else np.asarray(t, np.float32).reshape(3).copy()
        )

    def _to_engine(self) -> _pose.Pose:
        return _pose.Pose(_cpu(self.q), _cpu(self.t))

    @staticmethod
    def _from_engine(p: _pose.Pose) -> "Pose":
        return Pose(_host(p.q), _host(p.t))

    def __repr__(self):
        return f"Pose(q={self.q.tolist()}, t={self.t.tolist()})"


class CameraState:
    def __init__(self, intrinsics: CameraIntrinsics = None, pose: Pose = None):
        self.intrinsics = intrinsics
        self.pose = pose if pose is not None else Pose()

    def _to_engine(self) -> _camera.CameraState:
        return _camera.CameraState(
            self.intrinsics._to_engine(), self.pose._to_engine()
        )

    @staticmethod
    def _from_engine(s: _camera.CameraState,
                     like: "CameraState" = None) -> "CameraState":
        return CameraState(
            CameraIntrinsics._from_engine(
                s.intrinsics, None if like is None else like.intrinsics
            ),
            Pose._from_engine(s.pose),
        )


class SceneTransformations:
    def __init__(self, model_matrix, view_matrix,
                 intrinsics: CameraIntrinsics):
        self.model_matrix = np.asarray(model_matrix, np.float32).reshape(4, 4)
        self.view_matrix = np.asarray(view_matrix, np.float32).reshape(4, 4)
        self.intrinsics = intrinsics

    def _to_engine(self) -> _geometry.SceneTransformations:
        # CPU tensors: the consumers (pin mode, tracking setup) orchestrate
        # on the host and move what they solve to the device themselves.
        return _geometry.SceneTransformations(
            _cpu(self.model_matrix),
            _cpu(self.view_matrix),
            self.intrinsics._to_engine(),
        )


class Mesh:
    """Mutable mesh + packed triangle mask
    (cpp/polychase_pybind.cc:30-37)."""

    def __init__(self, vertices, triangles, masked_triangles=None):
        self.vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        self.triangles = np.asarray(triangles, np.uint32).reshape(-1, 3)
        size = _geometry.mask_array_size(len(self.triangles))
        if masked_triangles is None or np.size(masked_triangles) == 0:
            self.masked_triangles = np.zeros(size, np.uint32)
        else:
            self.masked_triangles = (
                np.asarray(masked_triangles, np.uint32).reshape(-1).copy()
            )

    def is_triangle_masked(self, tri_idx: int) -> bool:
        return bool(
            (self.masked_triangles[tri_idx // 32] >> (tri_idx % 32)) & 1
        )

    def mask_triangle(self, tri_idx: int) -> None:
        self.masked_triangles = _geometry.set_mask_bits(
            self.masked_triangles, tri_idx, "mask"
        )

    def unmask_triangle(self, tri_idx: int) -> None:
        self.masked_triangles = _geometry.set_mask_bits(
            self.masked_triangles, tri_idx, "unmask"
        )

    def toggle_mask_triangle(self, tri_idx: int) -> None:
        self.masked_triangles = _geometry.set_mask_bits(
            self.masked_triangles, tri_idx, "toggle"
        )

    def _to_engine(self, device: torch.device) -> _geometry.Mesh:
        return _geometry.Mesh.create(
            self.vertices, self.triangles, self.masked_triangles,
            device=device,
        )


class AcceleratedMesh:
    """Mesh with acceleration for ray casts
    (cpp/polychase_pybind.cc:39-47).

    Holds an engine mesh per device (batched casts, tracking, refine), each
    rebuilt when the mask changes, and a host C++ BVH (single-ray viewport
    picking, the Embree replacement)."""

    def __init__(self, vertices, triangles, masked_triangles=None):
        self._mesh = Mesh(vertices, triangles, masked_triangles)
        self._engine_meshes: dict = {}  # device -> (mask bytes, Mesh)
        self._bvh = None
        self._bvh_tried = False

    def inner(self) -> Mesh:
        return self._mesh

    def inner_mut(self) -> Mesh:
        self._engine_meshes.clear()  # mutation invalidates the device copies
        return self._mesh

    def _to_engine(self, device: torch.device) -> _geometry.Mesh:
        mask_bytes = self._mesh.masked_triangles.tobytes()
        cached = self._engine_meshes.get(device)
        if cached is None or cached[0] != mask_bytes:
            cached = (mask_bytes, self._mesh._to_engine(device))
            self._engine_meshes[device] = cached
        return cached[1]

    def _native_bvh(self):
        if not self._bvh_tried:
            self._bvh_tried = True
            from . import native as _native

            if _native.available():
                self._bvh = _native.BvhRaycaster(
                    self._mesh.vertices, self._mesh.triangles
                )
        return self._bvh


class RayHit:
    def __init__(self, pos, normal, barycentric_coordinate, t, primitive_id):
        self.pos = np.asarray(pos, np.float32).reshape(3)
        self.normal = np.asarray(normal, np.float32).reshape(3)
        self.barycentric_coordinate = np.asarray(
            barycentric_coordinate, np.float32
        ).reshape(2)
        self.t = float(t)
        self.primitive_id = int(primitive_id)


class PinUpdate:
    def __init__(self, pin_idx, pin_pos):
        self.pin_idx = int(pin_idx)
        self.pos = np.asarray(pin_pos, np.float32).reshape(2)


class VideoInfo:
    def __init__(self, width, height, first_frame, num_frames):
        self.width = int(width)
        self.height = int(height)
        self.first_frame = int(first_frame)
        self.num_frames = int(num_frames)

    def _to_engine(self) -> _opticalflow.VideoInfo:
        return _opticalflow.VideoInfo(
            self.width, self.height, self.first_frame, self.num_frames
        )


class GFTTOptions:
    def __init__(self):
        self.quality_level = 0.01
        self.min_distance = 5.0
        self.block_size = 3
        self.gradient_size = 3
        self.max_corners = 0
        self.use_harris = False
        self.harris_k = 0.04
        self.grid_rows = 4
        self.grid_cols = 4

    def _to_engine(self) -> _gftt.GFTTOptions:
        return _gftt.GFTTOptions(
            *(getattr(self, f) for f in _gftt.GFTTOptions._fields))


class OpticalFlowOptions:
    def __init__(self):
        self.window_size = 10
        self.max_level = 3
        self.term_max_iters = 30
        self.term_epsilon = 0.01
        self.min_eigen_threshold = 1e-4

    def _to_engine(self) -> _lk.LKOptions:
        return _lk.LKOptions(*(getattr(self, f) for f in _lk.LKOptions._fields))


class BundleOptions:
    def __init__(self):
        self.max_iterations = 100
        # Reference default is HUBER (cpp/pnp/types.h:207); the addon
        # overrides to Cauchy per call site.
        self.loss_type = LossType.Huber
        self.loss_scale = 1.0
        self.gradient_tol = 1e-10
        self.step_tol = 1e-8
        self.initial_lambda = 1e-5
        self.min_lambda = 1e-10
        self.max_lambda = 1e10
        # Kept for the reference's surface; the engine solves each problem
        # on one device and reads neither.
        self.max_allowed_parallelism = 8
        self.verbose = False
        # Extension over the reference surface: relative function
        # tolerance on LM steps.  0 = reference-exact termination, but
        # tracking and refine then default to 1e-5
        # (POLYCHASE_TRACK_FTOL / POLYCHASE_REFINE_FTOL, 0 restores the
        # reference's exits; engine/tracker.py, engine/refiner.py).
        self.function_tol = 0.0

    def _to_engine(self) -> _levmarq.BundleOptions:
        loss = self.loss_type
        if isinstance(loss, LossType):
            loss = loss.value
        return _levmarq.BundleOptions(
            max_iterations=int(self.max_iterations),
            loss_type=int(loss),
            loss_scale=float(self.loss_scale),
            gradient_tol=float(self.gradient_tol),
            step_tol=float(self.step_tol),
            initial_lambda=float(self.initial_lambda),
            min_lambda=float(self.min_lambda),
            max_lambda=float(self.max_lambda),
            function_tol=float(self.function_tol),
        )


class BundleStats:
    def __init__(self, iterations=0, initial_cost=0.0, cost=0.0, lambda_=0.0,
                 invalid_steps=0, step_norm=0.0, grad_norm=0.0):
        self.iterations = int(iterations)
        self.initial_cost = float(initial_cost)
        self.cost = float(cost)
        setattr(self, "lambda", float(lambda_))
        self.invalid_steps = int(invalid_steps)
        self.step_norm = float(step_norm)
        self.grad_norm = float(grad_norm)

    @staticmethod
    def _from_engine(s: _levmarq.BundleStats) -> "BundleStats":
        return BundleStats(
            iterations=int(s.iterations),
            initial_cost=float(s.initial_cost),
            cost=float(s.cost),
            lambda_=float(s.lambda_),
            invalid_steps=int(s.invalid_steps),
            step_norm=float(s.step_norm),
            grad_norm=float(s.grad_norm),
        )

    def __repr__(self):
        return (
            f"BundleStats(iterations={self.iterations}, "
            f"initial_cost={self.initial_cost}, cost={self.cost}, "
            f"lambda={getattr(self, 'lambda')}, "
            f"invalid_steps={self.invalid_steps}, "
            f"step_norm={self.step_norm}, grad_norm={self.grad_norm})"
        )


class PnPResult:
    def __init__(self, camera: CameraState = None,
                 bundle_stats: BundleStats = None):
        self.camera = camera
        self.bundle_stats = bundle_stats


class FrameTrackingResult:
    def __init__(self, frame, pose, intrinsics, bundle_stats, inlier_ratio):
        self.frame = int(frame)
        self.pose = pose
        self.intrinsics = intrinsics
        self.bundle_stats = bundle_stats
        self.inlier_ratio = float(inlier_ratio)


class CameraTrajectory:
    """Python-visible trajectory (cpp/polychase_pybind.cc:290-303)."""

    def __init__(self, first_frame_id: int, count: int):
        self._traj = _trajectory.CameraTrajectory(first_frame_id, count)
        # remembered api intrinsics (keeps width/height metadata)
        self._like: List[Optional[CameraState]] = [None] * int(count)

    def is_valid_frame(self, frame_id: int) -> bool:
        return self._traj.is_valid_frame(frame_id)

    def is_frame_filled(self, frame_id: int) -> bool:
        return self._traj.is_frame_filled(frame_id)

    def get(self, frame_id: int) -> Optional[CameraState]:
        s = self._traj.get(frame_id)
        if s is None:
            return None
        like = self._like[self._traj.index(frame_id)]
        return CameraState._from_engine(s, like)

    def set(self, frame_id: int, state: CameraState) -> None:
        self._traj.set(frame_id, state._to_engine())
        self._like[self._traj.index(frame_id)] = state

    def count(self) -> int:
        return self._traj.count

    def first_frame(self) -> int:
        return self._traj.first_frame

    def last_frame(self) -> int:
        return self._traj.last_frame


class RefineTrajectoryUpdate:
    def __init__(self, progress=0.0, message="", stats=None):
        self.progress = float(progress)
        self.message = message
        self.stats = stats


Database = _database.Database
ImagePairFlow = _database.ImagePairFlow


# ---------------------------------------------------------------------------
# Free functions
# ---------------------------------------------------------------------------


@_engine_errors
def ray_cast(
    accel_mesh: AcceleratedMesh,
    scene_transform: SceneTransformations,
    pos,
    check_mask: bool,
    *,
    device=None,
) -> Optional[RayHit]:
    """Cast a screen-space ray (cpp/ray_casting.cc:128-133).

    Uses the native host BVH when it is built (sub-ms picking latency) and
    the batched device cast (``engine.raycast.raycast``) otherwise.  Ray
    construction is host numpy: this runs per mouse event.
    """
    device = surface_device(device)
    mv = scene_transform.view_matrix.astype(
        np.float64) @ scene_transform.model_matrix.astype(np.float64)
    inv = np.linalg.inv(mv)
    intr = scene_transform.intrinsics._to_engine()  # the f32 intrinsics
    s = float(intr.sign)
    px, py = (float(v) for v in np.asarray(pos, np.float64).reshape(2))
    dir_cam = np.array(
        [
            s * (px - float(intr.cx)) / float(intr.fx),
            s * (py - float(intr.cy)) / float(intr.fy),
            s,
        ]
    )
    origin = inv[:3, 3].astype(np.float32)
    direction = (inv[:3, :3] @ dir_cam).astype(np.float32)

    bvh = accel_mesh._native_bvh()
    if bvh is not None:
        masked = (
            accel_mesh.inner().masked_triangles if check_mask else None
        )
        p, n, bary, t, prim = bvh.raycast(origin[None], direction[None],
                                          masked)
        if prim[0] == np.uint32(_raycast.INVALID_ID):
            return None
        return RayHit(
            pos=p[0], normal=n[0], barycentric_coordinate=bary[0],
            t=float(t[0]), primitive_id=int(prim[0]),
        )

    hits = _raycast.raycast(
        accel_mesh._to_engine(device),
        torch.as_tensor(origin[None], device=device),
        torch.as_tensor(direction[None], device=device),
        check_mask,
    )
    if not bool(hits.valid[0]):
        return None
    return RayHit(
        pos=_host(hits.pos[0]), normal=_host(hits.normal[0]),
        barycentric_coordinate=_host(hits.barycentric[0]),
        t=float(hits.t[0]), primitive_id=int(hits.prim_id[0]),
    )


@_engine_errors
def find_transformation(
    object_points,
    initial_scene_transform: SceneTransformations,
    current_scene_transform: SceneTransformations,
    update: PinUpdate,
    trans_type: TransformationType,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    *,
    device=None,
) -> SceneTransformations:
    """Pose update from a pin drag (cpp/pin_mode.cc:219-246).  A solve of
    more than ``engine.pinmode.HOST_PIN_MAX`` pins runs on ``device``."""
    device = surface_device(device)
    tt = (
        _geometry.TRANSFORM_MODEL
        if trans_type == TransformationType.Model
        else _geometry.TRANSFORM_CAMERA
    )
    out = _pinmode.find_transformation(
        np.asarray(object_points, np.float32),
        initial_scene_transform._to_engine(),
        current_scene_transform._to_engine(),
        _pinmode.PinUpdate(update.pin_idx, update.pos),
        tt,
        optimize_focal_length,
        optimize_principal_point,
        device=device,
    )
    intr = CameraIntrinsics._from_engine(
        out.intrinsics, initial_scene_transform.intrinsics
    )
    return SceneTransformations(
        _host(out.model_matrix), _host(out.view_matrix), intr
    )


@_engine_errors
def generate_optical_flow_database(
    video_info: VideoInfo,
    frame_accessor_function: Callable[[int], Optional[np.ndarray]],
    callback: Optional[Callable[[float, str], bool]],
    database_path: str,
    detector_options: GFTTOptions = None,
    flow_options: OpticalFlowOptions = None,
    write_images: bool = False,
    *,
    device=None,
) -> None:
    """Analyze a clip into the flow DB at ``database_path``
    (cpp/opticalflow.cc:209-321); on a card each LK level of a solve
    launches K2 and K3 (on each card of its split, with several)."""
    device = surface_devices(device)
    _opticalflow.generate_optical_flow_database(
        video_info._to_engine(),
        frame_accessor_function,
        callback,
        database_path,
        (detector_options or GFTTOptions())._to_engine(),
        (flow_options or OpticalFlowOptions())._to_engine(),
        write_images,
        device=device,
    )


@_engine_errors
def track_sequence(
    database_path: str,
    frame_from: int,
    frame_to_inclusive: int,
    scene_transform: SceneTransformations,
    accel_mesh: AcceleratedMesh,
    callback: Optional[Callable[[FrameTrackingResult], bool]],
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    bundle_opts: BundleOptions = None,
    *,
    device=None,
) -> None:
    """Track from ``frame_from`` to ``frame_to_inclusive``
    (cpp/tracker.cc); on a card each frame is one launch of K1.  Results
    reach ``callback`` in runs of ``engine.tracker.FLUSH_FRAMES`` frames,
    and a False return stops the run at that granularity."""
    device = surface_device(device)
    intr_like = scene_transform.intrinsics

    def cb(r: _tracker.FrameTrackingResult) -> bool:
        if callback is None:
            return True
        return callback(
            FrameTrackingResult(
                frame=r.frame,
                pose=Pose._from_engine(r.pose),
                intrinsics=CameraIntrinsics._from_engine(
                    r.intrinsics, intr_like
                ),
                bundle_stats=BundleStats._from_engine(r.bundle_stats),
                inlier_ratio=r.inlier_ratio,
            )
        )

    _tracker.track_sequence(
        database_path,
        frame_from,
        frame_to_inclusive,
        scene_transform._to_engine(),
        accel_mesh._to_engine(device),
        cb,
        optimize_focal_length,
        optimize_principal_point,
        (bundle_opts or BundleOptions())._to_engine(),
        device=device,
    )


@_engine_errors
def refine_trajectory(
    database_path: str,
    camera_trajectory: CameraTrajectory,
    model_matrix,
    mesh: AcceleratedMesh,
    optimize_focal_length: bool,
    optimize_principal_point: bool,
    callback: Optional[Callable[[RefineTrajectoryUpdate], bool]],
    bundle_opts: BundleOptions = None,
    *,
    device=None,
) -> None:
    """Bundle-adjust ``camera_trajectory`` in place (cpp/refiner.cc); with
    several devices its normal equations and prim refresh split over them."""
    device = surface_devices(device)

    def cb(u: _refiner.RefineTrajectoryUpdate) -> bool:
        if callback is None:
            return True
        return callback(
            RefineTrajectoryUpdate(
                progress=u.progress,
                message=u.message,
                stats=(
                    BundleStats._from_engine(u.stats)
                    if u.stats is not None else None
                ),
            )
        )

    _refiner.refine_trajectory(
        database_path,
        camera_trajectory._traj,
        np.asarray(model_matrix, np.float32).reshape(4, 4),
        _first_mesh(mesh, device),
        optimize_focal_length,
        optimize_principal_point,
        cb,
        (bundle_opts or BundleOptions())._to_engine(),
        device=device,
    )


# ---------------------------------------------------------------------------
# Extensions beyond the reference surface (multi-device, segment-parallel)
# ---------------------------------------------------------------------------


def device_count() -> int:
    """Number of visible CUDA devices (extension); 0 without a card, so
    the addon's ``device_count() > 1`` takes its sequential path."""
    return int(torch.cuda.device_count())


def _first_mesh(mesh: AcceleratedMesh, devices) -> _geometry.Mesh:
    """The engine mesh on the (first) device of ``surface_devices``."""
    first = devices[0] if isinstance(devices, list) else devices
    return mesh._to_engine(first)


@_engine_errors
def refine_segments(
    database_path: str,
    camera_trajectories,
    model_matrix,
    mesh: AcceleratedMesh,
    optimize_focal_length: bool,
    optimize_principal_point: bool,
    bundle_opts: BundleOptions = None,
    *,
    device=None,
) -> None:
    """Refine independent keyframe segments together (extension).

    The reference refines refine-all's segments one after another; here
    they are one stack that takes every LM iteration of all segments at
    once (``parallel.segments``), split over the devices when there are
    several.  Each trajectory is refined in place."""
    from .parallel.segments import refine_segments as _rs

    devices = surface_devices(device)
    refined = _rs(
        database_path,
        [ct._traj for ct in camera_trajectories],
        np.asarray(model_matrix, np.float32).reshape(4, 4),
        _first_mesh(mesh, devices),
        optimize_focal_length,
        optimize_principal_point,
        (bundle_opts or BundleOptions())._to_engine(),
        device=devices,
    )
    for ct, new in zip(camera_trajectories, refined):
        for fid in range(new.first_frame, new.last_frame + 1):
            ct._traj.set(fid, new.get(fid))


@_engine_errors
def track_segments(
    database_path: str,
    camera_trajectories,
    model_matrix,
    mesh: AcceleratedMesh,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    bundle_opts: BundleOptions = None,
    *,
    device=None,
):
    """Track independent seeded segments together (extension).

    Each trajectory must have its first frame filled (the seed keyframe);
    every frame step solves all segments' next frames at once, on a card
    one launch of K1 (``parallel.tracking``).  Returns the per-segment
    correspondence counts, (S, steps)."""
    from .parallel.tracking import track_segments as _ts

    devices = surface_devices(device)
    if bundle_opts is None:
        bundle_opts = BundleOptions()
        bundle_opts.loss_type = LossType.Cauchy
    return _ts(
        database_path,
        [ct._traj for ct in camera_trajectories],
        np.asarray(model_matrix, np.float32).reshape(4, 4),
        _first_mesh(mesh, devices),
        optimize_focal_length,
        optimize_principal_point,
        bundle_opts._to_engine(),
        device=devices,
    )


__all__ += ["device_count", "refine_segments", "track_segments"]
