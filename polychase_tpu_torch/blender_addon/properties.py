"""Persisted add-on state (rebuild of blender_addon/properties.py).

``PolychaseTracker`` holds one tracking setup (clip + geometry + camera +
database + pins/mask blobs); ``PolychaseState`` is the scene-level
collection of trackers.  Transient (non-persisted) UI state lives in
``TransientState`` keyed by tracker id.
"""

from __future__ import annotations

import bpy

from . import utils


# ---------------------------------------------------------------------------
# Transient (non-persisted) state
# ---------------------------------------------------------------------------


class TransientState:
    """Runtime flags/progress for one tracker (reference
    properties.py:238-259)."""

    def __init__(self):
        self.in_pinmode = False
        self.is_tracking = False
        self.is_refining = False
        self.is_analyzing = False
        self.progress = 0.0
        self.progress_message = ""
        self.active_thread = None

    @property
    def busy(self):
        return self.is_tracking or self.is_refining or self.is_analyzing


_transient: dict[int, TransientState] = {}


def transient_state(tracker) -> TransientState:
    state = _transient.get(tracker.id)
    if state is None:
        state = TransientState()
        _transient[tracker.id] = state
    return state


def clear_transient_state(tracker_id: int) -> None:
    _transient.pop(tracker_id, None)


# ---------------------------------------------------------------------------
# Change hooks
# ---------------------------------------------------------------------------


def _on_clip_changed(self, context):
    from . import background_images

    if self.camera and self.clip:
        background_images.setup_background_for_clip(self.camera, self.clip)


def _on_geometry_changed(self, context):
    # Geometry swap invalidates pins, masks and the cached mesh
    from . import core

    self.pins_data = b""
    self.pins_version += 1
    self.masked_triangles = b""
    core.Trackers.invalidate(self.id)


def _on_camera_changed(self, context):
    if self.camera and self.clip:
        from . import background_images

        background_images.setup_background_for_clip(self.camera, self.clip)


class PolychaseTracker(bpy.types.PropertyGroup):
    """One tracking setup (reference properties.py:76-213)."""

    id: bpy.props.IntProperty(default=-1)
    name: bpy.props.StringProperty(default="Tracker")

    clip: bpy.props.PointerProperty(
        type=bpy.types.MovieClip, name="Clip", update=_on_clip_changed
    )
    geometry: bpy.props.PointerProperty(
        type=bpy.types.Object,
        name="Geometry",
        poll=utils.poll_is_mesh,
        update=_on_geometry_changed,
    )
    camera: bpy.props.PointerProperty(
        type=bpy.types.Object,
        name="Camera",
        poll=utils.poll_is_camera,
        update=_on_camera_changed,
    )

    tracking_target: bpy.props.EnumProperty(
        name="Tracking Target",
        items=[
            ("CAMERA", "Camera", "Solve for camera motion"),
            ("GEOMETRY", "Geometry", "Solve for object motion"),
        ],
        default="CAMERA",
    )

    database_path: bpy.props.StringProperty(
        name="Database", subtype="FILE_PATH", default="//polychase.db"
    )

    # Pin state: packed float32 (N, 3) object-space positions + a version
    # counter so modal operators notice undo/redo edits.
    pins_data: bpy.props.StringProperty(subtype="BYTE_STRING", default="")
    pins_version: bpy.props.IntProperty(default=0)
    selected_pin: bpy.props.IntProperty(default=-1)

    # Packed u32 bitmask of masked triangles
    masked_triangles: bpy.props.StringProperty(
        subtype="BYTE_STRING", default=""
    )

    # Variable-intrinsics toggles
    optimize_focal_length: bpy.props.BoolProperty(
        name="Variable Focal Length", default=False
    )
    optimize_principal_point: bpy.props.BoolProperty(
        name="Variable Principal Point", default=False
    )

    # Appearance
    pin_color: bpy.props.FloatVectorProperty(
        name="Pin Color", subtype="COLOR", size=4, min=0.0, max=1.0,
        default=(0.2, 0.7, 1.0, 1.0),
    )
    selected_pin_color: bpy.props.FloatVectorProperty(
        name="Selected Pin Color", subtype="COLOR", size=4, min=0.0, max=1.0,
        default=(1.0, 0.4, 0.1, 1.0),
    )
    wireframe_color: bpy.props.FloatVectorProperty(
        name="Wireframe Color", subtype="COLOR", size=4, min=0.0, max=1.0,
        default=(0.0, 1.0, 0.5, 0.35),
    )
    masked_color: bpy.props.FloatVectorProperty(
        name="Masked Color", subtype="COLOR", size=4, min=0.0, max=1.0,
        default=(1.0, 0.1, 0.1, 0.5),
    )
    pin_radius: bpy.props.FloatProperty(
        name="Pin Radius", default=7.0, min=2.0, max=30.0
    )
    mask_brush_radius: bpy.props.IntProperty(
        name="Mask Brush Radius", default=20, min=1, max=200
    )

    # Stored transforms captured when entering pin mode (for cancel)
    stored_geometry_matrix: bpy.props.FloatVectorProperty(size=16)
    stored_camera_matrix: bpy.props.FloatVectorProperty(size=16)

    @property
    def transient(self) -> TransientState:
        return transient_state(self)


class PolychaseState(bpy.types.PropertyGroup):
    """Scene-level tracker collection (reference properties.py:262-321)."""

    trackers: bpy.props.CollectionProperty(type=PolychaseTracker)
    active_tracker_index: bpy.props.IntProperty(default=-1)
    next_tracker_id: bpy.props.IntProperty(default=0)

    @staticmethod
    def from_scene(scene=None) -> "PolychaseState":
        scene = scene or bpy.context.scene
        return scene.polychase_state

    @property
    def active_tracker(self):
        idx = self.active_tracker_index
        if 0 <= idx < len(self.trackers):
            return self.trackers[idx]
        return None


CLASSES = (PolychaseTracker, PolychaseState)


def register():
    for cls in CLASSES:
        bpy.utils.register_class(cls)
    bpy.types.Scene.polychase_state = bpy.props.PointerProperty(
        type=PolychaseState
    )


def unregister():
    del bpy.types.Scene.polychase_state
    for cls in reversed(CLASSES):
        bpy.utils.unregister_class(cls)
