"""Scene manipulation operators
(rebuild of blender_addon/operators/scene_operations.py).

- Center Geometry: place the mesh in front of the camera by bbox;
- Convert Animation: camera-animation ↔ geometry-animation by
  recomposing the modelview at every keyframe;
- Transform Scene: rigidly re-pose the whole tracked scene (all
  keyframes) relative to a reference.
"""

from __future__ import annotations

import math

import bpy
import mathutils

from .. import keyframes, properties, utils


def _active_tracker(context):
    state = properties.PolychaseState.from_scene(context.scene)
    return state.active_tracker if state else None


class PC_OT_CenterGeometry(bpy.types.Operator):
    bl_idname = "polychase.center_geometry"
    bl_label = "Center Geometry"
    bl_description = "Place the geometry in front of the camera"
    bl_options = {"REGISTER", "UNDO"}

    @classmethod
    def poll(cls, context):
        tracker = _active_tracker(context)
        return (
            tracker is not None
            and tracker.geometry is not None
            and tracker.camera is not None
            and not properties.transient_state(tracker).busy
        )

    def execute(self, context):
        tracker = _active_tracker(context)
        geometry, camera = tracker.geometry, tracker.camera

        # Object-space bbox radius (reference scene_operations.py:13-101)
        bbox = [mathutils.Vector(c) for c in geometry.bound_box]
        center = sum(bbox, mathutils.Vector()) / 8.0
        radius = max((c - center).length for c in bbox)
        scale = geometry.matrix_world.to_scale()
        radius *= max(scale.x, scale.y, scale.z)
        radius = max(radius, 1e-6)

        # Distance so the bbox fits the camera FOV
        fov = camera.data.angle if camera.data.type == "PERSP" else math.pi / 4
        distance = radius / math.tan(fov / 2.0) * 1.2

        cam_mat = camera.matrix_world
        cam_pos = cam_mat.translation
        view_dir = cam_mat.to_quaternion() @ mathutils.Vector((0, 0, -1))
        target = cam_pos + view_dir * distance

        world_center = geometry.matrix_world @ center
        offset = target - world_center
        loc, rot, _ = geometry.matrix_world.decompose()
        utils.set_object_model_matrix(geometry, loc + offset, rot)
        return {"FINISHED"}


def _iter_keyframe_frames(obj):
    return sorted(
        keyframes.keyframes_of_type(keyframes.object_transform_fcurves(obj))
    )


class PC_OT_ConvertAnimation(bpy.types.Operator):
    bl_idname = "polychase.convert_animation"
    bl_label = "Convert Animation"
    bl_description = (
        "Convert camera animation to geometry animation or vice versa, "
        "preserving the relative motion"
    )
    bl_options = {"REGISTER", "UNDO"}

    @classmethod
    def poll(cls, context):
        tracker = _active_tracker(context)
        return (
            tracker is not None
            and tracker.geometry is not None
            and tracker.camera is not None
            and not properties.transient_state(tracker).busy
        )

    def execute(self, context):
        tracker = _active_tracker(context)
        geometry, camera = tracker.geometry, tracker.camera
        scene = context.scene
        to_geometry = tracker.tracking_target == "CAMERA"
        source = camera if to_geometry else geometry
        dest = geometry if to_geometry else camera

        frames = _iter_keyframe_frames(source)
        if not frames:
            self.report({"WARNING"}, "Source object has no keyframes")
            return {"CANCELLED"}

        # Record keyframe types to preserve anchors
        src_fcurves = keyframes.object_transform_fcurves(source)
        kf_types = {}
        for fc in src_fcurves:
            for kp in fc.keyframe_points:
                kf_types[int(round(kp.co[0]))] = kp.type

        saved = scene.frame_current
        try:
            poses = []
            for frame in frames:
                scene.frame_set(frame)
                view = utils.get_camera_view_matrix(camera)
                model = geometry.matrix_world.copy()
                poses.append((frame, view @ model))

            # Freeze the destination's current transform as the constant
            scene.frame_set(frames[0])
            if to_geometry:
                const_view = utils.get_camera_view_matrix(camera)
            else:
                const_model = geometry.matrix_world.copy()

            # Remove the source's animation (emptied f-curves would
            # evaluate to 0.0 and snap the source to the origin)
            keyframes.clear_keyframes(src_fcurves, lambda f, t: True)
            keyframes.prune_empty_fcurves(source)

            for frame, mv in poses:
                scene.frame_set(frame)
                keytype = kf_types.get(frame, keyframes.GENERATED_KEYFRAME)
                if to_geometry:
                    model = const_view.inverted() @ mv
                    loc, rot, _ = model.decompose()
                    utils.set_object_model_matrix(geometry, loc, rot)
                else:
                    view = mv @ const_model.inverted()
                    loc, rot, _ = view.decompose()
                    utils.set_camera_view_matrix(camera, loc, rot)
                keyframes.insert_keyframe(dest, frame, keytype=keytype)
        finally:
            scene.frame_set(saved)

        tracker.tracking_target = (
            "GEOMETRY" if to_geometry else "CAMERA"
        )
        return {"FINISHED"}


# Live-preview state for PC_OT_TransformScene (reference
# scene_operations.py:240-332): the props dialog edits the reference
# object in real time and the companion object follows rigidly.
_disable_update = True
_orig_geom_mat = mathutils.Matrix()
_orig_cam_mat = mathutils.Matrix()
_orig_geom_scale = mathutils.Vector((1.0, 1.0, 1.0))


def _ts_ref_obj(tracker, reference):
    return tracker.geometry if reference == "GEOMETRY" else tracker.camera


def _ts_on_coords_changed(operator, context):
    """Re-sync the dialog's loc/rot fields from the reference object when
    the coordinate space toggles (reference scene_operations.py:246-272)."""
    global _disable_update
    if _disable_update:
        return
    tracker = _active_tracker(context)
    if not tracker or not tracker.geometry or not tracker.camera:
        return
    ref_obj = _ts_ref_obj(tracker, operator.reference)
    mat = (
        ref_obj.matrix_world
        if operator.coords == "WORLD" else ref_obj.matrix_local
    )
    loc, rot, _ = mat.decompose()
    _disable_update = True
    operator.location = loc
    operator.rotation = rot.to_euler()
    _disable_update = False


def _ts_update_reference(tracker, reference):
    """Companion object rigidly follows the edited reference
    (reference scene_operations.py:275-293)."""
    if reference == "GEOMETRY":
        update = tracker.geometry.matrix_world @ _orig_geom_mat.inverted()
        tracker.camera.matrix_world = update @ _orig_cam_mat
    else:
        update = tracker.camera.matrix_world @ _orig_cam_mat.inverted()
        tracker.geometry.matrix_world = update @ _orig_geom_mat
    tracker.camera.scale = (1.0, 1.0, 1.0)


def _ts_on_transform_changed(operator, context):
    """Live preview: write the dialog transform onto the reference object
    and drag the companion along (reference scene_operations.py:296-332)."""
    global _disable_update
    if _disable_update:
        return
    tracker = _active_tracker(context)
    if not tracker or not tracker.geometry or not tracker.camera:
        return

    if operator.reference == "GEOMETRY":
        ref_obj = tracker.geometry
        scale = operator.scale * _orig_geom_scale
    else:
        ref_obj = tracker.camera
        scale = None

    matrix = mathutils.Matrix.LocRotScale(
        mathutils.Vector(operator.location),
        mathutils.Euler(operator.rotation).to_quaternion(),
        scale,
    )
    if operator.coords == "WORLD":
        ref_obj.matrix_world = matrix
    else:
        ref_obj.matrix_world = (
            ref_obj.matrix_world @ ref_obj.matrix_local.inverted()
        ) @ matrix
    _ts_update_reference(tracker, operator.reference)


class PC_OT_TransformScene(bpy.types.Operator):
    bl_idname = "polychase.transform_scene"
    bl_label = "Transform Scene"
    bl_description = (
        "Transform tracked geometry or camera while maintaining correct "
        "relative poses between them"
    )
    bl_options = {"REGISTER", "UNDO"}

    reference: bpy.props.EnumProperty(
        name="Reference",
        items=(
            ("GEOMETRY", "Geometry", "Transform geometry"),
            ("CAMERA", "Camera", "Transform camera"),
        ),
    )
    coords: bpy.props.EnumProperty(
        name="Coordinates",
        items=(
            ("LOCAL", "Local", "Local Coordinates"),
            ("WORLD", "World", "World Coordinates"),
        ),
        default="WORLD",
        update=_ts_on_coords_changed,
    )
    scale: bpy.props.FloatProperty(
        name="Scale", default=1.0, precision=3, min=0.0,
        update=_ts_on_transform_changed,
    )
    rotation: bpy.props.FloatVectorProperty(
        name="Rotation", size=3, subtype="EULER", precision=3,
        update=_ts_on_transform_changed,
    )
    location: bpy.props.FloatVectorProperty(
        name="Location", size=3, subtype="TRANSLATION", precision=3,
        update=_ts_on_transform_changed,
    )

    @classmethod
    def poll(cls, context):
        tracker = _active_tracker(context)
        return (
            tracker is not None
            and tracker.geometry is not None
            and tracker.camera is not None
            and not properties.transient_state(tracker).busy
        )

    def draw(self, context):
        layout = self.layout
        layout.use_property_split = True
        col = layout.column()
        col.prop(self, "coords")
        col.prop(self, "location")
        col.prop(self, "rotation")
        if self.reference == "GEOMETRY":
            col.prop(self, "scale")

    def invoke(self, context, event):
        global _disable_update, _orig_geom_mat, _orig_cam_mat
        global _orig_geom_scale
        tracker = _active_tracker(context)
        if not tracker or not tracker.geometry or not tracker.camera:
            return {"CANCELLED"}

        # Cancel-restore snapshots + the rigid-link baseline
        self._geom_mat = tracker.geometry.matrix_world.copy()
        self._cam_mat = tracker.camera.matrix_world.copy()
        _orig_geom_mat = self._geom_mat.copy()
        _orig_cam_mat = self._cam_mat.copy()
        _orig_geom_scale = self._geom_mat.to_scale()

        scale_n = _orig_geom_scale.normalized()
        if abs(scale_n.x - scale_n.y) > 0.01 or abs(
            scale_n.y - scale_n.z
        ) > 0.01:
            self.report({"ERROR"}, "Non uniform scale detected")
            return {"CANCELLED"}

        _disable_update = True
        self.scale = 1.0
        _disable_update = False
        _ts_on_coords_changed(self, context)
        return context.window_manager.invoke_props_dialog(self)

    def execute(self, context):
        tracker = _active_tracker(context)
        geometry, camera = tracker.geometry, tracker.camera
        scene = context.scene

        if self.reference == "GEOMETRY":
            update = geometry.matrix_world @ _orig_geom_mat.inverted()
        else:
            update = camera.matrix_world @ _orig_cam_mat.inverted()

        animated = (
            geometry if tracker.tracking_target == "GEOMETRY" else camera
        )
        frames = _iter_keyframe_frames(animated)
        saved = scene.frame_current
        try:
            if tracker.tracking_target == "GEOMETRY":
                for frame in frames:
                    scene.frame_set(frame)
                    mat_world = geometry.matrix_world.copy()
                    geometry.matrix_world = update @ mat_world
                    keyframes.insert_keyframe(geometry, frame)
                    # restore so the object's scale channel is untouched
                    geometry.matrix_world = mat_world
                camera.matrix_world = update @ _orig_cam_mat
                camera.scale = (1.0, 1.0, 1.0)
            else:
                for frame in frames:
                    scene.frame_set(frame)
                    camera.matrix_world = update @ camera.matrix_world
                    camera.scale = (1.0, 1.0, 1.0)
                    keyframes.insert_keyframe(camera, frame)
                geometry.matrix_world = update @ _orig_geom_mat
        finally:
            scene.frame_set(saved)
        return {"FINISHED"}

    def cancel(self, context):
        tracker = _active_tracker(context)
        if not tracker:
            return
        if tracker.geometry and hasattr(self, "_geom_mat"):
            tracker.geometry.matrix_world = self._geom_mat
        if tracker.camera and hasattr(self, "_cam_mat"):
            tracker.camera.matrix_world = self._cam_mat


CLASSES = (
    PC_OT_CenterGeometry,
    PC_OT_ConvertAnimation,
    PC_OT_TransformScene,
)
