"""Keyframe management operators
(rebuild of blender_addon/operators/keyframe_management.py).

Navigation between keyframes, add/remove user anchors, clear generated
keyframes backwards/forwards/in-segment/all.
"""

from __future__ import annotations

import bpy

from .. import keyframes, properties


def _active_tracker(context):
    state = properties.PolychaseState.from_scene(context.scene)
    return state.active_tracker if state else None


def _target_object(tracker):
    return (
        tracker.camera
        if tracker.tracking_target == "CAMERA" else tracker.geometry
    )


def _prune(tracker):
    keyframes.prune_empty_fcurves(
        _target_object(tracker),
        tracker.camera.data if tracker.camera else None,
    )


class _TrackerOperator(bpy.types.Operator):
    @classmethod
    def poll(cls, context):
        tracker = _active_tracker(context)
        return (
            tracker is not None
            and _target_object(tracker) is not None
            and not properties.transient_state(tracker).busy
        )


class PC_OT_PrevKeyframe(_TrackerOperator):
    bl_idname = "polychase.prev_keyframe"
    bl_label = "Previous Keyframe"
    bl_options = {"REGISTER"}

    def execute(self, context):
        tracker = _active_tracker(context)
        fcurves = keyframes.tracker_fcurves(tracker, include_lens=False)
        frame = keyframes.find_prev_keyframe(
            fcurves, context.scene.frame_current, keyframes.USER_KEYFRAME
        )
        if frame is None:
            return {"CANCELLED"}
        context.scene.frame_set(frame)
        return {"FINISHED"}


class PC_OT_NextKeyframe(_TrackerOperator):
    bl_idname = "polychase.next_keyframe"
    bl_label = "Next Keyframe"
    bl_options = {"REGISTER"}

    def execute(self, context):
        tracker = _active_tracker(context)
        fcurves = keyframes.tracker_fcurves(tracker, include_lens=False)
        frame = keyframes.find_next_keyframe(
            fcurves, context.scene.frame_current, keyframes.USER_KEYFRAME
        )
        if frame is None:
            return {"CANCELLED"}
        context.scene.frame_set(frame)
        return {"FINISHED"}


class PC_OT_AddKeyframe(_TrackerOperator):
    bl_idname = "polychase.add_keyframe"
    bl_label = "Add Keyframe"
    bl_description = "Insert a user anchor keyframe at the current frame"
    bl_options = {"REGISTER", "UNDO"}

    def execute(self, context):
        tracker = _active_tracker(context)
        target = _target_object(tracker)
        frame = context.scene.frame_current
        keyframes.insert_keyframe(
            target, frame, keytype=keyframes.USER_KEYFRAME
        )
        if tracker.camera and (
            tracker.optimize_focal_length or tracker.optimize_principal_point
        ):
            keyframes.insert_camera_lens_keyframe(
                tracker.camera, frame, keytype=keyframes.USER_KEYFRAME
            )
        return {"FINISHED"}


class PC_OT_RemoveKeyframe(_TrackerOperator):
    bl_idname = "polychase.remove_keyframe"
    bl_label = "Remove Keyframe"
    bl_description = "Remove the keyframe at the current frame"
    bl_options = {"REGISTER", "UNDO"}

    def execute(self, context):
        tracker = _active_tracker(context)
        frame = context.scene.frame_current
        fcurves = keyframes.tracker_fcurves(tracker)
        removed = keyframes.clear_keyframes(
            fcurves, lambda f, t: f == frame
        )
        _prune(tracker)
        return {"FINISHED"} if removed else {"CANCELLED"}


class PC_OT_ClearBackwards(_TrackerOperator):
    bl_idname = "polychase.clear_backwards"
    bl_label = "Clear Backwards"
    bl_description = "Clear generated keyframes before the current frame"
    bl_options = {"REGISTER", "UNDO"}

    def execute(self, context):
        tracker = _active_tracker(context)
        frame = context.scene.frame_current
        fcurves = keyframes.tracker_fcurves(tracker)
        keyframes.clear_keyframes(
            fcurves,
            lambda f, t: t == keyframes.GENERATED_KEYFRAME and f <= frame,
        )
        _prune(tracker)
        return {"FINISHED"}


class PC_OT_ClearForwards(_TrackerOperator):
    bl_idname = "polychase.clear_forwards"
    bl_label = "Clear Forwards"
    bl_description = "Clear generated keyframes after the current frame"
    bl_options = {"REGISTER", "UNDO"}

    def execute(self, context):
        tracker = _active_tracker(context)
        frame = context.scene.frame_current
        fcurves = keyframes.tracker_fcurves(tracker)
        keyframes.clear_keyframes(
            fcurves,
            lambda f, t: t == keyframes.GENERATED_KEYFRAME and f >= frame,
        )
        _prune(tracker)
        return {"FINISHED"}


class PC_OT_ClearSegment(_TrackerOperator):
    bl_idname = "polychase.clear_segment"
    bl_label = "Clear Segment"
    bl_description = (
        "Clear generated keyframes between the surrounding user keyframes"
    )
    bl_options = {"REGISTER", "UNDO"}

    def execute(self, context):
        tracker = _active_tracker(context)
        frame = context.scene.frame_current
        fcurves = keyframes.tracker_fcurves(tracker)
        prev_kf = keyframes.find_prev_keyframe(
            fcurves, frame + 1, keyframes.USER_KEYFRAME
        )
        next_kf = keyframes.find_next_keyframe(
            fcurves, frame - 1, keyframes.USER_KEYFRAME
        )
        lo = prev_kf if prev_kf is not None else -(10**9)
        hi = next_kf if next_kf is not None else 10**9
        keyframes.clear_keyframes(
            fcurves,
            lambda f, t: t == keyframes.GENERATED_KEYFRAME and lo < f < hi,
        )
        _prune(tracker)
        return {"FINISHED"}


class PC_OT_ClearAllGenerated(_TrackerOperator):
    bl_idname = "polychase.clear_all_generated"
    bl_label = "Clear All Tracked"
    bl_description = "Clear all generated keyframes"
    bl_options = {"REGISTER", "UNDO"}

    def execute(self, context):
        tracker = _active_tracker(context)
        fcurves = keyframes.tracker_fcurves(tracker)
        keyframes.clear_all_generated(fcurves)
        _prune(tracker)
        return {"FINISHED"}


CLASSES = (
    PC_OT_PrevKeyframe,
    PC_OT_NextKeyframe,
    PC_OT_AddKeyframe,
    PC_OT_RemoveKeyframe,
    PC_OT_ClearBackwards,
    PC_OT_ClearForwards,
    PC_OT_ClearSegment,
    PC_OT_ClearAllGenerated,
)
