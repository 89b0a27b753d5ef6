"""Track Sequence operator (rebuild of blender_addon/operators/tracking.py).

Computes the tracking segment from the current frame to the next/prev
user keyframe (or clip edge), runs ``TrackerThread``, and converts each
per-frame result into Blender keyframes (GENERATED type), aborting when
the inlier ratio collapses below 0.25.
"""

from __future__ import annotations

import bpy
import mathutils
import numpy as np

from ... import polychase_core as pc
from .. import core, keyframes, properties, utils

MIN_INLIER_RATIO = 0.25


def compute_segment_end(tracker, current_frame: int, backward: bool,
                        single_frame: bool) -> int:
    """current frame → next/prev user KEYFRAME or clip edge
    (reference tracking.py:396-415)."""
    clip = tracker.clip
    clip_start = clip.frame_start
    clip_end = clip.frame_start + clip.frame_duration - 1
    if single_frame:
        return max(clip_start, current_frame - 1) if backward else min(
            clip_end, current_frame + 1
        )
    fcurves = keyframes.tracker_fcurves(tracker, include_lens=False)
    if backward:
        prev_kf = keyframes.find_prev_keyframe(
            fcurves, current_frame, keyframes.USER_KEYFRAME
        )
        return prev_kf if prev_kf is not None else clip_start
    next_kf = keyframes.find_next_keyframe(
        fcurves, current_frame, keyframes.USER_KEYFRAME
    )
    return next_kf if next_kf is not None else clip_end


def apply_tracking_result(tracker, result) -> None:
    """Pose → Blender transforms + GENERATED keyframes
    (reference tracking.py:290-356).

    The solved pose is the scale-free modelview (Rmv, tmv) from the
    scale-folding factorization (core.fold_scale); the object's scale is
    preserved on write-back.
    """
    geometry, camera = tracker.geometry, tracker.camera
    pose = result.pose
    Rmv = mathutils.Quaternion(
        (float(pose.q[0]), float(pose.q[1]), float(pose.q[2]),
         float(pose.q[3]))
    )
    tmv = mathutils.Vector(
        (float(pose.t[0]), float(pose.t[1]), float(pose.t[2]))
    )

    if tracker.tracking_target == "CAMERA":
        # view = modelview · model⁻¹ with the geometry's rigid part
        # (reference tracking.py:331-337)
        tm, Rm, _scale = utils.get_object_model_matrix_loc_rot_scale(
            geometry
        )
        Rm_inv = Rm.inverted()
        Rv = Rmv @ Rm_inv
        tv = tmv - Rv @ tm
        utils.set_camera_view_matrix(camera, tv, Rv)
        target = camera
    else:
        # model (rigid part) = view⁻¹ · modelview; scale preserved by
        # set_object_model_matrix (reference tracking.py:313-320)
        tv, Rv = utils.get_camera_view_matrix_loc_rot(camera)
        Rv_inv = Rv.inverted()
        Rm = Rv_inv @ Rmv
        tm = Rv_inv @ (tmv - tv)
        utils.set_object_model_matrix(geometry, tm, Rm)
        target = geometry

    keyframes.insert_keyframe(
        target, result.frame, keytype=keyframes.GENERATED_KEYFRAME
    )
    if tracker.optimize_focal_length or tracker.optimize_principal_point:
        core.set_camera_intrinsics(camera, result.intrinsics)
        keyframes.insert_camera_lens_keyframe(
            camera, result.frame, keytype=keyframes.GENERATED_KEYFRAME
        )


class _TrackOperatorBase(bpy.types.Operator):
    backward: bpy.props.BoolProperty(default=False)
    single_frame: bpy.props.BoolProperty(default=False)

    _thread = None
    _timer = None
    _tracker_id = -1
    _segment_end = 0

    @classmethod
    def poll(cls, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker if state else None
        return (
            tracker is not None
            and tracker.clip is not None
            and tracker.geometry is not None
            and tracker.camera is not None
            and not properties.transient_state(tracker).busy
        )

    def execute(self, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker
        clip = tracker.clip
        width, height = utils.clip_size(clip)
        current = context.scene.frame_current

        engine_tracker = core.Trackers.get(tracker)
        if engine_tracker is None or engine_tracker.accel_mesh is None:
            self.report({"ERROR"}, "No geometry to track against")
            return {"CANCELLED"}

        end = compute_segment_end(
            tracker, current, self.backward, self.single_frame
        )
        if end == current:
            self.report({"WARNING"}, "Nothing to track")
            return {"CANCELLED"}
        self._segment_end = end

        # Ensure an anchor USER keyframe at the start frame
        # (reference tracking.py:417-453)
        target = (
            tracker.camera
            if tracker.tracking_target == "CAMERA" else tracker.geometry
        )
        fcurves = keyframes.tracker_fcurves(tracker, include_lens=False)
        if not keyframes.has_keyframe_at(
            fcurves, current, keyframes.USER_KEYFRAME
        ):
            keyframes.insert_keyframe(
                target, current, keytype=keyframes.USER_KEYFRAME
            )
            if tracker.optimize_focal_length or (
                tracker.optimize_principal_point
            ):
                keyframes.insert_camera_lens_keyframe(
                    tracker.camera, current,
                    keytype=keyframes.USER_KEYFRAME,
                )

        scene_transform = core.scene_transformations(tracker, width, height)

        bundle_opts = pc.BundleOptions()
        bundle_opts.loss_type = pc.LossType.Cauchy
        bundle_opts.loss_scale = 1.0

        db_path = bpy.path.abspath(tracker.database_path)
        self._thread = pc.TrackerThread(
            db_path, current, end, scene_transform,
            engine_tracker.accel_mesh,
            tracker.optimize_focal_length and tracker.tracking_target
            == "CAMERA",
            tracker.optimize_principal_point and tracker.tracking_target
            == "CAMERA",
            bundle_opts,
            device=core.DEVICE,
        )
        self._tracker_id = tracker.id

        transient = properties.transient_state(tracker)
        transient.is_tracking = True
        transient.active_thread = self._thread
        transient.progress = 0.0
        transient.progress_message = "Tracking..."

        wm = context.window_manager
        self._timer = wm.event_timer_add(0.05, window=context.window)
        wm.modal_handler_add(self)
        return {"RUNNING_MODAL"}

    def modal(self, context, event):
        if event.type == "ESC":
            self._thread.request_stop()
        if event.type != "TIMER":
            return {"PASS_THROUGH"}

        state = properties.PolychaseState.from_scene(context.scene)
        tracker = None
        for t in state.trackers:
            if t.id == self._tracker_id:
                tracker = t
        if tracker is None:
            return self._finish(context, None, success=False)

        transient = properties.transient_state(tracker)
        start = context.scene.frame_current
        total = max(abs(self._segment_end - start), 1)

        while True:
            msg = self._thread.try_pop()
            if msg is None:
                break
            if isinstance(msg, bool):
                return self._finish(context, tracker, success=True)
            if isinstance(msg, Exception):
                self.report({"ERROR"}, str(msg))
                return self._finish(context, tracker, success=False)
            # FrameTrackingResult
            if msg.inlier_ratio < MIN_INLIER_RATIO:
                self.report(
                    {"WARNING"},
                    f"Stopping: inlier ratio {msg.inlier_ratio:.2f} at "
                    f"frame {msg.frame}",
                )
                self._thread.request_stop()
                return self._finish(context, tracker, success=True)
            apply_tracking_result(tracker, msg)
            transient.progress = abs(msg.frame - start) / total
            transient.progress_message = f"Tracked frame {msg.frame}"
            context.scene.frame_set(msg.frame)
            utils.redraw_view3d(context)
        return {"RUNNING_MODAL"}

    def _finish(self, context, tracker, success: bool):
        wm = context.window_manager
        if self._timer is not None:
            wm.event_timer_remove(self._timer)
        self._thread.join()
        if tracker is not None:
            transient = properties.transient_state(tracker)
            transient.is_tracking = False
            transient.active_thread = None
            transient.progress_message = (
                "Tracking complete" if success else "Tracking failed"
            )
        utils.redraw_view3d(context)
        return {"FINISHED"} if success else {"CANCELLED"}


class PC_OT_TrackSequence(_TrackOperatorBase):
    bl_idname = "polychase.track_sequence"
    bl_label = "Track Sequence"
    bl_description = (
        "Track from the current frame to the next/previous user keyframe"
    )
    bl_options = {"REGISTER", "UNDO"}


class PC_OT_CancelTracking(bpy.types.Operator):
    bl_idname = "polychase.cancel_tracking"
    bl_label = "Cancel Tracking"

    @classmethod
    def poll(cls, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker if state else None
        return (
            tracker is not None
            and properties.transient_state(tracker).is_tracking
        )

    def execute(self, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker
        thread = properties.transient_state(tracker).active_thread
        if thread is not None:
            thread.request_stop()
        return {"FINISHED"}


CLASSES = (PC_OT_TrackSequence, PC_OT_CancelTracking)
