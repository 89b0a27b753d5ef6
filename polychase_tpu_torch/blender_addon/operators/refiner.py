"""Refine Sequence operators (rebuild of blender_addon/operators/refiner.py).

Segments lie between consecutive user KEYFRAMEs.  For each segment a
``CameraTrajectory`` is built by sampling the evaluated scene per frame,
refined in a ``RefinerThread``, and the refined poses written back as
GENERATED keyframes (anchor endpoints untouched).
"""

from __future__ import annotations

import bpy
import mathutils
import numpy as np

from ... import polychase_core as pc
from .. import core, keyframes, properties, utils


def compute_segments(tracker, current_frame: int, all_segments: bool):
    """Segments between consecutive user keyframes
    (reference refiner.py:58-136)."""
    clip = tracker.clip
    clip_start = clip.frame_start
    clip_end = clip.frame_start + clip.frame_duration - 1
    fcurves = keyframes.tracker_fcurves(tracker, include_lens=False)
    user_kfs = sorted(
        keyframes.keyframes_of_type(fcurves, keyframes.USER_KEYFRAME)
    )
    user_kfs = [f for f in user_kfs if clip_start <= f <= clip_end]
    if len(user_kfs) < 2:
        return []

    segments = [
        (a, b) for a, b in zip(user_kfs[:-1], user_kfs[1:]) if b - a >= 2
    ]
    if all_segments:
        return segments

    # Current segment only; if the current frame IS a user keyframe,
    # refine the two segments adjacent to it.
    out = []
    for a, b in segments:
        if a <= current_frame <= b:
            out.append((a, b))
    return out


def build_trajectory(tracker, start: int, end: int, width, height,
                     depsgraph_scene):
    """Sample the evaluated scene per frame into a CameraTrajectory
    (reference refiner.py:138-226)."""
    scene = depsgraph_scene
    traj = pc.CameraTrajectory(start, end - start + 1)
    saved_frame = scene.frame_current
    try:
        for frame in range(start, end + 1):
            scene.frame_set(frame)
            # Pose = modelview without scale (the scale rides the model
            # matrix passed to the refiner, reference refiner.py:175-200).
            tm, Rm, _scale = utils.get_object_model_matrix_loc_rot_scale(
                tracker.geometry
            )
            tv, Rv = utils.get_camera_view_matrix_loc_rot(tracker.camera)
            Rmv = Rv @ Rm
            tmv = tv + Rv @ tm
            intr = core.camera_intrinsics(tracker.camera, width, height)
            pose = pc.Pose(
                q=np.array([Rmv.w, Rmv.x, Rmv.y, Rmv.z], np.float32),
                t=np.array(tmv[:], np.float32),
            )
            traj.set(frame, pc.CameraState(intr, pose))
    finally:
        scene.frame_set(saved_frame)
    return traj


def apply_refined_trajectory(tracker, traj, start: int, end: int,
                             scene) -> None:
    """Write refined poses back as GENERATED keyframes, excluding the
    anchor endpoints (reference refiner.py:378-461)."""
    saved_frame = scene.frame_current
    try:
        for frame in range(start + 1, end):
            state = traj.get(frame)
            if state is None:
                continue
            scene.frame_set(frame)
            # The refined pose is the scale-free modelview; recompose as
            # in tracking (reference refiner.py:410-445).
            Rmv = mathutils.Quaternion(
                tuple(float(v) for v in state.pose.q)
            )
            tmv = mathutils.Vector(tuple(float(v) for v in state.pose.t))
            if tracker.tracking_target == "CAMERA":
                tm, Rm, _s = utils.get_object_model_matrix_loc_rot_scale(
                    tracker.geometry
                )
                Rv = Rmv @ Rm.inverted()
                tv = tmv - Rv @ tm
                utils.set_camera_view_matrix(tracker.camera, tv, Rv)
                target = tracker.camera
            else:
                tv, Rv = utils.get_camera_view_matrix_loc_rot(
                    tracker.camera
                )
                Rv_inv = Rv.inverted()
                Rm = Rv_inv @ Rmv
                tm = Rv_inv @ (tmv - tv)
                utils.set_object_model_matrix(tracker.geometry, tm, Rm)
                target = tracker.geometry
            keyframes.insert_keyframe(
                target, frame, keytype=keyframes.GENERATED_KEYFRAME
            )
            if tracker.optimize_focal_length or (
                tracker.optimize_principal_point
            ):
                core.set_camera_intrinsics(tracker.camera, state.intrinsics)
                keyframes.insert_camera_lens_keyframe(
                    tracker.camera, frame,
                    keytype=keyframes.GENERATED_KEYFRAME,
                )
    finally:
        scene.frame_set(saved_frame)


class PC_OT_RefineSequence(bpy.types.Operator):
    bl_idname = "polychase.refine_sequence"
    bl_label = "Refine Sequence"
    bl_description = "Bundle-adjust the tracked trajectory between keyframes"
    bl_options = {"REGISTER", "UNDO"}

    all_segments: bpy.props.BoolProperty(default=False)

    _thread = None
    _timer = None
    _tracker_id = -1
    _segments = None
    _segment_idx = 0
    _current_traj = None
    _parallel_trajs = None  # multi-card refine-all: all segments at once

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
        self._segments = compute_segments(
            tracker, context.scene.frame_current, self.all_segments
        )
        if not self._segments:
            self.report(
                {"WARNING"},
                "Need at least two user keyframes (with frames between) "
                "to refine",
            )
            return {"CANCELLED"}

        engine_tracker = core.Trackers.get(tracker)
        if engine_tracker is None or engine_tracker.accel_mesh is None:
            self.report({"ERROR"}, "No geometry")
            return {"CANCELLED"}

        self._tracker_id = tracker.id
        self._segment_idx = 0

        transient = properties.transient_state(tracker)
        transient.is_refining = True
        transient.progress = 0.0
        transient.progress_message = "Refining..."

        # Refine-all on several cards: segments are independent BA
        # problems, so solve them ALL in one parallel dispatch (the
        # reference — and the one-card path below — runs them
        # sequentially, reference refiner.py:99-136).  Only the card
        # default splits over cards; an explicit device runs one card.
        self._parallel_trajs = None
        if (
            self.all_segments
            and len(self._segments) > 1
            and core.DEVICE is None
            and pc.device_count() > 1
        ):
            if not self._start_parallel(context, tracker, engine_tracker):
                transient.is_refining = False
                return {"CANCELLED"}
        elif not self._start_segment(context, tracker, engine_tracker):
            transient.is_refining = False
            return {"CANCELLED"}

        wm = context.window_manager
        self._timer = wm.event_timer_add(0.05, window=context.window)
        wm.modal_handler_add(self)
        return {"RUNNING_MODAL"}

    def _start_parallel(self, context, tracker, engine_tracker) -> bool:
        clip = tracker.clip
        width, height = utils.clip_size(clip)
        trajs = [
            build_trajectory(
                tracker, start, end, width, height, context.scene
            )
            for start, end in self._segments
        ]
        self._parallel_trajs = trajs
        model = np.array(
            mathutils.Matrix.Diagonal(
                tracker.geometry.matrix_world.to_scale().to_4d()
            ),
            np.float32,
        )
        opts = pc.BundleOptions()
        opts.loss_type = pc.LossType.Cauchy
        opts.loss_scale = 1.0
        self._thread = pc.RefineSegmentsThread(
            bpy.path.abspath(tracker.database_path), trajs, model,
            engine_tracker.accel_mesh,
            tracker.optimize_focal_length,
            tracker.optimize_principal_point,
            opts,
            device=core.DEVICE,
        )
        transient = properties.transient_state(tracker)
        transient.active_thread = self._thread
        return True

    def _start_segment(self, context, tracker, engine_tracker) -> bool:
        start, end = self._segments[self._segment_idx]
        clip = tracker.clip
        width, height = utils.clip_size(clip)
        traj = build_trajectory(
            tracker, start, end, width, height, context.scene
        )
        self._current_traj = (traj, start, end)

        # Scale-folding: the refiner's model matrix is the scale only
        # (reference refiner.py:361-371); poses in the trajectory are the
        # scale-free modelview.
        model = np.array(
            mathutils.Matrix.Diagonal(
                tracker.geometry.matrix_world.to_scale().to_4d()
            ),
            np.float32,
        )
        opts = pc.BundleOptions()
        opts.loss_type = pc.LossType.Cauchy
        opts.loss_scale = 1.0

        self._thread = pc.RefinerThread(
            bpy.path.abspath(tracker.database_path), traj, model,
            engine_tracker.accel_mesh,
            tracker.optimize_focal_length,
            tracker.optimize_principal_point,
            opts,
            device=core.DEVICE,
        )
        transient = properties.transient_state(tracker)
        transient.active_thread = self._thread
        return True

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

        while True:
            msg = self._thread.try_pop()
            if msg is None:
                break
            if isinstance(msg, bool):
                if self._parallel_trajs is not None:
                    # Parallel refine-all: one done message for the whole
                    # batch.  A cancelled run completes its dispatch but
                    # its results are NOT applied (the sequential path
                    # aborts mid-segment instead).
                    if getattr(self._thread, "stopped", False):
                        return self._finish(
                            context, tracker, success=False
                        )
                    for traj, (start, end) in zip(
                        self._parallel_trajs, self._segments
                    ):
                        apply_refined_trajectory(
                            tracker, traj, start, end, context.scene
                        )
                    return self._finish(context, tracker, success=True)
                # Segment done: apply results (partials applied on cancel
                # as well, reference refiner.py:560-568)
                traj, start, end = self._current_traj
                apply_refined_trajectory(
                    tracker, traj, start, end, context.scene
                )
                self._segment_idx += 1
                if self._segment_idx >= len(self._segments):
                    return self._finish(context, tracker, success=True)
                engine_tracker = core.Trackers.get(tracker)
                self._thread.join()
                if not self._start_segment(context, tracker, engine_tracker):
                    return self._finish(context, tracker, success=False)
            elif isinstance(msg, Exception):
                self.report({"ERROR"}, str(msg))
                return self._finish(context, tracker, success=False)
            else:  # RefineTrajectoryUpdate
                seg_frac = self._segment_idx / len(self._segments)
                transient.progress = seg_frac + msg.progress / len(
                    self._segments
                )
                transient.progress_message = msg.message
                utils.redraw_view3d(context)
        return {"RUNNING_MODAL"}

    def _finish(self, context, tracker, success: bool):
        wm = context.window_manager
        if self._timer is not None:
            wm.event_timer_remove(self._timer)
        if self._thread is not None:
            self._thread.join()
        if tracker is not None:
            transient = properties.transient_state(tracker)
            transient.is_refining = False
            transient.active_thread = None
            transient.progress_message = (
                "Refinement complete" if success else "Refinement failed"
            )
        utils.redraw_view3d(context)
        return {"FINISHED"} if success else {"CANCELLED"}


class PC_OT_RefineAllSegments(PC_OT_RefineSequence):
    bl_idname = "polychase.refine_all_segments"
    bl_label = "Refine All Segments"
    bl_description = "Bundle-adjust every segment between user keyframes"

    def execute(self, context):
        self.all_segments = True
        return super().execute(context)


class PC_OT_CancelRefine(bpy.types.Operator):
    bl_idname = "polychase.cancel_refine"
    bl_label = "Cancel Refinement"

    @classmethod
    def poll(cls, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker if state else None
        return (
            tracker is not None
            and properties.transient_state(tracker).is_refining
        )

    def execute(self, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker
        thread = properties.transient_state(tracker).active_thread
        if thread is not None:
            thread.request_stop()
        return {"FINISHED"}


CLASSES = (PC_OT_RefineSequence, PC_OT_RefineAllSegments, PC_OT_CancelRefine)
