"""Analyze Video operator (rebuild of blender_addon/operators/analysis.py).

Modal operator around ``OpticalFlowThread``: pumps the message queue on
a timer; on a frame request, seeks the scene to that frame, reads the
camera background image pixels and feeds them to the worker.
"""

from __future__ import annotations

import bpy
import numpy as np

from ... import polychase_core as pc
from .. import background_images, core, properties, utils


class PC_OT_AnalyzeVideo(bpy.types.Operator):
    bl_idname = "polychase.analyze_video"
    bl_label = "Analyze Video"
    bl_description = "Detect features and compute optical flow for the clip"
    bl_options = {"REGISTER"}

    frame_start: bpy.props.IntProperty(name="Start Frame", default=1)
    frame_end: bpy.props.IntProperty(name="End Frame", default=250)
    write_images: bpy.props.BoolProperty(
        name="Write Debug Images", default=False
    )

    _timer = None
    _thread = None
    _tracker_id = -1
    _pending_frame = None

    @classmethod
    def poll(cls, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker if state else None
        return (
            tracker is not None
            and tracker.clip is not None
            and tracker.camera is not None
            and not properties.transient_state(tracker).busy
        )

    def invoke(self, context, event):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker
        clip = tracker.clip
        self.frame_start = clip.frame_start
        self.frame_end = clip.frame_start + clip.frame_duration - 1
        return context.window_manager.invoke_props_dialog(self)

    def _prepare_image_source(self, tracker):
        """Find-or-create the Image datablock that exposes clip pixels
        (reference analysis.py:85-116)."""
        camera_data = tracker.camera.data
        clip = tracker.clip
        bg = background_images.find_background_image_for_clip(
            camera_data, clip
        )
        if bg is not None and bg.source == "IMAGE" and bg.image is not None:
            image_source = bg.image
        else:
            _, image_source = (
                background_images.create_background_image_for_clip(
                    camera_data, clip, alpha=0.0
                )
            )
        self._image_source_name = image_source.name
        return image_source

    def execute(self, context):
        import os

        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker
        clip = tracker.clip
        width, height = utils.clip_size(clip)

        background_images.setup_background_for_clip(tracker.camera, clip)
        if self._prepare_image_source(tracker) is None:
            return {"CANCELLED"}

        db_dir = os.path.dirname(bpy.path.abspath(tracker.database_path))
        if db_dir and not os.path.isdir(db_dir):
            os.makedirs(db_dir, exist_ok=True)

        info = pc.VideoInfo(
            width=width,
            height=height,
            first_frame=self.frame_start,
            num_frames=self.frame_end - self.frame_start + 1,
        )
        db_path = bpy.path.abspath(tracker.database_path)
        self._thread = pc.OpticalFlowThread(
            info, db_path, pc.GFTTOptions(), pc.OpticalFlowOptions(),
            self.write_images, device=core.DEVICE,
        )
        self._tracker_id = tracker.id

        transient = properties.transient_state(tracker)
        transient.is_analyzing = True
        transient.active_thread = self._thread
        transient.progress = 0.0
        transient.progress_message = "Starting analysis..."

        wm = context.window_manager
        self._timer = wm.event_timer_add(0.05, window=context.window)
        wm.modal_handler_add(self)
        return {"RUNNING_MODAL"}

    def _provide_frame(self, context, frame_id: int):
        """Seek + read the clip frame's pixels (reference
        analysis.py:182-233).

        The worker blocks until the frame arrives, so an unsatisfied
        request MUST stay pending: seeking takes a redraw cycle, and the
        next timer tick retries (``_pending_frame``).  Consuming the
        request without providing would strand the worker until its
        provide timeout kills the run."""
        self._pending_frame = frame_id
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = None
        for t in state.trackers:
            if t.id == self._tracker_id:
                tracker = t
                break
        image_source = bpy.data.images.get(self._image_source_name)
        if tracker is None or tracker.camera is None or image_source is None:
            self._pending_frame = None
            self._thread.request_stop()
            return

        image_user = background_images.get_image_user_for_image(
            tracker.camera.data, image_source
        )
        if image_user is None:
            self._pending_frame = None
            self._thread.request_stop()
            return

        user_frame = (
            frame_id + image_user.frame_offset - image_user.frame_start + 1
        )
        # Wait until both the scene and the background image settle on the
        # requested frame; the next timer tick retries.
        if (
            image_user.frame_current != user_frame
            or context.scene.frame_current != frame_id
        ):
            context.scene.frame_set(frame_id)
            return

        # The image may still not be refreshed — force a redraw.
        bpy.ops.wm.redraw_timer(type="DRAW_WIN_SWAP", iterations=1)

        width, height = image_source.size
        channels = image_source.channels
        pixels = np.empty((height, width, channels), np.float32)
        image_source.pixels.foreach_get(pixels.ravel())
        rgb = (pixels[:, :, :3] * 255.0).astype(np.uint8)
        self._pending_frame = None
        self._thread.provide_frame(frame_id, rgb)

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
        transient = (
            properties.transient_state(tracker) if tracker else None
        )

        # Retry a request that was waiting on a frame seek last tick.
        if self._pending_frame is not None:
            self._provide_frame(context, self._pending_frame)

        while True:
            msg = self._thread.try_pop()
            if msg is None:
                break
            if isinstance(msg, bool):
                return self._finish(context, tracker, success=True)
            if isinstance(msg, Exception):
                self.report({"ERROR"}, str(msg))
                return self._finish(context, tracker, success=False)
            if isinstance(msg, pc.OpticalFlowRequest):
                self._provide_frame(context, msg.frame_id)
            elif isinstance(msg, pc.OpticalFlowProgress):
                if transient:
                    transient.progress = msg.progress
                    transient.progress_message = msg.progress_message
                utils.redraw_view3d(context)
        return {"RUNNING_MODAL"}

    def _finish(self, context, tracker, success: bool):
        wm = context.window_manager
        if self._timer is not None:
            wm.event_timer_remove(self._timer)
        self._thread.join()
        if tracker is not None:
            transient = properties.transient_state(tracker)
            transient.is_analyzing = False
            transient.active_thread = None
            transient.progress = 1.0
            transient.progress_message = (
                "Analysis complete" if success else "Analysis failed"
            )
        utils.redraw_view3d(context)
        return {"FINISHED"} if success else {"CANCELLED"}


class PC_OT_CancelAnalysis(bpy.types.Operator):
    bl_idname = "polychase.cancel_analysis"
    bl_label = "Cancel Analysis"
    bl_options = {"REGISTER"}

    @classmethod
    def poll(cls, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker if state else None
        return (
            tracker is not None
            and properties.transient_state(tracker).is_analyzing
        )

    def execute(self, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker
        thread = properties.transient_state(tracker).active_thread
        if thread is not None:
            thread.request_stop()
        return {"FINISHED"}


CLASSES = (PC_OT_AnalyzeVideo, PC_OT_CancelAnalysis)
