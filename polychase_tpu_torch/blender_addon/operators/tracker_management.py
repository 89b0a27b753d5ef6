"""Tracker create/select/delete + clip open + geometry refresh operators
(rebuild of blender_addon/operators/{tracker_management,open_clip,
refresh_geometry}.py)."""

from __future__ import annotations

import bpy

from .. import core, properties


class PC_OT_CreateTracker(bpy.types.Operator):
    bl_idname = "polychase.create_tracker"
    bl_label = "Create Tracker"
    bl_options = {"REGISTER", "UNDO"}

    def execute(self, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.trackers.add()
        tracker.id = state.next_tracker_id
        tracker.name = f"Tracker {state.next_tracker_id}"
        state.next_tracker_id += 1
        state.active_tracker_index = len(state.trackers) - 1
        # Default to the scene camera if present
        if context.scene.camera:
            tracker.camera = context.scene.camera
        return {"FINISHED"}


class PC_OT_DeleteTracker(bpy.types.Operator):
    bl_idname = "polychase.delete_tracker"
    bl_label = "Delete Tracker"
    bl_options = {"REGISTER", "UNDO"}

    @classmethod
    def poll(cls, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker if state else None
        return tracker is not None and not properties.transient_state(
            tracker
        ).busy

    def execute(self, context):
        state = properties.PolychaseState.from_scene(context.scene)
        idx = state.active_tracker_index
        tracker = state.trackers[idx]
        core.Trackers.invalidate(tracker.id)
        properties.clear_transient_state(tracker.id)
        state.trackers.remove(idx)
        state.active_tracker_index = min(idx, len(state.trackers) - 1)
        return {"FINISHED"}


class PC_OT_OpenClip(bpy.types.Operator):
    bl_idname = "polychase.open_clip"
    bl_label = "Open Clip"
    bl_description = "Open a movie clip and assign it to the tracker"
    bl_options = {"REGISTER", "UNDO"}

    filepath: bpy.props.StringProperty(subtype="FILE_PATH")
    files: bpy.props.CollectionProperty(
        type=bpy.types.OperatorFileListElement
    )
    directory: bpy.props.StringProperty(subtype="DIR_PATH")

    @classmethod
    def poll(cls, context):
        state = properties.PolychaseState.from_scene(context.scene)
        return state is not None and state.active_tracker is not None

    def invoke(self, context, event):
        context.window_manager.fileselect_add(self)
        return {"RUNNING_MODAL"}

    def execute(self, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker
        try:
            clip = bpy.data.movieclips.load(self.filepath)
        except RuntimeError as exc:
            self.report({"ERROR"}, f"Cannot open clip: {exc}")
            return {"CANCELLED"}
        tracker.clip = clip
        return {"FINISHED"}


class PC_OT_RefreshGeometry(bpy.types.Operator):
    bl_idname = "polychase.refresh_geometry"
    bl_label = "Refresh Geometry"
    bl_description = "Rebuild the accelerated mesh after geometry edits"
    bl_options = {"REGISTER"}

    @classmethod
    def poll(cls, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker if state else None
        return (
            tracker is not None
            and tracker.geometry is not None
            and not properties.transient_state(tracker).busy
        )

    def execute(self, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker
        core.Trackers.invalidate(tracker.id)
        core.Trackers.get(tracker)  # rebuild now
        return {"FINISHED"}


CLASSES = (
    PC_OT_CreateTracker,
    PC_OT_DeleteTracker,
    PC_OT_OpenClip,
    PC_OT_RefreshGeometry,
)
