"""N-panel UI (rebuild of blender_addon/ui/panels.py).

The "Polychase" sidebar tab: tracker list, Inputs, Pin Mode, Scene,
Tracking, Optical Flow, Appearance and Camera panels.
"""

from __future__ import annotations

import bpy

from .. import properties


def _tracker(context):
    state = properties.PolychaseState.from_scene(context.scene)
    return state.active_tracker if state else None


class _Panel:
    bl_space_type = "VIEW_3D"
    bl_region_type = "UI"
    bl_category = "Polychase"


class PC_UL_Trackers(bpy.types.UIList):
    def draw_item(self, context, layout, data, item, icon, active_data,
                  active_property, index):
        layout.prop(item, "name", text="", emboss=False, icon="TRACKER")


class PC_PT_Main(_Panel, bpy.types.Panel):
    bl_idname = "PC_PT_main"
    bl_label = "Polychase"

    def draw(self, context):
        layout = self.layout
        state = properties.PolychaseState.from_scene(context.scene)
        row = layout.row()
        row.template_list(
            "PC_UL_Trackers", "", state, "trackers", state,
            "active_tracker_index", rows=2,
        )
        col = row.column(align=True)
        col.operator("polychase.create_tracker", text="", icon="ADD")
        col.operator("polychase.delete_tracker", text="", icon="REMOVE")


class PC_PT_Inputs(_Panel, bpy.types.Panel):
    bl_idname = "PC_PT_inputs"
    bl_parent_id = "PC_PT_main"
    bl_label = "Inputs"

    @classmethod
    def poll(cls, context):
        return _tracker(context) is not None

    def draw(self, context):
        layout = self.layout
        tracker = _tracker(context)
        layout.prop(tracker, "clip")
        layout.operator("polychase.open_clip", icon="FILEBROWSER")
        layout.prop(tracker, "geometry")
        layout.prop(tracker, "camera")
        layout.prop(tracker, "tracking_target", expand=True)


class PC_PT_PinMode(_Panel, bpy.types.Panel):
    bl_idname = "PC_PT_pinmode"
    bl_parent_id = "PC_PT_main"
    bl_label = "Pin Mode"

    @classmethod
    def poll(cls, context):
        return _tracker(context) is not None

    def draw(self, context):
        layout = self.layout
        tracker = _tracker(context)
        transient = properties.transient_state(tracker)
        if transient.in_pinmode:
            layout.label(text="Pin mode active (ESC to exit)", icon="INFO")
        else:
            layout.operator("polychase.pin_mode", icon="PIVOT_CURSOR")
        row = layout.row(align=True)
        row.operator("polychase.clear_pins")
        row.operator("polychase.clear_mask")
        layout.prop(tracker, "mask_brush_radius")


class PC_PT_Scene(_Panel, bpy.types.Panel):
    bl_idname = "PC_PT_scene"
    bl_parent_id = "PC_PT_main"
    bl_label = "Scene"

    @classmethod
    def poll(cls, context):
        return _tracker(context) is not None

    def draw(self, context):
        layout = self.layout
        layout.operator("polychase.center_geometry", icon="OBJECT_ORIGIN")
        layout.operator("polychase.convert_animation", icon="FILE_REFRESH")
        layout.operator("polychase.transform_scene", icon="ORIENTATION_GLOBAL")
        layout.operator("polychase.refresh_geometry", icon="MESH_DATA")


class PC_PT_Tracking(_Panel, bpy.types.Panel):
    bl_idname = "PC_PT_tracking"
    bl_parent_id = "PC_PT_main"
    bl_label = "Tracking"

    @classmethod
    def poll(cls, context):
        return _tracker(context) is not None

    def draw(self, context):
        layout = self.layout
        tracker = _tracker(context)
        transient = properties.transient_state(tracker)

        row = layout.row(align=True)
        op = row.operator(
            "polychase.track_sequence", text="", icon="TRACKING_BACKWARDS"
        )
        op.backward, op.single_frame = True, False
        op = row.operator(
            "polychase.track_sequence", text="",
            icon="TRACKING_BACKWARDS_SINGLE",
        )
        op.backward, op.single_frame = True, True
        op = row.operator(
            "polychase.track_sequence", text="",
            icon="TRACKING_FORWARDS_SINGLE",
        )
        op.backward, op.single_frame = False, True
        op = row.operator(
            "polychase.track_sequence", text="", icon="TRACKING_FORWARDS"
        )
        op.backward, op.single_frame = False, False

        row = layout.row(align=True)
        row.operator("polychase.refine_sequence", text="Refine")
        row.operator("polychase.refine_all_segments", text="Refine All")

        # Keyframe toolbar
        row = layout.row(align=True)
        row.operator("polychase.prev_keyframe", text="", icon="PREV_KEYFRAME")
        row.operator("polychase.add_keyframe", text="", icon="KEY_HLT")
        row.operator("polychase.remove_keyframe", text="", icon="KEY_DEHLT")
        row.operator("polychase.next_keyframe", text="", icon="NEXT_KEYFRAME")

        row = layout.row(align=True)
        row.operator("polychase.clear_backwards", text="Clear ←")
        row.operator("polychase.clear_segment", text="Clear Segment")
        row.operator("polychase.clear_forwards", text="Clear →")
        layout.operator("polychase.clear_all_generated")

        if transient.busy:
            box = layout.box()
            box.label(text=transient.progress_message or "Working...")
            box.progress(
                factor=transient.progress,
                type="BAR",
                text=f"{transient.progress * 100:.0f}%",
            )
            if transient.is_tracking:
                box.operator("polychase.cancel_tracking", icon="X")
            if transient.is_refining:
                box.operator("polychase.cancel_refine", icon="X")


class PC_PT_OpticalFlow(_Panel, bpy.types.Panel):
    bl_idname = "PC_PT_opticalflow"
    bl_parent_id = "PC_PT_main"
    bl_label = "Optical Flow"

    @classmethod
    def poll(cls, context):
        return _tracker(context) is not None

    def draw(self, context):
        layout = self.layout
        tracker = _tracker(context)
        transient = properties.transient_state(tracker)
        layout.prop(tracker, "database_path")
        if transient.is_analyzing:
            box = layout.box()
            box.label(text=transient.progress_message or "Analyzing...")
            box.progress(
                factor=transient.progress, type="BAR",
                text=f"{transient.progress * 100:.0f}%",
            )
            box.operator("polychase.cancel_analysis", icon="X")
        else:
            layout.operator("polychase.analyze_video", icon="SEQ_HISTOGRAM")


class PC_PT_Appearance(_Panel, bpy.types.Panel):
    bl_idname = "PC_PT_appearance"
    bl_parent_id = "PC_PT_main"
    bl_label = "Appearance"
    bl_options = {"DEFAULT_CLOSED"}

    @classmethod
    def poll(cls, context):
        return _tracker(context) is not None

    def draw(self, context):
        layout = self.layout
        tracker = _tracker(context)
        layout.prop(tracker, "pin_color")
        layout.prop(tracker, "selected_pin_color")
        layout.prop(tracker, "wireframe_color")
        layout.prop(tracker, "masked_color")
        layout.prop(tracker, "pin_radius")


class PC_PT_Camera(_Panel, bpy.types.Panel):
    bl_idname = "PC_PT_camera"
    bl_parent_id = "PC_PT_main"
    bl_label = "Camera"
    bl_options = {"DEFAULT_CLOSED"}

    @classmethod
    def poll(cls, context):
        tracker = _tracker(context)
        return tracker is not None and tracker.camera is not None

    def draw(self, context):
        layout = self.layout
        tracker = _tracker(context)
        cam_data = tracker.camera.data
        layout.prop(cam_data, "sensor_fit")
        layout.prop(cam_data, "sensor_width")
        layout.prop(cam_data, "lens")
        layout.prop(cam_data, "shift_x")
        layout.prop(cam_data, "shift_y")
        layout.separator()
        layout.prop(tracker, "optimize_focal_length")
        layout.prop(tracker, "optimize_principal_point")


CLASSES = (
    PC_UL_Trackers,
    PC_PT_Main,
    PC_PT_Inputs,
    PC_PT_PinMode,
    PC_PT_Scene,
    PC_PT_Tracking,
    PC_PT_OpticalFlow,
    PC_PT_Appearance,
    PC_PT_Camera,
)
