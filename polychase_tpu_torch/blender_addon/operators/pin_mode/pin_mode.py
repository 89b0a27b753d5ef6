"""Pin-mode modal operator
(rebuild of blender_addon/operators/pin_mode/pin_mode.py).

Long-lived modal session: LMB picks or creates pins (ray-cast onto the
mesh), dragging a pin re-solves the pose every MOUSEMOVE through
``find_transformation``, release inserts a user keyframe, RMB deletes a
pin, ``M`` toggles 3D mask painting, ESC exits.
"""

from __future__ import annotations

import bpy
import mathutils
import numpy as np

from .... import polychase_core as pc
from ... import core, keyframes, properties, utils
from .masking_3d import Masking3DSelector
from .rendering import PinModeRenderer


def region_under_mouse(context, event):
    for area in context.screen.areas:
        if area.type != "VIEW_3D":
            continue
        for region in area.regions:
            if region.type == "WINDOW":
                x = event.mouse_x - region.x
                y = event.mouse_y - region.y
                if 0 <= x < region.width and 0 <= y < region.height:
                    return region, area.spaces.active.region_3d, x, y
    return None, None, 0, 0


class PC_OT_PinMode(bpy.types.Operator):
    bl_idname = "polychase.pin_mode"
    bl_label = "Pin Mode"
    bl_description = "Place pins and drag them to pose the model or camera"
    bl_options = {"REGISTER", "UNDO"}

    _renderer = None
    _masker = None
    _dragging = False
    _drag_pin = -1
    _initial_scene = None
    _masking = False
    _mask_value = True
    _tracker_id = -1

    @classmethod
    def poll(cls, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker if state else None
        return (
            tracker is not None
            and tracker.geometry is not None
            and tracker.camera is not None
            and not properties.transient_state(tracker).busy
            and not properties.transient_state(tracker).in_pinmode
        )

    # -- scene transform plumbing ------------------------------------------

    def _scene_transform(self, tracker, context) -> pc.SceneTransformations:
        # Pin mode passes the RAW model matrix (scale included) — unlike
        # tracking, find_transformation recomposes full matrices, so no
        # scale folding here (reference pin_mode.py:55-67).
        clip = tracker.clip
        width, height = (
            utils.clip_size(clip) if clip else (1920, 1080)
        )
        return pc.SceneTransformations(
            model_matrix=np.array(tracker.geometry.matrix_world, np.float32),
            view_matrix=np.array(
                utils.get_camera_view_matrix(tracker.camera), np.float32
            ),
            intrinsics=core.camera_intrinsics(tracker.camera, width, height),
        )

    def _apply_scene_transform(self, tracker, scene: pc.SceneTransformations,
                               trans_type) -> None:
        """Write a solved transform back to the Blender objects
        (reference pin_mode.py:73-99)."""
        if trans_type == pc.TransformationType.Model:
            model = mathutils.Matrix(
                np.asarray(scene.model_matrix, np.float64).tolist()
            )
            loc, rot, scale = model.decompose()
            utils.set_object_model_matrix(
                tracker.geometry, loc, rot, scale
            )
        else:
            view = mathutils.Matrix(
                np.asarray(scene.view_matrix, np.float64).tolist()
            )
            loc, rot, _ = view.decompose()
            utils.set_camera_view_matrix(tracker.camera, loc, rot)
        if tracker.optimize_focal_length or tracker.optimize_principal_point:
            core.set_camera_intrinsics(tracker.camera, scene.intrinsics)

    # -- lifecycle ----------------------------------------------------------

    def invoke(self, context, event):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker
        engine_tracker = core.Trackers.get(tracker)
        if engine_tracker is None or engine_tracker.accel_mesh is None:
            self.report({"ERROR"}, "Tracker needs geometry")
            return {"CANCELLED"}

        self._tracker_id = tracker.id

        # Enter the camera view (reference pin_mode.py:208-253)
        if context.scene.camera != tracker.camera:
            context.scene.camera = tracker.camera
        for area in context.screen.areas:
            if area.type == "VIEW_3D":
                rv3d = area.spaces.active.region_3d
                if rv3d.view_perspective != "CAMERA":
                    rv3d.view_perspective = "CAMERA"
                break

        self._renderer = PinModeRenderer(tracker, engine_tracker)
        self._renderer.update_pins(engine_tracker.pins.points)
        self._renderer.install(tracker)
        self._masker = Masking3DSelector()

        transient = properties.transient_state(tracker)
        transient.in_pinmode = True

        context.window_manager.modal_handler_add(self)
        utils.redraw_view3d(context)
        return {"RUNNING_MODAL"}

    def _exit(self, context, tracker):
        if self._renderer is not None:
            self._renderer.uninstall()
            self._renderer = None
        if self._masker is not None:
            self._masker.free()
            self._masker = None
        if tracker is not None:
            properties.transient_state(tracker).in_pinmode = False
        utils.redraw_view3d(context)
        return {"FINISHED"}

    # -- pin picking --------------------------------------------------------

    def _project_pins(self, tracker, engine_tracker, region, rv3d):
        """Pin object-space points → region pixels."""
        pts = engine_tracker.pins.points
        if len(pts) == 0:
            return np.empty((0, 2), np.float32)
        model = np.asarray(tracker.geometry.matrix_world, np.float64)
        persp = np.asarray(rv3d.perspective_matrix, np.float64)
        hom = np.concatenate(
            [pts, np.ones((len(pts), 1), np.float32)], axis=1
        ) @ (persp @ model).T
        ndc = hom[:, :2] / hom[:, 3:4]
        px = np.stack(
            [
                (ndc[:, 0] * 0.5 + 0.5) * region.width,
                (ndc[:, 1] * 0.5 + 0.5) * region.height,
            ],
            axis=-1,
        )
        return px.astype(np.float32)

    def _pick_pin(self, tracker, engine_tracker, region, rv3d, x, y):
        px = self._project_pins(tracker, engine_tracker, region, rv3d)
        if len(px) == 0:
            return -1
        d = np.linalg.norm(px - np.array([x, y]), axis=-1)
        best = int(np.argmin(d))
        if d[best] <= max(tracker.pin_radius * 1.5, 10.0):
            return best
        return -1

    # -- modal --------------------------------------------------------------

    def modal(self, context, event):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = None
        for t in state.trackers:
            if t.id == self._tracker_id:
                tracker = t
        if tracker is None:
            return self._exit(context, None)
        engine_tracker = core.Trackers.get(tracker)
        if engine_tracker is None:
            return self._exit(context, tracker)

        if event.type == "ESC" and event.value == "PRESS":
            return self._exit(context, tracker)

        if event.type == "M" and event.value == "PRESS":
            self._masking = not self._masking
            self._renderer.set_mask_circle(None)
            utils.redraw_view3d(context)
            return {"RUNNING_MODAL"}

        region, rv3d, x, y = region_under_mouse(context, event)
        if region is None:
            return {"PASS_THROUGH"}

        if self._masking:
            return self._modal_masking(
                context, event, tracker, engine_tracker, region, rv3d, x, y
            )
        return self._modal_pins(
            context, event, tracker, engine_tracker, region, rv3d, x, y
        )

    def _modal_pins(self, context, event, tracker, engine_tracker, region,
                    rv3d, x, y):
        trans_type = (
            pc.TransformationType.Camera
            if tracker.tracking_target == "CAMERA"
            else pc.TransformationType.Model
        )

        if event.type == "LEFTMOUSE" and event.value == "PRESS":
            pin = self._pick_pin(tracker, engine_tracker, region, rv3d, x, y)
            if pin < 0:
                hit = engine_tracker.ray_cast(
                    tracker, context, region, rv3d, x, y, check_mask=True
                )
                if hit is None:
                    return {"RUNNING_MODAL"}
                pin = engine_tracker.pins.add_pin(tracker, hit.pos)
            tracker.selected_pin = pin
            self._dragging = True
            self._drag_pin = pin
            self._initial_scene = self._scene_transform(tracker, context)
            self._renderer.update_pins(engine_tracker.pins.points)
            utils.redraw_view3d(context)
            return {"RUNNING_MODAL"}

        if event.type == "MOUSEMOVE" and self._dragging:
            if self._drag_pin >= engine_tracker.pins.count:
                self._dragging = False
                return {"RUNNING_MODAL"}
            current_scene = self._scene_transform(tracker, context)
            clip = tracker.clip
            width, height = (
                utils.clip_size(clip) if clip else (region.width,
                                                    region.height)
            )
            # Region pixel → clip pixel
            px = np.array(
                [x / region.width * width, y / region.height * height],
                np.float32,
            )
            out = pc.find_transformation(
                engine_tracker.pins.points,
                self._initial_scene,
                current_scene,
                pc.PinUpdate(self._drag_pin, px),
                trans_type,
                tracker.optimize_focal_length,
                tracker.optimize_principal_point,
                device=core.DEVICE,
            )
            self._apply_scene_transform(tracker, out, trans_type)
            utils.redraw_view3d(context)
            return {"RUNNING_MODAL"}

        if event.type == "LEFTMOUSE" and event.value == "RELEASE":
            if self._dragging:
                self._dragging = False
                # Insert a user anchor keyframe (reference
                # pin_mode.py:101-128)
                target = (
                    tracker.camera
                    if tracker.tracking_target == "CAMERA"
                    else tracker.geometry
                )
                keyframes.insert_keyframe(
                    target, context.scene.frame_current,
                    keytype=keyframes.USER_KEYFRAME,
                )
                bpy.ops.ed.undo_push(message="Polychase pin drag")
            return {"RUNNING_MODAL"}

        if event.type == "RIGHTMOUSE" and event.value == "PRESS":
            pin = self._pick_pin(tracker, engine_tracker, region, rv3d, x, y)
            if pin >= 0:
                engine_tracker.pins.remove_pin(tracker, pin)
                if tracker.selected_pin == pin:
                    tracker.selected_pin = -1
                elif tracker.selected_pin > pin:
                    tracker.selected_pin -= 1
                self._renderer.update_pins(engine_tracker.pins.points)
                bpy.ops.ed.undo_push(message="Polychase delete pin")
                utils.redraw_view3d(context)
            return {"RUNNING_MODAL"}

        return {"PASS_THROUGH"}

    def _modal_masking(self, context, event, tracker, engine_tracker, region,
                       rv3d, x, y):
        radius = tracker.mask_brush_radius
        self._renderer.set_mask_circle((x, y, radius))

        if event.type == "WHEELUPMOUSE":
            tracker.mask_brush_radius = min(radius + 2, 200)
            return {"RUNNING_MODAL"}
        if event.type == "WHEELDOWNMOUSE":
            tracker.mask_brush_radius = max(radius - 2, 1)
            return {"RUNNING_MODAL"}

        paint = (
            event.type in ("LEFTMOUSE", "MOUSEMOVE")
            and (event.type == "LEFTMOUSE" or self._dragging)
        )
        if event.type == "LEFTMOUSE":
            if event.value == "PRESS":
                self._dragging = True
                self._mask_value = not event.ctrl  # Ctrl = unmask
                self._masker.render_ids(engine_tracker, tracker, region, rv3d)
            elif event.value == "RELEASE":
                self._dragging = False
                bpy.ops.ed.undo_push(message="Polychase mask paint")
                return {"RUNNING_MODAL"}

        if paint and self._dragging:
            tris = self._masker.triangles_under_brush(x, y, radius)
            polys = {
                engine_tracker.polygon_of_triangle(int(t)) for t in tris
            }
            for poly in polys:
                engine_tracker.mask_polygon(
                    tracker, poly, mask=self._mask_value
                )
            if polys:
                self._renderer.update_mask(
                    engine_tracker.accel_mesh.inner()
                )
        utils.redraw_view3d(context)
        return {"RUNNING_MODAL"}


class PC_OT_ClearPins(bpy.types.Operator):
    bl_idname = "polychase.clear_pins"
    bl_label = "Clear Pins"
    bl_options = {"REGISTER", "UNDO"}

    @classmethod
    def poll(cls, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker if state else None
        return tracker is not None and len(bytes(tracker.pins_data)) > 0

    def execute(self, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker
        tracker.pins_data = b""
        tracker.pins_version += 1
        tracker.selected_pin = -1
        return {"FINISHED"}


class PC_OT_ClearMask(bpy.types.Operator):
    bl_idname = "polychase.clear_mask"
    bl_label = "Clear 3D Mask"
    bl_options = {"REGISTER", "UNDO"}

    @classmethod
    def poll(cls, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker if state else None
        return tracker is not None and len(
            bytes(tracker.masked_triangles)
        ) > 0

    def execute(self, context):
        state = properties.PolychaseState.from_scene(context.scene)
        tracker = state.active_tracker
        tracker.masked_triangles = b""
        core.Trackers.invalidate(tracker.id)
        return {"FINISHED"}


CLASSES = (PC_OT_PinMode, PC_OT_ClearPins, PC_OT_ClearMask)
