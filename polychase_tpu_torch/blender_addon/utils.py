"""Blender math/camera helpers (rebuild of blender_addon/utils.py).

Implements the pixel-space intrinsics math following Blender's
``BKE_camera_params_compute_viewplane`` conventions, and model/view
matrix get/set helpers that strip parent scale
(reference blender_addon/utils.py:50-209).
"""

from __future__ import annotations

import bpy
import mathutils


def poll_is_mesh(_self, obj) -> bool:
    return isinstance(obj, bpy.types.Object) and obj.type == "MESH"


def poll_is_camera(_self, obj) -> bool:
    return isinstance(obj, bpy.types.Object) and obj.type == "CAMERA"


def ndc(region, x, y):
    """Region pixel → normalized device coordinate."""
    return (2.0 * (x / region.width) - 1.0, 2.0 * (y / region.height) - 1.0)


def _sensor_extent(sensor_fit, sensor_width, sensor_height, width, height,
                   ycor):
    if sensor_fit == "HORIZONTAL":
        return sensor_width, width
    if sensor_fit == "VERTICAL":
        return sensor_height, height
    # AUTO: fit the larger viewport dimension
    return sensor_width, (width if width > height else height * ycor)


def calc_camera_params_expanded(
    lens, shift_x, shift_y, sensor_width, sensor_height, sensor_fit,
    width, height, scale_x=1.0, scale_y=1.0,
):
    """Blender camera data → pixel-space (fx, fy, cx, cy)."""
    ycor = scale_y / scale_x
    sensor_size, extent = _sensor_extent(
        sensor_fit, sensor_width, sensor_height, width, height, ycor
    )
    fx = lens * extent / sensor_size
    fy = fx / ycor
    cx = shift_x * extent - width / 2.0
    cy = shift_y * extent - height / 2.0
    return fx, fy, cx, cy


def calc_camera_params(camera, width, height, scale_x=1.0, scale_y=1.0):
    data = camera.data
    return calc_camera_params_expanded(
        data.lens, data.shift_x, data.shift_y,
        data.sensor_width, data.sensor_height, data.sensor_fit,
        width, height, scale_x, scale_y,
    )


def set_camera_params(camera, width, height, fx, fy, cx, cy,
                      scale_x=1.0, scale_y=1.0):
    """Write pixel-space intrinsics back to lens/shift (fx must equal fy)."""
    if abs(fx - fy) > 1e-3 * max(abs(fx), 1.0):
        raise ValueError(f"anamorphic intrinsics not supported: {fx} != {fy}")
    data = camera.data
    ycor = scale_y / scale_x
    sensor_size, extent = _sensor_extent(
        data.sensor_fit, data.sensor_width, data.sensor_height,
        width, height, ycor,
    )
    data.lens = fx * sensor_size / extent
    data.shift_x = (cx + width / 2.0) / extent
    data.shift_y = (cy + height / 2.0) / extent


def calc_camera_proj_mat_pixels(camera, width=1.0, height=1.0):
    fx, fy, cx, cy = calc_camera_params(camera, width, height)
    n = camera.data.clip_start
    f = camera.data.clip_end
    return mathutils.Matrix((
        (fx, 0.0, cx, 0.0),
        (0.0, fy, cy, 0.0),
        (0.0, 0.0, -(f + n) / (f - n), -2.0 * f * n / (f - n)),
        (0.0, 0.0, -1.0, 0.0),
    ))


def calc_camera_params_from_proj(proj):
    return proj[0][0], proj[1][1], proj[0][2], proj[1][2]


def get_rotation_data_path(obj) -> str:
    mode = obj.rotation_mode
    if mode == "QUATERNION":
        return "rotation_quaternion"
    if mode == "AXIS_ANGLE":
        return "rotation_axis_angle"
    return "rotation_euler"


def get_object_model_matrix_loc_rot_scale(obj):
    loc, rot, scale = obj.matrix_world.decompose()
    return loc, rot, scale


def set_object_model_matrix(obj, loc_world, rot_world, scale_world=None):
    """Set world loc/rot, preserving local scale unless given."""
    local_scale = obj.scale.copy()
    obj.matrix_world = mathutils.Matrix.LocRotScale(
        loc_world, rot_world,
        scale_world if scale_world is not None
        else obj.matrix_world.to_scale(),
    )
    if scale_world is None:
        obj.scale = local_scale


def get_camera_view_matrix_loc_rot(camera):
    """World→camera view transform as (loc, rot), scale stripped."""
    loc, rot, _ = camera.matrix_world.decompose()
    rot = rot.inverted()
    loc = -(rot @ loc)
    return loc, rot


def get_camera_view_matrix(camera) -> mathutils.Matrix:
    loc, rot = get_camera_view_matrix_loc_rot(camera)
    return mathutils.Matrix.LocRotScale(
        loc, rot, mathutils.Vector((1.0, 1.0, 1.0))
    )


def set_camera_view_matrix(camera, loc, rot):
    """Inverse of :func:`get_camera_view_matrix_loc_rot`, keeping scale."""
    rot = rot.inverted()
    loc = -(rot @ loc)
    camera.matrix_world = mathutils.Matrix.LocRotScale(
        loc, rot, camera.matrix_world.to_scale()
    )


def clip_size(clip):
    return clip.size[0], clip.size[1]


def redraw_view3d(context):
    for area in context.screen.areas:
        if area.type == "VIEW_3D":
            area.tag_redraw()
