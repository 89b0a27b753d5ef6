"""F-curve keyframe layer (rebuild of blender_addon/keyframes.py).

Typed keyframes distinguish user anchors (``KEYFRAME``) from tracker
output (``GENERATED``); helpers insert/remove/search keyframes on an
object's loc/rot (and optionally the camera's lens/shift) f-curves,
handling Blender 4.4 slotted actions.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import bpy

from . import utils

USER_KEYFRAME = "KEYFRAME"
GENERATED_KEYFRAME = "GENERATED"

_TRANSFORM_PATHS = (
    "location",
    "rotation_quaternion",
    "rotation_euler",
    "rotation_axis_angle",
)
_LENS_PATHS = ("lens", "shift_x", "shift_y")


def _action_channelbag(anim_data, create: bool = False):
    """Resolve the channelbag holding the f-curves (4.4 slotted actions)."""
    action = anim_data.action if anim_data else None
    if action is None:
        return None
    # Blender ≥ 4.4: layered actions with slots
    if hasattr(action, "layers") and action.layers:
        slot = anim_data.action_slot
        if slot is None:
            return None
        for layer in action.layers:
            for strip in layer.strips:
                bag = strip.channelbag(slot)
                if bag is not None:
                    return bag
        return None
    return action


def _fcurves(obj_or_data, paths: Iterable[str], create: bool = False):
    """All existing f-curves of the given data paths."""
    anim = obj_or_data.animation_data
    if anim is None:
        if not create:
            return []
        anim = obj_or_data.animation_data_create()
    container = _action_channelbag(anim)
    if container is None:
        return []
    curves = []
    for fc in container.fcurves:
        if fc.data_path in paths:
            curves.append(fc)
    return curves


def object_transform_fcurves(obj, create: bool = False):
    return _fcurves(obj, _TRANSFORM_PATHS, create)


def camera_lens_fcurves(camera, create: bool = False):
    return _fcurves(camera.data, _LENS_PATHS, create)


def tracker_fcurves(tracker, include_lens: bool = True):
    """All f-curves the tracker writes for its current target."""
    obj = (
        tracker.camera
        if tracker.tracking_target == "CAMERA" else tracker.geometry
    )
    curves = list(object_transform_fcurves(obj)) if obj else []
    if (
        include_lens
        and tracker.camera
        and (tracker.optimize_focal_length or tracker.optimize_principal_point)
    ):
        curves += camera_lens_fcurves(tracker.camera)
    return curves


# ---------------------------------------------------------------------------
# Insertion / typing
# ---------------------------------------------------------------------------


def insert_keyframe(obj, frame: int, keytype: str = GENERATED_KEYFRAME,
                    paths: Optional[Iterable[str]] = None) -> None:
    """Keyframe the object's transform at ``frame`` with the given type."""
    if paths is None:
        paths = ("location", utils.get_rotation_data_path(obj))
    for path in paths:
        obj.keyframe_insert(data_path=path, frame=frame, keytype=keytype)


def insert_camera_lens_keyframe(camera, frame: int,
                                keytype: str = GENERATED_KEYFRAME) -> None:
    for path in _LENS_PATHS:
        camera.data.keyframe_insert(
            data_path=path, frame=frame, keytype=keytype
        )


def set_keyframe_type(obj, frame: int, keytype: str) -> None:
    for fc in object_transform_fcurves(obj):
        for kp in fc.keyframe_points:
            if abs(kp.co[0] - frame) < 0.5:
                kp.type = keytype


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------


def keyframes_of_type(fcurves, keytype: Optional[str] = None) -> set:
    frames = set()
    for fc in fcurves:
        for kp in fc.keyframe_points:
            if keytype is None or kp.type == keytype:
                frames.add(int(round(kp.co[0])))
    return frames


def find_prev_keyframe(fcurves, frame: int,
                       keytype: Optional[str] = None) -> Optional[int]:
    frames = [f for f in keyframes_of_type(fcurves, keytype) if f < frame]
    return max(frames) if frames else None


def find_next_keyframe(fcurves, frame: int,
                       keytype: Optional[str] = None) -> Optional[int]:
    frames = [f for f in keyframes_of_type(fcurves, keytype) if f > frame]
    return min(frames) if frames else None


def find_last_keyframe(fcurves, keytype: Optional[str] = None) -> Optional[int]:
    frames = keyframes_of_type(fcurves, keytype)
    return max(frames) if frames else None


def has_keyframe_at(fcurves, frame: int,
                    keytype: Optional[str] = None) -> bool:
    return frame in keyframes_of_type(fcurves, keytype)


# ---------------------------------------------------------------------------
# Removal
# ---------------------------------------------------------------------------


def clear_keyframes(
    fcurves,
    predicate: Callable[[int, str], bool],
) -> int:
    """Remove keyframe points where ``predicate(frame, keytype)``.

    Returns the number of removed points.
    """
    removed = 0
    for fc in fcurves:
        doomed = [
            kp for kp in fc.keyframe_points
            if predicate(int(round(kp.co[0])), kp.type)
        ]
        for kp in reversed(doomed):
            try:
                fc.keyframe_points.remove(kp, fast=True)
                removed += 1
            except RuntimeError:
                pass
        if doomed:
            fc.update()
    return removed


def prune_empty_fcurves(*objs_or_data) -> None:
    """Drop f-curves left without keyframe points, and the action itself
    once it is empty.

    In Blender an f-curve with zero points evaluates to 0.0, so leaving
    emptied curves behind would snap the channel to the origin on the
    next frame change (reference keyframes.py:92-96 removes them for
    the same reason).
    """
    for obj in objs_or_data:
        if obj is None:
            continue
        anim = getattr(obj, "animation_data", None)
        if anim is None:
            continue
        container = _action_channelbag(anim)
        if container is None:
            continue
        for fc in [f for f in container.fcurves if not f.keyframe_points]:
            container.fcurves.remove(fc)
        if not container.fcurves:
            anim.action = None


def clear_generated_in_range(fcurves, start: int, end: int) -> int:
    """Remove GENERATED keyframes with start <= frame <= end."""
    return clear_keyframes(
        fcurves,
        lambda f, t: t == GENERATED_KEYFRAME and start <= f <= end,
    )


def clear_all_generated(fcurves) -> int:
    return clear_keyframes(fcurves, lambda f, t: t == GENERATED_KEYFRAME)
