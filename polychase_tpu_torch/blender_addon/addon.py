"""Add-on registration (rebuild of blender_addon/addon.py)."""

from __future__ import annotations

import bpy

from . import properties
from .operators import (
    analysis,
    keyframe_management,
    scene_operations,
    tracker_management,
    tracking,
    refiner,
)
from .operators.pin_mode import pin_mode
from .ui import panels

_OPERATOR_CLASSES = (
    analysis.CLASSES
    + tracking.CLASSES
    + refiner.CLASSES
    + pin_mode.CLASSES
    + scene_operations.CLASSES
    + keyframe_management.CLASSES
    + tracker_management.CLASSES
)


def register():
    properties.register()
    for cls in _OPERATOR_CLASSES:
        bpy.utils.register_class(cls)
    for cls in panels.CLASSES:
        bpy.utils.register_class(cls)


def unregister():
    for cls in reversed(panels.CLASSES):
        bpy.utils.unregister_class(cls)
    for cls in reversed(_OPERATOR_CLASSES):
        bpy.utils.unregister_class(cls)
    properties.unregister()
