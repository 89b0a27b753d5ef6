"""Polychase (PyTorch + CUDA) — Blender add-on for 3D camera/object
match-moving.

A copy of ``polychase_tpu.blender_addon``, module by module, on top of
the PyTorch + CUDA port's ``polychase_core`` (``polychase_tpu_torch``).
It is a drop-in for the JAX package's add-on: enable one of the two in a
Blender, never both, since both register the same ``polychase.*``
operators and properties.  The engine runs on the CUDA card
(``core.DEVICE``).  Register via Blender's add-on mechanism; requires
Blender ≥ 4.2 and torch with CUDA in Blender's Python.
"""

bl_info = {
    "name": "Polychase (PyTorch + CUDA)",
    "author": "polychase_tpu contributors",
    "description": "Camera and object match-moving (PyTorch + CUDA core)",
    "blender": (4, 2, 0),
    "version": (0, 1, 0),
    "category": "Tracking",
}


def register():
    from . import addon

    addon.register()


def unregister():
    from . import addon

    addon.unregister()
