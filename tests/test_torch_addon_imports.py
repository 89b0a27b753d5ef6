"""The port's add-on copy imports and registers under a stubbed bpy, and
is a drop-in for the JAX add-on: a counterpart of every module at the same
relative path, the same operator ``bl_idname``s and the same 9 panel
classes, its own manifest id and ``bl_info`` name
(tests/test_addon_imports.py's checks, held against the JAX add-on)."""

import importlib
import pathlib
import sys
import tomllib
from unittest import mock

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
COPY = REPO / "polychase_tpu_torch" / "blender_addon"
JAX_ADDON = REPO / "polychase_tpu" / "blender_addon"

BPY_MODULES = [
    "bpy", "bpy.types", "bpy.props", "bpy.utils", "bpy.path",
    "mathutils", "gpu", "gpu.types", "gpu.state", "gpu.shader",
    "gpu_extras", "gpu_extras.batch",
]
PACKAGES = ("polychase_tpu_torch.blender_addon", "polychase_tpu.blender_addon")


def module_names(root, package):
    """Every module of an add-on package, from its files."""
    names = []
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(root).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join((package,) + parts))
    return names


def _pop_addons():
    for name in list(sys.modules):
        if any(name == p or name.startswith(p + ".") for p in PACKAGES):
            sys.modules.pop(name)


@pytest.fixture
def stub_bpy():
    saved = {name: sys.modules.get(name) for name in BPY_MODULES}
    bpy = mock.MagicMock(name="bpy")
    bpy.types.PropertyGroup = type("FakePropertyGroup", (), {})
    bpy.types.Operator = type("FakeOperator", (), {})
    bpy.types.Panel = type("FakePanel", (), {})
    bpy.types.UIList = type("FakeUIList", (), {})
    for name in BPY_MODULES:
        sys.modules[name] = mock.MagicMock(name=name)
    sys.modules["bpy"] = bpy
    sys.modules["bpy.types"] = bpy.types
    sys.modules["bpy.props"] = bpy.props
    _pop_addons()
    yield bpy
    for name, module in saved.items():
        if module is None:
            sys.modules.pop(name, None)
        else:
            sys.modules[name] = module
    _pop_addons()


def test_every_module_has_its_counterpart():
    theirs = {p.relative_to(JAX_ADDON) for p in JAX_ADDON.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    ours = {p.relative_to(COPY) for p in COPY.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}
    assert theirs == ours


def test_copy_modules_import(stub_bpy):
    names = module_names(COPY, PACKAGES[0])
    assert len(names) == 20
    for name in names:
        module = importlib.import_module(name)
        assert module.__file__.startswith(str(COPY)), name


def test_operator_tables_equal_the_jax_addons(stub_bpy):
    tables = []
    for package in PACKAGES:
        addon = importlib.import_module(f"{package}.addon")
        ids = [cls.bl_idname for cls in addon._OPERATOR_CLASSES]
        assert all(i.startswith("polychase.") for i in ids)
        assert len(ids) == len(set(ids)) >= 20
        tables.append(ids)
    assert tables[0] == tables[1]


def test_panel_tables_equal_the_jax_addons(stub_bpy):
    tables = []
    for package in PACKAGES:
        panels = importlib.import_module(f"{package}.ui.panels")
        assert len(panels.CLASSES) == 9  # UIList + 8 panels
        tables.append([(cls.__name__, getattr(cls, "bl_idname", None))
                       for cls in panels.CLASSES])
    assert tables[0] == tables[1]


def test_register_and_unregister(stub_bpy):
    addon = importlib.import_module(f"{PACKAGES[0]}.addon")
    panels = importlib.import_module(f"{PACKAGES[0]}.ui.panels")
    copy = importlib.import_module(PACKAGES[0])
    copy.register()
    registered = [c.args[0]
                  for c in stub_bpy.utils.register_class.call_args_list]
    assert registered[-len(panels.CLASSES):] == list(panels.CLASSES)
    assert set(addon._OPERATOR_CLASSES) <= set(registered)
    copy.unregister()
    unregistered = [c.args[0]
                    for c in stub_bpy.utils.unregister_class.call_args_list]
    assert sorted(map(id, unregistered)) == sorted(map(id, registered))


def test_own_manifest_and_bl_info():
    ours = tomllib.loads((COPY / "blender_manifest.toml").read_text())
    theirs = tomllib.loads((JAX_ADDON / "blender_manifest.toml").read_text())
    assert ours["id"] == "polychase_tpu_torch" != theirs["id"]
    assert ours["name"] != theirs["name"]
    assert "TPU" not in ours["name"] + ours["tagline"]
    assert ours["blender_version_min"] == theirs["blender_version_min"]
    copy = importlib.import_module(PACKAGES[0])
    assert copy.bl_info["name"] == ours["name"]
    assert "TPU" not in copy.bl_info["description"]
