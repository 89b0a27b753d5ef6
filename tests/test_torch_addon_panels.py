"""The UI panels of the port's add-on copy, executed against the fake
scene with tests/test_addon_panels.py's validating layout (each ``prop()``
names an existing attribute, each ``operator()`` a registered operator) in
the idle, busy and pin-mode states, and held to the JAX add-on's panels:
the same draw log in each state."""

import importlib
from types import SimpleNamespace

import pytest

from test_torch_addon_modal import (  # noqa: F401  (fixtures)
    ADDON,
    addon_modules,
    env,
    rendered,
)


class _OpProps(SimpleNamespace):
    """Returned by layout.operator(): accepts arbitrary prop writes."""


class FakeLayout:
    """Validating bpy.types.UILayout stand-in."""

    def __init__(self, registered_ops, log):
        self._ops = registered_ops
        self.log = log
        self.use_property_split = False

    # containers all hand back the same validating layout
    def row(self, **kw):
        return self

    def column(self, **kw):
        return self

    def box(self):
        self.log.append(("box",))
        return self

    def split(self, **kw):
        return self

    def prop(self, obj, name, **kw):
        assert obj is not None, name
        assert hasattr(obj, name), f"prop references missing field {name!r}"
        self.log.append(("prop", type(obj).__name__, name))

    def operator(self, idname, **kw):
        assert idname in self._ops, f"unregistered operator {idname!r}"
        self.log.append(("operator", idname))
        return _OpProps()

    def label(self, text="", **kw):
        self.log.append(("label", text))

    def progress(self, factor=0.0, type="BAR", text=""):
        assert 0.0 <= factor <= 1.0
        self.log.append(("progress", factor))

    def template_list(self, list_id, _list_uid, data, propname,
                      active_data, active_propname, **kw):
        assert hasattr(data, propname), propname
        assert hasattr(active_data, active_propname), active_propname
        self.log.append(("template_list", list_id))

    def separator(self):
        self.log.append(("separator",))


def _registered_ops(env, package=ADDON):
    addon = importlib.import_module(f"{package}.addon")
    return {
        cls.bl_idname
        for cls in addon._OPERATOR_CLASSES
        if hasattr(cls, "bl_idname")
    }


def _draw_all(env, panels, ops):
    drawn = []
    for cls in panels.CLASSES:
        if not hasattr(cls, "draw"):  # the UIList
            continue
        poll = getattr(cls, "poll", None)
        if poll is not None and not poll(env.ctx):
            continue
        inst = cls.__new__(cls)
        inst.layout = FakeLayout(ops, [])
        inst.draw(env.ctx)
        drawn.append((cls.__name__, inst.layout.log))
    return dict(drawn)


class TestPanels:
    def test_idle_state_draws_everything(self, env):
        panels = importlib.import_module(f"{ADDON}.ui.panels")
        ops = _registered_ops(env)
        drawn = _draw_all(env, panels, ops)
        # All 8 panels pass poll with a fully-configured tracker.
        assert len(drawn) == 8, sorted(drawn)
        # Idle: the tracking panel offers no cancel buttons and the
        # optical-flow panel offers analyze, not cancel.
        track_ops = [e[1] for e in drawn["PC_PT_Tracking"] if e[0] == "operator"]
        assert "polychase.cancel_tracking" not in track_ops
        assert "polychase.track_sequence" in track_ops
        flow_ops = [e[1] for e in drawn["PC_PT_OpticalFlow"] if e[0] == "operator"]
        assert flow_ops == ["polychase.analyze_video"]
        # Pin-mode panel offers entry while not in pin mode.
        pin_ops = [e[1] for e in drawn["PC_PT_PinMode"] if e[0] == "operator"]
        assert "polychase.pin_mode" in pin_ops

    def test_busy_states(self, env):
        panels = importlib.import_module(f"{ADDON}.ui.panels")
        properties = env.properties
        ops = _registered_ops(env)
        transient = properties.transient_state(env.tracker)
        transient.is_tracking = True
        transient.is_analyzing = True
        transient.progress = 0.42
        transient.progress_message = "Tracking frame 3"
        try:
            drawn = _draw_all(env, panels, ops)
        finally:
            transient.is_tracking = False
            transient.is_analyzing = False
            transient.progress = 0.0
            transient.progress_message = ""
        track = drawn["PC_PT_Tracking"]
        assert ("operator", "polychase.cancel_tracking") in track
        assert any(e[0] == "progress" for e in track)
        flow = drawn["PC_PT_OpticalFlow"]
        assert ("operator", "polychase.cancel_analysis") in flow
        assert ("operator", "polychase.analyze_video") not in flow

    def test_pinmode_state(self, env):
        panels = importlib.import_module(f"{ADDON}.ui.panels")
        ops = _registered_ops(env)
        transient = env.properties.transient_state(env.tracker)
        transient.in_pinmode = True
        try:
            drawn = _draw_all(env, panels, ops)
        finally:
            transient.in_pinmode = False
        pin = drawn["PC_PT_PinMode"]
        assert ("operator", "polychase.pin_mode") not in pin
        assert any(e[0] == "label" for e in pin)

    def test_uilist_and_no_tracker(self, env):
        panels = importlib.import_module(f"{ADDON}.ui.panels")
        ops = _registered_ops(env)
        # UIList row draws the tracker name.
        ul = panels.PC_UL_Trackers.__new__(panels.PC_UL_Trackers)
        layout = FakeLayout(ops, [])
        ul.draw_item(
            env.ctx, layout, None, env.tracker, None, None, None, 0
        )
        assert ("prop", type(env.tracker).__name__, "name") in layout.log

        # With no active tracker only the main panel draws.
        state = env.properties.PolychaseState.from_scene(env.scene)
        saved = state.active_tracker_index
        state.active_tracker_index = -1
        try:
            drawn = _draw_all(env, panels, ops)
        finally:
            state.active_tracker_index = saved
        assert list(drawn) == ["PC_PT_Main"]


@pytest.mark.parametrize("state", ["idle", "busy", "pinmode"])
def test_draw_logs_equal_the_jax_addons(env, state):
    logs = []
    for package in (ADDON, "polychase_tpu.blender_addon"):
        mods = addon_modules(package)
        panels = importlib.import_module(f"{package}.ui.panels")
        transient = mods.properties.transient_state(env.tracker)
        if state == "busy":
            transient.is_tracking = transient.is_analyzing = True
            transient.progress = 0.42
            transient.progress_message = "Tracking frame 3"
        transient.in_pinmode = state == "pinmode"
        try:
            logs.append(_draw_all(env, panels, _registered_ops(env, package)))
        finally:
            mods.properties._transient.clear()
            mods.core.Trackers.clear()
    assert logs[0] == logs[1]
    assert len(logs[0]) == 8
