"""bpy-free parity of the add-on copy's pure glue with the JAX add-on's, on
the same inputs: the camera-parameter fits and their round trip
(utils.py), the facade intrinsics built from a camera (core.py), tracking
and refine segment computation, the keyframe queries and clearing
(keyframes.py) and scale folding (core.fold_scale).  The copy must return
what the JAX add-on returns, exactly: the two modules are the same code on
different facades."""

import sys
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

import fake_mathutils as mu

BPY_MODULES = [
    "bpy", "bpy.types", "bpy.props", "bpy.utils", "bpy.path",
    "gpu", "gpu.types", "gpu.state", "gpu.shader",
    "gpu_extras", "gpu_extras.batch",
]
PACKAGES = ("polychase_tpu_torch.blender_addon", "polychase_tpu.blender_addon")


def _pop_addons():
    for name in list(sys.modules):
        if any(name == p or name.startswith(p + ".") for p in PACKAGES):
            sys.modules.pop(name)


@pytest.fixture
def addons():
    """(copy, JAX add-on), each with utils, core, keyframes, tracking and
    refiner imported under a stubbed bpy and the numpy mathutils."""
    import importlib

    saved = {
        name: sys.modules.get(name) for name in BPY_MODULES + ["mathutils"]
    }
    bpy = mock.MagicMock(name="bpy")
    bpy.types.PropertyGroup = type("PG", (), {})
    bpy.types.Operator = type("Op", (), {})
    for name in BPY_MODULES:
        sys.modules[name] = (
            bpy if name.startswith("bpy") else mock.MagicMock(name=name)
        )
    sys.modules["mathutils"] = mu
    _pop_addons()
    out = []
    for package in PACKAGES:
        out.append(SimpleNamespace(**{
            key: importlib.import_module(f"{package}.{name}")
            for key, name in (
                ("utils", "utils"), ("core", "core"),
                ("keyframes", "keyframes"),
                ("tracking", "operators.tracking"),
                ("refiner", "operators.refiner"),
            )
        }))
    yield out

    for name, module in saved.items():
        if module is None:
            sys.modules.pop(name, None)
        else:
            sys.modules[name] = module
    _pop_addons()


CAMERAS = [
    # lens, shift_x, shift_y, sensor_w, sensor_h, fit, width, height
    (35.0, 0.1, -0.05, 36.0, 24.0, "HORIZONTAL", 1920, 1080),
    (50.0, 0.0, 0.0, 36.0, 24.0, "VERTICAL", 1920, 1080),
    (35.0, 0.0, 0.0, 36.0, 24.0, "AUTO", 1080, 1920),
    (24.0, -0.2, 0.15, 23.5, 15.6, "AUTO", 640, 480),
]


@pytest.mark.parametrize("cam", CAMERAS)
def test_camera_params_and_intrinsics_equal(addons, cam):
    ours, theirs = addons
    assert (ours.utils.calc_camera_params_expanded(*cam)
            == theirs.utils.calc_camera_params_expanded(*cam))
    a = ours.core.camera_intrinsics_expanded(*cam)
    b = theirs.core.camera_intrinsics_expanded(*cam)
    for field in ("fx", "fy", "cx", "cy", "aspect_ratio", "width",
                  "height"):
        assert float(getattr(a, field)) == float(getattr(b, field)), field
    assert a.convention.name == b.convention.name == "OpenGL"


def test_camera_params_round_trip_equal(addons):
    results = []
    for addon in addons:
        data = SimpleNamespace(
            lens=35.0, shift_x=0.07, shift_y=-0.03, sensor_width=36.0,
            sensor_height=24.0, sensor_fit="AUTO", clip_start=0.1,
            clip_end=100.0,
        )
        cam = SimpleNamespace(data=data)
        params = addon.utils.calc_camera_params(cam, 1280, 720)
        data.lens, data.shift_x, data.shift_y = 1.0, 0.0, 0.0
        addon.utils.set_camera_params(cam, 1280, 720, *params)
        results.append((data.lens, data.shift_x, data.shift_y))
        with pytest.raises(ValueError):
            addon.utils.set_camera_params(cam, 1280, 720, params[0],
                                          params[0] * 1.5, *params[2:])
    assert results[0] == results[1]
    assert results[0][0] == pytest.approx(35.0)


def _fcurve(frames_types):
    class Points(list):
        def remove(self, kp, fast=False):
            list.remove(self, kp)

    return SimpleNamespace(
        keyframe_points=Points(
            SimpleNamespace(co=(float(f), 0.0), type=t)
            for f, t in frames_types),
        update=lambda: None,
    )


def _tracker(frames_types):
    return SimpleNamespace(
        clip=SimpleNamespace(frame_start=1, frame_duration=100),
        _fcurves=[_fcurve(frames_types)],
    )


KEYS = [(10, "KEYFRAME"), (20, "KEYFRAME"), (21, "KEYFRAME"),
        (40, "KEYFRAME"), (25, "GENERATED"), (50, "KEYFRAME")]


def test_segments_equal(addons, monkeypatch):
    got = []
    for addon in addons:
        monkeypatch.setattr(
            addon.keyframes, "tracker_fcurves",
            lambda tracker, include_lens=False: tracker._fcurves)
        tracker = _tracker(KEYS)
        ends = [addon.tracking.compute_segment_end(tracker, frame, back,
                                                   single)
                for frame in (1, 5, 12, 20, 21, 30, 50, 60, 100)
                for back in (False, True) for single in (False, True)]
        segments = [addon.refiner.compute_segments(tracker, frame, every)
                    for frame in (5, 15, 20, 21, 45, 60)
                    for every in (False, True)]
        got.append((ends, segments))
    assert got[0] == got[1]
    assert got[0][1][1] == [(10, 20), (21, 40), (40, 50)]


def test_keyframe_queries_and_clearing_equal(addons):
    got = []
    for addon in addons:
        kf = addon.keyframes
        types = [(1, kf.USER_KEYFRAME), (2, kf.GENERATED_KEYFRAME),
                 (3, kf.GENERATED_KEYFRAME), (4, kf.USER_KEYFRAME),
                 (6, kf.GENERATED_KEYFRAME)]
        fcurves = [_fcurve(types), _fcurve(types[1::2])]
        queries = (
            kf.keyframes_of_type(fcurves),
            kf.keyframes_of_type(fcurves, kf.USER_KEYFRAME),
            [kf.find_prev_keyframe(fcurves, f, kf.USER_KEYFRAME)
             for f in range(8)],
            [kf.find_next_keyframe(fcurves, f) for f in range(8)],
            kf.find_last_keyframe(fcurves),
            kf.find_last_keyframe(fcurves, kf.USER_KEYFRAME),
            [kf.has_keyframe_at(fcurves, f, kf.USER_KEYFRAME)
             for f in range(8)],
        )
        cleared = (kf.clear_generated_in_range(fcurves, 2, 3),
                   kf.keyframes_of_type(fcurves),
                   kf.clear_all_generated(fcurves),
                   kf.keyframes_of_type(fcurves))
        got.append((queries, cleared))
    assert got[0] == got[1]


def _model(scale=(2.0, 0.5, 3.0)):
    return mu.Matrix.LocRotScale(mu.Vector((1.0, -2.0, 0.5)),
                                 mu.Quaternion((0.9, 0.1, -0.2, 0.3)),
                                 mu.Vector(scale))


def _view():
    return mu.Matrix.LocRotScale(mu.Vector((0.2, 0.4, -5.0)),
                                 mu.Quaternion((0.8, -0.3, 0.1, 0.2)), None)


def test_fold_scale_equal(addons):
    got = [addon.core.fold_scale(_model(), _view()) for addon in addons]
    for a, b in zip(*got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    scale_m, mv = got[0]
    np.testing.assert_allclose(np.asarray(_view()) @ np.asarray(_model()),
                               np.asarray(mv) @ np.asarray(scale_m),
                               atol=1e-9)
