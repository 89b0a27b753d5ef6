"""The GPU-facing pin-mode pieces and the scale folding of the port's
add-on copy, under the behavioral fake bpy and gpu (tests/fake_bpy.py,
tests/fake_gpu.py), with the checks of tests/test_masking_gpu.py and
tests/test_scale_folding.py:

- ``Masking3DSelector``: the offscreen triangle-ID pass rasterizes (the
  perspective divide, the depth test), the readback decodes and the brush
  windows clamp; ``PinModeRenderer``: the overlay's pass sequence and GPU
  state, and the mask UBO carrying the port's packed bitmask.  Blender's
  ``gpu`` module draws these overlays; they are not CUDA.
- mask painting in pin mode masks the polygon under the brush, which the
  port's ray cast then refuses for new pins;
- ``core.fold_scale`` and ``apply_tracking_result`` keep the object's
  scale for both tracking targets.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

import fake_bpy
import fake_gpu
import fake_mathutils as mu
from test_addon_modal import _event
from test_e2e_images import H, W
from test_torch_addon_modal import (  # noqa: F401  (fixtures)
    ADDON,
    enter_pin_mode,
    env,
    rendered,
)


def _mk(env, name):
    return importlib.import_module(f"{ADDON}.operators.pin_mode.{name}")


def _ortho_scene(env, verts, tris, size=64):
    """A unit-box orthographic view of hand-placed triangles."""
    mu = env.mu
    engine_tracker = SimpleNamespace(
        accel_mesh=SimpleNamespace(
            inner=lambda: SimpleNamespace(
                vertices=np.asarray(verts, np.float32),
                triangles=np.asarray(tris, np.uint32),
            )
        )
    )
    tracker_props = SimpleNamespace(
        geometry=SimpleNamespace(matrix_world=mu.Matrix())
    )
    region = SimpleNamespace(width=size, height=size)
    # Identity projection: NDC == object coords; z maps [-1,1].
    rv3d = SimpleNamespace(perspective_matrix=mu.Matrix())
    return engine_tracker, tracker_props, region, rv3d


class TestMasking3DSelector:
    def test_pick_windows_and_background(self, env):
        m3d = _mk(env, "masking_3d")
        size = 64
        # Two side-by-side triangles: left half / right half of NDC.
        verts = [
            [-0.9, -0.5, 0.0], [-0.1, -0.5, 0.0], [-0.5, 0.5, 0.0],
            [0.1, -0.5, 0.0], [0.9, -0.5, 0.0], [0.5, 0.5, 0.0],
        ]
        tris = [[0, 1, 2], [3, 4, 5]]
        et, props, region, rv3d = _ortho_scene(env, verts, tris, size)

        sel = m3d.Masking3DSelector()
        sel.render_ids(et, props, region, rv3d)

        # NDC x=-0.5 → pixel 16; x=+0.5 → pixel 48; y=0 → 32.
        assert list(sel.triangles_under_brush(16, 30, 2)) == [0]
        assert list(sel.triangles_under_brush(48, 30, 2)) == [1]
        both = sel.triangles_under_brush(32, 30, 18)
        assert list(both) == [0, 1]
        # Background: top corner hits nothing.
        assert sel.triangles_under_brush(2, 60, 2).size == 0
        # Off-screen brush windows clamp instead of erroring.
        assert sel.triangles_under_brush(-10, -10, 3).size == 0

        sel.free()
        assert sel._id_buffer is None

    def test_depth_test_picks_nearer_triangle(self, env):
        m3d = _mk(env, "masking_3d")
        # Two overlapping full-screen-ish triangles; the SECOND drawn is
        # NEARER (smaller NDC z). With LESS depth testing the nearer one
        # must win even though it is drawn after.
        verts = [
            [-0.9, -0.9, 0.5], [0.9, -0.9, 0.5], [0.0, 0.9, 0.5],
            [-0.9, -0.9, -0.5], [0.9, -0.9, -0.5], [0.0, 0.9, -0.5],
        ]
        tris = [[0, 1, 2], [3, 4, 5]]
        et, props, region, rv3d = _ortho_scene(env, verts, tris)

        sel = m3d.Masking3DSelector()
        sel.render_ids(et, props, region, rv3d)
        assert list(sel.triangles_under_brush(32, 20, 1)) == [1]

        # Same scene with the near triangle FIRST: still triangle with
        # z=-0.5 (now id 0) — order independence proves the z-buffer.
        et2, props2, region2, rv3d2 = _ortho_scene(
            env, verts, [[3, 4, 5], [0, 1, 2]]
        )
        sel2 = m3d.Masking3DSelector()
        sel2.render_ids(et2, props2, region2, rv3d2)
        assert list(sel2.triangles_under_brush(32, 20, 1)) == [0]

    def test_offscreen_reallocates_on_resize(self, env):
        m3d = _mk(env, "masking_3d")
        verts = [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.0, 0.5, 0.0]]
        et, props, region, rv3d = _ortho_scene(env, verts, [[0, 1, 2]])
        sel = m3d.Masking3DSelector()
        sel.render_ids(et, props, region, rv3d)
        first = sel._offscreen
        region.width, region.height = 32, 32
        sel.render_ids(et, props, region, rv3d)
        assert sel._offscreen is not first and first.freed
        assert sel._id_buffer.shape == (32, 32)


class TestPinModeRendererPasses:
    def test_draw_sequence_and_mask_ubo(self, env):
        rendering = _mk(env, "rendering")
        engine_tracker = env.core.Trackers.get(env.tracker)

        # Mask the first polygon so the UBO is non-trivial.
        engine_tracker.mask_polygon(env.tracker, 0, mask=True)
        renderer = rendering.PinModeRenderer(env.tracker, engine_tracker)
        renderer.update_pins(
            np.array([[0.0, 0.0, 1.0], [0.3, 0.2, 0.9]], np.float32)
        )
        renderer.set_mask_circle((100.0, 120.0, 25.0))

        # The UBO holds the engine's packed bitmask (padded to 4096 u32).
        mask_words = np.frombuffer(renderer._mask_ubo.data, np.uint32)
        engine_mask = np.asarray(
            engine_tracker.accel_mesh.inner().masked_triangles, np.uint32
        ).reshape(-1)
        assert mask_words.size == 4096
        assert np.array_equal(mask_words[: engine_mask.size], engine_mask)
        assert mask_words.any()

        env.ctx.screen.areas.append(fake_bpy.FakeView3DArea(640, 480))
        fake_gpu.DRAW_LOG.clear()
        renderer._draw(env.tracker)

        log = fake_gpu.DRAW_LOG
        kinds = [d["type"] for d in log]
        assert kinds == ["TRIS", "LINES", "POINTS", "TRIS"], kinds

        prepass, wire, pins, circle = log
        # Depth prepass: invisible fill, mask tint on, depth writes on.
        assert prepass["uniforms"]["useMask"] is True
        assert prepass["state"]["depth_mask"] is True
        assert prepass["state"]["depth_test"] == "LESS_EQUAL"
        assert tuple(prepass["uniforms"]["color"]) == (0, 0, 0, 0)
        # Wireframe: negative depth bias, no depth writes, mask off.
        assert wire["uniforms"]["useMask"] is False
        assert float(wire["uniforms"]["bias"]) < 0
        assert wire["state"]["depth_mask"] is False
        # Pins: depth testing off so they are always visible.
        assert pins["state"]["depth_test"] == "NONE"
        assert pins["state"]["blend"] == "ALPHA"
        assert pins["n_verts"] == 2
        # Selection circle: full-screen quad with center/radius uniforms.
        assert tuple(circle["uniforms"]["center"]) == (100.0, 120.0)
        assert float(circle["uniforms"]["radius"]) == 25.0

    def test_update_geometry_handles_missing_mesh(self, env):
        rendering = _mk(env, "rendering")
        engine_tracker = env.core.Trackers.get(env.tracker)
        renderer = rendering.PinModeRenderer(env.tracker, engine_tracker)
        renderer.update_geometry(None)
        assert renderer._depth_batch is None and renderer._wire_batch is None
        # Draw with no geometry batches is a no-op, not a crash.
        env.ctx.screen.areas.append(fake_bpy.FakeView3DArea(640, 480))
        fake_gpu.DRAW_LOG.clear()
        renderer._draw(env.tracker)
        assert [d["type"] for d in fake_gpu.DRAW_LOG if d["type"] != "POINTS"] == []


def test_mask_painting_blocks_pins(env):
    op = enter_pin_mode(env, env.pin_mode)
    engine_tracker = env.core.Trackers.get(env.tracker)
    region = env.ctx.screen.areas[0].regions[0]
    rv3d = env.ctx.screen.areas[0].spaces.active.region_3d
    op.modal(env.ctx, _event("M", "PRESS"))
    assert op._masking
    r0 = env.tracker.mask_brush_radius
    op.modal(env.ctx, _event("WHEELUPMOUSE", "NOTHING", 10, 10))
    assert env.tracker.mask_brush_radius == r0 + 2
    op.modal(env.ctx, _event("WHEELDOWNMOUSE", "NOTHING", 10, 10))
    assert env.tracker.mask_brush_radius == r0

    cx, cy = W // 2, H // 2
    op.modal(env.ctx, _event("LEFTMOUSE", "PRESS", cx, cy))
    op.modal(env.ctx, _event("LEFTMOUSE", "RELEASE", cx, cy))
    # The rasterized id under the brush is the port's ray-cast hit there
    # (a pixel off the center, whose ray meets a triangle edge, where the
    # two may resolve the tie either way).
    ids = op._masker._id_buffer
    assert ids is not None and ids.shape == (H, W)
    px, py = cx + 7, cy + 5
    hit = engine_tracker.ray_cast(env.tracker, env.ctx, region, rv3d, px, py,
                                  check_mask=False)
    assert hit is not None and ids[py, px] == hit.primitive_id + 1
    assert ids[5, 5] == 0
    assert np.frombuffer(bytes(env.tracker.masked_triangles),
                         np.uint32).any()
    assert any("mask paint" in m for m in env.bpy.undo_pushes)
    assert op._renderer._mask_circle is not None

    op.modal(env.ctx, _event("M", "PRESS"))
    assert not op._masking
    op.modal(env.ctx, _event("LEFTMOUSE", "PRESS", cx, cy))
    assert engine_tracker.pins.count == 0  # the masked surface refuses
    op.modal(env.ctx, _event("LEFTMOUSE", "RELEASE", cx, cy))
    op.modal(env.ctx, _event("LEFTMOUSE", "PRESS", cx + 40, cy + 25))
    assert engine_tracker.pins.count == 1
    op.modal(env.ctx, _event("LEFTMOUSE", "RELEASE", cx + 40, cy + 25))
    op.modal(env.ctx, _event("ESC", "PRESS"))

    assert env.pin_mode.PC_OT_ClearMask.poll(env.ctx)
    assert env.pin_mode.PC_OT_ClearMask().execute(env.ctx) == {"FINISHED"}
    assert bytes(env.tracker.masked_triangles) == b""
    assert env.pin_mode.PC_OT_ClearPins().execute(env.ctx) == {"FINISHED"}
    assert bytes(env.tracker.pins_data) == b""


@pytest.fixture
def folding(env):
    """The copy's core, tracking operator and utils under the fake bpy."""
    return SimpleNamespace(
        core=env.core, tracking=env.tracking,
        utils=importlib.import_module(f"{ADDON}.utils"),
    )


def _make_model(scale=(2.0, 0.5, 3.0)):
    rot = mu.Quaternion((0.9, 0.1, -0.2, 0.3))
    return mu.Matrix.LocRotScale(
        mu.Vector((1.0, -2.0, 0.5)), rot, mu.Vector(scale)
    )


def _make_view():
    rot = mu.Quaternion((0.8, -0.3, 0.1, 0.2))
    return mu.Matrix.LocRotScale(mu.Vector((0.2, 0.4, -5.0)), rot, None)


def test_fold_scale_factorization(folding):
    model = _make_model()
    view = _make_view()
    scale_m, mv_no_scale = folding.core.fold_scale(model, view)

    # model matrix passed to the core is pure scale
    s = np.asarray(scale_m)
    assert np.allclose(s, np.diag(np.diag(s)))
    assert np.allclose(np.diag(s)[:3], [2.0, 0.5, 3.0])

    # mv_no_scale is rigid
    r = np.asarray(mv_no_scale)[:3, :3]
    assert np.allclose(r @ r.T, np.eye(3), atol=1e-9)

    # the factorization reproduces the full modelview exactly
    lhs = np.asarray(view) @ np.asarray(model)
    rhs = np.asarray(mv_no_scale) @ s
    assert np.allclose(lhs, rhs, atol=1e-9)


class _FakeObject:
    """Just enough of bpy.types.Object for the matrix utils."""

    def __init__(self, matrix):
        self.matrix_world = matrix
        self.scale = matrix.to_scale()
        self.rotation_mode = "QUATERNION"


def _fake_tracker(target, model, cam_world):
    geometry = _FakeObject(model)
    camera = _FakeObject(cam_world)
    return SimpleNamespace(
        geometry=geometry,
        camera=camera,
        tracking_target=target,
        optimize_focal_length=False,
        optimize_principal_point=False,
    )


def _solved_pose(mv_no_scale):
    loc, rot, _ = mv_no_scale.decompose()
    return SimpleNamespace(
        q=np.array([rot.w, rot.x, rot.y, rot.z], np.float32),
        t=np.array(list(loc), np.float32),
    )


def test_apply_tracking_result_geometry_preserves_scale(folding, monkeypatch):
    monkeypatch.setattr(
        folding.tracking.keyframes, "insert_keyframe", lambda *a, **k: None
    )
    model = _make_model()
    cam_world = _make_view().inverted()
    tracker = _fake_tracker("GEOMETRY", model, cam_world)

    # Ground truth: the solver moved the scale-free modelview
    view = folding.utils.get_camera_view_matrix(tracker.camera)
    _, mv0 = folding.core.fold_scale(model, view)
    delta = mu.Matrix.LocRotScale(
        mu.Vector((0.1, -0.05, 0.2)), mu.Quaternion((0.99, 0.1, 0.0, 0.05)),
        None,
    )
    mv_new = delta @ mv0

    result = SimpleNamespace(pose=_solved_pose(mv_new), frame=7)
    folding.tracking.apply_tracking_result(tracker, result)

    # object scale preserved exactly
    new_model = tracker.geometry.matrix_world
    assert np.allclose(
        list(new_model.to_scale()), [2.0, 0.5, 3.0], atol=1e-6
    )
    # and view @ new_model has the solved rigid part
    scale_m, mv_back = folding.core.fold_scale(new_model, view)
    assert np.allclose(
        np.asarray(mv_back), np.asarray(mv_new), atol=1e-5
    )


def test_apply_tracking_result_camera_target(folding, monkeypatch):
    monkeypatch.setattr(
        folding.tracking.keyframes, "insert_keyframe", lambda *a, **k: None
    )
    model = _make_model()
    cam_world = _make_view().inverted()
    tracker = _fake_tracker("CAMERA", model, cam_world)

    view = folding.utils.get_camera_view_matrix(tracker.camera)
    _, mv0 = folding.core.fold_scale(model, view)
    delta = mu.Matrix.LocRotScale(
        mu.Vector((-0.2, 0.1, 0.05)), mu.Quaternion((0.98, 0.0, 0.15, -0.1)),
        None,
    )
    mv_new = delta @ mv0

    result = SimpleNamespace(pose=_solved_pose(mv_new), frame=3)
    folding.tracking.apply_tracking_result(tracker, result)

    # geometry untouched
    assert np.allclose(
        np.asarray(tracker.geometry.matrix_world), np.asarray(model)
    )
    # new camera view recomposes the solved modelview
    view_new = folding.utils.get_camera_view_matrix(tracker.camera)
    _, mv_back = folding.core.fold_scale(model, view_new)
    assert np.allclose(
        np.asarray(mv_back), np.asarray(mv_new), atol=1e-5
    )
