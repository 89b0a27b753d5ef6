"""The port's add-on copy (``polychase_tpu_torch.blender_addon``) driven
through its modal operators under the behavioral fake bpy
(tests/fake_bpy.py), with real worker threads and the port's engine on the
CPU (``core.DEVICE = torch.device("cpu")``).

Each run is held to the port's direct call on the same inputs, to the bit:
the DB written by the modal analyze against
``generate_optical_flow_database``'s, and the keyframes of the modal track
and the modal refine against those the copy's own write-back makes from
``track_sequence``'s and ``refine_trajectory``'s poses.  The modal track
also meets tests/test_addon_modal.py's pose threshold against the rendered
clip's truth, the modal refine its 0.6× error bar, and an 8-pin drag
through the copy's pin mode agrees with the JAX add-on's within 1e-6 (both
take the float64 host route).  The clip is rendered by the JAX tests'
helpers in
this process; only the copy must be free of JAX.
"""

import importlib
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import fake_bpy
from test_addon_modal import (  # noqa: F401  (rendered: a fixture)
    ESC,
    TIMER,
    _CameraRV3D,
    _FLIP,
    _cv_project,
    _event,
    _install_camera_animation,
    _perturbed_views,
    _pump,
    _t_err,
    _view_cv4x4,
    _window_matrix,
    _wire_background_image,
    rendered,
)
from test_e2e_images import FOCAL, H, N_FRAMES, W

torch.set_num_threads(1)

ADDON = "polychase_tpu_torch.blender_addon"
CPU = torch.device("cpu")
PIN_PARITY_ATOL = 1e-6
GT_ATOL = 0.05  # tests/test_addon_modal.py's final-pose threshold

MODULES = {
    "analysis": "operators.analysis",
    "tracking": "operators.tracking",
    "refiner": "operators.refiner",
    "pin_mode": "operators.pin_mode.pin_mode",
    "properties": "properties",
    "keyframes": "keyframes",
    "core": "core",
}


def pop_addon(package=ADDON):
    for name in list(sys.modules):
        if name == package or name.startswith(package + "."):
            sys.modules.pop(name)


def addon_modules(package=ADDON):
    """The operator, property, keyframe and core modules of an add-on
    package, imported under the installed fake bpy."""
    return SimpleNamespace(**{
        key: importlib.import_module(f"{package}.{name}")
        for key, name in MODULES.items()
    })


@pytest.fixture
def env(rendered, tmp_path):
    """A fresh fake-bpy world with the copy imported under it and its
    engine calls on the CPU (tests/test_addon_modal.py's ``env``)."""
    pop_addon()
    scene = fake_bpy.FakeScene()
    bpy, saved = fake_bpy.install(scene)
    mods = addon_modules()
    mods.core.DEVICE = CPU
    import fake_mathutils as mu

    clip = fake_bpy.FakeClip(
        "clip", str(tmp_path / "clip.mp4"), W, H, 0, N_FRAMES
    )
    cam_data = fake_bpy.FakeCameraData()
    cam_data.lens = FOCAL * cam_data.sensor_width / W
    camera = fake_bpy.FakeObject("Camera", data=cam_data)
    view_gl = _FLIP @ _view_cv4x4(rendered.poses[0])
    camera.matrix_world = mu.Matrix(np.linalg.inv(view_gl))
    geometry = fake_bpy.FakeObject(
        "Sphere",
        mesh_arrays=(
            np.asarray(rendered.mesh.vertices),
            np.asarray(rendered.mesh.triangles),
        ),
    )
    tracker = fake_bpy.FakeTracker(
        clip=clip, camera=camera, geometry=geometry,
        database_path=str(tmp_path / "flow.db"),
    )
    scene.polychase_state = fake_bpy.FakeState([tracker])

    yield SimpleNamespace(
        bpy=bpy, scene=scene, ctx=bpy.context, clip=clip, camera=camera,
        geometry=geometry, tracker=tracker, rendered=rendered, mu=mu,
        db_path=str(tmp_path / "flow.db"), tmp_path=tmp_path,
        **vars(mods),
    )

    mods.core.Trackers.clear()
    mods.properties._transient.clear()
    fake_bpy.uninstall(saved)
    pop_addon()


def _pc():
    import polychase_tpu_torch.polychase_core as pc

    return pc


def analyze_direct(env, path):
    """The port's direct analyze of the rendered clip on the CPU."""
    pc = _pc()
    info = pc.VideoInfo(width=W, height=H, first_frame=0,
                        num_frames=N_FRAMES)
    pc.generate_optical_flow_database(
        info, lambda fid: env.rendered.frames[fid], None, path, device=CPU
    )


def read_db(path):
    pc = _pc()
    db = pc.Database(path)
    try:
        kps = [db.read_keypoints(f) for f in range(N_FRAMES)]
        flows = {}
        for f in range(N_FRAMES):
            for t in db.find_optical_flows_from_image(f):
                fl = db.read_image_pair_flow(f, t)
                flows[f, t] = (fl.src_kps_indices, fl.tgt_kps,
                               fl.flow_errors)
    finally:
        db.close()
    return kps, flows


def keyed_views(env, frames):
    """The camera's keyframed view matrices, back in the OpenCV
    convention."""
    return {f: _FLIP @ np.linalg.inv(env.camera.keyframe_matrices[f])
            for f in frames}


def replay_tracker(env):
    """A tracker on the scene's geometry whose camera starts where the
    scene's camera is now: a direct call's results written back through
    the copy's own write-back land in its camera's keyframes."""
    camera = fake_bpy.FakeObject("Camera.direct", data=env.camera.data)
    camera.matrix_world = env.mu.Matrix(np.array(env.camera.matrix_world))
    return fake_bpy.FakeTracker(clip=env.clip, camera=camera,
                                geometry=env.geometry)


def assert_same_keyframes(got, want, frames):
    assert set(frames) <= set(want.keyframe_matrices)
    for f in frames:
        np.testing.assert_array_equal(
            got.keyframe_matrices[f], want.keyframe_matrices[f],
            err_msg=f"frame {f}")


class TestAnalyzeModal:
    def test_database_equals_direct_call(self, env):
        op = env.analysis.PC_OT_AnalyzeVideo()
        assert type(op).poll(env.ctx)
        assert op.invoke(env.ctx, SimpleNamespace(type="RET")) == {
            "RUNNING_MODAL"}
        assert op.execute(env.ctx) == {"RUNNING_MODAL"}
        transient = env.properties.transient_state(env.tracker)
        assert transient.is_analyzing and not type(op).poll(env.ctx)
        _wire_background_image(env)
        assert _pump(op, env.ctx) == {"FINISHED"}, op.reports
        assert not transient.is_analyzing and transient.progress == 1.0
        assert env.ctx.window_manager.timers == []

        direct = str(env.tmp_path / "direct.db")
        analyze_direct(env, direct)
        kps, flows = read_db(env.db_path)
        ref_kps, ref_flows = read_db(direct)
        for f in range(N_FRAMES):
            assert kps[f].shape[0] > 60, f
            np.testing.assert_array_equal(kps[f], ref_kps[f])
        assert set(flows) == set(ref_flows)
        assert {t for f, t in flows if f == 3} >= {1, 2, 4, 5}
        for key, arrays in flows.items():
            for got, want in zip(arrays, ref_flows[key]):
                np.testing.assert_array_equal(got, want)

    def test_esc_during_blocked_frame_request_cancels_cleanly(self, env):
        op = env.analysis.PC_OT_AnalyzeVideo()
        op.invoke(env.ctx, SimpleNamespace(type="RET"))
        assert op.execute(env.ctx) == {"RUNNING_MODAL"}
        # No image users registered: the seek never settles, so the worker
        # stays blocked on its first frame request.
        deadline = time.time() + 60
        while op._pending_frame is None and time.time() < deadline:
            op.modal(env.ctx, TIMER)
            time.sleep(0.01)
        assert op._pending_frame is not None
        op.modal(env.ctx, ESC)
        assert _pump(op, env.ctx, deadline_s=60) == {"FINISHED"}, op.reports
        assert not [r for r in op.reports if "ERROR" in r[0]], op.reports
        assert not env.properties.transient_state(env.tracker).is_analyzing


class TestTrackModal:
    def test_keyframes_equal_direct_track_and_truth(self, env):
        analyze_direct(env, env.db_path)
        env.scene.frame_set(0)
        pc = _pc()
        scene = env.core.scene_transformations(env.tracker, W, H)
        replay = replay_tracker(env)

        op = env.tracking.PC_OT_TrackSequence()
        assert type(op).poll(env.ctx)
        assert op.execute(env.ctx) == {"RUNNING_MODAL"}, op.reports
        transient = env.properties.transient_state(env.tracker)
        assert transient.is_tracking
        assert _pump(op, env.ctx) == {"FINISHED"}, op.reports
        assert not transient.is_tracking and transient.active_thread is None
        gen = env.keyframes.keyframes_of_type(
            env.keyframes.tracker_fcurves(env.tracker, include_lens=False),
            env.keyframes.GENERATED_KEYFRAME,
        )
        assert gen == set(range(1, N_FRAMES))
        assert env.scene.frame_current == N_FRAMES - 1

        opts = pc.BundleOptions()
        opts.loss_type = pc.LossType.Cauchy
        opts.loss_scale = 1.0
        direct = []
        pc.track_sequence(
            env.db_path, 0, N_FRAMES - 1, scene,
            env.core.Trackers.get(env.tracker).accel_mesh,
            lambda r: direct.append(r) or True, False, False, opts,
            device=CPU,
        )
        assert [r.frame for r in direct] == list(range(1, N_FRAMES))
        for r in direct:
            env.tracking.apply_tracking_result(replay, r)
        assert_same_keyframes(env.camera, replay.camera, gen)

        gt = _view_cv4x4(env.rendered.poses[N_FRAMES - 1])
        final = _FLIP @ np.linalg.inv(np.asarray(env.camera.matrix_world))
        assert np.abs(final - gt).max() < GT_ATOL, final - gt

    def test_cancel_operator_requests_stop(self, env):
        analyze_direct(env, env.db_path)
        env.scene.frame_set(0)
        op = env.tracking.PC_OT_TrackSequence()
        assert op.execute(env.ctx) == {"RUNNING_MODAL"}
        assert env.tracking.PC_OT_CancelTracking.poll(env.ctx)
        assert env.tracking.PC_OT_CancelTracking().execute(env.ctx) == {
            "FINISHED"}
        assert _pump(op, env.ctx) in ({"FINISHED"}, {"CANCELLED"})
        assert not env.properties.transient_state(env.tracker).is_tracking

    def test_nothing_to_track_at_clip_end(self, env):
        env.scene.frame_set(N_FRAMES - 1)
        op = env.tracking.PC_OT_TrackSequence()
        assert op.execute(env.ctx) == {"CANCELLED"}
        assert any("Nothing to track" in m for _, m in op.reports)


class TestRefineModal:
    def _setup(self, env, seed, keys=()):
        analyze_direct(env, env.db_path)
        views = _perturbed_views(env, np.random.default_rng(seed))
        _install_camera_animation(env, views)
        for f in (0, N_FRAMES - 1) + tuple(keys):
            env.keyframes.insert_keyframe(
                env.camera, f, keytype=env.keyframes.USER_KEYFRAME)
        return views

    def _direct(self, env, start, end):
        """``refine_trajectory`` on the trajectory the operator builds."""
        pc = _pc()
        traj = env.refiner.build_trajectory(env.tracker, start, end, W, H,
                                            env.scene)
        opts = pc.BundleOptions()
        opts.loss_type = pc.LossType.Cauchy
        opts.loss_scale = 1.0
        pc.refine_trajectory(
            env.db_path, traj, np.eye(4, dtype=np.float32),
            env.core.Trackers.get(env.tracker).accel_mesh, False, False,
            None, opts, device=CPU,
        )
        return traj

    def _check(self, env, views, segments):
        gen = env.keyframes.keyframes_of_type(
            env.keyframes.tracker_fcurves(env.tracker, include_lens=False),
            env.keyframes.GENERATED_KEYFRAME,
        )
        assert gen == set().union(
            *(range(start + 1, end) for start, end in segments))
        replay = replay_tracker(env)

        def follow(frame):
            # The scene's animation poses the replay camera too, as it
            # posed the scene's camera under the operator's write-back.
            replay.camera.matrix_world = env.mu.Matrix(
                np.array(env.camera.matrix_world))

        env.scene.frame_hooks.append(follow)
        for start, end in segments:
            env.refiner.apply_refined_trajectory(
                replay, self._direct(env, start, end), start, end,
                env.scene)
        assert_same_keyframes(env.camera, replay.camera, gen)
        keyed = keyed_views(env, gen)
        before = [_t_err(views[f], env.rendered.poses[f]) for f in gen]
        after = [_t_err(keyed[f], env.rendered.poses[f]) for f in gen]
        assert np.mean(after) < 0.6 * np.mean(before), (before, after)

    def test_refine_sequence_equals_direct_refine(self, env):
        views = self._setup(env, 7)
        env.scene.frame_set(3)
        op = env.refiner.PC_OT_RefineSequence()
        assert type(op).poll(env.ctx)
        assert op.execute(env.ctx) == {"RUNNING_MODAL"}, op.reports
        assert env.refiner.PC_OT_CancelRefine.poll(env.ctx)
        assert _pump(op, env.ctx) == {"FINISHED"}, op.reports
        transient = env.properties.transient_state(env.tracker)
        assert not transient.is_refining and env.ctx.window_manager.timers == []
        self._check(env, views, [(0, N_FRAMES - 1)])

    def test_refine_all_on_one_device_is_sequential(self, env):
        """An explicit device (here the CPU) never takes the split route:
        refine-all runs its segments one after the other."""
        views = self._setup(env, 9, keys=(4,))
        op = env.refiner.PC_OT_RefineAllSegments()
        assert op.execute(env.ctx) == {"RUNNING_MODAL"}, op.reports
        assert op._parallel_trajs is None
        assert _pump(op, env.ctx) == {"FINISHED"}, op.reports
        self._check(env, views, [(0, 4), (4, N_FRAMES - 1)])


def enter_pin_mode(env, pin_mode):
    rv3d = _CameraRV3D(env.camera, _window_matrix(env))
    env.ctx.screen.areas.append(fake_bpy.FakeView3DArea(W, H, rv3d))
    op = pin_mode.PC_OT_PinMode()
    assert type(op).poll(env.ctx)
    assert op.invoke(env.ctx, _event("NONE")) == {"RUNNING_MODAL"}, (
        op.reports)
    return op


def place_pins(env, pin_mode, clicks):
    """Place a pin at each click (each a ray cast onto the sphere)."""
    op = enter_pin_mode(env, pin_mode)
    for x, y in clicks:
        op.modal(env.ctx, _event("LEFTMOUSE", "PRESS", x, y))
        op.modal(env.ctx, _event("LEFTMOUSE", "RELEASE", x, y))
    assert op.modal(env.ctx, _event("ESC", "PRESS")) == {"FINISHED"}
    return bytes(env.tracker.pins_data)


def pin_drag(env, pin_mode, pins, grab, target):
    """Load ``pins`` into the tracker, press on the pin under ``grab`` and
    drag it to ``target`` with four MOUSEMOVEs; returns the camera's world
    matrix."""
    env.tracker.pins_data = pins
    env.tracker.pins_version += 1
    op = enter_pin_mode(env, pin_mode)
    op.modal(env.ctx, _event("LEFTMOUSE", "PRESS", *grab))
    assert op._drag_pin == len(pins) // 12 - 1
    for _ in range(4):
        op.modal(env.ctx, _event("MOUSEMOVE", "NOTHING", *target))
    op.modal(env.ctx, _event("LEFTMOUSE", "RELEASE", *target))
    assert op.modal(env.ctx, _event("ESC", "PRESS")) == {"FINISHED"}
    env.ctx.screen.areas.clear()
    return np.array(env.camera.matrix_world)


PIN_CLICKS = [(W // 2 + dx, H // 2 + dy) for dx, dy in
              ((0, 0), (40, 25), (-35, 20), (30, -30), (-25, -35),
               (55, -5), (-50, 0), (10, 45))]
PIN_TARGET = (W // 2 + 22, H // 2 + 39)


class TestPinModeModal:
    def test_pick_drag_release(self, env):
        op = enter_pin_mode(env, env.pin_mode)
        transient = env.properties.transient_state(env.tracker)
        assert transient.in_pinmode and not type(op).poll(env.ctx)
        engine_tracker = env.core.Trackers.get(env.tracker)
        op.modal(env.ctx, _event("LEFTMOUSE", "PRESS", 30, 30))
        assert engine_tracker.pins.count == 0  # off the sphere
        clicks = [(W // 2, H // 2), (W // 2 + 40, H // 2 + 25)]
        for i, (x, y) in enumerate(clicks):
            op.modal(env.ctx, _event("LEFTMOUSE", "PRESS", x, y))
            assert engine_tracker.pins.count == i + 1 and op._dragging
            op.modal(env.ctx, _event("LEFTMOUSE", "RELEASE", x, y))
            hit = engine_tracker.pins.points[i]
            assert abs(np.linalg.norm(hit) - 1.0) < 0.05
            np.testing.assert_allclose(_cv_project(env, hit), [x, y],
                                       atol=1.5)
        x0, y0 = clicks[1]
        target = (x0 + 12, y0 - 8)
        op.modal(env.ctx, _event("LEFTMOUSE", "PRESS", x0, y0))
        assert op._drag_pin == 1
        for _ in range(4):
            op.modal(env.ctx, _event("MOUSEMOVE", "NOTHING", *target))
        op.modal(env.ctx, _event("LEFTMOUSE", "RELEASE", *target))
        np.testing.assert_allclose(
            _cv_project(env, engine_tracker.pins.points[1]), target,
            atol=2.0)
        np.testing.assert_allclose(
            _cv_project(env, engine_tracker.pins.points[0]), clicks[0],
            atol=2.0)
        op.modal(env.ctx, _event("RIGHTMOUSE", "PRESS", *target))
        assert engine_tracker.pins.count == 1
        fn, args, _, _ = fake_bpy.FakeSpaceView3D.draw_handlers[0]
        fn(*args)
        assert op.modal(env.ctx, _event("ESC", "PRESS")) == {"FINISHED"}
        assert not transient.in_pinmode
        assert fake_bpy.FakeSpaceView3D.draw_handlers == []

    def test_eight_pin_drag_matches_jax_addon(self, env):
        """The same 8 pins dragged the same way through each add-on's pin
        mode from the same camera: the copy on the port, the JAX add-on on
        the JAX package, both on the float64 host route."""
        pins = place_pins(env, env.pin_mode, PIN_CLICKS)
        assert len(pins) == 8 * 12
        env.ctx.screen.areas.clear()
        start = np.array(env.camera.matrix_world)
        dragged = np.frombuffer(pins, np.float32)[-3:]
        before = np.linalg.norm(_cv_project(env, dragged) - PIN_TARGET)
        got = pin_drag(env, env.pin_mode, pins, PIN_CLICKS[-1], PIN_TARGET)
        # Seven pins hold the pose: the dragged one moves toward the target.
        assert not np.allclose(got, start)
        assert np.linalg.norm(_cv_project(env, dragged) - PIN_TARGET) < before

        env.camera.matrix_world = env.mu.Matrix(start)
        jax_addon = addon_modules("polychase_tpu.blender_addon")
        try:
            want = pin_drag(env, jax_addon.pin_mode, pins, PIN_CLICKS[-1],
                            PIN_TARGET)
        finally:
            jax_addon.core.Trackers.clear()
            jax_addon.properties._transient.clear()
        np.testing.assert_allclose(got, want, rtol=0, atol=PIN_PARITY_ATOL)
