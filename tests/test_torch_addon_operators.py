"""The synchronous operators of the port's add-on copy (keyframe
management, scene operations, tracker management) executed under the
behavioral fake bpy, with tests/test_addon_operators.py's checks: fcurve
edits, frame navigation, the rigid scene transform and its cancel, the
geometry refresh rebuilding the port's accelerated mesh."""

import importlib

import numpy as np

from test_addon_modal import _FLIP, _view_cv4x4
from test_e2e_images import N_FRAMES
from test_torch_addon_modal import (  # noqa: F401  (fixtures)
    ADDON,
    env,
    rendered,
)


def _mod(env, name):
    return importlib.import_module(f"{ADDON}.operators.{name}")


def _key_camera(env, frame, keytype):
    env.scene.frame_set(frame)
    env.keyframes.insert_keyframe(env.camera, frame, keytype=keytype)


def _animate_camera(env):
    """Key the ground-truth orbit onto the camera: USER anchors at the
    ends, GENERATED inside (driven on frame_set by a scene hook)."""
    views = {f: _view_cv4x4(env.rendered.poses[f]) for f in range(N_FRAMES)}

    def hook(frame):
        if frame in views:
            env.camera.matrix_world = env.mu.Matrix(
                np.linalg.inv(_FLIP @ views[frame])
            )

    env.scene.frame_hooks.append(hook)
    hook(env.scene.frame_current)
    for f in range(N_FRAMES):
        _key_camera(
            env, f,
            env.keyframes.USER_KEYFRAME
            if f in (0, N_FRAMES - 1) else env.keyframes.GENERATED_KEYFRAME,
        )
    return views


def _camera_kf_types(env):
    fcurves = env.keyframes.tracker_fcurves(env.tracker, include_lens=False)
    out = {}
    for fc in fcurves:
        for kp in fc.keyframe_points:
            out[int(round(kp.co[0]))] = kp.type
    return out


class TestKeyframeManagement:
    def test_navigation_and_editing(self, env):
        km = _mod(env, "keyframe_management")
        _animate_camera(env)
        env.scene.frame_set(3)

        # prev/next navigate USER keyframes only
        assert km.PC_OT_PrevKeyframe.poll(env.ctx)
        assert km.PC_OT_PrevKeyframe().execute(env.ctx) == {"FINISHED"}
        assert env.scene.frame_current == 0
        assert km.PC_OT_NextKeyframe().execute(env.ctx) == {"FINISHED"}
        assert env.scene.frame_current == N_FRAMES - 1
        assert km.PC_OT_NextKeyframe().execute(env.ctx) == {"CANCELLED"}

        # add: the current frame becomes a USER anchor
        env.scene.frame_set(4)
        assert km.PC_OT_AddKeyframe().execute(env.ctx) == {"FINISHED"}
        assert _camera_kf_types(env)[4] == env.keyframes.USER_KEYFRAME

        # remove it again (any keytype at the frame)
        assert km.PC_OT_RemoveKeyframe().execute(env.ctx) == {"FINISHED"}
        assert 4 not in _camera_kf_types(env)
        assert km.PC_OT_RemoveKeyframe().execute(env.ctx) == {"CANCELLED"}

    def test_clear_operators(self, env):
        km = _mod(env, "keyframe_management")
        _animate_camera(env)

        # clear a middle segment bounded by the USER anchors
        env.scene.frame_set(3)
        km.PC_OT_AddKeyframe().execute(env.ctx)  # user anchor at 3
        env.scene.frame_set(1)
        assert km.PC_OT_ClearSegment().execute(env.ctx) == {"FINISHED"}
        types = _camera_kf_types(env)
        assert all(f not in types for f in (1, 2))
        assert types[0] == types[3] == env.keyframes.USER_KEYFRAME
        assert types[4] == env.keyframes.GENERATED_KEYFRAME

        # clear forwards of frame 4 (generated only)
        env.scene.frame_set(4)
        assert km.PC_OT_ClearForwards().execute(env.ctx) == {"FINISHED"}
        types = _camera_kf_types(env)
        assert all(
            t != env.keyframes.GENERATED_KEYFRAME or f < 4
            for f, t in types.items()
        )
        assert types[N_FRAMES - 1] == env.keyframes.USER_KEYFRAME

        # clear all generated leaves only user anchors
        assert km.PC_OT_ClearAllGenerated().execute(env.ctx) == {"FINISHED"}
        types = _camera_kf_types(env)
        assert set(types.values()) == {env.keyframes.USER_KEYFRAME}

    def test_clear_backwards(self, env):
        km = _mod(env, "keyframe_management")
        _animate_camera(env)
        env.scene.frame_set(2)
        assert km.PC_OT_ClearBackwards().execute(env.ctx) == {"FINISHED"}
        types = _camera_kf_types(env)
        assert 1 not in types and 2 not in types
        assert types[0] == env.keyframes.USER_KEYFRAME
        assert types[3] == env.keyframes.GENERATED_KEYFRAME


class TestSceneOperations:
    def test_center_geometry(self, env):
        so = _mod(env, "scene_operations")
        # Push the geometry far off-axis first
        env.geometry.matrix_world = env.mu.Matrix(
            np.array(env.mu.Matrix.LocRotScale(
                env.mu.Vector((25.0, -3.0, 7.0)), env.mu.Quaternion(), None
            ))
        )
        assert so.PC_OT_CenterGeometry.poll(env.ctx)
        assert so.PC_OT_CenterGeometry().execute(env.ctx) == {"FINISHED"}

        cam = np.array(env.camera.matrix_world)
        geo = np.array(env.geometry.matrix_world)
        corners = np.array(env.geometry.bound_box)  # local-space bbox
        center_world = (geo @ np.append(corners.mean(axis=0), 1.0))[:3]
        rel = np.linalg.inv(cam) @ np.append(center_world, 1.0)
        # Behavioral contract: bbox center in front of the camera
        # (GL: -Z forward) on the view axis, and every bbox corner
        # inside the FOV cone, at a distance of the right order (not
        # more than ~3x the tight fit).
        assert rel[2] < 0
        assert np.hypot(rel[0], rel[1]) < 1e-6
        fov = env.camera.data.angle
        world_corners = (geo @ np.c_[corners, np.ones(8)].T)[:3].T
        rel_c = (np.linalg.inv(cam) @ np.c_[
            world_corners, np.ones(8)
        ].T)[:3].T
        assert np.all(rel_c[:, 2] < 0)  # all corners in front
        half_width = np.abs(rel_c[:, 2]) * np.tan(fov / 2.0)
        assert np.all(np.abs(rel_c[:, 0]) <= half_width)
        assert np.all(np.abs(rel_c[:, 1]) <= half_width)
        radius = np.linalg.norm(world_corners - center_world, axis=1).max()
        assert -rel[2] <= 3.0 * radius / np.tan(fov / 2.0)

    def test_convert_animation_round(self, env):
        so = _mod(env, "scene_operations")
        views = _animate_camera(env)
        assert env.tracker.tracking_target == "CAMERA"

        op = so.PC_OT_ConvertAnimation()
        assert type(op).poll(env.ctx)
        assert op.execute(env.ctx) == {"FINISHED"}
        assert env.tracker.tracking_target == "GEOMETRY"

        # Camera animation is gone; geometry keyed at every frame with
        # the keytypes preserved.
        assert env.keyframes.object_transform_fcurves(env.camera) == []
        gtypes = {}
        for fc in env.keyframes.object_transform_fcurves(env.geometry):
            for kp in fc.keyframe_points:
                gtypes[int(round(kp.co[0]))] = kp.type
        assert set(gtypes) == set(range(N_FRAMES))
        assert gtypes[0] == env.keyframes.USER_KEYFRAME
        assert gtypes[1] == env.keyframes.GENERATED_KEYFRAME

        # The relative modelview at every frame is preserved:
        # const_view @ model_f == view_f @ I  (model was identity).
        # Tolerance is float32-level: the ground-truth poses (and the
        # addon's keyed channels in real Blender) are single precision.
        const_view = _FLIP @ views[0]  # GL view at the freeze frame
        for f in range(N_FRAMES):
            model_f = env.geometry.keyframe_matrices[f]
            assert np.allclose(
                const_view @ model_f, _FLIP @ views[f], atol=1e-4
            ), f

    def test_transform_scene_rigid(self, env):
        so = _mod(env, "scene_operations")
        views = _animate_camera(env)
        env.scene.frame_set(0)

        op = so.PC_OT_TransformScene()
        assert op.reference == "GEOMETRY"  # enum default, first item
        assert op.coords == "WORLD"
        assert type(op).poll(env.ctx)
        assert op.invoke(env.ctx, None) == {"RUNNING_MODAL"}
        assert env.ctx.window_manager.props_dialogs == [op]

        # The dialog synced its fields from the reference object.
        assert np.allclose(
            list(op.location), np.array(env.geometry.matrix_world)[:3, 3]
        )

        # Simulate the user editing the dialog: shift + yaw the geometry.
        cam_before = np.array(env.camera.matrix_world)
        geo_before = np.array(env.geometry.matrix_world)
        op.location = (2.0, -1.0, 0.5)
        op.rotation = (0.0, 0.0, 0.3)
        so._ts_on_transform_changed(op, env.ctx)

        update = np.array(env.geometry.matrix_world) @ np.linalg.inv(
            geo_before
        )
        # Live preview: the camera followed rigidly.
        assert np.allclose(
            np.array(env.camera.matrix_world), update @ cam_before,
            atol=1e-9,
        )

        # Confirm: every camera keyframe is re-posed by the same rigid
        # update (tracking target is CAMERA → the camera holds the keys).
        assert op.execute(env.ctx) == {"FINISHED"}
        for f in range(N_FRAMES):
            world_f = np.linalg.inv(_FLIP @ views[f])
            assert np.allclose(
                env.camera.keyframe_matrices[f], update @ world_f,
                atol=1e-9,
            ), f

    def test_transform_scene_cancel_restores(self, env):
        so = _mod(env, "scene_operations")
        _animate_camera(env)
        env.scene.frame_set(0)
        geo_before = np.array(env.geometry.matrix_world)
        cam_before = np.array(env.camera.matrix_world)

        op = so.PC_OT_TransformScene()
        assert op.invoke(env.ctx, None) == {"RUNNING_MODAL"}
        op.location = (5.0, 5.0, 5.0)
        so._ts_on_transform_changed(op, env.ctx)
        assert not np.allclose(
            np.array(env.geometry.matrix_world), geo_before
        )
        op.cancel(env.ctx)
        assert np.allclose(np.array(env.geometry.matrix_world), geo_before)
        assert np.allclose(np.array(env.camera.matrix_world), cam_before)

    def test_transform_scene_rejects_nonuniform_scale(self, env):
        so = _mod(env, "scene_operations")
        env.geometry.matrix_world = env.mu.Matrix(
            np.diag([1.0, 2.0, 1.0, 1.0])
        )
        op = so.PC_OT_TransformScene()
        assert op.invoke(env.ctx, None) == {"CANCELLED"}
        assert any("Non uniform scale" in m for _, m in op.reports)


class TestTrackerManagement:
    def test_refresh_geometry_rebuilds_mesh(self, env):
        tm = _mod(env, "tracker_management")
        eng = env.core.Trackers.get(env.tracker)
        n0 = len(eng.accel_mesh.inner().triangles)

        # Shrink the mesh in place; refresh must rebuild the accel mesh.
        verts, tris = env.geometry._mesh_arrays
        env.geometry._mesh_arrays = (verts, tris[: len(tris) // 2])
        assert tm.PC_OT_RefreshGeometry.poll(env.ctx)
        assert tm.PC_OT_RefreshGeometry().execute(env.ctx) == {"FINISHED"}
        eng2 = env.core.Trackers.get(env.tracker)
        assert len(eng2.accel_mesh.inner().triangles) == len(tris) // 2 != n0
