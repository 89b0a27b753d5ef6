"""Pose, camera and geometry functions of the port against the JAX
package's, on the same numpy-seeded inputs, atol 1e-6 (f32 ops in the same
order; the tolerance covers the libraries' own roundings); the helpers that
only refine and pin mode use within 1e-6 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polychase_tpu.engine import camera as JC
from polychase_tpu.engine import pose as JP
from polychase_tpu.engine.geometry import Mesh as JMesh, set_mask_bits

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine import camera as TC
from polychase_tpu_torch.engine import pose as TP
from polychase_tpu_torch.engine.geometry import Mesh as TMesh

torch.set_num_threads(1)

ATOL = 1e-6


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _vecs(rng, n=64, scale=1.0):
    return (rng.normal(size=(n, 3)) * scale).astype(np.float32)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(
        got.numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(ref), atol=atol, rtol=0,
    )


def T(a):
    return torch.as_tensor(np.array(a))


J = jnp.asarray


@pytest.mark.parametrize("fn", ["quat_mul", "quat_rotate", "quat_step_post"])
def test_quaternion_binary(rng, fn):
    a = _quats(rng)
    b = _quats(rng) if fn == "quat_mul" else _vecs(rng, scale=0.3)
    if fn == "quat_step_post":
        b[:8] *= 1e-7  # the Taylor branch near zero
    _close(getattr(TP, fn)(T(a), T(b)), getattr(JP, fn)(J(a), J(b)))


@pytest.mark.parametrize(
    "fn", ["quat_to_mat", "quat_conj", "quat_normalize", "quat_exp", "skew"]
)
def test_quaternion_unary(rng, fn):
    x = _quats(rng) if fn != "quat_exp" and fn != "skew" else _vecs(rng, 64, .5)
    if fn == "quat_exp":
        x[:8] *= 1e-7
    _close(getattr(TP, fn)(T(x)), getattr(JP, fn)(J(x)))


def test_mat_to_quat_all_branches(rng):
    """Rotations whose dominant Shepperd term is each of w, x, y, z."""
    q = _quats(rng, 256)
    for k in range(4):
        q[k * 8:(k + 1) * 8, k] = 5.0
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    m = np.asarray(JP.quat_to_mat(J(q)))
    _close(TP.mat_to_quat(T(m)), JP.mat_to_quat(J(m)))


def test_pose_ops(rng):
    q, t, p = _quats(rng), _vecs(rng), _vecs(rng, scale=3.0)
    tp, jp = TP.Pose(T(q), T(t)), JP.Pose(J(q), J(t))
    _close(TP.pose_apply(tp, T(p)), JP.pose_apply(jp, J(p)), 1e-5)
    _close(TP.pose_derotate(tp, T(p)), JP.pose_derotate(jp, J(p)), 1e-5)
    _close(TP.pose_center(tp), JP.pose_center(jp))
    m = np.asarray(JP.pose_rt4x4(jp))
    back_t, back_j = TP.pose_from_rt(T(m)), JP.pose_from_rt(J(m))
    _close(back_t.q, back_j.q)
    _close(back_t.t, back_j.t)


def test_jacobian_ops(rng):
    q, t, p = _quats(rng), _vecs(rng), _vecs(rng, scale=3.0)
    R = np.asarray(JP.quat_to_mat(J(q)))
    for got, ref in zip(TP.apply_with_jac(T(R), T(t), T(p)),
                        JP.apply_with_jac(J(R), J(t), J(p))):
        _close(got, ref, 1e-5)


def test_host_helpers(rng):
    q = _quats(rng, 8)
    for qi in q:
        np.testing.assert_allclose(TP.quat_to_mat_np(qi), JP.quat_to_mat_np(qi))
        m = JP.quat_to_mat_np(qi)
        np.testing.assert_allclose(TP.mat_to_quat_np(m), JP.mat_to_quat_np(m))
    jp = JP.Pose(J(q[0]), J(_vecs(rng, 1)[0]))
    np.testing.assert_allclose(
        TP.pose_rt4x4_np(convert.pose(jp, device="cpu")), JP.pose_rt4x4_np(jp)
    )


def _intrinsics(convention):
    sgn = 1.0 if convention == JC.OPENCV else -1.0
    ji = JC.Intrinsics.create(sgn * 900.0, sgn * 880.0, 655.0, 349.0,
                              1.0227, 1280, 720, convention)
    return ji, convert.intrinsics(ji, device="cpu")


@pytest.mark.parametrize("convention", [JC.OPENGL, JC.OPENCV])
def test_camera_project_unproject(rng, convention):
    ji, ti = _intrinsics(convention)
    x = _vecs(rng, 128, 2.0)
    x[:, 2] = np.abs(x[:, 2]) + 1.0
    x[:, 2] *= float(ji.sign)
    _close(TC.project(ti, T(x)), JC.project(ji, J(x)), 1e-4)
    for got, ref in zip(TC.project_with_jac(ti, T(x)),
                        JC.project_with_jac(ji, J(x))):
        _close(got, ref, 1e-4)
    px = rng.uniform(0, 1280, size=(128, 2)).astype(np.float32)
    _close(TC.unproject(ti, T(px)), JC.unproject(ji, J(px)))
    _close(TC.is_behind(ti, T(-x)), JC.is_behind(ji, J(-x)))
    assert ti.convention == ji.convention


@pytest.mark.parametrize("convention", [JC.OPENGL, JC.OPENCV])
def test_intrinsics_bounds(convention):
    ji, ti = _intrinsics(convention)
    tb, jb = TC.intrinsics_bounds(ti), JC.intrinsics_bounds(ji)
    for f in ("f_low", "f_high", "cx_low", "cx_high", "cy_low", "cy_high"):
        _close(getattr(tb, f), getattr(jb, f), 1e-3)


def test_mesh_mask_bits(rng):
    """Packed u32 mask words: the bit test, the corners and the round trip
    to the reference's uint32 layout, with the top bit of a word set."""
    n_tris = 200
    verts = rng.normal(size=(90, 3)).astype(np.float32)
    tris = rng.integers(0, 90, size=(n_tris, 3)).astype(np.uint32)
    masked = np.zeros(8, np.uint32)
    for i in (0, 31, 63, 64, 130, 199):
        masked = set_mask_bits(masked, i, "mask")
    jm = JMesh.create(verts, tris, masked)
    tm = convert.mesh(jm, device="cpu")
    ids = np.arange(n_tris)
    np.testing.assert_array_equal(
        tm.is_triangle_masked(T(ids)).numpy(),
        np.asarray(jm.is_triangle_masked(J(ids.astype(np.uint32)))),
    )
    for got, ref in zip(tm.triangle_corners(), jm.triangle_corners()):
        _close(got, ref, 0.0)
    np.testing.assert_array_equal(tm.to_numpy_mask(), np.asarray(jm.masked_triangles))
    _close(tm.bbox_min, jm.bbox.pmin, 0.0)
    _close(tm.bbox_max, jm.bbox.pmax, 0.0)
    empty = TMesh.create(verts, tris, device="cpu")
    assert not empty.is_triangle_masked(T(ids)).any()


def test_trajectory_and_options_carry_across(rng):
    """convert.camera_trajectory keeps filled and empty frames; the bundle
    options keep every field the solvers read."""
    from polychase_tpu.engine.levmarq import BundleOptions as JB
    from polychase_tpu.engine.trajectory import CameraTrajectory as JTraj

    ji, _ = _intrinsics(JC.OPENCV)
    jt = JTraj(5, 4)
    q = _quats(rng, 2)
    jt.set(5, JC.CameraState(ji, JP.Pose(J(q[0]), J(_vecs(rng, 1)[0]))))
    jt.set(7, JC.CameraState(ji, JP.Pose(J(q[1]), J(_vecs(rng, 1)[0]))))
    tt = convert.camera_trajectory(jt, device="cpu")
    assert (tt.first_frame, tt.last_frame) == (jt.first_frame, jt.last_frame)
    for f in range(5, 9):
        assert tt.is_frame_filled(f) == jt.is_frame_filled(f)
        if jt.is_frame_filled(f):
            _close(tt.get(f).pose.q, jt.get(f).pose.q, 0.0)
            _close(tt.get(f).intrinsics.fy, jt.get(f).intrinsics.fy, 0.0)
    jb = JB(max_iterations=7, loss_type=2, loss_scale=2.5, function_tol=1e-5)
    tb = convert.bundle_options(jb)
    for f in ("max_iterations", "loss_type", "loss_scale", "gradient_tol",
              "step_tol", "initial_lambda", "min_lambda", "max_lambda",
              "function_tol"):
        assert getattr(tb, f) == getattr(jb, f)


def test_explicit_device_required():
    with pytest.raises(ValueError):
        TC.Intrinsics.create(1, 1, 0, 0, 1, 2, 2, device=None)


# ---------------------------------------------------------------------------
# Helpers that refine and pin mode use: within 1e-6 relative (to the
# largest magnitude of each output)
# ---------------------------------------------------------------------------

RTOL = 1e-6


def _rel_close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-30)
    assert float(np.abs(got - ref).max()) <= RTOL * scale


def test_pose_helpers(rng):
    q, t, p = _quats(rng), _vecs(rng), _vecs(rng, scale=3.0)
    tp, jp = TP.Pose(T(q), T(t)), JP.Pose(J(q), J(t))
    _rel_close(TP.pose_rotate(tp, T(p)), JP.pose_rotate(jp, J(p)))
    ti, ji = TP.pose_inverse(tp), JP.pose_inverse(jp)
    _rel_close(ti.q, ji.q)
    _rel_close(ti.t, ji.t)
    _rel_close(TP.pose_rt4x4(tp), JP.pose_rt4x4(jp))
    m = np.asarray(JP.pose_rt4x4(jp)).copy()
    m[..., :3, :3] *= rng.uniform(0.5, 2.0, (64, 1, 3)).astype(np.float32)
    ts, js = TP.pose_from_srt(T(m)), JP.pose_from_srt(J(m))
    _rel_close(ts.q, js.q)
    _rel_close(ts.t, js.t)
    R = np.asarray(JP.quat_to_mat(J(q)))
    for got, ref in zip(TP.derotate_with_jac(T(R), T(p)),
                        JP.derotate_with_jac(J(R), J(p))):
        _rel_close(got, ref)
    for got, ref in zip(TP.center_with_jac(T(R), T(t)),
                        JP.center_with_jac(J(R), J(t))):
        _rel_close(got, ref)


@pytest.mark.parametrize("convention", [JC.OPENGL, JC.OPENCV])
def test_camera_helpers(rng, convention):
    ji, ti = _intrinsics(convention)
    px = rng.uniform(0, 1280, size=(128, 2)).astype(np.float32)
    for got, ref in zip(TC.unproject_with_jac(ti, T(px)),
                        JC.unproject_with_jac(ji, J(px))):
        _rel_close(got, ref)
    _rel_close(TC.proj_matrix_3x3(ti), JC.proj_matrix_3x3(ji))
    _rel_close(TC.proj_matrix_4x4(ti), JC.proj_matrix_4x4(ji))
    np.testing.assert_allclose(TC.proj_matrix_4x4_np(ti),
                               JC.proj_matrix_4x4_np(ji), rtol=RTOL)
    tr, jr = TC.rescale(ti, 0.5), JC.rescale(ji, 0.5)
    for f in ("fx", "fy", "cx", "cy", "aspect_ratio", "width", "sign"):
        _rel_close(getattr(tr, f), getattr(jr, f))


def test_geometry_helpers(rng):
    from polychase_tpu.engine import geometry as JG
    from polychase_tpu_torch.engine import geometry as TG

    assert (TG.TRANSFORM_CAMERA, TG.TRANSFORM_MODEL) == (
        JG.TRANSFORM_CAMERA, JG.TRANSFORM_MODEL)
    words = np.zeros(8, np.uint32)
    for i, op in ((3, "mask"), (31, "mask"), (64, "toggle"), (3, "unmask"),
                  (200, "toggle"), (200, "toggle"), (255, "mask")):
        got = TG.set_mask_bits(words, i, op)
        np.testing.assert_array_equal(got, JG.set_mask_bits(words, i, op))
        words = got
    with pytest.raises(ValueError):
        TG.set_mask_bits(words, 1, "flip")

    lo, hi = np.array([-1.0, -0.5, -2.0], np.float32), np.ones(3, np.float32)
    p3 = rng.uniform(-2.5, 1.5, (256, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TG.Bbox3(T(lo), T(hi)).contains(T(p3)).numpy(),
        np.asarray(JG.Bbox3(J(lo), J(hi)).contains(J(p3))))
    np.testing.assert_array_equal(
        TG.Bbox2(T(lo[:2]), T(hi[:2])).contains(T(p3[:, :2])).numpy(),
        np.asarray(JG.Bbox2(J(lo[:2]), J(hi[:2])).contains(J(p3[:, :2]))))

    ji, _ = _intrinsics(JC.OPENCV)
    pose = JP.Pose(J(_quats(rng, 1)[0]), J(np.array([0.1, -0.2, 6.0],
                                                    np.float32)))
    mat = np.asarray(JC.proj_matrix_4x4(ji) @ JP.pose_rt4x4(pose))
    _rel_close(TG.transform_points(T(mat), T(p3)),
               JG.transform_points(J(mat), J(p3)))
    tb = TG.transform_bbox(TG.Bbox3(T(lo), T(hi)), T(mat))
    jb = JG.transform_bbox(JG.Bbox3(J(lo), J(hi)), J(mat))
    _rel_close(tb.pmin, jb.pmin)
    _rel_close(tb.pmax, jb.pmax)
    verts = rng.normal(size=(30, 3)).astype(np.float32)
    tris = rng.integers(0, 30, (40, 3)).astype(np.uint32)
    tm = TG.Mesh.create(verts, tris, device="cpu")
    _rel_close(tm.bbox.pmin, JG.Mesh.create(verts, tris).bbox.pmin)
