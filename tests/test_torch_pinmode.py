"""The port's pin mode against the JAX package's, on the same scenes and
drags, and its two n-pin routes against each other.

Tolerances:
- against JAX (1, 2 and n pins, both transform types): on the host route
  output matrices and intrinsics within 1e-6 absolute (rtol 1e-6 on the
  intrinsics), both running the same float64 host math; on the device
  route (float32: XLA in JAX, plain torch in the port) within 1e-4; the
  12-pin drag with free intrinsics within 1e-4 of the range that JAX's
  own answer spans when the pins are given in other orders (its view
  matrix moves by ~4e-4 under that reassociation alone);
- the host route (float64 numpy) against the device route (the float32
  torch solve, which on a CUDA device is the kernel): matrices within 1e-4;
- the ≤ 3-point intrinsics gate: intrinsics exactly unchanged.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polychase_tpu.engine import camera as JC
from polychase_tpu.engine import pose as JP
from polychase_tpu.engine import pinmode as JPM
from polychase_tpu.engine.geometry import (
    SceneTransformations as JScene,
    TRANSFORM_CAMERA,
    TRANSFORM_MODEL,
)

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine import camera as TC
from polychase_tpu_torch.engine import pinmode as TPM
from polychase_tpu_torch.engine import pose as TP
from polychase_tpu_torch.engine.levmarq import BundleOptions
from polychase_tpu_torch.engine.pnp import (
    PnPOptions,
    normalize_bundle_opts,
    pack_camera_params,
    solve_arrays,
    solve_pnp,
)
from polychase_tpu_torch.engine.pnp_host import solve_pnp_host
from polychase_tpu_torch.kernels import pnp_lm

from synthetic import make_intrinsics, orbit_pose, sample_surface_points
from synthetic import make_sphere_mesh

torch.set_num_threads(1)

JAX_ATOL = 1e-6
ROUTE_ATOL = 1e-4

PINS = {
    1: [[0.1, -0.2, 0.3]],
    2: [[0.4, 0.0, 0.0], [-0.4, 0.0, 0.0]],
    5: [[0.3, 0.3, 0.0], [-0.3, 0.3, 0.1], [-0.3, -0.3, 0.0],
        [0.3, -0.3, -0.1], [0.0, 0.0, 0.2]],
}


@pytest.fixture(scope="module")
def scenes():
    intr = make_intrinsics()
    model = np.eye(4, dtype=np.float32)
    model[:3, 3] = [0.05, -0.02, 0.1]
    j = JScene(model_matrix=jnp.asarray(model),
               view_matrix=JP.pose_rt4x4(orbit_pose(0.0)), intrinsics=intr)
    return j, convert.scene_transformations(j, device="cpu")


def _project(scene, pts):
    mv = (np.asarray(scene.view_matrix, np.float64)
          @ np.asarray(scene.model_matrix, np.float64))
    Xc = pts @ mv[:3, :3].T + mv[:3, 3]
    i = scene.intrinsics
    K = np.array([[float(i.fx), 0, float(i.cx)], [0, float(i.fy), float(i.cy)],
                  [0, 0, 1]])
    p = Xc @ K.T
    return (p[:, :2] / p[:, 2:3]).astype(np.float32)


def _same(got, ref, atol):
    np.testing.assert_allclose(got.model_matrix.numpy(),
                               np.asarray(ref.model_matrix), atol=atol)
    np.testing.assert_allclose(got.view_matrix.numpy(),
                               np.asarray(ref.view_matrix), atol=atol)
    for f in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(float(getattr(got.intrinsics, f)),
                                   float(getattr(ref.intrinsics, f)),
                                   rtol=atol, atol=atol)


def _same_spread(got, refs, atol):
    """Each output of ``got`` within ``atol`` of the range that the
    ``refs`` span."""
    def check(g, rs, rtol=1e-7):
        g, rs = np.asarray(g, np.float64), np.asarray(rs, np.float64)
        lo, hi = rs.min(axis=0), rs.max(axis=0)
        np.testing.assert_array_less(lo - atol - rtol * np.abs(lo), g)
        np.testing.assert_array_less(g, hi + atol + rtol * np.abs(hi))

    check(got.model_matrix.numpy(), [r.model_matrix for r in refs])
    check(got.view_matrix.numpy(), [r.view_matrix for r in refs])
    for f in ("fx", "fy", "cx", "cy"):
        check(float(getattr(got.intrinsics, f)),
              [float(getattr(r.intrinsics, f)) for r in refs], rtol=atol)


def _routes(route, monkeypatch):
    """Force both packages onto one route of the ≥ 3-pin solve: the
    float64 host LM, or the device solve (XLA in JAX, plain torch in the
    port on the CPU); returns the tolerance of the comparison."""
    if route == "host":
        monkeypatch.setattr(TPM, "HOST_PIN_MAX", 1 << 30)
        monkeypatch.setenv("POLYCHASE_HOST_PIN_MAX", str(1 << 30))
        return JAX_ATOL
    monkeypatch.setattr(TPM, "HOST_PIN_MAX", 0)
    monkeypatch.setenv("POLYCHASE_HOST_PIN_MAX", "0")
    return ROUTE_ATOL


@pytest.mark.parametrize("trans_type", [TRANSFORM_MODEL, TRANSFORM_CAMERA])
@pytest.mark.parametrize("n,route", [(1, "host"), (2, "host"), (5, "host"),
                                     (5, "device")])
def test_matches_jax(scenes, monkeypatch, n, route, trans_type):
    jscene, tscene = scenes
    atol = _routes(route, monkeypatch)
    obj = np.asarray(PINS[n], np.float32)
    px0 = _project(jscene, obj)
    idx = n - 1
    target = px0[idx] + np.array([14.0, -9.0], np.float32)
    ref = JPM.find_transformation(obj, jscene, jscene,
                                  JPM.PinUpdate(idx, target), trans_type)
    got = TPM.find_transformation(
        obj, tscene, tscene,
        convert.pin_update(JPM.PinUpdate(idx, target)), trans_type,
        device="cpu")
    _same(got, ref, atol)
    if trans_type == TRANSFORM_CAMERA:
        np.testing.assert_array_equal(got.model_matrix.numpy(),
                                      np.asarray(jscene.model_matrix))
    # The dragged pin moved towards its target.
    px1 = _project(got, obj)
    assert np.linalg.norm(px1[idx] - target) < np.linalg.norm(
        px0[idx] - target)


def _surface_pins(n):
    mesh = make_sphere_mesh()
    pts, normals = sample_surface_points(mesh, np.random.default_rng(5), 4 * n)
    center = np.asarray(JP.pose_center(orbit_pose(0.0)))
    front = np.sum((pts - center) * normals, axis=-1) < 0
    return pts[front][:n]


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("opt", [False, True])
def test_free_intrinsics_matches_jax(scenes, monkeypatch, opt, route):
    jscene, tscene = scenes
    atol = _routes(route, monkeypatch)
    obj = _surface_pins(12)
    target = _project(jscene, obj)[3] + np.array([6.0, 4.0], np.float32)
    got = TPM.find_transformation(obj, tscene, tscene,
                                  TPM.PinUpdate(3, target), TRANSFORM_CAMERA,
                                  opt, opt, device="cpu")
    # The float32 solves reassociate their sums with the order of the pins,
    # so the device route is held against JAX's answers for the pins in
    # their order and in four shuffled ones (the same drag every time).
    orders = [np.arange(len(obj))] + [
        np.random.default_rng(s).permutation(len(obj))
        for s in range(1, 5 if route == "device" else 1)]
    refs = [JPM.find_transformation(
        obj[p], jscene, jscene,
        JPM.PinUpdate(int(np.nonzero(p == 3)[0][0]), target),
        TRANSFORM_CAMERA, opt, opt) for p in orders]
    if route == "host":
        _same(got, refs[0], atol)
    else:
        _same_spread(got, refs, atol)


@pytest.mark.parametrize("trans_type", [TRANSFORM_MODEL, TRANSFORM_CAMERA])
def test_host_route_matches_device_route(scenes, monkeypatch, trans_type):
    _, tscene = scenes
    obj = _surface_pins(96)
    target = _project(tscene, obj)[7] + np.array([8.0, -5.0], np.float32)
    upd = TPM.PinUpdate(7, target)
    monkeypatch.setattr(TPM, "HOST_PIN_MAX", len(obj) - 1)
    before = pnp_lm.launches
    device = TPM.find_transformation(obj, tscene, tscene, upd, trans_type,
                                     device="cpu")
    assert pnp_lm.launches == before  # CPU tensors take the plain version
    monkeypatch.setattr(TPM, "HOST_PIN_MAX", 1 << 30)
    host = TPM.find_transformation(obj, tscene, tscene, upd, trans_type,
                                   device="cpu")
    np.testing.assert_allclose(device.model_matrix.numpy(),
                               host.model_matrix.numpy(), atol=ROUTE_ATOL)
    np.testing.assert_allclose(device.view_matrix.numpy(),
                               host.view_matrix.numpy(), atol=ROUTE_ATOL)


def test_exact_recovery(scenes):
    """Dragging each pin in turn to the projections of a rotated model
    recovers it (test_pinmode.py)."""
    _, tscene = scenes
    obj = np.array([[0.3, 0.3, 0.0], [-0.3, 0.3, 0.1], [-0.3, -0.3, 0.0],
                    [0.3, -0.3, -0.1], [0.0, 0.2, 0.25], [0.1, -0.1, 0.2]],
                   np.float32)
    ang = 0.06
    Rz = np.eye(4, dtype=np.float32)
    Rz[:2, :2] = [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
    goal = TPM.SceneTransformations(torch.as_tensor(Rz @ tscene.model_matrix
                                                    .numpy()),
                                    tscene.view_matrix, tscene.intrinsics)
    px_goal = _project(goal, obj)
    cur = tscene
    for _ in range(3):
        for i in range(len(obj)):
            cur = TPM.find_transformation(obj, cur, cur,
                                          TPM.PinUpdate(i, px_goal[i]),
                                          TRANSFORM_MODEL, device="cpu")
    np.testing.assert_allclose(_project(cur, obj), px_goal, atol=0.5)


def test_pin_idx_out_of_range(scenes):
    _, tscene = scenes
    with pytest.raises(ValueError):
        TPM.find_transformation(np.zeros((2, 3), np.float32), tscene, tscene,
                                TPM.PinUpdate(5, np.zeros(2, np.float32)),
                                TRANSFORM_MODEL, device="cpu")
    with pytest.raises(ValueError):
        TPM.find_transformation(np.zeros((2, 3), np.float32), tscene, tscene,
                                TPM.PinUpdate(0, np.zeros(2, np.float32)),
                                TRANSFORM_MODEL, device=None)


def test_intrinsics_gate_with_three_points():
    """≤ 3 points leave the intrinsics untouched with the optimization
    flags on: three pins through both routes, and three valid points of
    eight in the batched solve."""
    rng = np.random.default_rng(0)
    intr = TC.Intrinsics.create(600.0, 600.0, 320.0, 240.0, 1.0, 640.0,
                                480.0, TC.OPENCV, device="cpu")
    pose = TP.Pose(torch.tensor([1.0, 0, 0, 0]), torch.tensor([0.0, 0, 3.0]))
    cam = TC.CameraState(intr, pose)
    X = rng.normal(0, 0.5, (8, 3)).astype(np.float32)
    X[:, 2] = 0.0
    proj = TC.project(intr, TP.pose_apply(pose, torch.as_tensor(X))).numpy()
    x = proj + rng.normal(0, 0.5, proj.shape).astype(np.float32)
    opts = PnPOptions(optimize_focal_length=True,
                      optimize_principal_point=True)
    want = [600.0, 600.0, 320.0, 240.0]
    for res in (solve_pnp_host(X[:3], x[:3], cam, opts),
                solve_pnp(X[:3], x[:3], cam, opts, device="cpu")):
        i = res.camera.intrinsics
        assert [float(i.fx), float(i.fy), float(i.cx), float(i.cy)] == want
    mask = np.zeros(8, bool)
    mask[:3] = True
    vec = solve_arrays(
        torch.as_tensor(X)[None], torch.as_tensor(x)[None],
        torch.as_tensor(mask.astype(np.float32))[None],
        torch.as_tensor(mask)[None],
        torch.as_tensor(pack_camera_params(cam, 12.0))[None],
        opt_f=True, opt_pp=True,
        opts=normalize_bundle_opts(BundleOptions()),
    )[0].numpy()
    np.testing.assert_array_equal(vec[7:11], want)


def test_host_solve_matches_jax_host_solve():
    """``solve_pnp_host`` against the JAX package's on a 16-point scene with
    free intrinsics and Huber loss."""
    from polychase_tpu.engine.pnp import PnPOptions as JOpts
    from polychase_tpu.engine.pnp_host import solve_pnp_host as jax_host

    rng = np.random.default_rng(1)
    X = rng.normal(0, 0.5, (16, 3)).astype(np.float32)
    X[:, 2] += 3.0
    x = (X[:, :2] / X[:, 2:3] * 600 + [320, 240]
         + rng.normal(0, 0.5, (16, 2))).astype(np.float32)
    jintr = JC.Intrinsics.create(640.0, 640.0, 330.0, 235.0, 1.0, 640.0,
                                 480.0, JC.OPENCV)
    q0 = np.array([0.999, 0.02, -0.03, 0.01], np.float32)
    q0 /= np.linalg.norm(q0)
    jcam = JC.CameraState(jintr, JP.Pose(q0, np.array([0.05, 0, 0.1],
                                                      np.float32)))
    jopts = JOpts(optimize_focal_length=True, optimize_principal_point=True)
    ref = jax_host(X, x, jcam, jopts)
    got = solve_pnp_host(
        X, x, convert.camera_state(jcam, device="cpu"),
        PnPOptions(optimize_focal_length=True, optimize_principal_point=True))
    np.testing.assert_array_equal(got.camera.pose.q.numpy(),
                                  np.asarray(ref.camera.pose.q))
    np.testing.assert_array_equal(got.camera.pose.t.numpy(),
                                  np.asarray(ref.camera.pose.t))
    assert int(got.stats.iterations) == int(ref.stats.iterations)
    assert got.inlier_ratio == pytest.approx(float(ref.inlier_ratio))
