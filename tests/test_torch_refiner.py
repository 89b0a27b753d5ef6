"""The port's refine (bundle adjustment) against the JAX package's, on the
same seeded flow DBs and trajectories.  Both run on the CPU: JAX its XLA
path, the port its plain torch one.

Tolerances:
- ``damped_block_tridiag_solve``: steps within rtol 1e-4 of the largest
  component, against the JAX banded solve and the port's dense solve, with
  ``ok`` equal;
- ``RefinerData``: every valid entry equal;
- one LM step's pieces on the same params and prims: ``total_cost``, the
  normal equations and ``try_lm_step``'s five scalars within 1e-4 relative;
- whole refines: test_refiner.py's ground-truth bars (rotation 1e-3 rad,
  translation 2.5e-3), anchors untouched to the bit, the final cost within
  1e-3 relative of JAX's on the same DB, and the poses within 5e-4 of
  JAX's (test_band_solve.py's banded-vs-dense tolerance).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from polychase_tpu.engine import camera as JC
from polychase_tpu.engine import pose as JP
from polychase_tpu.engine import refiner as JR
from polychase_tpu.engine.levmarq import (
    BundleOptions,
    CAUCHY,
    TRIVIAL,
    damped_block_tridiag_solve as jax_band_solve,
)
from polychase_tpu.engine.trajectory import CameraTrajectory as JTraj
from polychase_tpu.io.database import Database

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine import camera as TC
from polychase_tpu_torch.engine import levmarq as TL
from polychase_tpu_torch.engine import refiner as TR
from polychase_tpu_torch.engine.trajectory import CameraTrajectory

from synthetic import (
    make_intrinsics,
    make_sphere_mesh,
    orbit_pose,
    project_points,
    sample_surface_points,
    visible_from,
)
from test_refiner import perturbed_traj
from test_tracker import build_flow_db, pose_errors

torch.set_num_threads(1)

SOLVE_RTOL = 1e-4
STEP_RTOL = 1e-4
COST_RTOL = 1e-3
POSE_ATOL = 5e-4
ROT_GT, T_GT = 1e-3, 2.5e-3
EYE = np.eye(4, dtype=np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# The block-tridiagonal solve
# ---------------------------------------------------------------------------


def _band_system(rng, nb, bs, kind):
    n = nb * bs
    A = np.zeros((n, n))
    for i in range(nb):
        Q = rng.normal(0, 1, (bs, bs))
        A[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] = Q @ Q.T + 5 * np.eye(bs)
        if i + 1 < nb:
            E = rng.normal(0, 0.3, (bs, bs))
            A[(i + 1) * bs:(i + 2) * bs, i * bs:(i + 1) * bs] = E
            A[i * bs:(i + 1) * bs, (i + 1) * bs:(i + 2) * bs] = E.T
    b = rng.normal(0, 1, n)
    if kind == "anchors":  # anchored cameras: empty first and last blocks
        for s in (slice(0, bs), slice(n - bs, n)):
            A[s] = 0.0
            A[:, s] = 0.0
            b[s] = 0.0
    if kind == "indefinite":  # the second block cannot be factored
        s = slice(bs, 2 * bs)
        A[s, s] = np.ones((bs, bs)) * 4.0 - 3.0 * np.eye(bs)
    return A.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("kind", ["plain", "anchors", "indefinite"])
@pytest.mark.parametrize("nb,bs", [(6, 12), (7, 18), (8, 15)])
@pytest.mark.parametrize("lam", [1e-5, 1e-2, 1.0])
def test_banded_solve(nb, bs, lam, kind):
    rng = np.random.default_rng(nb * 100 + bs)
    A, b = _band_system(rng, nb, bs, kind)
    ref, ref_ok = jax_band_solve(jnp.asarray(A), jnp.asarray(b),
                                 jnp.float32(lam), nb=nb, bs=bs)
    got, ok = TL.damped_block_tridiag_solve(torch.as_tensor(A),
                                            torch.as_tensor(b), lam,
                                            nb=nb, bs=bs)
    dense, dense_ok = TL.damped_cholesky_solve(
        torch.as_tensor(A)[None], torch.as_tensor(b)[None],
        torch.tensor([lam], dtype=torch.float32))
    assert bool(ok) == bool(ref_ok) == bool(dense_ok[0]) == (
        kind != "indefinite")
    if kind == "indefinite":
        assert not got.any()
        return
    assert _rel(got.numpy(), ref) < SOLVE_RTOL
    assert _rel(got.numpy(), dense[0].numpy()) < SOLVE_RTOL


def test_banded_solve_rejects_wrong_shape():
    with pytest.raises(ValueError):
        TL.damped_block_tridiag_solve(torch.zeros(10, 10), torch.zeros(10),
                                      1e-3, nb=3, bs=4)


# ---------------------------------------------------------------------------
# Shared scenes: the JAX runs and DBs are made once per module
# ---------------------------------------------------------------------------


def _noisy_db(db_path, mesh, intr, poses, rng, skips, n_points, noise):
    """test_band_solve.py's DB: each frame's own visible surface points,
    their flows along ``skips`` with N(0, ``noise``) px on the targets."""
    n = len(poses)
    db = Database(db_path)
    pts3d = {}
    for i in range(n):
        pts, normals = sample_surface_points(mesh, rng, n_points)
        cam = JC.CameraState(intr, poses[i])
        px, vis = project_points(cam, pts)
        vis &= visible_from(cam, pts, normals)
        db.write_keypoints(i, px[vis])
        pts3d[i] = pts[vis]
    for i in range(n):
        for skip in skips:
            j = i + skip
            if not 0 <= j < n:
                continue
            proj, ok = project_points(JC.CameraState(intr, poses[j]),
                                      pts3d[i])
            idx = np.nonzero(ok)[0].astype(np.uint32)
            db.write_image_pair_flow(
                i, j, idx,
                proj[ok] + rng.normal(0, noise, (idx.size, 2)).astype(
                    np.float32),
                np.zeros(idx.size, np.float32),
            )
    db.close()


@pytest.fixture(scope="module")
def scene10(tmp_path_factory):
    """test_refiner.py's 10-frame orbit and perturbed trajectory (rotation
    0.01 rad, translation 0.02), over a DB with 0.25 px flow noise so that
    the final cost stays off zero and can be compared."""
    rng = np.random.default_rng(0)
    mesh, intr = make_sphere_mesh(), make_intrinsics()
    n = 10
    poses = [orbit_pose(0.05 * t) for t in range(n)]
    db_path = str(tmp_path_factory.mktemp("scene10") / "flow.db")
    _noisy_db(db_path, mesh, intr, poses, rng, (-8, -4, -2, -1, 1, 2, 4, 8),
              300, 0.25)
    traj = perturbed_traj(poses, intr, rng)
    return dict(mesh=mesh, intr=intr, poses=poses, db=db_path, traj=traj)


def _copy_jax_traj(traj):
    out = JTraj(traj.first_frame, traj.count)
    for f in range(traj.first_frame, traj.last_frame + 1):
        out.set(f, traj.get(f))
    return out


def _run_jax(scene, **kw):
    traj = _copy_jax_traj(scene["traj"])
    ups = []
    JR.refine_trajectory(scene["db"], traj, EYE, scene["mesh"],
                         callback=lambda u: ups.append(u) or True,
                         device_mesh=False, **kw)
    return traj, ups


def _run_port(scene, **kw):
    traj = convert.camera_trajectory(scene["traj"], device="cpu")
    if "bundle_opts" in kw:
        kw["bundle_opts"] = convert.bundle_options(kw["bundle_opts"])
    ups = []
    TR.refine_trajectory(scene["db"], traj, EYE,
                         convert.mesh(scene["mesh"], device="cpu"),
                         callback=lambda u: ups.append(u) or True,
                         device="cpu", **kw)
    return traj, ups


@pytest.fixture(scope="module")
def refined10(scene10):
    kw = dict(bundle_opts=BundleOptions(loss_type=CAUCHY, loss_scale=1.0))
    return _run_jax(scene10, **kw), _run_port(scene10, **kw)


def _states(traj):
    return [(np.asarray(traj.get(f).pose.q, np.float64),
             np.asarray(traj.get(f).pose.t, np.float64))
            for f in range(traj.first_frame, traj.last_frame + 1)]


def test_refine_matches_jax_and_truth(scene10, refined10):
    (jtraj, jups), (ttraj, tups) = refined10
    poses, start = scene10["poses"], scene10["traj"]
    n = len(poses)
    for i, ((qj, tj), (qt, tt)) in enumerate(zip(_states(jtraj),
                                                 _states(ttraj))):
        if i in (0, n - 1):
            # Anchors are untouched to the bit.
            np.testing.assert_array_equal(
                ttraj.get(i).pose.t.numpy(), np.asarray(start.get(i).pose.t))
            np.testing.assert_array_equal(
                ttraj.get(i).pose.q.numpy(), np.asarray(start.get(i).pose.q))
            continue
        rot, terr = pose_errors(JP.Pose(qt, tt), poses[i])
        assert rot < ROT_GT and terr < T_GT, (i, rot, terr)
        np.testing.assert_allclose(tt, tj, atol=POSE_ATOL)
        np.testing.assert_allclose(qt, qj, atol=POSE_ATOL)
    np.testing.assert_allclose(float(tups[-1].stats.cost),
                               float(jups[-1].stats.cost), rtol=COST_RTOL)
    assert float(tups[-1].stats.cost) < float(tups[-1].stats.initial_cost)
    assert "Cost" in tups[0].message


def test_refiner_data_matches_jax(scene10):
    db = Database(scene10["db"])
    try:
        ref = JR.build_refiner_data(db, scene10["traj"], scene10["mesh"], EYE)
        got = TR.build_refiner_data(
            db, convert.camera_trajectory(scene10["traj"], device="cpu"),
            convert.mesh(scene10["mesh"], device="cpu"), EYE, device="cpu")
    finally:
        db.close()
    a, b = convert.refiner_entries(got), convert.refiner_entries(ref)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], list):
            assert len(a[k]) == len(b[k]), k
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(a["src_frame"]) > 0


def _pieces(scene, ppc, stale):
    """The same RefinerData, params and prims in both packages; with
    ``stale`` the params move after the prim refresh, so some rays leave
    their cached triangle."""
    db = Database(scene["db"])
    try:
        jdata = JR.build_refiner_data(db, scene["traj"], scene["mesh"], EYE)
    finally:
        db.close()
    jparams = JR.traj_to_params(scene["traj"])
    model = jnp.eye(4)
    jprims = JR.refresh_prims(jparams, jdata, scene["mesh"], model)
    if stale:
        rng = np.random.default_rng(3)
        jparams = jparams._replace(
            t=jparams.t + jnp.asarray(rng.normal(0, 0.03, jparams.t.shape),
                                      jnp.float32))
    tdata = convert.refiner_data(jdata, device="cpu")
    tparams = convert.traj_params(jparams, device="cpu")
    tprims = torch.as_tensor(np.asarray(jprims).astype(np.int64))
    tmesh = convert.mesh(scene["mesh"], device="cpu")
    return (jdata, jparams, jprims, scene["mesh"].triangle_corners(), model,
            tdata, tparams, tprims, tmesh.triangle_corners(), torch.eye(4))


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("ppc", [6, 9])
def test_lm_step_pieces_match_jax(scene10, ppc, stale):
    (jdata, jparams, jprims, jtri, jm, tdata, tparams, tprims, ttri,
     tm) = _pieces(scene10, ppc, stale)
    opt_f = ppc == 9
    scale = 1.0
    jcost = JR.total_cost(jparams, jdata, jprims, jtri, jm, jm,
                          jnp.float32(scale), loss_type=CAUCHY)
    tcost = TR.total_cost(tparams, tdata, tprims, ttri, tm, tm, scale,
                          loss_type=CAUCHY)
    assert _rel(float(tcost), float(jcost)) < STEP_RTOL

    # The cost's validity is the Jacobians' plus the bounded triangle.
    args = (tparams, tdata, tprims, ttri, tm, tm)
    _, v_cost, _, _ = TR._edge_eval(*args, False, False, False)
    _, v_jac, _, _ = TR._edge_eval(*args, True, opt_f, False)
    jv_cost = JR._edge_eval(jparams, jdata, jprims, jtri, jm, jm, False,
                            False, False)[1]
    np.testing.assert_array_equal(v_cost.numpy(), np.asarray(jv_cost))
    assert not (v_cost & ~v_jac).any()
    if stale:
        assert (v_jac & ~v_cost).any()

    kw = dict(loss_type=CAUCHY, opt_f=opt_f, opt_pp=False, ppc=ppc)
    jJtJ, jJtr = JR.build_normal_equations(
        jparams, jdata, jprims, jtri, jm, jm, jnp.float32(scale), **kw)
    tJtJ, tJtr = TR.build_normal_equations(
        tparams, tdata, tprims, ttri, tm, tm, scale, **kw)
    assert _rel(tJtJ.numpy(), jJtJ) < STEP_RTOL
    assert _rel(tJtr.numpy(), jJtr) < STEP_RTOL

    intr0 = scene10["traj"].get(0).intrinsics
    jb = JC.intrinsics_bounds(intr0)
    tb = TC.intrinsics_bounds(convert.intrinsics(intr0, device="cpu"))
    lam = 1e-3
    _, jvec = JR.try_lm_step(jJtJ, jJtr, jparams, jdata, jprims, jtri, jm, jm,
                             jnp.float32(scale), jnp.float32(lam), jb, **kw)
    # The same normal equations into both: with a free focal length the
    # system is ill-conditioned, and the step would carry the builds'
    # last-bit differences over the tolerance.
    _, tvec = TR.try_lm_step(torch.as_tensor(np.array(jJtJ)),
                             torch.as_tensor(np.array(jJtr)), tparams,
                             tdata, tprims, ttri, tm, tm, scale, lam, tb,
                             **kw)
    jvec, tvec = np.asarray(jvec), tvec.numpy()
    assert tvec[1] == jvec[1] == 1.0
    for i in (0, 2, 3, 4):
        assert _rel(tvec[i], jvec[i]) < STEP_RTOL, (i, tvec, jvec)


def test_callback_count_and_cancel(scene10):
    """test_refiner.py's callback contract, and a cancel after the second
    report returns JAX's trajectory at that point."""
    def run(cancel_after, port):
        n = [0]

        def cb(u):
            n[0] += 1
            assert u.stats is not None
            return n[0] < cancel_after

        if port:
            traj = convert.camera_trajectory(scene10["traj"], device="cpu")
            TR.refine_trajectory(scene10["db"], traj, EYE,
                                 convert.mesh(scene10["mesh"], device="cpu"),
                                 callback=cb, device="cpu")
        else:
            traj = _copy_jax_traj(scene10["traj"])
            JR.refine_trajectory(scene10["db"], traj, EYE, scene10["mesh"],
                                 callback=cb, device_mesh=False)
        return traj, n[0]

    traj, calls = run(3, True)
    assert 3 <= calls <= 4
    for cancel_after in (1, 2):
        got, _ = run(cancel_after, True)
        ref, _ = run(cancel_after, False)
        for (qg, tg), (qr, tr) in zip(_states(got), _states(ref)):
            np.testing.assert_allclose(tg, tr, atol=POSE_ATOL)
            np.testing.assert_allclose(qg, qr, atol=POSE_ATOL)


def test_one_device_read_per_iteration(scene10, monkeypatch):
    reads = []
    real = TR._read_scalars
    monkeypatch.setattr(TR, "_read_scalars",
                        lambda v: reads.append(v.numel()) or real(v))
    _, ups = _run_port(scene10)
    iters = int(ups[-1].stats.iterations)
    assert iters >= 2
    assert iters <= len(reads) <= iters + 1


@pytest.mark.parametrize("which", ["focal", "principal_point"])
def test_refine_recovers_intrinsics(tmp_path, which):
    """test_refiner.py's intrinsics recovery on an exact f = 600 clip: a
    focal of 650 on the middle frames comes back within 5 px, a principal
    point off by (12, -9) px within 2 px."""
    rng = np.random.default_rng(0)
    mesh, intr = make_sphere_mesh(), make_intrinsics(f=600.0)
    n = 8
    poses = [orbit_pose(0.06 * t) for t in range(n)]
    db_path = str(tmp_path / "flow.db")
    build_flow_db(db_path, mesh, intr, poses, rng, n_points=500)
    if which == "focal":
        wrong = intr._replace(fx=jnp.float32(650.0), fy=jnp.float32(650.0))
    else:
        wrong = intr._replace(cx=intr.cx + jnp.float32(12.0),
                              cy=intr.cy - jnp.float32(9.0))
    jt = JTraj(0, n)
    for i, p in enumerate(poses):
        jt.set(i, JC.CameraState(intr if i in (0, n - 1) else wrong, p))
    traj = convert.camera_trajectory(jt, device="cpu")
    TR.refine_trajectory(
        db_path, traj, EYE, convert.mesh(mesh, device="cpu"),
        optimize_focal_length=which == "focal",
        optimize_principal_point=which == "principal_point",
        bundle_opts=TL.BundleOptions(loss_type=TRIVIAL, max_iterations=100),
        device="cpu",
    )
    for i in range(1, n - 1):
        got = traj.get(i).intrinsics
        if which == "focal":
            assert abs(float(got.fy) - 600.0) < 5.0, i
        else:
            assert abs(float(got.cx) - float(intr.cx)) < 2.0, i
            assert abs(float(got.cy) - float(intr.cy)) < 2.0, i


def test_refine_refuses_short_or_unfilled(scene10, tmp_path):
    mesh = convert.mesh(scene10["mesh"], device="cpu")
    state = convert.camera_state(scene10["traj"].get(0), device="cpu")
    short = CameraTrajectory(0, 2)
    short.set(0, state)
    short.set(1, state)
    gap = CameraTrajectory(0, 5)
    gap.set(0, state)
    for traj in (short, gap):
        with pytest.raises(ValueError):
            TR.refine_trajectory(scene10["db"], traj, EYE, mesh,
                                 device="cpu")


def test_refine_empty_database_is_graceful(scene10, tmp_path):
    db_path = str(tmp_path / "empty.db")
    Database(db_path).close()
    traj = convert.camera_trajectory(scene10["traj"], device="cpu")
    before = [traj.get(i).pose.t.numpy().copy() for i in range(traj.count)]
    TR.refine_trajectory(db_path, traj, EYE,
                         convert.mesh(scene10["mesh"], device="cpu"),
                         device="cpu")
    for i in range(traj.count):
        np.testing.assert_allclose(traj.get(i).pose.t.numpy(), before[i],
                                   atol=1e-6)


def test_bvh_route_matches_device_route(scene10, monkeypatch):
    """The host-BVH prim refresh gives the device sweep's prims and cost,
    and a whole refine through it the device route's final cost."""
    from polychase_tpu_torch import native

    if not native.available():
        pytest.skip("the port's host library is unavailable")
    mesh = convert.mesh(scene10["mesh"], device="cpu")
    traj = convert.camera_trajectory(scene10["traj"], device="cpu")
    db = Database(scene10["db"])
    try:
        data = TR.build_refiner_data(db, traj, mesh, EYE, device="cpu")
    finally:
        db.close()
    params = TR.traj_to_params(traj, device="cpu")
    m, tri = torch.eye(4), mesh.triangle_corners()
    dev = TR._make_prim_refresher(data, mesh, m, m, tri, 1.0, CAUCHY)
    assert not TR._refresh_routing(mesh)
    monkeypatch.setattr(TR, "BVH_TRIANGLE_THRESHOLD", 1)
    assert TR._refresh_routing(mesh)
    bvh = TR._make_prim_refresher(data, mesh, m, m, tri, 1.0, CAUCHY)
    prims_d, cost_d = dev(params)
    prims_b, cost_b = bvh(params)
    assert float((prims_d == prims_b).float().mean()) > 0.999
    assert abs(float(cost_d) - float(cost_b)) < 1e-3 * max(1.0, float(cost_d))
    _, ups_b = _run_port(scene10)
    monkeypatch.setattr(TR, "BVH_TRIANGLE_THRESHOLD", 1 << 30)
    _, ups_d = _run_port(scene10)
    np.testing.assert_allclose(float(ups_b[-1].stats.cost),
                               float(ups_d[-1].stats.cost), rtol=COST_RTOL)


# ---------------------------------------------------------------------------
# test_band_solve.py's 30-frame scene: the banded path end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene30(tmp_path_factory):
    rng = np.random.default_rng(4)
    mesh, intr = make_sphere_mesh(10, 14), make_intrinsics()
    N = 30
    poses = jax.device_get([orbit_pose(0.02 * t) for t in range(N)])
    db_path = str(tmp_path_factory.mktemp("scene30") / "flow.db")
    _noisy_db(db_path, mesh, intr, poses, rng, (-4, -2, -1, 1, 2, 4), 100,
              0.25)
    rng2 = np.random.default_rng(9)
    traj = JTraj(0, N)
    for i in range(N):
        t = np.asarray(poses[i].t, np.float64)
        if i not in (0, N - 1):
            t = t + rng2.normal(0, 0.004, 3)
        traj.set(i, JC.CameraState(intr, JP.Pose(
            jnp.asarray(np.asarray(poses[i].q), jnp.float32),
            jnp.asarray(t, jnp.float32))))
    return dict(mesh=mesh, intr=intr, poses=poses, db=db_path, traj=traj)


def test_banded_refine_matches_jax_and_dense(scene30, monkeypatch):
    opts = BundleOptions(loss_type=CAUCHY, loss_scale=1.0, max_iterations=15)
    db = Database(scene30["db"])
    try:
        data = TR.build_refiner_data(
            db, convert.camera_trajectory(scene30["traj"], device="cpu"),
            convert.mesh(scene30["mesh"], device="cpu"), EYE, device="cpu")
    finally:
        db.close()
    assert TR.compute_band(data, 30, 6) == (8, 24)

    jtraj, jups = _run_jax(scene30, bundle_opts=opts)
    banded, bups = _run_port(scene30, bundle_opts=opts)
    monkeypatch.setattr(TR, "compute_band", lambda *a: ())
    dense, _ = _run_port(scene30, bundle_opts=opts)
    np.testing.assert_allclose(float(bups[-1].stats.cost),
                               float(jups[-1].stats.cost), rtol=COST_RTOL)
    for (_, tb), (_, td), (_, tj) in zip(_states(banded), _states(dense),
                                         _states(jtraj)):
        np.testing.assert_allclose(tb, td, atol=POSE_ATOL)
        np.testing.assert_allclose(tb, tj, atol=POSE_ATOL)
