"""The port's segment-parallel refine against the JAX package's.

``refine_segments`` runs the reference's lockstep LM (``lm_chunk_device``
vmapped over segments); the port's runs ``engine.refiner.LockstepLM`` on
the same stack.  Both on the CPU, on test_segments_parallel.py's scene
(25 frames, a 10×14 sphere, 3 segments, Cauchy, 20 iterations) and on a
60-frame scene whose 50-frame segments take the banded solve.

Tolerances:
- whole runs: poses within 5e-4 of JAX's (``POSE_ATOL``, as in
  test_torch_refiner.py), both below 0.6× the initial mean translation
  error (test_segments_parallel.py's bar), and within 2e-4 of the port's
  own sequential ``refine_trajectory`` (the JAX test's bar);
- one stack over several devices: within 1e-6 of the one-device run;
- the batched banded solve: within 1e-6 of a loop of unbatched calls;
- the LM schedule from the same state: counted iterations equal, final
  cost within 1e-4 relative of the range of JAX's, and invalid steps
  among the counts JAX takes when its edges and matches come in other
  orders (its last, stagnating step is accepted in some of those orders
  and refused in others).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from polychase_tpu.engine import camera as JC
from polychase_tpu.engine import pose as JP
from polychase_tpu.engine import refiner as JR
from polychase_tpu.engine.levmarq import BundleOptions, CAUCHY
from polychase_tpu.engine.trajectory import CameraTrajectory as JTraj
from polychase_tpu.io.database import Database
from polychase_tpu.parallel.segments import refine_segments as jax_segments

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine import camera as TC
from polychase_tpu_torch.engine import levmarq as TL
from polychase_tpu_torch.engine import refiner as TR
from polychase_tpu_torch.parallel import segments as TS

from synthetic import make_intrinsics, make_sphere_mesh, orbit_pose
from test_segments_parallel import SEGS, _noisy_segments, scene  # noqa: F401
from test_torch_refiner import _noisy_db

torch.set_num_threads(1)

POSE_ATOL = 5e-4
SEQ_ATOL = 2e-4
SPLIT_ATOL = 1e-6
COST_RTOL = 1e-4
EYE = np.eye(4, dtype=np.float32)
OPTS = BundleOptions(loss_type=CAUCHY, loss_scale=1.0, max_iterations=20)


def _ts(traj):
    return np.stack([np.asarray(traj.get(f).pose.t, np.float64)
                     for f in range(traj.first_frame, traj.last_frame + 1)])


def _qs(traj):
    return np.stack([np.asarray(traj.get(f).pose.q, np.float64)
                     for f in range(traj.first_frame, traj.last_frame + 1)])


def _gt(sc, traj):
    return np.stack([np.asarray(sc["poses"][f].t, np.float64)
                     for f in range(traj.first_frame, traj.last_frame + 1)])


def _port(sc, trajs, opts=OPTS, device="cpu"):
    return TS.refine_segments(
        sc["db_path"], [convert.camera_trajectory(t, device="cpu")
                        for t in trajs],
        EYE, convert.mesh(sc["mesh"], device="cpu"),
        bundle_opts=convert.bundle_options(opts), device=device)


@pytest.fixture(scope="module")
def runs(scene):  # noqa: F811
    jax_out = jax_segments(scene["db_path"], _noisy_segments(scene), EYE,
                           scene["mesh"], bundle_opts=OPTS, device_mesh=False)
    return jax_out, _port(scene, _noisy_segments(scene))


def test_refine_segments_matches_jax(scene, runs):  # noqa: F811
    jax_out, port_out = runs
    assert len(port_out) == len(SEGS)
    for j, t, t0, (a, b) in zip(jax_out, port_out, _noisy_segments(scene),
                                SEGS):
        assert (t.first_frame, t.last_frame) == (a, b)
        gt = _gt(scene, t)
        err0 = np.linalg.norm(_ts(t0) - gt, axis=-1).mean()
        assert np.linalg.norm(_ts(j) - gt, axis=-1).mean() < 0.6 * err0
        assert np.linalg.norm(_ts(t) - gt, axis=-1).mean() < 0.6 * err0
        np.testing.assert_allclose(_ts(t), _ts(j), atol=POSE_ATOL)
        np.testing.assert_allclose(_qs(t), _qs(j), atol=POSE_ATOL)
        # The anchors are untouched to the bit.
        for f in (a, b):
            np.testing.assert_array_equal(t.get(f).pose.t.numpy(),
                                          np.asarray(t0.get(f).pose.t))


def test_refine_segments_matches_sequential(scene, runs):  # noqa: F811
    _, port_out = runs
    mesh = convert.mesh(scene["mesh"], device="cpu")
    for t0, par in zip(_noisy_segments(scene), port_out):
        seq = convert.camera_trajectory(t0, device="cpu")
        TR.refine_trajectory(scene["db_path"], seq, EYE, mesh,
                             bundle_opts=convert.bundle_options(OPTS),
                             device="cpu")
        np.testing.assert_allclose(_ts(par), _ts(seq), atol=SEQ_ATOL)
        np.testing.assert_allclose(_qs(par), _qs(seq), atol=SEQ_ATOL)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_uneven_split_over_devices(scene, runs, n_devices):  # noqa: F811
    """3 segments over 2 or 8 devices (here all the CPU): each shard is
    padded to the stack's shapes, so the split changes nothing."""
    _, one = runs
    split = _port(scene, _noisy_segments(scene), device=["cpu"] * n_devices)
    assert len(split) == len(one)
    for a, b in zip(split, one):
        assert (a.first_frame, a.last_frame) == (b.first_frame, b.last_frame)
        assert np.isfinite(_ts(a)).all()
        np.testing.assert_allclose(_ts(a), _ts(b), atol=SPLIT_ATOL)
        np.testing.assert_allclose(_qs(a), _qs(b), atol=SPLIT_ATOL)


def test_refine_segments_empty_and_unfilled(scene):  # noqa: F811
    assert TS.refine_segments(scene["db_path"], [], EYE,
                              convert.mesh(scene["mesh"], device="cpu"),
                              device="cpu") == []
    gap = convert.camera_trajectory(_noisy_segments(scene)[0], device="cpu")
    gap.clear(3)
    with pytest.raises(ValueError):
        TS.refine_segments(scene["db_path"], [gap], EYE,
                           convert.mesh(scene["mesh"], device="cpu"),
                           device="cpu")


# ---------------------------------------------------------------------------
# The batched banded solve and the LM schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb,bs", [(6, 12), (8, 15)])
def test_batched_banded_solve_matches_loop(nb, bs):
    from test_torch_refiner import _band_system

    rng = np.random.default_rng(nb * bs)
    kinds = ["plain", "anchors", "indefinite", "plain"]
    systems = [_band_system(rng, nb, bs, k) for k in kinds]
    A = torch.as_tensor(np.stack([a for a, _ in systems]))
    b = torch.as_tensor(np.stack([v for _, v in systems]))
    lam = torch.tensor([1e-5, 1e-2, 1.0, 1e-3])
    step, ok = TL.damped_block_tridiag_solve(A, b, lam, nb=nb, bs=bs)
    assert step.shape == (4, nb * bs) and ok.shape == (4,)
    for i in range(4):
        ref, ref_ok = TL.damped_block_tridiag_solve(A[i], b[i], lam[i],
                                                    nb=nb, bs=bs)
        assert bool(ok[i]) == bool(ref_ok) == (kinds[i] != "indefinite")
        np.testing.assert_allclose(step[i].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-6 * float(ref.abs().max() + 1))


@pytest.mark.parametrize("ppc", [6, 9])
@pytest.mark.parametrize("seg", [0, 2])
def test_lm_schedule_matches_jax(scene, seg, ppc):  # noqa: F811
    """One segment through the reference's ``lm_chunk_device`` and the
    port's ``LockstepLM`` from the same params, prims and data.  (The
    middle segment with 6 parameters is left out: its last step changes
    the cost by 8e-7 of it, inside the two packages' f32 sum-order
    difference, so accepting or rejecting it is a coin toss; both stop
    there on the stagnation exit.)"""
    traj = _noisy_segments(scene)[seg]
    db = Database(scene["db_path"])
    try:
        jdata = JR.build_refiner_data(db, traj, scene["mesh"], EYE)
    finally:
        db.close()
    jparams = JR.traj_to_params(traj)
    m = jnp.eye(4)
    jtri = scene["mesh"].triangle_corners()
    n_iters = 22
    tol = (1e-10, 1e-8, 1e-10, 1e10, 1e-5)
    Pn = traj.count * ppc
    jbounds = JC.intrinsics_bounds(traj.get(traj.first_frame).intrinsics)
    kw = dict(loss_type=CAUCHY, opt_f=ppc == 9, opt_pp=False, ppc=ppc)

    def reference(data):
        prims, cost0 = JR.refresh_prims_and_cost(
            jparams, data, scene["mesh"], m, m, jtri, jnp.float32(1.0),
            loss_type=CAUCHY)
        scal0 = jnp.stack([cost0, jnp.float32(1e-5), 2.0, 1.0, 0.0, 0.0,
                           0.0, jnp.float32(n_iters - 2)]).astype(jnp.float32)
        out = JR.lm_chunk_device(
            jparams, prims, jnp.zeros((Pn, Pn), jnp.float32),
            jnp.zeros((Pn,), jnp.float32), scal0, data, scene["mesh"], m, m,
            jtri, jnp.float32(1.0), jbounds, jnp.asarray(tol, jnp.float32),
            n_iters=n_iters, **kw)
        return prims, scal0, out

    prims, scal0, out = reference(jdata)
    jscal = np.asarray(out[4])
    # The same problem with its edges and their matches in four shuffled
    # orders: only the reference's order of summation changes.
    E, M = jdata.src_kp.shape
    shuffled = []
    for s in range(1, 5):
        rng = np.random.default_rng(s)
        pe, pm = rng.permutation(E), rng.permutation(M)
        shuffled.append(np.asarray(reference(jdata._replace(
            src_frame=jdata.src_frame[pe], tgt_frame=jdata.tgt_frame[pe],
            src_kp=jdata.src_kp[pe][:, pm], tgt_px=jdata.tgt_px[pe][:, pm],
            match_valid=jdata.match_valid[pe][:, pm],
            edge_weight=jdata.edge_weight[pe],
            edge_valid=jdata.edge_valid[pe]))[2][4]))
    jscals = np.stack([jscal] + shuffled)

    tmesh = convert.mesh(scene["mesh"], device="cpu")
    tbounds = TC.intrinsics_bounds(convert.intrinsics(
        traj.get(traj.first_frame).intrinsics, device="cpu"))
    lm = TR.LockstepLM(
        convert.traj_params(jparams, device="cpu"),
        torch.as_tensor(np.asarray(prims).astype(np.int64)),
        torch.as_tensor(np.array(scal0))[None],
        convert.refiner_data(jdata, device="cpu"), tmesh, torch.eye(4),
        torch.eye(4), tmesh.triangle_corners(), 1.0, tbounds, tol, **kw)
    TR.run_lockstep([lm], n_iters)
    tparams, tscal = lm.params, lm.scal[0].numpy()
    assert tscal[TR.ITERS] == jscal[TR.ITERS] >= 2
    assert tscal[TR.INVALID] in set(jscals[:, TR.INVALID].tolist())
    assert tscal[TR.DONE] == jscal[TR.DONE] == 1.0
    costs = jscals[:, TR.COST]
    assert (costs.min() * (1 - COST_RTOL) <= tscal[TR.COST]
            <= costs.max() * (1 + COST_RTOL))
    np.testing.assert_allclose(tparams.t.numpy(), np.asarray(out[0].t),
                               atol=POSE_ATOL)


# ---------------------------------------------------------------------------
# Long segments: the banded solve, and the dense one when the bands differ
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene60(tmp_path_factory):
    rng = np.random.default_rng(5)
    mesh, intr = make_sphere_mesh(10, 14), make_intrinsics()
    poses = jax.device_get([orbit_pose(0.02 * t) for t in range(60)])
    db_path = str(tmp_path_factory.mktemp("seg60") / "flow.db")
    _noisy_db(db_path, mesh, intr, poses, rng, (-4, -2, -1, 1, 2, 4), 60,
              0.25)
    return dict(mesh=mesh, intr=intr, poses=poses, db_path=db_path)


def _noisy(sc, segs, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for a, b in segs:
        traj = JTraj(a, b - a + 1)
        for i in range(a, b + 1):
            p = sc["poses"][i]
            t = np.asarray(p.t, np.float64)
            if i not in (a, b):
                t = t + rng.normal(0, 0.004, 3)
            traj.set(i, JC.CameraState(sc["intr"], JP.Pose(
                jnp.asarray(np.asarray(p.q), jnp.float32),
                jnp.asarray(t, jnp.float32))))
        out.append(traj)
    return out


@pytest.mark.parametrize("segs,banded", [
    (((0, 49), (10, 59)), True),     # 50 frames each: nb = 13 ≥ 6
    (((0, 2), (2, 51)), False),      # spans 2 and 4: the bands differ
])
def test_long_segments_match_jax(scene60, monkeypatch, segs, banded):
    opts = BundleOptions(loss_type=CAUCHY, loss_scale=1.0, max_iterations=6)
    calls = []
    real = TR.damped_block_tridiag_solve
    monkeypatch.setattr(TR, "damped_block_tridiag_solve",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    port = _port(scene60, _noisy(scene60, segs), opts)
    assert bool(calls) == banded
    if banded:
        assert calls[0] == dict(nb=13, bs=24)
    ref = jax_segments(scene60["db_path"], _noisy(scene60, segs), EYE,
                       scene60["mesh"], bundle_opts=opts, device_mesh=False)
    for t, j in zip(port, ref):
        np.testing.assert_allclose(_ts(t), _ts(j), atol=POSE_ATOL)
        np.testing.assert_allclose(_qs(t), _qs(j), atol=POSE_ATOL)


BANDED_SEGS = ((0, 49), (10, 59))
BANDED_OPTS = BundleOptions(loss_type=CAUCHY, loss_scale=1.0,
                            max_iterations=6)


@pytest.fixture(scope="module")
def banded_one(scene60):
    return _port(scene60, _noisy(scene60, BANDED_SEGS), BANDED_OPTS)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_banded_split_over_devices(scene60, banded_one, n_devices):
    """The banded segments (nb = 13, bs = 24) over 2 or 8 devices (here
    all the CPU): each shard solves its systems in a smaller batch, and
    the split changes nothing."""
    split = _port(scene60, _noisy(scene60, BANDED_SEGS), BANDED_OPTS,
                  device=["cpu"] * n_devices)
    assert len(split) == len(banded_one)
    for a, b in zip(split, banded_one):
        assert (a.first_frame, a.last_frame) == (b.first_frame, b.last_frame)
        assert np.isfinite(_ts(a)).all()
        np.testing.assert_allclose(_ts(a), _ts(b), atol=SPLIT_ATOL)
        np.testing.assert_allclose(_qs(a), _qs(b), atol=SPLIT_ATOL)
