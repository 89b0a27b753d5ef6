"""The port's segment-parallel tracking against the JAX package's.

Both run on the CPU, on test_tracking_parallel.py's scene (24 frames, a
12×16 sphere, 160 points a frame, 0.2 px flow noise, segments (0, 8),
(8, 16), (16, 23)), written once through the JAX ``Database``; the port
reads the same file.  The JAX run takes ``track_segments(device_mesh=
False)`` (its vmapped scan chain, the XLA arm off the TPU) with the exact
f32 targets (its default there); the port its batched frame step, the
plain PnP on the CPU.

Tolerances: the counts equal exactly; translations within 2e-4 and
quaternions within 1e-4 of JAX's; both within 5e-3 of the truth
(test_tracking_parallel.py's bar); the port's batched run within 2e-4 of
its own sequential ``track_camera_trajectory``; one stack spread over
several devices within 1e-6 of the one-device run.
"""

import numpy as np
import pytest
import torch

from polychase_tpu.engine import camera as JC
from polychase_tpu.engine.trajectory import CameraTrajectory as JTraj
from polychase_tpu.io.database import Database
from polychase_tpu.parallel.tracking import track_segments as jax_segments

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine import tracker as TT
from polychase_tpu_torch.engine.levmarq import CAUCHY, BundleOptions
from polychase_tpu_torch.io.database import Database as TDatabase
from polychase_tpu_torch.kernels import pnp_lm
from polychase_tpu_torch.parallel.tracking import track_segments

from synthetic import make_intrinsics
from test_tracking_parallel import SEGS, _seeded, scene  # noqa: F401

torch.set_num_threads(1)

T_ATOL, Q_ATOL, GT_ATOL = 2e-4, 1e-4, 5e-3
SEQ_ATOL, SPLIT_ATOL = 2e-4, 1e-6
EYE = np.eye(4, dtype=np.float32)
OPTS = BundleOptions(loss_type=CAUCHY, loss_scale=1.0)


def _field(traj, which):
    return np.stack([
        np.asarray(getattr(traj.get(f).pose, which), np.float64)
        for f in range(traj.first_frame, traj.last_frame + 1)
        if traj.is_frame_filled(f)])


def _jax(sc, db_path=None, segs=SEGS):
    trajs = [_seeded(sc, a, b) for a, b in segs]
    counts = jax_segments(db_path or sc["db_path"], trajs, EYE, sc["mesh"],
                          bundle_opts=OPTS, device_mesh=False)
    return trajs, np.asarray(counts)


def _port(sc, db_path=None, segs=SEGS, device="cpu"):
    trajs = [convert.camera_trajectory(_seeded(sc, a, b), device="cpu")
             for a, b in segs]
    counts = track_segments(db_path or sc["db_path"], trajs, EYE,
                            convert.mesh(sc["mesh"], device="cpu"),
                            bundle_opts=OPTS, device=device)
    return trajs, counts


@pytest.fixture(scope="module")
def runs(scene):  # noqa: F811
    before = pnp_lm.launches
    port = _port(scene)
    assert pnp_lm.launches == before  # CPU tensors take the plain version
    return _jax(scene), port


def _gt(sc, traj, which):
    return np.stack([np.asarray(getattr(sc["poses"][f], which), np.float64)
                     for f in range(traj.first_frame, traj.last_frame + 1)
                     if traj.is_frame_filled(f)])


def test_track_segments_matches_jax(scene, runs):  # noqa: F811
    (jtrajs, jcounts), (ttrajs, tcounts) = runs
    assert tcounts.shape == jcounts.shape == (3, 8)
    np.testing.assert_array_equal(tcounts, jcounts)
    assert (tcounts[:, :7] >= 3).all() and (tcounts[2, 7:] == 0).all()
    for j, t in zip(jtrajs, ttrajs):
        assert all(t.is_frame_filled(f) for f in range(t.first_frame,
                                                        t.last_frame + 1))
        np.testing.assert_allclose(_field(t, "t"), _field(j, "t"),
                                   atol=T_ATOL)
        np.testing.assert_allclose(_field(t, "q"), _field(j, "q"),
                                   atol=Q_ATOL)
        for traj in (j, t):
            err = np.linalg.norm(_field(traj, "t") - _gt(scene, traj, "t"),
                                 axis=-1)
            assert err.max() < GT_ATOL


def test_track_segments_matches_sequential(scene, runs):  # noqa: F811
    _, (ttrajs, _) = runs
    mesh = convert.mesh(scene["mesh"], device="cpu")
    db = TDatabase(scene["db_path"])
    try:
        for (a, b), par in zip(SEGS, ttrajs):
            seq = convert.camera_trajectory(_seeded(scene, a, b),
                                            device="cpu")
            TT.track_camera_trajectory(db, seq, a, b, EYE, mesh,
                                       bundle_opts=OPTS, device="cpu")
            np.testing.assert_allclose(_field(par, "t"), _field(seq, "t"),
                                       atol=SEQ_ATOL)
            np.testing.assert_allclose(_field(par, "q"), _field(seq, "q"),
                                       atol=SEQ_ATOL)
    finally:
        db.close()


@pytest.mark.parametrize("n_devices", [2, 8])
def test_split_over_devices(scene, runs, n_devices):  # noqa: F811
    """3 segments over 2 or 8 devices (here all the CPU): the shards are
    padded to the stack's shapes, so the split changes nothing."""
    _, (one, counts) = runs
    split, split_counts = _port(scene, device=["cpu"] * n_devices)
    np.testing.assert_array_equal(split_counts, counts)
    for a, b in zip(split, one):
        np.testing.assert_allclose(_field(a, "t"), _field(b, "t"),
                                   atol=SPLIT_ATOL)
        np.testing.assert_allclose(_field(a, "q"), _field(b, "q"),
                                   atol=SPLIT_ATOL)


def test_stripped_frame_keeps_warm_start(scene, runs, tmp_path):  # noqa: F811
    """Every flow into and out of frame 11 removed: its solve has no
    correspondence, the frame keeps its warm start (and stays unfilled),
    and the chain goes on from frames 8 and 10, in both packages alike."""
    src = Database(scene["db_path"])
    db_path = str(tmp_path / "stripped.db")
    dst = Database(db_path)
    n = len(scene["poses"])
    for f in range(n):
        dst.write_keypoints(f, src.read_keypoints(f))
        for g in src.find_optical_flows_from_image(f):
            if 11 in (f, g):
                continue
            fl = src.read_image_pair_flow(f, g)
            dst.write_image_pair_flow(f, g, fl.src_kps_indices, fl.tgt_kps,
                                      fl.flow_errors)
    src.close()
    dst.close()
    jtrajs, jcounts = _jax(scene, db_path)
    ttrajs, tcounts = _port(scene, db_path)
    np.testing.assert_array_equal(tcounts, jcounts)
    assert tcounts[1, 11 - 8 - 1] == 0
    assert (np.delete(tcounts[:, :7], 2, axis=1) >= 3).all()
    for j, t in zip(jtrajs, ttrajs):
        assert not t.is_frame_filled(11) and not j.is_frame_filled(11)
        np.testing.assert_allclose(_field(t, "t"), _field(j, "t"),
                                   atol=T_ATOL)
        np.testing.assert_allclose(_field(t, "q"), _field(j, "q"),
                                   atol=Q_ATOL)
        err = np.linalg.norm(_field(t, "t") - _gt(scene, t, "t"), axis=-1)
        assert err.max() < GT_ATOL


def test_mixed_clips_and_unfilled_seed_raise(scene):  # noqa: F811
    sc = scene
    mesh = convert.mesh(sc["mesh"], device="cpu")
    a = convert.camera_trajectory(_seeded(sc, 0, 4), device="cpu")
    other = JTraj(4, 5)
    p = sc["poses"][4]
    other.set(4, JC.CameraState(make_intrinsics(w=1920, h=1080, f=1800.0),
                                p))
    b = convert.camera_trajectory(other, device="cpu")
    with pytest.raises(TT.TrackingError, match="seed intrinsics"):
        track_segments(sc["db_path"], [a, b], EYE, mesh, device="cpu")
    empty = convert.camera_trajectory(JTraj(4, 5), device="cpu")
    with pytest.raises(TT.TrackingError, match="seed frame has no pose"):
        track_segments(sc["db_path"], [a, empty], EYE, mesh, device="cpu")
    assert track_segments(sc["db_path"], [], EYE, mesh,
                          device="cpu").shape == (0, 0)
