"""The port's worker threads (``runtime/threads.py``) against the JAX
package's facade, and the concurrency cases of ``test_runtime_stress.py``.

Each thread runs with ``device="cpu"`` (the kernels' plain versions) and is
held against the JAX facade's free function on the same seeded inputs:

- ``TrackerThread``: every frame within ``test_torch_tracker.py``'s
  ground-truth bars (rotation 2e-3 rad, translation 5e-3) in both
  packages; a chain amplifies float reassociation, so the two chains are
  held by their ground-truth errors (RMS within 1e-4 rad and 1e-3), not
  frame by frame;
- ``RefinerThread``: ``test_torch_refiner.py``'s poses within 5e-4 of the
  JAX refine, ``test_api.py``'s 2.5e-3 to the truth, anchors to the bit;
- ``RefineSegmentsThread``: its one progress message, then ``True``, and
  the trajectories equal to ``pc.refine_segments``'s within 1e-6;
- ``OpticalFlowThread`` and ``RefinerThread`` on a device list
  (``["cpu"] * 2``): the one-device thread's DB to the bit, its refined
  poses within 2e-3 rad and 4e-3;
- ``OpticalFlowThread``: ``test_torch_opticalflow.py``'s LK bounds against
  the JAX analyze; through a jittery provider and through the 17-slot ring
  (26 frames), the DB equal to the port's direct analyze, each frame
  requested once.

Without a card, a thread built with no ``device`` sends ``CppException``
and then ``True``, and runs nothing.  Each poll loop fails its test after
60 s rather than hang.
"""

import threading
import time

import cv2
import numpy as np
import pytest
import torch

import polychase_tpu.polychase_core as jpc
from polychase_tpu.engine import pose as JP
from polychase_tpu.engine import tracker as JT

import polychase_tpu_torch.polychase_core as pc
from polychase_tpu_torch.kernels import lk_iter, lk_prep, pnp_lm
from polychase_tpu_torch.runtime.threads import _SequentialFrameCache
from polychase_tpu_torch.synthetic import panning_clip

from synthetic import make_intrinsics, make_sphere_mesh, orbit_pose
from test_opticalflow import make_clip
from test_torch_api import segment_scene, segment_trajectories
from test_torch_opticalflow import assert_flows_match
from test_tracker import build_flow_db, pose_errors
from thread_drain import DEADLINE_S, drain

torch.set_num_threads(1)

CPU = "cpu"
ROT_GT, T_GT = 2e-3, 5e-3        # test_torch_tracker.py
Q_PAIR, T_PAIR = 1e-4, 1e-3
REFINE_ATOL, REFINE_T_GT = 5e-4, 2.5e-3  # test_torch_refiner.py, test_api.py
EYE = np.eye(4, dtype=np.float32)


def _scene(mod, pose):
    return mod.SceneTransformations(
        model_matrix=EYE, view_matrix=np.asarray(JP.pose_rt4x4(pose)),
        intrinsics=mod.CameraIntrinsics(
            fx=600.0, fy=600.0, cx=320.0, cy=240.0, aspect_ratio=1.0,
            width=640, height=480, convention=mod.CameraConvention.OpenCV),
    )


def _meshes(mesh):
    v, t = np.asarray(mesh.vertices), np.asarray(mesh.triangles)
    return jpc.AcceleratedMesh(v, t), pc.AcceleratedMesh(v, t)


# ---------------------------------------------------------------------------
# Tracker and refiner threads
# ---------------------------------------------------------------------------


def test_tracker_thread(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(JT, "QUANT_TGT", False)
    mesh = make_sphere_mesh()
    poses = [orbit_pose(0.04 * t) for t in range(8)]
    db_path = str(tmp_path / "flow.db")
    build_flow_db(db_path, mesh, make_intrinsics(), poses, rng)
    jmesh, tmesh = _meshes(mesh)

    ref = []
    jpc.track_sequence(db_path, 0, 7, _scene(jpc, poses[0]), jmesh,
                       lambda r: ref.append(r) or True, False, False,
                       jpc.BundleOptions())
    before = pnp_lm.launches
    got = drain(pc.TrackerThread(db_path, 0, 7, _scene(pc, poses[0]), tmesh,
                                  False, False, pc.BundleOptions(),
                                  device=CPU))
    assert pnp_lm.launches == before  # CPU tensors take the plain version
    assert [r.frame for r in got] == [r.frame for r in ref] == list(
        range(1, 8))
    for r in got:
        assert isinstance(r, pc.FrameTrackingResult)
        assert isinstance(r.pose, pc.Pose)
        assert isinstance(r.bundle_stats, pc.BundleStats)
        assert r.inlier_ratio > 0.99
        assert (r.intrinsics.width, r.intrinsics.height) == (640, 480)
    rms = []
    for results in (ref, got):
        err = np.array([pose_errors(JP.Pose(r.pose.q, r.pose.t),
                                    poses[r.frame]) for r in results])
        assert (err[:, 0] < ROT_GT).all() and (err[:, 1] < T_GT).all(), err
        rms.append(np.sqrt((err ** 2).mean(axis=0)))
    assert abs(rms[1][0] - rms[0][0]) < Q_PAIR, rms
    assert abs(rms[1][1] - rms[0][1]) < T_PAIR, rms


def test_refiner_thread(tmp_path, rng):
    mesh = make_sphere_mesh()
    poses = [orbit_pose(0.05 * t) for t in range(6)]
    db_path = str(tmp_path / "flow.db")
    build_flow_db(db_path, mesh, make_intrinsics(), poses, rng)
    noise = rng.normal(0, 0.01, (6, 3)).astype(np.float32)

    def trajectory(mod):
        traj = mod.CameraTrajectory(0, 6)
        for i, p in enumerate(poses):
            state = mod.CameraState(_scene(mod, p).intrinsics, mod.Pose(
                np.asarray(p.q), np.asarray(p.t)))
            if i not in (0, 5):
                state.pose.t = state.pose.t + noise[i]
            traj.set(i, state)
        return traj

    jmesh, tmesh = _meshes(mesh)
    jtraj, ttraj = trajectory(jpc), trajectory(pc)
    start = [ttraj.get(i).pose for i in (0, 5)]
    jpc.refine_trajectory(db_path, jtraj, EYE, jmesh, False, False, None,
                          jpc.BundleOptions())
    updates = drain(pc.RefinerThread(db_path, ttraj, EYE, tmesh, False,
                                      False, pc.BundleOptions(), device=CPU))
    assert updates
    assert all(isinstance(u, pc.RefineTrajectoryUpdate) for u in updates)
    assert isinstance(updates[-1].stats, pc.BundleStats)
    for i, p0 in zip((0, 5), start):
        np.testing.assert_array_equal(ttraj.get(i).pose.q, p0.q)
        np.testing.assert_array_equal(ttraj.get(i).pose.t, p0.t)
    for i in range(1, 5):
        got, ref = ttraj.get(i).pose, jtraj.get(i).pose
        assert np.linalg.norm(got.t - np.asarray(poses[i].t)) < REFINE_T_GT
        np.testing.assert_allclose(got.t, ref.t, atol=REFINE_ATOL)
        np.testing.assert_allclose(got.q, ref.q, atol=REFINE_ATOL)


@pytest.mark.parametrize("thread", ["OpticalFlowThread", "RefinerThread"])
def test_threads_split_over_a_device_list(tmp_path, thread):
    """An ``OpticalFlowThread`` and a ``RefinerThread`` on ``["cpu"] * 2``
    against the same thread on one device: the analyze DB equal to the bit,
    the refined poses within 2e-3 rad and 4e-3 (test_sharded.py's bars);
    on a list of one, the one-device results to the bit."""
    if thread == "OpticalFlowThread":
        frames = panning_clip(np.random.default_rng(0), 4, 160, 120, (3, 2))
        info = pc.VideoInfo(160, 120, 0, 4)
        for name, device in (("one.db", CPU), ("list.db", [CPU]),
                             ("two.db", [CPU, CPU])):
            drain(pc.OpticalFlowThread(info, str(tmp_path / name),
                                       device=device), frames)
        for name in ("list.db", "two.db"):
            _same_db(str(tmp_path / "one.db"), str(tmp_path / name), 4)
        return
    db = str(tmp_path / "flow.db")
    v, t, poses, intr = segment_scene(db)
    mesh = pc.AcceleratedMesh(v, t)
    opts = pc.BundleOptions()
    opts.max_iterations = 8
    out = []
    for device in (CPU, [CPU, CPU], [CPU]):
        traj = segment_trajectories(poses, intr, filled=True)[0]
        assert drain(pc.RefinerThread(db, traj, EYE, mesh, False, False,
                                      opts, device=device))
        out.append(traj)
    for f in range(out[0].first_frame(), out[0].last_frame() + 1):
        np.testing.assert_array_equal(out[2].get(f).pose.t,
                                      out[0].get(f).pose.t)
        np.testing.assert_array_equal(out[2].get(f).pose.q,
                                      out[0].get(f).pose.q)
    for f in range(out[0].first_frame(), out[0].last_frame() + 1):
        a, b = out[0].get(f).pose, out[1].get(f).pose
        assert np.linalg.norm(a.t - b.t) < 4e-3
        assert 2 * np.arccos(min(abs(float(np.dot(a.q, b.q))), 1.0)) < 2e-3


def test_refine_segments_thread(tmp_path):
    db = str(tmp_path / "flow.db")
    v, t, poses, intr = segment_scene(db)
    mesh = pc.AcceleratedMesh(v, t)
    opts = pc.BundleOptions()
    opts.max_iterations = 8
    ref = segment_trajectories(poses, intr, filled=True)
    pc.refine_segments(db, ref, EYE, mesh, False, False, opts, device=CPU)
    trajs = segment_trajectories(poses, intr, filled=True)
    thread = pc.RefineSegmentsThread(db, trajs, EYE, mesh, False, False,
                                     opts, device=CPU)
    msgs = drain(thread)
    assert len(msgs) == 1 and isinstance(msgs[0], pc.RefineTrajectoryUpdate)
    assert (msgs[0].progress, msgs[0].message) == (
        0.0, "Refining 3 segments in parallel")
    assert not thread.stopped
    for a, b in zip(trajs, ref):
        for f in range(a.first_frame(), a.last_frame() + 1):
            np.testing.assert_allclose(a.get(f).pose.t, b.get(f).pose.t,
                                       atol=1e-6)
            np.testing.assert_allclose(a.get(f).pose.q, b.get(f).pose.q,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# Optical-flow thread
# ---------------------------------------------------------------------------


def _analyze_thread(frames, info, db_path, requested=None, **kw):
    thread = pc.OpticalFlowThread(info, db_path, device=CPU, **kw)

    def serve(msg):
        if requested is not None:
            requested.append(msg.frame_id)
        thread.provide_frame(msg.frame_id, frames[msg.frame_id])

    return drain(thread, on_request=serve)


def _same_db(a, b, n):
    """Two analyze DBs hold the same keypoints and flows, to the bit."""
    da, db = pc.Database(a), pc.Database(b)
    try:
        for f in range(n):
            np.testing.assert_array_equal(da.read_keypoints(f),
                                          db.read_keypoints(f))
            assert da.find_optical_flows_from_image(f) == (
                db.find_optical_flows_from_image(f))
            for g in da.find_optical_flows_from_image(f):
                fa, fb = da.read_image_pair_flow(f, g), db.read_image_pair_flow(
                    f, g)
                np.testing.assert_array_equal(fa.src_kps_indices,
                                              fb.src_kps_indices)
                np.testing.assert_array_equal(fa.tgt_kps, fb.tgt_kps)
    finally:
        da.close()
        db.close()


def test_opticalflow_thread(tmp_path, rng, monkeypatch):
    monkeypatch.setenv("POLYCHASE_LK_COMPRESS", "0")
    monkeypatch.setenv("POLYCHASE_SHARD_ANALYZE", "0")
    frames = make_clip(rng, n=8)
    ref_db, got_db = str(tmp_path / "jax.db"), str(tmp_path / "port.db")
    jpc.generate_optical_flow_database(jpc.VideoInfo(160, 120, 0, 6),
                                       lambda f: frames[f], None, ref_db)
    launches = (lk_prep.launches, lk_iter.launches)
    requested = []
    msgs = _analyze_thread(frames, pc.VideoInfo(160, 120, 0, 6), got_db,
                           requested)
    assert (lk_prep.launches, lk_iter.launches) == launches  # CPU: plain
    assert requested == list(range(6))  # each frame requested once
    progress = [m for m in msgs if isinstance(m, pc.OpticalFlowProgress)]
    assert len(progress) == len(msgs) >= 6
    assert progress[-1] == (1.0, "Done")
    assert_flows_match(ref_db, got_db, frames[:6])
    db = pc.Database(got_db)
    assert db.get_min_image_id_with_keypoints() == 0
    assert db.get_max_image_id_with_keypoints() == 5
    db.close()


def test_opticalflow_thread_cancel(tmp_path, rng):
    """A stop while frames are requested ends the run early with ``True``
    and no error, in both packages (the port cancels at a frame request)."""
    frames = make_clip(rng, n=12)
    for mod in (jpc, pc):
        kw = {} if mod is jpc else dict(device=CPU)
        thread = mod.OpticalFlowThread(mod.VideoInfo(160, 120, 0, 12),
                                       str(tmp_path / f"{mod.__name__}.db"),
                                       **kw)
        served = []

        def serve(msg, thread=thread, served=served):
            served.append(msg.frame_id)
            if len(served) > 3:
                thread.request_stop()
            thread.provide_frame(msg.frame_id, frames[msg.frame_id])

        errors = []
        drain(thread, on_request=serve, errors=errors)
        assert thread.stopped
        assert len(served) < 12
        if mod is pc:
            assert errors == []


def test_sequential_frame_cache_wraps():
    """The 17-slot ring: each frame read once in order, the last 17 served
    from the ring, older ones and jumps of 17 or more refused."""
    reads = []
    cache = _SequentialFrameCache(lambda f: reads.append(f) or f * 10)
    assert cache(0) == 0
    assert cache(5) == 50 and reads == list(range(6))
    for f in range(6, 40):
        assert cache(f) == 10 * f
        assert cache(max(f - 16, 0)) == 10 * max(f - 16, 0)
    assert reads == list(range(40))
    with pytest.raises(RuntimeError, match="outside the ring"):
        cache(39 - 17)
    with pytest.raises(RuntimeError, match="beyond cache size"):
        cache(39 + 17)


def test_opticalflow_thread_ring_wraps(tmp_path):
    """26 frames wrap the 17-slot ring: each frame is requested once, in
    order, and the DB equals the direct analyze's."""
    n = 26
    frames = panning_clip(np.random.default_rng(1), n, 128, 96, (2, 1))
    info = pc.VideoInfo(128, 96, 0, n)
    direct, threaded = str(tmp_path / "direct.db"), str(tmp_path / "t.db")
    pc.generate_optical_flow_database(info, lambda f: frames[f], None,
                                      direct, device=CPU)
    requested = []
    _analyze_thread(frames, info, threaded, requested)
    assert requested == list(range(n))
    _same_db(direct, threaded, n)


# ---------------------------------------------------------------------------
# test_runtime_stress.py's cases on the port
# ---------------------------------------------------------------------------


def test_database_concurrent_readers_writers(tmp_path):
    """One Database hammered by 4 threads: its lock serialises SQLite."""
    db = pc.Database(str(tmp_path / "flow.db"))
    errors = []
    n_per_thread = 40

    def worker(tid):
        try:
            r = np.random.default_rng(tid)
            for i in range(n_per_thread):
                fid = tid * n_per_thread + i
                kps = r.uniform(0, 100, (17, 2)).astype(np.float32)
                db.write_keypoints(fid, kps)
                assert db.read_keypoints(fid).shape == (17, 2)
                if i > 0:
                    idx = np.arange(5, dtype=np.uint32)
                    db.write_image_pair_flow(
                        fid - 1, fid, idx,
                        r.uniform(0, 100, (5, 2)).astype(np.float32),
                        np.zeros(5, np.float32),
                    )
                    assert db.image_pair_flow_exists(fid - 1, fid)
                db.get_max_image_id_with_keypoints()
                db.find_optical_flows_to_image(fid)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE_S)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for fid in range(4 * n_per_thread):
        assert db.read_keypoints(fid).shape[0] == 17
    db.close()


def test_opticalflow_thread_jittery_provider(tmp_path, rng):
    """Frames provided from another thread after random delays: the
    handshake neither deadlocks nor drops a frame, and the DB equals the
    direct analyze's."""
    base = rng.integers(0, 255, (160, 220)).astype(np.float32)
    base = cv2.GaussianBlur(base, (0, 0), 1.5)
    base = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    frames = [
        np.ascontiguousarray(base[2 * t:2 * t + 120, 3 * t:3 * t + 160])
        for t in range(6)
    ]
    info = pc.VideoInfo(160, 120, 0, 6)
    direct, db_path = str(tmp_path / "direct.db"), str(tmp_path / "flow.db")
    pc.generate_optical_flow_database(info, lambda f: frames[f], None,
                                      direct, device=CPU)
    thread = pc.OpticalFlowThread(info, db_path, device=CPU)
    pending = []
    lock = threading.Lock()
    stop = threading.Event()

    def provider():
        r = np.random.default_rng(7)
        while not stop.is_set():
            with lock:
                fid = pending.pop(0) if pending else None
            if fid is None:
                time.sleep(0.002)
                continue
            time.sleep(float(r.uniform(0, 0.05)))
            thread.provide_frame(fid, frames[fid])

    def queue_request(msg):
        with lock:
            pending.append(msg.frame_id)

    prov = threading.Thread(target=provider)
    prov.start()
    try:
        drain(thread, on_request=queue_request)
    finally:
        stop.set()
        prov.join()
    _same_db(direct, db_path, 6)


# ---------------------------------------------------------------------------
# The card is the default, with no fallback
# ---------------------------------------------------------------------------


def test_threads_refuse_without_card(tmp_path, monkeypatch):
    """No device and no card: each thread's first message is the
    CppException, then True; no engine function runs."""
    from polychase_tpu_torch.engine import opticalflow, refiner, tracker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for eng, fn in ((tracker, "track_sequence"),
                    (refiner, "refine_trajectory"),
                    (opticalflow, "generate_optical_flow_database")):
        monkeypatch.setattr(eng, fn, lambda *a, _fn=fn, **k: ran.append(_fn))
    db = str(tmp_path / "flow.db")
    accel = pc.AcceleratedMesh(np.zeros((3, 3), np.float32),
                               np.array([[0, 1, 2]], np.uint32))
    scene = _scene(pc, orbit_pose(0.0))
    threads = [
        pc.OpticalFlowThread(pc.VideoInfo(16, 16, 0, 2), db),
        pc.TrackerThread(db, 0, 2, scene, accel, False, False,
                         pc.BundleOptions()),
        pc.RefinerThread(db, pc.CameraTrajectory(0, 3), EYE, accel, False,
                         False, pc.BundleOptions()),
    ]
    for thread in threads:
        errors = []
        assert drain(thread, errors=errors) == []
        assert len(errors) == 1
        assert isinstance(errors[0], pc.CppException)
        assert "no CUDA device" in errors[0].what()
    assert ran == []


def test_refine_segments_thread_refuses_without_card(tmp_path, monkeypatch):
    """The segments thread resolves ``None`` to every card; with none its
    first message is the CppException, then True, and nothing runs."""
    from polychase_tpu_torch.parallel import segments

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(segments, "refine_segments",
                        lambda *a, **k: ran.append(a))
    accel = pc.AcceleratedMesh(np.zeros((3, 3), np.float32),
                               np.array([[0, 1, 2]], np.uint32))
    errors = []
    thread = pc.RefineSegmentsThread(
        str(tmp_path / "flow.db"), [pc.CameraTrajectory(0, 3)], EYE, accel,
        False, False, pc.BundleOptions())
    assert drain(thread, errors=errors) == []
    assert len(errors) == 1 and isinstance(errors[0], pc.CppException)
    assert "no CUDA device" in errors[0].what()
    assert ran == []
