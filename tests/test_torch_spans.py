"""The host spans of the port's tracker and refiner under ``torch.profiler``
on the CPU, on a small synthetic clip (40 frames, 64 keypoints a frame, a
12 × 16 UV sphere): how often each opens, how they nest, that none is left
open by a cancel or an error, and that a profiler changes no result."""

import math
import shutil
import sqlite3

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from polychase_tpu_torch.engine import refiner as R
from polychase_tpu_torch.engine import tracker as T
from polychase_tpu_torch.engine.camera import OPENCV, Intrinsics
from polychase_tpu_torch.engine.geometry import Mesh, SceneTransformations
from polychase_tpu_torch.engine.levmarq import BundleOptions
from polychase_tpu_torch.engine.pose import quat_to_mat_np
from polychase_tpu_torch.synthetic import (
    build_flow_db, noisy_trajectory, orbit_poses, uv_sphere,
)

torch.set_num_threads(1)

FRAMES, KEYPOINTS = 40, 64
TRACK_SPANS = ("track.setup", "track.pack", "track.step", "track.deliver")
REFINE_SPANS = ("refine.data", "refine.setup", "refine.iteration",
                "refine.finish")
REFINE_LABELS = ("refine.raycast", "refine.cost", "refine.normal_equations",
                 "refine.solve", "refine.step")
AFTER = "after.call"
DEV = torch.device("cpu")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    verts, tris = uv_sphere(12, 16)
    mesh = Mesh.create(verts, tris, device=DEV)
    intr = Intrinsics.create(1800, 1800, 960, 540, 1, 1920, 1080, OPENCV,
                             device=DEV)
    poses = orbit_poses(FRAMES)
    db = str(tmp_path_factory.mktemp("spans") / "flow.db")
    build_flow_db(db, mesh, 1800.0, 1920, 1080, poses,
                  np.random.default_rng(0), KEYPOINTS, 0.3)
    return dict(mesh=mesh, intr=intr, poses=poses, db=db)


def _scene(clip, frame):
    q, t = clip["poses"][frame]
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = quat_to_mat_np(q)
    view[:3, 3] = t
    return SceneTransformations(torch.eye(4), torch.as_tensor(view),
                                clip["intr"])


def _spans(prof, names):
    """(start, end, name) of each host event named in ``names``, by
    start."""
    cpu = torch.autograd.DeviceType.CPU
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cpu and e.name() in names)


def _profiled(fn):
    """``fn()`` under a CPU profiler, then an ``AFTER`` label; returns
    what ``fn`` returned or raised, and the spans and labels."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        try:
            out = fn()
        except T.TrackingError as exc:
            out = exc
        with record_function(AFTER):
            pass
    return out, _spans(prof, TRACK_SPANS + REFINE_SPANS + REFINE_LABELS
                       + (AFTER,))


def _count(spans, name):
    return sum(n == name for _, _, n in spans)


def _closed_before_after(spans):
    """Every span and label ends before the ``AFTER`` label opens."""
    (after,) = [s for s, _, n in spans if n == AFTER]
    return all(e <= after for _, e, n in spans if n != AFTER)


def _track(clip, frm, to, callback=None, db=None):
    got = []

    def cb(r):
        got.append((r.frame, r.pose.q.numpy().copy(),
                    r.pose.t.numpy().copy(),
                    [float(v) for v in (r.intrinsics.fx, r.intrinsics.fy,
                                        r.intrinsics.cx, r.intrinsics.cy)]))
        return True if callback is None else callback(r)

    T.track_sequence(db or clip["db"], frm, to, _scene(clip, frm),
                     clip["mesh"], cb, device=DEV)
    return got


@pytest.fixture(scope="module", params=["forward", "backward"])
def tracked(request, clip):
    frm, to = (0, FRAMES - 1) if request.param == "forward" else (
        FRAMES - 1, 0)
    got, spans = _profiled(lambda: _track(clip, frm, to))
    return got, spans


@pytest.mark.parametrize("name", TRACK_SPANS)
def test_track_spans_counted(tracked, name):
    got, spans = tracked
    steps = FRAMES - 1
    want = {"track.setup": 1, "track.step": steps,
            "track.pack": math.ceil(steps / T.FLUSH_FRAMES),
            "track.deliver": math.ceil(steps / T.FLUSH_FRAMES)}[name]
    assert len(got) == steps
    assert _count(spans, name) == want


def test_track_spans_do_not_nest(tracked):
    _, spans = tracked
    track = [s for s in spans if s[2] in TRACK_SPANS]
    for (s0, e0, n0), (s1, e1, n1) in zip(track, track[1:]):
        assert e0 <= s1, (n0, n1)
    assert _closed_before_after(spans)


def _drop_flows_into(db, frame, tmp_path):
    path = str(tmp_path / "holed.db")
    shutil.copy(db, path)
    con = sqlite3.connect(path)
    with con:
        con.execute("DELETE FROM optical_flow WHERE image_id_to = ?",
                    (frame,))
    con.close()
    return path


def _bad_index(db, tmp_path):
    """A flow into frame 1 indexing past frame 0's keypoints."""
    from polychase_tpu_torch.io.database import Database

    path = str(tmp_path / "bad.db")
    shutil.copy(db, path)
    d = Database(path)
    try:
        n = d.read_keypoints(0).shape[0]
        d.write_image_pair_flow(0, 1, np.array([n + 3], np.uint32),
                                np.full((1, 2), 900.0, np.float32),
                                np.zeros(1, np.float32))
    finally:
        d.close()
    return path


# case → (how the pass ends, frames delivered, its spans' counts)
EARLY_EXITS = {
    "cancel": (None, 5, dict(setup=1, pack=1, step=T.FLUSH_FRAMES,
                             deliver=1)),
    "frame_error": (T.TrackingError, 4, dict(setup=1, pack=1,
                                             step=T.FLUSH_FRAMES,
                                             deliver=1)),
    "setup_error": (T.TrackingError, 0, dict(setup=1, pack=0, step=0,
                                             deliver=0)),
}


@pytest.mark.parametrize("case", sorted(EARLY_EXITS))
def test_track_leaves_no_span_open(clip, tmp_path, case):
    """A callback that returns False mid-chunk, a frame without flows
    (``TrackingError`` while delivering) and a flow past its keypoints
    (``TrackingError`` while setting up) each close every span."""
    raised, delivered, counts = EARLY_EXITS[case]
    db = {"cancel": clip["db"],
          "frame_error": _drop_flows_into(clip["db"], 5, tmp_path),
          "setup_error": _bad_index(clip["db"], tmp_path)}[case]
    stop = (lambda r: r.frame < 5) if case == "cancel" else None
    got, spans = _profiled(lambda: _track(clip, 0, FRAMES - 1, stop, db))
    if raised is None:
        assert isinstance(got, list) and len(got) == delivered
    else:
        assert isinstance(got, raised)
    for short, n in counts.items():
        assert _count(spans, f"track.{short}") == n, short
    assert _closed_before_after(spans)


def _refine(clip, max_iterations, callback=None):
    """Refine the clip from a noisy start; returns the refined poses, the
    progress reports' stats and the LM loop's passes (its reads)."""
    traj = noisy_trajectory(clip["poses"], clip["intr"],
                            np.random.default_rng(1))
    stats, reads = [], [0]
    read = R._read_scalars

    def counted(vec):
        reads[0] += 1
        return read(vec)

    def cb(update):
        stats.append(update.stats)
        return True if callback is None else callback(update)

    R._read_scalars = counted
    try:
        R.refine_trajectory(clip["db"], traj, np.eye(4, dtype=np.float32),
                            clip["mesh"], True, False, cb,
                            BundleOptions(max_iterations=max_iterations),
                            device=DEV)
    finally:
        R._read_scalars = read
    poses = np.stack([np.concatenate([traj.get(i).pose.q.numpy(),
                                      traj.get(i).pose.t.numpy(),
                                      [float(traj.get(i).intrinsics.fy)]])
                      for i in range(FRAMES)])
    return poses, stats, reads[0]


# max_iterations: 2 runs the loop out; 30 leaves it on a tolerance.
@pytest.fixture(scope="module", params=[2, 30])
def refined(request, clip):
    (poses, stats, reads), spans = _profiled(
        lambda: _refine(clip, request.param))
    return poses, stats, reads, spans


@pytest.mark.parametrize("name", REFINE_SPANS)
def test_refine_spans_counted(refined, name):
    """One data, setup and finish span a call; one iteration span a pass
    through the LM loop: the iterations counted, or one more where the
    loop left before counting its last pass."""
    _, stats, reads, spans = refined
    iterations = int(stats[-1].iterations)
    assert reads in (iterations, iterations + 1)
    want = reads if name == "refine.iteration" else 1
    assert _count(spans, name) == want


@pytest.mark.parametrize("label", REFINE_LABELS)
def test_refine_labels_nest_in_setup_or_iteration(refined, label):
    _, _, _, spans = refined
    outer = [(s, e) for s, e, n in spans
             if n in ("refine.setup", "refine.iteration")]
    inner = [(s, e) for s, e, n in spans if n == label]
    assert inner
    for s, e in inner:
        assert any(s0 <= s and e <= e0 for s0, e0 in outer), label


def test_refine_spans_do_not_overlap(refined):
    _, _, _, spans = refined
    phases = [s for s in spans if s[2] in REFINE_SPANS]
    for (s0, e0, n0), (s1, e1, n1) in zip(phases, phases[1:]):
        assert e0 <= s1, (n0, n1)
    assert _closed_before_after(spans)


def test_refine_cancel_leaves_no_span_open(clip):
    """A progress callback that cancels leaves the loop from inside its
    iteration span; the finish span still runs, and everything closes."""
    calls = []

    def stop(update):
        calls.append(update)
        return len(calls) < 2

    (_, _, reads), spans = _profiled(lambda: _refine(clip, 30, stop))
    assert _count(spans, "refine.iteration") == reads
    assert _count(spans, "refine.finish") == 1
    assert _closed_before_after(spans)


@pytest.mark.parametrize("entry", ["track", "refine"])
def test_results_same_with_and_without_a_profiler(clip, entry):
    if entry == "track":
        plain = _track(clip, 0, FRAMES - 1)
        traced, _ = _profiled(lambda: _track(clip, 0, FRAMES - 1))
        assert [r[0] for r in plain] == [r[0] for r in traced]
        for a, b in zip(plain, traced):
            for x, y in zip(a[1:], b[1:]):
                np.testing.assert_array_equal(x, y)
    else:
        plain = _refine(clip, 30)
        (traced, _, _), _ = _profiled(lambda: _refine(clip, 30))
        np.testing.assert_array_equal(plain[0], traced)

