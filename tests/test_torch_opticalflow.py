"""The port's analyze (``generate_optical_flow_database`` on the CPU)
against the JAX package's on the same clip, and its resume, cancel and
error contract.

The reference runs with its compressed result transfer off and on one
device (``POLYCHASE_LK_COMPRESS=0``, ``POLYCHASE_SHARD_ANALYZE=0``): both
are transport, not semantics.  Flows are held on the keypoints both
detect, with the LK bounds of ``test_lk_pallas.py`` (status agreement
> 97%, 0.05 px on flows both keep); a flow outside them must come back
within them when the port solves it on the reference's prepared levels.
"""

import sqlite3

import cv2
import numpy as np
import pytest
import torch

from polychase_tpu.engine import lk as JL
from polychase_tpu.engine import opticalflow as JO
from polychase_tpu.engine.gftt import GFTTOptions as JGFTTOptions
from polychase_tpu.io.database import Database

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine import lk as TL
from polychase_tpu_torch.engine import opticalflow as TO
from polychase_tpu_torch.kernels import lk_iter, lk_prep
from polychase_tpu_torch.synthetic import panning_clip

from test_opticalflow import make_clip

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _flows(db_path, n):
    """{(src, dst): {keypoint (x, y): (target (x, y))}} and keypoints."""
    db = Database(db_path)
    try:
        kps = [db.read_keypoints(f) for f in range(n)]
        flows = {}
        for f in range(n):
            for g in db.find_optical_flows_from_image(f):
                fl = db.read_image_pair_flow(f, g)
                src = kps[f][fl.src_kps_indices]
                flows[(f, g)] = {tuple(s): t for s, t in
                                 zip(src.tolist(), fl.tgt_kps)}
        return kps, flows
    finally:
        db.close()


def test_analyze_matches_jax(tmp_path, rng, monkeypatch):
    monkeypatch.setenv("POLYCHASE_LK_COMPRESS", "0")
    monkeypatch.setenv("POLYCHASE_SHARD_ANALYZE", "0")
    frames = make_clip(rng)
    n = len(frames)
    info = JO.VideoInfo(width=160, height=120, first_frame=0, num_frames=n)
    opts = JGFTTOptions(min_distance=7)
    ref_db, got_db = str(tmp_path / "jax.db"), str(tmp_path / "port.db")
    JO.generate_optical_flow_database(info, lambda f: frames[f], None,
                                      ref_db, opts)
    progress = []
    TO.generate_optical_flow_database(
        convert.video_info(info), lambda f: frames[f],
        lambda p, m: progress.append((p, m)) or True, got_db,
        convert.gftt_options(opts), device=CPU)
    assert progress[-1] == (1.0, "Done")
    flows = assert_flows_match(ref_db, got_db, frames)
    # the clip pans (2, 1) px per frame: frame f → f+1 flows by (-2, -1)
    f3 = flows[(3, 4)]
    med = np.median(np.array([t - np.array(s) for s, t in f3.items()]), 0)
    np.testing.assert_allclose(med, [-2.0, -1.0], atol=0.1)


def assert_flows_match(ref_db, got_db, frames):
    """The port's DB against the reference's on the same clip, with the LK
    bounds of the module docstring; returns the port's flows."""
    n = len(frames)
    ref_kps, ref_flows = _flows(ref_db, n)
    kps, flows = _flows(got_db, n)
    assert set(flows) == set(ref_flows)
    assert set(flows) == {(f, f + s) for f in range(n)
                          for s in TO.IMAGE_SKIPS if 0 <= f + s < n}
    for f in range(n):
        r = {tuple(p) for p in ref_kps[f].tolist()}
        g = {tuple(p) for p in kps[f].tolist()}
        assert len(r) > 10
        assert len(r & g) >= 0.99 * len(r)
    agree = total = 0
    outliers = []
    for pair, rf in ref_flows.items():
        gf = flows[pair]
        shared = {tuple(p) for p in ref_kps[pair[0]].tolist()} & {
            tuple(p) for p in kps[pair[0]].tolist()}
        for p in shared:
            total += 1
            agree += (p in rf) == (p in gf)
            if p in rf and p in gf and np.abs(rf[p] - gf[p]).max() >= 0.05:
                outliers.append((pair, p))
    assert agree / total > 0.97
    both = sum(len(set(rf) & set(flows[k])) for k, rf in ref_flows.items())
    assert len(outliers) <= both // 1000
    # A feature at the frame's edge can take another path down the coarse
    # levels from a last-bit difference in the pyramids (XLA contracts the
    # filters' multiply-adds).  On the reference's own prepared levels the
    # port's solve lands where the reference's does.
    for (f, g), p in outliers:
        src = convert.pyramid(JL.prepare_pyramid(JO.rgb_to_gray(frames[f])),
                              device=CPU)
        dst = convert.pyramid(JL.prepare_pyramid(JO.rgb_to_gray(frames[g])),
                              device=CPU)
        nxt, st, _ = TL.calc_optical_flow(src, dst, np.array([p]))
        assert st[0]
        assert np.abs(nxt[0] - ref_flows[(f, g)][p]).max() < 0.05
    return flows


def test_panning_clip_ground_truth(tmp_path):
    """Config 1b's clip at a small size: every pair exists, and skips ±1 and
    ±2 flow at −s·step.  (At ±4 and ±8 the pan leaves LK's basin on this
    blurred noise: OpenCV and the reference miss those pairs as well.)"""
    step = (3, 2)
    frames = panning_clip(np.random.default_rng(0), 10, 128, 96, step)
    db_path = str(tmp_path / "flow.db")
    p0, i0 = lk_prep.launches, lk_iter.launches
    TO.generate_optical_flow_database(
        TO.VideoInfo(128, 96, 0, 10), lambda f: frames[f], None, db_path,
        device=CPU)
    assert (lk_prep.launches, lk_iter.launches) == (p0, i0)  # CPU: plain
    db = Database(db_path)
    try:
        for f in range(10):
            kps = db.read_keypoints(f)
            assert kps.shape[0] > 50
            for s in TO.IMAGE_SKIPS:
                if not 0 <= f + s < 10:
                    continue
                fl = db.read_image_pair_flow(f, f + s)
                if abs(s) > 2:
                    continue
                d = fl.tgt_kps - kps[fl.src_kps_indices]
                err = np.linalg.norm(d + s * np.array(step), axis=1)
                assert np.median(err) <= 0.05, (f, s, np.median(err))
                if abs(s) == 1:
                    assert fl.src_kps_indices.size >= 0.9 * kps.shape[0]
    finally:
        db.close()


def test_resume_skips_existing(tmp_path, rng):
    frames = make_clip(rng)
    info = TO.VideoInfo(160, 120, 0, 6)
    db_path = str(tmp_path / "flow.db")
    calls = []

    def accessor(fid):
        calls.append(fid)
        return frames[fid]

    TO.generate_optical_flow_database(info, accessor, None, db_path,
                                      device=CPU)
    assert len(calls) == 6  # each frame decoded once
    calls.clear()
    TO.generate_optical_flow_database(info, accessor, None, db_path,
                                      device=CPU)
    assert calls == []
    # A pair removed from the DB is solved again, and only that pair.
    db = Database(db_path)
    before = db.read_image_pair_flow(2, 3)
    db.close()
    with sqlite3.connect(db_path) as conn:
        conn.execute("DELETE FROM optical_flow"
                     " WHERE image_id_from = 2 AND image_id_to = 3")
    conn.close()
    TO.generate_optical_flow_database(info, accessor, None, db_path,
                                      device=CPU)
    assert set(calls) == {2, 3}
    db = Database(db_path)
    after = db.read_image_pair_flow(2, 3)
    db.close()
    np.testing.assert_array_equal(after.src_kps_indices,
                                  before.src_kps_indices)
    np.testing.assert_allclose(after.tgt_kps, before.tgt_kps, atol=1e-4)


def test_cancel(tmp_path, rng):
    frames = make_clip(rng)
    info = TO.VideoInfo(160, 120, 0, 10)
    db_path = str(tmp_path / "flow.db")
    seen = []

    def cb(p, msg):
        seen.append(msg)
        return len(seen) < 3

    TO.generate_optical_flow_database(info, lambda f: frames[f], cb, db_path,
                                      device=CPU)
    assert seen[-1] == "Cancelled"
    db = Database(db_path)
    assert db.read_keypoints(1).shape[0] > 0
    assert db.read_keypoints(5).shape[0] == 0
    db.close()


def test_missing_frame_and_bad_frames(tmp_path):
    info = TO.VideoInfo(160, 120, 0, 4)
    with pytest.raises(TO.FrameNotProvidedError):
        TO.generate_optical_flow_database(
            info, lambda f: None, None, str(tmp_path / "a.db"), device=CPU)
    with pytest.raises(ValueError, match="shape"):
        TO.generate_optical_flow_database(
            info, lambda f: np.zeros((100, 160, 3), np.uint8), None,
            str(tmp_path / "b.db"), device=CPU)
    with pytest.raises(ValueError, match="frame_accessor"):
        TO.generate_optical_flow_database(
            info, None, None, str(tmp_path / "c.db"), device=CPU)
    with pytest.raises(ValueError, match="device"):
        TO.generate_optical_flow_database(
            info, lambda f: None, None, str(tmp_path / "d.db"), device=None)


def test_rgb_to_gray_matches_opencv(rng):
    img = rng.integers(0, 255, (32, 40, 3)).astype(np.uint8)
    golden = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    ours = TO.rgb_to_gray(img)
    assert np.abs(ours.astype(int) - golden.astype(int)).max() <= 1
    np.testing.assert_array_equal(ours, JO.rgb_to_gray(img))


def test_panning_clip_blur_matches_opencv():
    """panning_clip's numpy blur is cv2.GaussianBlur(σ=1.5) on float32."""
    from polychase_tpu_torch.synthetic import _gaussian_blur

    a = np.random.default_rng(3).integers(0, 255, (50, 70)).astype(
        np.float32)
    np.testing.assert_allclose(_gaussian_blur(a, 1.5),
                               cv2.GaussianBlur(a, (0, 0), 1.5), atol=1e-3)
