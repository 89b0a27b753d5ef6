"""The port's chained skip fan (``POLYCHASE_LK_CHAIN=1``) against the JAX
package's, on the CPU.

The reference runs its XLA arm with the compressed result transfer off
(``POLYCHASE_LK_COMPRESS=0``).  Tolerances:

- the phase plan and ``chain_engages``: equal to the reference's;
- the chained fan on the cases of test_lk.py:217-330 (non-linear motion,
  a resume-shaped fan with a gap), the port on the reference's own
  prepared levels: test_torch_lk.py's bounds for the multi-target solve
  against the XLA arm (status equal on ≥ 99% of the pairs, 1e-3 px and err
  1e-3 on the pairs both keep), and the reference test's own checks on the
  port (the true motion within 0.15 / 0.1 px, the unchained solve within a
  median 0.05 px);
- K2 once per level and K3 once per level per phase;
- a chained analyze against the reference's chained analyze on
  test_opticalflow.py's clip: test_torch_opticalflow.py's bounds (status
  agreement > 97%, 0.05 px on flows both keep), and the reference's parity
  test (:119-170) on the port, chained against unchained, cancel and
  resume (:173-200);
- the feature-split phases on 8 CPU shards: the one-device chained solve
  to the bit, and the JAX ``sharded_lk_chain_*`` on the 8-device CPU mesh
  (test_sharded_analyze.py:334) at the multi-target bounds above.
"""

import numpy as np
import pytest
import torch

from polychase_tpu.engine import lk as JL
from polychase_tpu.engine import opticalflow as JO
from polychase_tpu.engine.gftt import (
    GFTTOptions as JGFTTOptions,
    good_features_to_track,
)

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine import lk as TL
from polychase_tpu_torch.engine import opticalflow as TO
from polychase_tpu_torch.io.database import Database
from polychase_tpu_torch.kernels import lk_iter, lk_prep

from test_lk import shift_image, textured
from test_opticalflow import make_clip
from test_sharded_analyze import _clip
from test_torch_opticalflow import assert_flows_match

torch.set_num_threads(1)

CPU = torch.device("cpu")
STATUS_AGREE, POS_ATOL, ERR_ATOL = 0.99, 1e-3, 1e-3


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setenv("POLYCHASE_LK_COMPRESS", "0")
    monkeypatch.setenv("POLYCHASE_LK_CHAIN", "1")


def _both(frames):
    """JAX pyramids of ``frames`` and the same levels in the port."""
    ref = [JL.prepare_pyramid(f, JL.LKOptions()) for f in frames]
    return ref, [convert.pyramid(p, device=CPU) for p in ref]


def _jax_fan(prev, targets, pts, skips):
    h = JL.calc_optical_flow_multi_async(prev, targets, pts, JL.LKOptions(),
                                         skips=skips)
    assert h[0] == "devch"
    return JL.calc_optical_flow_multi_finish(h)


def _port_fan(prev, targets, pts, skips, devices=None):
    return TL.calc_optical_flow_multi_finish(TL.calc_optical_flow_multi_async(
        prev, targets, pts, TL.LKOptions(), skips, devices=devices))


def _assert_solves_match(ref, got):
    rn, rs, re = ref
    gn, gs, ge = got
    assert gn.shape == rn.shape and gs.dtype == bool
    assert rs.mean() > 0.8
    assert np.mean(rs == gs) >= STATUS_AGREE
    both = rs & gs
    assert np.abs(rn[both] - gn[both]).max() < POS_ATOL
    np.testing.assert_allclose(ge[both], re[both], atol=ERR_ATOL)


@pytest.mark.parametrize("skips", [
    [-8, -4, -2, -1, 1, 2, 4, 8], [1, 2, 4, 8], [-1, 1, 4], [-1, 1],
    [2, 8], [-4, -2, 1], [3, -6, 1],
])
def test_chain_plan_matches_jax(skips):
    assert TL._chain_plan(skips) == JL._chain_plan(skips)


def test_chain_engages(monkeypatch):
    monkeypatch.setenv("POLYCHASE_SHARD_ANALYZE", "0")  # JAX: one device
    fan = [-2, -1, 1, 2, 4, 8]
    assert TL.chain_engages(fan) and JL.chain_engages(fan)
    assert not TL.chain_engages([-1, 1]) and not TL.chain_engages(None)
    # Several devices: only in the feature split.
    m = TL.FEAT_SHARD_MIN
    assert TL.chain_engages(fan, m, 2)
    assert not TL.chain_engages(fan, m - 1, 2)
    assert not TL.chain_engages(fan, None, 2)
    monkeypatch.setenv("POLYCHASE_LK_CHAIN", "0")
    assert not TL.chain_engages(fan) and not JL.chain_engages(fan)


@pytest.mark.parametrize("case", ["nonlinear", "resume_gap"])
def test_chained_fan_matches_jax(rng, monkeypatch, case):
    monkeypatch.setenv("POLYCHASE_SHARD_ANALYZE", "0")
    img1 = textured(rng)
    if case == "nonlinear":
        # skip 2 is not twice skip 1, skip 4 turns around
        shifts = {1: (1.5, -1.0), 2: (7.0, 3.5), 4: (-5.0, 4.0)}
        n_pts, atol = 120, 0.15
    else:
        # only skips 2 and 8 are missing: the seed crosses the gap at 4x
        shifts = {2: (1.6, -1.2), 8: (6.4, -4.8)}
        n_pts, atol = 100, 0.1
    skips = list(shifts)
    tgts = [shift_image(img1, *shifts[s]) for s in skips]
    pts, _ = good_features_to_track(img1, None, JGFTTOptions(min_distance=9))
    pts = pts[:n_pts]
    (ref_prev, *ref_tgts), (prev, *tgts_p) = _both([img1] + tgts)
    ref = _jax_fan(ref_prev, ref_tgts, pts, skips)
    p0, i0 = lk_prep.launches, lk_iter.launches
    got = _port_fan(prev, tgts_p, pts, skips)
    assert (lk_prep.launches, lk_iter.launches) == (p0, i0)  # CPU: plain
    _assert_solves_match(ref, got)

    monkeypatch.setenv("POLYCHASE_LK_CHAIN", "0")
    un, us, _ = _port_fan(prev, tgts_p, pts, skips)
    cn, cs, _ = got
    for i, s in enumerate(skips):
        med = np.median(cn[i][cs[i]] - pts[cs[i]], axis=0)
        np.testing.assert_allclose(med, shifts[s], atol=atol)
        both = cs[i] & us[i]
        assert both.sum() > 0.8 * len(pts)
        d = np.linalg.norm(cn[i][both] - un[i][both], axis=1)
        assert np.median(d) < 0.05


def test_chained_fan_launches_k2_per_level_and_k3_per_phase(rng,
                                                            monkeypatch):
    """K2's and K3's wrappers (the plain versions on the CPU) are called
    ``levels`` and ``levels × phases`` times for one chained fan."""
    frames = [textured(np.random.default_rng(s)) for s in range(3)]
    _, (prev, a, b) = _both(frames)
    pts = rng.uniform((12, 12), (188, 148), (64, 2)).astype(np.float32)
    calls = {"prep": 0, "iter": 0}
    for mod, fn, key in ((lk_prep, "lk_prep_level", "prep"),
                         (lk_iter, "lk_iter_level", "iter")):
        real = getattr(mod, fn)

        def counted(*args, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(mod, fn, counted)
    skips = [-1, 1, 2, 4]   # phases |1|, |2|, |4|
    _port_fan(prev, [a, b, a, b], pts, skips)
    levels = prev.num_levels
    assert calls == {"prep": levels, "iter": levels * 3}


def _analyze(frames, path, port, callback=None):
    n = len(frames)
    accessor = lambda f: frames[f]  # noqa: E731
    opts = JGFTTOptions(min_distance=7)
    if port:
        TO.generate_optical_flow_database(
            TO.VideoInfo(160, 120, 0, n), accessor, callback, path,
            convert.gftt_options(opts), device=CPU)
    else:
        JO.generate_optical_flow_database(JO.VideoInfo(160, 120, 0, n),
                                          accessor, callback, path, opts)


def test_chained_analyze_matches_jax(tmp_path, rng, monkeypatch):
    monkeypatch.setenv("POLYCHASE_SHARD_ANALYZE", "0")
    frames = make_clip(rng)[:10]
    ref_db, got_db = str(tmp_path / "jax.db"), str(tmp_path / "port.db")
    _analyze(frames, ref_db, port=False)
    chained = []
    real = TL._chained_dispatch
    monkeypatch.setattr(TL, "_chained_dispatch", lambda *a: (
        chained.append(a[2]), real(*a))[1])
    _analyze(frames, got_db, port=True)
    assert len(chained) == 10 and chained[0] == [1, 2, 4, 8]
    assert_flows_match(ref_db, got_db, frames)

    # The reference's parity test on the port: chained against unchained.
    monkeypatch.setenv("POLYCHASE_LK_CHAIN", "0")
    plain_db = str(tmp_path / "plain.db")
    _analyze(frames, plain_db, port=True)
    db_c, db_u = Database(got_db), Database(plain_db)
    try:
        agree = total = 0
        for f in range(10):
            np.testing.assert_array_equal(db_c.read_keypoints(f),
                                          db_u.read_keypoints(f))
            for s in TO.IMAGE_SKIPS:
                if not 0 <= f + s < 10:
                    continue
                fc = db_c.read_image_pair_flow(f, f + s)
                fu = db_u.read_image_pair_flow(f, f + s)
                ic = dict(zip(fc.src_kps_indices.tolist(), fc.tgt_kps))
                iu = dict(zip(fu.src_kps_indices.tolist(), fu.tgt_kps))
                shared = set(ic) & set(iu)
                total += max(len(ic), len(iu))
                agree += len(shared)
                if shared:
                    d = np.array([ic[i] - iu[i] for i in shared])
                    assert np.median(np.linalg.norm(d, axis=1)) < 0.05
        assert agree / total > 0.97
    finally:
        db_c.close()
        db_u.close()


def test_chained_cancel_and_resume(tmp_path, rng):
    frames = make_clip(rng)[:10]
    db_path = str(tmp_path / "flow.db")
    seen = []

    def cb(p, msg):
        seen.append(msg)
        return len(seen) < 4

    _analyze(frames, db_path, port=True, callback=cb)
    assert seen[-1] == "Cancelled"
    _analyze(frames, db_path, port=True)
    db = Database(db_path)
    try:
        for f in range(10):
            assert db.read_keypoints(f).shape[0] > 10
            expected = {f + s for s in TO.IMAGE_SKIPS if 0 <= f + s < 10}
            assert set(db.find_optical_flows_from_image(f)) == expected
    finally:
        db.close()


def test_feature_split_chain_matches_one_device_and_jax(rng, monkeypatch):
    """test_sharded_analyze.py:334's fan: 300 points of its clip, skips
    [-1, 1, 2, 4, 8] from frame 1, the features split 8 ways (the reference
    on its 8-device CPU mesh from 64 features)."""
    monkeypatch.setenv("POLYCHASE_FEAT_SHARD_MIN", "64")
    monkeypatch.setattr(TL, "FEAT_SHARD_MIN", 64)
    frames = [f.astype(np.uint8) for f in _clip(rng)]
    pts = rng.uniform((12, 12), (148, 84), (300, 2)).astype(np.float32)
    skips = [-1, 1, 2, 4, 8]
    ref_pyrs, pyrs = _both(frames)
    assert JL.chain_engages(skips, len(pts))
    ref = _jax_fan(ref_pyrs[1], [ref_pyrs[1 + s] for s in skips], pts, skips)

    targets = [pyrs[1 + s] for s in skips]
    one = _port_fan(pyrs[1], targets, pts, skips)
    calls = []
    from polychase_tpu_torch.parallel import analyze as PA

    real = PA.sharded_lk_chain_phase
    monkeypatch.setattr(PA, "sharded_lk_chain_phase", lambda chain, *a, **k: (
        calls.append(len(chain)), real(chain, *a, **k))[1])
    split = _port_fan(pyrs[1], targets, pts, skips, devices=["cpu"] * 8)
    assert calls == [8] * 4   # 4 phases, each on 8 shards
    for a, b in zip(split, one):
        np.testing.assert_array_equal(a, b)
    _assert_solves_match(ref, split)
