"""The port's GFTT (plain torch on the CPU, native host finish) against the
JAX package and against OpenCV, on the same numpy images.

Tolerances: response maps rtol 1e-5 of the map's largest value against
the reference (the same taps in the same order), rtol 2e-3 against
``cv2.cornerMinEigenVal`` / ``cornerHarris`` (``test_gftt.py``'s); corners
≥ 99% shared with the reference and their qualities rtol 1e-5.
"""

import cv2
import numpy as np
import pytest
import torch

from polychase_tpu.engine import gftt as JG

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine import gftt as TG

from test_gftt import synth_image

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _responses(img, mask=None, **kw):
    q = kw.pop("quality_level", 1e-12)
    k = kw.pop("harris_k", 0.04)
    ref_eig, ref_cand = JG.gftt_response(
        np.asarray(img, np.float32), None if mask is None else mask != 0,
        np.float32(q), np.float32(k), **kw)
    eig, cand = TG.gftt_response(
        torch.as_tensor(np.asarray(img, np.float32)),
        None if mask is None else torch.as_tensor(mask != 0), q, k, **kw)
    return (np.asarray(ref_eig), np.asarray(ref_cand), eig.numpy(),
            cand.numpy())


@pytest.mark.parametrize("ksize", [1, 3, 5, 7])
@pytest.mark.parametrize("use_harris", [False, True])
def test_response_matches_jax(rng, ksize, use_harris):
    img = synth_image(rng)
    mask = np.zeros_like(img)
    mask[10:100, 20:140] = 1
    ref_eig, ref_cand, eig, cand = _responses(
        img, mask, ksize=ksize, use_harris=use_harris, quality_level=0.01)
    np.testing.assert_allclose(eig, ref_eig, rtol=1e-5,
                               atol=1e-5 * np.abs(ref_eig).max())
    assert (cand != ref_cand).sum() <= max(1, cand.sum() // 100)


@pytest.mark.parametrize("ksize", [1, 3, 5, 7])
def test_min_eigen_map_matches_opencv(rng, ksize):
    img = synth_image(rng)
    golden = cv2.cornerMinEigenVal(img, 3, ksize=ksize)
    eig, _ = TG.gftt_response(torch.as_tensor(img.astype(np.float32)), None,
                              1e-12, 0.04, ksize=ksize)
    eig = eig.numpy()
    sel = golden > golden.max() * 1e-3
    np.testing.assert_allclose(eig[sel], golden[sel], rtol=2e-3, atol=1e-9)


def test_harris_map_matches_opencv(rng):
    img = synth_image(rng)
    golden = cv2.cornerHarris(img, 3, 3, 0.04)
    eig, _ = TG.gftt_response(torch.as_tensor(img.astype(np.float32)), None,
                              1e-12, 0.04, use_harris=True)
    eig = eig.numpy()
    sel = golden > np.abs(golden).max() * 1e-3
    np.testing.assert_allclose(eig[sel], golden[sel], rtol=2e-3, atol=1e-10)


def _both_corners(img, mask, opts):
    ref = JG.good_features_to_track(img, mask, opts)
    got = TG.good_features_to_track(img, mask, convert.gftt_options(opts),
                                    device=CPU)
    return ref, got


def _assert_shared(ref, got):
    rp, rq = ref
    gp, gq = got
    rset = {tuple(p) for p in rp.tolist()}
    gset = {tuple(p) for p in gp.tolist()}
    assert len(rset) > 10
    shared = rset & gset
    assert len(shared) >= 0.99 * len(rset)
    assert len(gset - rset) <= max(1, len(rset) // 100)
    rmap = {tuple(p): q for p, q in zip(rp.tolist(), rq)}
    gmap = {tuple(p): q for p, q in zip(gp.tolist(), gq)}
    for p in shared:
        np.testing.assert_allclose(gmap[p], rmap[p], rtol=1e-5)


@pytest.mark.parametrize("opts", [
    JG.GFTTOptions(),
    JG.GFTTOptions(gradient_size=1),
    JG.GFTTOptions(gradient_size=5),
    JG.GFTTOptions(gradient_size=7, min_distance=3.0),
    JG.GFTTOptions(use_harris=True),
    JG.GFTTOptions(min_distance=0.0, max_corners=40),
])
def test_corners_match_jax(rng, opts):
    img = synth_image(rng)
    _assert_shared(*_both_corners(img, None, opts))


def test_corners_with_mask_match_jax(rng):
    img = synth_image(rng)
    mask = np.zeros_like(img)
    mask[10:100, 20:140] = 255
    ref, got = _both_corners(img, mask, JG.GFTTOptions())
    _assert_shared(ref, got)
    p = got[0]
    assert ((p[:, 0] >= 20) & (p[:, 0] < 140) & (p[:, 1] >= 10)
            & (p[:, 1] < 100)).all()


def test_max_corners_and_ordering(rng):
    img = synth_image(rng)
    pts_all, q_all = TG.good_features_to_track(img, None, device=CPU)
    pts_5, q_5 = TG.good_features_to_track(
        img, None, TG.GFTTOptions(max_corners=5), device=CPU)
    assert pts_5.shape == (5, 2)
    np.testing.assert_array_equal(pts_5, pts_all[:5])
    np.testing.assert_array_equal(q_5, q_all[:5])
    assert np.all(np.diff(q_all) <= 0)


def test_tie_collision_falls_back_to_full_map(monkeypatch):
    """Two adjacent candidates with the same response share a 2×2 block:
    the count sentinel sends the finish to the exact full-map path, which
    keeps the later row-major one of the tie."""
    H, W = 16, 16
    eig = np.zeros((H, W), np.float32)
    eig[5, 6] = eig[5, 7] = 3.0
    eig[10, 3] = 7.0
    monkeypatch.setattr(TG, "gftt_response",
                        lambda img, *a, **k: (img, img > 0))
    vals, idx, count = TG.gftt_candidates_topk(
        torch.as_tensor(eig), None, 0.01, 0.04, k=64)
    assert int(count) > vals.shape[0]
    pts, q = TG.gftt_finish(TG.gftt_dispatch(eig, None, TG.GFTTOptions(),
                                             k=64, device=CPU))
    assert pts.tolist() == [[3.0, 10.0], [7.0, 5.0]]
    assert q.tolist() == [7.0, 3.0]
    # Without the tie the reduction is exact.
    eig[5, 7] = 0.0
    vals, idx, count = TG.gftt_candidates_topk(
        torch.as_tensor(eig), None, 0.01, 0.04, k=64)
    assert int(count) == 2
    got = {(int(i) // W, int(i) % W) for v, i in zip(vals, idx) if v > 0}
    assert got == {(5, 6), (10, 3)}


def test_host_route_matches_jax_device_suppression(rng, monkeypatch):
    """The port suppresses on the host at every size; the reference
    suppresses on the device above a pixel count.  Both give the same
    corners in the same order."""
    img = rng.integers(0, 255, (120, 160)).astype(np.uint8)
    opts = JG.GFTTOptions(min_distance=5.0)
    monkeypatch.setenv("POLYCHASE_GFTT_DEV_SUPPRESS_MIN", "0")
    assert JG.device_suppress_route(img.size, opts)
    ref = JG.gftt_finish(JG.gftt_dispatch(img, None, opts))
    got = TG.good_features_to_track(img, None, convert.gftt_options(opts),
                                    device=CPU)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)


@pytest.mark.parametrize("md,mc", [(5.0, 0), (3.0, 50), (0.0, 30)])
def test_native_sort_suppress_matches_numpy(rng, md, mc):
    """The native fused sort + suppression and the numpy/Python pass the
    port falls back to agree exactly, ties included."""
    tile = rng.random((12, 16)).astype(np.float32)
    vals = np.tile(tile, (4, 5)).reshape(-1)
    lin = rng.permutation(vals.size).astype(np.int64)
    w, h = 80, 48
    native = TG._native_sort_suppress(vals, lin, w, h, md, mc)
    assert native is not None
    np.testing.assert_array_equal(
        native, TG._sort_suppress_numpy(vals, lin, w, h, md, mc))


def test_options_and_empty_images():
    with pytest.raises(ValueError, match="gradient_size"):
        TG.good_features_to_track(np.zeros((32, 32), np.uint8), None,
                                  TG.GFTTOptions(gradient_size=4), device=CPU)
    with pytest.raises(ValueError):
        TG.good_features_to_track(np.zeros((32, 32), np.uint8), None,
                                  TG.GFTTOptions(quality_level=0.0),
                                  device=CPU)
    pts, q = TG.good_features_to_track(np.zeros((0, 0), np.uint8), None,
                                       device=CPU)
    assert pts.shape == (0, 2) and q.shape == (0,)
    pts, _ = TG.good_features_to_track(np.full((64, 64), 128, np.uint8), None,
                                       device=CPU)
    assert pts.shape == (0, 2)
