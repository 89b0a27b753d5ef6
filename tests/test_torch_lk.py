"""The port's pyramid and LK (plain torch, on the CPU) against the JAX
package on the same numpy inputs.

The JAX side runs as its own tests run it here: the XLA arm of
``engine/lk.py`` and the Pallas kernels of ``kernels/lk_pallas.py`` in
interpret mode.  ``convert.pyramid`` puts the same prepared levels under
both packages where a test holds the LK solve alone.

Tolerances:
- pyramid levels and Scharr maps: rtol 1e-6 of each map's largest value
  (the same taps in the same order; XLA may contract a multiply-add);
- per-level prep (K2's plain version): patches 1e-4 absolute, normal
  matrix rtol 1e-5, the gate equal;
- LK against the Pallas kernels: ``test_lk_pallas.py``'s bounds (status
  agreement > 97%, 0.05 px on features both keep); against the XLA arm on
  the same levels the solve is the same float program up to sum order, so
  status agreement ≥ 99% and 1e-3 px.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychase_tpu.engine import lk as JL
from polychase_tpu.kernels import lk_pallas as lkp

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine import lk as TL
from polychase_tpu_torch.engine.gftt import GFTTOptions, good_features_to_track

from test_lk import textured
from test_lk_pallas import _make_pair, _pallas_pyr

torch.set_num_threads(1)

CPU = torch.device("cpu")
OPTS = TL.LKOptions()
EPS2 = float(OPTS.term_epsilon ** 2)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("shape", [(160, 200), (23, 45)])
def test_pyramid_and_scharr_match_jax(rng, shape):
    """Every prepared level (padded image, dx, dy) equals the reference's.
    The 23×45 frame's top level is 12×23, narrower than the pad + 1, so its
    reflect padding goes in stages."""
    img = textured(rng, *shape)
    levels = JL.num_pyramid_levels(*img.shape, JL.LKOptions())
    assert TL.num_pyramid_levels(*img.shape, OPTS) == levels
    ref = JL._prepare_levels(JL.build_pyramid(jnp.asarray(img), levels),
                             win=OPTS.window_size, levels=levels)
    got = TL.prepare_pyramid(img, OPTS, device=CPU)
    assert got.num_levels == levels
    for lvl in range(levels):
        assert got.levels[lvl][3] == tuple(int(v) for v in ref[lvl][3])
        for a, b in zip(got.levels[lvl][:3], ref[lvl][:3]):
            b = np.asarray(b)
            assert a.shape == b.shape
            np.testing.assert_allclose(
                a.numpy(), b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


def _levels_both(img):
    """JAX XLA-flavor prepared levels and the same levels in the port."""
    levels = JL.num_pyramid_levels(*img.shape, JL.LKOptions())
    ref = JL.PyramidCache(
        JL._prepare_levels(JL.build_pyramid(jnp.asarray(img), levels),
                           win=OPTS.window_size, levels=levels),
        levels, JL.LKOptions())
    return ref, convert.pyramid(ref, device=CPU)


def test_prep_level_matches_pallas_interpret():
    """K2's plain version against ``lk_prepare_level`` (the Pallas
    extraction kernel in interpret mode and its XLA tail) at two levels."""
    img1, _ = _make_pair()
    h, w = img1.shape
    rng = np.random.default_rng(1)
    n = lkp.GROUP
    pts = rng.uniform((12, 12), (w - 12, h - 12), (n, 2)).astype(np.float32)
    _, got = _levels_both(img1)
    data, dims, _ = _pallas_pyr(img1, JL.LKOptions())
    win = OPTS.window_size
    for lvl in (0, 2):
        lp = pts * (1.0 / (1 << lvl))
        H, W = dims[lvl]
        img, dx, dy, _ = got.levels[lvl]
        ours = [_np(t) for t in TL.prep_level(
            img, dx, dy, torch.as_tensor(lp), win=win, H=H, W=W,
            min_eig_thr=OPTS.min_eigen_threshold)]
        pal = [np.asarray(a) for a in lkp.lk_prepare_level(
            *data[lvl][:3], jnp.asarray(lp), win=win, H=H, W=W,
            min_eig_thr=OPTS.min_eigen_threshold, interpret=True)]
        # The port's patches are feature-major (N, 3, win, win); the
        # Pallas arm's are three feature-minor (win, win, N) planes.
        assert ours[0].shape == (n, 3, win, win)
        for k in range(3):
            np.testing.assert_allclose(ours[0][:, k],
                                       pal[k].transpose(2, 0, 1), rtol=0,
                                       atol=1e-4)
        for a, b in zip(ours[1:4], pal[3:6]):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())
        np.testing.assert_allclose(ours[4], pal[6], rtol=1e-4)
        np.testing.assert_array_equal(ours[5], pal[7])
        assert ours[5].mean() > 0.9


def test_prep_level_gates_out_of_bounds_and_nan():
    """Positions far outside the level, huge or NaN read a clamped window
    inside the buffer and fail the gate."""
    img1, _ = _make_pair()
    _, got = _levels_both(img1)
    img, dx, dy, (H, W) = got.levels[0]
    pts = torch.tensor([[-30.0, 5.0], [W + 40.0, 20.0], [np.nan, 3.0],
                        [5.0, 1e9], [-1e30, -1e30], [50.0, 40.0]])
    out = TL.prep_level(img, dx, dy, pts, win=OPTS.window_size, H=H, W=W,
                        min_eig_thr=OPTS.min_eigen_threshold)
    assert out[5].tolist() == [False] * 5 + [True]
    assert (out[4][:5] == 0).all()


def test_lk_level_matches_jax_xla():
    """One level of the plain solve against the XLA arm's ``_lk_level`` on
    the same levels and guesses, at every level."""
    img1, img2 = _make_pair()
    h, w = img1.shape
    rng = np.random.default_rng(2)
    pts = rng.uniform((4, 4), (w - 4, h - 4), (200, 2)).astype(np.float32)
    r1, g1 = _levels_both(img1)
    r2, g2 = _levels_both(img2)
    for lvl in range(r1.num_levels):
        s = 1.0 / (1 << lvl)
        prev = pts * s
        guess = (pts + rng.normal(0, 1.5, pts.shape).astype(np.float32)) * s
        imgp, dxp, dyp, shape = r1.levels[lvl]
        jn, js, je = JL._lk_level(
            imgp, dxp, dyp, r2.levels[lvl][0], jnp.asarray(prev),
            jnp.asarray(guess), jnp.ones(len(pts), bool), jnp.bool_(lvl == 0),
            shape, jnp.float32(EPS2), jnp.float32(OPTS.min_eigen_threshold),
            win=OPTS.window_size, max_iters=OPTS.term_max_iters,
        )
        tn, ts, te = TL._lk_level(
            g1.levels[lvl], g2.levels[lvl][0][None], torch.as_tensor(prev),
            torch.as_tensor(guess)[None], level_is_zero=(lvl == 0),
            eps2=EPS2, min_eig_thr=OPTS.min_eigen_threshold,
            win=OPTS.window_size, max_iters=OPTS.term_max_iters,
        )
        js, ts = np.asarray(js), ts[0].numpy()
        assert np.mean(js == ts) >= 0.99
        both = js & ts
        d = np.abs(np.asarray(jn)[both] - tn[0].numpy()[both]).max()
        assert d < 1e-3, (lvl, d)
        if lvl == 0:
            np.testing.assert_allclose(te[0].numpy()[both],
                                       np.asarray(je)[both], atol=1e-3)


def test_iter_level_counts_the_iterations_each_pair_needs():
    """The counted plain iteration returns what ``iter_level`` returns and,
    per pair, the windows it sampled: none for a gated-out feature, one for
    a feature tracked into its own frame (its first step converges), at
    most ``max_iters``."""
    img1, img2 = _make_pair()
    _, g1 = _levels_both(img1)
    _, g2 = _levels_both(img2)
    img, dx, dy, (H, W) = g1.levels[0]
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(
        rng.uniform((12, 12), (W - 12, H - 12), (64, 2)).astype(np.float32))
    prep = list(TL.prep_level(img, dx, dy, pts, win=OPTS.window_size, H=H,
                              W=W, min_eig_thr=OPTS.min_eigen_threshold))
    prep[5] = prep[5].clone()
    prep[5][:4] = False
    imgs = torch.stack([img, g2.levels[0][0]])
    kw = dict(win=OPTS.window_size, H=H, W=W, max_iters=OPTS.term_max_iters,
              eps2=EPS2, level_is_zero=True)
    guess = pts.expand(2, *pts.shape).contiguous()
    *out, iters = TL.iter_level_counted(imgs, *prep, guess, **kw)
    for a, b in zip(out, TL.iter_level(imgs, *prep, guess, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert iters.dtype == torch.int32 and iters.shape == (2, 64)
    assert (iters[:, :4] == 0).all()
    assert (iters[0, 4:][prep[5][4:]] == 1).all()
    assert int(iters[1].max()) <= OPTS.term_max_iters
    assert int(iters[1, 4:].sum()) > 60


def test_multi_target_matches_xla_and_pallas_interpret():
    """The coarse-to-fine chain into two targets: the port's multi solve
    (CPU arm of the kernel wrappers) against the XLA arm's
    ``_lk_all_levels_multi`` on the same levels, and against
    ``lk_all_levels_pallas`` in interpret mode."""
    img1, img2 = _make_pair()
    img3 = _make_pair(shift=(-2.0, 1.0))[1]
    h, w = img1.shape
    rng = np.random.default_rng(1)
    n = lkp.GROUP
    pts = rng.uniform((12, 12), (w - 12, h - 12), (n, 2)).astype(np.float32)
    levels = 3

    r1, g1 = _levels_both(img1)
    tgts = [_levels_both(im) for im in (img2, img3)]
    ref = JL._lk_all_levels_multi(
        tuple(r1.levels[:levels]),
        tuple(jnp.stack([r.levels[lvl][0] for r, _ in tgts])
              for lvl in range(levels)),
        jnp.asarray(pts), jnp.float32(EPS2),
        jnp.float32(OPTS.min_eigen_threshold), win=OPTS.window_size,
        max_iters=OPTS.term_max_iters, levels=levels,
    )
    got = TL._lk_all_levels_multi(
        g1.levels[:levels],
        [torch.stack([g.levels[lvl][0] for _, g in tgts])
         for lvl in range(levels)],
        torch.as_tensor(pts), EPS2, OPTS.min_eigen_threshold,
        win=OPTS.window_size, max_iters=OPTS.term_max_iters, levels=levels,
    )
    rn, rs, re = (np.asarray(a) for a in ref)
    gn, gs, ge = (a.numpy() for a in got)
    assert rs.mean() > 0.9
    assert np.mean(rs == gs) >= 0.99
    both = rs & gs
    assert np.abs(rn[both] - gn[both]).max() < 1e-3
    np.testing.assert_allclose(ge[both], re[both], atol=1e-3)

    data1, dims, _ = _pallas_pyr(img1, JL.LKOptions())
    nexts = [_pallas_pyr(im, JL.LKOptions())[0] for im in (img2, img3)]
    pn, ps, _ = lkp.lk_all_levels_pallas(
        tuple(data1[:levels]),
        tuple(tuple(d[lvl][0] for d in nexts) for lvl in range(levels)),
        jnp.asarray(pts), dims=dims[:levels], win=OPTS.window_size,
        max_iters=OPTS.term_max_iters, eps2=EPS2,
        min_eig_thr=float(OPTS.min_eigen_threshold), interpret=True,
    )
    pn, ps = np.asarray(pn), np.asarray(ps)
    assert np.mean(ps == gs) > 0.97
    both = ps & gs
    assert both.sum() > n
    assert np.linalg.norm(pn[both] - gn[both], axis=-1).max() < 0.05


def test_calc_optical_flow_multi_matches_xla_with_spatial_sort(monkeypatch):
    """The public multi-target call (N above the spatial-sort threshold, so
    the features are reordered and put back) against the reference's, with
    its compressed transfer off."""
    monkeypatch.setenv("POLYCHASE_LK_COMPRESS", "0")
    monkeypatch.setenv("POLYCHASE_SHARD_ANALYZE", "0")
    img1, img2 = _make_pair(seed=3)
    h, w = img1.shape
    pts = np.random.default_rng(5).uniform(
        (0, 0), (w, h), (300, 2)).astype(np.float32)
    r1, g1 = _levels_both(img1)
    r2, g2 = _levels_both(img2)
    rn, rs, re = JL.calc_optical_flow_multi(r1, [r2, r1], pts)
    gn, gs, ge = TL.calc_optical_flow_multi(g1, [g2, g1], pts)
    assert gn.shape == (2, 300, 2) and gs.dtype == bool
    assert np.mean(rs == gs) >= 0.99
    both = rs & gs
    assert np.abs(rn[both] - gn[both]).max() < 1e-3
    # tracking a frame into itself stays put
    np.testing.assert_allclose(gn[1][gs[1]], pts[gs[1]], atol=0.02)


def test_matches_opencv_on_rotation_zoom(rng):
    """test_lk.py's cv2 golden (rotation 2.5°, zoom 1.03) on the port."""
    img1 = textured(rng, 200, 260)
    M = cv2.getRotationMatrix2D((130, 100), 2.5, 1.03)
    img2 = cv2.warpAffine(img1, M, (img1.shape[1], img1.shape[0]),
                          borderMode=cv2.BORDER_REFLECT_101)
    pts, _ = good_features_to_track(img1, None, GFTTOptions(min_distance=8),
                                    device=CPU)
    pts = pts[:120]
    p1 = TL.prepare_pyramid(img1, OPTS, device=CPU)
    p2 = TL.prepare_pyramid(img2, OPTS, device=CPU)
    nxt, status, err = TL.calc_optical_flow(p1, p2, pts, OPTS)

    cv_nxt, cv_status, _ = cv2.calcOpticalFlowPyrLK(
        img1, img2, pts.reshape(-1, 1, 2), None,
        winSize=(OPTS.window_size, OPTS.window_size),
        maxLevel=OPTS.max_level,
        criteria=(cv2.TERM_CRITERIA_COUNT + cv2.TERM_CRITERIA_EPS,
                  OPTS.term_max_iters, OPTS.term_epsilon),
        flags=0, minEigThreshold=OPTS.min_eigen_threshold,
    )
    cv_nxt = cv_nxt.reshape(-1, 2)
    cv_status = cv_status.reshape(-1).astype(bool)
    assert (status == cv_status).mean() > 0.9
    both = status & cv_status
    d = np.linalg.norm(nxt[both] - cv_nxt[both], axis=-1)
    assert np.quantile(d, 0.8) < 0.3
    assert np.median(d) < 0.15


def test_status_false_for_flat_and_oob():
    img1 = np.full((120, 160), 100, np.uint8)
    img1[40:60, 50:70] = 200
    pts = np.array([[10.0, 10.0], [50.0, 40.0], [300.0, 40.0]], np.float32)
    p1 = TL.prepare_pyramid(img1, OPTS, device=CPU)
    nxt, status, err = TL.calc_optical_flow(p1, p1, pts, OPTS)
    assert status.tolist() == [False, True, False]
    np.testing.assert_allclose(nxt[1], pts[1], atol=0.05)
    assert err.shape == (3,) and np.isfinite(err).all()


def test_empty_points():
    p = TL.prepare_pyramid(np.zeros((64, 64), np.uint8), device=CPU)
    nxt, status, err = TL.calc_optical_flow(p, p, np.empty((0, 2)))
    assert nxt.shape == (0, 2) and status.shape == (0,) and err.shape == (0,)
    nxt, status, err = TL.calc_optical_flow_multi(p, [p, p], np.empty((0, 2)))
    assert nxt.shape == (2, 0, 2) and status.shape == (2, 0)
    nxt, status, err = TL.calc_optical_flow_multi(p, [], np.ones((3, 2)))
    assert nxt.shape == (0, 0, 2)  # as the reference returns it


def test_convert_pyramid_refuses_pallas_flavor():
    pal = JL.PyramidCache((), 1, JL.LKOptions(), "pallas", ((64, 64),))
    with pytest.raises(ValueError, match="flavor"):
        convert.pyramid(pal, device=CPU)


def test_explicit_device_required():
    with pytest.raises(ValueError, match="device"):
        TL.prepare_pyramid(np.zeros((32, 32), np.uint8), device=None)
