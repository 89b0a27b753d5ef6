"""K1 (csrc/pnp_lm.cu), K2 (csrc/lk_prep.cu), K3 (csrc/lk_iter.cu), K4
(csrc/gftt_suppress.cu), K5 (csrc/raycast_sweep.cu) and K6
(csrc/grid_cast.cu) against their plain torch versions on a CUDA card,
GFTT's device route against its host route and the chained skip fan's K2
and K3 launches (on one card and split by features), refine and pin mode
on the card against the same work on the CPU, the segment-parallel track
(one K1 and one K5 launch a step for every segment), the sharded analyze
and refine (two shards on one card, or every card), K1-K3, K5 and K6 on a
card other than the current one, K5's and K6's failures raising, and the
``polychase_core`` threads with no device argument on the card.

These tests need the card and skip elsewhere.  The file imports no jax, so
it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from polychase_tpu_torch.engine import lk
from polychase_tpu_torch.engine.gftt import good_features_to_track
from polychase_tpu_torch.engine.levmarq import BundleOptions
from polychase_tpu_torch.engine.pnp import solve_arrays
from polychase_tpu_torch.engine.pose import quat_to_mat_np
from polychase_tpu_torch.kernels import grid_cast, lk_iter, lk_prep, pnp_lm
from polychase_tpu_torch.synthetic import panning_clip

from thread_drain import drain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scene(n, seed, opencv=True, f_err=1.0):
    rng = np.random.default_rng(seed)
    sign = 1.0 if opencv else -1.0
    X = rng.normal(size=(n, 3)).astype(np.float32)
    X[:, 2] += 6.0 * sign
    q = np.array([0.99, 0.05, -0.08, 0.03])
    q /= np.linalg.norm(q)
    Z = X.astype(np.float64) @ quat_to_mat_np(q).T + [0.1, -0.2, 0.3]
    x = np.stack([1800 * Z[:, 0] / Z[:, 2] + 960,
                  1800 * Z[:, 1] / Z[:, 2] + 540], -1)
    x = (x + rng.normal(scale=0.4, size=x.shape)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-n // 10:] = False
    q0 = q + [0.01, -0.02, 0.015, 0.01]
    q0 /= np.linalg.norm(q0)
    params = np.array([*q0, 0.15, -0.1, 0.2, 1800 * f_err, 1800 * f_err,
                       960, 540, 1, 1920, 1080, sign, 12], np.float32)
    return X, x, mask.astype(np.float32), mask, params


def _to(scenes, dev):
    return [torch.as_tensor(np.stack([s[i] for s in scenes]), device=dev)
            for i in range(5)]


@pytest.mark.parametrize("loss_type", [0, 1, 2])
@pytest.mark.parametrize("opt", [False, True])
def test_kernel_matches_plain(card, loss_type, opt):
    """Tolerances of tests/test_pnp_pallas.py: pose 5e-4 (1e-3 with free
    intrinsics), inlier ratio 1e-3, cost rtol 1e-3."""
    args = _to([_scene(4096, s, f_err=0.875 if opt else 1.0)
                for s in range(3)], card)
    kw = dict(opt_f=opt, opt_pp=opt,
              opts=BundleOptions(max_iterations=50, loss_type=loss_type,
                                 function_tol=1e-5))
    before = pnp_lm.launches
    got = pnp_lm.solve_arrays_lm(*args, **kw).cpu().numpy()
    assert pnp_lm.launches == before + 1
    ref = solve_arrays(*args, **kw).cpu().numpy()
    np.testing.assert_allclose(got[:, :7], ref[:, :7],
                               atol=1e-3 if opt else 5e-4)
    np.testing.assert_allclose(got[:, 18], ref[:, 18], atol=1e-3)
    np.testing.assert_allclose(got[:, 13], ref[:, 13], rtol=1e-3)
    if opt:
        np.testing.assert_allclose(got[:, 7:11], ref[:, 7:11], rtol=2e-3,
                                   atol=1.0)


def test_kernel_rejects_bad_shapes(card):
    """Wrong shapes, devices, types and strided points raise: the kernel
    reads the points where they lie."""
    X, x, w, m, p = _to([_scene(256, 0)], card)
    opts = BundleOptions()
    kw = dict(opt_f=False, opt_pp=False, opts=opts)
    for bad in ((X, x[:, :-1], w, m, p), (X, x, w, m, p.cpu()),
                (X, x, w.double(), m, p), (X, x, w, m.float(), p),
                (torch.cat([X, X[..., :1]], -1)[..., :3], x, w, m, p),
                (X[:, ::2].contiguous(), x[:, ::2], w[:, ::2], m[:, ::2],
                 p)):
        with pytest.raises(ValueError):
            pnp_lm.solve_arrays_lm(*bad, **kw)


def _random_masks(args, seed):
    """Each solve of the batch its own random mask (and weights)."""
    X, x, w, m, p = args
    rng = np.random.default_rng(seed)
    keep = rng.random(tuple(m.shape)) > rng.uniform(0.05, 0.5,
                                                    (m.shape[0], 1))
    m = torch.as_tensor(keep, device=m.device)
    return [X, x, m.float(), m, p]


# (S, N): each side of the step from one warp to one block and of every
# doubling of the cluster, the largest cluster's staged capacity, the
# streamed route, and batches whose solves each take a cluster.
K1_SHAPE_CASES = [(1, 32), (1, 33), (1, 512), (1, 513), (1, 4096), (1, 4097),
                  (1, 8192), (1, 131072), (1, 131073), (1, 200000), (8, 8192),
                  (4, 16384), (64, 1000)]


@pytest.mark.parametrize("S,N", K1_SHAPE_CASES)
def test_kernel_launch_shapes_match_plain(card, S, N):
    """K1 at every kind of launch shape against the plain version, with
    the tolerances of test_kernel_matches_plain."""
    args = _random_masks(_to([_scene(N, s) for s in range(S)], card), N)
    kw = dict(opt_f=False, opt_pp=False,
              opts=BundleOptions(max_iterations=50, loss_type=1,
                                 function_tol=1e-5))
    shape = pnp_lm.fitted_shape(S, N, 6, 1)
    assert shape.cluster * shape.per_block >= N
    if N > pnp_lm.STAGE_MAX * pnp_lm.MAX_CLUSTER:
        assert not shape.staged
    if N > pnp_lm.WARP_MAX and S <= 8:
        assert shape.cluster > 1 or N <= pnp_lm.BLOCK_POINTS
    before = pnp_lm.launches
    got = pnp_lm.solve_arrays_lm(*args, **kw).cpu().numpy()
    assert pnp_lm.launches == before + 1
    ref = solve_arrays(*args, **kw).cpu().numpy()
    np.testing.assert_allclose(got[:, :7], ref[:, :7], atol=5e-4)
    np.testing.assert_allclose(got[:, 18], ref[:, 18], atol=1e-3)
    np.testing.assert_allclose(got[:, 13], ref[:, 13], rtol=1e-3)


@pytest.mark.parametrize("n", [3, 4, 5, 6, 7, 8])
def test_kernel_pin_sizes(card, n):
    """Pin-drag sizes with a free focal (one warp): pose and focal against
    the plain version, on points spread wide enough that the focal is
    determined (chip_smoke.py's pin cases say why); with 3 points the focal
    stays frozen (the > 3 gate) and the pose fits them exactly, so the cost
    is not compared."""
    from polychase_tpu_torch.synthetic import pnp_scene

    scene = pnp_scene(np.random.default_rng(100 + n), n, f_err=0.95,
                      noise=1.0, spread=2.0)
    args = _to([scene], card)
    p = args[4]
    kw = dict(opt_f=True, opt_pp=False, opts=BundleOptions(loss_type=0))
    assert pnp_lm.fitted_shape(1, n, 9, 0).threads == pnp_lm.WARP_THREADS
    got = pnp_lm.solve_arrays_lm(*args, **kw).cpu().numpy()
    ref = solve_arrays(*args, **kw).cpu().numpy()
    np.testing.assert_allclose(got[:, :7], ref[:, :7], atol=1e-3)
    np.testing.assert_allclose(got[:, 7:11], ref[:, 7:11], rtol=2e-3,
                               atol=1.0)
    if n == 3:
        np.testing.assert_array_equal(got[:, 7:11], p[:, 7:11].cpu().numpy())
    else:
        np.testing.assert_allclose(got[:, 13], ref[:, 13], rtol=1e-3)


# ---------------------------------------------------------------------------
# K2 and K3
# ---------------------------------------------------------------------------

OPTS = lk.LKOptions()
WIN = OPTS.window_size


@pytest.fixture
def lk_case(card):
    """A 640×480 panning clip: frame 4's corners, its pyramid and the
    pyramids of four targets (skips -2, -1, 1, 2), on the card."""
    frames = panning_clip(np.random.default_rng(0), 7, 640, 480)
    pts, _ = good_features_to_track(frames[4], device=card)
    pts, _ = lk._spatial_sort(pts)
    src = lk.prepare_pyramid(frames[4], OPTS, device=card)
    tgts = [lk.prepare_pyramid(frames[f], OPTS, device=card)
            for f in (2, 3, 5, 6)]
    return torch.as_tensor(pts, device=card), src, tgts


def test_lk_prep_matches_plain(lk_case):
    """Patches atol 1e-4 (the blend is not contracted into FMAs), A terms
    rtol 1e-4 (sum order), the gate equal on ≥ 99.9% of features."""
    pts, src, _ = lk_case
    for lvl in range(src.num_levels):
        img, dx, dy, (H, W) = src.levels[lvl]
        p = pts * (1.0 / (1 << lvl))
        kw = dict(win=WIN, H=H, W=W, min_eig_thr=OPTS.min_eigen_threshold)
        before = lk_prep.launches
        got = lk_prep.lk_prep_level(img, dx, dy, p, **kw)
        assert lk_prep.launches == before + 1
        ref = lk.prep_level(img, dx, dy, p, **kw)
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
        for a, b in zip(got[1:4], ref[1:4]):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-4 * float(b.abs().max()))
        assert (got[5] == ref[5]).float().mean() >= 0.999


def test_lk_iter_matches_plain(lk_case):
    """Status ≥ 99% equal at every level of the coarse-to-fine chain (each
    level fed the kernel chain's guesses); 0.05 px on features both keep,
    for every one at level 0 and for 99.9% above it (a feature that does
    not converge near a coarse level's border stops where the budget ends,
    which last-bit differences move)."""
    pts, src, tgts = lk_case
    levels = src.num_levels
    eps2 = OPTS.term_epsilon ** 2
    top = levels - 1
    cur = (pts * (1.0 / (1 << top))).expand(len(tgts), *pts.shape)
    cur = cur.contiguous()
    for lvl in range(top, -1, -1):
        if lvl != top:
            cur = cur * 2.0
        img, dx, dy, (H, W) = src.levels[lvl]
        prep = lk.prep_level(img, dx, dy, pts * (1.0 / (1 << lvl)), win=WIN,
                             H=H, W=W, min_eig_thr=OPTS.min_eigen_threshold)
        imgs = torch.stack([t.levels[lvl][0] for t in tgts])
        kw = dict(win=WIN, H=H, W=W, max_iters=OPTS.term_max_iters,
                  eps2=eps2, level_is_zero=(lvl == 0))
        before = lk_iter.launches
        got = lk_iter.lk_iter_level(imgs, *prep, cur, **kw)
        assert lk_iter.launches == before + 1
        ref = lk.iter_level(imgs, *prep, cur, **kw)
        assert (got[1] == ref[1]).float().mean() >= 0.99
        both = got[1] & ref[1] & prep[5]
        dpos = (got[0] - ref[0]).abs().amax(dim=-1)[both]
        assert float((dpos <= 0.05).float().mean()) >= 0.999
        if lvl == 0:
            assert float(dpos.max()) <= 0.05
        if lvl == 0:
            torch.testing.assert_close(got[2][both], ref[2][both], rtol=0,
                                       atol=1e-2)
        cur = got[0]


# (T, N, win): T 1, 3 and 8 targets, N not a multiple of a block's 32
# pairs, windows other than 10 (the kernel with the window a runtime
# value), and windows whose templates for 32 pairs would not fit in shared
# memory (fewer pairs a block).
K3_CASES = [(1, 1001, 10), (3, 1001, 10), (8, 1001, 10), (3, 257, 7),
            (8, 333, 13), (5, 129, 21), (1, 257, 31), (2, 129, 40)]


@pytest.mark.parametrize("T,N,win", K3_CASES)
def test_lk_iter_cases_match_plain(card, T, N, win):
    """K3 against its plain version at level 0 of a textured 200×160
    frame panned by a pixel per target, with the guesses of a tenth of the
    features off the image (they leave it: status 0), a tenth gated out (ok
    false: they never move) and one feature at NaN.  Status equal on ≥ 99%
    of the pairs, positions of pairs both keep within 0.05 px; err, a
    function of the final position, within 1e-2 where the two positions
    agree within 1e-4 px (≥ 99% of those pairs: a pair that does not
    converge stops where last-bit differences put it)."""
    rng = np.random.default_rng(T * 1000 + N + win)
    opts = lk.LKOptions(window_size=win)
    frames = panning_clip(rng, T + 1, 200, 160, (1, 1))
    src = lk.prepare_pyramid(frames[0], opts, device=card)
    img, dx, dy, (H, W) = src.levels[0]
    pts = rng.uniform((win, win), (W - win, H - win), (N, 2))
    pts[-1] = np.nan
    pts = torch.as_tensor(pts.astype(np.float32), device=card)
    prep = list(lk.prep_level(img, dx, dy, pts, win=win, H=H, W=W,
                              min_eig_thr=1e-4))
    prep[5][N // 10: N // 5] = False
    imgs = torch.stack([lk.prepare_pyramid(f, opts, device=card).levels[0][0]
                        for f in frames[1:]])
    shift = rng.normal(0, 0.7, (T, N, 2))
    shift[:, : N // 10, 0] -= 3 * W  # off the image
    guess = (pts + torch.as_tensor(shift.astype(np.float32), device=card)
             ).contiguous()
    kw = dict(win=win, H=H, W=W, max_iters=30, eps2=1e-4, level_is_zero=True)
    before = lk_iter.launches
    got = lk_iter.lk_iter_level(imgs, *prep, guess, **kw)
    assert lk_iter.launches == before + 1
    ref = lk.iter_level(imgs, *prep, guess, **kw)
    assert (got[1] == ref[1]).float().mean() >= 0.99
    assert not got[1][:, : N // 5].any()
    gated = ~prep[5]
    torch.testing.assert_close(got[0][:, gated], guess[:, gated], rtol=0,
                               atol=0, equal_nan=True)
    both = got[1] & ref[1]
    assert int(both.sum()) > T * N // 2
    dpos = (got[0] - ref[0]).abs().amax(dim=-1)
    assert float(dpos[both].max()) <= 0.05
    same = both & (dpos <= 1e-4)
    assert int(same.sum()) >= 0.99 * int(both.sum())
    torch.testing.assert_close(got[2][same], ref[2][same], rtol=0, atol=1e-2)


def test_lk_launch_counts_follow_the_levels(lk_case):
    pts, src, tgts = lk_case
    p0, i0 = lk_prep.launches, lk_iter.launches
    nxt, st, err = lk.calc_optical_flow_multi(src, tgts, pts.cpu().numpy())
    assert (lk_prep.launches - p0, lk_iter.launches - i0) == (
        src.num_levels, src.num_levels)
    assert nxt.shape == (4, pts.shape[0], 2) and st.mean() > 0.9


def test_lk_kernels_reject_bad_inputs(lk_case):
    pts, src, tgts = lk_case
    img, dx, dy, (H, W) = src.levels[0]
    kw = dict(win=WIN, H=H, W=W, min_eig_thr=1e-4)
    with pytest.raises(ValueError):
        lk_prep.lk_prep_level(img[:-1], dx, dy, pts, **kw)
    with pytest.raises(ValueError):
        lk_prep.lk_prep_level(img.cpu(), dx, dy, pts, **kw)
    with pytest.raises(ValueError):
        lk_prep.lk_prep_level(img, dx, dy, pts[:, :1], **kw)
    prep = lk_prep.lk_prep_level(img, dx, dy, pts, **kw)
    imgs = torch.stack([t.levels[0][0] for t in tgts])
    cur = pts.expand(4, *pts.shape).contiguous()
    ikw = dict(win=WIN, H=H, W=W, max_iters=30, eps2=1e-4,
               level_is_zero=True)
    with pytest.raises(ValueError):
        lk_iter.lk_iter_level(imgs, *prep, cur[:3], **ikw)
    with pytest.raises(ValueError):
        lk_iter.lk_iter_level(imgs.cpu(), *prep, cur, **ikw)
    with pytest.raises(ValueError):
        lk_iter.lk_iter_level(imgs, *prep[:5], prep[5].float(), cur, **ikw)
    with pytest.raises(ValueError):
        lk_iter.lk_iter_level(imgs, prep[0].permute(1, 2, 3, 0).contiguous(),
                              *prep[1:], cur, **ikw)


# ---------------------------------------------------------------------------
# Refine and pin mode
# ---------------------------------------------------------------------------


def _refine(dev, db_path, poses, seed):
    """A refine of a 30-frame orbit clip on ``dev``; returns the refined
    translations and the last progress report."""
    from polychase_tpu_torch.engine.camera import OPENCV, Intrinsics
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.engine.levmarq import CAUCHY
    from polychase_tpu_torch.engine.refiner import refine_trajectory
    from polychase_tpu_torch.synthetic import noisy_trajectory, uv_sphere

    mesh = Mesh.create(*uv_sphere(24, 32), device=dev)
    intr = Intrinsics.create(1800, 1800, 960, 540, 1, 1920, 1080, OPENCV,
                             device=dev)
    traj = noisy_trajectory(poses, intr, np.random.default_rng(seed))
    ups = []
    refine_trajectory(db_path, traj, np.eye(4, dtype=np.float32), mesh,
                      optimize_focal_length=True,
                      callback=lambda u: ups.append(u) or True,
                      bundle_opts=BundleOptions(loss_type=CAUCHY,
                                                max_iterations=30),
                      device=dev)
    t = np.stack([traj.get(i).pose.t.numpy() for i in range(len(poses))])
    return t, ups[-1]


def test_refine_on_card_matches_cpu(card, tmp_path):
    """Final cost within 1e-3 relative, translations within 5e-4."""
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.synthetic import (
        build_flow_db, orbit_poses, uv_sphere,
    )

    poses = orbit_poses(30)
    db_path = str(tmp_path / "flow.db")
    build_flow_db(db_path, Mesh.create(*uv_sphere(24, 32), device="cpu"),
                  1800.0, 1920, 1080, poses, np.random.default_rng(2), 128,
                  0.3)
    t_gpu, up_gpu = _refine(card, db_path, poses, 3)
    t_cpu, up_cpu = _refine(torch.device("cpu"), db_path, poses, 3)
    np.testing.assert_allclose(float(up_gpu.stats.cost),
                               float(up_cpu.stats.cost), rtol=1e-3)
    np.testing.assert_allclose(t_gpu, t_cpu, atol=5e-4)


@pytest.mark.parametrize("lam", [1e-5, 1e-2, 1.0])
def test_banded_solve_matches_dense_on_card(card, lam):
    """Config 4's block shape (nb 32, bs 72), steps within 1e-4 of the
    largest component."""
    from polychase_tpu_torch.engine.levmarq import (
        damped_block_tridiag_solve, damped_cholesky_solve,
    )

    rng = np.random.default_rng(0)
    nb, bs = 32, 72
    n = nb * bs
    A = np.zeros((n, n))
    for i in range(nb):
        Q = rng.normal(0, 1, (bs, bs))
        A[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] = Q @ Q.T + 5 * np.eye(bs)
        if i + 1 < nb:
            E = rng.normal(0, 0.3, (bs, bs))
            A[(i + 1) * bs:(i + 2) * bs, i * bs:(i + 1) * bs] = E
            A[i * bs:(i + 1) * bs, (i + 1) * bs:(i + 2) * bs] = E.T
    At = torch.as_tensor(A, dtype=torch.float32, device=card)
    bt = torch.as_tensor(rng.normal(0, 1, n), dtype=torch.float32,
                         device=card)
    band, ok = damped_block_tridiag_solve(At, bt, lam, nb=nb, bs=bs)
    dense, dok = damped_cholesky_solve(
        At[None], bt[None], torch.full((1,), lam, device=card))
    assert bool(ok) and bool(dok[0])
    diff = float((band - dense[0]).abs().max() / dense[0].abs().max())
    assert diff <= 1e-4, diff


def test_pin_device_route_launches_k1(card, monkeypatch):
    """8192 pins, above ``HOST_PIN_MAX``, go through the device route,
    which launches K1 once; the pose agrees with the host route within
    1e-4."""
    from polychase_tpu_torch.engine import pinmode
    from polychase_tpu_torch.engine.camera import OPENCV, Intrinsics
    from polychase_tpu_torch.engine.geometry import (
        TRANSFORM_CAMERA, Mesh, SceneTransformations,
    )
    from polychase_tpu_torch.synthetic import (
        orbit_poses, surface_pins, uv_sphere,
    )

    q, t = orbit_poses(1)[0]
    mesh = Mesh.create(*uv_sphere(24, 32), device=card)
    pins = surface_pins(mesh, (q, t), 1800.0, 1920, 1080,
                        np.random.default_rng(0), 8192)
    assert len(pins) > pinmode.HOST_PIN_MAX
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = quat_to_mat_np(q)
    view[:3, 3] = t
    intr = Intrinsics.create(1800, 1800, 960, 540, 1, 1920, 1080, OPENCV,
                             device=card)
    scene = SceneTransformations(torch.eye(4, device=card),
                                 torch.as_tensor(view, device=card), intr)
    upd = pinmode.PinUpdate(2, np.array([955.0, 542.0], np.float32))
    before = pnp_lm.launches
    dev = pinmode.find_transformation(pins, scene, scene, upd,
                                      TRANSFORM_CAMERA, device=card)
    assert pnp_lm.launches == before + 1
    monkeypatch.setattr(pinmode, "HOST_PIN_MAX", 1 << 30)
    host = pinmode.find_transformation(pins, scene, scene, upd,
                                       TRANSFORM_CAMERA, device=card)
    assert pnp_lm.launches == before + 1
    np.testing.assert_allclose(dev.view_matrix.numpy(),
                               host.view_matrix.numpy(), atol=1e-4)


def _segment_clip(dev, tmp_path, n=18, sphere=(24, 32)):
    """An ``n``-frame 1080p orbit of a UV sphere (24×32 unless given) with
    512 keypoints a frame, and the facade's pieces to track or refine
    it."""
    import polychase_tpu_torch.polychase_core as pc
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.synthetic import (
        build_flow_db, orbit_poses, uv_sphere,
    )

    verts, tris = uv_sphere(*sphere)
    poses = orbit_poses(n)
    db = str(tmp_path / "flow.db")
    build_flow_db(db, Mesh.create(verts, tris, device=dev), 1800.0, 1920,
                  1080, poses, np.random.default_rng(0), 512, 0.2)
    intr = pc.CameraIntrinsics(1800, 1800, 960, 540, 1, 1920, 1080,
                               pc.CameraConvention.OpenCV)

    def trajs(bounds, filled, seed=1):
        rng = np.random.default_rng(seed)
        out = []
        for a, b in bounds:
            traj = pc.CameraTrajectory(a, b - a + 1)
            for f in range(a, b + 1 if filled else a + 1):
                q, t = poses[f]
                if f not in (a, b):
                    t = t + rng.normal(0, 0.004, 3).astype(np.float32)
                traj.set(f, pc.CameraState(intr, pc.Pose(q, t)))
            out.append(traj)
        return out

    return pc, db, pc.AcceleratedMesh(verts, tris), poses, trajs


def test_track_segments_launches_k1_once_a_step(card, tmp_path):
    """Three segments of 6 frames: 5 steps, so 5 launches of K1 and of K5
    (not 15), the counts equal to the plain route's on the CPU and every
    pose within 5e-3 of the truth on both."""
    from polychase_tpu_torch.kernels import raycast_sweep

    pc, db, mesh, poses, trajs = _segment_clip(card, tmp_path)
    bounds = ((0, 5), (6, 11), (12, 17))
    on_card, on_cpu = trajs(bounds, False), trajs(bounds, False)
    before = (pnp_lm.launches, raycast_sweep.launches)
    counts = pc.track_segments(db, on_card, np.eye(4), mesh)
    assert (pnp_lm.launches, raycast_sweep.launches) == (before[0] + 5,
                                                         before[1] + 5)
    cpu_counts = pc.track_segments(db, on_cpu, np.eye(4), mesh,
                                   device="cpu")
    assert (pnp_lm.launches, raycast_sweep.launches) == (before[0] + 5,
                                                         before[1] + 5)
    np.testing.assert_array_equal(counts, cpu_counts)
    assert counts.shape == (3, 5) and (counts >= 3).all()
    for traj in on_card + on_cpu:
        for f in range(traj.first_frame(), traj.last_frame() + 1):
            assert np.linalg.norm(traj.get(f).pose.t - poses[f][1]) < 5e-3


def test_refine_segments_thread_on_card(card, tmp_path):
    """A RefineSegmentsThread built with no device refines on the card:
    its progress message, then True, and the poses within 5e-4 of the same
    refine on the CPU."""
    pc, db, mesh, poses, trajs = _segment_clip(card, tmp_path)
    bounds = ((0, 8), (9, 17))
    opts = pc.BundleOptions()
    opts.loss_type = pc.LossType.Cauchy
    opts.max_iterations = 10
    on_card, on_cpu = trajs(bounds, True), trajs(bounds, True)
    msgs = drain(pc.RefineSegmentsThread(db, on_card, np.eye(4), mesh,
                                         False, False, opts))
    assert [m.message for m in msgs] == ["Refining 2 segments in parallel"]
    pc.refine_segments(db, on_cpu, np.eye(4), mesh, False, False, opts,
                       device="cpu")
    for a, b in zip(on_card, on_cpu):
        for f in range(a.first_frame(), a.last_frame() + 1):
            np.testing.assert_allclose(a.get(f).pose.t, b.get(f).pose.t,
                                       atol=5e-4)


def test_segments_split_over_cards(card, tmp_path):
    """Four segments over every visible card (the facade's default) against
    the same on one card: the counts equal, the tracked and the refined
    poses within 1e-4."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    pc, db, mesh, poses, trajs = _segment_clip(card, tmp_path, n=24)
    bounds = ((0, 5), (6, 11), (12, 17), (18, 23))
    one, every = trajs(bounds, False), trajs(bounds, False)
    counts = pc.track_segments(db, one, np.eye(4), mesh, device="cuda:0")
    np.testing.assert_array_equal(
        pc.track_segments(db, every, np.eye(4), mesh), counts)
    opts = pc.BundleOptions()
    opts.max_iterations = 10
    filled_one, filled_every = trajs(bounds, True), trajs(bounds, True)
    pc.refine_segments(db, filled_one, np.eye(4), mesh, False, False, opts,
                       device="cuda:0")
    pc.refine_segments(db, filled_every, np.eye(4), mesh, False, False,
                       opts)
    for a, b in zip(one + filled_one, every + filled_every):
        for f in range(a.first_frame(), a.last_frame() + 1):
            np.testing.assert_allclose(a.get(f).pose.t, b.get(f).pose.t,
                                       atol=1e-4)
            np.testing.assert_allclose(a.get(f).pose.q, b.get(f).pose.q,
                                       atol=1e-4)


# ---------------------------------------------------------------------------
# The public surface: polychase_core's threads with no device argument
# ---------------------------------------------------------------------------


def test_tracker_thread_on_card(card, tmp_path):
    """A TrackerThread built with no device tracks on the card: one K1
    launch a frame, every pose within 5e-3 of the truth."""
    import polychase_tpu_torch.polychase_core as pc
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.synthetic import (
        build_flow_db, orbit_poses, uv_sphere,
    )

    verts, tris = uv_sphere(24, 32)
    poses = orbit_poses(12)
    db = str(tmp_path / "flow.db")
    build_flow_db(db, Mesh.create(verts, tris, device=card), 1800.0, 1920,
                  1080, poses, np.random.default_rng(0), 512, 0.0)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = quat_to_mat_np(poses[0][0])
    view[:3, 3] = poses[0][1]
    scene = pc.SceneTransformations(np.eye(4), view, pc.CameraIntrinsics(
        1800, 1800, 960, 540, 1, 1920, 1080, pc.CameraConvention.OpenCV))
    before = pnp_lm.launches
    got = drain(pc.TrackerThread(db, 0, 11, scene,
                                  pc.AcceleratedMesh(verts, tris), False,
                                  False, pc.BundleOptions()))
    assert pnp_lm.launches == before + 11
    assert [r.frame for r in got] == list(range(1, 12))
    for r in got:
        assert np.linalg.norm(r.pose.t - poses[r.frame][1]) < 5e-3


def test_opticalflow_thread_on_card(card, tmp_path):
    """An OpticalFlowThread built with no device analyzes on every card: K2
    and K3 launch once per level of every solve's every shard (one shard a
    solve on one card), and the DB equals the direct analyze's, also on
    every card, to the bit."""
    import polychase_tpu_torch.polychase_core as pc
    from polychase_tpu_torch.io.database import Database

    n = 6
    frames = panning_clip(np.random.default_rng(0), n, 320, 240, (3, 2))
    info = pc.VideoInfo(320, 240, 0, n)
    direct, threaded = str(tmp_path / "direct.db"), str(tmp_path / "t.db")
    pc.generate_optical_flow_database(info, lambda f: frames[f], None,
                                      direct)
    before = (lk_prep.launches, lk_iter.launches)
    progress = drain(pc.OpticalFlowThread(info, threaded), frames)
    # 320x240 frames keep fewer than FEAT_SHARD_MIN corners: several cards
    # split each solve by targets.
    want = _analyze_launches(n, 240, 320, torch.cuda.device_count(),
                             "targets")
    assert (lk_prep.launches - before[0], lk_iter.launches - before[1]) == (
        want, want)
    assert progress[-1] == (1.0, "Done")
    a, b = Database(direct), Database(threaded)
    try:
        for f in range(n):
            np.testing.assert_array_equal(a.read_keypoints(f),
                                          b.read_keypoints(f))
            for g in a.find_optical_flows_from_image(f):
                fa, fb = a.read_image_pair_flow(f, g), b.read_image_pair_flow(
                    f, g)
                np.testing.assert_array_equal(fa.src_kps_indices,
                                              fb.src_kps_indices)
                np.testing.assert_array_equal(fa.tgt_kps, fb.tgt_kps)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# The sharded paths, and the kernels on a card other than the current one
# ---------------------------------------------------------------------------


def _analyze_launches(n, height, width, n_devices, route):
    """K2's (and K3's) launches in an n-frame analyze over ``n_devices``,
    counted without the code under test: once per level of every shard of
    every solve, a solve split by ``route`` into one shard a device (by
    targets, one a target where there are fewer targets than devices)."""
    from polychase_tpu_torch.engine.opticalflow import IMAGE_SKIPS

    levels = lk.num_pyramid_levels(height, width, lk.LKOptions())
    total = 0
    for f in range(n):
        T = sum(0 <= f + s < n for s in IMAGE_SKIPS)
        if T:
            total += (1 if n_devices == 1 else n_devices
                      if route == "features" else min(T, n_devices))
    return levels * total


def _split_devices():
    """Every card, or two shards on the one card there is."""
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(n)] if n > 1
            else [torch.device("cuda", 0)] * 2)


@pytest.mark.parametrize("route", ["targets", "features"])
def test_sharded_analyze_matches_one_card(card, tmp_path, monkeypatch,
                                          route):
    """Analyze split over ``_split_devices()`` (by targets, or by features
    with ``FEAT_SHARD_MIN`` lowered to 1) against the same on card 0: the
    same keypoints and pairs, the same kept flows within 1e-4 px (every
    pair's solve is independent), K2 and K3 once per level of every shard."""
    from polychase_tpu_torch.engine.opticalflow import (
        VideoInfo, generate_optical_flow_database,
    )
    from polychase_tpu_torch.io.database import Database

    if route == "features":
        monkeypatch.setattr(lk, "FEAT_SHARD_MIN", 1)
    n, devices = 6, _split_devices()
    frames = panning_clip(np.random.default_rng(0), n, 320, 240, (3, 2))
    info = VideoInfo(320, 240, 0, n)
    one, split = str(tmp_path / "one.db"), str(tmp_path / "split.db")
    generate_optical_flow_database(info, lambda f: frames[f], None, one,
                                   device="cuda:0")
    before = (lk_prep.launches, lk_iter.launches)
    generate_optical_flow_database(info, lambda f: frames[f], None, split,
                                   device=devices)
    want = _analyze_launches(n, 240, 320, len(devices), route)
    assert want > lk.num_pyramid_levels(240, 320, OPTS) * n
    assert (lk_prep.launches - before[0], lk_iter.launches - before[1]) == (
        want, want)
    a, b = Database(one), Database(split)
    try:
        for f in range(n):
            np.testing.assert_array_equal(a.read_keypoints(f),
                                          b.read_keypoints(f))
            pairs = a.find_optical_flows_from_image(f)
            assert pairs == b.find_optical_flows_from_image(f)
            for g in pairs:
                fa, fb = a.read_image_pair_flow(f, g), b.read_image_pair_flow(
                    f, g)
                np.testing.assert_array_equal(fa.src_kps_indices,
                                              fb.src_kps_indices)
                np.testing.assert_allclose(fa.tgt_kps, fb.tgt_kps, rtol=0,
                                           atol=1e-4)
    finally:
        a.close()
        b.close()


def test_refine_on_every_card(card, tmp_path):
    """A 30-frame refine split over ``_split_devices()`` against the same
    refine on card 0: the cost falls, the anchors keep their bits, every
    pose within 2e-3 rad and 4e-3 (tests/test_sharded.py's bars)."""
    from polychase_tpu_torch.engine.camera import OPENCV, Intrinsics
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.engine.levmarq import CAUCHY
    from polychase_tpu_torch.engine.refiner import refine_trajectory
    from polychase_tpu_torch.synthetic import (
        build_flow_db, noisy_trajectory, orbit_poses, uv_sphere,
    )

    poses = orbit_poses(30)
    db = str(tmp_path / "flow.db")
    build_flow_db(db, Mesh.create(*uv_sphere(24, 32), device="cpu"), 1800.0,
                  1920, 1080, poses, np.random.default_rng(2), 128, 0.3)
    c0 = torch.device("cuda", 0)
    mesh = Mesh.create(*uv_sphere(24, 32), device=c0)
    intr = Intrinsics.create(1800, 1800, 960, 540, 1, 1920, 1080, OPENCV,
                             device=c0)
    out = []
    for device in (c0, _split_devices()):
        traj = noisy_trajectory(poses, intr, np.random.default_rng(3))
        start = [traj.get(i).pose for i in (0, len(poses) - 1)]
        ups = []
        refine_trajectory(db, traj, np.eye(4, dtype=np.float32), mesh,
                          optimize_focal_length=True,
                          callback=lambda u: ups.append(u) or True,
                          bundle_opts=BundleOptions(loss_type=CAUCHY,
                                                    max_iterations=30),
                          device=device)
        assert float(ups[-1].stats.cost) < float(ups[-1].stats.initial_cost)
        for i, p in zip((0, len(poses) - 1), start):
            torch.testing.assert_close(traj.get(i).pose.t, p.t, rtol=0, atol=0)
            torch.testing.assert_close(traj.get(i).pose.q, p.q, rtol=0, atol=0)
        out.append(traj)
    for i in range(len(poses)):
        a, b = out[0].get(i).pose, out[1].get(i).pose
        assert float(torch.linalg.vector_norm(a.t - b.t)) < 4e-3
        dq = min(abs(float(torch.dot(a.q, b.q))), 1.0)
        assert 2 * np.arccos(dq) < 2e-3


def test_kernels_launch_on_their_tensors_card(card):
    """K1, K2 and K3 on card 1's tensors, launched while card 0 is current,
    equal the same calls on card 0 to the bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    k1 = _to([_scene(4096, s) for s in range(2)], c0)
    kw = dict(opt_f=False, opt_pp=False,
              opts=BundleOptions(max_iterations=50, loss_type=1,
                                 function_tol=1e-5))
    frames = panning_clip(np.random.default_rng(0), 3, 640, 480)
    pts, _ = good_features_to_track(frames[1], device=c0)
    src = lk.prepare_pyramid(frames[1], OPTS, device=c0)
    tgts = [lk.prepare_pyramid(f, OPTS, device=c0) for f in (frames[0],
                                                            frames[2])]
    img, dx, dy, (H, W) = src.levels[0]
    imgs = torch.stack([t.levels[0][0] for t in tgts])
    pts = torch.as_tensor(pts, device=c0)
    guess = pts.expand(2, *pts.shape).contiguous()
    pkw = dict(win=WIN, H=H, W=W, min_eig_thr=OPTS.min_eigen_threshold)
    ikw = dict(win=WIN, H=H, W=W, max_iters=OPTS.term_max_iters,
               eps2=OPTS.term_epsilon ** 2, level_is_zero=True)

    def calls(dev):
        on = [a.to(dev) for a in k1]
        prep = lk_prep.lk_prep_level(img.to(dev), dx.to(dev), dy.to(dev),
                                     pts.to(dev), **pkw)
        it = lk_iter.lk_iter_level(imgs.to(dev), *prep, guess.to(dev), **ikw)
        return [pnp_lm.solve_arrays_lm(*on, **kw), *prep, *it]

    with torch.cuda.device(0):
        before = (pnp_lm.launches, lk_prep.launches, lk_iter.launches)
        ref, got = calls(c0), calls(c1)
        assert (pnp_lm.launches, lk_prep.launches, lk_iter.launches) == tuple(
            b + 2 for b in before)
        torch.cuda.synchronize(c1)
    for a, b in zip(got, ref):
        assert a.device == c1
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K4 (GFTT suppression) and the chained skip fan
# ---------------------------------------------------------------------------


def _qmaps(card):
    """The quality map of a 640×480 panning-clip frame (its NMS candidates)
    and a noise map whose qualities all tie."""
    from polychase_tpu_torch.engine import gftt

    frame = panning_clip(np.random.default_rng(0), 1, 640, 480)[0]
    img = torch.as_tensor(frame, device=card)
    eig, cand = gftt.gftt_response(img.to(torch.float32), None, 0.01, 0.04)
    rng = np.random.default_rng(1)
    ties = np.where(rng.random((480, 640)) < 0.3, 0.5, 0.0).astype(
        np.float32)
    return [torch.where(cand, eig, 0.0).contiguous(),
            torch.as_tensor(ties, device=card)]


def _noise_qmap(card, kind, shape, seed=0):
    """A random map: noise qualities, all tied, or quantized to quarters,
    on 40% of the pixels."""
    rng = np.random.default_rng(seed)
    q = rng.random(shape).astype(np.float32)
    q[rng.random(shape) < 0.6] = 0.0
    if kind == "ties":
        q = np.where(q > 0, np.float32(0.5), np.float32(0.0))
    elif kind == "quantized":
        q = np.round(q * 4).astype(np.float32) / 4
    return torch.as_tensor(q, device=card)


def _frame_qmap(card, frame, mask=None):
    from polychase_tpu_torch.engine import gftt

    img = torch.as_tensor(frame, device=card).to(torch.float32)
    m = None if mask is None else torch.as_tensor(mask, device=card)
    eig, cand = gftt.gftt_response(img, m, 0.01, 0.04)
    return torch.where(cand, eig, 0.0).contiguous()


def _k4_matches_plain(q, d, max_rounds=None, **kw):
    """K4 (both calls) against ``suppress_plain`` + ``_compact_kept`` on
    one map, to the bit, with one CUDA launch a call.  Returns the plain
    result."""
    from polychase_tpu_torch.engine import gftt
    from polychase_tpu_torch.kernels import gftt_suppress

    offs = gftt._circle_offsets(d)
    max_rounds = gftt.MAX_ROUNDS if max_rounds is None else max_rounds
    k = q.numel()
    ref = gftt.suppress_plain(q, offs, max_rounds)
    want = gftt._compact_kept(q, ref[0], k)
    before = (gftt_suppress.launches, gftt_suppress.cuda_launches())
    got = gftt_suppress.gftt_suppress_kept(q, offs, k, max_rounds, **kw)
    four = gftt_suppress.gftt_suppress(q, offs, max_rounds, **kw)
    assert (gftt_suppress.launches, gftt_suppress.cuda_launches()) == (
        before[0] + 2, before[1] + 2)
    for a, b in zip(got[:3], want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[3].dtype == torch.bool and bool(got[3]) == bool(ref[1])
    assert got[4].dtype == torch.int32 and int(got[4]) == int(ref[2])
    assert torch.equal(got[5] >= 2, ref[0])
    assert torch.equal(four[0], ref[0]) and bool(four[1]) == bool(ref[1])
    assert int(four[2]) == int(ref[2])
    return ref


@pytest.mark.parametrize("d", [1.0, 2.5, 5.0, 8.0])
def test_gftt_suppress_matches_plain(card, d):
    """The kept map, the kept list (vals, idx, count), converged and
    rounds equal to the bit (both compare qualities and indices only), one
    launch a call: a frame's map and noise maps whose qualities are noise,
    all tied or quantized.  Cut at 1, 2 and 5 rounds and resumed from
    its state in batches of as many, the fixed point ends on the uncut
    kept list and round count."""
    from polychase_tpu_torch.engine import gftt
    from polychase_tpu_torch.kernels import gftt_suppress

    maps = _qmaps(card)[:1] + [_noise_qmap(card, kind, (480, 640), i)
                               for i, kind in enumerate(
                                   ("noise", "ties", "quantized"))]
    for i, q in enumerate(maps):
        ref = _k4_matches_plain(q, d)
        assert int(ref[0].sum()) > 0 and (i != 0 or bool(ref[1]))
    offs = gftt._circle_offsets(d)
    q = maps[2]
    whole = gftt.suppress_plain(q, offs, 100_000)
    want = gftt._compact_kept(q, whole[0], q.numel())
    for cut in (1, 2, 5):
        got = gftt_suppress.gftt_suppress_kept(q, offs, q.numel(), cut)
        rounds = int(got[4])
        while not bool(got[3]):
            got = gftt_suppress.gftt_suppress_kept(q, offs, q.numel(), cut,
                                                   got[5])
            rounds += int(got[4])
        for a, b in zip(got[:3], want):
            assert torch.equal(a, b)
        assert rounds == int(whole[2]) and bool(whole[1])


@pytest.mark.parametrize("shape", [(1, 1919), (1081, 1), (1081, 1919),
                                   (3, 5)])
def test_gftt_suppress_shapes(card, shape):
    """One row, one column, an odd-sized 1080p-like frame and a map
    smaller than a band: K4 equals the plain version at every disc."""
    for d in (1.0, 2.5, 5.0, 8.0):
        _k4_matches_plain(_noise_qmap(card, "noise", shape), d)


def test_gftt_suppress_4k_frame(card):
    """The routes phase's 4K noise frame (3840×2160, ~170k kept at d 5):
    its bands outgrow shared memory and are walked in column chunks."""
    big = panning_clip(np.random.default_rng(5), 1, 3840, 2160, (7, 4))[0]
    q = _frame_qmap(card, big)
    for d in (1.0, 2.5, 5.0, 8.0):
        assert bool(_k4_matches_plain(q, d)[1])


def test_gftt_suppress_masked_frame(card):
    frame = panning_clip(np.random.default_rng(3), 1, 640, 480)[0]
    mask = np.zeros((480, 640), bool)
    mask[40:300, 100:500] = True
    q = _frame_qmap(card, frame, mask)
    assert bool((q[~torch.as_tensor(mask, device=card)] == 0).all())
    ref = _k4_matches_plain(q, 5.0)
    assert int(ref[0].sum()) > 100


def test_gftt_suppress_outlasts_max_rounds(card):
    """Every pixel of a 480×640 map ties: the later index decides, and the
    fixed point needs 313 rounds at d 5, past MAX_ROUNDS.  Cut there, it is
    unconverged in both; resumed, it ends on the uncut result."""
    from polychase_tpu_torch.engine import gftt
    from polychase_tpu_torch.kernels import gftt_suppress

    q = torch.full((480, 640), 0.5, device=card)
    ref = _k4_matches_plain(q, 5.0)
    assert not bool(ref[1]) and int(ref[2]) == gftt.MAX_ROUNDS
    offs = gftt._circle_offsets(5.0)
    whole = gftt.suppress_plain(q, offs, 100_000)
    got = gftt_suppress.gftt_suppress_kept(q, offs, q.numel())
    rounds = int(got[4])
    while not bool(got[3]):
        got = gftt_suppress.gftt_suppress_kept(q, offs, q.numel(),
                                               state=got[5])
        rounds += int(got[4])
    assert rounds == int(whole[2]) > gftt.MAX_ROUNDS
    for a, b in zip(got[:3], gftt._compact_kept(q, whole[0], q.numel())):
        assert torch.equal(a, b)


def test_gftt_suppress_forced_grids(card):
    """A forced grid of 2 blocks gives the same bits (bands of 240 rows,
    walked in column chunks); a grid that cannot be co-resident is refused by the
    runtime and raises, with no launch counted (by the wrapper or by the
    library) and no fallback."""
    from polychase_tpu_torch.engine import gftt
    from polychase_tpu_torch.kernels import gftt_suppress

    q = _qmaps(card)[0]
    _k4_matches_plain(q, 5.0, grid=2)
    offs = gftt._circle_offsets(5.0)
    before = (gftt_suppress.launches, gftt_suppress.cuda_launches())
    with pytest.raises(RuntimeError, match="CUDA error"):
        gftt_suppress.gftt_suppress_kept(q, offs, q.numel(), grid=100_000)
    assert (gftt_suppress.launches, gftt_suppress.cuda_launches()) == before
    torch.cuda.synchronize()


def test_gftt_device_route_matches_host_route_on_card(card, monkeypatch):
    from polychase_tpu_torch.engine import gftt
    from polychase_tpu_torch.kernels import gftt_suppress

    frame = panning_clip(np.random.default_rng(2), 1, 640, 480)[0]
    monkeypatch.setattr(gftt, "DEVICE_SUPPRESS_MIN", 1 << 62)
    host = gftt.gftt_finish(gftt.gftt_dispatch(frame, device=card))
    monkeypatch.setattr(gftt, "DEVICE_SUPPRESS_MIN", 0)
    k4, resumed = gftt_suppress.launches, gftt.resumed_frames
    got = good_features_to_track(frame, device=card)
    assert gftt_suppress.launches == k4 + 1
    assert gftt.resumed_frames == resumed
    assert got[0].shape[0] > 1000
    for a, b in zip(got, host):
        np.testing.assert_array_equal(a, b)
    # Cut at one round a batch, the frame is finished on the card.
    monkeypatch.setattr(gftt, "MAX_ROUNDS", 1)
    got = good_features_to_track(frame, device=card)
    assert gftt.resumed_frames == resumed + 1
    assert gftt_suppress.launches > k4 + 2
    for a, b in zip(got, host):
        np.testing.assert_array_equal(a, b)


def test_chained_fan_launches(lk_case, monkeypatch):
    """Skips -2, -1, 1, 2 chained: K2 once per level, K3 once per level of
    each of the two phases; the ±1 flows as the unchained solve's."""
    pts, src, tgts = lk_case
    skips = [-2, -1, 1, 2]
    host_pts = pts.cpu().numpy()
    un = lk.calc_optical_flow_multi(src, tgts, host_pts)
    monkeypatch.setenv("POLYCHASE_LK_CHAIN", "1")
    p0, i0 = lk_prep.launches, lk_iter.launches
    got = lk.calc_optical_flow_multi_finish(lk.calc_optical_flow_multi_async(
        src, tgts, host_pts, OPTS, skips))
    L = src.num_levels
    assert (lk_prep.launches - p0, lk_iter.launches - i0) == (L, 2 * L)
    for i in (1, 2):
        both = got[1][i] & un[1][i]
        assert both.mean() > 0.9
        d = np.linalg.norm(got[0][i][both] - un[0][i][both], axis=-1)
        assert np.median(d) < 0.05


def test_chained_split_matches_one_card(lk_case, monkeypatch):
    """The chained fan split by features over ``_split_devices()``: the
    one-card chained result within 1e-4 px, K2 once per level and K3 once
    per level per phase on every shard."""
    pts, src, tgts = lk_case
    skips = [-2, -1, 1, 2]
    host_pts = pts.cpu().numpy()
    monkeypatch.setenv("POLYCHASE_LK_CHAIN", "1")
    monkeypatch.setattr(lk, "FEAT_SHARD_MIN", 1)
    one = lk.calc_optical_flow_multi_finish(lk.calc_optical_flow_multi_async(
        src, tgts, host_pts, OPTS, skips))
    devices = _split_devices()
    p0, i0 = lk_prep.launches, lk_iter.launches
    split = lk.calc_optical_flow_multi_finish(
        lk.calc_optical_flow_multi_async(src, tgts, host_pts, OPTS, skips,
                                         devices=devices))
    L, D = src.num_levels, len(devices)
    assert (lk_prep.launches - p0, lk_iter.launches - i0) == (L * D,
                                                              2 * L * D)
    np.testing.assert_array_equal(split[1], one[1])
    both = split[1]
    np.testing.assert_allclose(split[0][both], one[0][both], rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# K5 (the ray cast sweep)
# ---------------------------------------------------------------------------


def _k5_scene(card, kind, G, K, sphere=(24, 32), seed=0):
    """A UV sphere (every triangle twice for ``duplicated``, 40 masked for
    ``masked``) on the card and G groups of K rays from distance 4 aimed
    around it (away from it for ``miss``)."""
    from polychase_tpu_torch.engine.geometry import (
        Mesh, mask_array_size, set_mask_bits,
    )
    from polychase_tpu_torch.synthetic import uv_sphere

    rng = np.random.default_rng(seed)
    verts, tris = uv_sphere(*sphere)
    words = None
    if kind == "duplicated":
        tris = np.concatenate([tris, tris])
    if kind == "masked":
        words = np.zeros(mask_array_size(len(tris)), np.uint32)
        for i in rng.choice(len(tris), 40, replace=False):
            words = set_mask_bits(words, int(i), "mask")
    ang = rng.uniform(0, 2 * np.pi, G)
    o = np.stack([4 * np.sin(ang), rng.uniform(-0.5, 0.5, G),
                  -4 * np.cos(ang)], -1).astype(np.float32)
    d = rng.normal(size=(G, K, 3)) * 0.7 - o[:, None]
    if kind == "miss":
        d = -d
    mesh = Mesh.create(verts, tris, words, device=card)
    return (mesh, torch.as_tensor(o, device=card),
            torch.as_tensor(d.astype(np.float32), device=card))


def _k5_inputs(mesh, o, d):
    return o, d, mesh.vertices, mesh.triangles, mesh.masked_triangles


K5_CASES = [("plain", 250, 128, (24, 32)), ("masked", 250, 128, (24, 32)),
            ("duplicated", 16, 128, (24, 32)), ("plain", 4, 2048, (80, 128)),
            ("plain", 2000, 1, (24, 32)), ("plain", 7, 333, (36, 72)),
            ("miss", 8, 100, (24, 32)), ("masked", 3000, 1, (36, 72)),
            ("masked", 50, 7, (24, 32)), ("plain", 9, 7, (36, 72)),
            ("plain", 4, 48, (80, 128)), ("masked", 20, 48, (24, 32))]


def _same_hits(got, want):
    """Ids, t and ``valid`` to the bit; positions, normals and barycentrics
    within 1e-6 relative (to the bit where K5 copies torch's rounding)."""
    for f in ("prim_id", "t", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("pos", "normal", "barycentric"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, atol=0)


def _device_work(fn):
    """``timing.device_work`` on ``fn``: the CUDA runtime's launches,
    copies and fills it queued, the device's kernels it ran (which the
    profiler may miss in a window this short), and what it returned."""
    from polychase_tpu_torch.timing import device_work

    return device_work(fn)


@pytest.mark.parametrize("kind,G,K,sphere", K5_CASES)
def test_raycast_sweep_matches_plain(card, kind, G, K, sphere):
    """K5 against the plain route (``cast_plain``: ``sweep_plain``, then
    ``hits_plain``) on the card, with and without the mask: every field of
    the hits (ids, t and ``valid`` to the bit), one launch a call, counted
    by the wrapper and by the library."""
    from polychase_tpu_torch.engine import raycast as R
    from polychase_tpu_torch.kernels import raycast_sweep as RS

    args = _k5_inputs(*_k5_scene(card, kind, G, K, sphere))
    for check_mask in (True, False):
        before = (RS.launches, RS.cuda_launches())
        got = RS.raycast_hits(*args, check_mask)
        assert (RS.launches, RS.cuda_launches()) == tuple(
            b + 1 for b in before)
        want = R.cast_plain(*args, check_mask)
        _same_hits(got, want)
    hit = got.valid
    if kind == "miss":
        assert not hit.any() and torch.isinf(got.t).all()
    else:
        assert hit.float().mean() > 0.3
    if kind == "duplicated":
        assert (got.prim_id[hit] < args[3].shape[0] // 2).all()
    if kind == "masked" and G * K >= 3000:
        # Some closest hits lie on masked triangles: dropped by the mask.
        masked = RS.raycast_hits(*args, True).valid
        assert bool((hit & ~masked).any())


def test_raycast_grouped_launches_k5(card):
    """``raycast_grouped`` on the card's tensors is one launch of K5 and no
    other kernel (counted by ``torch.profiler``); its hits equal the plain
    route's on the card, and the plain route equals, to the bit, the
    arithmetic of ``raycast_grouped`` before the route was split out (so a
    cast through it, such as config 4's refine truth, keeps its bits)."""
    from polychase_tpu_torch.engine import raycast as R
    from polychase_tpu_torch.kernels import raycast_sweep as RS

    from raycast_before import raycast_grouped_before

    mesh, o, d = _k5_scene(card, "masked", 250, 128)
    assert not R.grid_route(mesh.num_triangles)  # K5's route
    R.raycast_grouped(mesh, o, d)  # builds and loads the library
    torch.cuda.synchronize()
    before = (RS.launches, RS.cuda_launches())
    queued, ran, got = _device_work(lambda: R.raycast_grouped(mesh, o, d))
    assert (RS.launches, RS.cuda_launches()) == tuple(b + 2 for b in before)
    assert len(queued) == 1 and queued[0].startswith(
        "cudaLaunchKernelEx"), queued
    assert all("hits_kernel" in n for n, _ in ran), ran
    want = R.cast_plain(*_k5_inputs(mesh, o, d))
    assert RS.launches == before[0] + 2
    _same_hits(got, want)
    old = raycast_grouped_before(mesh, o, d)
    for f in ("pos", "normal", "barycentric", "t", "prim_id", "valid"):
        assert torch.equal(getattr(want, f), getattr(old, f)), f


def test_raycast_sweep_launches_on_its_tensors_card(card):
    """K5 on card 1's tensors, launched while card 0 is current, equals the
    same call on card 0 to the bit."""
    from polychase_tpu_torch.kernels import raycast_sweep as RS

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    args = _k5_inputs(*_k5_scene(c0, "plain", 16, 128))
    with torch.cuda.device(0):
        before = RS.launches
        ref = RS.raycast_hits(*args)
        got = RS.raycast_hits(*(a.to(c1) for a in args))
        assert RS.launches == before + 2
        torch.cuda.synchronize(c1)
    for f in ("pos", "normal", "barycentric", "t", "prim_id", "valid"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.device == c1
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=0, atol=0)


def test_raycast_sweep_failures_raise(card, monkeypatch):
    """No fallback to the plain route: a failed build raises from
    ``raycast_grouped``, a plan the library refuses (3 rays a thread, or
    the packed layout at 2) raises with no launch counted, and inputs the kernel does not take
    raise ValueError."""
    from polychase_tpu_torch.engine import raycast as R
    from polychase_tpu_torch.kernels import build
    from polychase_tpu_torch.kernels import raycast_sweep as RS

    mesh, o, d = _k5_scene(card, "plain", 4, 64)
    args = _k5_inputs(mesh, o, d)
    before = (RS.launches, RS.cuda_launches())
    # 3 rays a thread, and the packed layout at 2 (which launch_plan never
    # gives), have no kernel.
    for plan in (RS.Plan(3, False, 1, 1), RS.Plan(2, True, 4, 1)):
        with monkeypatch.context() as m:
            m.setattr(RS, "launch_plan", lambda *a, plan=plan: plan)
            with pytest.raises(RuntimeError, match="CUDA error"):
                RS.raycast_hits(*args)
    assert (RS.launches, RS.cuda_launches()) == before
    with pytest.raises(ValueError):
        RS.raycast_hits(o, d.transpose(0, 1), *args[2:])
    with pytest.raises(ValueError):
        RS.raycast_hits(o, d.double(), *args[2:])
    with pytest.raises(ValueError):
        RS.raycast_hits(o, d.cpu(), *args[2:])
    with pytest.raises(ValueError):
        RS.raycast_hits(o, d, args[2], args[3].int(), args[4])
    with pytest.raises(ValueError):
        RS.raycast_hits(o, d, args[2].cpu(), *args[3:])

    def broken(*a, **kw):
        raise RuntimeError("nvcc failed on raycast_sweep.cu")

    monkeypatch.setattr(build, "load", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        R.raycast_grouped(mesh, o, d)
    assert RS.launches == before[0]


# ---------------------------------------------------------------------------
# K6 (the grid cast)
# ---------------------------------------------------------------------------


def _k6_scene(card, kind, n, seed=0):
    """A mesh on the card, its grid and ``n`` rays: from distance 4 around a
    UV sphere (24×32; 80×128 for ``frame``; 450×450, 404,100 triangles,
    for ``large``; 40 triangles masked for ``masked``), a soup of 2,000
    triangles, axis-aligned rays from inside and outside the sphere, a huge
    ground triangle under the sphere, or an empty mesh."""
    from polychase_tpu_torch.engine.geometry import (
        Mesh, mask_array_size, set_mask_bits,
    )
    from polychase_tpu_torch.engine.gridcast import build_grid_accel
    from polychase_tpu_torch.synthetic import uv_sphere

    rng = np.random.default_rng(seed)
    verts, tris = uv_sphere(*{"frame": (80, 128), "large": (450, 450)}.get(
        kind, (24, 32)))
    words = None
    if kind == "masked":
        words = np.zeros(mask_array_size(len(tris)), np.uint32)
        for i in rng.choice(len(tris), 40, replace=False):
            words = set_mask_bits(words, int(i), "mask")
    if kind == "soup":
        centers = rng.uniform(-2, 2, (2000, 1, 3))
        verts = (centers + rng.normal(0, 0.2, (2000, 3, 3))).reshape(-1, 3)
        tris = np.arange(6000).reshape(-1, 3)
    if kind == "huge":
        verts = np.concatenate([verts, [[-50, -50, -2], [50, -50, -2],
                                        [0, 80, -2]]])
        tris = np.concatenate([tris, [[len(verts) - 3, len(verts) - 2,
                                       len(verts) - 1]]])
    if kind == "empty":
        verts, tris = np.zeros((0, 3)), np.zeros((0, 3))
    o = rng.normal(size=(n, 3))
    o = 4 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(0, 0.7, (n, 3)) - o
    if kind == "axis":
        o = np.concatenate([rng.uniform(-0.5, 0.5, (n // 2, 3)),
                            rng.uniform(-3, 3, (n - n // 2, 3))])
        d = np.concatenate([np.eye(3), -np.eye(3)])[rng.integers(0, 6, n)]
    if kind == "huge":
        d[: n // 4] = [0.1, 0.05, -1.0]
    mesh = Mesh.create(verts, tris, words, device=card)
    accel = build_grid_accel(verts, tris, device=card)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                    device=card)
    return mesh, accel, f32(o), f32(d)


# (kind, rays, keywords, lanes a ray: None for team_width's, else forced)
K6_CASES = [("plain", 2000, {}, None), ("frame", 8192, {}, None),
            ("masked", 3000, {}, None),
            ("masked", 3000, dict(check_mask=False), None),
            ("soup", 4096, {}, None), ("axis", 2048, {}, None),
            ("huge", 2048, {}, None), ("empty", 256, {}, None),
            ("plain", 2000, dict(max_iters=1), None),
            ("frame", 8192, dict(max_iters=8), None),
            ("plain", 2000, dict(block=1), None),
            ("plain", 100, dict(block=2), None),
            ("plain", 2000, dict(block=7), None),
            ("large", 8192, {}, None)]
K6_CASES += [c for team in grid_cast.TEAMS for c in (
    ("frame", 8192, {}, team), ("soup", 4096, {}, team),
    ("axis", 2048, {}, team), ("huge", 2048, dict(block=7), team),
    ("plain", 2000, dict(max_iters=6, block=1), team),
    ("frame", 8192, dict(max_iters=8), team))]


@pytest.mark.parametrize("kind,n,kw,team", K6_CASES)
def test_grid_cast_matches_plain(card, kind, n, kw, team):
    """K6 against its plain version (``grid_plain``, the reference's
    lockstep loop in torch) on the card: every field of the hits to the
    bit, one launch a call, counted by the wrapper and by the library; at
    the team width ``team_width`` picks and at each of ``TEAMS``, forced
    through ``_launch``."""
    from polychase_tpu_torch.engine.gridcast import grid_plain
    from polychase_tpu_torch.kernels import grid_cast as GK

    mesh, accel, o, d = _k6_scene(card, kind, n)
    arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
    before = (GK.launches, GK.cuda_launches())
    if team is None:
        got = GK.grid_hits(o, d, accel, *arrays, **kw)
    else:
        assert team in GK.TEAMS
        got = GK._launch(o, d, accel, *arrays, kw.get("check_mask", True),
                         kw.get("block", 4), kw.get("max_iters", 200_000),
                         team)
    assert (GK.launches, GK.cuda_launches()) == tuple(b + 1 for b in before)
    want = grid_plain(o, d, accel, *arrays, **kw)
    for f in ("pos", "normal", "barycentric", "t", "prim_id", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if kind == "empty":
        assert not bool(got.valid.any())
    elif kw.get("max_iters") != 1:
        assert got.valid.float().mean() > 0.2


def test_grid_raycast_grouped_launches_k6(card):
    """``grid_raycast_grouped`` on the card's tensors is one launch of K6,
    its hits those of ``grid_raycast`` on the flat rays."""
    from polychase_tpu_torch.engine import gridcast as GC
    from polychase_tpu_torch.kernels import grid_cast as GK

    mesh, accel, o, d = _k6_scene(card, "plain", 512)
    origins, dirs = o[:4], d.reshape(4, 128, 3)
    before = GK.launches
    grouped = GC.grid_raycast_grouped(mesh, accel, origins, dirs)
    flat = GC.grid_raycast(mesh, accel,
                           origins[:, None].expand(4, 128, 3), dirs)
    assert GK.launches == before + 2
    assert grouped.t.shape == (4, 128)
    for f in ("pos", "normal", "barycentric", "t", "prim_id", "valid"):
        assert torch.equal(getattr(grouped, f).reshape(getattr(flat, f).shape),
                           getattr(flat, f)), f


# A UV sphere above ``raycast.GRID_TRIANGLE_THRESHOLD``: 179,400 triangles.
ROUTE_SPHERE = (300, 300)


def test_grouped_cast_above_the_threshold_takes_k6(card):
    """On the card, ``raycast_grouped`` on a mesh above the threshold (a
    tracking frame's 4 × 2048 rays) builds the mesh's grid at its first
    cast only, then launches K6 once a cast and K5 never (no
    ``hits_kernel`` among the kernels the profiler saw); every field of
    its hits equals ``grid_plain``'s on the card to the bit."""
    from polychase_tpu_torch.engine import gridcast as GC
    from polychase_tpu_torch.engine import raycast as R
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.kernels import raycast_sweep as RS
    from polychase_tpu_torch.synthetic import uv_sphere

    mesh = Mesh.create(*uv_sphere(*ROUTE_SPHERE), device=card)
    assert R.grid_route(mesh.num_triangles)
    rng = np.random.default_rng(3)
    o = rng.normal(size=(4, 3))
    o = 4 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(0, 0.7, (4, 2048, 3)) - o[:, None]
    origins = torch.as_tensor(o.astype(np.float32), device=card)
    dirs = torch.as_tensor(d.astype(np.float32), device=card)
    builds = GC.builds
    R.raycast_grouped(mesh, origins, dirs)  # builds the grid, loads K6
    torch.cuda.synchronize()
    assert GC.builds == builds + 1
    before = (grid_cast.launches, grid_cast.cuda_launches(), RS.launches)
    _, ran, got = _device_work(lambda: R.raycast_grouped(mesh, origins,
                                                          dirs))
    assert (grid_cast.launches, grid_cast.cuda_launches(), RS.launches) == (
        before[0] + 2, before[1] + 2, before[2])  # device_work calls twice
    assert GC.builds == builds + 1
    # The profiler may miss a kernel in a window this short; the libraries'
    # counts above are the check, this one what it saw.
    assert not [n for n, _ in ran if "hits_kernel" in n], ran
    want = GC.grid_plain(origins[:, None].expand(4, 2048, 3).reshape(-1, 3),
                         dirs.reshape(-1, 3), mesh.grid, mesh.vertices,
                         mesh.triangles, mesh.masked_triangles)
    for f in ("pos", "normal", "barycentric", "t", "prim_id", "valid"):
        assert torch.equal(getattr(got, f).reshape(getattr(want, f).shape),
                           getattr(want, f)), f
    assert got.valid.float().mean() > 0.2


def test_tracking_above_the_threshold_launches_k6(card, tmp_path):
    """Tracking on a mesh above the threshold, twice through one
    ``AcceleratedMesh``: each frame step one launch of K6 and of K1 and
    none of K5, the grid built once; the poses within 5e-3 of the
    truth."""
    from polychase_tpu_torch.engine import gridcast as GC
    from polychase_tpu_torch.kernels import raycast_sweep as RS

    pc, db, mesh, poses, _ = _segment_clip(card, tmp_path, n=8,
                                           sphere=ROUTE_SPHERE)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = quat_to_mat_np(poses[0][0])
    view[:3, 3] = poses[0][1]
    scene = pc.SceneTransformations(np.eye(4), view, pc.CameraIntrinsics(
        1800, 1800, 960, 540, 1, 1920, 1080, pc.CameraConvention.OpenCV))
    builds = GC.builds
    for _ in range(2):
        before = (pnp_lm.launches, grid_cast.launches, RS.launches)
        got = []
        pc.track_sequence(db, 0, 7, scene, mesh,
                          lambda r: got.append(r) or True)
        assert (pnp_lm.launches, grid_cast.launches, RS.launches) == (
            before[0] + 7, before[1] + 7, before[2])
        assert [r.frame for r in got] == list(range(1, 8))
        for r in got:
            assert np.linalg.norm(r.pose.t - poses[r.frame][1]) < 5e-3
    assert GC.builds == builds + 1


def test_grid_cast_launches_on_its_tensors_card(card):
    """K6 on card 1's tensors, launched while card 0 is current, equals the
    same call on card 0 to the bit."""
    from polychase_tpu_torch.kernels import grid_cast as GK

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    c1 = torch.device("cuda", 1)
    mesh, accel, o, d = _k6_scene(torch.device("cuda", 0), "plain", 1000)
    arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
    with torch.cuda.device(0):
        before = GK.launches
        ref = GK.grid_hits(o, d, accel, *arrays)
        got = GK.grid_hits(o.to(c1), d.to(c1), accel.to(c1),
                           *(a.to(c1) for a in arrays))
        assert GK.launches == before + 2
        torch.cuda.synchronize(c1)
    for f in ("pos", "normal", "barycentric", "t", "prim_id", "valid"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.device == c1
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=0, atol=0)


def test_grid_cast_failures_raise(card, monkeypatch):
    """No fallback to the plain version: a failed build raises from
    ``grid_raycast``, a launch the library refuses raises with no launch
    counted, and inputs the kernel does not take raise ValueError."""
    from polychase_tpu_torch.engine import gridcast as GC
    from polychase_tpu_torch.kernels import build
    from polychase_tpu_torch.kernels import grid_cast as GK

    mesh, accel, o, d = _k6_scene(card, "plain", 256)
    arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
    GK.grid_hits(o, d, accel, *arrays)  # builds and loads the library
    before = (GK.launches, GK.cuda_launches())
    with monkeypatch.context() as m:
        m.setattr(GK, "team_width", lambda accel: 6)
        with pytest.raises(RuntimeError, match="CUDA error"):
            GK.grid_hits(o, d, accel, *arrays)
    assert (GK.launches, GK.cuda_launches()) == before
    for bad in ((o, d.double()), (o, d.cpu()), (o[:10], d)):
        with pytest.raises(ValueError):
            GK.grid_hits(*bad, accel, *arrays)
    with pytest.raises(ValueError):
        GK.grid_hits(o, d, accel.to("cpu"), *arrays)
    with pytest.raises(ValueError):
        GK.grid_hits(o, d, accel, arrays[0], arrays[1].int(), arrays[2])

    def broken(*a, **kw):
        raise RuntimeError("nvcc failed on grid_cast.cu")

    monkeypatch.setattr(build, "load", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        GC.grid_raycast(mesh, accel, o, d)
    assert GK.launches == before[0]
