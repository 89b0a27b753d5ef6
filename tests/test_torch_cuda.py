"""K1 (csrc/pnp_lm.cu), K2 (csrc/lk_prep.cu) and K3 (csrc/lk_iter.cu)
against their plain torch versions on a CUDA card, and refine and pin mode
on the card against the same work on the CPU.

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
from polychase_tpu_torch.kernels import lk_iter, lk_prep, pnp_lm
from polychase_tpu_torch.synthetic import panning_clip

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
    """512 pins go through the device route, which launches K1 once; the
    pose agrees with the host route within 1e-4."""
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
                        np.random.default_rng(0), 512)
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
