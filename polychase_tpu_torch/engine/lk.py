"""Pyramidal Lucas–Kanade sparse optical flow.

Port of ``polychase_tpu/engine/lk.py`` (XLA flavor), with OpenCV's
semantics (``video/src/lkpyramid.cpp``):

- pyramid: 5-tap Gaussian [1 4 6 4 1]/16 pyrDown with reflect-101
  borders, level size ``((w+1)//2, (h+1)//2)``, built on the device from the
  uint8 frame;
- Scharr derivatives per level (smoothing (3, 10, 3) × central difference,
  reflect-101, unscaled: 32× the intensity gradient);
- each level is padded by ``win + 2``: the image reflect-101 (in stages when
  the pad is wider than the level), the derivatives with zeros;
- per level, the source-frame prep (template patches, derivative patches,
  the 2×2 normal matrix and its gate) is :func:`prep_level`, and the
  iteration over every (target, feature) pair is :func:`iter_level`.  These
  two are the plain torch versions of the hand-written kernels K2
  (``kernels/lk_prep.py``) and K3 (``kernels/lk_iter.py``);
- the coarse-to-fine chain is a host loop over levels;
- given several devices, a solve splits its features (from
  ``FEAT_SHARD_MIN`` of them) or else its targets over them
  (``parallel.analyze``), as the reference's mesh routes do
  (``polychase_tpu/engine/lk.py:865-924``, ``:1111-1164``);
- with ``POLYCHASE_LK_CHAIN=1`` (the reference's opt-in, default off) a
  skip fan is solved as chained phases (:func:`chain_engages`,
  :func:`_chained_dispatch`): K2 once per level for every phase, then K3
  once per level per phase, each phase seeded from the flows of the one
  before it.

Filters are sums of shifted slices in tap order, as the reference writes
them, so the CPU arm agrees with it to float rounding.  The reference's TPU
devices (shape buckets, 4/8 target padding, the compressed result transfer,
bf16 storage) are not ported.
"""

from __future__ import annotations

import functools
import os
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..backend import HostCopy, as_device
from ..parallel import resolve_devices


class LKOptions(NamedTuple):
    """Flow options (cpp/opticalflow.h:27-33)."""

    window_size: int = 10
    max_level: int = 3
    term_max_iters: int = 30
    term_epsilon: float = 0.01
    min_eigen_threshold: float = 1e-4


_FLT_SCALE = 1.0 / (1 << 20)  # OpenCV's fixed-point compensation factor
_FLT_EPSILON = float(np.float32(1.1920929e-07))
_PYR_TAPS = (0.0625, 0.25, 0.375, 0.25, 0.0625)  # [1 4 6 4 1] / 16

# ---------------------------------------------------------------------------
# Pyramid construction
# ---------------------------------------------------------------------------


def _pad(img: torch.Tensor, top: int, bottom: int, left: int, right: int,
         mode: str) -> torch.Tensor:
    return F.pad(img[None], (left, right, top, bottom), mode=mode)[0]


def _sep_sum(p: torch.Tensor, kx, ky, H: int, W: int) -> torch.Tensor:
    """Separable correlation of a padded image: shifted column slices summed
    in tap order, then shifted row slices (zero taps skipped)."""
    acc = torch.zeros((p.shape[0], W), dtype=p.dtype, device=p.device)
    for i, c in enumerate(kx):
        if c:
            acc = acc + float(c) * p[:, i:i + W]
    out = torch.zeros((H, W), dtype=p.dtype, device=p.device)
    for j, c in enumerate(ky):
        if c:
            out = out + float(c) * acc[j:j + H]
    return out


def _pyr_down(img: torch.Tensor) -> torch.Tensor:
    """OpenCV pyrDown: Gaussian blur then 2× decimation (even pixels)."""
    H, W = img.shape
    p = _pad(img, 2, 2, 2, 2, "reflect")
    return _sep_sum(p, _PYR_TAPS, _PYR_TAPS, H, W)[::2, ::2].contiguous()


def num_pyramid_levels(h: int, w: int, opts: LKOptions) -> int:
    """Levels actually built: OpenCV stops when a level gets smaller than
    the window (modules/video/src/lkpyramid.cpp buildOpticalFlowPyramid)."""
    levels = 1
    win = opts.window_size
    for _ in range(opts.max_level):
        h, w = (h + 1) // 2, (w + 1) // 2
        if w <= win or h <= win:
            break
        levels += 1
    return levels


def build_pyramid(image: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Grayscale image → list of ``levels`` float32 tensors."""
    img = image.to(torch.float32)
    pyr = [img]
    for _ in range(levels - 1):
        img = _pyr_down(img)
        pyr.append(img)
    return pyr


def _scharr_derivs(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OpenCV calcSharrDeriv: smooth (3,10,3) × diff (-1,0,1), unscaled."""
    H, W = img.shape
    p = _pad(img, 1, 1, 1, 1, "reflect")
    dx = _sep_sum(p, (-1.0, 0.0, 1.0), (3.0, 10.0, 3.0), H, W)
    dy = _sep_sum(p, (3.0, 10.0, 3.0), (-1.0, 0.0, 1.0), H, W)
    return dx, dy


def _pad_level(img: torch.Tensor, pad: int, zero: bool) -> torch.Tensor:
    """Pad a level for out-of-bounds window access: reflect-101 for images
    (in stages when the pad is wider than the level), zeros for
    derivatives."""
    if zero:
        return _pad(img, pad, pad, pad, pad, "constant")
    remaining = pad
    out = img
    while remaining > 0:
        step = min(remaining, out.shape[0] - 1, out.shape[1] - 1)
        if step <= 0:
            return _pad(out, remaining, remaining, remaining, remaining,
                        "replicate")
        out = _pad(out, step, step, step, step, "reflect")
        remaining -= step
    return out


# One prepared level: padded image, padded dx, padded dy, unpadded (H, W).
Level = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Tuple[int, int]]


def _prepare_levels(pyr: Sequence[torch.Tensor], *, win: int,
                    levels: int) -> List[Level]:
    """Pad images and compute + pad Scharr derivatives for every level."""
    pad = win + 2
    out = []
    for lvl in range(levels):
        img = pyr[lvl]
        dx, dy = _scharr_derivs(img)
        out.append((
            _pad_level(img, pad, zero=False).contiguous(),
            _pad_level(dx, pad, zero=True).contiguous(),
            _pad_level(dy, pad, zero=True).contiguous(),
            (int(img.shape[0]), int(img.shape[1])),
        ))
    return out


class PyramidCache:
    """Prepared (padded + differentiated) pyramid for one frame."""

    def __init__(self, levels_data: List[Level], num_levels: int,
                 opts: LKOptions):
        self.levels = levels_data
        self.num_levels = num_levels
        self.opts = opts

    @property
    def device(self) -> torch.device:
        return self.levels[0][0].device


def prepare_pyramid(image, opts: LKOptions = LKOptions(), *,
                    device) -> PyramidCache:
    """Build the LK pyramid for a grayscale frame (uint8 or float).

    ``image`` is a host array or a tensor; it goes to ``device`` in its own
    dtype (a uint8 frame crosses as uint8) and is converted there."""
    device = as_device(device)
    if isinstance(image, torch.Tensor):
        img = image.to(device, non_blocking=True)
    else:
        img = torch.from_numpy(np.ascontiguousarray(image)).to(
            device, non_blocking=True)
    if img.dim() != 2:
        raise ValueError("image must be 2D grayscale")
    levels = num_pyramid_levels(img.shape[0], img.shape[1], opts)
    pyr = build_pyramid(img, levels)
    data = _prepare_levels(pyr, win=opts.window_size, levels=levels)
    return PyramidCache(data, levels, opts)


# ---------------------------------------------------------------------------
# Plain LK: the torch versions of K2 (prep) and K3 (iteration)
# ---------------------------------------------------------------------------


def _gather_patches(padded: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                    pad: int, win: int) -> torch.Tensor:
    """Gather (win+1)² integer windows with top-left (ix, iy).

    ``padded`` is (B, Hp, Wp), ``ix`` / ``iy`` are float origins (B, N) in
    unpadded level coordinates.  Origins are clamped into the buffer as
    ``dynamic_slice`` clamps them in the reference (NaN → 0), so any
    position reads inside it; only features that fail the bounds test see
    the clamp.  Returns (B, N, win+1, win+1).
    """
    B, Hp, Wp = padded.shape
    k = win + 1
    sx = torch.nan_to_num(ix + pad, nan=0.0).clamp(0, Wp - k).long()
    sy = torch.nan_to_num(iy + pad, nan=0.0).clamp(0, Hp - k).long()
    ar = torch.arange(k, device=padded.device)
    idx = ((sy[..., None, None] + ar[:, None]) * Wp
           + (sx[..., None, None] + ar[None, :]))
    flat = torch.gather(padded.reshape(B, Hp * Wp), 1, idx.reshape(B, -1))
    return flat.reshape(*ix.shape, k, k)


def _bilerp(P: torch.Tensor, ax: torch.Tensor, ay: torch.Tensor):
    """Bilinear blend of integer patches: (..., w+1, w+1) → (..., w, w)."""
    w00 = ((1 - ax) * (1 - ay))[..., None, None]
    w01 = (ax * (1 - ay))[..., None, None]
    w10 = ((1 - ax) * ay)[..., None, None]
    w11 = (ax * ay)[..., None, None]
    return (w00 * P[..., :-1, :-1] + w01 * P[..., :-1, 1:]
            + w10 * P[..., 1:, :-1] + w11 * P[..., 1:, 1:])


def _origin(pts: torch.Tensor, win: int):
    """Window origin floor(pt − (win−1)/2) and the blend fractions."""
    half = (win - 1) * 0.5
    ip = torch.floor(pts - half)
    frac = pts - half - ip
    return ip[..., 0], ip[..., 1], frac[..., 0], frac[..., 1]


def _in_bounds(ix, iy, win: int, H: int, W: int) -> torch.Tensor:
    """OpenCV's window bounds test, on float origins (NaN fails it)."""
    return (ix >= -win) & (ix < W) & (iy >= -win) & (iy < H)


def prep_level(img_pad, dx_pad, dy_pad, pts, *, win: int, H: int, W: int,
               min_eig_thr: float):
    """Source-frame prep of one level (plain version of K2).

    ``pts`` (N, 2) are positions at this level's scale.  Returns
    ``(patches, a11, a12, a22, invd, ok)``: the template and derivative
    patches (N, 3, win, win) (image, dx, dy), feature-major, and the normal
    matrix (scaled 2⁻²⁰), its inverse determinant and the gate (bounds, min
    eigenvalue ≥ ``min_eig_thr``, det ≥ FLT_EPSILON) as (N,) vectors.
    """
    pad = win + 2
    ix, iy, ax, ay = _origin(pts, win)

    def patch(padded):
        return _bilerp(
            _gather_patches(padded[None], ix[None], iy[None], pad, win)[0],
            ax, ay,
        )

    ip = patch(img_pad)
    dxi = patch(dx_pad)
    dyi = patch(dy_pad)
    a11 = torch.sum(dxi * dxi, dim=(1, 2)) * _FLT_SCALE
    a12 = torch.sum(dxi * dyi, dim=(1, 2)) * _FLT_SCALE
    a22 = torch.sum(dyi * dyi, dim=(1, 2)) * _FLT_SCALE
    D = a11 * a22 - a12 * a12
    min_eig = (
        a22 + a11 - torch.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)
    ) / (2.0 * float(win * win))
    ok = (_in_bounds(ix, iy, win, H, W) & (min_eig >= min_eig_thr)
          & (D >= _FLT_EPSILON))
    invd = torch.where(ok, 1.0 / torch.where(ok, D, 1.0), 0.0)
    return torch.stack([ip, dxi, dyi], dim=1), a11, a12, a22, invd, ok


def iter_level(imgs_pad, patches, a11, a12, a22, invd, ok, pts, *,
               win: int, H: int, W: int, max_iters: int, eps2: float,
               level_is_zero: bool):
    """LK iteration of one level for T targets (plain version of K3).

    ``imgs_pad`` (T, Hp, Wp) are the targets' padded images, ``pts``
    (T, N, 2) the current guesses; the prep arrays come from
    :func:`prep_level` and are shared by every target.  Each feature stops
    on step² ≤ ``eps2``, on oscillation (back half a step) or on leaving the
    image; it starts active where ``ok``.  Returns ``(pts (T, N, 2),
    status (T, N) bool, err (T, N))``: status and err are final only at
    level 0 (elsewhere all True and 0).
    """
    return iter_level_counted(
        imgs_pad, patches, a11, a12, a22, invd, ok, pts, win=win, H=H, W=W,
        max_iters=max_iters, eps2=eps2, level_is_zero=level_is_zero)[:3]


def iter_level_counted(imgs_pad, patches, a11, a12, a22, invd, ok, pts, *,
                       win: int, H: int, W: int, max_iters: int, eps2: float,
                       level_is_zero: bool):
    """:func:`iter_level`, and the iterations each pair needed (T, N)
    int32: those in which it was active and inside the image, each of which
    samples its window once.  The work a kernel must do for these inputs is
    counted from them."""
    T, N = pts.shape[:2]
    pad = win + 2
    I, GX, GY = patches[:, 0], patches[:, 1], patches[:, 2]
    nxt = pts
    active = ok.expand(T, N).clone()
    status = active.clone() if level_is_zero else torch.ones_like(active)
    prev = torch.zeros_like(pts)
    iters = torch.zeros((T, N), dtype=torch.int32, device=pts.device)

    def sample(p):
        ix, iy, bx, by = _origin(p, win)
        J = _bilerp(_gather_patches(imgs_pad, ix, iy, pad, win), bx, by)
        return ix, iy, J

    for j in range(max_iters):
        if not bool(active.any()):
            break  # frozen features never move again
        ix, iy, J = sample(nxt)
        oob = ~_in_bounds(ix, iy, win, H, W)
        if level_is_zero:
            status = status & ~(active & oob)
        active = active & ~oob
        iters += active
        diff = (J - I) * 32.0
        b1 = torch.sum(diff * GX, dim=(2, 3)) * _FLT_SCALE
        b2 = torch.sum(diff * GY, dim=(2, 3)) * _FLT_SCALE
        # OpenCV's delta (note the sign convention of its solve)
        dx_ = (a12 * b2 - a22 * b1) * invd
        dy_ = (a12 * b1 - a11 * b2) * invd
        delta = torch.stack([dx_, dy_], dim=-1)
        stepped = torch.where(active[..., None], nxt + delta, nxt)
        converged = torch.sum(delta * delta, dim=-1) <= eps2
        oscillating = (
            (j > 0)
            & (torch.abs(dx_ + prev[..., 0]) < 0.01)
            & (torch.abs(dy_ + prev[..., 1]) < 0.01)
        )
        stepped = torch.where((active & oscillating)[..., None],
                              stepped - delta * 0.5, stepped)
        active = active & ~converged & ~oscillating
        prev, nxt = delta, stepped

    if level_is_zero:
        _, _, J = sample(nxt)
        err = torch.sum(torch.abs(J - I), dim=(2, 3)) / float(win * win)
    else:
        err = torch.zeros((T, N), dtype=torch.float32, device=pts.device)
    return nxt, status, err, iters


def _lk_level(prev_level: Level, next_imgs, prev_pts, next_pts, *,
              level_is_zero: bool, eps2: float, min_eig_thr: float,
              win: int, max_iters: int, prep=prep_level,
              iterate=iter_level, pre=None):
    """One pyramid level: the source prep (``pre`` where it is hoisted),
    then the iteration into every target.  ``prep`` / ``iterate`` default
    to the plain versions."""
    img, dx, dy, (H, W) = prev_level
    if pre is None:
        pre = prep(img, dx, dy, prev_pts, win=win, H=H, W=W,
                   min_eig_thr=min_eig_thr)
    return iterate(next_imgs, *pre, next_pts, win=win, H=H, W=W,
                   max_iters=max_iters, eps2=eps2,
                   level_is_zero=level_is_zero)


def _lk_core(prev_levels: Sequence[Level], next_images, pts, eps2: float,
             min_eig_thr: float, win: int, max_iters: int, levels: int, *,
             prep=prep_level, iterate=iter_level, preps=None, start=None):
    """Coarse-to-fine chain of one source pyramid into T targets.

    ``next_images[lvl]`` is (T, Hp, Wp); ``pts`` (N, 2) full-resolution
    source positions; ``start`` (T, N, 2) the full-resolution first guesses
    (default ``pts``); ``preps`` the source prep of every level, hoisted
    (default: ``prep`` at each level).  Returns ``(next (T, N, 2), status
    (T, N), err)``."""
    T = next_images[0].shape[0]
    top = levels - 1
    if start is None:
        start = pts.expand(T, *pts.shape)
    cur = (start * (1.0 / (1 << top))).contiguous()
    status = err = None
    for lvl in range(top, -1, -1):
        if lvl != top:
            cur = cur * 2.0
        cur, st, er = _lk_level(
            prev_levels[lvl], next_images[lvl], pts * (1.0 / (1 << lvl)),
            cur, level_is_zero=(lvl == 0), eps2=eps2,
            min_eig_thr=min_eig_thr, win=win, max_iters=max_iters,
            prep=prep, iterate=iterate,
            pre=None if preps is None else preps[lvl],
        )
        if lvl == 0:
            status, err = st, er
    return cur, status, err


def _lk_all_levels_multi(prev_levels, next_images, pts, eps2: float,
                         min_eig_thr: float, *, win: int, max_iters: int,
                         levels: int):
    """Track the same features into T targets: :func:`_lk_core` through
    the kernel wrappers, which launch K2 and K3 on CUDA tensors and take the
    plain versions on CPU tensors."""
    from ..kernels.lk_iter import lk_iter_level
    from ..kernels.lk_prep import lk_prep_level

    return _lk_core(prev_levels, next_images, pts, eps2, min_eig_thr, win,
                    max_iters, levels, prep=lk_prep_level,
                    iterate=lk_iter_level)


# ---------------------------------------------------------------------------
# Chained skip fan (polychase_tpu/engine/lk.py:635-855)
# ---------------------------------------------------------------------------
#
# The fan solves the same features into targets at skips ±{1, 2, 4, 8}.
# Flow is near-linear over small skips: the skip-2k flow is about twice the
# skip-k flow, so a phase seeded from the phase before it starts near its
# optimum, and only the ±1 phase starts cold.  Phases go in |skip| order,
# one slot per sign; a feature whose seed pair failed starts from zero, as
# the unchained solve does.  On repetitive texture a seed can land in
# another basin than the zero start: the same ambiguity, resolved towards
# the extrapolated motion.  Downstream PnP and refine take flows through
# inlier gates and robust losses, as they take OpenCV's.

_CHAIN_T = 2  # slots per phase: one per sign of the skip


def _lk_chain_enabled() -> bool:
    """``POLYCHASE_LK_CHAIN=1`` chains the skip fan (default off): a switch
    of the JAX package's semantics, kept as it is."""
    return os.environ.get("POLYCHASE_LK_CHAIN", "0") == "1"


def _chain_plan(skips):
    """Group a skip fan into chained phases of same-|skip| targets.

    Returns a list of phases, each a list of exactly ``_CHAIN_T`` slots
    ``(orig_idx | None, src (phase, col) | None, scale)``: ``orig_idx``
    indexes the caller's targets (None: padding, the source frame itself at
    zero seed), ``src`` the same-sign slot solved in an earlier phase that
    seeds this one, ``scale`` the skip ratio applied to its flow."""
    mags = sorted({abs(s) for s in skips})
    solved: dict = {}   # sign -> (mag, phase, col)
    plan = []
    for p, mag in enumerate(mags):
        slots = []
        for i, s in enumerate(skips):
            if abs(s) != mag:
                continue
            sign = s > 0
            src = solved.get(sign)
            if src is None:
                slots.append((i, None, 0.0))
            else:
                slots.append((i, (src[1], src[2]), mag / src[0]))
            solved[sign] = (mag, p, len(slots) - 1)
        while len(slots) < _CHAIN_T:
            slots.append((None, None, 0.0))
        plan.append(slots)
    return plan


def chain_engages(skips, n_features=None, n_devices: int = 1) -> bool:
    """Whether a fan with these skips takes the chained dispatch: with
    ``POLYCHASE_LK_CHAIN=1``, two magnitudes of skip at least, and, given
    several devices, only in the feature split (``n_features`` ≥
    ``FEAT_SHARD_MIN``): seeds are per feature, so they split with the
    features; below it the target split uses the devices better than
    2-wide phases would."""
    if skips is None or not _lk_chain_enabled():
        return False
    if len({abs(s) for s in skips}) < 2:
        return False
    if n_devices <= 1:
        return True
    return n_features is not None and n_features >= FEAT_SHARD_MIN


def lk_chain_prep(prev_levels: Sequence[Level], pts, *, win: int,
                  min_eig_thr: float, levels: int):
    """The source prep of every level for all phases of a chained fan: K2
    once per level (its plain version on CPU tensors)."""
    from ..kernels.lk_prep import lk_prep_level

    out = []
    for lvl in range(levels):
        img, dx, dy, (H, W) = prev_levels[lvl]
        out.append(lk_prep_level(img, dx, dy, pts * (1.0 / (1 << lvl)),
                                 win=win, H=H, W=W, min_eig_thr=min_eig_thr))
    return out


def lk_chain_phase(prev_levels: Sequence[Level], preps, next_images, pts,
                   src_nxt, src_status, scales, *, win: int, max_iters: int,
                   eps2: float, levels: int):
    """One chained phase of T slots: the seed ``where(src_status,
    (src_nxt - pts) · scale, 0)``, then the solve from ``pts + seed`` with
    the hoisted ``preps``, K3 once per level.  ``src_nxt`` (T, N, 2) and
    ``src_status`` (T, N) are the seeding slots' results (``pts`` and False
    where a slot has none), ``scales`` (T,).  Returns ``(next, status,
    err)``."""
    from ..kernels.lk_iter import lk_iter_level

    seed = torch.where(src_status[..., None],
                       (src_nxt - pts[None]) * scales[:, None, None], 0.0)
    return _lk_core(prev_levels, next_images, pts, eps2, 0.0, win, max_iters,
                    levels, iterate=lk_iter_level, preps=preps,
                    start=pts[None] + seed)


def _chained_dispatch(prev_pyr, next_pyrs, skips, pts_dev, opts: LKOptions,
                      levels: int, devices):
    """Queue the skip fan as chained phases, with no host sync: K2 once per
    level, then per phase K3 once per level, each phase consuming the
    earlier phases' results where they lie.  The features split into one
    contiguous shard per device (one shard on one device), and each shard
    seeds from its own shard of the earlier phases
    (``parallel.analyze.sharded_lk_chain_*``).  Returns ``(next (T, N, 2),
    status, err)`` on the first device, in the caller's target order."""
    from ..parallel import analyze

    plan = _chain_plan(skips)
    eps = min(max(opts.term_epsilon, 0.0), 10.0)
    shards = analyze.sharded_lk_chain_prep(
        devices, prev_pyr.levels[:levels], pts_dev, win=opts.window_size,
        min_eig_thr=float(opts.min_eigen_threshold), levels=levels)
    outs = []  # per phase, per shard: (next, status, err)
    for slots in plan:
        pyrs = [prev_pyr if i is None else next_pyrs[i] for i, _, _ in slots]
        stacked = [torch.stack([p.levels[lvl][0] for p in pyrs])
                   for lvl in range(levels)]
        src_nxt, src_status = [], []
        for s, sh in enumerate(shards):
            none = torch.zeros(sh.pts.shape[0], dtype=torch.bool,
                               device=sh.pts.device)
            src_nxt.append(torch.stack([
                sh.pts if src is None else outs[src[0]][s][0][src[1]]
                for _, src, _ in slots]))
            src_status.append(torch.stack([
                none if src is None else outs[src[0]][s][1][src[1]]
                for _, src, _ in slots]))
        scales = torch.tensor([sc for _, _, sc in slots], dtype=torch.float32)
        outs.append(analyze.sharded_lk_chain_phase(
            shards, stacked, src_nxt, src_status, scales,
            win=opts.window_size, max_iters=opts.term_max_iters,
            eps2=float(eps * eps), levels=levels))
    slot_of = {i: (p, c) for p, slots in enumerate(plan)
               for c, (i, _, _) in enumerate(slots) if i is not None}

    def target(k, t):
        """Output k of target t, its shards gathered on the first device."""
        p, c = slot_of[t]
        return torch.cat([o[k][c].to(devices[0], non_blocking=True)
                          for o in outs[p]])

    return tuple(torch.stack([target(k, t) for t in range(len(next_pyrs))])
                 for k in range(3))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

GROUP_SORT_MIN = 128  # below this many features the order cannot matter
# Features from which a solve given several devices splits its features
# over them, not its (at most 8) targets: the JAX package's default
# (``_feat_shard_min``, polychase_tpu/engine/lk.py:858-862), not yet
# measured on the card.
FEAT_SHARD_MIN = 32768


def split_route(n: int, T: int, n_devices: int) -> str:
    """How a solve of ``n`` features into ``T`` targets splits over
    ``n_devices``: ``"features"``, ``"targets"``, or ``""`` for the
    unsharded solve on the first device."""
    if n_devices < 2:
        return ""
    if n >= FEAT_SHARD_MIN:
        return "features"
    return "targets" if T >= 2 else ""


def _spatial_sort(pts: np.ndarray):
    """Row-major (y, x) order of the features, and its inverse.

    Per-feature solves are independent, so the order carries no semantics.
    Sorted, the neighbours of a warp sample neighbouring windows (cache
    reuse) and tend to converge together.  Keypoints arrive
    quality-sorted, scattered across the image.
    """
    n = pts.shape[0]
    if n <= GROUP_SORT_MIN:
        return pts, None
    # One packed-key argsort == np.lexsort((x, y)): the IEEE bits of a float
    # order like the float once sign-magnitude is mapped to biased-unsigned
    # (-0.0 collapsed to +0.0 first).
    b = np.ascontiguousarray(pts, np.float32).view(np.uint32)
    b = np.where(b == np.uint32(0x80000000), np.uint32(0), b)
    b = np.where(b & 0x80000000, ~b, b | np.uint32(0x80000000))
    key = (b[:, 1].astype(np.uint64) << np.uint64(32)) | b[:, 0]
    order = np.argsort(key, kind="stable")
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    return pts[order], inv


class FlowHandle(NamedTuple):
    """An in-flight multi-target solve (see
    :func:`calc_optical_flow_multi_async`)."""

    T: int
    copy: object          # HostCopy of (next, status, err); None if empty


def calc_optical_flow_multi_async(
    prev_pyr: PyramidCache,
    next_pyrs: List[PyramidCache],
    prev_pts: np.ndarray,
    opts: LKOptions = LKOptions(),
    skips=None,
    *,
    devices=None,
) -> FlowHandle:
    """Queue a multi-target solve on the pyramids' device; nothing blocks.

    ``devices`` (a list whose first is the pyramids' device; default that
    device alone) splits the solve over several devices by
    :func:`split_route`; the spatial sort wraps the whole solve.  ``skips``
    (frame offsets aligned with ``next_pyrs``) chains the fan where
    :func:`chain_engages`.  The results travel from the first device to
    pinned host buffers behind one event, which
    :func:`calc_optical_flow_multi_finish` waits on."""
    pts = np.ascontiguousarray(prev_pts, np.float32).reshape(-1, 2)
    n, T = pts.shape[0], len(next_pyrs)
    dev = prev_pyr.device
    devices = [dev] if devices is None else resolve_devices(devices)
    if devices[0] != dev:
        raise ValueError(f"the pyramids are on {dev}, the first device is "
                         f"{devices[0]}")
    if n == 0 or T == 0:
        return FlowHandle(T, None)
    levels = min([prev_pyr.num_levels] + [p.num_levels for p in next_pyrs])
    pts, inv = _spatial_sort(pts)
    pts_dev = torch.from_numpy(np.ascontiguousarray(pts)).to(
        dev, non_blocking=True)
    if (skips is not None and len(skips) == T
            and chain_engages(skips, n, len(devices))):
        nxt, status, err = _chained_dispatch(prev_pyr, next_pyrs, list(skips),
                                             pts_dev, opts, levels, devices)
    else:
        stacked = [torch.stack([p.levels[lvl][0] for p in next_pyrs])
                   for lvl in range(levels)]
        eps = min(max(opts.term_epsilon, 0.0), 10.0)
        solve = _lk_all_levels_multi
        route = split_route(n, T, len(devices))
        if route:
            from ..parallel import analyze

            solve = functools.partial(
                analyze.sharded_lk_multi_feat if route == "features"
                else analyze.sharded_lk_multi, devices)
        nxt, status, err = solve(
            prev_pyr.levels[:levels], stacked, pts_dev, float(eps * eps),
            float(opts.min_eigen_threshold), win=opts.window_size,
            max_iters=opts.term_max_iters, levels=levels,
        )
    if inv is not None:
        # Back to the caller's order on the device, before the copy.
        inv = torch.from_numpy(inv).to(dev, non_blocking=True)
        nxt, status, err = nxt[:, inv], status[:, inv], err[:, inv]
    return FlowHandle(T, HostCopy(nxt, status, err))


def calc_optical_flow_multi_finish(handle: FlowHandle):
    """Wait for a :func:`calc_optical_flow_multi_async` handle; returns
    ``(next_pts (T, N, 2), status (T, N) bool, err (T, N))`` as numpy."""
    if handle.copy is None:
        return (
            np.empty((handle.T, 0, 2), np.float32),
            np.empty((handle.T, 0), bool),
            np.empty((handle.T, 0), np.float32),
        )
    return handle.copy.numpy()


def calc_optical_flow_multi(prev_pyr, next_pyrs, prev_pts,
                            opts: LKOptions = LKOptions(), *, devices=None):
    """Track ``prev_pts`` into several target frames in one solve."""
    return calc_optical_flow_multi_finish(
        calc_optical_flow_multi_async(prev_pyr, next_pyrs, prev_pts, opts,
                                      devices=devices)
    )


def calc_optical_flow(prev_pyr, next_pyr, prev_pts,
                      opts: LKOptions = LKOptions(), *, devices=None):
    """Track ``prev_pts`` (N, 2) from prev to next frame (``devices`` as
    for :func:`calc_optical_flow_multi_async`).

    Returns ``(next_pts (N, 2) f32, status (N,) bool, err (N,) f32)`` with
    cv::calcOpticalFlowPyrLK conventions."""
    nxt, status, err = calc_optical_flow_multi(
        prev_pyr, [next_pyr], prev_pts, opts, devices=devices)
    return nxt[0], status[0], err[0]
