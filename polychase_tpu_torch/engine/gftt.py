"""Good-features-to-track corner detection.

Port of ``polychase_tpu/engine/gftt.py``, itself a rebuild of the
reference's GFTT (cpp/feature_detection/gftt.{h,cc}).  The dense part runs
in plain torch on the device: the Shi-Tomasi or Harris response (Sobel with
reflect-101 borders, unnormalized box filter, OpenCV's 8-bit scaling), the
per-grid-block threshold-to-zero, the 3×3 dilation NMS away from the 1-px
border.  The tail, the quality sort (ties: later row-major position first)
and the greedy min-distance suppression, takes one of two routes that give
the same corners in the same order:

- host route: a top-k of the candidates on a 2×2 block max crosses to the
  host, where the native ``gftt_sort_suppress`` of the port's ``native``
  (numpy where it is missing) sorts and suppresses;
- device route (:func:`device_suppress_route`, frames of
  ``DEVICE_SUPPRESS_MIN`` pixels and more): the suppression runs on the
  device as the reference's exact fixed point (``_suppress_device``), on a
  card in the kernel K4 (``kernels/gftt_suppress.py``), which also
  compacts the kept points, and only those cross, to be put in quality
  order.  Where the fixed point has
  points undecided after ``MAX_ROUNDS`` rounds, :func:`gftt_finish` runs
  more rounds on the device from where they stopped (the JAX package
  redoes such a frame on the host); ``resumed_frames`` counts those frames.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..backend import HostCopy, as_device


class GFTTOptions(NamedTuple):
    """Detector options (cpp/feature_detection/gftt.h:5-21)."""

    quality_level: float = 0.01
    min_distance: float = 5.0
    block_size: int = 3
    gradient_size: int = 3
    max_corners: int = 0
    use_harris: bool = False
    harris_k: float = 0.04
    grid_rows: int = 4
    grid_cols: int = 4


# Overflowed ``count`` that signals a tie inside a 2×2 block.
_COLLISION_COUNT = 2 ** 30

# Frames of at least this many pixels take the device suppression route.
# The port's own threshold, not the JAX package's TPU one (2,000,000):
# in chip_smoke.py's routes phase on an H100 80GB HBM3 at 700 W (PERF.md)
# the device route, K4 in one launch, won both turns at every size from
# 320×240 in every run; at 160×120 and 80×60 the two routes lay within
# 0.7 ms of each other and the host route won a turn at 160×120.
DEVICE_SUPPRESS_MIN = 76_800
# Rounds of the suppression fixed point queued at a time.
MAX_ROUNDS = 128
# Frames of the device route whose fixed point outlasted MAX_ROUNDS rounds
# and was finished by more rounds queued in gftt_finish, in this process.
resumed_frames = 0


def _check_options(options: GFTTOptions) -> None:
    if not (
        options.quality_level > 0
        and options.min_distance >= 0
        and options.max_corners >= 0
    ):
        raise ValueError("invalid GFTT options")
    if int(options.gradient_size) not in (1, 3, 5, 7):
        raise ValueError("gradient_size must be 1, 3, 5 or 7")


def _sep_filter(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable 2D correlation with BORDER_REFLECT_101: shifted slices
    summed in tap order, columns then rows."""
    rx, ry = len(kx) // 2, len(ky) // 2
    H, W = img.shape
    p = F.pad(img[None], (rx, rx, ry, ry), mode="reflect")[0]
    acc = torch.zeros((H + 2 * ry, W), dtype=img.dtype, device=img.device)
    for i, k in enumerate(kx):
        acc = acc + float(k) * p[:, i:i + W]
    out = torch.zeros((H, W), dtype=img.dtype, device=img.device)
    for j, k in enumerate(ky):
        out = out + float(k) * acc[j:j + H]
    return out


def _sobel_kernels(ksize: int) -> Tuple[np.ndarray, np.ndarray]:
    """1st-derivative and smoothing taps of OpenCV's ``getDerivKernels``
    (unnormalized); ksize 1 smooths with the identity."""
    taps = {
        1: ([-1.0, 0.0, 1.0], [1.0]),
        3: ([-1.0, 0.0, 1.0], [1.0, 2.0, 1.0]),
        5: ([-1.0, -2.0, 0.0, 2.0, 1.0], [1.0, 4.0, 6.0, 4.0, 1.0]),
        7: (
            [-1.0, -4.0, -5.0, 0.0, 5.0, 4.0, 1.0],
            [1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0],
        ),
    }
    if ksize not in taps:
        raise ValueError(
            "gradient_size must be 1, 3, 5 or 7 (OpenCV getDerivKernels)"
        )
    deriv, smooth = taps[ksize]
    return np.array(deriv), np.array(smooth)


def _corner_response(image: torch.Tensor, block_size: int, ksize: int,
                     use_harris: bool, harris_k: float,
                     is_8u: bool) -> torch.Tensor:
    """Shi-Tomasi min-eigenvalue or Harris response map, scaled as OpenCV's
    ``cornerEigenValsVecs``."""
    deriv, smooth = _sobel_kernels(ksize)
    scale = (1 << (ksize - 1)) * block_size
    if is_8u:
        scale *= 255.0
    inv = 1.0 / scale
    dx = _sep_filter(image, deriv * inv, smooth)
    dy = _sep_filter(image, smooth, deriv * inv)
    ones = np.ones(block_size)
    a = _sep_filter(dx * dx, ones, ones)
    b = _sep_filter(dx * dy, ones, ones)
    c = _sep_filter(dy * dy, ones, ones)
    if use_harris:
        k = float(np.float32(harris_k))
        return a * c - b * b - k * (a + c) * (a + c)
    ha, hc = 0.5 * a, 0.5 * c
    return (ha + hc) - torch.sqrt((ha - hc) * (ha - hc) + b * b)


def _grid_threshold(eig: torch.Tensor, mask: Optional[torch.Tensor],
                    grid_rows: int, grid_cols: int,
                    quality_level: float) -> torch.Tensor:
    """Per-block threshold-to-zero at block_max · quality
    (cpp/feature_detection/gftt.cc:38-67)."""
    H, W = eig.shape
    bh = -(-H // grid_rows)
    bw = -(-W // grid_cols)
    ph, pw = grid_rows * bh - H, grid_cols * bw - W
    considered = torch.isfinite(eig)
    if mask is not None:
        considered = considered & mask
    eig_p = F.pad(eig, (0, pw, 0, ph))
    con_p = F.pad(considered, (0, pw, 0, ph))
    blocks = torch.where(con_p, eig_p, float("-inf")).reshape(
        grid_rows, bh, grid_cols, bw)
    bmax = torch.amax(blocks, dim=(1, 3))
    bmax = torch.where(torch.isfinite(bmax), bmax, 0.0)
    q = float(np.float32(quality_level))
    thr = (bmax * q).repeat_interleave(bh, 0).repeat_interleave(bw, 1)
    return torch.where(eig_p > thr, eig_p, 0.0)[:H, :W]


def _dilate3x3(x: torch.Tensor) -> torch.Tensor:
    """3×3 max filter with -inf border (cv::dilate default)."""
    H, W = x.shape
    p = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    out = x
    for dy in range(3):
        for dx in range(3):
            if dy != 1 or dx != 1:
                out = torch.maximum(out, p[dy:dy + H, dx:dx + W])
    return out


def _response_kw(options: GFTTOptions, is_8u: bool) -> dict:
    return dict(
        block_size=int(options.block_size),
        ksize=int(options.gradient_size),
        use_harris=bool(options.use_harris),
        grid_rows=max(1, int(options.grid_rows)),
        grid_cols=max(1, int(options.grid_cols)),
        is_8u=is_8u,
    )


def gftt_response(image: torch.Tensor, mask: Optional[torch.Tensor],
                  quality_level: float, harris_k: float, *,
                  block_size: int = 3, ksize: int = 3,
                  use_harris: bool = False, grid_rows: int = 4,
                  grid_cols: int = 4, is_8u: bool = True):
    """Dense half of GFTT: response → grid threshold → NMS.

    ``image`` is float32 (H, W), ``mask`` a bool (H, W) tensor or None.
    Returns ``(eig, candidates)``: the thresholded response and the bool map
    of strict 3×3 maxima inside the 1-px border and the mask."""
    eig = _corner_response(image, block_size, ksize, use_harris, harris_k,
                           is_8u)
    eig = _grid_threshold(eig, mask, grid_rows, grid_cols, quality_level)
    dil = _dilate3x3(eig)
    H, W = eig.shape
    interior = torch.zeros((H, W), dtype=torch.bool, device=eig.device)
    interior[1:H - 1, 1:W - 1] = True
    cand = (eig != 0.0) & (eig == dil) & interior
    if mask is not None:
        cand = cand & mask
    return eig, cand


def _candidates_reduced(image, mask, quality_level, harris_k, **kw):
    """Candidate compaction: response → NMS → 2×2 block max.

    NMS keeps only pixels equal to their 3×3 dilation, so two candidates in
    one 2×2 block can only be an exact tie on adjacent pixels; that case
    sets ``count`` to an overflow sentinel so the finish takes the exact
    full-map path.  Returns ``(block values, block linear indices, count)``
    (pixel 0 is border-excluded, so index 0 never marks a candidate)."""
    eig, cand = gftt_response(image, mask, quality_level, harris_k, **kw)
    H, W = eig.shape
    q = torch.where(cand, eig, 0.0)
    lin = torch.arange(H * W, device=eig.device).reshape(H, W)
    ph, pw = H % 2, W % 2
    q = F.pad(q, (0, pw, 0, ph))
    lin = F.pad(lin, (0, pw, 0, ph))
    cand_p = F.pad(cand, (0, pw, 0, ph))
    Hb, Wb = q.shape[0] // 2, q.shape[1] // 2
    bvals = torch.amax(q.reshape(Hb, 2, Wb, 2), dim=(1, 3)).reshape(-1)
    blin = torch.amax(
        torch.where(cand_p, lin, 0).reshape(Hb, 2, Wb, 2), dim=(1, 3)
    ).reshape(-1)
    bcount = cand_p.reshape(Hb, 2, Wb, 2).sum(dim=(1, 3))
    count = torch.where(torch.any(bcount > 1),
                        torch.full((), _COLLISION_COUNT, device=eig.device),
                        cand.sum())
    return bvals, blin, count


def gftt_candidates_topk(image, mask, quality_level, harris_k, *, k: int,
                         **kw):
    """Device-compacted candidates: the top ``k`` (value, linear index) of
    the 2×2 block maxima, and the candidate count (the finish falls back to
    the full map when ``count`` exceeds the k kept)."""
    bvals, blin, count = _candidates_reduced(image, mask, quality_level,
                                             harris_k, **kw)
    vals, bidx = torch.topk(bvals, min(k, bvals.shape[0]))
    return vals, blin[bidx], count


def _circle_offsets(min_distance: float) -> Tuple[Tuple[int, int], ...]:
    """Integer pixel offsets (dy, dx) with dx² + dy² < d² (strict, as the
    reference's distance test, cpp/feature_detection/gftt.cc:139-148)."""
    r = int(np.ceil(min_distance)) - 1
    return tuple((dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)
                 if dx * dx + dy * dy < min_distance * min_distance)


def suppress_plain(qmap: torch.Tensor, offsets, max_rounds: int = MAX_ROUNDS,
                   state: Optional[torch.Tensor] = None):
    """Exact greedy min-distance suppression as a fixed point (plain version
    of K4; the reference's ``_suppress_device``).

    ``qmap`` (H, W) float32 holds the candidates' qualities, 0 elsewhere.
    Each round first rejects every undecided point within the disc
    ``offsets`` of a kept point, then keeps every undecided point whose key
    (float bits of its quality << 32 | its row-major index, so the later
    index wins a tie) beats every undecided neighbour's.  Returns ``(kept
    (H, W) bool, converged () bool, rounds () int32, state (H, W) uint8)``;
    ``converged`` is False where points are still undecided after
    ``max_rounds`` rounds, and ``state`` (1 undecided, 2 or more kept)
    passed back in goes on from there: the kept map does not depend on
    where the rounds were cut.
    """
    H, W = qmap.shape
    dev = qmap.device
    nbrs = [o for o in offsets if o != (0, 0)]
    r = max([max(abs(dy), abs(dx)) for dy, dx in nbrs] + [0])
    lin = torch.arange(H * W, dtype=torch.int64, device=dev).reshape(H, W)
    keys = (qmap.contiguous().view(torch.int32).to(torch.int64) << 32) | lin
    if state is None:
        und = qmap > 0.0
        kept = torch.zeros_like(und)
    else:
        und, kept = state == 1, state >= 2
    kp = torch.zeros((H + 2 * r, W + 2 * r), dtype=torch.bool, device=dev)
    kpad = torch.zeros((H + 2 * r, W + 2 * r), dtype=torch.int64, device=dev)

    def shifted(p, dy, dx):
        return p[r + dy:r + dy + H, r + dx:r + dx + W]

    rounds = 0
    while rounds < max_rounds and bool(und.any()):
        kp[r:r + H, r:r + W] = kept
        for dy, dx in nbrs:
            und = und & ~shifted(kp, dy, dx)
        key = torch.where(und, keys, 0)
        kpad[r:r + H, r:r + W] = key
        best = key
        for dy, dx in nbrs:
            best = torch.maximum(best, shifted(kpad, dy, dx))
        won = und & (key == best)
        kept = kept | won
        und = und & ~won
        rounds += 1
    state = kept.to(torch.uint8) * 2 + und.to(torch.uint8)
    return (kept, ~und.any(),
            torch.tensor(rounds, dtype=torch.int32, device=dev), state)


def device_suppress_route(num_pixels: int, options: GFTTOptions) -> bool:
    """Whether :func:`gftt_dispatch` suppresses on the device: from
    ``DEVICE_SUPPRESS_MIN`` pixels, for 1 ≤ min_distance ≤ 8 (the
    reference's guard: the disc has up to ~200 offsets at 8)."""
    return (1.0 <= options.min_distance <= 8.0
            and num_pixels >= DEVICE_SUPPRESS_MIN)


def _compact_kept(qmap, kept, k: int):
    """The kept points' qualities and row-major indices in row-major order,
    zero past ``count``, in buffers of ``k``: ``(vals (k,), idx (k,),
    count)`` (the plain version of K4's compaction)."""
    flat = kept.reshape(-1)
    pos = torch.cumsum(flat, 0) - 1
    count = pos[-1] + 1
    # Slot k takes the points that are not kept or do not fit.
    slot = torch.where(flat & (pos < k), pos, k)
    lin = torch.arange(flat.numel(), device=flat.device)
    idx = torch.zeros(k + 1, dtype=torch.int64, device=flat.device)
    idx.scatter_(0, slot, lin)
    idx = idx[:k]
    vals = torch.where(torch.arange(k, device=flat.device) < count,
                       qmap.reshape(-1)[idx], 0.0)
    return vals, idx, count


def gftt_suppressed_topk(image, mask, quality_level, harris_k, *, k: int,
                         offsets, **kw):
    """The whole GFTT tail on the device: response → NMS → min-distance
    suppression and the kept points' compaction (K4 on a card, one
    launch; the plain fixed point and :func:`_compact_kept` elsewhere).

    Returns ``(vals (k,), idx (k,), count, converged, qmap, state)``: the
    kept points' qualities and row-major indices in row-major order (the
    finish puts them in quality order, so the reference's top-k of the kept
    set is a compaction here), zero past ``count``; where ``converged`` is
    False the finish goes on from ``state`` on the quality map ``qmap``.
    ``k`` must hold every kept point (the hex-packing bound)."""
    from ..kernels.gftt_suppress import gftt_suppress_kept

    eig, cand = gftt_response(image, mask, quality_level, harris_k, **kw)
    qmap = torch.where(cand, eig, 0.0).contiguous()
    vals, idx, count, converged, _, state = gftt_suppress_kept(
        qmap, offsets, k, MAX_ROUNDS)
    return vals, idx, count, converged, qmap, state


class GFTTDispatch(NamedTuple):
    """In-flight detection for one frame."""

    copy: HostCopy        # (vals, idx, count[, converged]) to the host
    shape: Tuple[int, int]
    options: GFTTOptions
    # On the device, what the finish may need: (image, mask) on the host
    # route, to redo an overflowed top-k; (qmap, state, k) on the device
    # route, to go on with an unfinished fixed point.
    fallback: tuple
    suppressed: bool = False  # the device route: vals hold the kept set


def _as_mask(mask, device) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    if not isinstance(mask, torch.Tensor):
        mask = torch.from_numpy(np.ascontiguousarray(mask))
    mask = mask.to(device, non_blocking=True)
    return mask if mask.dtype == torch.bool else mask != 0


def kept_capacity(h: int, w: int, min_distance: float) -> int:
    """The device route's kept buffer for an h×w frame.  Kept points are
    pairwise >= min_distance apart, so the hex packing bound caps their
    count (Groemer's bound for a W×H rectangle, 2WH/(√3 d²) + (W + H)/d +
    1, lies below it; a 4K noise frame keeps ~170k at d = 5, the bound is
    ~390k)."""
    d = float(min_distance)
    pack = int((w / d + 2) * (h / d + 2) * 1.16)
    return min(max(32768, pack), h * w)


def gftt_dispatch(image, mask=None, options: GFTTOptions = GFTTOptions(),
                  k: int = 0, *, device) -> GFTTDispatch:
    """Start GFTT for a frame: the device work is queued, nothing blocks.

    ``image`` is a host array or a tensor (uint8 keeps OpenCV's 8-bit
    scaling); it is converted to float32 on ``device``.  The route is
    :func:`device_suppress_route`'s."""
    device = as_device(device)
    if isinstance(image, torch.Tensor):
        img = image.to(device, non_blocking=True)
    else:
        img = torch.from_numpy(np.ascontiguousarray(image)).to(
            device, non_blocking=True)
    if img.dim() != 2:
        raise ValueError("image must be 2D grayscale")
    _check_options(options)
    is_8u = img.dtype == torch.uint8
    imgf = img.to(torch.float32)
    maskt = _as_mask(mask, device)
    kw = _response_kw(options, is_8u)
    q, hk = float(options.quality_level), float(options.harris_k)
    if device_suppress_route(img.numel(), options):
        d = float(options.min_distance)
        k = kept_capacity(*img.shape, d)
        *out, qmap, state = gftt_suppressed_topk(
            imgf, maskt, q, hk, k=k, offsets=_circle_offsets(d), **kw)
        return GFTTDispatch(HostCopy(*out), tuple(img.shape), options,
                            (qmap, state, k), suppressed=True)
    if k <= 0:
        # NMS candidates are at most ~1 per 3x3 neighbourhood; budget 1/16
        # of the pixels.
        k = max(32768, img.numel() // 16)
    k = min(k, img.numel())
    vals, idx, count = gftt_candidates_topk(imgf, maskt, q, hk, k=k, **kw)
    return GFTTDispatch(HostCopy(vals, idx, count), tuple(img.shape),
                        options, (img, maskt))


def _native_sort_suppress(vals, lin, w, h, min_distance, max_corners):
    """Fused C quality sort + greedy suppression; accepted candidate indices
    in acceptance order, or None when the native library is absent."""
    from .. import native

    fn = native.native_fn(
        "gftt_sort_suppress",
        ctypes.c_uint32,
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
            ctypes.c_int32, ctypes.c_void_p,
        ],
    )
    if fn is None:
        return None
    vals_f = np.ascontiguousarray(vals, np.float32)
    lin_i = np.ascontiguousarray(lin, np.int64)
    out = np.empty(len(vals_f), np.uint32)
    count = fn(
        vals_f.ctypes.data_as(ctypes.c_void_p),
        lin_i.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_uint32(len(vals_f)), ctypes.c_int32(int(w)),
        ctypes.c_int32(int(h)), ctypes.c_float(float(min_distance)),
        ctypes.c_int32(int(max_corners)),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out[:count]


def _sort_suppress_numpy(vals, lin, w, h, min_distance, max_corners):
    """The same as the native call in numpy and Python: quality descending,
    later row-major position first, then the greedy grid-cell pass
    (cpp/feature_detection/gftt.cc:100-164)."""
    order = np.lexsort((-lin, -vals))
    if min_distance < 1:
        return order[:max_corners] if max_corners > 0 else order
    cell = int(round(min_distance))
    gw, gh = (w + cell - 1) // cell, (h + cell - 1) // cell
    grid: list = [[] for _ in range(gw * gh)]
    md2 = min_distance * min_distance
    kept = []
    for i in order:
        x, y = int(lin[i] % w), int(lin[i] // w)
        xc, yc = x // cell, y // cell
        good = all(
            (x - mx) ** 2 + (y - my) ** 2 >= md2
            for yy in range(max(yc - 1, 0), min(yc + 1, gh - 1) + 1)
            for xx in range(max(xc - 1, 0), min(xc + 1, gw - 1) + 1)
            for mx, my in grid[yy * gw + xx]
        )
        if good:
            grid[yc * gw + xc].append((x, y))
            kept.append(i)
            if max_corners > 0 and len(kept) == max_corners:
                break
    return np.asarray(kept, np.int64)


def _finish_suppressed(d: GFTTDispatch):
    """Host half of the device route: the kept points in quality order (the
    greedy pass's acceptance order), cut at ``max_corners``.  A fixed point
    with points still undecided goes on, on the device, from its state."""
    global resumed_frames
    from ..kernels.gftt_suppress import gftt_suppress_kept
    from .. import native

    vals, idx, count, converged = d.copy.numpy()
    if not bool(converged):
        resumed_frames += 1
        qmap, state, k = d.fallback
        offsets = _circle_offsets(float(d.options.min_distance))
        done = False
        while not done:
            *kept, conv, _, state = gftt_suppress_kept(qmap, offsets, k,
                                                       MAX_ROUNDS, state)
            done = bool(conv)  # waits for this batch of rounds
        vals, idx, count = HostCopy(*kept).numpy()
    assert int(count) <= vals.shape[0], "more kept points than the bound"
    keep = vals > 0.0
    vals, lin = vals[keep], idx[keep].astype(np.int64)
    order = native.quality_order(vals, lin)
    if d.options.max_corners > 0:
        # Greedy with a cap is the unlimited greedy cut at the first
        # max_corners acceptances (the same visiting order).
        order = order[:int(d.options.max_corners)]
    W = d.shape[1]
    pts = np.stack([(lin[order] % W).astype(np.float32),
                    (lin[order] // W).astype(np.float32)], axis=-1)
    return pts.reshape(-1, 2), vals[order].astype(np.float32)


def gftt_finish(d: GFTTDispatch) -> Tuple[np.ndarray, np.ndarray]:
    """Blocking host half: sort + greedy min-distance suppression, or on
    the device route the order of the kept points.  Returns ``(corners
    (N, 2) f32, quality (N,) f32)``."""
    if d.suppressed:
        return _finish_suppressed(d)
    vals, idx, count = d.copy.numpy()
    H, W = d.shape
    if int(count) > vals.shape[0]:
        # Top-k overflow or a 2×2 tie: redo from the full map (exact).
        img, maskt = d.fallback
        eig, cand = gftt_response(
            img.to(torch.float32), maskt, float(d.options.quality_level),
            float(d.options.harris_k),
            **_response_kw(d.options, img.dtype == torch.uint8),
        )
        packed = torch.where(cand, eig, 0.0).cpu().numpy()
        ys, xs = np.nonzero(packed)
        vals = packed[ys, xs]
        lin = ys.astype(np.int64) * W + xs
    else:
        lin = idx.astype(np.int64)
    keep = vals > 0.0
    vals = np.ascontiguousarray(vals[keep], np.float32)
    lin = lin[keep]
    if vals.size == 0:
        return np.empty((0, 2), np.float32), np.empty((0,), np.float32)
    md, mc = float(d.options.min_distance), int(d.options.max_corners)
    acc = _native_sort_suppress(vals, lin, W, H, md, mc)
    if acc is None:
        acc = _sort_suppress_numpy(vals, lin, W, H, md, mc)
    pts = np.stack([(lin[acc] % W).astype(np.float32),
                    (lin[acc] // W).astype(np.float32)], axis=-1)
    return pts, vals[acc]


def good_features_to_track(image, mask=None,
                           options: GFTTOptions = GFTTOptions(), *,
                           device) -> Tuple[np.ndarray, np.ndarray]:
    """Detect corners.  Returns ``(corners (N, 2) float32, quality (N,))``.

    ``image`` is a (H, W) grayscale array; uint8 inputs reproduce OpenCV's
    8-bit response scaling (cpp/feature_detection/gftt.cc:14-192)."""
    img = image if isinstance(image, torch.Tensor) else np.asarray(image)
    if img.ndim != 2:
        raise ValueError("image must be 2D grayscale")
    _check_options(options)
    if img.shape[0] * img.shape[1] == 0:
        return np.empty((0, 2), np.float32), np.empty((0,), np.float32)
    return gftt_finish(gftt_dispatch(img, mask, options, device=device))
