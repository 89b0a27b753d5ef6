"""K1: the whole-solve LM PnP kernel (``csrc/pnp_lm.cu``) and its wrapper.

Replaces the TPU kernel ``polychase_tpu/kernels/pnp_pallas.py::_make_kernel``.
The kernel runs one whole PnP solve per thread block cluster: residuals,
Jacobians, IRLS normal equations, the damped equilibrated Cholesky solve,
the Nielsen schedule and every exit, with the batch of solves as the grid.

On the card it is bound by latency: a solve is a chain of LM iterations, and
the main path waits on one solve at a time.  So a solve is spread over a
cluster of up to 16 blocks (:func:`launch_shape`), each block keeps its
slice of the points in shared memory for the whole solve (a slice above
``STAGE_MAX`` points is streamed from L2 instead), and each LM iteration is
one pass over the points at the trial state with one reduction round across
the cluster.  Solves of at most ``WARP_MAX`` points (pin drags) run in one
warp whose reductions are shuffles alone.

The device of the tensors chooses the arm: CPU tensors go to the plain torch
version (``engine.pnp.solve_arrays``), CUDA tensors launch the kernel on
their own card, whatever the current device, and any failure to build or
launch it raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..backend import current
from ..engine import pnp
from ..engine.levmarq import BundleOptions
from . import build

# Kernel launches made by this module in this process.
launches = 0

# Limits of csrc/pnp_lm.cu: the points a block stages in shared memory
# (kStageMax) and the cluster sizes it takes (powers of two up to 16; above
# 8 the card's non-portable sizes).
STAGE_MAX = 8192
MAX_CLUSTER = 16
# Solves of at most this many points run in one block of one warp (on the
# H100 one warp beat one block of 256 threads at 16 and 32 points, lost at
# 64: chip_smoke.py's launch-shape sweep, PERF.md).
WARP_MAX = 32
# Points each block of a cluster takes, about: the cluster is the smallest
# power of two whose blocks hold N at this many each.  On the H100 a lone
# solve was never slower on more blocks down to 256 points a block
# (chip_smoke.py's launch-shape sweep, PERF.md).
BLOCK_POINTS = 256
# A batch of S solves keeps S × cluster within the H100's 132 SMs.
SMS = 132
BLOCK_THREADS, WARP_THREADS = 256, 32

_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_float] * 11
    + [ctypes.c_void_p]
)
# Focal bounds of camera.intrinsics_bounds, as the TPU kernel folds them:
# f in [half_w / tan(80°), half_w / tan(7.5°)] for the OpenCV convention.
_F_LOW_SCALE = float(np.float32(1.0 / math.tan(math.radians(160.0) / 2.0)))
_F_HIGH_SCALE = float(np.float32(1.0 / math.tan(math.radians(15.0) / 2.0)))


class LaunchShape(NamedTuple):
    """How one solve is laid out: ``cluster`` blocks of ``threads``
    threads; block r owns points [r·per_block, min(N, (r+1)·per_block)),
    held in shared memory when ``staged``."""

    cluster: int
    threads: int
    per_block: int
    staged: bool


def launch_shape(S: int, N: int, *,
                 max_cluster: int = MAX_CLUSTER) -> LaunchShape:
    """The launch shape of S solves of N points each, on clusters of at
    most ``max_cluster`` blocks."""
    if N <= WARP_MAX:
        return LaunchShape(1, WARP_THREADS, N, True)
    limit = min(max_cluster, max(1, SMS // max(S, 1)))
    want = -(-N // BLOCK_POINTS)
    cluster = 1
    while cluster < want and cluster * 2 <= limit:
        cluster *= 2
    per_block = -(-N // cluster)
    return LaunchShape(cluster, BLOCK_THREADS, per_block,
                       per_block <= STAGE_MAX)


def load(csrc=build.CSRC):
    """Build (at first use) and load the kernel library (from another copy
    of the source with ``csrc``, as ``k1_stamps`` does)."""
    lib = build.load("pnp_lm.cu", csrc)
    fn = lib.lib.pnp_lm_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    cap = lib.lib.pnp_lm_max_cluster
    cap.argtypes = [ctypes.c_int] * 5
    cap.restype = ctypes.c_int
    return lib


_fits: dict = {}


def cluster_fits(n_params: int, loss: int, shape: LaunchShape) -> int:
    """The largest cluster size up to ``shape.cluster`` that the current
    card can schedule for blocks of this shape (cached per card)."""
    key = (torch.cuda.current_device(), n_params, loss, shape)
    if key not in _fits:
        fits = load().lib.pnp_lm_max_cluster(
            n_params, loss, shape.cluster, shape.per_block, int(shape.staged))
        if fits < 1:
            raise RuntimeError("pnp_lm: cluster occupancy query failed")
        _fits[key] = fits
    return _fits[key]


def fitted_shape(S: int, N: int, n_params: int, loss: int) -> LaunchShape:
    """The launch shape K1 takes on the current card: :func:`launch_shape`'s,
    with the cluster cut to what the card can schedule for the block's
    shared memory."""
    cap = MAX_CLUSTER
    while True:
        shape = launch_shape(S, N, max_cluster=cap)
        if shape.cluster == 1:
            return shape
        fits = cluster_fits(n_params, loss, shape)
        if fits >= shape.cluster:
            return shape
        cap = fits


def _check(X, x, weights, mask, params, opts):
    dev = X.device
    if X.dim() != 3 or X.shape[-1] != 3:
        raise ValueError(f"X must be (S, N, 3), got {tuple(X.shape)}")
    S, N = X.shape[:2]
    for name, t, shape, dtype in (
        ("X", X, (S, N, 3), torch.float32),
        ("x", x, (S, N, 2), torch.float32),
        ("weights", weights, (S, N), torch.float32),
        ("mask", mask, (S, N), torch.bool),
        ("params", params, (S, pnp.PARAMS_LEN), None),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, X on {dev}")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if dtype is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if int(opts.loss_type) not in (0, 1, 2):
        raise ValueError(f"unknown loss type {opts.loss_type}")
    return S, N


def launch(X, x, weights, mask, params, *, opt_f: bool, opt_pp: bool,
           opts: BundleOptions, shape: LaunchShape | None = None
           ) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors.  ``shape`` defaults to
    :func:`launch_shape`'s, cut to what the card can schedule.
    :func:`solve_arrays_lm` is the entry point; this one lets a measurement
    choose the shape."""
    global launches
    if X.device.type != "cuda":
        raise ValueError(f"pnp_lm: the kernel runs on CUDA, not {X.device}")
    S, N = _check(X, x, weights, mask, params, opts)
    n_params = 9 if (opt_f or opt_pp) else 6
    params = params.to(torch.float32).contiguous()
    out = torch.empty((S, pnp.RESULT_LEN), dtype=torch.float32,
                      device=X.device)
    scale = float(opts.loss_scale)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    # The kernel launches on the current device, which also owns the
    # function attributes it sets and the occupancy it is sized by.
    with current(X.device):
        if shape is None:
            shape = fitted_shape(S, N, n_params, int(opts.loss_type))
        rc = load().lib.pnp_lm_launch(
            params.data_ptr(), X.data_ptr(), x.data_ptr(), weights.data_ptr(),
            mask.data_ptr(), out.data_ptr(), S, N, shape.cluster,
            shape.threads, shape.per_block, int(shape.staged), n_params,
            int(opts.loss_type), int(bool(opt_f)), int(bool(opt_pp)),
            int(opts.max_iterations), scale, scale * scale,
            1.0 / (scale * scale), float(opts.gradient_tol),
            float(opts.step_tol), float(opts.initial_lambda),
            float(opts.min_lambda), float(opts.max_lambda),
            float(opts.function_tol), _F_LOW_SCALE, _F_HIGH_SCALE, stream,
        )
    if rc != 0:
        raise RuntimeError(f"pnp_lm kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def solve_arrays_lm(X, x, weights, mask, params, *, opt_f: bool,
                    opt_pp: bool, opts: BundleOptions) -> torch.Tensor:
    """Batched PnP, same contract as ``engine.pnp.solve_arrays``:
    ``X`` (S, N, 3) f32, ``x`` (S, N, 2) f32, ``weights`` (S, N) f32,
    ``mask`` (S, N) bool, ``params`` (S, 16) → (S, 19).  On a CUDA device
    the point tensors are read where they lie and must be contiguous."""
    dev = X.device
    if dev.type == "cpu":
        return pnp.solve_arrays(
            X, x, weights, mask, params, opt_f=opt_f, opt_pp=opt_pp, opts=opts
        )
    if dev.type != "cuda":
        raise ValueError(f"pnp_lm: unsupported device {dev}")
    return launch(X, x, weights, mask, params, opt_f=opt_f, opt_pp=opt_pp,
                  opts=opts)
