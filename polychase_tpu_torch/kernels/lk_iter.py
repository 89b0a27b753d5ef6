"""K3: the LK iteration kernel (``csrc/lk_iter.cu``) and its wrapper.

Replaces the TPU kernel ``polychase_tpu/kernels/lk_pallas.py
::_make_iter_kernel``.  A block stages the templates of its features (K2's
feature-major patches) in shared memory once, for all T targets and every
iteration: 32 pairs a block, fewer where a large window would not fit
(above 120 none fits, and the wrapper raises).  A group of 16 lanes solves
one (target, feature) pair at a time, taking the block's next pair when it
is done: it stages the target window under the moving point in shared
memory, samples it with the lanes across the window's pixels, reduces b by
shuffles, solves the 2×2 system, steps, and stops on its own (convergence,
oscillation, leaving the image); at level 0 it writes status and err.  The
kernel is compiled with the main path's window (10) fixed, and with the
window as a runtime value for others.  The plain torch version is
``engine.lk.iter_level``.

CPU tensors take the plain version; CUDA tensors launch the kernel on their
own card, whatever the current device, and any failure to build or launch
it raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..backend import current
from ..engine import lk
from . import build
from .lk_prep import check_level

# Kernel launches made by lk_iter_level in this process.
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def load():
    """Build (at first use) and load the kernel library."""
    lib = build.load("lk_iter.cu")
    fn = lib.lib.lk_iter_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def lk_iter_level(imgs_pad, patches, a11, a12, a22, invd, ok, pts, *,
                  win: int, H: int, W: int, max_iters: int, eps2: float,
                  level_is_zero: bool):
    """Same contract as ``engine.lk.iter_level``: ``imgs_pad`` (T, H +
    2(win+2), W + 2(win+2)), the prep of K2 (patches (N, 3, win, win),
    vectors (N)), ``pts`` (T, N, 2) → ``(pts (T, N, 2), status (T, N) bool,
    err (T, N))``."""
    global launches
    dev = pts.device
    if dev.type == "cpu":
        return lk.iter_level(
            imgs_pad, patches, a11, a12, a22, invd, ok, pts,
            win=win, H=H, W=W, max_iters=max_iters, eps2=eps2,
            level_is_zero=level_is_zero,
        )
    if dev.type != "cuda":
        raise ValueError(f"lk_iter: unsupported device {dev}")
    if pts.dim() != 3 or pts.shape[2] != 2:
        raise ValueError(f"pts must be (T, N, 2), got {tuple(pts.shape)}")
    T, n = int(pts.shape[0]), int(pts.shape[1])
    if T * n >= 1 << 31:
        raise ValueError(f"{T} x {n} pairs exceed the kernel's int indices")
    pad = win + 2
    check_level("pts", pts, dev, (T, n, 2))
    check_level("imgs_pad", imgs_pad, dev, (T, H + 2 * pad, W + 2 * pad))
    check_level("patches", patches, dev, (n, 3, win, win))
    for name, t in (("a11", a11), ("a12", a12), ("a22", a22),
                    ("invd", invd)):
        check_level(name, t, dev, (n,))
    if ok.device != dev or tuple(ok.shape) != (n,) or ok.dtype != torch.bool:
        raise ValueError(f"ok must be ({n},) bool on {dev}")
    ok = ok.contiguous()
    out = torch.empty((T, n, 2), dtype=torch.float32, device=dev)
    status = torch.empty((T, n), dtype=torch.bool, device=dev)
    err = torch.empty((T, n), dtype=torch.float32, device=dev)
    if T * n:
        fn = load().lib.lk_iter_launch
        # The kernel launches on, and sizes its shared memory for, the
        # current device.
        with current(dev):
            rc = fn(imgs_pad.data_ptr(), patches.data_ptr(), a11.data_ptr(),
                    a12.data_ptr(), a22.data_ptr(), invd.data_ptr(),
                    ok.data_ptr(), pts.data_ptr(), out.data_ptr(),
                    status.data_ptr(), err.data_ptr(), T, n, H + 2 * pad,
                    W + 2 * pad, H, W, win, int(max_iters), float(eps2),
                    int(bool(level_is_zero)),
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"lk_iter kernel launch failed: CUDA error {rc}")
        launches += 1
    return out, status, err
