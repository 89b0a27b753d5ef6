"""K2: the LK source-frame prep kernel (``csrc/lk_prep.cu``) and its wrapper.

Replaces the TPU kernel ``polychase_tpu/kernels/lk_pallas.py
::_make_extract_kernel`` and the XLA tail of ``lk_prepare_level``: a group
of 16 lanes per feature, spread over the rows of its window, blends the
padded image, dx and dy to win×win patches written feature-major (one
feature's (3, win, win) values contiguous, the copy K3 stages), and builds
the normal matrix by shuffle reductions, its gate, invD and ok.  The source pyramid is shared by every target, so K2 runs once per
level per source frame.  The plain torch version is
``engine.lk.prep_level``.

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

# Kernel launches made by lk_prep_level in this process.
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]


def load():
    """Build (at first use) and load the kernel library."""
    lib = build.load("lk_prep.cu")
    fn = lib.lib.lk_prep_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def check_level(name: str, t: torch.Tensor, dev, shape) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``dev`` (shared with K3's wrapper)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the points on {dev}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32")


def lk_prep_level(img_pad, dx_pad, dy_pad, pts, *, win: int, H: int, W: int,
                  min_eig_thr: float):
    """Same contract as ``engine.lk.prep_level``: ``img_pad``, ``dx_pad``,
    ``dy_pad`` (H + 2(win+2), W + 2(win+2)), ``pts`` (N, 2) at the level's
    scale → ``(patches (N, 3, win, win), a11, a12, a22, invd (N),
    ok (N) bool)``."""
    global launches
    dev = pts.device
    if dev.type == "cpu":
        return lk.prep_level(img_pad, dx_pad, dy_pad, pts, win=win, H=H, W=W,
                             min_eig_thr=min_eig_thr)
    if dev.type != "cuda":
        raise ValueError(f"lk_prep: unsupported device {dev}")
    if pts.dim() != 2 or pts.shape[1] != 2:
        raise ValueError(f"pts must be (N, 2), got {tuple(pts.shape)}")
    n = int(pts.shape[0])
    pad = win + 2
    hp, wp = H + 2 * pad, W + 2 * pad
    check_level("pts", pts, dev, (n, 2))
    for name, t in (("img_pad", img_pad), ("dx_pad", dx_pad),
                    ("dy_pad", dy_pad)):
        check_level(name, t, dev, (hp, wp))
    patches = torch.empty((n, 3, win, win), dtype=torch.float32, device=dev)
    vec = torch.empty((4, n), dtype=torch.float32, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        fn = load().lib.lk_prep_launch
        with current(dev):  # the kernel launches on the current device
            rc = fn(img_pad.data_ptr(), dx_pad.data_ptr(), dy_pad.data_ptr(),
                    pts.data_ptr(), patches.data_ptr(), vec.data_ptr(),
                    ok.data_ptr(), n, hp, wp, H, W, win, float(min_eig_thr),
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"lk_prep kernel launch failed: CUDA error {rc}")
        launches += 1
    return patches, vec[0], vec[1], vec[2], vec[3], ok
