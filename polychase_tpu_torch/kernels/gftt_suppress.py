"""K4: GFTT's min-distance suppression (``csrc/gftt_suppress.cu``) and its
wrapper.

A kernel of the port with no TPU counterpart: it replaces the XLA fixed
point ``polychase_tpu/engine/gftt.py::_suppress_device``.  One call queues
an init pass, then ``max_rounds`` rounds of a reject pass and a select
pass, one thread per pixel, each round run only while the previous one
left a point undecided (a flag on the card, never read by the host).  A
call given an earlier call's ``state`` skips the init pass and goes on
from there.  The plain torch version is ``engine.gftt.suppress_plain``.

CPU tensors take the plain version; CUDA tensors launch the kernel on their
own card, whatever the current device, and any failure to build or launch
it raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..backend import current
from ..engine import gftt
from . import build

# Calls of gftt_suppress that launched the kernel in this process (one per
# frame, more where a frame's fixed point outlasts max_rounds rounds).
launches = 0
# The CUDA launches those calls queued: an init pass, unless resumed, and
# two passes a round; the rounds after the fixed point return at once.
cuda_launches = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_offsets: dict = {}


def load():
    """Build (at first use) and load the kernel library."""
    lib = build.load("gftt_suppress.cu")
    fn = lib.lib.gftt_suppress_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def _offsets_on(offsets, dev) -> torch.Tensor:
    """The disc's offsets without (0, 0) as an (n, 2) int32 (dy, dx)
    tensor on ``dev``, made once per device and disc."""
    key = (dev, offsets)
    t = _offsets.get(key)
    if t is None:
        nbrs = [o for o in offsets if o != (0, 0)] or [(0, 0)]
        t = torch.tensor(nbrs, dtype=torch.int32, device=dev)
        _offsets[key] = t
    return t


def gftt_suppress(qmap: torch.Tensor, offsets,
                  max_rounds: int = gftt.MAX_ROUNDS,
                  state: Optional[torch.Tensor] = None):
    """Same contract as ``engine.gftt.suppress_plain``: ``qmap`` (H, W)
    float32, the candidates' qualities and 0 elsewhere; ``offsets`` the
    disc of ``engine.gftt._circle_offsets``; ``state`` None, or the state
    an earlier call on the same map and disc returned, to go on from.
    Returns ``(kept (H, W) bool, converged () bool, rounds () int32, state
    (H, W) uint8)`` on the map's device."""
    global launches, cuda_launches
    dev = qmap.device
    if dev.type == "cpu":
        return gftt.suppress_plain(qmap, offsets, max_rounds, state)
    if dev.type != "cuda":
        raise ValueError(f"gftt_suppress: unsupported device {dev}")
    if (qmap.dim() != 2 or qmap.dtype != torch.float32
            or not qmap.is_contiguous()):
        raise ValueError("qmap must be a contiguous (H, W) float32 tensor")
    H, W = qmap.shape
    n_off = len([o for o in offsets if o != (0, 0)])
    off = _offsets_on(tuple(offsets), dev)
    flags = torch.zeros((max_rounds + 1,), dtype=torch.int32, device=dev)
    resume = state is not None
    if resume:
        if (state.shape != qmap.shape or state.dtype != torch.uint8
                or state.device != dev or not state.is_contiguous()):
            raise ValueError("state must be an earlier call's (H, W) uint8 "
                             "state on the map's device")
        flags[0] = 1
    else:
        state = torch.empty((H, W), dtype=torch.uint8, device=dev)
    if H * W:
        fn = load().lib.gftt_suppress_launch
        with current(dev):  # the kernel launches on the current device
            rc = fn(qmap.data_ptr(), state.data_ptr(), flags.data_ptr(),
                    off.data_ptr(), n_off, H, W, int(max_rounds),
                    int(resume), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"gftt_suppress kernel launch failed: CUDA error {rc}")
        launches += 1
        cuda_launches += (0 if resume else 1) + 2 * int(max_rounds)
    return (state >= 2, flags[max_rounds] == 0,
            flags[:max_rounds].sum(dtype=torch.int32), state)
