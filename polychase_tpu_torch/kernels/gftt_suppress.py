"""K4: GFTT's min-distance suppression (``csrc/gftt_suppress.cu``) and its
wrapper.

A kernel of the port with no TPU counterpart: it replaces the XLA fixed
point ``polychase_tpu/engine/gftt.py::_suppress_device``.  One call is one
cooperative launch: an init pass, then up to ``max_rounds`` rounds of a
reject pass and a select pass over each band's candidates, with a grid
barrier between passes, until no point is left undecided; then the kept
points compacted in row-major order.
A call given an earlier call's ``state`` goes on from there.  The plain
torch version is ``engine.gftt.suppress_plain`` (and ``_compact_kept`` for
the kept list).

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

# Calls that launched the kernel in this process (one per frame, more where
# a frame's fixed point outlasts max_rounds rounds).
launches = 0
# The ctl scratch's blocks when the grid is sized from the occupancy: more
# than any card's SMs can hold co-resident at one block each.
_AUTO_GRID_MAX = 1024

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
             + [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p]
             + [ctypes.c_int] + [ctypes.c_void_p])
_discs: dict = {}


def load():
    """Build (at first use) and load the kernel library."""
    lib = build.load("gftt_suppress.cu")
    fn = lib.lib.gftt_suppress_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    lib.lib.gftt_suppress_cuda_launches.restype = ctypes.c_longlong
    return lib


def cuda_launches() -> int:
    """The cooperative launches the kernel library has queued in this
    process, counted in its C entry point where the runtime accepts them
    (one a call of :func:`gftt_suppress_kept`)."""
    return int(load().lib.gftt_suppress_cuda_launches())


def disc_rows(offsets):
    """The disc's radius r and its rows' half-widths: ``(r, half)`` with
    ``half[dy + r]`` the h such that the offsets of row dy are dx in [-h, h]
    (but for (0, 0)), -1 where the row holds none.  Raises ValueError for
    offsets that are not such rows, as every disc of
    ``engine.gftt._circle_offsets`` is."""
    nbrs = {o for o in offsets if o != (0, 0)}
    r = max([max(abs(dy), abs(dx)) for dy, dx in nbrs] + [0])
    half = []
    for dy in range(-r, r + 1):
        dxs = {dx for y, dx in nbrs if y == dy}
        h = max([abs(dx) for dx in dxs], default=-1)
        want = set(range(-h, h + 1)) - ({0} if dy == 0 else set())
        if dxs != want:
            raise ValueError("the disc's rows must be centred runs of dx")
        half.append(h)
    return r, half


def _disc_on(offsets, dev):
    """``(r, half (2r + 1,) int32 tensor on dev)`` of :func:`disc_rows`,
    made once per device and disc."""
    key = (dev, offsets)
    t = _discs.get(key)
    if t is None:
        r, half = disc_rows(offsets)
        t = (r, torch.tensor(half, dtype=torch.int32, device=dev))
        _discs[key] = t
    return t


def _launch(qmap, offsets, max_rounds, state, k, grid):
    """One launch of K4 on the map's card.  Returns ``(vals, idx, count,
    converged, rounds, state)``."""
    global launches
    dev = qmap.device
    if (qmap.dim() != 2 or qmap.dtype != torch.float32
            or not qmap.is_contiguous()):
        raise ValueError("qmap must be a contiguous (H, W) float32 tensor")
    H, W = qmap.shape
    r, half = _disc_on(tuple(offsets), dev)
    resume = state is not None
    if resume:
        if (state.shape != qmap.shape or state.dtype != torch.uint8
                or state.device != dev or not state.is_contiguous()):
            raise ValueError("state must be an earlier call's (H, W) uint8 "
                             "state on the map's device")
    else:
        state = torch.empty((H, W), dtype=torch.uint8, device=dev)
    rounds = torch.empty((), dtype=torch.int32, device=dev)
    converged = torch.empty((), dtype=torch.bool, device=dev)
    vals = torch.empty((k,), dtype=torch.float32, device=dev)
    idx = torch.empty((k,), dtype=torch.int64, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    if H * W:
        ctl_blocks = int(grid) if grid else _AUTO_GRID_MAX
        ctl = torch.empty((3 * ctl_blocks,), dtype=torch.int32, device=dev)
        spill = torch.empty((H * W,), dtype=torch.int32, device=dev)
        fn = load().lib.gftt_suppress_launch
        with current(dev):  # the kernel launches on the current device
            rc = fn(qmap.data_ptr(), state.data_ptr(), half.data_ptr(), r,
                    H, W, int(max_rounds), int(resume), int(k),
                    vals.data_ptr(), idx.data_ptr(), count.data_ptr(),
                    rounds.data_ptr(), converged.data_ptr(), ctl.data_ptr(),
                    ctl_blocks, spill.data_ptr(), int(grid or 0),
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"gftt_suppress kernel launch failed: CUDA error {rc}")
        launches += 1
    else:
        rounds.zero_()
        converged.fill_(True)
        vals.zero_()
        idx.zero_()
        count.zero_()
    return vals, idx, count, converged, rounds, state


def _check_device(dev):
    if dev.type != "cuda":
        raise ValueError(f"gftt_suppress: unsupported device {dev}")


def gftt_suppress_kept(qmap: torch.Tensor, offsets, k: int,
                       max_rounds: int = gftt.MAX_ROUNDS,
                       state: Optional[torch.Tensor] = None, *,
                       grid: Optional[int] = None):
    """The suppression of ``engine.gftt.suppress_plain`` with the kept
    points compacted.  ``qmap`` (H, W) float32, the candidates' qualities
    and 0 elsewhere; ``offsets`` the disc of ``engine.gftt._circle_offsets``;
    ``state`` None, or the state an earlier call on the same map and disc
    returned, to go on from.  Returns ``(vals (k,) float32, idx (k,)
    int64, count () int64, converged () bool, rounds () int32, state (H, W)
    uint8)`` on the map's device: the kept points' qualities and row-major
    indices in row-major order, zero past ``count``
    (``engine.gftt._compact_kept``'s buffers, to the bit), and ``state``
    2 or more where kept.  ``grid`` forces the kernel's block count
    (measurements and tests; by default it is sized from the occupancy)."""
    if qmap.device.type == "cpu":
        kept, converged, rounds, state = gftt.suppress_plain(
            qmap, offsets, max_rounds, state)
        return (*gftt._compact_kept(qmap, kept, k), converged, rounds,
                state)
    _check_device(qmap.device)
    if k < 1:
        raise ValueError("k must be at least 1")
    return _launch(qmap, offsets, max_rounds, state, int(k), grid)


def gftt_suppress(qmap: torch.Tensor, offsets,
                  max_rounds: int = gftt.MAX_ROUNDS,
                  state: Optional[torch.Tensor] = None, *,
                  grid: Optional[int] = None):
    """:func:`gftt_suppress_kept` read as ``engine.gftt.suppress_plain``
    returns: ``(kept (H, W) bool, converged, rounds, state)``."""
    *_, converged, rounds, state = gftt_suppress_kept(
        qmap, offsets, 1, max_rounds, state, grid=grid)
    return state >= 2, converged, rounds, state
