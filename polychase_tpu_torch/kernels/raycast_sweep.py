"""K5: the closest-hit sweep of ``raycast_grouped`` (``csrc/raycast_sweep.cu``)
and its wrapper.

A kernel of the port with no TPU counterpart: it replaces the XLA scan of
``polychase_tpu/engine/raycast.py::raycast_grouped``.  One call sweeps G
groups of K rays, one origin a group, over every triangle and returns each
ray's closest hit, (best t, best id), ties to the lowest id.  The plain
torch version is ``engine.raycast.sweep_plain``.

CPU tensors take the plain version; CUDA tensors launch the kernel on their
own card, whatever the current device, and any failure to build or launch
it raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..backend import current
from . import build

# Calls that launched the kernel in this process (one per cast).
launches = 0

THREADS_MAX = 128     # rays a block (csrc/raycast_sweep.cu: kMaxThreads)
BLOCKS_PER_SM = 8     # blocks a split run aims for, per SM
SPLIT_MIN_TRIS = 256  # triangles a split sweeps at least (two tiles)
SPLITS_MAX = 64

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 4)
_sms: dict = {}


class Plan(NamedTuple):
    threads: int     # rays a block
    ray_blocks: int  # blocks a group
    splits: int      # triangle ranges swept by separate blocks


def launch_plan(G: int, K: int, T: int, sms: int) -> Plan:
    """The launch of G groups of K rays over T triangles on a card with
    ``sms`` SMs: blocks of 32 to 128 rays (a warp's multiple covering K),
    and the triangles split over more blocks where the rays alone give
    fewer than ``BLOCKS_PER_SM`` blocks an SM, each split sweeping at least
    ``SPLIT_MIN_TRIS`` triangles."""
    threads = min(THREADS_MAX, max(32, -(-K // 32) * 32))
    ray_blocks = -(-K // threads)
    blocks = max(G * ray_blocks, 1)
    want = -(-BLOCKS_PER_SM * sms // blocks)
    splits = max(1, min(want, SPLITS_MAX, T // SPLIT_MIN_TRIS))
    return Plan(threads, ray_blocks, splits)


def load():
    """Build (at first use) and load the kernel library."""
    lib = build.load("raycast_sweep.cu")
    fn = lib.lib.raycast_sweep_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    lib.lib.raycast_sweep_cuda_launches.restype = ctypes.c_longlong
    return lib


def cuda_launches() -> int:
    """The sweeps the kernel library has queued in this process, counted in
    its C entry point where the runtime accepts them (one a call of
    :func:`raycast_sweep`)."""
    return int(load().lib.raycast_sweep_cuda_launches())


def _sm_count(dev: torch.device) -> int:
    n = _sms.get(dev.index)
    if n is None:
        n = torch.cuda.get_device_properties(dev).multi_processor_count
        _sms[dev.index] = n
    return n


def _check(origins, dirs, v0, e1, e2):
    dev = origins.device
    if dev.type != "cuda":
        raise ValueError(f"raycast_sweep: unsupported device {dev}")
    for name, t, dim in (("origins", origins, 2), ("dirs", dirs, 3),
                         ("p1", v0, 2), ("e1", e1, 2), ("e2", e2, 2)):
        if (t.device != dev or t.dtype != torch.float32 or t.dim() != dim
                or t.shape[-1] != 3 or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"(..., 3) tensor of {dim} dims on {dev}")
    G, K = dirs.shape[:2]
    if origins.shape[0] != G or not v0.shape == e1.shape == e2.shape:
        raise ValueError("origins (G, 3), dirs (G, K, 3) and p1, e1, e2 "
                         "(T, 3) disagree")


def _launch(origins, dirs, v0, e1, e2):
    """One launch of K5 on the tensors' card: ``(best_t, best_id)``."""
    global launches
    dev = origins.device
    G, K = dirs.shape[:2]
    T = v0.shape[0]
    best_t = torch.empty((G, K), dtype=torch.float32, device=dev)
    best_id = torch.empty((G, K), dtype=torch.int64, device=dev)
    if G * K == 0:
        return best_t, best_id
    plan = launch_plan(G, K, T, _sm_count(dev))
    partial = (torch.empty((plan.splits, G, K), dtype=torch.int64,
                           device=dev) if plan.splits > 1 else None)
    fn = load().lib.raycast_sweep_launch
    with current(dev):  # the kernel launches on the current device
        rc = fn(origins.data_ptr(), dirs.data_ptr(), v0.data_ptr(),
                e1.data_ptr(), e2.data_ptr(), G, K, T, plan.threads,
                plan.splits, best_t.data_ptr(), best_id.data_ptr(),
                None if partial is None else partial.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"raycast_sweep kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return best_t, best_id


def raycast_sweep(origins: torch.Tensor, dirs: torch.Tensor,
                  p1: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor,
                  chunk: int = 0):
    """The sweep of ``engine.raycast.sweep_plain``: ``origins`` (G, 3),
    ``dirs`` (G, K, 3), the triangles' first corners ``p1`` and edges
    ``e1``, ``e2`` (T, 3), float32.  Returns ``best_t`` (G, K) float32
    (infinite on a miss) and ``best_id`` (G, K) int64 (``INVALID_ID`` on a
    miss) on the tensors' device.  ``chunk`` is the plain version's
    triangle block and is not used on a card, where :func:`launch_plan`
    sets the launch."""
    if origins.device.type == "cpu":
        from ..engine.raycast import sweep_plain

        return sweep_plain(origins, dirs, p1, e1, e2, chunk)
    _check(origins, dirs, p1, e1, e2)
    return _launch(origins, dirs, p1, e1, e2)
