"""K5: ``raycast_grouped`` on the card in one launch, the closest-hit sweep
and its hits (``csrc/raycast_sweep.cu``), and its wrapper.

A kernel of the port with no TPU counterpart: it replaces the XLA scan of
``polychase_tpu/engine/raycast.py::raycast_grouped`` and the ops after it.
One call casts G groups of K rays, one origin a group, against a mesh's
triangles: each ray's closest hit (ties to the lowest id), dropped where
its triangle is masked, with its position, normal and barycentrics.  The
plain torch version is ``engine.raycast.cast_plain`` (``sweep_plain``, then
``hits_plain``).

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

TILE = 512          # triangles a block stages a pass (csrc: kTile)
BLOCKS_PER_SM = 1   # blocks an SM holds (csrc: kThreads, registers)
CLUSTER_MAX = 8     # blocks a cluster over the triangles (csrc: kMaxCluster)
PACKED_BELOW = 32   # K under which a block packs groups (csrc: PACKED)

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_void_p] * 7)
_sms: dict = {}


class Plan(NamedTuple):
    rays_per_thread: int
    packed: bool     # blocks of any groups' rays, each its own constants
    ray_blocks: int  # blocks of 32 R rays: a group's, or in all if packed
    cluster: int     # blocks a cluster, over as many triangle ranges


def launch_plan(G: int, K: int, T: int, sms: int) -> Plan:
    """The launch of G groups of K rays over T triangles on a card with
    ``sms`` SMs.  Blocks of 32 R rays, R = 4 (2 for K of 32 to 64, so
    that a block is not mostly idle): one group's (its stage shares the
    group's constants), or, for K under 32, packed from any groups.  Where
    the blocks of rays fill less than one wave of ``BLOCKS_PER_SM`` an SM,
    clusters of 2 to ``CLUSTER_MAX`` blocks split the triangles, as many
    as fit in that wave, each block at least one tile.  (A wave of more
    blocks than SMs would leave the scheduler to stack several on one SM
    while others idle: on an H100 a tracking frame took 0.24 ms in
    clusters of 4 against 0.16 in clusters of 2, ``k5_compare.py
    --plans``.)"""
    packed = K < PACKED_BELOW
    R = 2 if 32 <= K <= 64 else 4
    per = 32 * R
    ray_blocks = -(-G * K // per) if packed else -(-K // per)
    blocks = ray_blocks if packed else G * ray_blocks
    cluster = 1
    while (cluster < CLUSTER_MAX
           and blocks * cluster * 2 <= sms * BLOCKS_PER_SM
           and T >= cluster * 2 * TILE):
        cluster *= 2
    return Plan(R, packed, ray_blocks, cluster)


def load():
    """Build (at first use) and load the kernel library."""
    lib = build.load("raycast_sweep.cu")
    fn = lib.lib.raycast_sweep_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    lib.lib.raycast_sweep_cuda_launches.restype = ctypes.c_longlong
    return lib


def cuda_launches() -> int:
    """The launches the kernel library has queued in this process, counted
    in its C entry point where the runtime accepts them (one a call of
    :func:`raycast_hits`)."""
    return int(load().lib.raycast_sweep_cuda_launches())


def _sm_count(dev: torch.device) -> int:
    n = _sms.get(dev.index)
    if n is None:
        n = torch.cuda.get_device_properties(dev).multi_processor_count
        _sms[dev.index] = n
    return n


def _check(origins, dirs, vertices, triangles, words):
    """The inputs the kernel takes, on every device: ValueError otherwise."""
    dev = origins.device
    for name, t, dtype, shape in (
            ("origins", origins, torch.float32, (None, 3)),
            ("dirs", dirs, torch.float32, (None, None, 3)),
            ("vertices", vertices, torch.float32, (None, 3)),
            ("triangles", triangles, torch.int64, (None, 3)),
            ("mask words", words, torch.int64, (None,))):
        if (t.device != dev or t.dtype != dtype or t.dim() != len(shape)
                or any(w is not None and n != w
                       for n, w in zip(t.shape, shape))
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor of shape "
                f"{tuple('*' if w is None else w for w in shape)} on {dev}")
    G = dirs.shape[0]
    if origins.shape[0] != G:
        raise ValueError("origins (G, 3) and dirs (G, K, 3) disagree")
    if words.shape[0] < -(-triangles.shape[0] // 32):
        raise ValueError("fewer mask words than the triangles need")


def _launch(origins, dirs, vertices, triangles, words, check_mask, plan):
    """One launch of K5 on the tensors' card with ``plan``: the fields of
    :class:`engine.raycast.RayHits`."""
    global launches
    from ..engine.raycast import RayHits

    dev = origins.device
    G, K = dirs.shape[:2]
    T = triangles.shape[0]

    def out(*shape, dtype=torch.float32):
        return torch.empty((G, K, *shape), dtype=dtype, device=dev)

    hits = RayHits(pos=out(3), normal=out(3), barycentric=out(2), t=out(),
                   prim_id=out(dtype=torch.int64),
                   valid=out(dtype=torch.bool))
    if G * K == 0:
        return hits
    fn = load().lib.raycast_sweep_launch
    with current(dev):  # the kernel launches on the current device
        rc = fn(origins.data_ptr(), dirs.data_ptr(), vertices.data_ptr(),
                triangles.data_ptr(), words.data_ptr(), G, K, T,
                plan.rays_per_thread, int(plan.packed), plan.ray_blocks,
                plan.cluster, int(bool(check_mask)), hits.pos.data_ptr(),
                hits.normal.data_ptr(), hits.barycentric.data_ptr(),
                hits.t.data_ptr(), hits.prim_id.data_ptr(),
                hits.valid.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"raycast_sweep kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return hits


def raycast_hits(origins: torch.Tensor, dirs: torch.Tensor,
                 vertices: torch.Tensor, triangles: torch.Tensor,
                 words: torch.Tensor, check_mask: bool = True,
                 chunk: int = 0):
    """``raycast_grouped``'s cast, the plain version's
    ``engine.raycast.cast_plain``: ``origins`` (G, 3) and ``dirs`` (G, K,
    3) float32, and a mesh's ``vertices`` (V, 3) float32, ``triangles``
    (T, 3) int64 and mask ``words`` (int64), all contiguous on one device.
    Returns :class:`engine.raycast.RayHits` on that device.  ``chunk`` is
    the plain version's triangle block and is not used on a card, where
    :func:`launch_plan` sets the launch."""
    _check(origins, dirs, vertices, triangles, words)
    dev = origins.device
    if dev.type == "cpu":
        from ..engine.raycast import cast_plain

        return cast_plain(origins, dirs, vertices, triangles, words,
                          check_mask, chunk)
    if dev.type != "cuda":
        raise ValueError(f"raycast_hits: unsupported device {dev}")
    G, K = dirs.shape[:2]
    plan = launch_plan(G, K, triangles.shape[0], _sm_count(dev))
    return _launch(origins, dirs, vertices, triangles, words, check_mask,
                   plan)
