"""K6: ``grid_raycast`` on the card in one launch, the grid walk and its
hits (``csrc/grid_cast.cu``), and its wrapper.

A kernel of the port with no TPU counterpart: the JAX package runs this
cast as an XLA ``lax.while_loop`` over all rays in lockstep
(``polychase_tpu/engine/gridcast.py:212-379``), not as a Pallas kernel.
One call casts N rays, each with its own origin, through a
:class:`engine.gridcast.GridAccel`: each ray's closest hit (the first
strictly smaller t in visiting order), dropped where its triangle is
masked, with its position, normal and barycentrics.  A team of lanes walks
each ray (``team_width``).  The plain torch version is
``engine.gridcast.grid_plain``.

CPU tensors take the plain version; CUDA tensors launch the kernel on their
own card, whatever the current device, and any failure to build or launch
it raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..backend import current
from . import build

# Calls that launched the kernel in this process (one per cast).
launches = 0

TEAMS = (8, 16, 32)  # lanes a ray the kernel takes (csrc: grid_kernel<L>)

_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 7)


def team_width(accel) -> int:
    """Lanes a ray for casts through ``accel``: the least of ``TEAMS`` whose
    two rounds hold the candidates of the cell an item lies in, on the
    mean (``accel.cell_load``, the build's), else the widest.  Measured on
    an H100 at every width (``k6_compare.py --teams``, PERF.md §6): the
    fastest, or within 2% of it, on five of seven scenes, from config 4's
    refresh on a 1,472-triangle sphere (load 9.4: 8 lanes) to 1,998,000
    triangles (117.6: 32) and a huge ground triangle whose grid holds the
    mesh in a few dense cells (243.7: 32); 8,192 rays into a soup of
    20,000 (9.1) or the 1,472-triangle sphere took 16 lanes 14-16% faster
    (at 8 lanes those rays fill a quarter of the card's warp slots).
    Pure arithmetic on a number the build knows: no host sync in a cast."""
    for team in TEAMS:
        if accel.cell_load <= 2 * team:
            return team
    return TEAMS[-1]


def load():
    """Build (at first use) and load the kernel library."""
    lib = build.load("grid_cast.cu")
    fn = lib.lib.grid_cast_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    lib.lib.grid_cast_cuda_launches.restype = ctypes.c_longlong
    return lib


def cuda_launches() -> int:
    """The launches the kernel library has queued in this process, counted
    in its C entry point where the runtime accepts them (one a call of
    :func:`grid_hits`)."""
    return int(load().lib.grid_cast_cuda_launches())


def _check(origins, dirs, accel, vertices, triangles, words, block,
           max_iters):
    """The inputs the kernel takes, on every device: ValueError otherwise."""
    dev = origins.device
    for name, t, dtype, shape in (
            ("origins", origins, torch.float32, (None, 3)),
            ("dirs", dirs, torch.float32, (None, 3)),
            ("cell_start", accel.cell_start, torch.int32, (None,)),
            ("items", accel.items, torch.int32, (None,)),
            ("tri_rows", accel.tri_rows, torch.float32, (None, 12)),
            ("lo", accel.lo, torch.float32, (3,)),
            ("h", accel.h, torch.float32, (3,)),
            ("res", accel.res, torch.int32, (3,)),
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
    if dirs.shape[0] != origins.shape[0]:
        raise ValueError("origins and dirs (N, 3) disagree")
    if words.shape[0] < -(-triangles.shape[0] // 32):
        raise ValueError("fewer mask words than the triangles need")
    if triangles.shape[0] and accel.tri_rows.shape[0] != triangles.shape[0]:
        raise ValueError("the grid was built over another mesh")
    if block < 1 or max_iters < 0:
        raise ValueError("block must be >= 1 and max_iters >= 0")


def _launch(origins, dirs, accel, vertices, triangles, words, check_mask,
            block, max_iters, team):
    """One launch of K6 on the tensors' card, ``team`` lanes a ray (one of
    ``TEAMS``; the tests and ``k6_compare.py`` force each): the fields of
    :class:`engine.raycast.RayHits`."""
    global launches
    from ..engine.raycast import RayHits

    dev = origins.device
    n = origins.shape[0]

    def out(*shape, dtype=torch.float32):
        return torch.empty((n, *shape), dtype=dtype, device=dev)

    hits = RayHits(pos=out(3), normal=out(3), barycentric=out(2), t=out(),
                   prim_id=out(dtype=torch.int64),
                   valid=out(dtype=torch.bool))
    if n == 0:
        return hits
    fn = load().lib.grid_cast_launch
    with current(dev):  # the kernel launches on the current device
        rc = fn(origins.data_ptr(), dirs.data_ptr(),
                accel.cell_start.data_ptr(), accel.items.data_ptr(),
                accel.tri_rows.data_ptr(), accel.lo.data_ptr(),
                accel.h.data_ptr(), accel.res.data_ptr(),
                vertices.data_ptr(), triangles.data_ptr(), words.data_ptr(),
                n, block, max_iters, int(bool(check_mask)), team,
                hits.pos.data_ptr(), hits.normal.data_ptr(),
                hits.barycentric.data_ptr(), hits.t.data_ptr(),
                hits.prim_id.data_ptr(), hits.valid.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grid_cast kernel launch failed: CUDA error {rc}")
    launches += 1
    return hits


def grid_hits(origins: torch.Tensor, dirs: torch.Tensor, accel,
              vertices: torch.Tensor, triangles: torch.Tensor,
              words: torch.Tensor, check_mask: bool = True, block: int = 4,
              max_iters: int = 200_000):
    """``grid_raycast``'s cast, the plain version's
    ``engine.gridcast.grid_plain``: ``origins``, ``dirs`` (N, 3) float32,
    a :class:`engine.gridcast.GridAccel` and a mesh's ``vertices`` (V, 3)
    float32, ``triangles`` (T, 3) int64 and mask ``words`` (int64), all
    contiguous on one device.  Returns :class:`engine.raycast.RayHits` on
    that device."""
    _check(origins, dirs, accel, vertices, triangles, words, block,
           max_iters)
    dev = origins.device
    if dev.type == "cpu":
        from ..engine.gridcast import grid_plain

        return grid_plain(origins, dirs, accel, vertices, triangles, words,
                          check_mask, block, max_iters)
    if dev.type != "cuda":
        raise ValueError(f"grid_hits: unsupported device {dev}")
    return _launch(origins, dirs, accel, vertices, triangles, words,
                   check_mask, block, max_iters, team_width(accel))
