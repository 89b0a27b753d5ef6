"""Closest-hit ray casting through a uniform grid over the mesh.

Port of ``polychase_tpu/engine/gridcast.py``, the reference's analogue of
Embree's BVH (cpp/ray_casting.cc:21-121) for a device:

- **Build** (host, numpy, once a mesh): every triangle is binned into the
  cells its bounding box overlaps; the cell → triangle lists are stored
  CSR-style (``cell_start``, ``items``, x-major cells
  ``flat = (ix·ry + iy)·rz + iz``), with the reference's resolution rule,
  so that ``cell_start``, ``items``, ``lo``, ``h`` and ``res`` equal the
  JAX build's to the bit.
- **Traverse**: each ray walks its cells with the Amanatides–Woo 3D-DDA.
  A ray's action is either a block of ``block`` candidates of its current
  cell (Möller–Trumbore with its own origin, eps 1e-10, ``t > 0``) or one
  step to the next cell; it ends when its best hit lies at or before the
  exit of its cell (binning is conservative, so every closer triangle has
  been tested), when it leaves the grid, or after ``max_iters`` actions.
  The winner is the first strictly smaller t in visiting order: the lowest
  id within a cell, the earlier cell across cells.  Exact closest hit,
  up to the order of ties, as the brute sweep of ``engine/raycast.py``.

On the TPU the traversal is one XLA ``lax.while_loop`` over all rays in
lockstep.  Here CPU tensors take :func:`grid_plain`, that loop in torch
with the reference's arithmetic; CUDA tensors launch K6
(``kernels/grid_cast.py`` → ``csrc/grid_cast.cu``), a kernel of the port
in which each thread walks its own ray, or raise.

The reference pre-gathers a 48-byte row per (cell, triangle) item, since
TPU gathers are row-granular (``gridcast.py:146-149``).  The port keeps one
row per triangle, ``tri_rows`` = (p1, e1 = p2 - p1, e2 = p3 - p1) in
float32 as the reference computes them, and reads it by id.

Mask semantics match the reference: the closest hit is found over all
triangles (masked ones still occlude) and then dropped if its triangle is
masked (cpp/ray_casting.cc:100-120).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..backend import as_device
from .geometry import Mesh
from .pose import cross
from .raycast import INVALID_ID, RayHits, _EPS, _ray_hits, _unmasked

_BIG = float("inf")


@dataclass
class GridAccel:
    """A uniform grid over a mesh, as tensors on one device.

    ``cell_start`` has ``prod(res) + 1`` CSR offsets into ``items`` (the
    flat cell → triangle lists, x-major, each list in ascending id).
    ``tri_rows`` holds one row a triangle, ``[p1, e1, e2, 0, 0, 0]``.
    """

    cell_start: torch.Tensor  # (prod(res) + 1,) int32
    items: torch.Tensor       # (max(n_items, 1),) int32 triangle ids
    tri_rows: torch.Tensor    # (max(T, 1), 12) float32
    lo: torch.Tensor          # (3,) float32 grid origin
    h: torch.Tensor           # (3,) float32 cell size
    res: torch.Tensor         # (3,) int32 cells per axis

    def to(self, device) -> "GridAccel":
        device = as_device(device)
        return GridAccel(*(getattr(self, f).to(device) for f in (
            "cell_start", "items", "tri_rows", "lo", "h", "res")))


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def build_grid_accel(vertices, triangles, max_cells: int = 1 << 21,
                     max_mean_items: float = 12.0, *,
                     device) -> GridAccel:
    """Host-side grid build (the ``AcceleratedMesh`` build step), on
    ``device`` afterwards.

    The grid holds ~2 cells a triangle (anisotropic, proportional to the
    mesh's extent per axis), at most ``max_cells``, and is halved until
    the conservative bounding-box binning keeps the mean items a triangle
    at most ``max_mean_items``: a skewed mesh (one huge ground plane)
    coarsens the grid instead of exploding its lists.  Fewer than 2**23
    triangles, as the reference."""
    device = as_device(device)
    v = _host(vertices, np.float64).reshape(-1, 3)
    tri = _host(triangles, np.int64).reshape(-1, 3)
    T = tri.shape[0]

    def accel(cell_start, items, rows, lo, h, res):
        return GridAccel(
            cell_start=torch.as_tensor(cell_start.astype(np.int32),
                                       device=device),
            items=torch.as_tensor(items.astype(np.int32), device=device),
            tri_rows=torch.as_tensor(rows, device=device),
            lo=torch.as_tensor(lo.astype(np.float32), device=device),
            h=torch.as_tensor(h.astype(np.float32), device=device),
            res=torch.as_tensor(res.astype(np.int32), device=device),
        )

    if T == 0 or v.shape[0] == 0:
        return accel(np.zeros(2), np.zeros(1), np.zeros((1, 12), np.float32),
                     np.zeros(3), np.ones(3), np.ones(3))
    if T >= (1 << 23):
        raise ValueError("grid accel supports < 2^23 triangles")

    p = v[tri]  # (T, 3, 3)
    tlo = p.min(axis=1)
    thi = p.max(axis=1)
    lo = tlo.min(axis=0)
    hi = thi.max(axis=0)
    pad = 1e-6 * max(float((hi - lo).max()), 1.0)
    lo = lo - pad
    hi = hi + pad
    extent = np.maximum(hi - lo, 4 * pad)

    total = float(min(max_cells, max(8, 2 * T)))
    scale = (total / float(extent.prod())) ** (1.0 / 3.0)
    res = np.maximum(1, np.floor(extent * scale).astype(np.int64))
    # Degenerate axes clamp to one cell, which can inflate the product far
    # past the budget on thin meshes: enforce it explicitly.
    while res.prod() > max_cells:
        res = np.maximum(1, res // 2)

    while True:
        h = extent / res
        c0 = np.clip(((tlo - lo) / h).astype(np.int64), 0, res - 1)
        c1 = np.clip(((thi - lo) / h).astype(np.int64), 0, res - 1)
        span = c1 - c0 + 1  # (T, 3)
        counts = span.prod(axis=1)
        n_items = int(counts.sum())
        if n_items <= max_mean_items * T or (res == 1).all():
            break
        res = np.maximum(1, res // 2)

    # The (cell, triangle) pairs without a Python loop: a global item index
    # decomposed into (triangle, local xyz offset inside its span).
    tri_of = np.repeat(np.arange(T, dtype=np.int64), counts)
    first = np.concatenate(([0], np.cumsum(counts)[:-1]))
    local = np.arange(n_items, dtype=np.int64) - np.repeat(first, counts)
    span_t = span[tri_of]
    nyz = span_t[:, 1] * span_t[:, 2]
    lx = local // nyz
    rem = local - lx * nyz
    ly = rem // span_t[:, 2]
    lz = rem - ly * span_t[:, 2]
    flat = ((c0[tri_of, 0] + lx) * res[1] + c0[tri_of, 1] + ly) * res[2] \
        + c0[tri_of, 2] + lz

    order = np.argsort(flat, kind="stable")
    items = tri_of[order]
    cell_start = np.zeros(int(res.prod()) + 1, np.int64)
    np.add.at(cell_start, flat[order] + 1, 1)
    cell_start = np.cumsum(cell_start)

    pf = p.astype(np.float32)
    rows = np.zeros((T, 12), np.float32)
    rows[:, 0:3] = pf[:, 0]
    rows[:, 3:6] = pf[:, 1] - pf[:, 0]
    rows[:, 6:9] = pf[:, 2] - pf[:, 0]
    return accel(cell_start, items, rows, lo, h, res)


def _slab_entry(lo, hi, origins, dirs):
    """Entry and exit parameters of the rays against the grid's box, with
    axis-parallel directions handled explicitly: ``(t0, t1)``; a ray
    enters iff ``t1 >= max(t0, 0)`` and ``t0`` is finite."""
    d0 = dirs == 0.0
    inv = 1.0 / torch.where(d0, 1.0, dirs)
    near = torch.where(d0, torch.where(origins >= lo, -_BIG, _BIG),
                       (lo - origins) * inv)
    far = torch.where(d0, torch.where(origins <= hi, _BIG, -_BIG),
                      (hi - origins) * inv)
    # d == 0 outside the slab: rejected through t0 = +inf (far = -inf
    # would re-sort into an unconstrained interval).
    bad = d0 & ((origins < lo) | (origins > hi))
    near = torch.where(bad, _BIG, near)
    far = torch.where(bad, _BIG, far)
    t0 = torch.amax(torch.minimum(near, far), dim=-1)
    t1 = torch.amin(torch.maximum(near, far), dim=-1)
    return t0, t1


def _moller_block(o, d, p1, e1, e2):
    """Möller–Trumbore on (N, B, 3) candidate blocks; ``o`` and ``d`` are
    (N, 1, 3), ``e1``, ``e2`` the edges p2 - p1, p3 - p1."""
    rce2 = cross(d, e2)
    det = torch.sum(e1 * rce2, dim=-1)
    ok = torch.abs(det) > _EPS
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    s = o - p1
    u = inv_det * torch.sum(s * rce2, dim=-1)
    sce1 = cross(s, e1)
    v = inv_det * torch.sum(d * sce1, dim=-1)
    t = inv_det * torch.sum(e2 * sce1, dim=-1)
    hit = (ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0))
    return t, u, v, hit


def _no_hits(n: int, device) -> RayHits:
    f32 = dict(dtype=torch.float32, device=device)
    return RayHits(
        pos=torch.zeros((n, 3), **f32), normal=torch.zeros((n, 3), **f32),
        barycentric=torch.zeros((n, 2), **f32),
        t=torch.full((n,), _BIG, **f32),
        prim_id=torch.full((n,), INVALID_ID, dtype=torch.int64,
                           device=device),
        valid=torch.zeros((n,), dtype=torch.bool, device=device))


def grid_plain_counted(origins: torch.Tensor, dirs: torch.Tensor,
                       accel: GridAccel, vertices: torch.Tensor,
                       triangles: torch.Tensor, words: torch.Tensor,
                       check_mask: bool = True, block: int = 4,
                       max_iters: int = 200_000):
    """:func:`grid_plain`, with the work its inputs needed: returns
    ``(hits, tests, steps, iterations, found)``, the candidates tested
    (ray, triangle pairs), the actions that left a cell (a DDA step, or
    the ray's end there), the lockstep's iterations and each ray's closest
    triangle before the mask test (``INVALID_ID`` where none)."""
    n = origins.shape[0]
    dev = origins.device
    if triangles.shape[0] == 0:
        hits = _no_hits(n, dev)
        return hits, 0, 0, 0, hits.prim_id
    cs, items, rows = accel.cell_start, accel.items, accel.tri_rows
    res, glo, h = accel.res, accel.lo, accel.h
    ghi = glo + h * res.to(torch.float32)

    t0, t1 = _slab_entry(glo, ghi, origins, dirs)
    t_start = torch.clamp_min(t0, 0.0)
    inside = (t1 >= t_start) & (t0 < _BIG)

    pstart = origins + dirs * t_start[:, None]
    # The start cell, clamped into the grid in float (a ray that does not
    # enter keeps a cell in range too; NaN takes cell 0).
    c = torch.floor((pstart - glo) / h)
    c = torch.where(torch.isnan(c), 0.0, c)
    cell = torch.minimum(torch.clamp_min(c, 0.0),
                         (res - 1).to(torch.float32)).to(torch.int32)

    step = torch.sign(dirs).to(torch.int32)
    d0 = dirs == 0.0
    safe_d = torch.where(d0, 1.0, dirs)
    # The parameter of the next boundary crossing on each axis.
    next_bound = glo + (cell + (step > 0).to(torch.int32)).to(
        torch.float32) * h
    tmax = torch.where(d0, _BIG, (next_bound - origins) / safe_d)
    tdelta = torch.where(d0, _BIG, torch.abs(h / safe_d))

    def flat_of(c):
        return ((c[:, 0] * res[1] + c[:, 1]) * res[2] + c[:, 2]).long()

    f0 = flat_of(cell)
    zero = torch.zeros_like(f0, dtype=torch.int32)
    ptr = torch.where(inside, cs[f0], zero)
    end = torch.where(inside, cs[f0 + 1], zero)

    active = inside
    best_t = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    best_uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    best_id = torch.full((n,), INVALID_ID, dtype=torch.int64, device=dev)
    barange = torch.arange(block, dtype=torch.int32, device=dev)
    axes = torch.arange(3, device=dev)
    o_b, d_b = origins[:, None, :], dirs[:, None, :]
    ni = items.shape[0]
    tests = steps = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    while it < max_iters and bool(active.any()):
        has = ptr < end
        do_cand = active & has

        # A block of the current cell's candidates.
        idx = ptr[:, None] + barange[None, :]  # (N, B)
        cval = do_cand[:, None] & (idx < end[:, None])
        ids = items[idx.clamp(0, ni - 1).long()].long()
        r = rows[ids]  # (N, B, 12)
        t, u, v, hit = _moller_block(o_b, d_b, r[..., 0:3], r[..., 3:6],
                                     r[..., 6:9])
        hit = hit & cval
        t = torch.where(hit, t, _BIG)
        j = torch.argmin(t, dim=-1, keepdim=True)
        tj = torch.gather(t, -1, j)[:, 0]
        closer = tj < best_t
        uvj = torch.stack([torch.gather(u, -1, j)[:, 0],
                           torch.gather(v, -1, j)[:, 0]], dim=-1)
        best_uv = torch.where(closer[:, None], uvj, best_uv)
        best_id = torch.where(closer, torch.gather(ids, -1, j)[:, 0],
                              best_id)
        best_t = torch.where(closer, tj, best_t)
        ptr = torch.where(do_cand, torch.minimum(ptr + block, end), ptr)

        # A ray whose cell is exhausted ends, or steps to the next cell.
        do_adv = active & ~has
        hit_done = best_t <= torch.amin(tmax, dim=-1)
        onehot = torch.argmin(tmax, dim=-1)[:, None] == axes[None, :]
        newcell = cell + torch.where(onehot, step, 0)
        oob = ((newcell < 0) | (newcell >= res)).any(dim=-1)
        done = do_adv & (hit_done | oob)
        move = do_adv & ~done
        cell = torch.where(move[:, None], newcell, cell)
        tmax = torch.where(move[:, None] & onehot, tmax + tdelta, tmax)
        fc = flat_of(cell)
        ptr = torch.where(move, cs[fc], ptr)
        end = torch.where(move, cs[fc + 1], end)

        active = active & ~done
        tests = tests + cval.sum()
        steps = steps + do_adv.sum()
        it += 1

    valid = _unmasked(words, best_id, check_mask)
    safe = torch.where(valid, best_id, torch.zeros_like(best_id))
    q = vertices[triangles[safe]]  # (N, 3, 3)
    hits = _ray_hits(q[:, 0], q[:, 1], q[:, 2], best_uv, best_t, best_id,
                     valid)
    return hits, int(tests), int(steps), it, best_id


def grid_plain(origins: torch.Tensor, dirs: torch.Tensor, accel: GridAccel,
               vertices: torch.Tensor, triangles: torch.Tensor,
               words: torch.Tensor, check_mask: bool = True, block: int = 4,
               max_iters: int = 200_000) -> RayHits:
    """The cast of :func:`grid_raycast` in plain torch, the plain version of
    K6 (``kernels/grid_cast.py``): the reference's lockstep loop, every
    active ray taking one action an iteration (a block of candidates, or
    a cell step), at most ``max_iters`` iterations, so at most
    ``max_iters`` actions a ray.  ``origins``, ``dirs`` (N, 3) float32;
    ``vertices``, ``triangles`` and ``words`` are a :class:`Mesh`'s
    arrays.  The hit's barycentrics are the walk's; position and normal
    follow from them (``raycast._ray_hits``)."""
    return grid_plain_counted(origins, dirs, accel, vertices, triangles,
                              words, check_mask, block, max_iters)[0]


def grid_raycast(mesh: Mesh, accel: GridAccel, origins: torch.Tensor,
                 dirs: torch.Tensor, check_mask: bool = True, block: int = 4,
                 max_iters: int = 200_000) -> RayHits:
    """Closest-hit cast of N rays through the grid, each with its own
    origin: ``origins``, ``dirs`` (N, 3).  Exact (up to the order of ties)
    like :func:`raycast.raycast`, with work that follows the candidates
    along each ray instead of the triangle count.  CPU tensors take
    :func:`grid_plain`; on a card the whole cast is one launch of K6."""
    from ..kernels.grid_cast import grid_hits

    origins = origins.to(torch.float32).reshape(-1, 3).contiguous()
    dirs = dirs.to(torch.float32).reshape(-1, 3).contiguous()
    return grid_hits(origins, dirs, accel, mesh.vertices, mesh.triangles,
                     mesh.masked_triangles, check_mask, block, max_iters)


def grid_raycast_grouped(mesh: Mesh, accel: GridAccel, origins: torch.Tensor,
                         dirs: torch.Tensor, check_mask: bool = True,
                         block: int = 4,
                         max_iters: int = 200_000) -> RayHits:
    """:func:`grid_raycast` in the shape of :func:`raycast.raycast_grouped`:
    G groups of K rays, one origin a group (``origins`` (G, 3), ``dirs``
    (G, K, 3)), results with (G, K) dims."""
    origins = origins.to(torch.float32).reshape(-1, 3)
    G = origins.shape[0]
    dirs = dirs.to(torch.float32).reshape(G, -1, 3)
    K = dirs.shape[1]
    hits = grid_raycast(mesh, accel, origins[:, None, :].expand(G, K, 3),
                        dirs, check_mask, block, max_iters)
    return RayHits(
        pos=hits.pos.reshape(G, K, 3),
        normal=hits.normal.reshape(G, K, 3),
        barycentric=hits.barycentric.reshape(G, K, 2),
        t=hits.t.reshape(G, K),
        prim_id=hits.prim_id.reshape(G, K),
        valid=hits.valid.reshape(G, K),
    )
