"""The plain reference's ray cast: the closest hit of groups of rays that
share an origin, in plain torch.

It asks what the program's ray cast answers (for each ray the closest
triangle hit at t > 0, and a hit on a masked triangle is no hit), by
another route than any cast of the program: for each group the triangles
are projected through its origin onto a plane across the group's mean
direction, each ray becomes a point of that plane, and only the triangles
whose projected box holds a ray's point are tested, by Möller–Trumbore in
the caller's precision.  A triangle that reaches behind the origin's plane
cannot be projected; it is tested against every ray of the group.  Groups
go through in chunks, so a cast of many groups is a few passes.

Nothing here imports the program.  The matrix products go through
``common.mm``, which the control computes in TF32.
"""

from __future__ import annotations

import math

import torch

from .common import mm

# Projected depth (along a group's mean direction) below which a corner
# counts as reaching behind the origin.
_NEAR = 1e-6
_EPS = 1e-12
# Group × triangle entries a chunk holds at most.
_CHUNK = 1 << 24


def _bases(dirs, valid):
    """(G, 3, 3): rows x', y', z' of an orthonormal basis per group, z'
    along the mean direction of its valid rays."""
    unit = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    unit = torch.where(valid[..., None], unit, torch.zeros_like(unit))
    z = unit.sum(1)
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    helper = torch.zeros_like(z)
    helper.scatter_(1, torch.argmin(torch.abs(z), dim=1, keepdim=True), 1.0)
    x = torch.linalg.cross(helper, z)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.stack([x, torch.linalg.cross(z, x), z], 1)


def _moller_trumbore(o, d, a, b, c):
    """t of each ray (o, d) against each triangle (a, b, c), and whether it
    hits (t > 0, inside, not parallel); all batched alike."""
    e1, e2 = b - a, c - a
    p = torch.linalg.cross(d, e2)
    det = torch.sum(e1 * p, -1)
    scale = (torch.linalg.vector_norm(e1, dim=-1)
             * torch.linalg.vector_norm(e2, dim=-1)
             * torch.linalg.vector_norm(d, dim=-1))
    ok = torch.abs(det) > _EPS * scale
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    s = o - a
    u = torch.sum(s * p, -1) * inv
    qv = torch.linalg.cross(s, e1)
    v = torch.sum(d * qv, -1) * inv
    t = torch.sum(e2 * qv, -1) * inv
    return t, ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)


def _expand(counts):
    """For each item repeated ``counts`` times: its index and its rank in
    its run."""
    item = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    return item, torch.arange(item.numel(), device=counts.device) - first[item]


def _pairs(verts, tris, origins, dirs, valid):
    """(group, triangle, ray) triples to test for a chunk of groups."""
    C, K = valid.shape
    dev = verts.device
    B = _bases(dirs, valid)                                   # (C, 3, 3)
    Pv = mm(verts[None] - origins[:, None], B.transpose(1, 2))  # (C, V, 3)
    pz = Pv[..., 2]
    P2 = Pv[..., :2] / torch.where(pz > _NEAR, pz,
                                   torch.ones_like(pz))[..., None]
    Dr = mm(dirs, B.transpose(1, 2))
    if bool((valid & (Dr[..., 2] <= 0)).any()):
        raise ValueError("a ray leaves the half-space of its group's mean "
                         "direction")
    pts = Dr[..., :2] / torch.where(valid, Dr[..., 2],
                                    torch.ones_like(Dr[..., 2]))[..., None]
    big = torch.finfo(pts.dtype).max
    lo = torch.where(valid[..., None], pts, big).min(1).values  # (C, 2)
    hi = torch.where(valid[..., None], pts, -big).max(1).values
    cells = max(1, math.isqrt(K))
    size = (hi - lo) / cells
    size = torch.where(size > 0, size, torch.ones_like(size))
    cxy = torch.clamp(((pts - lo[:, None]) / size[:, None]).floor().long(),
                      0, cells - 1)
    g_ray = torch.arange(C, device=dev)[:, None].expand(C, K)
    ray_cell = (g_ray * cells + cxy[..., 0]) * cells + cxy[..., 1]
    ray_cell = torch.where(valid, ray_cell, C * cells * cells)
    flat = ray_cell.reshape(-1)
    order = torch.argsort(flat)
    counts = torch.bincount(flat, minlength=C * cells * cells + 1)
    starts = torch.cumsum(counts, 0) - counts

    zc = pz[:, tris] > _NEAR                                  # (C, T, 3)
    front = zc.all(-1)
    corners = P2[:, tris]                                     # (C, T, 3, 2)
    bmin, bmax = corners.min(2).values, corners.max(2).values
    over = front & (bmax >= lo[:, None]).all(-1) & \
        (bmin <= hi[:, None]).all(-1)
    g, tri = torch.nonzero(over, as_tuple=True)
    c0 = torch.clamp(((bmin[g, tri] - lo[g]) / size[g]).floor().long(), 0,
                     cells - 1)
    c1 = torch.clamp(((bmax[g, tri] - lo[g]) / size[g]).floor().long(), 0,
                     cells - 1)
    span = c1 - c0 + 1
    item, k = _expand(span[:, 0] * span[:, 1])
    cell = ((g[item] * cells + c0[item, 0] + k // span[item, 1]) * cells
            + c0[item, 1] + k % span[item, 1])
    item2, k2 = _expand(counts[cell])
    ray_flat = order[starts[cell[item2]] + k2]
    out_g, out_tri, out_ray = g[item[item2]], tri[item[item2]], ray_flat % K
    gs, ts = torch.nonzero(~front & zc.any(-1), as_tuple=True)
    if gs.numel():  # reaching behind the origin: every ray of the group
        rays = torch.arange(K, device=dev).repeat(gs.numel())
        out_g = torch.cat([out_g, gs.repeat_interleave(K)])
        out_tri = torch.cat([out_tri, ts.repeat_interleave(K)])
        out_ray = torch.cat([out_ray, rays])
    return out_g, out_tri, out_ray


def cast_groups(verts, tris, origins, dirs, valid=None, masked=None):
    """Closest hits of rays ``origins[g]`` + t·``dirs[g, k]`` ((G, 3),
    (G, K, 3); ``valid`` (G, K) marks the rays that exist) on the mesh
    (``verts`` (V, 3), ``tris`` (T, 3) int64, ``masked`` (T,) bool or
    None), in ``verts``' dtype.  Returns hit (G, K) bool, t (G, K) and the
    prim (G, K) int64, -1 where none."""
    G, K = dirs.shape[:2]
    dev, dt = verts.device, verts.dtype
    if valid is None:
        valid = torch.ones((G, K), dtype=torch.bool, device=dev)
    t_out = torch.full((G * K,), math.inf, dtype=dt, device=dev)
    first = torch.full((G * K,), torch.iinfo(torch.long).max,
                       dtype=torch.long, device=dev)
    if K and tris.shape[0]:
        step = max(1, _CHUNK // max(tris.shape[0], verts.shape[0]))
        for g0 in range(0, G, step):
            g1 = min(G, g0 + step)
            g, tri, ray = _pairs(verts, tris, origins[g0:g1], dirs[g0:g1],
                                 valid[g0:g1])
            a, b, c = (verts[tris[tri, i]] for i in range(3))
            gg = g + g0
            t, ok = _moller_trumbore(origins[gg], dirs[gg, ray], a, b, c)
            t = torch.where(ok, t, torch.full_like(t, math.inf))
            idx = gg * K + ray
            t_out.scatter_reduce_(0, idx, t, reduce="amin")
            best = ok & (t == t_out[idx])
            first.scatter_reduce_(0, idx[best], tri[best], reduce="amin")
    hit = (first != torch.iinfo(torch.long).max) & valid.reshape(-1)
    prim = torch.where(hit, first, torch.full_like(first, -1))
    if masked is not None:
        hit = hit & ~masked[torch.clamp(prim, min=0)]
    return hit.reshape(G, K), t_out.reshape(G, K), prim.reshape(G, K)


def cast_group(verts, tris, origin, dirs, masked=None):
    """:func:`cast_groups` of one group: rays ``origin`` (3,) + t·``dirs``
    (K, 3).  Returns hit (K,), t (K,), prim (K,)."""
    hit, t, prim = cast_groups(verts, tris, origin[None], dirs[None],
                               masked=masked)
    return hit[0], t[0], prim[0]

