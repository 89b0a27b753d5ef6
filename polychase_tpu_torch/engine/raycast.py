"""Closest-hit ray casting against a triangle mesh, and the single-primitive
intersections of bundle adjustment.

Port of ``polychase_tpu/engine/raycast.py``: ``raycast_grouped`` (one shared
origin per group of rays, the hot shape), the general ``raycast`` (N rays
with their own origins), the screen-point → ray helpers, and
``intersect_ray_plane_jac`` / ``intersect_ray_triangle``.  On the TPU these
are XLA, not Pallas.  Here all are plain torch but ``raycast_grouped``,
which takes one of two routes by the mesh's triangle count
(:func:`grid_route`): below ``GRID_TRIANGLE_THRESHOLD`` the sweep, on a
card one launch of K5, a kernel of the port (``kernels/raycast_sweep.py``),
whose plain version is :func:`cast_plain` (:func:`sweep_plain`, then
:func:`hits_plain`); from it the uniform grid of ``engine/gridcast.py``
(``grid_raycast_grouped``, exact up to the order of ties; on a card one
launch of K6, ``kernels/grid_cast.py``, and ``grid_plain`` on the CPU),
with the grid built once a mesh.  The flat :func:`raycast` and the
surface's single-ray pick keep the sweep and the host BVH.

Mask semantics match the reference: the closest hit is found over all
triangles and then dropped if that triangle is masked (masked triangles
still occlude).  Triangle ids are int64 holding the reference's ``uint32``
values, with ``INVALID_ID = 0xFFFFFFFF`` on a miss.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import camera
from .geometry import Mesh, SceneTransformations, triangle_masked
from .pose import cross

INVALID_ID = 0xFFFFFFFF
_EPS = 1e-10

# Triangle count from which ``raycast_grouped`` casts through the mesh's
# uniform grid (K6 on a card) instead of the sweep (K5).  A tracking
# frame's 4 × 2048 rays on an NVIDIA H100 80GB HBM3 at 700.00 W, three
# calls of ``crossover.py`` (PERF.md, section 6): K6 took 0.017-0.034 ms
# from 1,472 to 130,560 triangles against K5's 0.019-0.97, but the grid's
# host build, spread over one 120-frame pass, costs about as much a frame
# as K5's sweep (0.4-1.6 µs a triangle, moving up to 2× between calls:
# 60.8-118.4 ms at 130,560), and K6's call holds the host 0.05-0.25 ms
# longer.  With both counted, K6 won on the device and on the call's host
# clock in every call from 399,000 triangles; at 130,560 it won in two
# calls and lost by 5% in the third, whose slower builds put the crossover
# near 150,000 on both clocks.  The same count routes the CPU's casts.
GRID_TRIANGLE_THRESHOLD = 160_000
# The grid build's limit (``gridcast.build_grid_accel`` refuses more, as the
# reference): from it the sweep casts whatever the threshold.
GRID_TRIANGLE_LIMIT = 1 << 23


@dataclass
class RayHits:
    pos: torch.Tensor  # (..., 3) hit position (object space)
    normal: torch.Tensor  # (..., 3) normalized geometric normal
    barycentric: torch.Tensor  # (..., 2) (u, v)
    t: torch.Tensor  # (...,) ray parameter
    prim_id: torch.Tensor  # (...,) int64, INVALID_ID on miss
    valid: torch.Tensor  # (...,) bool


def _moller_trumbore(origin, direction, p1, p2, p3):
    """Möller–Trumbore, broadcast over leading dims.  Returns ``(t, u, v,
    inside)``: ``inside`` is ``|det| > 1e-10`` and (u, v) within the
    triangle; the caller adds its own test on ``t``."""
    e1, e2 = p2 - p1, p3 - p1
    rce2 = cross(direction, e2)
    det = torch.sum(e1 * rce2, dim=-1)
    ok = torch.abs(det) > _EPS
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    s = origin - p1
    u = inv_det * torch.sum(s * rce2, dim=-1)
    sce1 = cross(s, e1)
    v = inv_det * torch.sum(direction * sce1, dim=-1)
    t = inv_det * torch.sum(e2 * sce1, dim=-1)
    inside = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    return t, u, v, inside


def _unmasked(words: torch.Tensor, best_id: torch.Tensor,
              check_mask: bool) -> torch.Tensor:
    """Rays with a closest hit, less those whose triangle is masked in the
    mask ``words``."""
    valid = best_id != INVALID_ID
    if check_mask:
        masked = triangle_masked(
            words, torch.where(valid, best_id, torch.zeros_like(best_id))
        )
        valid = valid & ~masked
    return valid


def _ray_hits(q1, q2, q3, uv, best_t, best_id, valid) -> RayHits:
    """The hits on triangles (q1, q2, q3) at barycentrics ``uv``, zeroed
    (t infinite, id ``INVALID_ID``) where not ``valid``."""
    u, v = uv[..., 0], uv[..., 1]
    pos = (1.0 - u - v)[..., None] * q1 + u[..., None] * q2 + v[..., None] * q3
    ng = cross(q2 - q1, q3 - q1)
    normal = ng / torch.clamp(
        torch.linalg.vector_norm(ng, dim=-1, keepdim=True), min=1e-20
    )
    vm = valid[..., None]
    return RayHits(
        pos=torch.where(vm, pos, torch.zeros_like(pos)),
        normal=torch.where(vm, normal, torch.zeros_like(normal)),
        barycentric=torch.where(vm, uv, torch.zeros_like(uv)),
        t=torch.where(valid, best_t, torch.full_like(best_t, torch.inf)),
        prim_id=torch.where(valid, best_id,
                            torch.full_like(best_id, INVALID_ID)),
        valid=valid,
    )


def raycast(mesh: Mesh, origins: torch.Tensor, dirs: torch.Tensor,
            check_mask: bool = True, chunk: int = 1024) -> RayHits:
    """Closest-hit cast of N rays, each with its own origin: ``origins`` and
    ``dirs`` (N, 3).  Triangles are swept in ``chunk``-sized blocks; the
    closest hit's barycentrics are carried through the sweep."""
    origins = origins.to(torch.float32).reshape(-1, 3)
    dirs = dirs.to(torch.float32).reshape(-1, 3)
    n = origins.shape[0]
    dev = origins.device
    p1, p2, p3 = mesh.triangle_corners()
    num_tris = p1.shape[0]
    pad = (-num_tris) % chunk
    if pad:
        z = torch.zeros((pad, 3), dtype=p1.dtype, device=dev)
        p1, p2, p3 = (torch.cat([p, z]) for p in (p1, p2, p3))

    best_t = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    best_uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    best_id = torch.full((n,), INVALID_ID, dtype=torch.int64, device=dev)
    lane = torch.arange(chunk, dtype=torch.int64, device=dev)
    for base in range(0, num_tris + pad, chunk):
        sl = slice(base, base + chunk)
        t, u, v, hit = _moller_trumbore(origins[:, None], dirs[:, None],
                                        p1[sl][None], p2[sl][None],
                                        p3[sl][None])
        hit = hit & (t > 0) & ((base + lane) < num_tris)[None, :]
        t = torch.where(hit, t, torch.full_like(t, torch.inf))
        j = torch.argmin(t, dim=-1)
        tj = torch.gather(t, -1, j[:, None])[:, 0]
        closer = tj < best_t
        uj = torch.gather(u, -1, j[:, None])[:, 0]
        vj = torch.gather(v, -1, j[:, None])[:, 0]
        best_uv = torch.where(closer[:, None], torch.stack([uj, vj], -1),
                              best_uv)
        best_id = torch.where(closer, base + j, best_id)
        best_t = torch.where(closer, tj, best_t)

    valid = _unmasked(mesh.masked_triangles, best_id, check_mask)
    safe_id = torch.where(valid, best_id, torch.zeros_like(best_id))
    return _ray_hits(p1[safe_id], p2[safe_id], p3[safe_id], best_uv, best_t,
                     best_id, valid)


def _chunk_size(num_rays: int, num_tris: int, device: torch.device) -> int:
    """Triangles per sweep step of :func:`sweep_plain`: keeps the (G, K,
    Tc) temporaries near 512K elements (2 MB) on the CPU, which swept a
    frame's 2048 rays 3-4x faster than 32M on two 8-core hosts, and near
    32M on a card, where the plain sweep is only K5's yardstick; small
    meshes take one power-of-two cover.  No id or t depends on it."""
    elements = (1 << 25) if device.type == "cuda" else (1 << 19)
    chunk = max(64, min(4096, elements // max(num_rays, 1)))
    chunk = max(64, (chunk // 64) * 64)
    if num_tris < chunk:
        cover = 64
        while cover < num_tris:
            cover *= 2
        chunk = cover
    return chunk


def sweep_plain(origins: torch.Tensor, dirs: torch.Tensor, p1: torch.Tensor,
                e1: torch.Tensor, e2: torch.Tensor, chunk: int = 0):
    """The closest-hit sweep of :func:`raycast_grouped` in plain torch: the
    plain version of K5 (``kernels/raycast_sweep.py``).

    ``origins`` (G, 3), ``dirs`` (G, K, 3), the triangles' first corners
    ``p1`` and edges ``e1 = p2 - p1``, ``e2 = p3 - p1`` (T, 3), all
    float32.  Triangles are swept in ``chunk``-sized blocks (0: sized from
    the ray count), carrying only (best t, best id).  Returns ``best_t``
    (G, K) float32, infinite on a miss, and ``best_id`` (G, K) int64
    holding the reference's ``uint32`` ids, ``INVALID_ID`` on a miss; ties
    go to the lowest id (``argmin`` takes the first minimum, and a later
    chunk must be strictly closer)."""
    G, K = dirs.shape[:2]
    dev = origins.device
    num_tris = p1.shape[0]
    if chunk <= 0:
        chunk = _chunk_size(G * K, num_tris, dev)

    pad = (-num_tris) % chunk
    if pad:
        z = torch.zeros((pad, 3), dtype=p1.dtype, device=dev)
        p1, e1, e2 = (torch.cat([p, z]) for p in (p1, e1, e2))

    best_t = torch.full((G, K), torch.inf, dtype=torch.float32, device=dev)
    best_id = torch.full((G, K), INVALID_ID, dtype=torch.int64, device=dev)
    d0, d1, d2 = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]  # (G, K, 1)
    lane = torch.arange(chunk, dtype=torch.int64, device=dev)

    for base in range(0, num_tris + pad, chunk):
        v0 = p1[base:base + chunk]
        ce1 = e1[base:base + chunk]
        ce2 = e2[base:base + chunk]
        A = cross(ce2, ce1)                           # (Tc, 3)
        omv = origins[:, None, :] - v0[None]          # (G, Tc, 3)
        B = cross(ce2[None], omv)                     # (G, Tc, 3)
        Cq = cross(omv, ce1[None])                    # (G, Tc, 3)
        sdet = torch.sum(ce2[None] * Cq, dim=-1)      # (G, Tc)

        def dot3(x):  # (G or 1, Tc, 3) → (G, K, Tc)
            x = x[:, None]
            return d0 * x[..., 0] + d1 * x[..., 1] + d2 * x[..., 2]

        det = dot3(A[None])
        udet = dot3(B)
        vdet = dot3(Cq)
        s = torch.where(det >= 0, 1.0, -1.0)
        adet = det * s
        u_, v_ = udet * s, vdet * s
        t_ = sdet[:, None, :] * s
        tri_ids = base + lane
        hit = (
            (adet > _EPS) & (u_ >= 0) & (v_ >= 0) & (u_ + v_ <= adet)
            & (t_ > 0) & (tri_ids < num_tris)
        )
        t = torch.where(
            hit, t_ / torch.where(hit, adet, torch.ones_like(adet)),
            torch.full_like(adet, torch.inf),
        )
        j = torch.argmin(t, dim=-1)
        tj = torch.gather(t, -1, j[..., None])[..., 0]
        closer = tj < best_t
        best_id = torch.where(closer, base + j, best_id)
        best_t = torch.where(closer, tj, best_t)
    return best_t, best_id


def hits_plain(origins: torch.Tensor, dirs: torch.Tensor, p1: torch.Tensor,
               p2: torch.Tensor, p3: torch.Tensor, words: torch.Tensor,
               best_t: torch.Tensor, best_id: torch.Tensor,
               check_mask: bool = True) -> RayHits:
    """The hits of :func:`raycast_grouped` after its sweep, in plain torch:
    the plain version of K5's epilogue (``kernels/raycast_sweep.py``).

    ``origins`` (G, 3), ``dirs`` (G, K, 3), the triangles' corners ``p1``,
    ``p2``, ``p3`` (T, 3), the mask ``words`` and the sweep's ``best_t``,
    ``best_id`` (G, K).  A closest hit on a masked triangle is dropped
    (masked triangles still occlude).  The winner's barycentrics are
    recomputed once per ray; this can round differently from the sweep, so
    a grazing hit whose |det| falls to eps here is folded into ``valid``:
    no valid hit carries non-finite barycentrics into the PnP solve."""
    valid = _unmasked(words, best_id, check_mask)
    safe_id = torch.where(valid, best_id, torch.zeros_like(best_id))
    q1, q2, q3 = p1[safe_id], p2[safe_id], p3[safe_id]

    be1, be2 = q2 - q1, q3 - q1
    bomv = origins[:, None, :] - q1
    bB = cross(be2, bomv)
    bCq = cross(bomv, be1)
    bdet = torch.sum(dirs * cross(be2, be1), dim=-1)
    bdet_ok = torch.abs(bdet) > _EPS
    valid = valid & bdet_ok
    binv = torch.where(
        valid, 1.0 / torch.where(bdet_ok, bdet, torch.ones_like(bdet)),
        torch.zeros_like(bdet),
    )
    uv = torch.stack([torch.sum(dirs * bB, dim=-1) * binv,
                      torch.sum(dirs * bCq, dim=-1) * binv], dim=-1)
    return _ray_hits(q1, q2, q3, uv, best_t, best_id, valid)


def cast_plain(origins: torch.Tensor, dirs: torch.Tensor,
               vertices: torch.Tensor, triangles: torch.Tensor,
               words: torch.Tensor, check_mask: bool = True,
               chunk: int = 0) -> RayHits:
    """:func:`raycast_grouped` in plain torch, the plain version of K5:
    the triangles' corners gathered, :func:`sweep_plain`, then
    :func:`hits_plain`.  ``vertices`` (V, 3), ``triangles`` (T, 3) and
    ``words`` are a :class:`Mesh`'s arrays."""
    p1 = vertices[triangles[:, 0]]
    p2 = vertices[triangles[:, 1]]
    p3 = vertices[triangles[:, 2]]
    best_t, best_id = sweep_plain(origins, dirs, p1, p2 - p1, p3 - p1, chunk)
    return hits_plain(origins, dirs, p1, p2, p3, words, best_t, best_id,
                      check_mask)


def grid_route(num_triangles: int) -> bool:
    """True where :func:`raycast_grouped` casts a mesh of ``num_triangles``
    triangles through its grid: from ``GRID_TRIANGLE_THRESHOLD`` and below
    ``GRID_TRIANGLE_LIMIT``, whatever the device."""
    return GRID_TRIANGLE_THRESHOLD <= num_triangles < GRID_TRIANGLE_LIMIT


def raycast_grouped(mesh: Mesh, origins: torch.Tensor, dirs: torch.Tensor,
                    check_mask: bool = True, chunk: int = 0) -> RayHits:
    """Closest-hit cast of G groups of K rays, one shared origin per group.

    ``origins`` (G, 3), ``dirs`` (G, K, 3).  With a shared origin every
    Möller–Trumbore triple product factors into per-triangle constants
    contracted with the direction:

        det   = d · (e2 × e1)
        u·det = d · (e2 × (o − v0))
        v·det = d · ((o − v0) × e1)
        t·det =      e2 · ((o − v0) × e1)

    The sweep carries only (best t, best id); the hit test is sign
    arithmetic on the undivided determinants, and the winner's barycentrics
    are recomputed once per ray afterwards.  Ties go to the lowest
    triangle id.  CPU tensors take :func:`cast_plain`; on a card the whole
    cast is one launch of K5 (``kernels/raycast_sweep.py``), where
    ``chunk`` (the plain version's memory knob) is not used.

    A mesh that :func:`grid_route` sends to the grid is cast instead by
    ``gridcast.grid_raycast_grouped`` through ``gridcast.mesh_grid(mesh)``,
    built at the first such cast and kept with the mesh: the same closest
    hits but for the order of exact ties and rays on a triangle's edge
    (the walk tests each ray with its own origin), with work that follows
    the cells each ray crosses instead of the triangle count.
    """
    if grid_route(mesh.num_triangles):
        from .gridcast import grid_raycast_grouped, mesh_grid

        return grid_raycast_grouped(mesh, mesh_grid(mesh), origins, dirs,
                                    check_mask)
    return sweep_grouped(mesh, origins, dirs, check_mask, chunk)


def sweep_grouped(mesh: Mesh, origins: torch.Tensor, dirs: torch.Tensor,
                  check_mask: bool = True, chunk: int = 0) -> RayHits:
    """:func:`raycast_grouped`'s sweep route, whatever the mesh's size:
    :func:`cast_plain` for CPU tensors, one launch of K5 on a card."""
    from ..kernels.raycast_sweep import raycast_hits

    origins = origins.to(torch.float32).reshape(-1, 3).contiguous()
    G = origins.shape[0]
    dirs = dirs.to(torch.float32).reshape(G, -1, 3).contiguous()
    return raycast_hits(origins, dirs, mesh.vertices, mesh.triangles,
                        mesh.masked_triangles, check_mask, chunk)


def get_ray_object_space(scene: SceneTransformations, pos: torch.Tensor):
    """Unproject pixel(s) into an object-space ray: ``(origin, direction)``."""
    mat = torch.linalg.inv(scene.view_matrix @ scene.model_matrix)
    origin = mat[:3, 3]
    direction = camera.unproject(scene.intrinsics, pos) @ mat[:3, :3].T
    return origin, direction


def get_ray_world_space(scene: SceneTransformations, pos: torch.Tensor):
    """Unproject pixel(s) into a world-space ray: ``(origin, direction)``."""
    mat = torch.linalg.inv(scene.view_matrix)
    origin = mat[:3, 3]
    direction = camera.unproject(scene.intrinsics, pos) @ mat[:3, :3].T
    return origin, direction


# ---------------------------------------------------------------------------
# Single-primitive intersections for bundle adjustment
# ---------------------------------------------------------------------------


def intersect_ray_plane_jac(origin, direction, plane_point, plane_normal):
    """Ray–plane intersection, batched over leading dims.  Returns
    ``(x, jac_origin, jac_dir, ok)`` with ``jac_origin = I − d nᵀ / (d·n)``
    and ``jac_dir = jac_origin · t``; ``ok`` is ``|d·n| > 1e-10``."""
    d_dot_n = torch.sum(direction * plane_normal, dim=-1)
    ok = torch.abs(d_dot_n) > _EPS
    safe = torch.where(ok, d_dot_n, torch.ones_like(d_dot_n))
    t = torch.sum((plane_point - origin) * plane_normal, dim=-1) / safe
    x = origin + direction * t[..., None]
    dn = (direction[..., :, None] * plane_normal[..., None, :]
          / safe[..., None, None])
    eye = torch.eye(3, dtype=direction.dtype, device=direction.device)
    jac_origin = eye - dn
    jac_dir = jac_origin * t[..., None, None]
    return x, jac_origin, jac_dir, ok


def intersect_ray_triangle(origin, direction, p1, p2, p3):
    """Single ray–triangle Möller–Trumbore, batched over leading dims.
    Returns ``(x, ok)``; a hit needs ``t >= 0`` and ``u <= 1``, unlike the
    sweeps' strict ``t > 0``."""
    t, _, _, inside = _moller_trumbore(origin, direction, p1, p2, p3)
    return origin + direction * t[..., None], inside & (t >= 0)
