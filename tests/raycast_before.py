"""``raycast_grouped`` as its arithmetic stood before its sweep became
``sweep_plain`` and its hits ``hits_plain``: a frozen copy, with its chunk
rule of 32M-element temporaries, that the plain route is held against to
the bit on the CPU and on a card.  Imports no jax."""

import torch

from polychase_tpu_torch.engine import raycast as R
from polychase_tpu_torch.engine.pose import cross


def raycast_grouped_before(mesh, origins, dirs, check_mask=True, chunk=0):
    origins = origins.to(torch.float32).reshape(-1, 3)
    G = origins.shape[0]
    dirs = dirs.to(torch.float32).reshape(G, -1, 3)
    K = dirs.shape[1]
    dev = origins.device
    p1, p2, p3 = mesh.triangle_corners()
    num_tris = p1.shape[0]
    if chunk <= 0:
        chunk = max(64, min(4096, (1 << 25) // max(G * K, 1)))
        chunk = max(64, (chunk // 64) * 64)
        if num_tris < chunk:
            cover = 64
            while cover < num_tris:
                cover *= 2
            chunk = cover
    pad = (-num_tris) % chunk
    if pad:
        z = torch.zeros((pad, 3), dtype=p1.dtype, device=dev)
        p1, p2, p3 = (torch.cat([p, z]) for p in (p1, p2, p3))
    e1_all, e2_all = p2 - p1, p3 - p1
    best_t = torch.full((G, K), torch.inf, dtype=torch.float32, device=dev)
    best_id = torch.full((G, K), R.INVALID_ID, dtype=torch.int64, device=dev)
    d0, d1, d2 = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    lane = torch.arange(chunk, dtype=torch.int64, device=dev)
    for base in range(0, num_tris + pad, chunk):
        v0 = p1[base:base + chunk]
        e1 = e1_all[base:base + chunk]
        e2 = e2_all[base:base + chunk]
        A = cross(e2, e1)
        omv = origins[:, None, :] - v0[None]
        B = cross(e2[None], omv)
        Cq = cross(omv, e1[None])
        sdet = torch.sum(e2[None] * Cq, dim=-1)

        def dot3(x):
            x = x[:, None]
            return d0 * x[..., 0] + d1 * x[..., 1] + d2 * x[..., 2]

        det = dot3(A[None])
        udet = dot3(B)
        vdet = dot3(Cq)
        s = torch.where(det >= 0, 1.0, -1.0)
        adet = det * s
        u_, v_ = udet * s, vdet * s
        t_ = sdet[:, None, :] * s
        hit = ((adet > R._EPS) & (u_ >= 0) & (v_ >= 0) & (u_ + v_ <= adet)
               & (t_ > 0) & ((base + lane) < num_tris))
        t = torch.where(hit, t_ / torch.where(hit, adet,
                                              torch.ones_like(adet)),
                        torch.full_like(adet, torch.inf))
        j = torch.argmin(t, dim=-1)
        tj = torch.gather(t, -1, j[..., None])[..., 0]
        closer = tj < best_t
        best_id = torch.where(closer, base + j, best_id)
        best_t = torch.where(closer, tj, best_t)
    valid = best_id != R.INVALID_ID
    if check_mask:
        masked = mesh.is_triangle_masked(
            torch.where(valid, best_id, torch.zeros_like(best_id)))
        valid = valid & ~masked
    safe_id = torch.where(valid, best_id, torch.zeros_like(best_id))
    q1, q2, q3 = p1[safe_id], p2[safe_id], p3[safe_id]
    be1, be2 = q2 - q1, q3 - q1
    bomv = origins[:, None, :] - q1
    bB = cross(be2, bomv)
    bCq = cross(bomv, be1)
    bdet = torch.sum(dirs * cross(be2, be1), dim=-1)
    bdet_ok = torch.abs(bdet) > R._EPS
    valid = valid & bdet_ok
    binv = torch.where(valid, 1.0 / torch.where(bdet_ok, bdet,
                                                torch.ones_like(bdet)),
                       torch.zeros_like(bdet))
    uv = torch.stack([torch.sum(dirs * bB, dim=-1) * binv,
                      torch.sum(dirs * bCq, dim=-1) * binv], dim=-1)
    u, v = uv[..., 0], uv[..., 1]
    pos = (1.0 - u - v)[..., None] * q1 + u[..., None] * q2 + v[..., None] * q3
    ng = cross(q2 - q1, q3 - q1)
    normal = ng / torch.clamp(
        torch.linalg.vector_norm(ng, dim=-1, keepdim=True), min=1e-20)
    vm = valid[..., None]
    return R.RayHits(
        pos=torch.where(vm, pos, torch.zeros_like(pos)),
        normal=torch.where(vm, normal, torch.zeros_like(normal)),
        barycentric=torch.where(vm, uv, torch.zeros_like(uv)),
        t=torch.where(valid, best_t, torch.full_like(best_t, torch.inf)),
        prim_id=torch.where(valid, best_id,
                            torch.full_like(best_id, R.INVALID_ID)),
        valid=valid,
    )
