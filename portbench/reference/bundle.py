"""The plain reference of refine: bundle adjustment of a clip's cameras
against its flow edges, in plain torch.

The objective is the program's (``refine_trajectory``), written out again:

- each frame keeps the keypoints inside the mesh's bounding box as its
  start camera projects it, padded by 20 px;
- each flow i → j inside the clip is an edge, weighted 1 / (1 + the
  distance of i from the nearer end of the clip);
- a match's 3D point is where the ray of its source keypoint, from the
  source camera, first meets the mesh; its residual is that point's
  projection into the target camera minus the flow's target pixel;
- a match counts where its ray hits the mesh and the point lies in front
  of the target camera; an edge's cost is the mean robust loss of its
  counted matches, times its weight; the objective is the sum;
- every camera but the first and last moves: its rotation, translation
  and focal length (fx = aspect · fy), the principal point fixed.

Unlike the program, the reference casts every ray on every evaluation of
the cost, so it minimises the objective itself and not a cached
approximation of it.  Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import jvp

from .cast import cast_groups
from .common import levenberg_marquardt, loss, loss_weight, mm, \
    quat_to_mat, retract, rtol_for
from .pnp import camera_rays

PAD_PX = 20.0
PARAMS = 7  # rotation 3, translation 3, focal 1


@dataclass
class Cameras:
    """Every frame's camera: q (F, 4), t (F, 3), focal fy (F,); fx =
    aspect · fy; cx, cy fixed."""

    q: torch.Tensor
    t: torch.Tensor
    f: torch.Tensor

    def to(self, dtype):
        return Cameras(self.q.to(dtype), self.t.to(dtype), self.f.to(dtype))


@dataclass
class Problem:
    kps: list          # frame → (K_f, 2) kept keypoints
    kps_pad: torch.Tensor  # (F, K, 2) the same, padded
    src: torch.Tensor  # (E,) edge source frame
    tgt: torch.Tensor  # (E,)
    kp: torch.Tensor   # (E, M) index into the source frame's kept keypoints
    px: torch.Tensor   # (E, M, 2) target pixels
    used: torch.Tensor  # (E, M) bool, the match exists
    weight: torch.Tensor  # (E,)
    anchor: torch.Tensor  # (F,) bool
    aspect: float
    cx: float
    cy: float
    verts: torch.Tensor
    tris: torch.Tensor
    masked: torch.Tensor = None


def _bbox_px(q, t, fx, fy, cx, cy, lo, hi):
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                       np.float64)
    w, x, y, z = (float(v) for v in q)
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    Z = corners @ R.T + np.asarray(t, np.float64)
    p = np.stack([(fx * Z[:, 0] + cx * Z[:, 2]) / Z[:, 2],
                  (fy * Z[:, 1] + cy * Z[:, 2]) / Z[:, 2]], -1)
    return p.min(0) - PAD_PX, p.max(0) + PAD_PX


def build_problem(scene, start: Cameras, *, dtype, device,
                  masked=None) -> Problem:
    """The edges and kept keypoints of the whole clip for the cameras
    ``start`` (host float32 values, as the program reads them)."""
    F = scene.n_frames
    lo = scene.vertices.min(0).astype(np.float64)
    hi = scene.vertices.max(0).astype(np.float64)
    q = start.q.double().cpu().numpy()
    t = start.t.double().cpu().numpy()
    f = start.f.double().cpu().numpy()
    kps, remaps = [], []
    for i in range(F):
        k = scene.kps[i]
        pmin, pmax = _bbox_px(q[i], t[i], f[i], f[i], scene.cx, scene.cy,
                              lo, hi)
        inside = ((k[:, 0] > pmin[0]) & (k[:, 0] < pmax[0])
                  & (k[:, 1] > pmin[1]) & (k[:, 1] < pmax[1]))
        remap = np.full(len(k), -1, np.int64)
        remap[inside] = np.arange(int(inside.sum()))
        kps.append(torch.as_tensor(k[inside], dtype=dtype, device=device))
        remaps.append(remap)
    edges = []
    for (i, j), (idx, px) in sorted(scene.flows.items()):
        if not (0 <= i < F and 0 <= j < F) or idx.size == 0:
            continue
        new = remaps[i][idx.astype(np.int64)]
        keep = new >= 0
        if keep.any():
            edges.append((i, j, new[keep], px[keep]))
    E = len(edges)
    M = max(len(e[2]) for e in edges)
    src = np.array([e[0] for e in edges], np.int64)
    kp = np.zeros((E, M), np.int64)
    pxa = np.zeros((E, M, 2), np.float64)
    used = np.zeros((E, M), bool)
    for n, (_, _, idx, px) in enumerate(edges):
        kp[n, :len(idx)] = idx
        pxa[n, :len(idx)] = px
        used[n, :len(idx)] = True
    weight = 1.0 / (np.minimum(src, (F - 1) - src) + 1.0)
    anchor = np.zeros(F, bool)
    anchor[0] = anchor[F - 1] = True
    pad = torch.zeros((F, max(k.shape[0] for k in kps), 2), dtype=dtype,
                      device=device)
    for i, k in enumerate(kps):
        pad[i, :k.shape[0]] = k
    dev = lambda a, d=None: torch.as_tensor(a, dtype=d, device=device)  # noqa
    return Problem(
        kps=kps, kps_pad=pad, src=dev(src),
        tgt=dev(np.array([e[1] for e in edges])),
        kp=dev(kp), px=dev(pxa, dtype), used=dev(used),
        weight=dev(weight, dtype), anchor=dev(anchor), aspect=1.0,
        cx=scene.cx, cy=scene.cy,
        verts=dev(scene.vertices, dtype),
        tris=dev(scene.triangles.astype(np.int64)), masked=masked)


def cast_all(pb: Problem, cams: Cameras):
    """Every frame's kept keypoints cast from its camera, one group a
    frame: the hit mask and the prim, (F, K) padded with misses."""
    F, K = pb.kps_pad.shape[:2]
    valid = torch.arange(K, device=pb.kps_pad.device)[None] < torch.tensor(
        [k.shape[0] for k in pb.kps], device=pb.kps_pad.device)[:, None]
    o, d = camera_rays(cams.q, cams.t, pb.aspect * cams.f, cams.f, pb.cx,
                       pb.cy, pb.kps_pad)
    hit, _, prim = cast_groups(pb.verts, pb.tris, o, d, valid, pb.masked)
    return hit, prim


def _edge_residuals(pb: Problem, cams: Cameras, prim, ds, dtg):
    """Residuals (E, M, 2) and the in-front mask, with the source and
    target cameras of each edge moved by ``ds``, ``dtg`` (E, 7)."""
    s, g = pb.src, pb.tgt
    qs, ts, fs = retract(cams.q[s], ds[:, :3]), cams.t[s] + ds[:, 3:6], \
        cams.f[s] + ds[:, 6]
    qg, tg, fg = retract(cams.q[g], dtg[:, :3]), cams.t[g] + dtg[:, 3:6], \
        cams.f[g] + dtg[:, 6]
    Rs, Rg = quat_to_mat(qs), quat_to_mat(qg)
    pix = pb.kps_pad[s[:, None], pb.kp]                   # (E, M, 2)
    fxs = (pb.aspect * fs)[:, None]
    d_cam = torch.stack([(pix[..., 0] - pb.cx) / fxs,
                         (pix[..., 1] - pb.cy) / fs[:, None],
                         torch.ones_like(pix[..., 0])], -1)
    d = mm(d_cam, Rs)                                     # (E, M, 3)
    o = -mm(Rs.transpose(1, 2), ts[:, :, None])[:, :, 0]  # (E, 3)
    p = prim[s[:, None], pb.kp].clamp(min=0)
    a = pb.verts[pb.tris[p, 0]]
    n = torch.linalg.cross(pb.verts[pb.tris[p, 1]] - a,
                           pb.verts[pb.tris[p, 2]] - a)
    dn = torch.sum(d * n, -1)
    dn = torch.where(dn != 0, dn, torch.ones_like(dn))
    depth = torch.sum((a - o[:, None, :]) * n, -1) / dn
    X = o[:, None, :] + d * depth[..., None]
    Xc = mm(X, Rg.transpose(1, 2)) + tg[:, None, :]
    fxg = (pb.aspect * fg)[:, None]
    proj = torch.stack([fxg * Xc[..., 0] / Xc[..., 2] + pb.cx,
                        fg[:, None] * Xc[..., 1] / Xc[..., 2] + pb.cy], -1)
    return proj - pb.px, Xc[..., 2] >= 0


def _counted(pb: Problem, hit, front):
    return pb.used & hit[pb.src[:, None], pb.kp] & front


class Objective:
    """The objective of ``pb`` under a robust loss.  The last cast is kept,
    so the Gauss–Newton system at an accepted state does not cast it
    again."""

    def __init__(self, pb: Problem, kind: str, scale: float):
        self.pb, self.kind, self.scale = pb, kind, scale
        self._cast = (None, None)

    def _prims(self, cams):
        if self._cast[0] is not cams:
            self._cast = (cams, cast_all(self.pb, cams))
        return self._cast[1]

    def cost(self, cams: Cameras) -> float:
        """The objective at ``cams``, every ray cast anew."""
        pb = self.pb
        hit, prim = self._prims(cams)
        E = pb.src.shape[0]
        zero = torch.zeros((E, PARAMS), dtype=cams.q.dtype,
                           device=cams.q.device)
        r, front = _edge_residuals(pb, cams, prim, zero, zero)
        ok = _counted(pb, hit, front)
        r2 = torch.sum(r * r, -1)
        per = torch.where(ok, loss(self.kind, self.scale, r2),
                          torch.zeros_like(r2))
        n = torch.clamp(ok.sum(-1), min=1)
        return float((pb.weight * per.sum(-1) / n).sum())

    def system(self, cams: Cameras):
        """The Gauss–Newton matrix and gradient over the free cameras."""
        pb, kind, scale = self.pb, self.kind, self.scale
        hit, prim = self._prims(cams)
        E = pb.src.shape[0]
        F = cams.q.shape[0]
        dt, dev = cams.q.dtype, cams.q.device
        zero = torch.zeros((E, PARAMS), dtype=dt, device=dev)
        cols = []
        for side in range(2):
            for k in range(PARAMS):
                e = torch.zeros_like(zero)
                e[:, k] = 1.0
                tangents = (e, zero) if side == 0 else (zero, e)
                r, jc = jvp(lambda a, b: _edge_residuals(pb, cams, prim, a,
                                                         b)[0],
                            (zero, zero), tangents)
                cols.append(jc)
        J = torch.stack(cols, -1)                          # (E, M, 2, 14)
        _, front = _edge_residuals(pb, cams, prim, zero, zero)
        ok = _counted(pb, hit, front)
        r2 = torch.sum(r * r, -1)
        w = torch.where(ok, loss_weight(kind, scale, r2),
                        torch.zeros_like(r2))
        n = torch.clamp(ok.sum(-1), min=1).to(dt)
        scale_e = pb.weight / n
        M = J.shape[1]
        Jf = J.reshape(E, M * 2, 2 * PARAMS)
        Jw = Jf * w.repeat_interleave(2, dim=1)[:, :, None]
        A_e = mm(Jw.transpose(1, 2), Jf) * scale_e[:, None, None]
        b_e = mm(Jw.transpose(1, 2), r.reshape(E, M * 2, 1))[:, :, 0] \
            * scale_e[:, None]
        off = torch.arange(PARAMS, device=dev)
        rows = torch.cat([pb.src[:, None] * PARAMS + off,
                          pb.tgt[:, None] * PARAMS + off], 1)  # (E, 14)
        P = F * PARAMS
        A = torch.zeros((P, P), dtype=dt, device=dev)
        A.index_put_((rows[:, :, None].expand(E, 14, 14),
                      rows[:, None, :].expand(E, 14, 14)), A_e,
                     accumulate=True)
        b = torch.zeros(P, dtype=dt, device=dev)
        b.index_put_((rows,), b_e, accumulate=True)
        free = (~pb.anchor).repeat_interleave(PARAMS)
        return A[free][:, free], b[free]


def edge_cost(pb: Problem, cams: Cameras, kind: str, scale: float) -> float:
    """The objective at ``cams``, with every ray cast anew."""
    return Objective(pb, kind, scale).cost(cams)


def _step(pb: Problem, cams: Cameras, dx):
    F = cams.q.shape[0]
    full = torch.zeros(F * PARAMS, dtype=dx.dtype, device=dx.device)
    full[(~pb.anchor).repeat_interleave(PARAMS)] = dx
    d = full.reshape(F, PARAMS)
    return Cameras(retract(cams.q, d[:, :3]), cams.t + d[:, 3:6],
                   cams.f + d[:, 6])


def refine(pb: Problem, start: Cameras, kind: str, scale: float):
    """The cameras that minimise :func:`edge_cost` from ``start``, in the
    problem's dtype, and their cost."""
    obj = Objective(pb, kind, scale)
    cams, c, _ = levenberg_marquardt(
        start, obj.cost, obj.system, lambda s, dx: _step(pb, s, dx),
        rtol=rtol_for(pb.verts.dtype))
    return cams, c
