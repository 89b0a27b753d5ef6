"""The plain reference of one tracking frame: cast the rays of every flow
into the frame from its source cameras, then solve the frame's pose by
robust least squares on the reprojections, in plain torch.

``frame_points`` builds the frame's 3D–2D matches from the flow DB's
keypoints and flows and the source cameras; ``pnp_cost`` is the tracker's
objective (the sum of the robust loss of each valid match's squared
reprojection error, OpenCV convention); ``solve_pnp`` minimises it.
Nothing here imports the program.
"""

from __future__ import annotations

import torch
from torch.func import jvp

from .cast import cast_groups
from .common import levenberg_marquardt, loss, loss_weight, mm, \
    quat_to_mat, retract, rtol_for

# The residual of a point behind the camera (the program's, a finite
# stand-in for infinity).
BEHIND = 1e18


def camera_rays(q, t, fx, fy, cx, cy, pix):
    """World-space origins (…, 3) and directions (…, n, 3) of pixels
    ``pix`` (…, n, 2) seen by the cameras (q, t) (world to camera,
    OpenCV); ``fx``, ``fy`` broadcast against the cameras."""
    R = quat_to_mat(q)
    fx, fy = (torch.as_tensor(v, dtype=pix.dtype, device=pix.device)
              for v in (fx, fy))
    d_cam = torch.stack([(pix[..., 0] - cx) / fx[..., None],
                         (pix[..., 1] - cy) / fy[..., None],
                         torch.ones_like(pix[..., 0])], -1)
    o = -mm(R.transpose(-1, -2), t[..., None])[..., 0]
    return o, mm(d_cam, R)


def frame_points(scene, frame, cams: dict, verts, tris, masked=None):
    """The matches of ``frame``: for each flow into it from a frame in
    ``cams`` (frame → (q, t, fx, fy, cx, cy)), the source keypoints' rays
    cast on the mesh, one group a flow.  Returns X (N, 3), the flows'
    target pixels x (N, 2) and the hit mask (N,), in ``verts``' dtype."""
    dt, dev = verts.dtype, verts.device
    flows = [(src, scene.flows[(src, frame)]) for src in sorted(cams)
             if (src, frame) in scene.flows
             and scene.flows[(src, frame)][0].size]
    K = max(f[0].size for _, f in flows)
    G = len(flows)
    pix = torch.zeros((G, K, 2), dtype=dt, device=dev)
    valid = torch.zeros((G, K), dtype=torch.bool, device=dev)
    origins, dirs = [], []
    for g, (src, (idx, _)) in enumerate(flows):
        n = idx.size
        pix[g, :n] = torch.as_tensor(scene.kps[src][idx.astype("int64")],
                                     dtype=dt, device=dev)
        valid[g, :n] = True
        q, t, fx, fy, cx, cy = cams[src]
        o, d = camera_rays(q, t, fx, fy, cx, cy, pix[g])
        origins.append(o)
        dirs.append(d)
    o, d = torch.stack(origins), torch.stack(dirs)
    hit, tt, _ = cast_groups(verts, tris, o, d, valid, masked)
    X = o[:, None] + d * torch.where(hit, tt, torch.zeros_like(tt))[..., None]
    x = torch.zeros((G, K, 2), dtype=dt, device=dev)
    for g, (_, (idx, tgt)) in enumerate(flows):
        x[g, :idx.size] = torch.as_tensor(tgt, dtype=dt, device=dev)
    return X[valid], x[valid], hit[valid]


def _residuals(q, t, X, x, intr):
    fx, fy, cx, cy = intr
    Z = mm(X, quat_to_mat(q).T) + t
    p = torch.stack([fx * Z[:, 0] / Z[:, 2] + cx,
                     fy * Z[:, 1] / Z[:, 2] + cy], -1)
    behind = Z[:, 2] < 0
    return torch.where(behind[:, None], torch.full_like(p, BEHIND), p - x)


def pnp_cost(q, t, X, x, valid, intr, kind, scale) -> float:
    """Σ over valid matches of ρ(|reprojection error|²)."""
    r = _residuals(q, t, X, x, intr)
    r2 = torch.sum(r * r, -1)
    return float(torch.where(valid, loss(kind, scale, r2),
                             torch.zeros_like(r2)).sum())


def solve_pnp(X, x, valid, q0, t0, intr, kind, scale):
    """The pose (q, t) that minimises :func:`pnp_cost` from (q0, t0), and
    its cost.  Only the valid matches enter: a ray that missed stands at
    its camera's centre, which projects to 0 / 0 where the frame's camera
    is its source's, and a NaN in the system would stop every step."""
    dt = X.dtype
    X, x = X[valid], x[valid]
    valid = valid[valid]

    def cost(s):
        return pnp_cost(s[0], s[1], X, x, valid, intr, kind, scale)

    def system(s):
        q, t = s

        def res(delta):
            return _residuals(retract(q, delta[:3]), t + delta[3:], X, x,
                              intr)

        zero = torch.zeros(6, dtype=dt, device=X.device)
        cols = []
        for k in range(6):
            e = torch.zeros_like(zero)
            e[k] = 1.0
            r, jc = jvp(res, (zero,), (e,))
            cols.append(jc)
        J = torch.stack(cols, -1)                          # (N, 2, 6)
        r2 = torch.sum(r * r, -1)
        w = torch.where(valid, loss_weight(kind, scale, r2),
                        torch.zeros_like(r2))
        Jw = (J * w[:, None, None]).reshape(-1, 6)
        A = mm(Jw.T, J.reshape(-1, 6))
        b = mm(Jw.T, r.reshape(-1, 1))[:, 0]
        return A, b

    def step(s, dx):
        return retract(s[0], dx[:3]), s[1] + dx[3:]

    (q, t), c, _ = levenberg_marquardt((q0, t0), cost, system, step,
                                       rtol=rtol_for(dt))
    return q, t, c
