"""SE(3) poses as quaternion + translation, with analytic Jacobians.

Port of ``polychase_tpu/engine/pose.py``.  Every function takes tensors with
arbitrary leading batch dims and keeps float32.

- Quaternions are ``(w, x, y, z)``, scalar first.
- Rotation Jacobians are taken with respect to a right-multiplicative so(3)
  perturbation, ``R(q · exp(δω)) ≈ R(q) · (I + skew(δω))``, the reference's
  ``QuatStepPost`` retraction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Pose:
    """Rigid transform ``x ↦ R(q) x + t``."""

    q: torch.Tensor  # (..., 4) quaternion, (w, x, y, z)
    t: torch.Tensor  # (..., 3) translation


# ---------------------------------------------------------------------------
# Quaternion primitives
# ---------------------------------------------------------------------------


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    # No host constant: a host→device copy would wait for the stream.
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (w, x, y, z) ordering."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting like ``jnp.cross``."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` by ``q`` with ``v + 2 w (u × v) + 2 u × (u × v)``."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → 3×3 rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3×3 rotation matrix → quaternion (w, x, y, z), branch-free.

    Shepperd's method evaluated on all four branches; the dominant one is
    selected per item (first maximum on ties, as ``jnp.argmax``)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw = torch.stack([safe_sqrt(1 + tr), m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack(
        [m21 - m12, safe_sqrt(1 + m00 - m11 - m22), m01 + m10, m02 + m20], -1
    )
    qy = torch.stack(
        [m02 - m20, m01 + m10, safe_sqrt(1 - m00 + m11 - m22), m12 + m21], -1
    )
    qz = torch.stack(
        [m10 - m01, m02 + m20, m12 + m21, safe_sqrt(1 - m00 - m11 + m22)], -1
    )

    def finish(qc, dom):
        s = qc[..., dom]
        out = qc / (2.0 * s[..., None])
        out = out.clone()
        out[..., dom] = s / 2.0
        return out

    cand = torch.stack(
        [finish(qw, 0), finish(qx, 1), finish(qy, 2), finish(qz, 3)], dim=-2
    )
    scores = torch.stack(
        [tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1
    )
    best = torch.argmax(scores, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cand, -2, idx)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def quat_exp(w_delta: torch.Tensor) -> torch.Tensor:
    """so(3) vector → unit quaternion, with the Taylor form near zero."""
    sq = torch.sum(w_delta * w_delta, dim=-1, keepdim=True)
    small = sq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angle
    cos_half = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    return torch.cat([cos_half, k * w_delta], dim=-1)


def quat_step_post(q: torch.Tensor, w_delta: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative SO(3) retraction ``q · exp(δω)``."""
    return quat_mul(q, quat_exp(w_delta))


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(*v.shape[:-1], 3, 3)


# ---------------------------------------------------------------------------
# Pose operations
# ---------------------------------------------------------------------------


def pose_apply(pose: Pose, p: torch.Tensor) -> torch.Tensor:
    """``R p + t``."""
    return quat_rotate(pose.q, p) + pose.t


def pose_rotate(pose: Pose, p: torch.Tensor) -> torch.Tensor:
    """``R p``."""
    return quat_rotate(pose.q, p)


def pose_derotate(pose: Pose, p: torch.Tensor) -> torch.Tensor:
    """``Rᵀ p``."""
    return quat_rotate(quat_conj(pose.q), p)


def pose_center(pose: Pose) -> torch.Tensor:
    """Camera center ``-Rᵀ t``."""
    return -pose_derotate(pose, pose.t)


def pose_inverse(pose: Pose) -> Pose:
    return Pose(quat_conj(pose.q), -pose_derotate(pose, pose.t))


def pose_rt4x4(pose: Pose) -> torch.Tensor:
    """4×4 homogeneous ``[R t; 0 1]``."""
    R = quat_to_mat(pose.q)
    top = torch.cat([R, pose.t[..., :, None]], dim=-1)
    bottom = torch.zeros((*top.shape[:-2], 1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def pose_from_rt(mat: torch.Tensor) -> Pose:
    """4×4 (or 3×4) rigid matrix → Pose."""
    return Pose(mat_to_quat(mat[..., :3, :3]), mat[..., :3, 3])


def pose_from_srt(mat: torch.Tensor) -> Pose:
    """Like :func:`pose_from_rt` but normalizes scaled columns."""
    R = mat[..., :3, :3]
    R = R / torch.linalg.norm(R, dim=-2, keepdim=True)
    return Pose(mat_to_quat(R), mat[..., :3, 3])


# ---------------------------------------------------------------------------
# Operations with analytic Jacobians (w.r.t. right-mult. so(3) and t)
# ---------------------------------------------------------------------------


def apply_with_jac(R: torch.Tensor, t: torch.Tensor, p: torch.Tensor):
    """``y = R p + t`` and ``(y, jac_p, jac_R, jac_t)`` with
    ``jac_R = R · skew(-p)``, ``jac_p = R``, ``jac_t = I``."""
    y = torch.einsum("...ij,...j->...i", R, p) + t
    jac_R = torch.einsum("...ij,...jk->...ik", R, skew(-p))
    jac_t = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    return y, R, jac_R, jac_t


def derotate_with_jac(R: torch.Tensor, p: torch.Tensor):
    """``y = Rᵀ p`` and ``(y, jac_p, jac_R)`` with ``jac_p = Rᵀ``,
    ``jac_R = skew(y)``."""
    Rt = R.transpose(-1, -2)
    y = torch.einsum("...ij,...j->...i", Rt, p)
    return y, Rt, skew(y)


def center_with_jac(R: torch.Tensor, t: torch.Tensor):
    """``c = -Rᵀ t`` and ``(c, jac_R, jac_t)`` with ``jac_R = skew(c)``,
    ``jac_t = -Rᵀ``."""
    Rt = R.transpose(-1, -2)
    c = -torch.einsum("...ij,...j->...i", Rt, t)
    return c, skew(c), -Rt


# ---------------------------------------------------------------------------
# Host (numpy) variants for orchestration code
# ---------------------------------------------------------------------------


def quat_to_mat_np(q) -> np.ndarray:
    """Host copy of :func:`quat_to_mat` in float64."""
    w, x, y, z = (float(v) for v in np.asarray(q).reshape(4))
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def mat_to_quat_np(m) -> np.ndarray:
    """Host rotation matrix → WXYZ quaternion (Shepperd)."""
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        w = np.sqrt(1.0 + t) / 2.0
        q = np.array([
            w,
            (m[2, 1] - m[1, 2]) / (4 * w),
            (m[0, 2] - m[2, 0]) / (4 * w),
            (m[1, 0] - m[0, 1]) / (4 * w),
        ])
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        sdiag = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k]) * 2
        q = np.empty(4)
        q[i + 1] = sdiag / 4
        q[0] = (m[k, j] - m[j, k]) / sdiag
        q[j + 1] = (m[j, i] + m[i, j]) / sdiag
        q[k + 1] = (m[k, i] + m[i, k]) / sdiag
    return q / np.linalg.norm(q)


def pose_rt4x4_np(pose: Pose) -> np.ndarray:
    """Host ``[R t; 0 1]`` in float64."""
    m = np.eye(4)
    m[:3, :3] = quat_to_mat_np(pose.q.detach().cpu().numpy())
    m[:3, 3] = pose.t.detach().cpu().numpy().astype(np.float64).reshape(3)
    return m
