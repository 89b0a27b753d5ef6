"""Pinhole camera model with analytic Jacobians, OpenGL/OpenCV conventions.

Port of ``polychase_tpu/engine/camera.py``.  The convention is carried as a
float sign ``s`` (+1 for OpenCV looking down +Z, -1 for OpenGL looking down
-Z).  ``fy`` is the free focal parameter and ``fx = aspect_ratio · fy``, so
intrinsics Jacobians are over ``(fy, cx, cy)``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..backend import as_device

OPENGL = 0  # looking at -Z
OPENCV = 1  # looking at +Z


@dataclass
class Intrinsics:
    """Pinhole intrinsics.  Each field is a float32 tensor: 0-d for one
    camera, or any shape that broadcasts against the points."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    aspect_ratio: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    sign: torch.Tensor  # +1.0 OpenCV, -1.0 OpenGL

    @staticmethod
    def create(fx, fy, cx, cy, aspect_ratio, width, height,
               convention=OPENGL, *, device) -> "Intrinsics":
        device = as_device(device)
        sign = 1.0 if convention == OPENCV else -1.0
        vals = (fx, fy, cx, cy, aspect_ratio, width, height, sign)
        return Intrinsics(
            *(torch.tensor(np.float32(v), device=device) for v in vals)
        )

    @property
    def convention(self) -> int:
        return OPENCV if float(self.sign) > 0 else OPENGL

    def to(self, device) -> "Intrinsics":
        return Intrinsics(
            *(getattr(self, f.name).to(device) for f in fields(self))
        )


@dataclass
class Bounds:
    """FOV-derived clamping bounds for the (fy, cx, cy) optimization."""

    f_low: torch.Tensor
    f_high: torch.Tensor
    cx_low: torch.Tensor
    cx_high: torch.Tensor
    cy_low: torch.Tensor
    cy_high: torch.Tensor


def intrinsics_bounds(intr: Intrinsics, min_fov_deg: float = 15.0,
                      max_fov_deg: float = 160.0) -> Bounds:
    """Focal/principal-point bounds from an FOV range.  For the OpenGL
    convention focals are negative, so the bounds flip sign."""
    f32 = dict(dtype=torch.float32, device=intr.width.device)
    min_tan = torch.tan(torch.deg2rad(torch.tensor(min_fov_deg, **f32)) / 2)
    max_tan = torch.tan(torch.deg2rad(torch.tensor(max_fov_deg, **f32)) / 2)
    half_w = intr.width / 2.0
    f_low_cv = half_w / max_tan
    f_high_cv = half_w / min_tan
    is_gl = intr.sign < 0
    f_low = torch.where(is_gl, -f_high_cv, f_low_cv)
    f_high = torch.where(is_gl, -f_low_cv, f_high_cv)
    zero = torch.zeros_like(intr.width)
    return Bounds(f_low, f_high, zero, intr.width, zero, intr.height)


def project(intr: Intrinsics, x: torch.Tensor) -> torch.Tensor:
    """Perspective projection of (..., 3) camera-space points → (..., 2)."""
    z = x[..., 2]
    return torch.stack(
        [intr.fx * x[..., 0] / z + intr.cx, intr.fy * x[..., 1] / z + intr.cy],
        dim=-1,
    )


def project_with_jac(intr: Intrinsics, x: torch.Tensor):
    """Projection and ``(p, jac_x (..., 2, 3), jac_intrin (..., 2, 3))``,
    the latter over ``(fy, cx, cy)`` with ``fx = aspect_ratio · fy``."""
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    inv_z = 1.0 / Z
    p = torch.stack(
        [intr.fx * X * inv_z + intr.cx, intr.fy * Y * inv_z + intr.cy], dim=-1
    )
    zero = torch.zeros_like(X)
    jac_x = torch.stack(
        [
            intr.fx * inv_z, zero, -intr.fx * X * inv_z * inv_z,
            zero, intr.fy * inv_z, -intr.fy * Y * inv_z * inv_z,
        ],
        dim=-1,
    ).reshape(*X.shape, 2, 3)
    one = torch.ones_like(X)
    jac_intrin = torch.stack(
        [intr.aspect_ratio * X * inv_z, one, zero, Y * inv_z, zero, one],
        dim=-1,
    ).reshape(*X.shape, 2, 3)
    return p, jac_x, jac_intrin


def unproject(intr: Intrinsics, p: torch.Tensor) -> torch.Tensor:
    """Pixel → camera-space ray direction ``s · ((px-cx)/fx, (py-cy)/fy, 1)``."""
    s = intr.sign
    return torch.stack(
        [
            s * (p[..., 0] - intr.cx) / intr.fx,
            s * (p[..., 1] - intr.cy) / intr.fy,
            torch.broadcast_to(s, p[..., 0].shape),
        ],
        dim=-1,
    )


def unproject_with_jac(intr: Intrinsics, p: torch.Tensor):
    """Unprojection and ``(d, jac_p (..., 3, 3), jac_intrin (..., 3, 3))``:
    ``jac_p`` keeps the reference's 3×3 layout with a zero third column,
    ``jac_intrin`` is over ``(fy, cx, cy)``."""
    s = intr.sign
    px, py = p[..., 0], p[..., 1]
    d = torch.stack(
        [
            s * (px - intr.cx) / intr.fx,
            s * (py - intr.cy) / intr.fy,
            torch.broadcast_to(s, px.shape),
        ],
        dim=-1,
    )
    zero = torch.zeros_like(px)
    jac_p = torch.stack(
        [
            s / intr.fx + zero, zero, zero,
            zero, s / intr.fy + zero, zero,
            zero, zero, zero,
        ],
        dim=-1,
    ).reshape(*px.shape, 3, 3)
    jac_intrin = torch.stack(
        [
            s * (intr.cx - px) / (intr.fy * intr.fy * intr.aspect_ratio),
            -s / intr.fx + zero,
            zero,
            s * (intr.cy - py) / (intr.fy * intr.fy),
            zero,
            -s / intr.fy + zero,
            zero, zero, zero,
        ],
        dim=-1,
    ).reshape(*px.shape, 3, 3)
    return d, jac_p, jac_intrin


def is_behind(intr: Intrinsics, x: torch.Tensor) -> torch.Tensor:
    """Cheirality test: behind iff ``s · z < 0``."""
    return intr.sign * x[..., 2] < 0.0


def proj_matrix_3x3(intr: Intrinsics) -> torch.Tensor:
    """The K matrix."""
    z = torch.zeros_like(intr.fx)
    o = torch.ones_like(intr.fx)
    return torch.stack(
        [intr.fx, z, intr.cx, z, intr.fy, intr.cy, z, z, o], dim=-1
    ).reshape(*intr.fx.shape, 3, 3)


# The reference's fixed near/far planes; only rows 0, 1 and 3 of the 4×4
# projection are meaningful.
_BOGUS_FAR, _BOGUS_NEAR = 100.0, 10.0


def proj_matrix_4x4(intr: Intrinsics) -> torch.Tensor:
    """4×4 projection with the reference's fixed near/far planes."""
    f, n = _BOGUS_FAR, _BOGUS_NEAR
    p22 = -(f + n) / (f - n)
    p23 = -2.0 * f * n / (f - n)
    z = torch.zeros_like(intr.fx)
    o = torch.ones_like(intr.fx)
    return torch.stack(
        [
            intr.fx, z, intr.cx, z,
            z, intr.fy, intr.cy, z,
            z, z, p22 + z, p23 + z,
            z, z, o, z,
        ],
        dim=-1,
    ).reshape(*intr.fx.shape, 4, 4)


def rescale(intr: Intrinsics, scale) -> Intrinsics:
    """Scale fx, fy, cx and cy."""
    return replace(intr, fx=intr.fx * scale, fy=intr.fy * scale,
                   cx=intr.cx * scale, cy=intr.cy * scale)


def proj_matrix_4x4_np(intr) -> np.ndarray:
    """Host float64 copy of :func:`proj_matrix_4x4`; the fields may be
    tensors or numbers."""
    f, n = _BOGUS_FAR, _BOGUS_NEAR
    fx, fy, cx, cy = (float(v) for v in (intr.fx, intr.fy, intr.cx, intr.cy))
    return np.array(
        [
            [fx, 0, cx, 0],
            [0, fy, cy, 0],
            [0, 0, -(f + n) / (f - n), -2.0 * f * n / (f - n)],
            [0, 0, 1.0, 0],
        ],
        np.float64,
    )


@dataclass
class CameraState:
    """Intrinsics + pose."""

    intrinsics: Intrinsics
    pose: "Pose"  # noqa: F821  (polychase_tpu_torch.engine.pose.Pose)
