"""Triangle meshes with packed per-triangle mask bits, scene transforms.

Port of ``polychase_tpu/engine/geometry.py``.  Torch has little ``uint32``
arithmetic, so the packed mask words and the triangle indices are held as
int64 tensors that carry the unsigned 32-bit values; ``to_numpy_mask``
turns the words back into the reference's ``uint32`` layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..backend import as_device


@dataclass
class Bbox3:
    pmin: torch.Tensor  # (3,)
    pmax: torch.Tensor  # (3,)

    def contains(self, p: torch.Tensor) -> torch.Tensor:
        return torch.all((p > self.pmin) & (p < self.pmax), dim=-1)


@dataclass
class Bbox2:
    pmin: torch.Tensor  # (2,)
    pmax: torch.Tensor  # (2,)

    def contains(self, p: torch.Tensor) -> torch.Tensor:
        return torch.all((p > self.pmin) & (p < self.pmax), dim=-1)


def mask_array_size(num_triangles: int) -> int:
    """Packed-u32 mask length padded to a uvec4 multiple."""
    n = (num_triangles + 31) // 32
    return n + (4 - n % 4) % 4


def triangle_masked(words: torch.Tensor,
                    tri_idx: torch.Tensor) -> torch.Tensor:
    """Vectorized bit test of triangle ids (int64 tensor) in the packed
    mask ``words``."""
    elem = words[tri_idx // 32]
    return ((elem >> (tri_idx % 32)) & 1) != 0


@dataclass
class Mesh:
    """Triangle mesh + packed triangle mask bits.

    ``vertices`` (V, 3) float32; ``triangles`` (T, 3) int64;
    ``masked_triangles`` (ceil(T/32) padded to 4,) int64 holding u32 words;
    ``bbox_min``/``bbox_max`` (3,) float32.
    """

    vertices: torch.Tensor
    triangles: torch.Tensor
    masked_triangles: torch.Tensor
    bbox_min: torch.Tensor
    bbox_max: torch.Tensor

    @staticmethod
    def create(vertices, triangles, masked_triangles=None, *,
               device) -> "Mesh":
        device = as_device(device)
        v = torch.as_tensor(
            np.array(vertices, np.float32).reshape(-1, 3), device=device
        )
        t = torch.as_tensor(
            np.asarray(triangles, np.uint32).reshape(-1, 3).astype(np.int64),
            device=device,
        )
        size = mask_array_size(int(t.shape[0]))
        if masked_triangles is None or np.size(masked_triangles) == 0:
            words = np.zeros((size,), np.int64)
        else:
            words = np.asarray(masked_triangles, np.uint32).astype(np.int64)
            if words.shape[0] < size:
                raise ValueError(
                    f"masked_triangles too short: {words.shape[0]} < {size}"
                )
        if v.shape[0]:
            lo, hi = v.min(dim=0).values, v.max(dim=0).values
        else:
            lo = hi = torch.zeros(3, dtype=torch.float32, device=device)
        return Mesh(v, t, torch.as_tensor(words, device=device), lo, hi)

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])

    @property
    def bbox(self) -> Bbox3:
        return Bbox3(self.bbox_min, self.bbox_max)

    def triangle_corners(self):
        """Per-triangle corner positions → three (T, 3) tensors."""
        v, t = self.vertices, self.triangles
        return v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]

    def is_triangle_masked(self, tri_idx: torch.Tensor) -> torch.Tensor:
        """Vectorized bit test of triangle ids (int64 tensor)."""
        return triangle_masked(self.masked_triangles, tri_idx)

    def to_numpy_mask(self) -> np.ndarray:
        """The mask words in the reference's ``uint32`` layout."""
        return self.masked_triangles.cpu().numpy().astype(np.uint32)


def set_mask_bits(masked: np.ndarray, tri_idx: int, op: str) -> np.ndarray:
    """Host mask, unmask or toggle of one triangle's bit in ``uint32``
    words; returns a new array."""
    masked = np.asarray(masked, np.uint32).copy()
    elem, bit = tri_idx // 32, np.uint32(1) << np.uint32(tri_idx % 32)
    if op == "mask":
        masked[elem] |= bit
    elif op == "unmask":
        masked[elem] &= ~bit
    elif op == "toggle":
        masked[elem] ^= bit
    else:
        raise ValueError(op)
    return masked


@dataclass
class SceneTransformations:
    """Model matrix + view matrix + intrinsics."""

    model_matrix: torch.Tensor  # (4, 4) object→world
    view_matrix: torch.Tensor  # (4, 4) world→camera
    intrinsics: "Intrinsics"  # noqa: F821


# TransformationType
TRANSFORM_CAMERA = 0
TRANSFORM_MODEL = 1


def transform_points(mat4: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a homogeneous 4×4 to (..., 3) points."""
    return pts @ mat4[:3, :3].T + mat4[:3, 3]


def transform_bbox(bbox: Bbox3, mat4: torch.Tensor) -> Bbox2:
    """The 2D extent of the 8 bbox corners through a 4×4, divided by w."""
    lo, hi = bbox.pmin, bbox.pmax
    corners = torch.stack(
        [
            torch.stack([x, y, z])
            for x in (lo[0], hi[0])
            for y in (lo[1], hi[1])
            for z in (lo[2], hi[2])
        ]
    )
    hom = torch.cat([corners, torch.ones_like(corners[:, :1])], dim=-1)
    hom = hom @ mat4.T
    xy = hom[:, :2] / hom[:, 3:4]
    return Bbox2(xy.min(dim=0).values, xy.max(dim=0).values)
