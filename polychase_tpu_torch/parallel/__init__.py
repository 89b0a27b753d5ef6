"""Segment-parallel tracking and refine.

Port of the segment half of ``polychase_tpu/parallel``: independent
keyframe segments stacked on a leading segment axis and solved in lockstep,
one step of every segment per launch (``tracking.track_segments``,
``segments.refine_segments``).  The reference's device mesh becomes a list
of devices: the stack is split into contiguous shards, one per device, each
driven from the caller's thread (launches on different cards run
together), and gathered.  Every shard is padded to the whole stack's
shapes, so a segment's result does not depend on the split.

The sharded modules of the reference (``sharded.py``, ``analyze.py``,
``raycast.py``: one computation spread over a mesh) are not ported here.
"""

from __future__ import annotations

from dataclasses import fields
from typing import List, Tuple

import torch

from ..backend import as_device
from ..engine.geometry import Mesh


def resolve_devices(device) -> List[torch.device]:
    """One device, or a sequence of them, as a list of devices."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty list of devices")
        return [as_device(d) for d in device]
    return [as_device(device)]


def shards(S: int, n_devices: int) -> List[Tuple[int, int]]:
    """Contiguous ``[lo, hi)`` runs of S segments, one per device, the
    first ones a segment longer where S does not divide; devices beyond S
    get none."""
    base, extra = divmod(S, n_devices)
    out, lo = [], 0
    for d in range(min(S, n_devices)):
        hi = lo + base + (d < extra)
        out.append((lo, hi))
        lo = hi
    return out


def mesh_on(mesh: Mesh, device: torch.device) -> Mesh:
    """``mesh`` with its tensors on ``device``."""
    if mesh.vertices.device == device:
        return mesh
    return Mesh(*(getattr(mesh, f.name).to(device) for f in fields(mesh)))
