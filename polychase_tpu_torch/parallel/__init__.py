"""Work split over several devices.

Port of ``polychase_tpu/parallel``.  The reference's device mesh becomes a
list of devices (:func:`resolve_devices`): the split axis is cut into
contiguous shards, one per device (:func:`shards`), one host thread queues
every shard's work (launches on different cards run together), and the
results are gathered, or summed in device order, on the first device, which
stands in for the reference's ``psum``.  A device may appear more than once,
so ``["cpu"] * 4`` on the CPU and ``["cuda:0", "cuda:0"]`` on one card run
the split.

- Segment-parallel (``tracking.track_segments``,
  ``segments.refine_segments``): independent keyframe segments stacked on a
  leading segment axis and solved in lockstep, one step of every segment
  per launch.  Every shard is padded to the whole stack's shapes, so a
  segment's result does not depend on the split.
- Sharded (``raycast``, ``sharded``, ``analyze``): one computation spread
  over the devices: the ray cast over its ray groups, refine's normal
  equations over the flow edges, analyze's LK solve over its targets or its
  features, and the chained skip fan's phases over its features.  ``engine.refiner.refine_trajectory`` and
  ``engine.opticalflow.generate_optical_flow_database`` take them when
  given several devices.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..backend import as_device
from ..engine.geometry import Mesh


def resolve_devices(device) -> List[torch.device]:
    """One device, or a sequence of them, as a list of devices.  A list
    that mixes the CPU and CUDA devices raises ``ValueError``."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty list of devices")
        devices = [as_device(d) for d in device]
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"a list of devices mixes kinds: {devices}")
        return devices
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
    """``mesh`` with its tensors on ``device``.  Where its cast takes the
    grid (``engine.raycast.grid_route``), the grid goes with it: built once
    on ``mesh`` (``gridcast.mesh_grid``) and copied, never rebuilt on
    ``device``."""
    if mesh.vertices.device == device:
        return mesh
    from ..engine.gridcast import mesh_grid
    from ..engine.raycast import grid_route

    grid = (mesh_grid(mesh).to(device) if grid_route(mesh.num_triangles)
            else None)
    return Mesh(mesh.vertices.to(device), mesh.triangles.to(device),
                mesh.masked_triangles.to(device), mesh.bbox_min.to(device),
                mesh.bbox_max.to(device), grid)
