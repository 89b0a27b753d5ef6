"""The batched ray cast split over several devices.

Port of ``polychase_tpu/parallel/raycast.py``.  Rays are independent, so
each device casts its contiguous shard of the ray groups against its own
copy of the mesh with the port's ``engine.raycast.raycast_grouped`` (plain
torch) and the hits are gathered on the first device: there is nothing to
reduce.  The sharded refine casts its prim refresh (one group of rays a
frame) through :func:`split_cast`, with the mesh copied to each device
once for the whole refine.
"""

from __future__ import annotations

from dataclasses import fields
from typing import List, Sequence, Union

import torch

from ..backend import current
from ..engine.geometry import Mesh
from ..engine.raycast import RayHits, raycast_grouped
from . import mesh_on, resolve_devices, shards

# The mesh, or its copy on each device.
Meshes = Union[Mesh, Sequence[Mesh]]


def _per_device(mesh: Meshes, devices) -> List[Mesh]:
    if isinstance(mesh, Mesh):
        return [mesh_on(mesh, dev) for dev in devices]
    if len(mesh) != len(devices):
        raise ValueError(f"{len(mesh)} meshes for {len(devices)} devices")
    return list(mesh)


def sharded_raycast_grouped(devices, mesh: Meshes, origins: torch.Tensor,
                            dirs: torch.Tensor,
                            check_mask: bool = True) -> RayHits:
    """Closest-hit cast of G groups of K rays, ``origins`` (G, 3) and
    ``dirs`` (G, K, 3), the groups split contiguously over ``devices``;
    the hits of ``raycast_grouped``, on the first device.  G must be a
    multiple of the device count, as in the reference."""
    devices = resolve_devices(devices)
    G = int(origins.shape[0])
    if G % len(devices):
        raise ValueError(f"group count {G} not divisible by the "
                         f"{len(devices)} devices; pad the groups")
    return split_cast(devices, _per_device(mesh, devices), origins, dirs,
                      check_mask)


def split_cast(devices, meshes: Sequence[Mesh], origins: torch.Tensor,
               dirs: torch.Tensor, check_mask: bool = True) -> RayHits:
    """``raycast_grouped`` of ``origins`` (G, 3) and ``dirs`` (G, K, 3)
    with each device's contiguous run of the groups (uneven where the
    device count does not divide G) cast on it against its mesh in
    ``meshes``, every shard queued before any result is gathered on the
    first device."""
    devices = resolve_devices(devices)
    parts = []
    for dev, m, (lo, hi) in zip(devices, meshes,
                                shards(int(origins.shape[0]), len(devices))):
        with current(dev):
            parts.append(raycast_grouped(
                m, origins[lo:hi].to(dev, non_blocking=True),
                dirs[lo:hi].to(dev, non_blocking=True),
                check_mask=check_mask))
    first = devices[0]
    return RayHits(*(torch.cat([getattr(p, f.name).to(first) for p in parts])
                     for f in fields(RayHits)))


def sharded_raycast_flat(devices, mesh: Meshes, origins: torch.Tensor,
                         dirs: torch.Tensor,
                         check_mask: bool = True) -> RayHits:
    """Cast of N single rays, ``origins`` and ``dirs`` (N, 3), split over
    ``devices``: N is padded to a multiple of the device count with dummy
    rays (origin 0, direction +z), each ray is a group of one, and the
    padding is sliced off the hits (on the first device)."""
    devices = resolve_devices(devices)
    n, n_dev = int(origins.shape[0]), len(devices)
    n_pad = -(-max(n, 1) // n_dev) * n_dev
    if n_pad != n:
        pad = n_pad - n
        origins = torch.cat([origins, origins.new_zeros((pad, 3))])
        dirs = torch.cat([dirs, dirs.new_tensor([0.0, 0.0, 1.0]).expand(
            pad, 3)])
    hits = split_cast(devices, _per_device(mesh, devices), origins,
                      dirs.reshape(n_pad, 1, 3), check_mask)
    return RayHits(*(v.reshape(n_pad, *v.shape[2:])[:n] for v in (
        getattr(hits, f.name) for f in fields(RayHits))))
