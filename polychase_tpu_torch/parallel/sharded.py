"""Refine's normal equations split over several devices by flow edge.

Port of ``polychase_tpu/parallel/sharded.py``.  Each edge's residual block,
its Jacobians and its scale (``edge_weight / n_valid``, local to the edge)
depend on that edge alone, so the dense JᵀJ / Jᵀr is a sum over edges:

- the edge-indexed fields of :class:`RefinerData` are split contiguously
  over the devices, and the rest (keypoints, anchors, aspect, sign) is
  copied to each, with the triangle corners and the model matrices, once
  per refine (:class:`EdgeShards`);
- per rebuild, the parameters and the cached prims cross to each device,
  each device builds the dense system of its edges with
  ``engine.refiner.build_normal_equations``, and the partial systems come
  back to the first device and are summed there in device order, the
  reference's ``psum``: one device list always gives one answer.

The reference pads the edges to a multiple of the mesh size
(``_pad_edges_to``), TPU layout; contiguous uneven shards need none.
"""

from __future__ import annotations

from dataclasses import fields

import torch

from ..backend import current
from ..engine.refiner import (
    RefinerData,
    TrajParams,
    _fields,
    apply_step,
    build_normal_equations,
    solve_step,
)
from . import resolve_devices, shards

# The fields of RefinerData indexed by edge (the reference's _EDGE_FIELDS,
# polychase_tpu/engine/refiner.py:1045-1050).
EDGE_FIELDS = frozenset(("src_frame", "tgt_frame", "src_kp", "tgt_px",
                         "match_valid", "edge_weight", "edge_valid"))


class EdgeShards:
    """One refine problem's edges split over ``devices``, with what each
    device needs besides: made once, used for every rebuild."""

    def __init__(self, devices, data: RefinerData, tri_corners, model,
                 model_inv):
        self.devices = resolve_devices(devices)
        E = int(data.src_frame.shape[0])
        self.parts = []
        for dev, (lo, hi) in zip(self.devices, shards(E, len(self.devices))):
            local = RefinerData(**{
                f.name: (getattr(data, f.name)[lo:hi]
                         if f.name in EDGE_FIELDS
                         else getattr(data, f.name)).to(dev)
                for f in fields(RefinerData)})
            self.parts.append((dev, local, tuple(c.to(dev)
                                                 for c in tri_corners),
                               model.to(dev), model_inv.to(dev)))

    def normal_equations(self, params: TrajParams, prims: torch.Tensor,
                         loss_scale, *, loss_type: int, opt_f: bool,
                         opt_pp: bool, ppc: int):
        """Dense JᵀJ (P, P) and Jᵀr (P,) of all edges on the first device:
        every device's partial system queued, then summed in device
        order."""
        partial = []
        for dev, data, tri, model, model_inv in self.parts:
            p = TrajParams(*(a.to(dev, non_blocking=True)
                             for a in _fields(params)))
            with current(dev):
                partial.append(build_normal_equations(
                    p, data, prims.to(dev, non_blocking=True), tri, model,
                    model_inv, loss_scale, loss_type=loss_type, opt_f=opt_f,
                    opt_pp=opt_pp, ppc=ppc))
        first = self.devices[0]
        JtJ, Jtr = partial[0]
        for a, b in partial[1:]:
            JtJ = JtJ.add_(a.to(first, non_blocking=True))
            Jtr = Jtr.add_(b.to(first, non_blocking=True))
        return JtJ, Jtr


def sharded_normal_equations(devices, params: TrajParams, data: RefinerData,
                             prims, tri_corners, model, model_inv,
                             loss_scale, *, loss_type: int, opt_f: bool,
                             opt_pp: bool, ppc: int):
    """JᵀJ / Jᵀr with the edges split over ``devices``, summed on the
    first device (one :class:`EdgeShards` build, then one rebuild)."""
    return EdgeShards(devices, data, tri_corners, model,
                      model_inv).normal_equations(
        params, prims, loss_scale, loss_type=loss_type, opt_f=opt_f,
        opt_pp=opt_pp, ppc=ppc)


def sharded_refine_step(devices, params: TrajParams, data: RefinerData,
                        prims, tri_corners, model, model_inv, loss_scale,
                        lam: float, bounds, *, loss_type: int, opt_f: bool,
                        opt_pp: bool, ppc: int):
    """One damped Gauss-Newton step of the sharded refine: the sharded
    system, the dense damped Cholesky solve and the step of every
    non-anchor camera, on the first device.  Returns ``(new_params,
    step_norm, ok)``."""
    JtJ, Jtr = sharded_normal_equations(
        devices, params, data, prims, tri_corners, model, model_inv,
        loss_scale, loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp, ppc=ppc)
    step, ok = solve_step(JtJ, Jtr, lam, ())
    new_params = apply_step(params, data, step, bounds, opt_f=opt_f,
                            opt_pp=opt_pp, ppc=ppc)
    return new_params, torch.linalg.vector_norm(step), ok
