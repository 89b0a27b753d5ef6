"""Segment-parallel trajectory refinement.

Port of ``polychase_tpu/parallel/segments.py``.  Refine-all's keyframe
segments are independent bundle adjustment problems.  Each is padded to
the stack's common frame, keypoint, edge and match counts (padded frames
repeat the segment's last frame and are anchored; padded edges and
matches are invalid, so they cost work but cannot move anything), the
stack is laid out frame-major, and the reference's device-resident LM
schedule (``engine.refiner.LockstepLM``) runs every segment's whole budget
in lockstep: one normal-equation build, one batched solve, one candidate
cost and one prim-refresh sweep for all segments per iteration.

As in the reference, the stack takes one band for its solve: the banded
one only when every segment's band is the same, else the dense one; and
the LM runs ``max_iterations + 2`` iterations with ``max_iterations``
counted ones as its budget.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import List, Sequence

import numpy as np
import torch

from ..engine import camera as C
from ..engine.geometry import Mesh
from ..engine.levmarq import BundleOptions
from ..engine.pnp import normalize_bundle_opts
from ..engine.refiner import (
    LockstepLM,
    RefinerData,
    TrajParams,
    _fields,
    build_refiner_data,
    compute_band,
    params_to_traj,
    refresh_prims,
    run_lockstep,
    segment_costs,
    traj_to_params,
)
from ..engine.trajectory import CameraTrajectory
from ..io.database import Database
from . import mesh_on, resolve_devices, shards


def _pad_to(a: torch.Tensor, dim: int, n: int, value=0) -> torch.Tensor:
    if a.shape[dim] == n:
        return a
    shape = list(a.shape)
    shape[dim] = n - a.shape[dim]
    return torch.cat([a, a.new_full(shape, value)], dim=dim)


def _pad_segment(params: TrajParams, data: RefinerData, F, K, E, M):
    """One segment's problem padded to the stack's shapes: padded frames
    repeat the last real frame and are anchored; padded keypoints, edges
    and matches are invalid."""
    f0 = int(params.q.shape[0])
    params = TrajParams(*(torch.cat([a, a[-1:].expand(F - f0, *a.shape[1:])])
                          for a in _fields(params)))
    pad_e = lambda a, v=0: _pad_to(a, 0, E, v)  # noqa: E731
    data = RefinerData(
        kps=_pad_to(_pad_to(data.kps, 0, F), 1, K),
        kp_valid=_pad_to(_pad_to(data.kp_valid, 0, F), 1, K),
        src_frame=pad_e(data.src_frame),
        tgt_frame=pad_e(data.tgt_frame),
        src_kp=_pad_to(pad_e(data.src_kp), 1, M),
        tgt_px=_pad_to(pad_e(data.tgt_px), 1, M),
        match_valid=_pad_to(pad_e(data.match_valid), 1, M),
        edge_weight=pad_e(data.edge_weight),
        edge_valid=pad_e(data.edge_valid),
        anchor=_pad_to(data.anchor, 0, F, True),
        aspect=data.aspect.expand(F),
        conv_sign=data.conv_sign.expand(F),
    )
    return params, data


def _stack(padded, bounds, F: int, device):
    """Padded segments as one frame-major problem on ``device``: segment
    s's frames at s·F + f, its edges renumbered to them."""
    params = TrajParams(*(torch.cat(parts).to(device) for parts in zip(
        *(_fields(p) for p, _ in padded))))
    def cat(name):
        parts = [getattr(d, name) for _, d in padded]
        if name in ("src_frame", "tgt_frame"):
            parts = [a + s * F for s, a in enumerate(parts)]
        return torch.cat(parts).to(device)

    data = RefinerData(**{name: cat(name)
                          for name in RefinerData.__dataclass_fields__})
    bounds = C.Bounds(*(
        torch.stack([getattr(b, f) for b in bounds]).repeat_interleave(F)
        .to(device) for f in C.Bounds.__dataclass_fields__))
    return params, data, bounds


def refine_segments(
    database,
    trajs: Sequence[CameraTrajectory],
    model_matrix,
    mesh: Mesh,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    bundle_opts: BundleOptions = BundleOptions(),
    *,
    device,
) -> List[CameraTrajectory]:
    """Refine independent, fully filled trajectory segments together;
    returns the refined copies (CPU tensors) in input order.

    ``database`` is a :class:`Database` or a path.  ``device`` is one
    device or a sequence of devices; with several, the segments are split
    into contiguous shards, one per device.  ``mesh`` is copied to each
    device that does not hold it.  Unless ``bundle_opts`` sets
    ``function_tol``, LM stops at a relative function tolerance of
    ``POLYCHASE_REFINE_FTOL`` (default 1e-5; 0 gives the reference's exits
    exactly), as ``refine_trajectory`` does.
    """
    devices = resolve_devices(device)
    if not trajs:
        return []
    for traj in trajs:
        for fid in range(traj.first_frame, traj.last_frame + 1):
            if not traj.is_frame_filled(fid):
                raise ValueError(f"frame {fid} has no pose")
    opts = normalize_bundle_opts(bundle_opts)
    if opts.function_tol == 0.0:
        ftol = float(os.environ.get("POLYCHASE_REFINE_FTOL", "1e-5"))
        if ftol > 0.0:
            opts = replace(opts, function_tol=ftol)

    cpu = torch.device("cpu")
    own_db = isinstance(database, str)
    if own_db:
        database = Database(database)
    try:
        packed = [(traj_to_params(t, device=cpu),
                   build_refiner_data(database, t, mesh, model_matrix,
                                      device=cpu))
                  for t in trajs]
    finally:
        if own_db:
            database.close()

    opt_f, opt_pp = bool(optimize_focal_length), bool(optimize_principal_point)
    ppc = 9 if (opt_f or opt_pp) else 6
    F = max(int(p.q.shape[0]) for p, _ in packed)
    K = max(int(d.kps.shape[1]) for _, d in packed)
    E = max(int(d.src_frame.shape[0]) for _, d in packed)
    M = max(int(d.src_kp.shape[1]) for _, d in packed)
    # The stack solves with one band: the segments' own when they agree.
    bands = {compute_band(d, F, ppc) for _, d in packed}
    band = bands.pop() if len(bands) == 1 else ()
    padded = [_pad_segment(p, d, F, K, E, M) for p, d in packed]
    bounds = [C.intrinsics_bounds(t.get(t.first_frame).intrinsics.to(cpu))
              for t in trajs]

    model = np.asarray(model_matrix, np.float32).reshape(4, 4)
    model_inv = np.linalg.inv(model.astype(np.float64)).astype(np.float32)
    tol = (opts.gradient_tol, opts.step_tol, opts.min_lambda,
           opts.max_lambda, opts.function_tol)
    n_iters = int(opts.max_iterations) + 2
    lms = []
    for dev, (lo, hi) in zip(devices, shards(len(trajs), len(devices))):
        params, data, bnds = _stack(padded[lo:hi], bounds[lo:hi], F, dev)
        mesh_d = mesh_on(mesh, dev)
        m, m_inv = (torch.as_tensor(a, device=dev) for a in (model,
                                                             model_inv))
        geom = (mesh_d.triangle_corners(), m, m_inv, float(opts.loss_scale))
        prims = refresh_prims(params, data, mesh_d, m_inv)
        cost = segment_costs(params, data, prims, *geom, S=hi - lo,
                             loss_type=int(opts.loss_type))
        # [cost, λ, v, rebuild, done, invalid steps, iterations, budget]
        scal = torch.stack([cost] + [
            torch.full_like(cost, v) for v in (
                opts.initial_lambda, 2.0, 1.0, 0.0, 0.0, 0.0, n_iters - 2)
        ], dim=1)
        lms.append(LockstepLM(
            params, prims, scal, data, mesh_d, m, m_inv, geom[0], geom[3],
            bnds, tol, loss_type=int(opts.loss_type), opt_f=opt_f,
            opt_pp=opt_pp, ppc=ppc, band=band))
    run_lockstep(lms, n_iters)

    out = []
    for lm, (lo, hi) in zip(lms, shards(len(trajs), len(devices))):
        fields = [a.cpu() for a in _fields(lm.params)]
        for s, traj in enumerate(trajs[lo:hi]):
            rows = slice(s * F, s * F + traj.count)
            out.append(params_to_traj(
                TrajParams(*(a[rows] for a in fields)), traj))
    return out
