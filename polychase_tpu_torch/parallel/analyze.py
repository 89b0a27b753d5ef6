"""Analyze's multi-target LK solve split over several devices.

Port of ``polychase_tpu/parallel/analyze.py:1-261``.  Every (target,
feature) pair of a solve is independent, so a solve splits over either
axis with no reduction:

- :func:`sharded_lk_multi` splits the targets: each device gets its run of
  the stacked target levels and a copy of the source levels and points;
- :func:`sharded_lk_multi_feat` splits the features, the axis that grows
  with resolution: each device gets its run of the points and a copy of the
  source and of every target level.

Each device runs ``engine.lk._lk_all_levels_multi``, which launches K2 and
K3 at every level on CUDA tensors and takes their plain versions on CPU
tensors, so the reference's XLA and Pallas variants are one function here.
The copies are queued per solve; the results are gathered on the first
device, in the unsharded call's layout.  Shards are contiguous and may be
uneven: the reference's padding of T with copies of the source and of N to
128-lane groups is TPU layout.

The chained fan (``engine.lk._chained_dispatch``) splits the features the
same way (``polychase_tpu/parallel/analyze.py:263-388``):
:func:`sharded_lk_chain_prep` runs K2 once per level on each device's shard,
and :func:`sharded_lk_chain_phase` runs one phase on every shard, each
seeded from its own shard of the earlier phases, which stay on their
devices.  The one gather on the first device follows the last phase.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from ..backend import current
from ..engine.lk import (
    Level,
    _lk_all_levels_multi,
    lk_chain_phase,
    lk_chain_prep,
)
from . import resolve_devices, shards


def _levels_on(levels: Sequence[Level], dev) -> list:
    """Prepared levels copied to ``dev`` (no copy where they lie)."""
    return [(img.to(dev, non_blocking=True), dx.to(dev, non_blocking=True),
             dy.to(dev, non_blocking=True), hw) for img, dx, dy, hw in levels]


def _gather(outs, first, dim: int):
    """The shards' (next, status, err) concatenated on ``first``."""
    return tuple(torch.cat([o[i].to(first, non_blocking=True) for o in outs],
                           dim=dim) for i in range(3))


def sharded_lk_multi(devices, prev_levels: Sequence[Level],
                     next_images_stacked: Sequence[torch.Tensor],
                     pts: torch.Tensor, eps2: float, min_eig_thr: float, *,
                     win: int, max_iters: int, levels: int):
    """The targets of ``_lk_all_levels_multi`` split contiguously over
    ``devices``: ``prev_levels`` per level (padded image, dx, dy, (H, W)),
    ``next_images_stacked`` per level (T, Hp, Wp), ``pts`` (N, 2).  Returns
    its ``(next (T, N, 2), status (T, N), err (T, N))`` on the first
    device."""
    devices = resolve_devices(devices)
    T = int(next_images_stacked[0].shape[0])
    outs = []
    for dev, (lo, hi) in zip(devices, shards(T, len(devices))):
        prev = _levels_on(prev_levels[:levels], dev)
        nxt = [s[lo:hi].to(dev, non_blocking=True)
               for s in next_images_stacked[:levels]]
        with current(dev):
            outs.append(_lk_all_levels_multi(
                prev, nxt, pts.to(dev, non_blocking=True), eps2, min_eig_thr,
                win=win, max_iters=max_iters, levels=levels))
    return _gather(outs, devices[0], 0)


def sharded_lk_multi_feat(devices, prev_levels: Sequence[Level],
                          next_images_stacked: Sequence[torch.Tensor],
                          pts: torch.Tensor, eps2: float, min_eig_thr: float,
                          *, win: int, max_iters: int, levels: int):
    """The features of ``_lk_all_levels_multi`` split contiguously over
    ``devices``; arguments and results as :func:`sharded_lk_multi`'s."""
    devices = resolve_devices(devices)
    N = int(pts.shape[0])
    outs = []
    for dev, (lo, hi) in zip(devices, shards(N, len(devices))):
        prev = _levels_on(prev_levels[:levels], dev)
        nxt = [s.to(dev, non_blocking=True)
               for s in next_images_stacked[:levels]]
        with current(dev):
            outs.append(_lk_all_levels_multi(
                prev, nxt, pts[lo:hi].to(dev, non_blocking=True), eps2,
                min_eig_thr, win=win, max_iters=max_iters, levels=levels))
    return _gather(outs, devices[0], 1)


class ChainShard(NamedTuple):
    """One device's shard of a chained fan."""

    device: torch.device
    levels: list          # the source levels, copied to the device
    pts: torch.Tensor     # (n, 2), the shard's features
    preps: list           # K2's output at every level, on the device


def sharded_lk_chain_prep(devices, prev_levels: Sequence[Level],
                          pts: torch.Tensor, *, win: int, min_eig_thr: float,
                          levels: int) -> List[ChainShard]:
    """The hoisted source prep of a chained fan with the features split
    contiguously over ``devices`` (one shard on one device): each device's
    copy of the source levels, its points and K2's output at every level."""
    devices = resolve_devices(devices)
    out = []
    for dev, (lo, hi) in zip(devices, shards(int(pts.shape[0]),
                                             len(devices))):
        prev = _levels_on(prev_levels[:levels], dev)
        p = pts[lo:hi].to(dev, non_blocking=True)
        with current(dev):
            out.append(ChainShard(dev, prev, p, lk_chain_prep(
                prev, p, win=win, min_eig_thr=min_eig_thr, levels=levels)))
    return out


def sharded_lk_chain_phase(chain: Sequence[ChainShard],
                           next_images_stacked: Sequence[torch.Tensor],
                           src_nxt: Sequence[torch.Tensor],
                           src_status: Sequence[torch.Tensor],
                           scales: torch.Tensor, *, win: int, max_iters: int,
                           eps2: float, levels: int) -> list:
    """One chained phase (T slots) on every shard of ``chain``:
    ``next_images_stacked`` per level (T, Hp, Wp), copied to each device;
    ``src_nxt[i]`` (T, n_i, 2) and ``src_status[i]`` (T, n_i) the seeding
    results of shard i, on its device; ``scales`` (T,).  Returns each
    shard's ``(next, status, err)`` on its device."""
    outs = []
    for sh, nxt_s, st_s in zip(chain, src_nxt, src_status):
        dev = sh.device
        nxt = [s.to(dev, non_blocking=True)
               for s in next_images_stacked[:levels]]
        with current(dev):
            outs.append(lk_chain_phase(
                sh.levels, sh.preps, nxt, sh.pts, nxt_s, st_s,
                scales.to(dev, non_blocking=True), win=win,
                max_iters=max_iters, eps2=eps2, levels=levels))
    return outs
