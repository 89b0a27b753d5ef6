"""Faults planted in the program underneath a run, each of which a cell's
comparison with the reference has to call not correct: the harness's
tests plant them at a tiny size on the CPU, ``calibrate.py --fault`` at
the cell's own size on the card.

    with planted("track.half"):
        ...  # every run of the tracker in here drops every other ray

A name is ``<entry>.<fault>``: the entry is the program module's (the
tracker's or the refiner's), the fault one of

- ``unchanged``: a step that returns its state unchanged;
- ``half``: half of the batch left out, the mean taken over the rest;
- ``altered``: an answer altered where it is produced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib


def _track_unchanged(tr):
    solve = tr.solve_arrays_lm

    def unchanged(X, x, w, m, params, **kw):  # the warm start, unmoved
        import torch

        out = solve(X, x, w, m, params, **kw)
        return torch.cat([params[:, :11], out[:, 11:]], 1)
    return "solve_arrays_lm", unchanged


def _track_half(tr):
    cast = tr.raycast_grouped

    def half(mesh, o, d, check):  # every other ray dropped from the solve
        hits = cast(mesh, o, d, check)
        hits.valid[..., ::2] = False
        return hits
    return "raycast_grouped", half


def _track_altered(tr):
    solve = tr.solve_arrays_lm

    def altered(*a, **kw):  # each answer moved where it is produced
        out = solve(*a, **kw).clone()
        out[:, 4] += 1e-3
        return out
    return "solve_arrays_lm", altered


def _refine_unchanged(rf):
    return "apply_step", lambda params, *a, **kw: params


def _refine_half(rf):
    build = rf.build_refiner_data

    def half(*a, **kw):  # every other edge left out of the mean
        data = build(*a, **kw)
        data.edge_valid[::2] = False
        return data
    return "build_refiner_data", half


def _refine_altered(rf):
    to_traj = rf.params_to_traj

    def altered(params, traj):  # the answer moved where it is produced
        t = params.t.clone()
        t[t.shape[0] // 2, 0] += 1e-3
        return to_traj(dataclasses.replace(params, t=t), traj)
    return "params_to_traj", altered


MODULES = {"track": "polychase_tpu_torch.engine.tracker",
           "refine": "polychase_tpu_torch.engine.refiner"}
FAULTS = {"track.unchanged": _track_unchanged,
          "track.half": _track_half,
          "track.altered": _track_altered,
          "refine.unchanged": _refine_unchanged,
          "refine.half": _refine_half,
          "refine.altered": _refine_altered}


@contextlib.contextmanager
def planted(name: str):
    """The program with the fault ``name`` in place, restored after."""
    mod = importlib.import_module(MODULES[name.split(".")[0]])
    attr, fn = FAULTS[name](mod)
    was = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, was)
