"""The entry ``api.refine_trajectory``: one call bundle-adjusts the whole
clip from the ground truth with every translation but the first and last
frame's noised by N(0, ``t_sigma``), a fresh draw each call; the focal
length is free, the loss and its scale and the iteration cap are the
mix's.  The draws come from the mix's ``start_stream`` and not from the
seed: how many LM iterations a call takes depends on its start, so every
run makes the same sequence of starts and only the scene changes with the
seed.

End to end: ``refine_s``, the window's time over the calls it completed
(the last runs to its end inside the window).

Correct: for a sample of the window's calls, drawn from the seed, the
reference minimises the same objective from the same start in float64,
casting every ray anew at each evaluation.  The program's refined cameras
are judged by the excess of their cost over the reference's least cost,
relative to that least cost (``refine_excess_cost``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.gen.scene import rng_for
from portbench.reference import bundle as ref
from portbench.reference.common import tf32_products


def start_cameras(scene, traffic, index):
    """The start of call ``index``: (q (F, 4), t (F, 3), f (F,)) float32."""
    F = scene.n_frames
    q = np.stack([p[0] for p in scene.poses]).astype(np.float32)
    t = np.stack([p[1] for p in scene.poses]).astype(np.float32)
    noise = rng_for(traffic["start_stream"], 3, index + 1).normal(
        0.0, traffic["t_sigma"], (F, 3)).astype(np.float32)
    noise[0] = noise[F - 1] = 0.0
    return q, t + noise, np.full(F, scene.focal, np.float32)


class Caller:
    def __init__(self, scene, config, traffic, device, db_path, seed):
        from polychase_tpu_torch import api

        self.api = api
        self.scene, self.traffic = scene, traffic
        self.device, self.db_path = device, db_path
        self.mesh = api.AcceleratedMesh(scene.vertices, scene.triangles)
        opts = api.BundleOptions()
        opts.loss_type = getattr(api.LossType, traffic["loss"])
        opts.loss_scale = traffic["loss_scale"]
        opts.max_iterations = traffic["max_iterations"]
        self.opts = opts

    def trajectory(self, index):
        api, s = self.api, self.scene
        q, t, f = start_cameras(s, self.traffic, index)
        traj = api.CameraTrajectory(0, s.n_frames)
        for i in range(s.n_frames):
            intr = api.CameraIntrinsics(f[i], f[i], s.cx, s.cy, 1.0, s.width,
                                        s.height, api.CameraConvention.OpenCV)
            traj.set(i, api.CameraState(intr, api.Pose(q[i], t[i])))
        return traj

    def call(self, index):
        from torch.profiler import record_function

        traj = self.trajectory(index)
        t0 = time.perf_counter()
        with record_function("bench.refine_trajectory"):
            self.api.refine_trajectory(
                self.db_path, traj, np.eye(4, dtype=np.float32), self.mesh,
                self.traffic["optimize_focal_length"],
                self.traffic["optimize_principal_point"], None, self.opts,
                device=self.device)
        t1 = time.perf_counter()
        states = [traj.get(i) for i in range(self.scene.n_frames)]
        out = (np.stack([s.pose.q for s in states]),
               np.stack([s.pose.t for s in states]),
               np.array([s.intrinsics.fy for s in states], np.float32))
        return {"index": index, "t0": t0, "t1": t1, "out": out}

    def end_to_end(self, records, window_s):
        return {"refine_s": window_s / max(len(records), 1)}

    def notes(self, records):
        return [f"refine calls in the window: {len(records)}"]

    def layer_context(self, records):
        return {"refine_calls": len(records)}

    def release(self):
        self.mesh = None


def _cams(q, t, f, dtype, device):
    dev = dict(dtype=dtype, device=device)
    return ref.Cameras(torch.as_tensor(q, **dev), torch.as_tensor(t, **dev),
                       torch.as_tensor(f, **dev))


def call_gap(scene, traffic, rec, device, control=False):
    """The excess cost of the call's refined cameras (or, with
    ``control``, of the reference's own in float32 with its products in
    TF32) over the float64 reference's least, from the call's start."""
    f64 = torch.float64
    kind, scale = traffic["loss"].lower(), traffic["loss_scale"]
    start = start_cameras(scene, traffic, rec["index"])
    pb = ref.build_problem(scene, _cams(*start, f64, "cpu"), dtype=f64,
                           device=device)
    _, c_ref = ref.refine(pb, _cams(*start, f64, device), kind, scale)
    if control:
        f32 = torch.float32
        pb32 = ref.build_problem(scene, _cams(*start, f64, "cpu"), dtype=f32,
                                 device=device)
        with tf32_products():
            got, _ = ref.refine(pb32, _cams(*start, f32, device), kind, scale)
        got = got.to(f64)
    else:
        got = _cams(*rec["out"], f64, device)
    c = ref.edge_cost(pb, got, kind, scale)
    return (c - c_ref) / c_ref


def sample(records, seed, n):
    rng = rng_for(seed, 4)
    pick = rng.choice(len(records), size=min(n, len(records)), replace=False)
    return [records[i] for i in sorted(pick)]


def check(scene, config, traffic, records, seed, device, limits,
          control=False):
    """[(name, value, limit)] of the comparison with the reference."""
    gaps = [call_gap(scene, traffic, rec, device, control)
            for rec in sample(records, seed, traffic["check_calls"])]
    return [("refine_excess_cost", max(gaps) if gaps else float("inf"),
             limits["refine_excess_cost"])]
