"""The entry ``api.track_sequence``: one call tracks the clip forward from
the ground-truth pose of its first frame, with the default
``BundleOptions``, and the callback stamps each frame it is handed.

End to end:

- ``track_fps``: the frames delivered in the window over the window's
  time;
- ``track_update_p90_ms``: the 90th percentile of the waits between
  updates of the artist's timeline.  Deliveries that come within one
  display frame (``update_merge_s``) of an update's first are drawn
  together, as one update; a call's first wait is counted from the call.

Correct: for a sample of the window's frames, drawn from the seed, the
reference casts the frame's flows from the source cameras the program
delivered (the first frame's is the start it was given) and solves the
frame's pose in float64.  The program's pose is judged by the excess of
its cost over the reference's least cost, relative to that least cost
(``track_excess_cost``).  That follows the program one step at a time
from its own poses; the chain itself is checked by ``track_missing``:
every call delivers every frame once, in order.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

from portbench.gen.scene import rng_for

# The tracker hands its frames to the host in runs of this many
# (``engine/tracker.py``'s ``FLUSH_FRAMES``).
FLUSH_FRAMES = 32
from portbench.reference import pnp as ref_pnp
from portbench.reference.common import tf32_products


def start_view(scene) -> np.ndarray:
    """The first frame's world→camera matrix."""
    from portbench.gen.scene import quat_to_mat

    q, t = scene.poses[0]
    view = np.eye(4)
    view[:3, :3] = quat_to_mat(q)
    view[:3, 3] = t
    return view.astype(np.float32)


class Caller:
    def __init__(self, scene, config, traffic, device, db_path, seed):
        from polychase_tpu_torch import api

        self.api = api
        self.scene, self.traffic = scene, traffic
        self.device, self.db_path = device, db_path
        self.mesh = api.AcceleratedMesh(scene.vertices, scene.triangles)
        intr = api.CameraIntrinsics(scene.focal, scene.focal, scene.cx,
                                    scene.cy, 1.0, scene.width,
                                    scene.height, api.CameraConvention.OpenCV)
        self.scene_tf = api.SceneTransformations(np.eye(4), start_view(scene),
                                                 intr)
        self.last = scene.n_frames - 1

    def call(self, index):
        from torch.profiler import record_function

        got = []

        def deliver(r):
            with record_function("bench.deliver"):
                i = r.intrinsics
                got.append((time.perf_counter(), r.frame, r.pose.q.copy(),
                            r.pose.t.copy(), (i.fx, i.fy, i.cx, i.cy),
                            r.bundle_stats.iterations))
            return True

        t0 = time.perf_counter()
        with record_function("bench.track_sequence"):
            self.api.track_sequence(self.db_path, 0, self.last, self.scene_tf,
                                    self.mesh, deliver, device=self.device)
        return {"t0": t0, "t1": time.perf_counter(), "frames": got}

    def updates(self, rec):
        merge = self.traffic["update_merge_s"]
        waits, prev, first = [], rec["t0"], None
        for stamp, *_ in rec["frames"]:
            if first is None or stamp - first >= merge:
                waits.append(stamp - prev)
                prev = first = stamp
        return waits

    def end_to_end(self, records, window_s):
        frames = sum(len(r["frames"]) for r in records)
        waits = [w for r in records for w in self.updates(r)]
        out = {"track_fps": frames / window_s}
        if len(waits) >= 2:
            out["track_update_p90_ms"] = 1e3 * statistics.quantiles(
                waits, n=10)[-1]
        return out

    def notes(self, records):
        n = sum(len(self.updates(r)) for r in records)
        return [f"timeline updates in the window: {n}"]

    def layer_context(self, records):
        """Per delivered frame: its rays (the flows into it from the frames
        tracked before it), its groups, and its PnP iterations; and the
        mesh's sizes."""
        rays = ray_counts(self.scene)
        frames = [(rays[f][0], rays[f][1], int(it))
                  for r in records for _, f, _, _, _, it in r["frames"]]
        T = self.scene.triangles.shape[0]
        return {"track_frames": frames,
                "mesh": (self.scene.vertices.shape[0], T, -(-T // 32))}

    def release(self):
        self.mesh = None


def ray_counts(scene):
    """frame → (groups, rays) of a forward pass: the flows into it from
    earlier frames."""
    out = {f: (0, 0) for f in range(scene.n_frames)}
    for (i, j), (idx, _) in scene.flows.items():
        if i < j and idx.size:
            g, n = out[j]
            out[j] = (g + 1, n + idx.size)
    return out


def _cams(rec, scene, dtype, device):
    """frame → the camera the program delivered for it in ``rec`` (the
    first frame's: the start it was given)."""
    dev = dict(dtype=dtype, device=device)
    q0, t0 = scene.poses[0]
    cams = {0: (torch.as_tensor(q0, **dev), torch.as_tensor(t0, **dev),
                scene.focal, scene.focal, scene.cx, scene.cy)}
    for _, f, q, t, intr, _ in rec["frames"]:
        cams[f] = (torch.as_tensor(q, **dev), torch.as_tensor(t, **dev),
                   *(float(v) for v in intr))
    return cams


def frame_gap(scene, rec, frame, device, control=False):
    """The excess cost of a pose of ``frame`` over the float64 reference's
    least, from the source cameras the program delivered in ``rec``: the
    program's pose, or with ``control`` the pose that the reference itself
    finds in float32 (its products in TF32 under the caller's
    ``tf32_products``)."""
    f64 = torch.float64
    verts = torch.as_tensor(scene.vertices, dtype=f64, device=device)
    tris = torch.as_tensor(scene.triangles.astype(np.int64), device=device)
    cams = _cams(rec, scene, f64, device)
    src = {i: c for i, c in cams.items() if i < frame}
    X, x, valid = ref_pnp.frame_points(scene, frame, src, verts, tris)
    q0, t0, *intr = cams[frame - 1]
    intr = tuple(intr)
    _, _, c_ref = ref_pnp.solve_pnp(X, x, valid, q0, t0, intr, "huber", 1.0)
    q, t = cams[frame][:2]
    if control:
        f32 = torch.float32
        src32 = {i: (c[0].to(f32), c[1].to(f32), *c[2:])
                 for i, c in src.items()}
        X32, x32, valid32 = ref_pnp.frame_points(scene, frame, src32,
                                                 verts.to(f32), tris)
        q, t, _ = ref_pnp.solve_pnp(X32, x32, valid32, *src32[frame - 1][:2],
                                    intr, "huber", 1.0)
    c = ref_pnp.pnp_cost(q.to(f64), t.to(f64), X, x, valid, intr, "huber",
                         1.0)
    return (c - c_ref) / c_ref


def sample(records, scene, seed, n, chunk=FLUSH_FRAMES):
    """``n`` (record index, frame) pairs drawn from the seed among the
    frames the window delivered, spread over the calls and over each
    call's flush chunks (the runs of ``chunk`` frames that reach the host
    together): pick j takes call j of a shuffled order, each call once
    before any twice, and the chunk (j + j // calls) mod chunks, so that
    the chunks take turns and every (call, chunk) pair comes before any
    comes twice; a frame of that chunk is drawn at random."""
    rng = rng_for(seed, 4)
    order = rng.permutation(len(records))
    n_chunks = -(-(scene.n_frames - 1) // chunk)
    picks = set()
    for j in range(min(n, sum(len(r["frames"]) for r in records))):
        k = int(order[j % len(order)])
        c = (j + j // len(order)) % n_chunks
        frames = [f for _, f, *_ in records[k]["frames"]
                  if (f - 1) // chunk == c and (k, f) not in picks]
        if frames:
            picks.add((k, int(frames[rng.integers(len(frames))])))
    return sorted(picks)


def missing(records, scene) -> int:
    """Frames not delivered once and in order, over every call."""
    want = list(range(1, scene.n_frames))
    bad = 0
    for r in records:
        got = [f for _, f, *_ in r["frames"]]
        bad += sum(a != b for a, b in zip(got, want))
        bad += abs(len(got) - len(want))
    return bad


def check(scene, config, traffic, records, seed, device, limits,
          control=False):
    """[(name, value, limit)] of the comparison with the reference."""
    gaps = []
    with tf32_products() if control else contextlib.nullcontext():
        for k, f in sample(records, scene, seed, traffic["check_frames"]):
            gaps.append(frame_gap(scene, records[k], f, device, control))
    return [("track_missing", float(missing(records, scene)),
             limits["track_missing"]),
            ("track_excess_cost", max(gaps) if gaps else float("inf"),
             limits["track_excess_cost"])]
