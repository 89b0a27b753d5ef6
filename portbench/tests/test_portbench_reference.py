"""The plain reference: its ray cast and its solves agree with the program
at a tiny size on the CPU, and the yardstick's bounds match a hand
count."""

import time

import numpy as np
import pytest
import torch

from portbench import bounds as B
from portbench import harness as H
from portbench.gen import scene as S
from portbench.reference import cast as RC

from tiny import tiny_cell


@pytest.mark.parametrize("n", [(24, 32), (44, 116)])
def test_cast_agrees_with_the_program(n):
    from polychase_tpu_torch.engine.geometry import Mesh
    from polychase_tpu_torch.engine.raycast import raycast_grouped

    v, t = S.uv_sphere(*n)
    mesh = Mesh.create(v, t, device="cpu")
    rng = np.random.default_rng(0)
    o = np.array([[0.1, 0.2, -4.0], [4.0, 0.0, 0.5], [0.0, 3.0, 0.2]],
                 np.float32)
    d = (rng.normal(size=(3, 400, 3)) * 0.7 - o[:, None]).astype(np.float32)
    h = raycast_grouped(mesh, torch.tensor(o), torch.tensor(d), True)
    V = torch.tensor(v, dtype=torch.float64)
    T = torch.tensor(t.astype(np.int64))
    for g in range(3):
        hit, tt, prim = RC.cast_group(V, T, torch.tensor(o[g], dtype=V.dtype),
                                      torch.tensor(d[g], dtype=V.dtype))
        valid = h.valid[g].numpy()
        assert np.array_equal(hit.numpy(), valid)
        assert np.array_equal(prim.numpy()[valid], h.prim_id[g].numpy()[valid])
        X = o[g] + d[g] * tt.numpy()[:, None]
        assert np.abs(X[valid] - h.pos[g].numpy()[valid]).max() < 2e-5


def test_cast_honours_the_mask():
    v, t = S.uv_sphere(24, 32)
    V = torch.tensor(v, dtype=torch.float64)
    T = torch.tensor(t.astype(np.int64))
    o = torch.tensor([0.0, 0.0, -4.0], dtype=V.dtype)
    d = torch.tensor([[0.01, 0.02, 1.0]], dtype=V.dtype)
    hit, _, prim = RC.cast_group(V, T, o, d)
    masked = torch.zeros(len(t), dtype=torch.bool)
    masked[int(prim)] = True
    hit2, _, prim2 = RC.cast_group(V, T, o, d, masked)
    assert hit.all() and not hit2.any() and int(prim2) == int(prim)


def test_keypoint_rays_meet_their_points():
    """The generator's points are the first hits of their own rays."""
    from portbench.reference.pnp import camera_rays

    cfg = tiny_cell("track.buddha1m").config
    sc = S.make_scene(cfg, 21)
    X, pix = S.sample_keypoints(S.Surface(sc.vertices, sc.triangles),
                                *sc.poses[5], sc.focal, sc.width, sc.height,
                                cfg["keypoints_per_frame"],
                                S.rng_for(21, 1, 5), cfg["min_facing_cos"])
    f64 = torch.float64
    q, t = (torch.tensor(a, dtype=f64) for a in sc.poses[5])
    o, d = camera_rays(q, t, sc.focal, sc.focal, sc.cx, sc.cy,
                       torch.tensor(pix, dtype=f64))
    hit, tt, _ = RC.cast_group(torch.tensor(sc.vertices, dtype=f64),
                               torch.tensor(sc.triangles.astype(np.int64)),
                               o, d)
    assert hit.all()
    got = (o + d * tt[:, None]).numpy()
    assert np.abs(got - X).max() < 1e-9


@pytest.mark.parametrize("name", ["track.buddha1m", "refine.buddha1m"])
def test_tiny_cell_is_correct(name):
    """A whole run on the CPU: the program's answers sit within the
    cell's limits of the reference's."""
    torch.set_num_threads(2)
    out = H.run_cell(tiny_cell(name), 2**31 + 99, 0.5, False,
                     torch.device("cpu"), time.perf_counter())
    assert out.result["correct"], out.result
    assert out.result["failed"] == 0 and out.result["attempted"] >= 1
    assert list(out.result)[-1] == "checks"
    for n, v, lim in out.checks:
        assert v <= lim, (n, v, lim)


def test_cast_bytes_hand_count():
    """track.buddha1m's frame of 4 groups, 8192 rays: (564 + 1) · 966
    vertices · 12 + 1,087,716 triangles · 24 + 33,992 mask words · 8 +
    4 origins · 12 + 8192 rays · (12 + 45) bytes."""
    V, T = 565 * 966, 1_087_716
    assert B.cast_bytes(V, T, -(-T // 32), 4, 8192) == (
        6_549_480 + 26_105_184 + 271_936 + 48 + 466_944)
    ms, kind = B.bound_ms(33_393_592, 0.0)
    assert kind == "bytes" and abs(ms - 33_393_592 / 3.35e12 * 1e3) < 1e-15


def test_k1_bound_hand_count():
    ms, kind = B.k1_bound(8192, 6, 4)
    assert kind == "operations"
    assert abs(ms - 5 * 8192 * 260 / 67e12 * 1e3) < 1e-15


def test_roofline_readers():
    """The readers reckon from a trace and the calls' records as their
    docstrings say, and return nothing where there is nothing to read."""
    from portbench.trace import Trace

    T = 1_087_716
    layer = {"track_frames": [(4, 8192, 4), (4, 8000, 3)],
             "mesh": (565 * 966, T, -(-T // 32))}
    tr = Trace(1.0, 0.9, {}, {"void hits_kernel<4, false>(Params)": 16.0,
                              "pnp_lm_kernel": 0.04})
    ctx = H.Ctx(tr, layer)
    cast = H.load_module(H.HERE / "metrics" / "cast_roofline.track.py")
    k1 = H.load_module(H.HERE / "metrics" / "k1_roofline.track.py")
    want = sum(B.cast_bytes(565 * 966, T, -(-T // 32), g, r)
               for g, r, _ in layer["track_frames"]) / 3.35e12 * 1e3
    assert abs(cast.read(ctx) - 100 * want / 16.0) < 1e-12
    want = (B.k1_bound(8192, 6, 4)[0] + B.k1_bound(8000, 6, 3)[0])
    assert abs(k1.read(ctx) - 100 * want / 0.04) < 1e-12
    empty = H.Ctx(Trace(1.0, 0.0, {}, {}), layer)
    assert cast.read(empty) is None and k1.read(empty) is None
    idle = H.load_module(H.HERE / "metrics" / "device_idle.track.py")
    assert abs(idle.read(ctx) - 10.0) < 1e-12
    ne = H.load_module(H.HERE / "metrics" / "refine_ne_ms.py")
    assert ne.read(ctx) is None
    rctx = H.Ctx(Trace(1.0, 0.5, {"refine.normal_equations": 30.0},
                       {"void hits_kernel<4, false>(Params)": 10.0}),
                 {"refine_calls": 2})
    assert ne.read(rctx) == 15.0
    cast_ms = H.load_module(H.HERE / "metrics" / "cast_ms.refine.py")
    assert cast_ms.read(rctx) == 5.0 and cast_ms.read(ctx) is None
