"""The generator: the same seed gives the same inputs, its keypoints lie on
the mesh, its spheres have the published triangle counts, and it makes a
flow DB that the program reads back."""

import numpy as np
import pytest

from portbench import harness as H
from portbench.gen import scene as S

from tiny import tiny_cell


def test_sphere_triangle_counts():
    cfg = H.read_json(H.HERE / "configs" / "hd1080-buddha1m.json")
    for n, count in ((cfg["mesh"]["uv_sphere"], 1_087_716),
                     ((44, 116), 9_976)):  # FLAME's, for its later cells
        v, t = S.uv_sphere(*n)
        assert t.shape == (count, 3)
        assert t.max() == v.shape[0] - 1
    assert cfg["mesh"]["source_triangles"] == 1_087_716


@pytest.mark.parametrize("n", [(3, 5), (24, 32), (44, 116)])
def test_sphere_matches_the_programs(n):
    from polychase_tpu_torch import synthetic

    v, t = S.uv_sphere(*n)
    v2, t2 = synthetic.uv_sphere(*n)
    assert np.array_equal(v, v2) and np.array_equal(t, t2)


def test_orbit_matches_the_programs():
    from polychase_tpu_torch import synthetic

    for (q, t), (q2, t2) in zip(S.orbit_poses(250),
                                synthetic.orbit_poses(250)):
        assert np.array_equal(q, q2) and np.array_equal(t, t2)


def test_same_seed_same_inputs():
    cfg = tiny_cell("refine.buddha1m").config
    a, b, c = (S.make_scene(cfg, s) for s in (2**31 + 5, 2**31 + 5, 6))
    assert all(np.array_equal(x, y) for x, y in zip(a.kps, b.kps))
    assert a.flows.keys() == b.flows.keys()
    for k in a.flows:
        assert np.array_equal(a.flows[k][0], b.flows[k][0])
        assert np.array_equal(a.flows[k][1], b.flows[k][1])
    assert not np.array_equal(a.kps[0], c.kps[0])


def test_keypoints_lie_on_the_mesh():
    """Each frame's keypoints: as many as the configuration asks, inside
    the frame, and their rays meet the sphere (|x| = 1 at the hit) on its
    side that faces the camera."""
    cfg = tiny_cell("track.buddha1m").config
    sc = S.make_scene(cfg, 11)
    X, pix = S.sample_keypoints(S.Surface(sc.vertices, sc.triangles),
                                *sc.poses[3], sc.focal, sc.width, sc.height,
                                cfg["keypoints_per_frame"],
                                S.rng_for(11, 1, 3), cfg["min_facing_cos"])
    assert np.allclose(pix.astype(np.float32), sc.kps[3])
    # Points on the faceted sphere lie within its chord error of radius 1.
    r = np.linalg.norm(X, axis=1)
    assert np.all(r <= 1.0 + 1e-6) and np.all(r > 0.99)
    for k in sc.kps:
        assert k.shape == (cfg["keypoints_per_frame"], 2)
        assert (k[:, 0] > 0).all() and (k[:, 0] < sc.width).all()


def test_flows_follow_the_fan_and_the_noise():
    cfg = tiny_cell("refine.buddha1m").config
    sc = S.make_scene(cfg, 12)
    n = sc.n_frames
    want = {(i, i + s) for i in range(n) for s in cfg["skips"]
            if 0 <= i + s < n}
    assert set(sc.flows) == want


def test_the_program_reads_the_db(tmp_path):
    from polychase_tpu_torch.io.database import Database

    cfg = tiny_cell("refine.buddha1m").config
    sc = S.make_scene(cfg, 13)
    S.write_db(sc, str(tmp_path / "f.db"))
    db = Database(str(tmp_path / "f.db"))
    try:
        assert np.array_equal(db.read_keypoints(4), sc.kps[4])
        f = db.read_image_pair_flow(4, 6)
        assert np.array_equal(f.src_kps_indices, sc.flows[(4, 6)][0])
        assert np.array_equal(f.tgt_kps, sc.flows[(4, 6)][1])
        assert sorted(db.find_optical_flows_from_image(4)) == sorted(
            j for i, j in sc.flows if i == 4)
    finally:
        db.close()


def test_refine_starts_are_one_stream():
    """Every run makes the same sequence of refine starts, whatever its
    seed; each call's start is a fresh draw; the ends are not moved."""
    cell = tiny_cell("refine.buddha1m")
    a = S.make_scene(cell.config, 1)
    b = S.make_scene(cell.config, 2)
    start = cell.call.start_cameras
    for i in (-1, 0, 5):
        assert np.array_equal(start(a, cell.traffic, i)[1],
                              start(b, cell.traffic, i)[1])
    t0, t1 = start(a, cell.traffic, 0)[1], start(a, cell.traffic, 1)[1]
    assert not np.array_equal(t0, t1)
    truth = np.stack([p[1] for p in a.poses])
    assert np.array_equal(t0[[0, -1]], truth[[0, -1]])


@pytest.mark.parametrize("calls,n", [(4, 16), (44, 24)])
def test_track_sample_spreads_over_calls_and_chunks(calls, n):
    """Tracking's sample takes every (call, flush chunk) pair before any
    twice, and with more calls than picks, every pick from another call."""
    from types import SimpleNamespace

    from portbench.calls import track_sequence as TS

    scene = SimpleNamespace(n_frames=120)
    records = [{"frames": [(0.0, f) for f in range(1, 120)]}
               for _ in range(calls)]
    picks = TS.sample(records, scene, 2**31 + 5, n)
    assert len(picks) == n
    cells = {(k, (f - 1) // TS.FLUSH_FRAMES) for k, f in picks}
    assert len(cells) == n
    chunks = [c for _, c in cells]
    assert all(chunks.count(c) == n // 4 for c in range(4))
    if calls >= n:
        assert len({k for k, _ in picks}) == n
    assert picks == TS.sample(records, scene, 2**31 + 5, n)
