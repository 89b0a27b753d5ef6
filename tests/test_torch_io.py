"""The port's own copies of the JAX package's jax-free host modules, held
against the originals: the SQLite flow DB (``polychase_tpu_torch.io.
database``), whose files either package must read row for row, and the host
C++ (``polychase_tpu_torch.native``), whose BVH and GFTT suppression must
give the originals' results."""

import ctypes

import numpy as np
import pytest

from polychase_tpu import native as JN
from polychase_tpu.io import database as JD

from polychase_tpu_torch import native as TN
from polychase_tpu_torch.engine import gftt as TG
from polychase_tpu_torch.io import database as TD


def _fill(db, rng, frames=5):
    """Keypoints for every frame and flows of skips ±1, ±2; returns what
    was written."""
    kps, flows = {}, {}
    with db.deferred_commits():
        for f in range(frames):
            kps[f] = rng.uniform(0, 1920, (int(rng.integers(0, 40)), 2)
                                 ).astype(np.float32)
            db.write_keypoints(f, kps[f])
        for f in range(frames):
            for s in (-2, -1, 1, 2):
                if not 0 <= f + s < frames:
                    continue
                n = kps[f].shape[0]
                idx = np.sort(rng.choice(n, size=n // 2, replace=False))
                flows[(f, f + s)] = (
                    idx.astype(np.uint32),
                    rng.normal(0, 500, (idx.size, 2)).astype(np.float32),
                    rng.uniform(0, 3, idx.size).astype(np.float32),
                )
                db.write_image_pair_flow(f, f + s, *flows[(f, f + s)])
    return kps, flows


def _check(db, kps, flows):
    assert db.get_min_image_id_with_keypoints() == min(kps)
    assert db.get_max_image_id_with_keypoints() == max(kps)
    for f, want in kps.items():
        assert db.keypoints_exist(f)
        got = db.read_keypoints(f)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for (f, t), (idx, tgt, err) in flows.items():
        assert db.image_pair_flow_exists(f, t)
        fl = db.read_image_pair_flow(f, t)
        assert (fl.image_id_from, fl.image_id_to) == (f, t)
        np.testing.assert_array_equal(fl.src_kps_indices, idx)
        np.testing.assert_array_equal(fl.tgt_kps, tgt)
        np.testing.assert_array_equal(fl.flow_errors, err)
    for f in kps:
        assert sorted(db.find_optical_flows_from_image(f)) == sorted(
            t for (s, t) in flows if s == f)
    ranged = db.read_flows_to_image_range(0, max(kps))
    assert sum(len(v) for v in ranged.values()) == len(flows)
    assert not db.keypoints_exist(max(kps) + 1)
    assert db.read_image_pair_flow(0, 99).src_kps_indices.size == 0


@pytest.mark.parametrize("writer,reader", [(JD, TD), (TD, JD)],
                         ids=["jax_writes", "port_writes"])
def test_database_files_cross_between_packages(tmp_path, writer, reader):
    """A DB written by one package reads back row for row in the other."""
    path = str(tmp_path / "flow.db")
    db = writer.Database(path)
    try:
        kps, flows = _fill(db, np.random.default_rng(0))
    finally:
        db.close()
    db = reader.Database(path)
    try:
        _check(db, kps, flows)
    finally:
        db.close()


def test_database_flow_dataclass_round_trip(tmp_path):
    """``ImagePairFlow`` rows, written whole and overwritten, as the JAX
    package stores them."""
    path = str(tmp_path / "flow.db")
    with TD.Database(path) as db:
        db.write_keypoints(3, np.ones((4, 2), np.float32))
        db.write_keypoints(4, np.ones((2, 2), np.float32))
        fl = TD.ImagePairFlow(3, 4, np.arange(4, dtype=np.uint32),
                              np.full((4, 2), 7.0, np.float32),
                              np.zeros(4, np.float32))
        db.write_image_pair_flow(fl)
        fl.tgt_kps = fl.tgt_kps + 1.0
        db.write_image_pair_flow(fl)
    with JD.Database(path) as db:
        got = db.read_image_pair_flow(3, 4)
        np.testing.assert_array_equal(got.tgt_kps, np.full((4, 2), 8.0))
        assert db.find_optical_flows_to_image(4) == [3]
    assert TD.INVALID_ID == JD.INVALID_ID


def test_native_library_builds_under_build_dir():
    """The port's host library builds at first use into build/torch_native
    under a name keyed by its source, never into the package."""
    assert TN.available()
    path = TN.library_path()
    assert path.exists() and path.parent == TN.BUILD_DIR
    assert path.parent.name == "torch_native"
    assert TN.SOURCE.parent.parent.name == "polychase_tpu_torch"
    assert not list(TN.SOURCE.parent.glob("*.so"))


@pytest.mark.parametrize("md,mc", [(5.0, 0), (3.0, 50), (0.0, 30)])
def test_native_sort_suppress_matches_jax_package(rng, md, mc):
    """``gftt_sort_suppress`` of the port's library gives the JAX package's
    accepted candidates in the same order, ties included."""
    if not JN.available():
        pytest.skip("the JAX package's native library is unavailable")
    tile = rng.random((12, 16)).astype(np.float32)
    vals = np.tile(tile, (4, 5)).reshape(-1)
    lin = rng.permutation(vals.size).astype(np.int64)
    w, h = 80, 48
    fn = JN.native_fn("gftt_sort_suppress", ctypes.c_uint32, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_float, ctypes.c_int32, ctypes.c_void_p])
    out = np.empty(vals.size, np.uint32)
    count = fn(vals.ctypes.data_as(ctypes.c_void_p),
               lin.ctypes.data_as(ctypes.c_void_p), vals.size, w, h, md, mc,
               out.ctypes.data_as(ctypes.c_void_p))
    got = TG._native_sort_suppress(vals, lin, w, h, md, mc)
    np.testing.assert_array_equal(got, out[:count])


def test_native_bvh_matches_jax_package(rng):
    """The port's BVH hits the JAX package's prims, with its masked-triangle
    rule, on a random soup of triangles."""
    if not JN.available():
        pytest.skip("the JAX package's native library is unavailable")
    verts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    tris = rng.integers(0, 300, (200, 3)).astype(np.uint32)
    origins = np.tile(np.array([[0.0, 0.0, -4.0]], np.float32), (512, 1))
    dirs = np.concatenate([rng.uniform(-0.3, 0.3, (512, 2)),
                           np.ones((512, 1))], axis=1).astype(np.float32)
    mask = np.zeros(7, np.uint32)
    mask[0] = 0xFFFF  # triangles 0..15 occlude but never hit
    for bits in (None, mask):
        got = TN.BvhRaycaster(verts, tris).raycast(origins, dirs, bits)
        ref = JN.BvhRaycaster(verts, tris).raycast(origins, dirs, bits)
        np.testing.assert_array_equal(got[4], ref[4])
        hit = got[4] != 0xFFFFFFFF
        assert hit.sum() > 50
        for a, b in zip(got[:4], ref[:4]):
            np.testing.assert_allclose(a[hit], b[hit], rtol=1e-5, atol=1e-5)
    assert not np.isin(got[4], np.arange(16)).any()
