"""The port's uniform-grid cast (``engine/gridcast.py``; on the CPU its plain
version ``grid_plain``, the plain version of K6) against the JAX package's
``engine/gridcast.py`` (XLA on the CPU), on the same numpy-seeded inputs.

- The build: ``cell_start``, ``items``, ``lo``, ``h`` and ``res`` equal to
  the bit on spheres (8, 12) and (24, 32), a soup, a huge triangle that
  coarsens the grid, an empty mesh and a thin mesh under a cell budget;
  the port's per-triangle rows equal the reference's per-item rows, and
  ``convert.grid_accel`` carries a JAX-built grid across to the bit.
- The casts, on the cases of tests/test_gridcast.py (sphere, soup, mask
  semantics, axis-aligned rays and origins inside, the grouped wrapper, the
  empty mesh, a ray parallel to a slab outside it, the huge triangle, the
  thin mesh) and at small ``max_iters``: ``valid`` and ``prim_id`` equal on
  every ray; ``t``, positions and normals within rtol 1e-5, atol 1e-5.
  The two packages round the Möller-Trumbore cross products and 3-sums
  differently (XLA's CPU fusions against torch's kernels), so a hit's t
  and barycentrics move by a few ulps (on these rays at most 1.3e-6 in t
  and 9.1e-6 in a position on the huge triangle's 100-unit ground plane);
  the walk, the cap and the winner are the same.
- Random soups (hypothesis): the grid, the port's flat sweep and its host
  BVH agree, as tests/test_properties.py holds the JAX package's three.
- The wrapper: CPU tensors never load the kernel library, inputs the
  kernel does not take raise, ``block_threads`` sizes a launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from polychase_tpu.engine.geometry import Mesh as JMesh, set_mask_bits
from polychase_tpu.engine.gridcast import (
    build_grid_accel as jax_build,
    grid_raycast as jax_grid,
    grid_raycast_grouped as jax_grid_grouped,
)

from polychase_tpu_torch import convert, native
from polychase_tpu_torch.engine import gridcast as G
from polychase_tpu_torch.engine.raycast import (
    INVALID_ID, raycast, raycast_grouped,
)
from polychase_tpu_torch.kernels import build, grid_cast as K

from synthetic import make_sphere_mesh

torch.set_num_threads(1)

HIT_FIELDS = ("pos", "normal", "barycentric", "t", "prim_id", "valid")
# See the module docstring: the packages' roundings differ by a few ulps.
RTOL = ATOL = 1e-5


def _rand_rays(rng, n, radius=4.0):
    """tests/test_gridcast.py's rays: from random points on a sphere of
    ``radius`` aimed at jittered points near the origin."""
    o = rng.normal(size=(n, 3))
    o = radius * o / np.linalg.norm(o, axis=-1, keepdims=True)
    target = rng.normal(0, 0.8, size=(n, 3))
    return o.astype(np.float32), (target - o).astype(np.float32)


def _soup(rng, n_tri=400, spread=0.25):
    centers = rng.uniform(-2, 2, (n_tri, 1, 3))
    verts = (centers + rng.normal(0, spread, (n_tri, 3, 3))).reshape(-1, 3)
    tris = np.arange(3 * n_tri, dtype=np.uint32).reshape(-1, 3)
    return verts.astype(np.float32), tris


def _huge():
    base = make_sphere_mesh(16, 24)
    verts, tris = np.asarray(base.vertices), np.asarray(base.triangles)
    ground = np.array([[-50, -50, -2], [50, -50, -2], [0, 80, -2]],
                      np.float32)
    verts = np.concatenate([verts, ground]).astype(np.float32)
    tris = np.concatenate(
        [tris, [[len(verts) - 3, len(verts) - 2, len(verts) - 1]]]
    ).astype(np.uint32)
    return verts, tris


def _thin(rng, n_tri=20000):
    centers = rng.uniform(-1, 1, (n_tri, 1, 2))
    v2 = (centers + rng.normal(0, 0.004, (n_tri, 3, 2))).reshape(-1, 2)
    verts = np.concatenate([v2, np.zeros((len(v2), 1))], axis=1)
    return (verts.astype(np.float32),
            np.arange(3 * n_tri, dtype=np.uint32).reshape(-1, 3))


def _case(kind):
    """(vertices, triangles, build keywords) of a build case."""
    rng = np.random.default_rng(5)
    if kind.startswith("sphere"):
        m = make_sphere_mesh(*(int(x) for x in kind.split("-")[1:]))
        return np.asarray(m.vertices), np.asarray(m.triangles), {}
    if kind == "soup":
        return (*_soup(np.random.default_rng(1)), {})
    if kind == "huge":
        return (*_huge(), {})
    if kind == "thin":
        return (*_thin(rng), dict(max_cells=1 << 18))
    return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint32), {}


def _both(jmesh, o, d, check_mask=True, **kw):
    """The JAX package's grid cast and the port's on the CPU."""
    verts, tris = np.asarray(jmesh.vertices), np.asarray(jmesh.triangles)
    want = jax_grid(jmesh, jax_build(verts, tris), jnp.asarray(o),
                    jnp.asarray(d), check_mask, **kw)
    mesh = convert.mesh(jmesh, device="cpu")
    got = G.grid_raycast(mesh, G.build_grid_accel(verts, tris, device="cpu"),
                         torch.as_tensor(o), torch.as_tensor(d), check_mask,
                         **kw)
    return got, want


def _assert_matches_jax(got, want):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.prim_id.numpy(),
                                  np.asarray(want.prim_id).astype(np.int64))
    for f in ("t", "pos", "normal"):
        np.testing.assert_allclose(getattr(got, f).numpy()[valid],
                                   np.asarray(getattr(want, f))[valid],
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    assert np.isinf(got.t.numpy()[~valid]).all()
    assert not got.pos.numpy()[~valid].any()


@pytest.mark.parametrize("kind", ["sphere-8-12", "sphere-24-32", "soup",
                                  "huge", "empty", "thin"])
def test_build_matches_jax(kind):
    verts, tris, kw = _case(kind)
    ref = jax_build(verts, tris, **kw)
    got = G.build_grid_accel(verts, tris, device="cpu", **kw)
    for f in ("cell_start", "items", "lo", "h", "res"):
        want = np.asarray(getattr(ref, f))
        have = getattr(got, f).numpy()
        assert have.dtype == want.dtype, f
        np.testing.assert_array_equal(have, want, err_msg=f)
    # The port's row of each item's triangle is the reference's item row.
    rows = got.tri_rows.numpy()[got.items.numpy()]
    data = np.asarray(ref.item_data)
    if len(tris):
        np.testing.assert_array_equal(rows[:, :9], data[:, :9])
        assert rows.shape[0] == data.shape[0] and got.tri_rows.shape[0] == len(
            tris)
    carried = convert.grid_accel(ref, device="cpu")
    for f in ("cell_start", "items", "tri_rows", "lo", "h", "res"):
        assert torch.equal(getattr(carried, f), getattr(got, f)), f
    if kind == "huge":
        assert got.items.shape[0] <= 12 * len(tris) + 8
    if kind == "thin":
        assert int(got.res.prod()) <= 1 << 18


def test_build_takes_tensors_and_refuses_2_23_triangles():
    verts, tris, _ = _case("sphere-8-12")
    a = G.build_grid_accel(verts, tris, device="cpu")
    b = G.build_grid_accel(torch.tensor(verts),
                           torch.as_tensor(tris.astype(np.int64)),
                           device="cpu")
    for f in ("cell_start", "items", "tri_rows", "lo", "h", "res"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    huge = np.zeros((1 << 23, 3), np.int64)
    with pytest.raises(ValueError, match="2\\^23"):
        G.build_grid_accel(np.zeros((3, 3), np.float32), huge, device="cpu")


@pytest.mark.parametrize("n_lat,n_lon", [(8, 12), (24, 32)])
def test_grid_matches_jax_on_sphere(n_lat, n_lon):
    rng = np.random.default_rng(0)
    o, d = _rand_rays(rng, 257)
    got, want = _both(make_sphere_mesh(n_lat, n_lon), o, d)
    assert 50 < int(got.valid.sum()) < 257
    _assert_matches_jax(got, want)


def test_grid_matches_jax_on_soup():
    rng = np.random.default_rng(1)
    verts, tris = _soup(rng)
    o, d = _rand_rays(rng, 513, radius=6.0)
    got, want = _both(JMesh.create(verts, tris), o, d)
    assert int(got.valid.sum()) > 100
    _assert_matches_jax(got, want)


@pytest.mark.parametrize("check_mask", [True, False])
def test_grid_mask_semantics_match_jax(check_mask):
    """Masked triangles occlude and are then dropped, like the reference."""
    rng = np.random.default_rng(2)
    base = make_sphere_mesh(12, 16)
    verts, tris = np.asarray(base.vertices), np.asarray(base.triangles)
    masked = np.zeros(base.masked_triangles.shape, np.uint32)
    for t in range(0, len(tris), 3):
        masked = set_mask_bits(masked, t, "mask")
    o, d = _rand_rays(rng, 129)
    got, want = _both(JMesh.create(verts, tris, masked), o, d, check_mask)
    _assert_matches_jax(got, want)
    if check_mask:
        nomask, _ = _both(JMesh.create(verts, tris, masked), o, d, False)
        assert int(nomask.valid.sum()) > int(got.valid.sum())


def test_grid_axis_aligned_and_inside_match_jax():
    """tests/test_gridcast.py's rays, moved off the poles: a ray through a
    vertex that several triangles share ties them at one t, and which one
    wins is decided by the last bit of rounding (tests/test_torch_raycast.py
    leaves such rays out too)."""
    o = np.array([[0.05, 0.03, 0.0], [3.0, 0.01, 0.02], [0.03, -5.0, 0.2],
                  [3.0, 3.0, 3.0], [0.1, 0.2, -0.3], [0.02, -0.04, 5.0]],
                 np.float32)
    d = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                  [1.0, 1.0, 1.0], [-1.0, 0.0, 0.0], [0.0, 0.0, -1.0]],
                 np.float32)
    got, want = _both(make_sphere_mesh(10, 14), o, d)
    _assert_matches_jax(got, want)
    assert got.valid[[0, 1, 2, 4, 5]].all() and not bool(got.valid[3])


def test_grid_grouped_matches_jax_and_the_sweep():
    rng = np.random.default_rng(3)
    jm = make_sphere_mesh(8, 12)
    verts, tris = np.asarray(jm.vertices), np.asarray(jm.triangles)
    G_, K_ = 4, 64
    origins = rng.normal(size=(G_, 3)).astype(np.float32)
    origins = 4.0 * origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    dirs = (rng.normal(0, 0.5, (G_, K_, 3))
            - origins[:, None, :]).astype(np.float32)
    want = jax_grid_grouped(jm, jax_build(verts, tris), jnp.asarray(origins),
                            jnp.asarray(dirs))
    mesh = convert.mesh(jm, device="cpu")
    o, d = torch.as_tensor(origins), torch.as_tensor(dirs)
    got = G.grid_raycast_grouped(
        mesh, G.build_grid_accel(verts, tris, device="cpu"), o, d)
    assert got.t.shape == (G_, K_) and got.pos.shape == (G_, K_, 3)
    flat = [type(got)(*(getattr(h, f).reshape(G_ * K_, *getattr(
        h, f).shape[2:]) for f in HIT_FIELDS)) for h in (got, want)]
    _assert_matches_jax(*flat)
    sweep = raycast_grouped(mesh, o, d)
    assert torch.equal(sweep.valid, got.valid)
    assert torch.equal(sweep.prim_id, got.prim_id)
    torch.testing.assert_close(sweep.t, got.t, rtol=RTOL, atol=ATOL)


def test_grid_empty_mesh():
    jm = JMesh.create(np.zeros((0, 3), np.float32),
                      np.zeros((0, 3), np.uint32))
    o = np.zeros((5, 3), np.float32)
    d = np.tile(np.array([0, 0, 1.0], np.float32), (5, 1))
    got, want = _both(jm, o, d)
    assert not got.valid.any()
    assert (got.prim_id == INVALID_ID).all() and torch.isinf(got.t).all()
    _assert_matches_jax(got, want)


def test_grid_degenerate_axis_ray_outside_slab():
    """A direction parallel to a slab, its origin outside it, misses at
    once."""
    o = np.array([[0.0, 2.5, 0.0], [0.0, 0.5, -3.0]], np.float32)
    d = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    got, want = _both(make_sphere_mesh(8, 12), o, d)
    _assert_matches_jax(got, want)
    assert not bool(got.valid[0]) and bool(got.valid[1])


def test_grid_huge_triangle_matches_jax():
    rng = np.random.default_rng(4)
    verts, tris = _huge()
    o, d = _rand_rays(rng, 129, radius=8.0)
    d[:32] = np.array([0.1, 0.05, -1.0], np.float32)
    got, want = _both(JMesh.create(verts, tris), o, d)
    _assert_matches_jax(got, want)
    assert len(tris) - 1 in got.prim_id.tolist()


def test_grid_thin_mesh_matches_jax():
    verts, tris = _thin(np.random.default_rng(5))
    o = np.array([[0.2, -0.1, 2.0], [5.0, 5.0, 5.0], [-0.3, 0.4, -1.0]],
                 np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.01, 0.0, 1.0]],
                 np.float32)
    jm = JMesh.create(verts, tris)
    want = jax_grid(jm, jax_build(verts, tris, max_cells=1 << 18),
                    jnp.asarray(o), jnp.asarray(d))
    got = G.grid_raycast(
        convert.mesh(jm, device="cpu"),
        G.build_grid_accel(verts, tris, max_cells=1 << 18, device="cpu"),
        torch.as_tensor(o), torch.as_tensor(d))
    _assert_matches_jax(got, want)


@pytest.mark.parametrize("max_iters,block", [(1, 4), (6, 4), (6, 1),
                                             (20, 2)])
def test_small_max_iters_matches_jax(max_iters, block):
    """The cap counts actions a ray, as the reference's lockstep counts
    iterations: rays cut short keep the best hit found so far, the same
    one in both packages."""
    rng = np.random.default_rng(6)
    o, d = _rand_rays(rng, 257)
    got, want = _both(make_sphere_mesh(24, 32), o, d, block=block,
                      max_iters=max_iters)
    _assert_matches_jax(got, want)
    full, _ = _both(make_sphere_mesh(24, 32), o, d, block=block)
    assert int(got.valid.sum()) <= int(full.valid.sum())
    if max_iters <= 6:
        assert int(got.valid.sum()) < int(full.valid.sum())


def test_grid_plain_counts_its_work():
    """``grid_plain_counted``: the same hits as ``grid_plain``, the
    candidates tested, the cell actions, the lockstep's iterations and
    the closest triangle before the mask test."""
    rng = np.random.default_rng(7)
    jm = make_sphere_mesh(24, 32)
    mesh = convert.mesh(jm, device="cpu")
    accel = G.build_grid_accel(mesh.vertices, mesh.triangles, device="cpu")
    o, d = (torch.as_tensor(a) for a in _rand_rays(rng, 200))
    arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
    hits, tests, steps, its, found = G.grid_plain_counted(o, d, accel,
                                                          *arrays)
    plain = G.grid_plain(o, d, accel, *arrays)
    for f in HIT_FIELDS:
        assert torch.equal(getattr(hits, f), getattr(plain, f)), f
    assert torch.equal(found, hits.prim_id)  # no triangle is masked
    # Every ray that enters ends in a cell action or at the cap, and a
    # ray's actions fill at most one iteration each.
    assert int(hits.valid.sum()) <= tests and 0 < steps
    assert tests + steps <= 4 * its * 200
    one, t1, s1, i1, _ = G.grid_plain_counted(o, d, accel, *arrays,
                                              max_iters=3)
    assert i1 == 3 and t1 <= tests and s1 <= steps
    # With every third triangle masked, a masked winner is found and then
    # dropped.
    masked = np.zeros(jm.masked_triangles.shape, np.uint32)
    for t in range(0, mesh.num_triangles, 3):
        masked = set_mask_bits(masked, t, "mask")
    mm = convert.mesh(JMesh.create(np.asarray(jm.vertices),
                                   np.asarray(jm.triangles), masked),
                      device="cpu")
    arrays = (mm.vertices, mm.triangles, mm.masked_triangles)
    hits, *_, found = G.grid_plain_counted(o, d, accel, *arrays)
    assert torch.equal(found, G.grid_plain_counted(
        o, d, accel, *arrays, check_mask=False)[4])
    assert torch.equal(hits.prim_id,
                       torch.where(hits.valid, found, INVALID_ID))
    assert int((found != INVALID_ID).sum()) > int(hits.valid.sum())


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_grid_sweep_and_bvh_agree(seed):
    """The grid, the port's flat sweep and its host BVH on random soups:
    the same hit set and ids, t within 1e-4 (the BVH within 1e-3, as
    tests/test_properties.py holds the JAX package's three)."""
    rng = np.random.default_rng(seed)
    n_tri = 120
    centers = rng.uniform(-2, 2, (n_tri, 1, 3))
    verts = (centers + rng.uniform(-0.4, 0.4, (n_tri, 3, 3))).reshape(
        -1, 3).astype(np.float32)
    tris = np.arange(3 * n_tri, dtype=np.uint32).reshape(-1, 3)
    o = rng.normal(size=(64, 3))
    o = (5.0 * o / np.linalg.norm(o, axis=-1, keepdims=True))
    d = (rng.normal(0, 1.0, (64, 3)) - o).astype(np.float32)
    o = torch.as_tensor(o.astype(np.float32))
    d = torch.as_tensor(d)
    from polychase_tpu_torch.engine.geometry import Mesh

    mesh = Mesh.create(verts, tris, device="cpu")
    sweep = raycast(mesh, o, d)
    grid = G.grid_raycast(mesh, G.build_grid_accel(verts, tris,
                                                   device="cpu"), o, d)
    sv = sweep.valid
    assert torch.equal(sv, grid.valid)
    assert torch.equal(sweep.prim_id, grid.prim_id)
    torch.testing.assert_close(sweep.t[sv], grid.t[sv], rtol=1e-4,
                               atol=1e-4)
    if native.available():
        _, _, _, bt, bprim = native.BvhRaycaster(verts, tris).raycast(
            o.numpy(), d.numpy())
        bvalid = bprim != 0xFFFFFFFF
        np.testing.assert_array_equal(sv.numpy(), bvalid)
        np.testing.assert_array_equal(grid.prim_id.numpy()[bvalid],
                                      bprim[bvalid].astype(np.int64))
        np.testing.assert_allclose(grid.t.numpy()[bvalid], bt[bvalid],
                                   rtol=1e-3, atol=1e-3)


def _mesh_accel(rng):
    jm = make_sphere_mesh(8, 12)
    mesh = convert.mesh(jm, device="cpu")
    accel = G.build_grid_accel(mesh.vertices, mesh.triangles, device="cpu")
    o, d = (torch.as_tensor(a) for a in _rand_rays(rng, 64))
    return mesh, accel, o, d


def test_cpu_tensors_never_load_the_library(rng, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "load_all", refuse)
    mesh, accel, o, d = _mesh_accel(rng)
    arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
    before = K.launches
    hits = G.grid_raycast(mesh, accel, o, d)
    direct = K.grid_hits(o, d, accel, *arrays)
    assert K.launches == before and hits.valid.any()
    want = G.grid_plain(o, d, accel, *arrays)
    for f in HIT_FIELDS:
        assert torch.equal(getattr(hits, f), getattr(want, f)), f
        assert torch.equal(getattr(direct, f), getattr(want, f)), f


def test_inputs_the_kernel_does_not_take_raise(rng, monkeypatch):
    """Wrong types, shapes, layouts, devices or a grid of another mesh raise
    ValueError before any route; a device that is neither the CPU nor a card
    raises without loading the library."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(build, "load", refuse)
    mesh, accel, o, d = _mesh_accel(rng)
    arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
    bad = [
        (o.double(), d, accel, *arrays),
        (o, d[:10], accel, *arrays),
        (o, d.t().contiguous().t(), accel, *arrays),
        (o, d, G.GridAccel(accel.cell_start.long(), *(getattr(accel, f) for f
                                                       in ("items", "tri_rows",
                                                           "lo", "h", "res"))),
         *arrays),
        (o, d, G.GridAccel(accel.cell_start, accel.items,
                           accel.tri_rows[:-1], accel.lo, accel.h, accel.res),
         *arrays),
        (o, d, accel, arrays[0], arrays[1].int(), arrays[2]),
        (o, d, accel, arrays[0], arrays[1], arrays[2][:1]),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            K.grid_hits(*args)
    for kw in (dict(block=0), dict(max_iters=-1)):
        with pytest.raises(ValueError):
            K.grid_hits(o, d, accel, *arrays, **kw)
    meta = [a.to("meta") for a in (o, d)]
    with pytest.raises(ValueError):
        K.grid_hits(*meta, accel.to("meta"),
                    *(a.to("meta") for a in arrays))


@pytest.mark.parametrize("n,sms,threads", [(8192, 132, 32), (32000, 132, 128),
                                           (16000, 132, 64), (100, 132, 32),
                                           (8192, 64, 128)])
def test_block_threads(n, sms, threads):
    assert K.block_threads(n, sms) == threads
