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
  kernel does not take raise, ``team_width`` picks a launch's lanes a ray
  from the build's ``cell_load``.
- K6's team walk (``csrc/grid_cast.cu``), modelled in torch: one cell a
  step, a cell's candidates L at a time reduced to the least (t, lane),
  the ``max_iters`` cap counted an action at a time: equal to
  ``grid_plain`` to the bit on the scenes above at every team width the
  kernel takes, uncapped and cut short.
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
    candidates tested, the cell actions, the lockstep's iterations, the
    closest triangle before the mask test and the grid's entries read."""
    rng = np.random.default_rng(7)
    jm = make_sphere_mesh(24, 32)
    mesh = convert.mesh(jm, device="cpu")
    accel = G.build_grid_accel(mesh.vertices, mesh.triangles, device="cpu")
    o, d = (torch.as_tensor(a) for a in _rand_rays(rng, 200))
    arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
    hits, walks, its, found, reads = G.grid_plain_counted(o, d, accel,
                                                          *arrays)
    plain = G.grid_plain(o, d, accel, *arrays)
    for f in HIT_FIELDS:
        assert torch.equal(getattr(hits, f), getattr(plain, f)), f
    assert torch.equal(found, hits.prim_id)  # no triangle is masked
    # Every ray that hits tested a candidate and left a cell with some;
    # every ray that enters ends in a cell action (the cap is not met);
    # a ray's actions fill at most one iteration each, a candidate action
    # at most 4 tests.
    tests, steps = walks.tests, walks.empty + walks.full
    assert (tests[hits.valid] > 0).all() and (walks.full[hits.valid] > 0).all()
    assert int(hits.valid.sum()) <= int(tests.sum()) and (steps > 0).any()
    assert (tests <= 4 * its).all() and (steps <= its).all()
    assert (walks.empty[tests == 0] == steps[tests == 0]).all()
    # Each slot tested once or more, each row at most once a slot; a
    # cell's range is two entries, at most one a step more.
    assert 0 < reads.rows <= reads.items <= int(tests.sum())
    assert reads.items <= accel.items.shape[0]
    assert reads.cell_start <= accel.cell_start.shape[0]
    assert 2 < reads.cell_start <= int(steps.sum()) + 2 * o.shape[0]
    _, w1, i1, _, r1 = G.grid_plain_counted(o, d, accel, *arrays,
                                            max_iters=3)
    assert r1.items <= reads.items and r1.cell_start <= reads.cell_start
    assert i1 == 3 and (w1.tests <= tests).all()
    assert (w1.empty + w1.full <= steps).all()
    assert (w1.tests + w1.empty + w1.full <= 3 * 4).all()
    # With every third triangle masked, a masked winner is found and then
    # dropped.
    masked = np.zeros(jm.masked_triangles.shape, np.uint32)
    for t in range(0, mesh.num_triangles, 3):
        masked = set_mask_bits(masked, t, "mask")
    mm = convert.mesh(JMesh.create(np.asarray(jm.vertices),
                                   np.asarray(jm.triangles), masked),
                      device="cpu")
    arrays = (mm.vertices, mm.triangles, mm.masked_triangles)
    hits, *_, found, _ = G.grid_plain_counted(o, d, accel, *arrays)
    assert torch.equal(found, G.grid_plain_counted(
        o, d, accel, *arrays, check_mask=False)[3])
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
                                                           "lo", "h", "res",
                                                           "cell_load"))),
         *arrays),
        (o, d, G.GridAccel(accel.cell_start, accel.items,
                           accel.tri_rows[:-1], accel.lo, accel.h, accel.res,
                           accel.cell_load),
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


@pytest.mark.parametrize("load,team", [(0.0, 8), (8.0, 8), (16.01, 16),
                                       (9.08, 8), (9.44, 8), (18.32, 16),
                                       (44.51, 32), (117.57, 32),
                                       (243.69, 32)])
def test_team_width(load, team):
    """K6's lanes a ray from the grid's ``cell_load``: the least team
    whose two rounds hold it (the soup of 20,000, config 4's 1,472-triangle
    sphere, the tracking frame's 20,224, 399,000 and 1,998,000 triangles,
    the huge triangle's grid)."""
    accel = G.GridAccel(*(torch.zeros(1),) * 6, cell_load=load)
    assert K.team_width(accel) == team and team in K.TEAMS


@pytest.mark.parametrize("kind,load", [("sphere-24-32", 9.44),
                                       ("huge", 243.69), ("empty", 0.0)])
def test_cell_load_is_the_builds(kind, load):
    """``cell_load`` is the build's sum n^2 / sum n over its cells' counts
    n, carried by ``to`` and by ``convert.grid_accel``; the huge ground
    triangle's grid, almost all cells of one candidate, has the load of
    its few dense ones."""
    verts, tris, kw = _case(kind)
    accel = G.build_grid_accel(verts, tris, device="cpu", **kw)
    n = np.diff(accel.cell_start.numpy()).astype(np.float64)
    assert accel.cell_load == (pytest.approx((n * n).sum() / n.sum())
                               if n.sum() else 0.0)
    assert accel.cell_load == pytest.approx(load, abs=0.005)
    assert accel.to("cpu").cell_load == accel.cell_load
    if len(tris):
        carried = convert.grid_accel(jax_build(verts, tris, **kw),
                                     device="cpu")
        assert carried.cell_load == accel.cell_load


# ---------------------------------------------------------------------------
# K6's team walk, modelled in torch
# ---------------------------------------------------------------------------


def _least(t, lanes):
    """The shuffle reduction of ``csrc/grid_cast.cu``'s ``test_cell``: the
    least (t, lane) of each row's L lanes, by the butterfly of xor
    offsets L/2, ..., 1.  Returns (t, lane)."""
    L = t.shape[1]
    kt, kl = t.clone(), lanes.expand_as(t).clone()
    off = L // 2
    while off:
        partner = lanes ^ off
        ot, ol = kt[:, partner], kl[:, partner]
        take = (ot < kt) | ((ot == kt) & (ol < kl))
        kt, kl = torch.where(take, ot, kt), torch.where(take, ol, kl)
        off //= 2
    return kt[:, 0], kl[:, 0]


def _team_walk(o, d, accel, vertices, triangles, words, check_mask, block,
               max_iters, L):
    """K6's walk, ``csrc/grid_cast.cu::grid_kernel<L>``, modelled in torch
    with ``grid_plain``'s operations, every ray at once: one cell a step,
    its candidates L at a time, candidate k of a cell whose candidates
    begin at action a tested only where a + k // block < max_iters, the
    least (t, lane) of the L joining the best hit where strictly smaller;
    each cell's end or step one action."""
    from polychase_tpu_torch.engine.raycast import _ray_hits, _unmasked

    n = o.shape[0]
    if triangles.shape[0] == 0:
        return G.grid_plain(o, d, accel, vertices, triangles, words,
                            check_mask, block, max_iters)
    cs, items, rows = accel.cell_start, accel.items, accel.tri_rows
    res, glo, h = accel.res, accel.lo, accel.h
    t0, t1 = G._slab_entry(glo, glo + h * res.to(torch.float32), o, d)
    t_start = torch.clamp_min(t0, 0.0)
    live = (t1 >= t_start) & (t0 < float("inf")) & (max_iters > 0)
    c = torch.floor((o + d * t_start[:, None] - glo) / h)
    c = torch.where(torch.isnan(c), 0.0, c)
    cell = torch.minimum(torch.clamp_min(c, 0.0),
                         (res - 1).to(torch.float32)).to(torch.int32)
    step = torch.sign(d).to(torch.int32)
    d0 = d == 0.0
    safe_d = torch.where(d0, 1.0, d)
    nb = glo + (cell + (step > 0).to(torch.int32)).to(torch.float32) * h
    tmax = torch.where(d0, float("inf"), (nb - o) / safe_d)
    tdelta = torch.where(d0, float("inf"), torch.abs(h / safe_d))

    lanes = torch.arange(L)
    axes = torch.arange(3)
    rows_of = torch.arange(n)
    acts = torch.zeros(n, dtype=torch.int64)
    best_t = torch.full((n,), float("inf"))
    best_uv = torch.zeros((n, 2))
    best_id = torch.full((n,), INVALID_ID, dtype=torch.int64)
    while bool(live.any()):
        flat = ((cell[:, 0] * res[1] + cell[:, 1]) * res[2]
                + cell[:, 2]).long()
        cb = torch.where(live, cs[flat], 0)
        ce = torch.where(live, cs[flat + 1], 0)
        full = live & (cb < ce)
        k0, going = cb.clone(), full.clone()
        while bool(going.any()):
            k = k0[:, None] + lanes[None]
            take = (going[:, None] & (k < ce[:, None])
                    & (acts[:, None] + (k - cb[:, None]) // block
                       < max_iters))
            ids = items[k.clamp(0, items.shape[0] - 1)].long()
            r = rows[ids]
            t, u, v, hit = G._moller_block(
                o[:, None], d[:, None], r[..., 0:3], r[..., 3:6],
                r[..., 6:9])
            t = torch.where(hit & take, t, float("inf"))
            kt, kl = _least(t, lanes)
            closer = going & (kt < best_t)
            uv = torch.stack([u[rows_of, kl], v[rows_of, kl]], dim=-1)
            best_uv = torch.where(closer[:, None], uv, best_uv)
            best_id = torch.where(closer, ids[rows_of, kl], best_id)
            best_t = torch.where(closer, kt, best_t)
            k0 = k0 + L
            going = going & (k0 < ce) & (acts + (k0 - cb) // block
                                         < max_iters)
        acts = torch.where(full, acts + (ce - cb + block - 1) // block, acts)
        live = live & (acts < max_iters)
        # The cell is exhausted: end at its exit, or step on, or end where
        # the step leaves the grid.
        live = live & ~(best_t <= torch.amin(tmax, dim=-1))
        onehot = torch.argmin(tmax, dim=-1)[:, None] == axes[None, :]
        moved = cell + torch.where(onehot, step, 0)
        live = live & ~((moved < 0) | (moved >= res)).any(dim=-1)
        cell = torch.where(live[:, None], moved, cell)
        tmax = torch.where(live[:, None] & onehot, tmax + tdelta, tmax)
        acts = torch.where(live, acts + 1, acts)
        live = live & (acts < max_iters)
    valid = _unmasked(words, best_id, check_mask)
    q = vertices[triangles[torch.where(valid, best_id, 0)]]
    return _ray_hits(q[:, 0], q[:, 1], q[:, 2], best_uv, best_t, best_id,
                     valid)


def _walk_scene(kind):
    """(mesh, origins, dirs, build keywords) of the model's scenes."""
    rng = np.random.default_rng(8)
    if kind == "axis":
        o = np.concatenate([rng.uniform(-0.5, 0.5, (64, 3)),
                            rng.uniform(-3, 3, (64, 3))]).astype(np.float32)
        d = np.concatenate([np.eye(3), -np.eye(3)])[
            rng.integers(0, 6, 128)].astype(np.float32)
        return convert.mesh(make_sphere_mesh(10, 14), device="cpu"), o, d, {}
    if kind == "masked":
        base = make_sphere_mesh(12, 16)
        masked = np.zeros(base.masked_triangles.shape, np.uint32)
        for t in range(0, int(base.triangles.shape[0]), 3):
            masked = set_mask_bits(masked, t, "mask")
        jm = JMesh.create(np.asarray(base.vertices),
                          np.asarray(base.triangles), masked)
        return (convert.mesh(jm, device="cpu"), *_rand_rays(rng, 129), {})
    if kind == "thin":
        verts, tris = _thin(rng, 4000)
        # From above the centroids of 96 triangles, nearly straight down.
        at = verts[tris[rng.choice(len(tris), 96, replace=False)]].mean(1)
        o = (at + [0, 0, 2.0]).astype(np.float32)
        d = (rng.normal(0, 1e-4, (96, 3)) + [0, 0, -1]).astype(np.float32)
        return (convert.mesh(JMesh.create(verts, tris), device="cpu"), o, d,
                dict(max_cells=1 << 14))
    verts, tris, kw = _case({"sphere": "sphere-24-32",
                             "twice": "sphere-24-32"}.get(kind, kind))
    if kind == "twice":  # every triangle twice: each hit an exact-t tie
        tris = np.concatenate([tris, tris])
    radius = {"soup": 6.0, "huge": 8.0}.get(kind, 4.0)
    o, d = _rand_rays(rng, 129, radius)
    if kind == "huge":
        d[:32] = np.array([0.1, 0.05, -1.0], np.float32)
    return (convert.mesh(JMesh.create(verts, tris), device="cpu"), o, d, kw)


@pytest.mark.parametrize("max_iters,block", [(200_000, 4), (1, 4), (6, 4),
                                             (6, 1), (8, 4)])
@pytest.mark.parametrize("team", K.TEAMS)
@pytest.mark.parametrize("kind", ["sphere", "soup", "masked", "axis", "huge",
                                  "thin", "empty", "twice"])
def test_team_walk_matches_grid_plain(kind, team, max_iters, block):
    """The ordering argument of K6's team walk, on this host: a torch model
    of it (``_team_walk``) equals ``grid_plain`` to the bit on every field,
    at team widths 8, 16 and 32, uncapped and cut at 1, 6 and 8 actions
    with blocks of 4 and 1; on the sphere with every triangle twice the
    lower id, first in visiting order, wins each tie."""
    mesh, o, d, kw = _walk_scene(kind)
    accel = G.build_grid_accel(mesh.vertices, mesh.triangles, device="cpu",
                               **kw)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
    want = G.grid_plain(o, d, accel, *arrays, True, block, max_iters)
    got = _team_walk(o, d, accel, *arrays, True, block, max_iters, team)
    for f in HIT_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if kind != "empty" and max_iters > 6:
        assert bool(want.valid.any())


# ---------------------------------------------------------------------------
# The route of the grouped cast (``raycast.grid_route``) and the grid kept
# with the mesh (``gridcast.mesh_grid``); tests lower the threshold on toy
# meshes, the program never does.
# ---------------------------------------------------------------------------


def _route_scene(kind, seed=7):
    """A 24×32 sphere (1,472 triangles; 40 of them masked for "masked",
    every triangle twice for "twice") and 4 groups of 96 rays at it."""
    jm = make_sphere_mesh(24, 32)
    verts, tris = np.asarray(jm.vertices), np.asarray(jm.triangles)
    words = None
    rng = np.random.default_rng(seed)
    if kind == "masked":
        words = np.asarray(jm.masked_triangles)
        for i in rng.choice(len(tris), 40, replace=False):
            words = set_mask_bits(words, int(i), "mask")
    if kind == "twice":
        tris = np.concatenate([tris, tris])
    from polychase_tpu_torch.engine.geometry import Mesh

    mesh = Mesh.create(verts, tris, words, device="cpu")
    origins = rng.normal(size=(4, 3))
    origins = 4.0 * origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    dirs = rng.normal(0, 0.6, (4, 96, 3)) - origins[:, None, :]
    return (mesh, torch.as_tensor(origins.astype(np.float32)),
            torch.as_tensor(dirs.astype(np.float32)))


def _plain(mesh, o, d):
    from polychase_tpu_torch.engine.raycast import cast_plain

    return cast_plain(o, d, mesh.vertices, mesh.triangles,
                      mesh.masked_triangles)


@pytest.mark.parametrize("kind", ["sphere", "masked", "twice"])
def test_grouped_cast_above_the_threshold_takes_the_grid(kind, monkeypatch):
    """From ``GRID_TRIANGLE_THRESHOLD`` triangles ``raycast_grouped`` is
    ``grid_raycast_grouped`` through the mesh's grid, field for field; its
    ids are the sweep's (``cast_plain``) on every ray but those whose two
    t's lie within float eps of each other (an exact tie or an edge), and
    the grid is built at the first cast only."""
    from polychase_tpu_torch.engine import raycast as R

    mesh, o, d = _route_scene(kind)
    monkeypatch.setattr(R, "GRID_TRIANGLE_THRESHOLD", mesh.num_triangles)
    assert R.grid_route(mesh.num_triangles)
    before = G.builds
    got = R.raycast_grouped(mesh, o, d)
    assert G.builds == before + 1 and mesh.grid is not None
    accel = G.build_grid_accel(mesh.vertices, mesh.triangles, device="cpu")
    want = G.grid_raycast_grouped(mesh, accel, o, d)
    for f in HIT_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    again = R.raycast_grouped(mesh, o, d)
    assert G.builds == before + 2  # the direct build above, no other
    assert torch.equal(again.prim_id, got.prim_id)
    sweep = _plain(mesh, o, d)
    assert torch.equal(got.valid, sweep.valid) and bool(got.valid.any())
    eps = torch.finfo(torch.float32).eps
    apart = (got.t - sweep.t).abs() > eps * sweep.t.abs().clamp_min(1.0)
    assert torch.equal(got.prim_id[apart], sweep.prim_id[apart])
    assert float((got.prim_id == sweep.prim_id).float().mean()) > 0.99
    if kind == "masked":
        assert not bool(got.valid.all())


@pytest.mark.parametrize("kind", ["sphere", "masked", "twice"])
def test_grouped_cast_below_the_threshold_is_the_sweep(kind, monkeypatch):
    """Below the threshold ``raycast_grouped`` is ``cast_plain`` to the
    bit and builds no grid, at the program's threshold and one count
    above the mesh's."""
    from polychase_tpu_torch.engine import raycast as R

    mesh, o, d = _route_scene(kind)
    want = _plain(mesh, o, d)
    before = G.builds
    for threshold in (R.GRID_TRIANGLE_THRESHOLD, mesh.num_triangles + 1):
        monkeypatch.setattr(R, "GRID_TRIANGLE_THRESHOLD", threshold)
        assert not R.grid_route(mesh.num_triangles)
        got = R.raycast_grouped(mesh, o, d)
        for f in HIT_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert G.builds == before and mesh.grid is None


def test_grid_route_stops_at_the_builds_limit(monkeypatch):
    """A mesh of 2**23 triangles or more, which the grid build refuses,
    keeps the sweep: the rule on counts, and a cast whose mesh reports
    2**23 triangles (a patched count, not such a mesh) is the sweep's."""
    from polychase_tpu_torch.engine import raycast as R
    from polychase_tpu_torch.engine.geometry import Mesh

    monkeypatch.setattr(R, "GRID_TRIANGLE_THRESHOLD", 1)
    assert R.GRID_TRIANGLE_LIMIT == 1 << 23
    assert [R.grid_route(n) for n in (0, 1, (1 << 23) - 1, 1 << 23,
                                      1 << 24)] == [
        False, True, True, False, False]
    mesh, o, d = _route_scene("sphere")
    want = _plain(mesh, o, d)
    monkeypatch.setattr(Mesh, "num_triangles", property(lambda m: 1 << 23))
    before = G.builds
    got = R.raycast_grouped(mesh, o, d)
    for f in HIT_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert G.builds == before


def test_mesh_grid_is_built_once_and_spanned():
    """``mesh_grid`` builds the grid at its first call, on the mesh's
    device, inside one ``mesh.grid_build`` span, and hands the same grid
    back after; the build is the direct build's."""
    from torch.profiler import ProfilerActivity, profile

    mesh, _, _ = _route_scene("sphere")
    before = G.builds
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        grid = G.mesh_grid(mesh)
        assert G.mesh_grid(mesh) is grid and mesh.grid is grid
    assert G.builds == before + 1
    spans = [e for e in prof.events() if e.name == "mesh.grid_build"]
    assert len(spans) == 1
    want = G.build_grid_accel(mesh.vertices, mesh.triangles, device="cpu")
    for f in ("cell_start", "items", "tri_rows", "lo", "h", "res"):
        assert torch.equal(getattr(grid, f), getattr(want, f)), f
    assert grid.cell_load == want.cell_load


def test_mesh_on_carries_the_grid(monkeypatch):
    """``parallel.mesh_on`` copies a mesh that the grid route takes with
    its grid, built once on the source and never on the copy's device
    (the ``meta`` device stands in for a second card); a mesh below the
    threshold goes without one."""
    from polychase_tpu_torch.engine import raycast as R
    from polychase_tpu_torch.parallel import mesh_on

    meta = torch.device("meta")
    mesh, _, _ = _route_scene("sphere")
    before = G.builds
    assert mesh_on(mesh, meta).grid is None and G.builds == before
    monkeypatch.setattr(R, "GRID_TRIANGLE_THRESHOLD", 1)
    copies = [mesh_on(mesh, meta) for _ in range(2)]
    assert G.builds == before + 1 and mesh.grid is not None
    for copy in copies:
        assert copy.grid.items.device == meta
        assert copy.grid.items.shape == mesh.grid.items.shape
        assert copy.grid.cell_load == mesh.grid.cell_load
    assert mesh_on(mesh, torch.device("cpu")) is mesh


@pytest.mark.parametrize("device_type,count,bvh", [
    ("cuda", 1_000, False), ("cpu", 1_000, False),
    ("cuda", 1_600_000, False), ("cuda", 1_998_000, False),
    ("cuda", (1 << 23) - 1, False), ("cuda", 1 << 23, True),
    ("cpu", 1_600_000, True), ("cpu", 1_998_000, True), ("cpu", 1 << 23, True),
])
def test_refresh_takes_the_bvh_only_off_the_grid_route(device_type, count,
                                                       bvh):
    """Refine's prim refresh routing as a function of (device type, count):
    a card's mesh that the cast layer sends to the grid is never sent to
    the host BVH; a CPU mesh from ``BVH_TRIANGLE_THRESHOLD`` up and a
    card's of 2**23 triangles or more are."""
    from polychase_tpu_torch.engine import refiner as TR

    assert TR._bvh_refresh(device_type, count) is bvh
