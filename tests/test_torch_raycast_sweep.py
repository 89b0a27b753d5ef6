"""``raycast_grouped``'s plain route, the plain version of K5
(``engine.raycast.cast_plain``: ``sweep_plain``, then ``hits_plain``), and
the wrapper in front of it, on the CPU.

- ``sweep_plain`` against the JAX package's ``raycast_grouped`` (XLA on the
  CPU, without the mask) on tests/test_torch_raycast.py's plain, masked and
  duplicated meshes, at the default chunk and at 64 (a sweep of 352
  triangles in six chunks, the last one padded): ids equal on every ray,
  t within rtol 1e-5 where both hit (the two packages' cross products and
  sums round differently).
- ``hits_plain`` after ``sweep_plain`` against every field of the JAX
  ``raycast_grouped``, with and without the mask: ids and valid equal,
  positions, normals and barycentrics within 1e-5, t within rtol 1e-5.
- Its own invariants, to the bit: ties go to the lowest id (every triangle
  duplicated), the chunk does not change an id or a t, nor does casting
  each ray as a group of one (the sharded flat cast's shape).
- ``raycast_grouped`` against a frozen copy of its arithmetic before the
  sweep and the hits were factored out (``tests/raycast_before.py``),
  every field to the bit.
- The wrapper: CPU tensors never load the kernel library; anything else
  that is not a card raises; inputs the kernel does not take raise
  before any route; ``launch_plan``'s rays a thread, packing, blocks and
  clusters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychase_tpu.engine.raycast import raycast_grouped as jax_cast

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine import raycast as R
from polychase_tpu_torch.kernels import build, raycast_sweep as RS

from raycast_before import raycast_grouped_before
from test_torch_raycast import _mesh, _rays

torch.set_num_threads(1)


def _tris(mesh):
    p1, p2, p3 = mesh.triangle_corners()
    return p1, p2 - p1, p3 - p1


def _sweep(jm, origins, dirs, chunk=0):
    mesh = convert.mesh(jm, device="cpu")
    return R.sweep_plain(torch.as_tensor(origins), torch.as_tensor(dirs),
                         *_tris(mesh), chunk)


@pytest.mark.parametrize("kind", ["plain", "masked", "duplicated"])
@pytest.mark.parametrize("chunk", [0, 64])
def test_sweep_plain_matches_jax(rng, kind, chunk):
    jm = _mesh(kind)
    origins, dirs = _rays(rng, jm)
    ref = jax_cast(jm, jnp.asarray(origins), jnp.asarray(dirs), False, chunk)
    best_t, best_id = _sweep(jm, origins, dirs, chunk)
    # The reference's ids after its sweep: a miss, or a hit whose
    # barycentric recompute fell to |det| <= 1e-10, is INVALID_ID there.
    ref_id = np.asarray(ref.prim_id).astype(np.int64)
    valid = np.asarray(ref.valid)
    got = best_id.numpy()
    np.testing.assert_array_equal(got[valid], ref_id[valid])
    assert (got[~valid] == R.INVALID_ID).all()
    np.testing.assert_allclose(best_t.numpy()[valid],
                               np.asarray(ref.t)[valid], rtol=1e-5)
    assert np.isinf(best_t.numpy()[~valid]).all()
    assert valid.any() and (~valid).any()


def test_ties_go_to_the_lowest_id(rng):
    """Every triangle twice: each hit is the first copy's, with its t to
    the bit."""
    origins, dirs = _rays(rng, _mesh("plain"))
    once = _sweep(_mesh("plain"), origins, dirs)
    twice = _sweep(_mesh("duplicated"), origins, dirs)
    for chunk in (64, 100):
        again = _sweep(_mesh("duplicated"), origins, dirs, chunk)
        assert torch.equal(again[1], twice[1])
    assert torch.equal(twice[1], once[1])
    assert torch.equal(twice[0], once[0])
    hit = once[1] != R.INVALID_ID
    assert hit.any() and (once[1][hit] < _mesh("plain").num_triangles).all()


@pytest.mark.parametrize("chunk", [64, 100, 128, 352, 4096])
def test_chunk_changes_no_bit(rng, chunk):
    """352 triangles: a multiple of none of these chunks but 352 itself."""
    jm = _mesh("masked")
    origins, dirs = _rays(rng, jm)
    ref_t, ref_id = _sweep(jm, origins, dirs)
    t, ids = _sweep(jm, origins, dirs, chunk)
    assert torch.equal(ids, ref_id) and torch.equal(t, ref_t)


def test_groups_of_one_ray(rng):
    """Each ray its own group with its group's origin: the same ids and t
    to the bit."""
    jm = _mesh("plain")
    origins, dirs = _rays(rng, jm, G=3, K=40)
    ref_t, ref_id = _sweep(jm, origins, dirs)
    G, K = dirs.shape[:2]
    t, ids = _sweep(jm, np.repeat(origins, K, axis=0),
                    dirs.reshape(G * K, 1, 3))
    assert torch.equal(ids.reshape(G, K), ref_id)
    assert torch.equal(t.reshape(G, K), ref_t)


def _hits(jm, origins, dirs, check_mask=True, chunk=0):
    mesh = convert.mesh(jm, device="cpu")
    o, d = torch.as_tensor(origins), torch.as_tensor(dirs)
    p1, p2, p3 = mesh.triangle_corners()
    best_t, best_id = R.sweep_plain(o, d, p1, p2 - p1, p3 - p1, chunk)
    return R.hits_plain(o, d, p1, p2, p3, mesh.masked_triangles, best_t,
                        best_id, check_mask)


@pytest.mark.parametrize("kind", ["plain", "masked", "duplicated"])
@pytest.mark.parametrize("check_mask", [True, False])
def test_hits_plain_matches_jax(rng, kind, check_mask):
    """``hits_plain`` after ``sweep_plain`` against every field of the JAX
    package's ``raycast_grouped``: ids and ``valid`` equal, positions,
    normals and barycentrics within 1e-5, t within rtol 1e-5 where valid
    (the two packages' cross products and sums round differently)."""
    jm = _mesh(kind)
    origins, dirs = _rays(rng, jm)
    ref = jax_cast(jm, jnp.asarray(origins), jnp.asarray(dirs), check_mask)
    got = _hits(jm, origins, dirs, check_mask)
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.prim_id.numpy(),
                                  np.asarray(ref.prim_id).astype(np.int64))
    for f in ("pos", "normal", "barycentric"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose(got.t.numpy()[v], np.asarray(ref.t)[v],
                               rtol=1e-5)
    assert np.isinf(got.t.numpy()[~v]).all()
    assert v.any() and (~v).any()
    if kind == "masked":
        # Masked closest hits dropped only where the mask is asked for.
        unmasked = _hits(jm, origins, dirs, False).valid
        assert bool((unmasked & ~got.valid).any()) == check_mask


@pytest.mark.parametrize("kind,chunk,check_mask,G,K", [
    ("plain", 0, True, 5, 120), ("masked", 0, True, 5, 120),
    ("duplicated", 0, True, 5, 120), ("masked", 64, True, 5, 120),
    ("masked", 0, False, 5, 120), ("masked", 0, True, 600, 1),
    ("plain", 100, True, 3, 7)])
def test_raycast_grouped_unchanged_by_the_refactor(kind, chunk, check_mask,
                                                   G, K):
    """``raycast_grouped`` on the CPU (``cast_plain``) against a frozen copy
    of its arithmetic before the sweep and the hits were factored out,
    every field to the bit, with and without the mask, at the groups of
    one ray and small groups of the packed layout."""
    rng = np.random.default_rng(13)
    jm = _mesh(kind)
    origins, dirs = _rays(rng, jm, G=G, K=max(K, 8))
    dirs = np.ascontiguousarray(dirs[:, :K])
    mesh = convert.mesh(jm, device="cpu")
    args = (mesh, torch.as_tensor(origins), torch.as_tensor(dirs),
            check_mask, chunk)
    got, want = R.raycast_grouped(*args), raycast_grouped_before(*args)
    for f in ("pos", "normal", "barycentric", "t", "prim_id", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.valid.any() and (~got.valid).any()


def test_cpu_tensors_never_load_the_library(rng, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "load_all", refuse)
    jm = _mesh("masked")
    origins, dirs = _rays(rng, jm)
    before = RS.launches
    mesh = convert.mesh(jm, device="cpu")
    o, d = torch.as_tensor(origins), torch.as_tensor(dirs)
    arrays = (mesh.vertices, mesh.triangles, mesh.masked_triangles)
    hits = R.raycast_grouped(mesh, o, d)
    direct = RS.raycast_hits(o, d, *arrays)
    assert RS.launches == before
    assert hits.valid.any()
    want = R.cast_plain(o, d, *arrays)
    for f in ("pos", "normal", "barycentric", "t", "prim_id", "valid"):
        assert torch.equal(getattr(hits, f), getattr(want, f)), f
        assert torch.equal(getattr(direct, f), getattr(want, f)), f


def test_other_devices_raise_without_a_launch(monkeypatch):
    """A tensor that is on neither the CPU nor a card raises ValueError
    before the library is asked for."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(build, "load", refuse)
    meta = [torch.empty(s, dtype=dt, device="meta") for s, dt in (
        ((2, 3), torch.float32), ((2, 4, 3), torch.float32),
        ((5, 3), torch.float32), ((4, 3), torch.int64),
        ((4,), torch.int64))]
    before = RS.launches
    with pytest.raises(ValueError, match="unsupported device"):
        RS.raycast_hits(*meta)
    assert RS.launches == before


def _bad_inputs(case):
    """A CPU cast's arguments with one of them broken as ``case`` says."""
    jm = _mesh("masked")
    origins, dirs = _rays(np.random.default_rng(3), jm, G=2, K=8)
    mesh = convert.mesh(jm, device="cpu")
    args = [torch.as_tensor(origins), torch.as_tensor(dirs), mesh.vertices,
            mesh.triangles, mesh.masked_triangles]
    which, how = case.split(":")
    i = ("origins", "dirs", "vertices", "triangles", "words").index(which)
    a = args[i]
    args[i] = {"float64": lambda: a.double(), "int32": lambda: a.int(),
               "float32": lambda: a.float(), "shape": lambda: a[..., :2],
               "strided": lambda: a.t().contiguous().t(), "short": lambda: a[:3],
               "meta": lambda: a.to("meta"),
               "flat": lambda: a.reshape(-1)}[how]()
    return args


@pytest.mark.parametrize("case", [
    "vertices:float64", "vertices:shape", "vertices:strided",
    "vertices:meta", "triangles:int32", "triangles:float32",
    "triangles:shape", "triangles:meta", "words:int32", "words:short",
    "words:meta", "origins:flat", "dirs:float64"])
def test_wrapper_checks_raise_without_the_library(case, monkeypatch):
    """The wrapper's argument checks (type, shape, contiguity, device) raise
    ValueError on CPU-built inputs before any route, the library never
    loaded."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(build, "load", refuse)
    args = _bad_inputs(case)
    before = RS.launches
    with pytest.raises(ValueError):
        RS.raycast_hits(*args)
    assert RS.launches == before


@pytest.mark.parametrize("G,K,T,sms,want", [
    (4, 2048, 20224, 132, (4, False, 16, 2)),   # a tracking frame
    (250, 128, 1472, 132, (4, False, 1, 1)),    # config 4's prim refresh
    (32000, 1, 1472, 132, (4, True, 250, 1)),   # the sharded flat cast
    (7, 333, 5040, 132, (4, False, 3, 4)),
    (2000, 1, 1472, 132, (4, True, 16, 2)),     # groups of one, packed
    (7, 7, 5040, 132, (4, True, 1, 8)),         # K < 32: groups packed
    (16, 31, 2944, 132, (4, True, 4, 4)),
    (1, 5, 100, 132, (4, True, 1, 1)),          # fewer triangles than a tile
    (1, 64, 100_000, 132, (2, False, 1, 8)),    # clusters capped
    (3, 32, 4096, 132, (2, False, 1, 8)),       # K 32 to 64: two a thread
    (4, 48, 20224, 132, (2, False, 1, 8)),      # a frame of 48 keypoints
    (4, 2048, 20224, 16, (4, False, 16, 1)),    # the rays fill a small card
])
def test_launch_plan(G, K, T, sms, want):
    plan = RS.launch_plan(G, K, T, sms)
    assert tuple(plan) == want
    R, packed, ray_blocks, cluster = plan
    rays = 32 * R
    assert packed == (K < RS.PACKED_BELOW)
    live = G * K if packed else K
    assert ray_blocks * rays >= live > (ray_blocks - 1) * rays
    blocks = ray_blocks * (1 if packed else G)
    assert cluster == 1 or (blocks * cluster <= sms * RS.BLOCKS_PER_SM
                            and T >= cluster * RS.TILE)
    assert 1 <= cluster <= RS.CLUSTER_MAX and cluster & (cluster - 1) == 0
