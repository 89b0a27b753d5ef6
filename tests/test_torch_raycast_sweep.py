"""The closest-hit sweep of ``raycast_grouped``: the plain version of K5
(``engine.raycast.sweep_plain``) and the dispatch in front of it, on the CPU.

- ``sweep_plain`` against the JAX package's ``raycast_grouped`` (XLA on the
  CPU, without the mask) on tests/test_torch_raycast.py's plain, masked and
  duplicated meshes, at the default chunk and at 64 (a sweep of 352
  triangles in six chunks, the last one padded): ids equal on every ray,
  t within rtol 1e-5 where both hit (the two packages' cross products and
  sums round differently).
- Its own invariants, to the bit: ties go to the lowest id (every triangle
  duplicated), the chunk does not change an id or a t, nor does casting
  each ray as a group of one (the sharded flat cast's shape).
- ``raycast_grouped`` against a copy of its arithmetic before the sweep was
  factored out, every field to the bit.
- The dispatch: CPU tensors never load the kernel library; anything else
  that is not a card raises; ``launch_plan``'s blocks and splits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychase_tpu.engine.raycast import raycast_grouped as jax_cast

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine import raycast as R
from polychase_tpu_torch.engine.pose import cross
from polychase_tpu_torch.kernels import build, raycast_sweep as RS

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


def _raycast_grouped_before(mesh, origins, dirs, check_mask=True, chunk=0):
    """``raycast_grouped`` as it was before its sweep became
    ``sweep_plain``, with its chunk rule of 32M-element temporaries."""
    origins = origins.to(torch.float32).reshape(-1, 3)
    G = origins.shape[0]
    dirs = dirs.to(torch.float32).reshape(G, -1, 3)
    K = dirs.shape[1]
    p1, p2, p3 = mesh.triangle_corners()
    num_tris = p1.shape[0]
    if chunk <= 0:
        chunk = max(64, min(4096, (1 << 25) // max(G * K, 1)))
        chunk = max(64, (chunk // 64) * 64)
        if num_tris < chunk:
            cover = 64
            while cover < num_tris:
                cover *= 2
            chunk = cover
    pad = (-num_tris) % chunk
    if pad:
        z = torch.zeros((pad, 3), dtype=p1.dtype)
        p1, p2, p3 = (torch.cat([p, z]) for p in (p1, p2, p3))
    e1_all, e2_all = p2 - p1, p3 - p1
    best_t = torch.full((G, K), torch.inf, dtype=torch.float32)
    best_id = torch.full((G, K), R.INVALID_ID, dtype=torch.int64)
    d0, d1, d2 = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    lane = torch.arange(chunk, dtype=torch.int64)
    for base in range(0, num_tris + pad, chunk):
        v0 = p1[base:base + chunk]
        e1 = e1_all[base:base + chunk]
        e2 = e2_all[base:base + chunk]
        A = cross(e2, e1)
        omv = origins[:, None, :] - v0[None]
        B = cross(e2[None], omv)
        Cq = cross(omv, e1[None])
        sdet = torch.sum(e2[None] * Cq, dim=-1)

        def dot3(x):
            x = x[:, None]
            return d0 * x[..., 0] + d1 * x[..., 1] + d2 * x[..., 2]

        det = dot3(A[None])
        udet = dot3(B)
        vdet = dot3(Cq)
        s = torch.where(det >= 0, 1.0, -1.0)
        adet = det * s
        u_, v_ = udet * s, vdet * s
        t_ = sdet[:, None, :] * s
        hit = ((adet > R._EPS) & (u_ >= 0) & (v_ >= 0) & (u_ + v_ <= adet)
               & (t_ > 0) & ((base + lane) < num_tris))
        t = torch.where(hit, t_ / torch.where(hit, adet,
                                              torch.ones_like(adet)),
                        torch.full_like(adet, torch.inf))
        j = torch.argmin(t, dim=-1)
        tj = torch.gather(t, -1, j[..., None])[..., 0]
        closer = tj < best_t
        best_id = torch.where(closer, base + j, best_id)
        best_t = torch.where(closer, tj, best_t)
    valid = R._unmasked(mesh, best_id, check_mask)
    safe_id = torch.where(valid, best_id, torch.zeros_like(best_id))
    q1, q2, q3 = p1[safe_id], p2[safe_id], p3[safe_id]
    be1, be2 = q2 - q1, q3 - q1
    bomv = origins[:, None, :] - q1
    bB = cross(be2, bomv)
    bCq = cross(bomv, be1)
    bdet = torch.sum(dirs * cross(be2, be1), dim=-1)
    bdet_ok = torch.abs(bdet) > R._EPS
    valid = valid & bdet_ok
    binv = torch.where(valid, 1.0 / torch.where(bdet_ok, bdet,
                                                torch.ones_like(bdet)),
                       torch.zeros_like(bdet))
    uv = torch.stack([torch.sum(dirs * bB, dim=-1) * binv,
                      torch.sum(dirs * bCq, dim=-1) * binv], dim=-1)
    return R._ray_hits(q1, q2, q3, uv, best_t, best_id, valid)


@pytest.mark.parametrize("kind,chunk", [("plain", 0), ("masked", 0),
                                        ("duplicated", 0), ("masked", 64)])
def test_raycast_grouped_unchanged_by_the_refactor(kind, chunk):
    rng = np.random.default_rng(13)
    jm = _mesh(kind)
    origins, dirs = _rays(rng, jm, G=5, K=120)
    mesh = convert.mesh(jm, device="cpu")
    args = (mesh, torch.as_tensor(origins), torch.as_tensor(dirs), True,
            chunk)
    got, want = R.raycast_grouped(*args), _raycast_grouped_before(*args)
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
    hits = R.raycast_grouped(mesh, torch.as_tensor(origins),
                             torch.as_tensor(dirs))
    t, ids = RS.raycast_sweep(torch.as_tensor(origins),
                              torch.as_tensor(dirs), *_tris(mesh))
    assert RS.launches == before
    assert hits.valid.any()
    want = R.sweep_plain(torch.as_tensor(origins), torch.as_tensor(dirs),
                         *_tris(mesh))
    assert torch.equal(ids, want[1]) and torch.equal(t, want[0])


def test_other_devices_raise_without_a_launch(monkeypatch):
    """A tensor that is on neither the CPU nor a card raises ValueError
    before the library is asked for."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(build, "load", refuse)
    meta = [torch.empty(s, device="meta") for s in ((2, 3), (2, 4, 3),
                                                    (5, 3), (5, 3), (5, 3))]
    before = RS.launches
    with pytest.raises(ValueError):
        RS.raycast_sweep(*meta)
    assert RS.launches == before


@pytest.mark.parametrize("G,K,T,sms,want", [
    (4, 2048, 20224, 132, (128, 16, 17)),   # a tracking frame
    (250, 128, 1472, 132, (128, 1, 5)),     # config 4's prim refresh
    (32000, 1, 1472, 132, (32, 1, 1)),      # the sharded flat cast
    (7, 333, 5040, 132, (128, 3, 19)),
    (1, 5, 100, 132, (32, 1, 1)),           # fewer triangles than a split
    (1, 64, 100_000, 132, (64, 1, 64)),     # splits capped
])
def test_launch_plan(G, K, T, sms, want):
    plan = RS.launch_plan(G, K, T, sms)
    assert tuple(plan) == want
    assert plan.threads % 32 == 0 and plan.threads <= RS.THREADS_MAX
    assert plan.ray_blocks * plan.threads >= K
    assert (plan.ray_blocks - 1) * plan.threads < K
    assert 1 <= plan.splits <= max(1, T // RS.SPLIT_MIN_TRIS)
