"""The port's ray casts (grouped and general) and BA intersections against
the JAX package's, on the same numpy-seeded rays: triangle ids and
``valid`` equal, hit positions atol 1e-5 (1e-4 for the general cast).
Covers masked triangles (which still occlude), exact ties (a mesh whose
triangles are duplicated: the lowest id wins in both), grazing rays along
the silhouette, misses, and a sweep split into many triangle chunks.

Rays aimed exactly at a vertex or along an edge are left out: whether such
a ray counts as inside a triangle is decided by the last bit of rounding,
which differs between XLA's fused loops and torch's kernels."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polychase_tpu.engine.geometry import Mesh as JMesh, set_mask_bits
from polychase_tpu.engine.raycast import raycast_grouped as jax_cast

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine.raycast import INVALID_ID, raycast_grouped

from synthetic import make_sphere_mesh

torch.set_num_threads(1)


def _rays(rng, mesh, G=4, K=96):
    ang = rng.uniform(0, 2 * np.pi, G)
    origins = np.stack(
        [4 * np.sin(ang), rng.uniform(-0.5, 0.5, G), -4 * np.cos(ang)], -1
    ).astype(np.float32)
    targets = rng.normal(size=(G, K, 3)) * 0.7
    # Grazing rays: tangent to the unit sphere, just inside and outside.
    for g in range(G):
        o = origins[g].astype(np.float64)
        side = np.cross(o, [0.0, 1.0, 0.0])
        side /= np.linalg.norm(side)
        d = np.linalg.norm(o)
        for k, r in enumerate((0.97, 0.99, 1.0, 1.01)):
            targets[g, k] = side * r * d / np.sqrt(d * d - r * r)
    # Misses: aimed far outside the sphere.
    targets[:, -4:] = [[5.0, 5.0, 5.0]]
    dirs = (targets - origins[:, None, :]).astype(np.float32)
    return origins, dirs


def _mesh(kind, seed=1):
    jm = make_sphere_mesh()
    verts, tris = np.asarray(jm.vertices), np.asarray(jm.triangles)
    words = np.asarray(jm.masked_triangles)
    if kind == "masked":
        rng = np.random.default_rng(seed)
        for i in rng.choice(len(tris), 40, replace=False):
            words = set_mask_bits(words, int(i), "mask")
    if kind == "duplicated":
        tris = np.concatenate([tris, tris])
        words = None
    return JMesh.create(verts, tris, words)


@pytest.mark.parametrize("kind", ["plain", "masked", "duplicated"])
@pytest.mark.parametrize("chunk", [0, 64])
def test_matches_jax(rng, kind, chunk):
    jm = _mesh(kind)
    origins, dirs = _rays(rng, jm)
    ref = jax_cast(jm, jnp.asarray(origins), jnp.asarray(dirs), True, chunk)
    got = raycast_grouped(
        convert.mesh(jm, device="cpu"), torch.as_tensor(origins),
        torch.as_tensor(dirs), True, chunk,
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(
        got.prim_id.numpy().astype(np.uint32), np.asarray(ref.prim_id)
    )
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.barycentric.numpy(),
                               np.asarray(ref.barycentric), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(ref.normal),
                               atol=1e-5, rtol=0)
    v = got.valid.numpy()
    np.testing.assert_allclose(got.t.numpy()[v], np.asarray(ref.t)[v],
                               rtol=1e-5)
    assert v.any() and (~v).any()
    assert (got.prim_id.numpy()[~v] == INVALID_ID).all()
    if kind == "duplicated":
        assert (got.prim_id.numpy()[v] < jm.num_triangles // 2).all()


def test_masked_triangles_occlude(rng):
    """A masked closest hit is dropped, not replaced by the hit behind it."""
    jm = make_sphere_mesh()
    origins, dirs = _rays(rng, jm)
    mesh = convert.mesh(jm, device="cpu")
    clear = raycast_grouped(mesh, torch.as_tensor(origins),
                            torch.as_tensor(dirs))
    words = np.zeros(np.asarray(jm.masked_triangles).shape, np.uint32)
    for i in np.unique(clear.prim_id.numpy()[clear.valid.numpy()])[::2]:
        words = set_mask_bits(words, int(i), "mask")
    masked = convert.mesh(
        JMesh.create(np.asarray(jm.vertices), np.asarray(jm.triangles), words),
        device="cpu",
    )
    got = raycast_grouped(masked, torch.as_tensor(origins),
                          torch.as_tensor(dirs))
    hidden = clear.valid & masked.is_triangle_masked(
        torch.where(clear.valid, clear.prim_id, 0)
    )
    assert hidden.any()
    assert not got.valid[hidden].any()
    keep = clear.valid & ~hidden
    np.testing.assert_array_equal(got.prim_id[keep].numpy(),
                                  clear.prim_id[keep].numpy())


# ---------------------------------------------------------------------------
# The general ray cast (N rays, own origins) and the BA intersections
# ---------------------------------------------------------------------------


def _flat_rays(rng, mesh):
    """test_matches_jax's grouped rays, each given its own origin by a
    small jitter along its direction (the hit stays the same triangle but
    no two rays share an origin)."""
    origins, dirs = _rays(rng, mesh)
    G, K = dirs.shape[:2]
    o = np.repeat(origins[:, None, :], K, axis=1)
    o = o + dirs * rng.uniform(0.0, 0.05, (G, K, 1)).astype(np.float32)
    return o.reshape(-1, 3).astype(np.float32), dirs.reshape(-1, 3)


@pytest.mark.parametrize("kind", ["plain", "masked", "duplicated"])
@pytest.mark.parametrize("chunk", [1024, 64])
def test_general_raycast_matches_jax(rng, kind, chunk):
    from polychase_tpu.engine.raycast import raycast as jax_raycast
    from polychase_tpu_torch.engine.raycast import raycast

    jm = _mesh(kind)
    origins, dirs = _flat_rays(rng, jm)
    ref = jax_raycast(jm, jnp.asarray(origins), jnp.asarray(dirs), True,
                      chunk)
    got = raycast(convert.mesh(jm, device="cpu"), torch.as_tensor(origins),
                  torch.as_tensor(dirs), True, chunk)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(
        got.prim_id.numpy().astype(np.uint32), np.asarray(ref.prim_id))
    # The carried barycentrics divide by the determinant, which is small on
    # the grazing rays: 1e-4 there.
    for f in ("pos", "barycentric", "normal"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-4,
                                   rtol=0)
    v = got.valid.numpy()
    assert v.any() and (~v).any()


def test_ray_world_space_matches_jax(rng):
    from polychase_tpu.engine import pose as JP
    from polychase_tpu.engine.geometry import SceneTransformations as JS
    from polychase_tpu.engine.raycast import get_ray_world_space as jax_ray
    from polychase_tpu_torch.engine.raycast import get_ray_world_space

    from synthetic import make_intrinsics, orbit_pose

    scene = JS(jnp.eye(4), JP.pose_rt4x4(orbit_pose(0.3)),
               make_intrinsics())
    tscene = convert.scene_transformations(scene, device="cpu")
    for pos in rng.uniform(0, 480, (4, 2)).astype(np.float32):
        o_ref, d_ref = jax_ray(scene, jnp.asarray(pos))
        o, d = get_ray_world_space(tscene, torch.as_tensor(pos))
        np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-5)
        np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-6)


def test_ba_intersections_match_jax(rng):
    """``intersect_ray_plane_jac`` with its |d·n| > 1e-10 gate (rays
    parallel to the plane), and ``intersect_ray_triangle`` with its t ≥ 0
    and u ≤ 1 tests (origins on the triangle's plane)."""
    from polychase_tpu.engine.raycast import (
        intersect_ray_plane_jac as jax_plane,
        intersect_ray_triangle as jax_tri,
    )
    from polychase_tpu_torch.engine.raycast import (
        intersect_ray_plane_jac,
        intersect_ray_triangle,
    )

    n = 256
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    p1 = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    p2 = p1 + rng.normal(size=(n, 3)).astype(np.float32)
    p3 = p1 + rng.normal(size=(n, 3)).astype(np.float32)
    normal = np.cross(p2 - p1, p3 - p1).astype(np.float32)
    # Parallel to the plane: d · n = 0 exactly for a unit-axis normal.
    normal[:16] = [0.0, 0.0, 1.0]
    d[:16, 2] = 0.0
    # Origins on the triangle itself: t = 0.
    o[16:32] = (p1[16:32] + 0.25 * (p2[16:32] - p1[16:32])
                + 0.25 * (p3[16:32] - p1[16:32]))
    for got, ref in zip(
        intersect_ray_plane_jac(*(torch.as_tensor(a) for a in (o, d, p1,
                                                                normal))),
        jax_plane(*(jnp.asarray(a) for a in (o, d, p1, normal))),
    ):
        got, ref = got.numpy(), np.asarray(ref)
        if got.dtype == bool:
            np.testing.assert_array_equal(got, ref)
        else:
            ok = np.asarray(jax_plane(o, d, p1, normal)[3])
            np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-4,
                                       atol=1e-4)
    assert not intersect_ray_plane_jac(
        *(torch.as_tensor(a) for a in (o, d, p1, normal)))[3][:16].any()
    x, ok = intersect_ray_triangle(*(torch.as_tensor(a)
                                     for a in (o, d, p1, p2, p3)))
    x_ref, ok_ref = jax_tri(*(jnp.asarray(a) for a in (o, d, p1, p2, p3)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    k = ok.numpy()
    np.testing.assert_allclose(x.numpy()[k], np.asarray(x_ref)[k], atol=1e-5)
    assert k[16:32].any() and k.sum() < n
