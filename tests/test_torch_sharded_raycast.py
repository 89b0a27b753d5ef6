"""The port's ray cast split over devices (``parallel/raycast.py``) against
its one-device cast and the JAX package's sharded casts.

12 groups of 64 rays from random origins around test_sharded_raycast.py's
sphere (12×16), on 2 and 3 CPU shards (``["cpu"] * n``); the flat cast
takes the same rays less the last five, so the padding is exercised.  The
JAX side runs ``sharded_raycast_grouped`` and ``sharded_raycast_flat`` on 4
of the conftest's 8 CPU devices.  Gates: prim ids and ``valid`` equal,
``t`` within 1e-5 on valid hits (a split changes no ray's arithmetic).
``split_cast`` (refine's prim refresh) on 5 and 7 uneven shards equals the
one-device cast to the bit.
"""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychase_tpu.parallel.raycast import (
    make_ray_mesh,
    sharded_raycast_flat as jax_flat,
    sharded_raycast_grouped as jax_grouped,
)

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine.raycast import raycast_grouped
from polychase_tpu_torch.parallel import raycast as PR

from synthetic import make_sphere_mesh

torch.set_num_threads(1)

G, K, FLAT_CUT = 12, 64, 5
T_ATOL = 1e-5


@pytest.fixture(scope="module")
def rays():
    """The rays, the JAX mesh and the JAX package's grouped and flat hits
    on a 4-device mesh."""
    rng = np.random.default_rng(0)
    origins = rng.normal(size=(G, 3)).astype(np.float32)
    origins = 4.0 * origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    dirs = (rng.normal(0, 0.5, (G, K, 3))
            - origins[:, None, :]).astype(np.float32)
    jmesh = make_sphere_mesh(12, 16)
    ray_mesh = make_ray_mesh(jax.devices()[:4])
    n = G * K - FLAT_CUT
    o_flat = np.repeat(origins, K, axis=0)[:n]
    d_flat = dirs.reshape(-1, 3)[:n]
    grouped = jax_grouped(ray_mesh, jmesh, jnp.asarray(origins),
                          jnp.asarray(dirs))
    flat = jax_flat(ray_mesh, jmesh, jnp.asarray(o_flat), jnp.asarray(d_flat))
    return dict(origins=origins, dirs=dirs, o_flat=o_flat, d_flat=d_flat,
                mesh=convert.mesh(jmesh, device="cpu"),
                jax={"grouped": grouped, "flat": flat})


def _check(got, want):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.prim_id.numpy()[valid],
                                  np.asarray(want.prim_id)[valid])
    np.testing.assert_allclose(got.t.numpy()[valid],
                               np.asarray(want.t)[valid], rtol=0, atol=T_ATOL)


@pytest.mark.parametrize("kind", ["grouped", "flat"])
@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_cast_matches_one_device_and_jax(rays, kind, n_shards):
    """Prim ids and ``valid`` equal, ``t`` within 1e-5, against the port's
    one-device cast and the JAX package's sharded cast."""
    mesh, devices = rays["mesh"], ["cpu"] * n_shards
    one = raycast_grouped(mesh, torch.as_tensor(rays["origins"]),
                          torch.as_tensor(rays["dirs"]))
    if kind == "grouped":
        got = PR.sharded_raycast_grouped(
            devices, mesh, torch.as_tensor(rays["origins"]),
            torch.as_tensor(rays["dirs"]))
        assert got.prim_id.shape == (G, K)
        _check(got, one)
    else:
        got = PR.sharded_raycast_flat(
            devices, mesh, torch.as_tensor(rays["o_flat"]),
            torch.as_tensor(rays["d_flat"]))
        n = G * K - FLAT_CUT
        assert got.prim_id.shape == (n,) and got.pos.shape == (n, 3)
        flat_one = type(one)(*(v.reshape(G * K, *v.shape[2:])[:n] for v in (
            one.pos, one.normal, one.barycentric, one.t, one.prim_id,
            one.valid)))
        _check(got, flat_one)
    _check(got, rays["jax"][kind])


@pytest.mark.parametrize("n_shards", [5, 7])
def test_split_cast_takes_uneven_shards(rays, n_shards):
    """``split_cast``, the sharded refine's prim refresh, on a device count
    that does not divide the 12 groups: every field of the one-device
    cast to the bit."""
    mesh = rays["mesh"]
    origins, dirs = (torch.as_tensor(rays["origins"]),
                     torch.as_tensor(rays["dirs"]))
    one = raycast_grouped(mesh, origins, dirs)
    got = PR.split_cast(["cpu"] * n_shards, [mesh] * n_shards, origins, dirs)
    assert bool(one.valid.any())
    for f in fields(one):
        torch.testing.assert_close(getattr(got, f.name), getattr(one, f.name),
                                   rtol=0, atol=0)


def test_sharded_cast_refuses_indivisible_groups(rays):
    """As the reference: a group count the device count does not divide
    raises ``ValueError``."""
    with pytest.raises(ValueError, match="divisible"):
        PR.sharded_raycast_grouped(
            ["cpu"] * 5, rays["mesh"], torch.as_tensor(rays["origins"]),
            torch.as_tensor(rays["dirs"]))
