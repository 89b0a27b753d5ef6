"""The port's sharded refine (``parallel/sharded.py`` and
``refine_trajectory`` on a device list) against its one-device refine and
the JAX package's sharded refine, on test_sharded.py's 8-frame problem
(an orbit over a 12×16 sphere, translations noised by N(0, 0.01)).

- ``sharded_normal_equations`` on 3 CPU shards (``["cpu"] * 3``, 8 frames'
  edges split unevenly) against the JAX ``sharded_normal_equations`` on an
  8-device edge mesh and against the port's ``build_normal_equations``, at
  6 and 9 parameters a camera: rtol 1e-3, atol 1e-5 × the largest entry
  (test_sharded.py's gate; the sum order differs across shards).
- The prim refresh ``refine_trajectory`` takes on 3 shards: the one-device
  refresh's prims and cost to the bit.
- ``sharded_refine_step``: the solve succeeds, the step is finite and
  non-zero, the anchors keep their bits, and the stepped cameras lie within
  1e-5 of the one-device step's.
- ``refine_trajectory(device=["cpu"] * 3)`` against ``device="cpu"`` and
  against the JAX ``refine_trajectory(device_mesh=make_edge_mesh())``:
  every pose within 2e-3 rad and 4e-3 (test_sharded.py's bars); a list of
  one gives the one-device result to the bit.
- A list that mixes the CPU and CUDA devices raises ``ValueError`` at every
  entry point that takes one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychase_tpu.engine.levmarq import BundleOptions, CAUCHY
from polychase_tpu.engine.refiner import refine_trajectory as jax_refine
from polychase_tpu.engine.trajectory import CameraTrajectory as JTraj
from polychase_tpu.parallel.sharded import (
    make_edge_mesh,
    sharded_normal_equations_jit as jax_normal_equations,
)

from polychase_tpu_torch import convert
from polychase_tpu_torch.engine import camera as TC
from polychase_tpu_torch.engine import refiner as TR
from polychase_tpu_torch.engine.opticalflow import (
    VideoInfo,
    generate_optical_flow_database,
)
from polychase_tpu_torch.parallel import analyze as PA
from polychase_tpu_torch.parallel import raycast as PR
from polychase_tpu_torch.parallel import sharded as PS

from synthetic import make_intrinsics, make_sphere_mesh, orbit_pose
from test_refiner import perturbed_traj
from test_sharded import build_problem
from test_tracker import pose_errors

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHARDS = ["cpu"] * 3
ROT_ATOL, T_ATOL, STEP_ATOL = 2e-3, 4e-3, 1e-5
EYE = np.eye(4, dtype=np.float32)
N_FRAMES = 8


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """test_sharded.py's problem in both packages: (mesh, data, params,
    prims, model) of the JAX package and the port's arguments of
    ``build_normal_equations`` on the same state; and its flow DB."""
    tmp = tmp_path_factory.mktemp("problem")
    jax_problem = build_problem(tmp, np.random.default_rng(0))
    mesh, data, params, prims, _ = jax_problem
    port_mesh = convert.mesh(mesh, device=CPU)
    eye = torch.eye(4)
    port = (convert.traj_params(params, device=CPU),
            convert.refiner_data(data, device=CPU),
            torch.as_tensor(np.asarray(prims).astype(np.int64)),
            port_mesh.triangle_corners(), eye, eye, 1.0)
    return jax_problem, port, str(tmp / "flow.db")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-3,
                               atol=1e-5 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("ppc", [6, 9])
def test_sharded_normal_equations_match(problem, ppc):
    (mesh, data, params, prims, model), port, _ = problem
    kw = dict(loss_type=CAUCHY, opt_f=ppc == 9, opt_pp=ppc == 9, ppc=ppc)
    ref = jax_normal_equations(
        make_edge_mesh(jax.devices()[:8]), params, data, prims,
        mesh.triangle_corners(), model, model, jnp.float32(1.0), **kw)
    got = PS.sharded_normal_equations(SHARDS, *port, **kw)
    one = TR.build_normal_equations(*port, **kw)
    assert got[0].shape == (N_FRAMES * ppc,) * 2
    for g, r, o in zip(got, ref, one):
        _close(g.numpy(), r)
        _close(g.numpy(), o.numpy())


def test_sharded_refine_step(problem):
    _, port, _ = problem
    params, data = port[:2]
    bounds = TC.intrinsics_bounds(convert.intrinsics(make_intrinsics(),
                                                     device=CPU))
    kw = dict(loss_type=CAUCHY, opt_f=False, opt_pp=False, ppc=6)
    new, step_norm, ok = PS.sharded_refine_step(SHARDS, *port, 1e-4, bounds,
                                                **kw)
    assert bool(ok)
    assert np.isfinite(float(step_norm)) and float(step_norm) > 0
    step, one_ok = TR.solve_step(*TR.build_normal_equations(*port, **kw),
                                 1e-4, ())
    one = TR.apply_step(params, data, step, bounds, opt_f=False,
                        opt_pp=False, ppc=6)
    assert bool(one_ok)
    for a, b, c in zip(TR._fields(new), TR._fields(one), TR._fields(params)):
        torch.testing.assert_close(a[[0, -1]], c[[0, -1]], rtol=0, atol=0)
        torch.testing.assert_close(a, b, rtol=0, atol=STEP_ATOL)


def test_sharded_prim_refresh_is_the_one_device_refresh(problem):
    """The prim refresh ``refine_trajectory`` takes on 3 shards (the frames'
    ray groups split unevenly) gives the one-device refresh's prims and
    cost to the bit."""
    (mesh, *_), port, _ = problem
    params, data, _, tri, model, model_inv, scale = port
    args = (data, convert.mesh(mesh, device=CPU), model, model_inv, tri,
            scale, CAUCHY)
    one = TR._make_prim_refresher(*args, routing=False)(params)
    got = TR._make_prim_refresher(*args, routing=False,
                                  devices=[CPU] * 3)(params)
    assert int((one[0] >= 0).sum()) > 0
    for g, o in zip(got, one):
        torch.testing.assert_close(g, o, rtol=0, atol=0)


@pytest.fixture(scope="module")
def refines(problem):
    """test_sharded.py's end-to-end refine (on the problem's flow DB) from
    one noisy start: the JAX package's on its 8-device edge mesh, and the
    port's on one device, on a list of one and on 3 shards."""
    mesh, intr = make_sphere_mesh(), make_intrinsics()
    poses = [orbit_pose(0.05 * t) for t in range(N_FRAMES)]
    db = problem[2]
    start = perturbed_traj(poses, intr, np.random.default_rng(1))
    opts = BundleOptions(loss_type=CAUCHY, loss_scale=1.0)

    ref = JTraj(0, N_FRAMES)
    for i in range(N_FRAMES):
        ref.set(i, start.get(i))
    jax_refine(db, ref, EYE, mesh, bundle_opts=opts,
               device_mesh=make_edge_mesh())
    port_mesh = convert.mesh(mesh, device=CPU)
    out = {}
    for name, device in (("one", "cpu"), ("list of one", ["cpu"]),
                         ("shards", SHARDS)):
        traj = convert.camera_trajectory(start, device=CPU)
        TR.refine_trajectory(db, traj, EYE, port_mesh,
                             bundle_opts=convert.bundle_options(opts),
                             device=device)
        out[name] = traj
    return poses, ref, out


def _poses(traj):
    return [traj.get(i).pose for i in range(N_FRAMES)]


@pytest.mark.parametrize("against", ["one device", "jax"])
def test_refine_over_devices_matches(refines, against):
    poses, ref, out = refines
    want = _poses(out["one"] if against == "one device" else ref)
    for i, (a, b) in enumerate(zip(_poses(out["shards"]), want)):
        rot_err, t_err = pose_errors(a, b)
        assert rot_err < ROT_ATOL, (i, rot_err)
        assert t_err < T_ATOL, (i, t_err)


def test_refine_on_a_list_of_one_is_the_one_device_refine(refines):
    _, _, out = refines
    for a, b in zip(_poses(out["list of one"]), _poses(out["one"])):
        torch.testing.assert_close(a.q, b.q, rtol=0, atol=0)
        torch.testing.assert_close(a.t, b.t, rtol=0, atol=0)


MIXED = ["cpu", "cuda:0"]


@pytest.mark.parametrize("entry", [
    "refine_trajectory", "sharded_normal_equations", "sharded_raycast_flat",
    "sharded_lk_multi", "generate_optical_flow_database"])
def test_mixed_device_lists_raise(problem, tmp_path, entry):
    port = problem[1]
    z = torch.zeros((4, 3))
    calls = {
        "refine_trajectory": lambda: TR.refine_trajectory(
            str(tmp_path / "none.db"), None, EYE, None, device=MIXED),
        "sharded_normal_equations": lambda: PS.sharded_normal_equations(
            MIXED, *port, loss_type=CAUCHY, opt_f=False, opt_pp=False,
            ppc=6),
        "sharded_raycast_flat": lambda: PR.sharded_raycast_flat(
            MIXED, None, z, z),
        "sharded_lk_multi": lambda: PA.sharded_lk_multi(
            MIXED, [], [z[None]], z[:, :2], 1e-4, 1e-4, win=10, max_iters=30,
            levels=1),
        "generate_optical_flow_database": lambda: (
            generate_optical_flow_database(
                VideoInfo(16, 16, 0, 2), lambda f: None, None,
                str(tmp_path / "flow.db"), device=MIXED)),
    }
    with pytest.raises(ValueError, match="mixes"):
        calls[entry]()
