"""The port's plain PnP solve (polychase_tpu_torch.engine.pnp.solve_arrays,
the CPU arm of the K1 wrapper) against the JAX package's XLA solve and its
Pallas kernel run in interpret mode, on the cases of test_pnp_pallas.py and
with its tolerances: pose atol 5e-4 (1e-3 with free intrinsics), inlier
ratio atol 1e-3, cost rtol 1e-3 (for the 4- to 8-point pin solves, of the
range of JAX's costs over orders of the points).  The solvers sum in
different orders, so they agree to float tolerance, not bitwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from polychase_tpu.engine.levmarq import BundleOptions as JaxBundleOptions
from polychase_tpu.engine.pnp import solve_arrays as jax_solve_arrays
from polychase_tpu.kernels.pnp_pallas import solve_arrays_pallas

from polychase_tpu_torch import convert
from polychase_tpu_torch.kernels.pnp_lm import solve_arrays_lm

from test_pnp_pallas import _scene, _scene_cv

torch.set_num_threads(1)


def _port(X, x, w, mask, params, opts, opt_f=False, opt_pp=False):
    t = lambda a: torch.as_tensor(np.asarray(a))[None]  # noqa: E731
    out = solve_arrays_lm(
        t(X), t(x), t(w), t(mask), t(params), opt_f=opt_f, opt_pp=opt_pp,
        opts=convert.bundle_options(opts),
    )
    return out[0].numpy()


def _jax(X, x, w, mask, params, opts, opt_f=False, opt_pp=False):
    args = [jnp.asarray(a) for a in (X, x, w, mask, params)]
    ref = jax_solve_arrays(*args, opt_f=opt_f, opt_pp=opt_pp, opts=opts)
    pal = solve_arrays_pallas(
        *args, opt_f=opt_f, opt_pp=opt_pp, opts=opts, interpret=True
    )
    return np.asarray(jax.device_get(ref)), np.asarray(jax.device_get(pal))



def _check_pose(got, refs, atol=5e-4):
    for ref in refs:
        np.testing.assert_allclose(got[:7], ref[:7], atol=atol)
        np.testing.assert_allclose(got[18], ref[18], atol=1e-3)


@pytest.mark.parametrize("loss_type", [0, 1, 2])
@pytest.mark.parametrize("ftol", [0.0, 1e-5])
def test_losses(loss_type, ftol):
    X, x, w, mask, params, q_gt, t_gt = _scene()
    opts = JaxBundleOptions(
        max_iterations=30, loss_type=loss_type, function_tol=ftol
    )
    got = _port(X, x, w, mask, params, opts)
    refs = _jax(X, x, w, mask, params, opts)
    _check_pose(got, refs)
    for ref in refs:
        np.testing.assert_allclose(got[13], ref[13], rtol=1e-3)
    err_q = min(np.linalg.norm(got[:4] - q_gt), np.linalg.norm(got[:4] + q_gt))
    assert err_q < 2e-3
    assert np.abs(got[4:7] - t_gt).max() < 2e-2


def test_behind_camera():
    X, x, w, mask, params, _, _ = _scene(behind=40)
    opts = JaxBundleOptions(max_iterations=30, loss_type=2, function_tol=1e-5)
    got = _port(X, x, w, mask, params, opts)
    _check_pose(got, _jax(X, x, w, mask, params, opts))


def test_behind_camera_trivial_cost_overflows():
    """A few hundred behind points overflow the f32 Trivial cost to inf;
    every step is then rejected and the pose stays at the warm start, in
    the port as in the reference."""
    X, x, w, mask, params, _, _ = _scene(n=600, n_masked=0, behind=250)
    opts = JaxBundleOptions(max_iterations=10, loss_type=0)
    got = _port(X, x, w, mask, params, opts)
    refs = _jax(X, x, w, mask, params, opts)
    assert np.isinf(got[12]) and all(np.isinf(r[12]) for r in refs)
    _check_pose(got, refs, atol=1e-6)
    np.testing.assert_array_equal(got[:7], params[:7])


def test_all_masked_off():
    X, x, w, mask, params, _, _ = _scene()
    mask[:] = False
    w[:] = 0.0
    opts = JaxBundleOptions(max_iterations=10, loss_type=1)
    got = _port(X, x, w, mask, params, opts)
    assert np.all(np.isfinite(got[:11]))
    for ref in _jax(X, x, w, mask, params, opts):
        np.testing.assert_allclose(got[:7], ref[:7], atol=1e-5)
    assert got[18] == 0.0


def test_non_multiple_of_lane_n():
    X, x, w, mask, params, _, _ = _scene(n=333, n_masked=20)
    opts = JaxBundleOptions(max_iterations=30, loss_type=1, function_tol=1e-5)
    got = _port(X, x, w, mask, params, opts)
    _check_pose(got, _jax(X, x, w, mask, params, opts))


@pytest.mark.parametrize(
    "opt_f,opt_pp", [(True, False), (False, True), (True, True)]
)
def test_variable_intrinsics(opt_f, opt_pp):
    X, x, w, mask, params = _scene_cv(
        f_err=0.875 if opt_f else 1.0,
        pp_err=(8.0, -6.0) if opt_pp else (0.0, 0.0),
    )
    opts = JaxBundleOptions(max_iterations=50, loss_type=1, function_tol=1e-5)
    got = _port(X, x, w, mask, params, opts, opt_f=opt_f, opt_pp=opt_pp)
    for ref in _jax(X, x, w, mask, params, opts, opt_f=opt_f, opt_pp=opt_pp):
        np.testing.assert_allclose(got[:7], ref[:7], atol=1e-3)
        np.testing.assert_allclose(got[7:11], ref[7:11], rtol=2e-3, atol=1.0)
    if opt_f:
        assert abs(got[8] - 1800.0) < 25.0
    if opt_pp:
        assert abs(got[9] - 960.0) < 4.0
        assert abs(got[10] - 540.0) < 4.0


def test_intrinsics_gate_3_points():
    X, x, w, mask, params = _scene_cv(f_err=0.9, n_valid=3)
    opts = JaxBundleOptions(max_iterations=20, loss_type=0)
    got = _port(X, x, w, mask, params, opts, opt_f=True, opt_pp=True)
    refs = _jax(X, x, w, mask, params, opts, opt_f=True, opt_pp=True)
    np.testing.assert_allclose(got[7:11], params[7:11], atol=0.0)
    for ref in refs:
        np.testing.assert_allclose(got[:7], ref[:7], atol=5e-4)


@pytest.mark.parametrize("n,opt_pp", [(4, False), (6, False), (8, False),
                                      (8, True)])
def test_pin_sizes(n, opt_pp):
    """Pin-drag sizes (the solves K1 runs in one warp): 4 to 8 points,
    Trivial loss, free focal, against the JAX XLA solve.  A free principal
    point needs more than 4 points: with 4 it has 9 unknowns for 8
    residuals, and the two solvers stop at different points of that
    valley."""
    X, x, w, mask, params = _scene_cv(n=n, f_err=0.95)
    opts = JaxBundleOptions(loss_type=0)
    got = _port(X, x, w, mask, params, opts, opt_f=True, opt_pp=opt_pp)

    def ref(p):
        args = [jnp.asarray(a) for a in (X[p], x[p], w[p], mask[p], params)]
        return np.asarray(jax.device_get(jax_solve_arrays(
            *args, opt_f=True, opt_pp=opt_pp, opts=opts)))

    # The final cost of these tiny solves moves by ~2e-3 of itself when
    # the JAX solve merely takes its points in another order, so the cost
    # is held within 1e-3 of the range of JAX's costs over the points in
    # their order and in four shuffled ones.
    orders = [np.arange(n)] + [np.random.default_rng(s).permutation(n)
                               for s in range(1, 5)]
    refs = np.stack([ref(p) for p in orders])
    np.testing.assert_allclose(got[:7], refs[0, :7], atol=1e-3)
    np.testing.assert_allclose(got[7:11], refs[0, 7:11], rtol=2e-3, atol=1.0)
    assert (refs[:, 13].min() * (1 - 1e-3) <= got[13]
            <= refs[:, 13].max() * (1 + 1e-3))
    np.testing.assert_allclose(got[18], refs[0, 18], atol=1e-3)


def test_batched_equals_single_solves():
    """Solves of a batch are independent: each row agrees with its own
    single solve and with the JAX solve, to the solver tolerance (a batched
    reduction may round differently, so an ftol exit can move by one
    iteration)."""
    scenes = [_scene(seed=s, n=256, n_masked=17 * s) for s in range(3)]
    opts = JaxBundleOptions(max_iterations=30, loss_type=1, function_tol=1e-5)
    stack = lambda i: torch.as_tensor(np.stack([s[i] for s in scenes]))  # noqa: E731
    got = solve_arrays_lm(
        stack(0), stack(1), stack(2), stack(3), stack(4), opt_f=False,
        opt_pp=False, opts=convert.bundle_options(opts),
    ).numpy()
    for s, sc in enumerate(scenes):
        single = _port(*sc[:5], opts)
        _check_pose(got[s], [single, *_jax(*sc[:5], opts)])


def test_wrapper_routes_by_device():
    """CPU tensors take the plain version without a launch; a device that
    is neither CPU nor CUDA is refused."""
    from polychase_tpu_torch.engine.pnp import solve_arrays as plain
    from polychase_tpu_torch.kernels import pnp_lm

    X, x, w, mask, params, _, _ = _scene(n=64, n_masked=4)
    args = [torch.as_tensor(np.asarray(a))[None] for a in (X, x, w, mask, params)]
    opts = convert.bundle_options(JaxBundleOptions(max_iterations=5))
    before = pnp_lm.launches
    got = solve_arrays_lm(*args, opt_f=False, opt_pp=False, opts=opts)
    assert pnp_lm.launches == before
    ref = plain(*args, opt_f=False, opt_pp=False, opts=opts)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    with pytest.raises(ValueError):
        solve_arrays_lm(*(a.to("meta") for a in args), opt_f=False,
                        opt_pp=False, opts=opts)
