"""Host (numpy) iterative PnP in float64: the interactive fast path.

Port of ``polychase_tpu/engine/pnp_host.py``.  A pin drag fires one solve
per mouse move, and with a few pins the solve is microseconds of numpy,
less than a device launch and the copies around it.  The module mirrors
``engine.pnp.solve_arrays`` in float64: the same residuals and Jacobians,
Nielsen λ schedule, FOV clamping and ≤ 3-point intrinsics gate.
``engine.pinmode`` routes small solves here and large ones to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import camera as C
from . import pose as P
from .levmarq import BundleStats, CAUCHY, HUBER, TRIVIAL
from .pnp import PnPOptions, PnPResult

_BEHIND_RESIDUAL = 1e18  # engine.pnp._BEHIND_RESIDUAL


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _quat_exp(w_delta):
    sq = float(np.dot(w_delta, w_delta))
    if sq < 1e-12:
        return np.concatenate([[1.0 - sq / 8.0], (0.5 - sq / 48.0) * w_delta])
    angle = np.sqrt(sq)
    half = 0.5 * angle
    return np.concatenate([[np.cos(half)], (np.sin(half) / angle) * w_delta])


def _bounds(width, height, sign):
    """FOV bounds for (fy, cx, cy): float64 twin of
    ``camera.intrinsics_bounds``."""
    min_tan = np.tan(np.deg2rad(15.0) / 2)
    max_tan = np.tan(np.deg2rad(160.0) / 2)
    half_w = width / 2.0
    f_low_cv, f_high_cv = half_w / max_tan, half_w / min_tan
    if sign < 0:
        f_low, f_high = -f_high_cv, -f_low_cv
    else:
        f_low, f_high = f_low_cv, f_high_cv
    return f_low, f_high, 0.0, width, 0.0, height


def _loss_value(loss_type, scale, r2):
    if loss_type == TRIVIAL:
        return r2
    if loss_type == HUBER:
        thr2 = scale * scale
        r = np.sqrt(np.maximum(r2, 0))
        return np.where(r2 <= thr2, r2, scale * (2.0 * r - scale))
    if loss_type == CAUCHY:
        thr2 = scale * scale
        return thr2 * np.log1p(r2 / thr2)
    raise ValueError(f"unknown loss type {loss_type}")


def _loss_weight(loss_type, scale, r2):
    if loss_type == TRIVIAL:
        return np.ones_like(r2)
    if loss_type == HUBER:
        thr2 = scale * scale
        r = np.sqrt(np.maximum(r2, 1e-30))
        return np.where(r2 <= thr2, 1.0, scale / r)
    if loss_type == CAUCHY:
        inv_thr2 = 1.0 / (scale * scale)
        return np.maximum(1.18e-38, 1.0 / (1.0 + r2 * inv_thr2))
    raise ValueError(f"unknown loss type {loss_type}")


class _Cam:
    """Mutable host camera: q(4) t(3) fx fy cx cy, aspect, sign, size.

    ``fx`` is kept apart from ``fy`` because the step clamps them
    independently (fy stepped then clamped, fx = clip(aspect·fy)), so near
    the FOV bounds with aspect ≠ 1 they decouple."""

    __slots__ = (
        "q", "t", "fx", "fy", "cx", "cy", "aspect", "sign", "w", "h",
    )

    def __init__(self, q, t, fx, fy, cx, cy, aspect, sign, w, h):
        self.q, self.t = q, t
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.aspect, self.sign, self.w, self.h = aspect, sign, w, h

    def copy(self):
        return _Cam(
            self.q.copy(), self.t.copy(), self.fx, self.fy, self.cx,
            self.cy, self.aspect, self.sign, self.w, self.h,
        )


def _residuals(cam: _Cam, X, x):
    """(N, 2) residuals and the behind-camera mask."""
    Z = X @ P.quat_to_mat_np(cam.q).T + cam.t
    behind = cam.sign * Z[:, 2] < 0.0
    z = np.stack(
        [cam.fx * Z[:, 0] / Z[:, 2] + cam.cx,
         cam.fy * Z[:, 1] / Z[:, 2] + cam.cy],
        axis=-1,
    )
    res = z - x
    res[behind] = _BEHIND_RESIDUAL
    return res, behind


def _residuals_jac(cam: _Cam, X, x, opt_f, opt_pp):
    """Residuals and (N, 2, 9) Jacobians."""
    R = P.quat_to_mat_np(cam.q)
    Z = X @ R.T + cam.t
    Xc, Yc, Zc = Z[:, 0], Z[:, 1], Z[:, 2]
    inv_z = 1.0 / Zc
    z = np.stack(
        [cam.fx * Xc * inv_z + cam.cx, cam.fy * Yc * inv_z + cam.cy], axis=-1
    )
    res = z - x
    n = X.shape[0]
    zero = np.zeros(n)
    dz_dZ = np.stack(
        [
            cam.fx * inv_z, zero, -cam.fx * Xc * inv_z * inv_z,
            zero, cam.fy * inv_z, -cam.fy * Yc * inv_z * inv_z,
        ],
        axis=-1,
    ).reshape(n, 2, 3)
    # dZ/dω = R · skew(-p) for the right-multiplicative so(3) step.
    px, py, pz = X[:, 0], X[:, 1], X[:, 2]
    skew_neg = np.stack(
        [zero, pz, -py, -pz, zero, px, py, -px, zero], axis=-1
    ).reshape(n, 3, 3)
    dZ_dR = np.einsum("ij,njk->nik", R, skew_neg)
    J_rot = np.einsum("nij,njk->nik", dz_dZ, dZ_dR)
    one = np.ones(n)
    dz_dintr = np.stack(
        [cam.aspect * Xc * inv_z, one, zero, Yc * inv_z, zero, one], axis=-1
    ).reshape(n, 2, 3)
    if not opt_f:
        dz_dintr[:, :, 0] = 0.0
    if not opt_pp:
        dz_dintr[:, :, 1:] = 0.0
    return res, np.concatenate([J_rot, dz_dZ, dz_dintr], axis=-1)


def _total_cost(cam, X, x, weights, loss_type, loss_scale):
    res, _ = _residuals(cam, X, x)
    r2 = np.sum(res * res, axis=-1)
    return float(np.sum(weights * _loss_value(loss_type, loss_scale, r2)))


def _normal_equations(cam, X, x, weights, loss_type, loss_scale, opt_f,
                      opt_pp):
    res, J = _residuals_jac(cam, X, x, opt_f, opt_pp)
    r2 = np.sum(res * res, axis=-1)
    w = weights * _loss_weight(loss_type, loss_scale, r2)
    JtJ = np.einsum("nlp,nlq,n->pq", J, J, w)
    Jtr = np.einsum("nlp,nl,n->p", J, res, w)
    return JtJ, Jtr


def _damped_solve(JtJ, Jtr, lam):
    """The damped, equilibrated Cholesky solve of
    ``levmarq.damped_cholesky_solve``."""
    diag = np.clip(np.diagonal(JtJ), 1e-6, 1e32)
    damped = diag * (1.0 + lam)
    A = JtJ.copy()
    np.fill_diagonal(A, damped)
    d = 1.0 / np.sqrt(damped)
    As = A * d[:, None] * d[None, :]
    try:
        L = np.linalg.cholesky(As)
    except np.linalg.LinAlgError:
        return np.zeros_like(Jtr), False
    y = np.linalg.solve(L, Jtr * d)
    s = np.linalg.solve(L.T, y)
    step = -(s * d)
    ok = bool(np.all(np.isfinite(step)))
    return (step if ok else np.zeros_like(step)), ok


def _apply_step(cam: _Cam, dp, bounds, opt_f, opt_pp):
    new = cam.copy()
    new.q = _quat_mul(cam.q, _quat_exp(dp[0:3]))
    new.t = cam.t + dp[3:6]
    f_low, f_high, cx_low, cx_high, cy_low, cy_high = bounds
    if opt_f:
        new.fy = float(np.clip(cam.fy + dp[6], f_low, f_high))
        new.fx = float(np.clip(new.aspect * new.fy, f_low, f_high))
    if opt_pp:
        new.cx = float(np.clip(cam.cx + dp[7], cx_low, cx_high))
        new.cy = float(np.clip(cam.cy + dp[8], cy_low, cy_high))
    return new


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def solve_pnp_host(object_points, image_points, cam0: C.CameraState,
                   opts: PnPOptions = PnPOptions(),
                   weights=None) -> PnPResult:
    """Host twin of :func:`engine.pnp.solve_pnp`: the same semantics in
    float64 numpy, with no device work.  ``cam0``'s fields may be tensors
    on any device or numbers; the result's camera is CPU tensors."""
    X = np.asarray(object_points, np.float64).reshape(-1, 3)
    x = np.asarray(image_points, np.float64).reshape(-1, 2)
    n = X.shape[0]
    if n != x.shape[0]:
        raise ValueError("object/image point count mismatch")
    if n < 3:
        raise ValueError("PnP needs at least 3 points")
    w_arr = (
        np.ones(n) if weights is None
        else np.asarray(weights, np.float64).reshape(-1)
    )
    ci = cam0.intrinsics
    f = lambda v: float(_np(v))  # noqa: E731
    cam = _Cam(
        q=_np(cam0.pose.q).reshape(4).copy(),
        t=_np(cam0.pose.t).reshape(3).copy(),
        fx=f(ci.fx), fy=f(ci.fy), cx=f(ci.cx), cy=f(ci.cy),
        aspect=f(ci.aspect_ratio), sign=f(ci.sign),
        w=f(ci.width), h=f(ci.height),
    )
    bounds = _bounds(cam.w, cam.h, cam.sign)

    b = opts.bundle_opts
    loss_type, loss_scale = int(b.loss_type), float(b.loss_scale)
    # Intrinsics move only with more than 3 points.
    opt_f = bool(opts.optimize_focal_length) and n > 3
    opt_pp = bool(opts.optimize_principal_point) and n > 3

    cost = _total_cost(cam, X, x, w_arr, loss_type, loss_scale)
    initial_cost = cost
    JtJ, Jtr = _normal_equations(
        cam, X, x, w_arr, loss_type, loss_scale, opt_f, opt_pp
    )
    grad_norm = float(np.linalg.norm(Jtr))
    lam, v = float(b.initial_lambda), 2.0
    iterations, invalid_steps, step_norm = 0, 0, -1.0
    done = grad_norm < b.gradient_tol

    while not done and iterations < b.max_iterations:
        step, solve_ok = _damped_solve(JtJ, Jtr, lam)
        step_norm = float(np.linalg.norm(step))
        cam_new = _apply_step(cam, step, bounds, opt_f, opt_pp)
        cost_new = _total_cost(cam_new, X, x, w_arr, loss_type, loss_scale)

        improved = solve_ok and cost_new < cost
        tiny_step = solve_ok and step_norm < b.step_tol

        actual = cost_new - cost
        expected = float(np.dot(step, 2.0 * Jtr + JtJ @ step))
        rho = actual / expected if expected != 0.0 else 0.0
        lam_saturated = lam >= b.max_lambda

        accept = improved and not tiny_step
        if accept:
            cam = cam_new
            cost = cost_new
            if rho > 0:
                factor = max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                lam = float(np.clip(lam * factor, b.min_lambda, b.max_lambda))
            v = 2.0
            JtJ, Jtr = _normal_equations(
                cam, X, x, w_arr, loss_type, loss_scale, opt_f, opt_pp
            )
            grad_norm = float(np.linalg.norm(Jtr))
        else:
            lam = min(b.max_lambda, lam * v)
            v = 2.0 * v
        if not (improved or tiny_step):
            invalid_steps += 1

        done = (
            tiny_step
            or (accept and grad_norm < b.gradient_tol)
            or (not improved and not tiny_step and lam_saturated)
        )
        iterations += 1

    res, behind = _residuals(cam, X, x)
    err2 = np.sum(res * res, axis=-1)
    err2[behind] = np.inf
    max_err = float(opts.max_inlier_error)
    ratio = (
        float(np.sum(err2 < max_err * max_err)) / max(n, 1)
        if max_err > 0.0 else 0.0
    )

    t32 = lambda a: torch.tensor(np.float32(a))  # noqa: E731
    intr_out = C.Intrinsics(
        fx=t32(cam.fx), fy=t32(cam.fy), cx=t32(cam.cx), cy=t32(cam.cy),
        aspect_ratio=t32(cam.aspect), width=t32(cam.w), height=t32(cam.h),
        sign=t32(cam.sign),
    )
    camera = C.CameraState(
        intr_out,
        P.Pose(torch.as_tensor(cam.q.astype(np.float32)),
               torch.as_tensor(cam.t.astype(np.float32))),
    )
    f32 = np.float32
    stats = BundleStats(
        iterations=np.int32(iterations),
        initial_cost=f32(initial_cost),
        cost=f32(cost),
        lambda_=f32(lam),
        invalid_steps=np.int32(invalid_steps),
        step_norm=f32(step_norm),
        grad_norm=f32(grad_norm),
    )
    return PnPResult(camera=camera, stats=stats, inlier_ratio=ratio)
