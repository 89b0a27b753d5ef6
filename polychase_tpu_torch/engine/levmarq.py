"""Batched Levenberg–Marquardt, the plain torch version.

Port of ``polychase_tpu/engine/levmarq.py``: the dense solver loop, the
damped Cholesky solve and its block-tridiagonal variant.  The batch axis
that the reference gets from ``vmap`` is written out: every state tensor
has a leading solve axis ``S``, and the loop runs until every solve is
done, freezing the finished ones, which is what ``vmap`` of a
``while_loop`` does.  The loop tests ``done`` on the host once per
iteration.

Semantics preserved from the reference:

- damping: diagonal replaced by ``clamp(diag, 1e-6, 1e32) · (1 + λ)``, then
  symmetric Jacobi equilibration before the Cholesky solve;
- Nielsen λ schedule: on acceptance with gain ratio ρ > 0,
  ``λ ← clamp(λ · max(1/3, 1 − (2ρ−1)³))``; on rejection
  ``λ ← min(λ·v, λmax)``, ``v ← 2v``;
- exits on gradient norm, step norm, max iterations, λ saturation after a
  failed step, and the optional relative ``function_tol``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

# Loss types (BundleOptions::LossType)
TRIVIAL = 0
HUBER = 1
CAUCHY = 2


@dataclass(frozen=True)
class BundleOptions:
    """Solver options.  ``function_tol`` is the relative tolerance on
    accepted (and rejected) steps; 0 disables it, which reproduces the
    reference's exits exactly."""

    max_iterations: int = 100
    loss_type: int = HUBER
    loss_scale: float = 1.0
    gradient_tol: float = 1e-10
    step_tol: float = 1e-8
    initial_lambda: float = 1e-5
    min_lambda: float = 1e-10
    max_lambda: float = 1e10
    function_tol: float = 0.0


@dataclass
class BundleStats:
    """Solver telemetry."""

    iterations: torch.Tensor
    initial_cost: torch.Tensor
    cost: torch.Tensor
    lambda_: torch.Tensor
    invalid_steps: torch.Tensor
    step_norm: torch.Tensor
    grad_norm: torch.Tensor


# ---------------------------------------------------------------------------
# Robust losses
# ---------------------------------------------------------------------------


def loss_value(loss_type: int, scale: float, r2: torch.Tensor):
    """ρ(r²), elementwise."""
    if loss_type == TRIVIAL:
        return r2
    if loss_type == HUBER:
        thr2 = scale * scale
        r = torch.sqrt(torch.clamp(r2, min=0.0))
        return torch.where(r2 <= thr2, r2, scale * (2.0 * r - scale))
    if loss_type == CAUCHY:
        thr2 = scale * scale
        return thr2 * torch.log1p(r2 / thr2)
    raise ValueError(f"unknown loss type {loss_type}")


def loss_weight(loss_type: int, scale: float, r2: torch.Tensor):
    """IRLS weight w(r²) = ρ'(r²), elementwise."""
    if loss_type == TRIVIAL:
        return torch.ones_like(r2)
    if loss_type == HUBER:
        thr2 = scale * scale
        r = torch.sqrt(torch.clamp(r2, min=1e-30))
        return torch.where(r2 <= thr2, torch.ones_like(r2), scale / r)
    if loss_type == CAUCHY:
        inv_thr2 = 1.0 / (scale * scale)
        return torch.clamp(1.0 / (1.0 + r2 * inv_thr2), min=1.18e-38)
    raise ValueError(f"unknown loss type {loss_type}")


# ---------------------------------------------------------------------------
# Damped, equilibrated Cholesky solve
# ---------------------------------------------------------------------------


def damped_cholesky_solve(JtJ, Jtr, lam):
    """Solve ``(JtJ with damped diagonal) step = -Jtr`` for a batch.

    ``JtJ`` (S, P, P), ``Jtr`` (S, P), ``lam`` (S,).  Returns
    ``(step (S, P), ok (S,))``; ``ok`` is false where the factorization or
    the solve produced non-finite values, and the step is then zero.
    """
    diag = torch.clamp(torch.diagonal(JtJ, dim1=-2, dim2=-1), 1e-6, 1e32)
    damped = diag * (1.0 + lam[:, None])
    A = JtJ.clone()
    A.diagonal(dim1=-2, dim2=-1).copy_(damped)
    d = 1.0 / torch.sqrt(damped)
    As = A * d[:, :, None] * d[:, None, :]
    bs = Jtr * d
    L, info = torch.linalg.cholesky_ex(As)
    # The substitutions one system at a time, each in its own allocation:
    # the CPU's triangular solves order their operations differently for
    # the later systems of a batch and for a view at an unaligned offset,
    # and a solve's result must not depend on the batch it is in.
    xs = []
    for Li, bi in zip(L, bs):
        Li, bi = Li.clone(), bi[:, None].clone()
        y = torch.linalg.solve_triangular(Li, bi, upper=False)
        xs.append(torch.linalg.solve_triangular(Li.T, y, upper=True))
    x = torch.stack(xs)
    step = -(x[..., 0] * d)
    ok = (
        (info == 0)
        & torch.isfinite(L).all(dim=-1).all(dim=-1)
        & torch.isfinite(step).all(dim=-1)
    )
    return torch.where(ok[:, None], step, torch.zeros_like(step)), ok


def damped_block_tridiag_solve(JtJ, Jtr, lam, *, nb: int, bs: int):
    """Banded variant of :func:`damped_cholesky_solve`, for one system or
    a batch of them.

    With bundle adjustment's skip pattern an edge couples frames at most
    ``S`` apart, so super-blocks of ``S`` frames make the normal matrix
    block-tridiagonal: ``nb`` diagonal blocks of size ``bs``.  ``JtJ`` is
    the full dense (nb·bs, nb·bs) system, ``Jtr`` (nb·bs,), ``lam`` a float
    or 0-d tensor; or, batched, (B, nb·bs, nb·bs), (B, nb·bs) and (B,).
    The damping and equilibration are the dense solve's, and zero-padded
    trailing rows must carry zero ``Jtr``.  The factorization and the two
    substitutions are loops over the ``nb`` blocks, each over the batch.
    Returns ``(step, ok)``, ``ok`` a bool tensor, 0-d or (B,), folding
    every block's factorization and the step's finiteness; the step is zero
    where not ok.
    """
    n = nb * bs
    if JtJ.dim() not in (2, 3) or tuple(JtJ.shape[-2:]) != (n, n):
        raise ValueError(f"JtJ is {tuple(JtJ.shape)}, want ({n}, {n})")
    batch = tuple(JtJ.shape[:-2])
    if isinstance(lam, torch.Tensor):
        lam = lam[..., None]
    diag = torch.clamp(torch.diagonal(JtJ, dim1=-2, dim2=-1), 1e-6, 1e32)
    damped = diag * (1.0 + lam)
    A = JtJ.clone()
    A.diagonal(dim1=-2, dim2=-1).copy_(damped)
    d = 1.0 / torch.sqrt(damped)
    As = (A * d[..., :, None] * d[..., None, :]).reshape(*batch, nb, bs, nb,
                                                         bs)
    b = (Jtr * d).reshape(*batch, nb, bs, 1)

    ok = torch.ones(batch, dtype=torch.bool, device=JtJ.device)
    Ls, Cts = [], []  # Cts[i] = C_iᵀ with C_i = E_i · L_i^{-T}
    CCt = torch.zeros((*batch, bs, bs), dtype=JtJ.dtype, device=JtJ.device)
    for i in range(nb):
        L, info = torch.linalg.cholesky_ex(As[..., i, :, i, :] - CCt)
        ok = ok & (info == 0) & torch.isfinite(L).flatten(-2).all(dim=-1)
        Ls.append(L)
        if i + 1 < nb:
            Ct = torch.linalg.solve_triangular(
                L, As[..., i + 1, :, i, :].transpose(-1, -2), upper=False
            )
            Cts.append(Ct)
            CCt = Ct.transpose(-1, -2) @ Ct
    ys, y = [], None
    for i in range(nb):
        r = (b[..., i, :, :] if i == 0
             else b[..., i, :, :] - Cts[i - 1].transpose(-1, -2) @ y)
        y = torch.linalg.solve_triangular(Ls[i], r, upper=False)
        ys.append(y)
    xs, x = [None] * nb, None
    for i in reversed(range(nb)):
        r = ys[i] if i == nb - 1 else ys[i] - Cts[i] @ x
        x = torch.linalg.solve_triangular(Ls[i].transpose(-1, -2), r,
                                          upper=True)
        xs[i] = x
    step = -(torch.cat(xs, dim=-2)[..., 0] * d)
    ok = ok & torch.isfinite(step).all(dim=-1)
    return torch.where(ok[..., None], step, torch.zeros_like(step)), ok


# ---------------------------------------------------------------------------
# Generic dense LM loop
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LMProblem:
    """Batched problem description.

    - ``residuals(params) -> (res (S, N, L), valid (S, N), weight (S, N))``;
      invalid residuals cost nothing (the reference's ``invalid_is_inf =
      False``, the only setting PnP uses; cost and normal equations are
      not normalized by the valid count).
    - ``residuals_jac(params) -> (res, J (S, N, L, P), valid, weight)``.
    - ``step(params, dp (S, P)) -> params``; ``params`` is an (S, K) tensor.
    """

    residuals: Callable
    residuals_jac: Callable
    step: Callable


def _total_cost(problem: LMProblem, opts: BundleOptions, params):
    res, valid, weight = problem.residuals(params)
    r2 = torch.sum(res * res, dim=-1)
    cost_i = weight * loss_value(opts.loss_type, opts.loss_scale, r2)
    cost_i = torch.where(valid, cost_i, torch.zeros_like(cost_i))
    return cost_i.sum(dim=-1)


def _normal_equations(problem: LMProblem, opts: BundleOptions, params):
    res, J, valid, weight = problem.residuals_jac(params)
    r2 = torch.sum(res * res, dim=-1)
    w = weight * loss_weight(opts.loss_type, opts.loss_scale, r2)
    w = torch.where(valid, w, torch.zeros_like(w))
    # Products summed over the last, contiguous axis, not einsums or
    # matrix products: those pick their CPU kernel (and so their order of
    # summation) by the batch's shape and the host's SIMD width, and a
    # solve's result must not depend on the batch it is in.
    S, N, L, P = J.shape
    Jt = J.reshape(S, N * L, P).transpose(1, 2).contiguous()  # (S, P, N·L)
    wt = w[:, :, None].expand(S, N, L).reshape(S, 1, N * L)
    Jwt = Jt * wt
    JtJ = (Jt[:, :, None, :] * Jwt[:, None, :, :]).sum(dim=-1)
    Jtr = (Jwt * res.reshape(S, 1, N * L)).sum(dim=-1)
    return JtJ, Jtr


def lm_solve(problem: LMProblem, params0: torch.Tensor, opts: BundleOptions):
    """Run LM to convergence for every solve of the batch.

    Returns ``(params (S, K), BundleStats)`` with (S,) stats."""
    init_cost = _total_cost(problem, opts, params0)
    JtJ, Jtr = _normal_equations(problem, opts, params0)
    S = init_cost.shape[0]
    f32 = dict(dtype=torch.float32, device=init_cost.device)
    i32 = dict(dtype=torch.int32, device=init_cost.device)

    params, cost = params0, init_cost
    lam = torch.full((S,), opts.initial_lambda, **f32)
    v = torch.full((S,), 2.0, **f32)
    grad_norm = torch.linalg.vector_norm(Jtr, dim=-1)
    step_norm = torch.full((S,), -1.0, **f32)
    iters = torch.zeros((S,), **i32)
    invalid = torch.zeros((S,), **i32)
    done = grad_norm < opts.gradient_tol

    while True:
        active = ~done & (iters < opts.max_iterations)
        if not bool(active.any()):
            break
        step, solve_ok = damped_cholesky_solve(JtJ, Jtr, lam)
        sn = torch.linalg.vector_norm(step, dim=-1)
        params_new = problem.step(params, step)
        cost_new = _total_cost(problem, opts, params_new)

        improved = solve_ok & (cost_new < cost)
        tiny = solve_ok & (sn < opts.step_tol)

        actual = cost_new - cost
        JtJ_step = (JtJ * step[:, None, :]).sum(dim=-1)
        expected = torch.sum(step * (2.0 * Jtr + JtJ_step), dim=-1)
        rho = actual / expected
        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_accept = torch.where(
            rho > 0,
            torch.clamp(lam * factor, opts.min_lambda, opts.max_lambda),
            lam,
        )
        lam_saturated = lam >= opts.max_lambda
        lam_reject = torch.clamp(lam * v, max=opts.max_lambda)

        accept = improved & ~tiny
        params_out = torch.where(accept[:, None], params_new, params)
        cost_out = torch.where(accept, cost_new, cost)
        lam_out = torch.where(accept, lam_accept, lam_reject)
        v_out = torch.where(accept, torch.full_like(v, 2.0), 2.0 * v)
        invalid_out = invalid + (~(improved | tiny)).to(torch.int32)

        # Rebuild the normal equations only for accepted steps; rejected
        # solves keep theirs, as the reference's lax.cond does.
        JtJ_out, Jtr_out = JtJ, Jtr
        if bool(accept.any()):
            JtJ_new, Jtr_new = _normal_equations(problem, opts, params_out)
            JtJ_out = torch.where(accept[:, None, None], JtJ_new, JtJ)
            Jtr_out = torch.where(accept[:, None], Jtr_new, Jtr)
        gn = torch.linalg.vector_norm(Jtr_out, dim=-1)

        done_new = (
            tiny
            | (accept & (gn < opts.gradient_tol))
            | (~improved & ~tiny & lam_saturated)
        )
        if opts.function_tol > 0.0:
            # An accepted step that shaved at most ftol·cost, or a
            # rejected one whose attempted move changed the cost by at
            # most that, is at the noise floor.
            stagnated = torch.abs(actual) <= opts.function_tol * cost
            done_new = done_new | ((accept | (~improved & ~tiny)) & stagnated)

        # Solves that were already finished keep their state.
        a = active
        params = torch.where(a[:, None], params_out, params)
        cost = torch.where(a, cost_out, cost)
        lam = torch.where(a, lam_out, lam)
        v = torch.where(a, v_out, v)
        JtJ = torch.where(a[:, None, None], JtJ_out, JtJ)
        Jtr = torch.where(a[:, None], Jtr_out, Jtr)
        grad_norm = torch.where(a, gn, grad_norm)
        step_norm = torch.where(a, sn, step_norm)
        iters = iters + a.to(torch.int32)
        invalid = torch.where(a, invalid_out, invalid)
        done = torch.where(a, done_new, done)

    stats = BundleStats(
        iterations=iters, initial_cost=init_cost, cost=cost, lambda_=lam,
        invalid_steps=invalid, step_norm=step_norm, grad_norm=grad_norm,
    )
    return params, stats
