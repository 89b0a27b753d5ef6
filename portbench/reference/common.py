"""Pieces of the plain reference shared by its PnP and its bundle
adjustment: rotations, the robust losses and a Levenberg–Marquardt loop.

Plain torch in the caller's dtype; nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

HUBER, CAUCHY = "huber", "cauchy"

_TF32 = contextvars.ContextVar("portbench_tf32", default=False)


@contextlib.contextmanager
def tf32_products():
    """Inside the block, :func:`mm` rounds float32 operands to TF32 (10
    mantissa bits, to nearest) before it multiplies, as a tensor core does
    with TF32 on: the control's precision.  ``allow_tf32`` alone is not
    enough: cuBLAS may pick a float32 kernel for thin products."""
    token = _TF32.set(True)
    try:
        yield
    finally:
        _TF32.reset(token)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x.detach())  # the value rounded, derivatives as x's


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``; inside :func:`tf32_products` with float32 operands
    rounded to TF32 first."""
    if _TF32.get() and a.dtype == torch.float32:
        a, b = _round_tf32(a), _round_tf32(b)
    return a @ b


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of WXYZ quaternions, batched."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit WXYZ quaternion → rotation matrix, batched."""
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1)
    return m.reshape(*q.shape[:-1], 3, 3)


def retract(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """q turned by the small rotation ``w`` (…, 3), on its right:
    ``normalize(q · (1, w / 2))``, smooth at w = 0."""
    one = torch.ones_like(w[..., :1])
    dq = torch.cat([one, 0.5 * w], -1)
    out = quat_mul(q / torch.linalg.vector_norm(q, dim=-1, keepdim=True), dq)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def loss(kind: str, scale: float, r2: torch.Tensor) -> torch.Tensor:
    """ρ(r²) of the program's robust losses (Huber, Cauchy)."""
    c2 = scale * scale
    if kind == HUBER:
        r = torch.sqrt(torch.clamp(r2, min=0.0))
        return torch.where(r2 <= c2, r2, scale * (2.0 * r - scale))
    if kind == CAUCHY:
        return c2 * torch.log1p(r2 / c2)
    raise ValueError(f"unknown loss {kind}")


def loss_weight(kind: str, scale: float, r2: torch.Tensor) -> torch.Tensor:
    """ρ'(r²), the weight of a residual in the Gauss–Newton system."""
    c2 = scale * scale
    if kind == HUBER:
        r = torch.sqrt(torch.clamp(r2, min=1e-300))
        return torch.where(r2 <= c2, torch.ones_like(r2), scale / r)
    if kind == CAUCHY:
        return 1.0 / (1.0 + r2 / c2)
    raise ValueError(f"unknown loss {kind}")


def levenberg_marquardt(x, cost, system, step, *, rtol, max_iter=60,
                        max_tries=8):
    """Minimise ``cost(x)`` (a float) from ``x``: ``system(x)`` gives the
    Gauss–Newton matrix A and gradient b, ``step(x, dx)`` the moved state.
    Stops once an accepted step lowers the cost by at most ``rtol`` of it,
    or ``max_tries`` dampings in a row find no lower cost.  Returns (x, its
    cost, iterations)."""
    c = cost(x)
    lam = 1e-4
    it = 0
    for it in range(1, max_iter + 1):
        A, b = system(x)
        diag = torch.diagonal(A).clone()
        diag = torch.where(diag > 0, diag, torch.ones_like(diag))
        for _ in range(max_tries):
            M = A + torch.diag(lam * diag)
            L, info = torch.linalg.cholesky_ex(M)
            if int(info) == 0:
                dx = torch.cholesky_solve(-b[:, None], L)[:, 0]
                x_new = step(x, dx)
                c_new = cost(x_new)
                if c_new < c:
                    break
            lam *= 10.0
        else:
            return x, c, it
        done = c - c_new <= rtol * c
        x, c = x_new, c_new
        lam = max(lam / 3.0, 1e-12)
        if done:
            break
    return x, c, it


def rtol_for(dtype: torch.dtype) -> float:
    """The relative decrease at which the reference stops: ten rounding
    units of its dtype, and no less than 1e-12."""
    return max(1e-12, 10.0 * torch.finfo(dtype).eps)
