"""The yardstick's arithmetic: the card's peaks and the least time a
kernel could take on the shapes it is handed.

``bound_ms`` and ``k1_bound`` are frozen copies of ``chip_smoke.py``'s, so
that a later change there cannot move a reading of this benchmark.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): HBM3
# bandwidth and float32 rate outside the tensor cores.
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12

# K1: f32 operations per point and LM iteration, counted from the PnP
# kernel's source (a trial-cost pass, ~40, and a normal-equation pass:
# projection and Jacobian ~85 and the 27 JtJ/Jtr sums × 5, ~135, with 6
# parameters; the 54 sums of 9 parameters make it ~390).
K1_OPS_POINT_ITER = {6: 260, 9: 390}

# Bytes of one ray cast's inputs and outputs: a vertex (3 float32), a
# triangle (3 int64 indices, as the program's mesh holds them), a mask word
# (int64), a ray's origin or direction (3 float32), and a ray's hit fields
# (position and normal 12 bytes each, barycentrics 8, t 4, prim id 8,
# valid 1).
VERTEX_BYTES, TRIANGLE_BYTES, WORD_BYTES = 12, 24, 8
RAY_BYTES, HIT_BYTES = 12, 45


def bound_ms(nbytes: float, ops: float):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the f32 operations over the f32 rate, and which one."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(n, n_params, iterations):
    """K1 on one solve of n points: each input read once (X, x, weight,
    mask, 16 params), the 19-float row written once; iterations + 1 passes
    of the per-point work."""
    nbytes = n * (12 + 8 + 4 + 1) + 16 * 4 + 19 * 4
    ops = (iterations + 1) * n * K1_OPS_POINT_ITER[n_params]
    return bound_ms(nbytes, ops)


def cast_bytes(n_verts, n_tris, n_words, n_groups, n_rays) -> int:
    """Bytes a ray cast must move at the least: the mesh's vertices,
    indices and mask words read once, each group's origin and each ray's
    direction read once, and each ray's hit written once.  It counts no
    operation: the tests a cast makes depend on how it walks the mesh."""
    return (n_verts * VERTEX_BYTES + n_tris * TRIANGLE_BYTES
            + n_words * WORD_BYTES + n_groups * RAY_BYTES
            + n_rays * (RAY_BYTES + HIT_BYTES))
