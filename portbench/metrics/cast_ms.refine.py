"""Device ms a refine call spends in the ray cast kernels, K5's
(``hits_kernel``, csrc/raycast_sweep.cu) and K6's (``grid_kernel``,
csrc/grid_cast.cu): the prim refresh's casts, the only casts refine
makes.  Read by kernel name and not from the ``refine.raycast`` label:
the label's device time counted the cast's ctypes launches in some traces
and not in others.  Moves ``refine_s``."""

KERNELS = ("hits_kernel", "grid_kernel")


def read(ctx):
    calls = ctx.layer.get("refine_calls")
    ms = ctx.trace.kernel_ms(*KERNELS)
    if not calls or ms <= 0:
        return None
    return ms / calls
