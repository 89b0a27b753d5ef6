"""The tracking ray cast's share of its roofline, in %: per traced frame
the least time its cast could take, counted in bytes alone from the shapes
handed to it (``bounds.cast_bytes``: the mesh's vertices, indices and mask
words, the frame's groups and rays, the hits), summed, over the device
time of the cast kernels, K5's (``hits_kernel``, csrc/raycast_sweep.cu)
and K6's (``grid_kernel``, csrc/grid_cast.cu), so that a change of route
leaves the metric valid.  Moves ``track_fps``."""

from portbench.bounds import bound_ms, cast_bytes

KERNELS = ("hits_kernel", "grid_kernel")


def read(ctx):
    frames = ctx.layer.get("track_frames")
    ms = ctx.trace.kernel_ms(*KERNELS)
    if not frames or ms <= 0:
        return None
    V, T, W = ctx.layer["mesh"]
    least = sum(bound_ms(cast_bytes(V, T, W, groups, rays), 0.0)[0]
                for groups, rays, _ in frames)
    return 100.0 * least / ms
