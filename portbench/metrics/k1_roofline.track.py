"""K1's share of its roofline in tracking, in %: per traced frame
``bounds.k1_bound`` of the frame's matches (its rays), 6 parameters and the
LM iterations its callback reported, summed, over the device time of K1
(``pnp_lm_kernel``, csrc/pnp_lm.cu).  Moves ``track_fps``."""

from portbench.bounds import k1_bound

KERNEL = "pnp_lm_kernel"


def read(ctx):
    frames = ctx.layer.get("track_frames")
    ms = ctx.trace.kernel_ms(KERNEL)
    if not frames or ms <= 0:
        return None
    least = sum(k1_bound(rays, 6, it)[0] for _, rays, it in frames if rays)
    return 100.0 * least / ms
