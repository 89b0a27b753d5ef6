"""Share of the traced tracking window in which the card ran nothing:
100 · (1 − busy / window), busy the union of every kernel, copy and fill
(``portbench/trace.py``).  Moves ``track_fps``."""


def read(ctx):
    if not ctx.layer.get("track_frames") or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
