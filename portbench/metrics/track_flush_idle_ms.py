"""Idle ms of the card a delivered frame, charged to the tracker's
``track.pack`` and ``track.deliver`` spans, summed (engine/tracker.py: a
32-frame chunk's inputs packed and uploaded; its results handed to the
callback and the trajectory).  None where neither span ran in the traced
window (no key of the trace's labels), so a renamed span reads null and
not 0; a span that ran but is not among the ten largest idle entries adds
0.  Moves ``track_fps``."""

from portbench.idle import span_idle_ms

SPANS = ("track.pack", "track.deliver")


def read(ctx):
    return span_idle_ms(ctx.trace, SPANS,
                        len(ctx.layer.get("track_frames") or ()))
