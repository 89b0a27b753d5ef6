"""Idle ms of the card a delivered frame, charged to the tracker's
``track.step`` span (engine/tracker.py: one frame step, the rays, the
cast, the PnP launch and the carry update).  None where the span did not
run in the traced window (no key of the trace's labels), so a renamed
span reads null and not 0; 0 where it ran but is not among the ten
largest idle entries.  Moves ``track_fps``."""

from portbench.idle import span_idle_ms

SPANS = ("track.step",)


def read(ctx):
    return span_idle_ms(ctx.trace, SPANS,
                        len(ctx.layer.get("track_frames") or ()))
