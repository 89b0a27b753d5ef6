"""Idle ms of the card a delivered frame, charged to the tracker's
``track.setup`` span (engine/tracker.py: the flow DB's reads and the plan,
the initial carry, the keypoint table and the uploads, before a pass's
first chunk).  None where the span did not run in the traced window (no
key of the trace's labels), so a renamed span reads null and not 0; 0
where it ran but is not among the ten largest idle entries.  Moves
``track_update_p90_ms``: a pass's first update waits for it."""

from portbench.idle import span_idle_ms

SPANS = ("track.setup",)


def read(ctx):
    return span_idle_ms(ctx.trace, SPANS,
                        len(ctx.layer.get("track_frames") or ()))
