"""Idle ms of the card a refine call, charged to the refiner's
``refine.data`` span (engine/refiner.py: the flow DB opened and read, and
``build_refiner_data``).  None where the span did not run in the traced
window (no key of the trace's labels), so a renamed span reads null and
not 0; 0 where it ran but is not among the ten largest idle entries.
Moves ``refine_s``."""

from portbench.idle import span_idle_ms

SPANS = ("refine.data",)


def read(ctx):
    return span_idle_ms(ctx.trace, SPANS, ctx.layer.get("refine_calls"))
