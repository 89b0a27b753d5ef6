"""Idle ms of the card a refine call, charged to the refiner's
``refine.iteration`` span (engine/refiner.py: one pass of the LM loop
outside its stage labels, mostly the host's turn after the pass's one
read).  None where the span did not run in the traced window (no key of
the trace's labels), so a renamed span reads null and not 0; 0 where it
ran but is not among the ten largest idle entries.  Moves ``refine_s``."""

from portbench.idle import span_idle_ms

SPANS = ("refine.iteration",)


def read(ctx):
    return span_idle_ms(ctx.trace, SPANS, ctx.layer.get("refine_calls"))
