"""Idle ms of the card a refine call, charged to the refiner's
``refine.setup`` and ``refine.finish`` spans, summed (engine/refiner.py:
the uploads, the first prim refresh and its cost, the band; after the LM
loop, the last cost read, the last report and the write-back).  None
where neither span ran in the traced window (no key of the trace's
labels), so a renamed span reads null and not 0; a span that ran but is
not among the ten largest idle entries adds 0.  Moves ``refine_s``."""

from portbench.idle import span_idle_ms

SPANS = ("refine.setup", "refine.finish")


def read(ctx):
    return span_idle_ms(ctx.trace, SPANS, ctx.layer.get("refine_calls"))
