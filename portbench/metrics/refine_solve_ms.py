"""Device ms a refine call spends under the ``refine.solve`` and
``refine.step`` labels (engine/refiner.py: the damped solve and the
step).  Moves ``refine_s``."""

LABELS = ("refine.solve", "refine.step")


def read(ctx):
    calls = ctx.layer.get("refine_calls")
    if not calls or not any(k in ctx.trace.labels for k in LABELS):
        return None
    return sum(ctx.trace.labels.get(k, 0.0) for k in LABELS) / calls
