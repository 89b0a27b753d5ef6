"""Device ms a refine call spends under the ``refine.normal_equations``
label (engine/refiner.py: the residuals, their Jacobians and JᵀJ).
Moves ``refine_s``."""

LABELS = ("refine.normal_equations",)


def read(ctx):
    calls = ctx.layer.get("refine_calls")
    if not calls or not any(k in ctx.trace.labels for k in LABELS):
        return None
    return sum(ctx.trace.labels.get(k, 0.0) for k in LABELS) / calls
