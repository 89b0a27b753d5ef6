"""The device's idle time that a traced run charges to spans the program
opens itself (``Trace.idle_gaps``: each gap goes to the innermost host
event open at its middle), for the per-layer metrics that read them."""


def span_idle_ms(trace, spans, per):
    """Idle ms charged to ``spans``, summed, over ``per`` (frames or
    calls).  None where ``per`` is missing or 0, or where none of
    ``spans`` ran in the window (is a key of ``trace.labels``): a renamed
    span reads null, not 0.  A span that ran but is not among the trace's
    ten largest idle entries adds 0."""
    if not per or not any(s in trace.labels for s in spans):
        return None
    gaps = dict(trace.idle_gaps)
    return 1e3 * sum(gaps.get(s, 0.0) for s in spans) / per
