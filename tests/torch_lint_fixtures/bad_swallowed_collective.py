"""KNOWN-BAD: a collective inside a try whose handler swallows.

A rank whose TensorBoard write raises OSError goes on without the boundary
exchange's failure-code all-gather that its peers enter.
"""


def boundary(telemetry, ring, consume, step, tb):
    try:
        tb.log_value("loss", 1.0, step)
        telemetry.flush_boundary(ring, consume, step_hint=step)
    except OSError:
        pass
