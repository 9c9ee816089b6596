"""KNOWN-BAD: a host sync inside a flush-boundary hot loop.

``.item()`` on the step's loss is the reference's per-iteration readback:
one wait for the card a step. The annotated line is a DESIGNED sync site
(its reason recorded) and must not fire; the bare marker must fire the
missing-reason rule.
"""

import time


def epoch(train_step, state, batches, telemetry, ring_buf, consume, print_freq):
    for idx, (images, labels) in enumerate(batches):
        metrics = train_step(state, images, labels)
        loss = metrics["loss"].item()  # BUG: a readback every step
        t = float(time.time() - state.t0)  # sync-ok: host wall-clock only
        u = bool(state.flag)  # sync-ok
        if (idx + 1) % print_freq == 0:
            telemetry.flush_boundary(ring_buf, consume, step_hint=idx)
    return loss, t, u
