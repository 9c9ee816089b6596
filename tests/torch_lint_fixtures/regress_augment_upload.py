"""REGRESSION: a blocking per-step upload in the augmentation.

The port's augmentation once built its per-channel constant with
``torch.tensor(values, device=device)`` on every step: a synchronizing copy
of host values between flush boundaries. It was found on the card by the
observability phase's sync guard; this rule catches it in the loop.
"""

import torch


def train_one_epoch(batches, generator, mean, std, device, train_step, telemetry,
                    ring_buf, consume, print_freq):
    for idx, images in enumerate(batches):
        scale = torch.tensor(std, dtype=torch.float32, device=device)
        views = (images.float() - mean) / scale
        train_step(views, generator)
        if (idx + 1) % print_freq == 0:
            telemetry.flush_boundary(ring_buf, consume, step_hint=idx)
