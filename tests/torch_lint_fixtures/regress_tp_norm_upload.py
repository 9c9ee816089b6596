"""REGRESSION: a blocking upload in a helper that the train step calls.

The tensor-parallel health gradient norm once built its flags of sharded
leaves with ``torch.tensor(flags).to(norms.device)`` on every call: a
pageable host-to-device copy that waits for the card, inside the step,
reached through a same-module helper. The two casts below it are not
uploads and stay silent.
"""

import torch


def global_grad_norm(params, flags, model_group=None):
    norms = torch.stack([torch.linalg.vector_norm(p.grad) for p in params])
    sharded = torch.tensor(flags).to(norms.device)
    weights = torch.tensor(flags).to(torch.float32)
    staged = torch.tensor(flags).to(norms.device, non_blocking=True)
    return (norms * weights * staged).sum() + torch.where(sharded, norms, 0.0).sum()


def train_step(state, cfg, images, labels):
    loss = state.model(images).sum()
    loss.backward()
    return {"loss": loss, "grad_norm": global_grad_norm(state.model.parameters(), cfg.flags)}
