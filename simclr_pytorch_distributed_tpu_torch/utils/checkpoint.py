"""Checkpoints in the reference's ``.pth`` layout (reference ``util.py:87-96``).

``{'opt', 'model', 'optimizer', 'epoch'}`` via ``torch.save``: ``'model'``
is the ``SupConResNet`` state dict with the ``'module.'`` prefix the
reference's DDP-wrapped model carries, ``'optimizer'`` the SGD state dict,
``'opt'`` the run's configuration as a plain dict. The JAX package's
``convert_reference_checkpoint`` reads such a file as it is.
"""

from __future__ import annotations

import dataclasses
import os

import torch


def save_model(model, optimizer, cfg, epoch: int, path: str) -> None:
    """Write the checkpoint to ``path`` through a temporary file, so a
    crash mid-write never leaves a truncated file under the final name."""
    opt = {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in dataclasses.asdict(cfg).items()
    }
    state = {
        "opt": opt,
        "model": {f"module.{k}": v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        "epoch": int(epoch),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
