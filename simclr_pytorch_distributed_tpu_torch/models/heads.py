"""Projection head and the SupCon encoder+head model (reference resnet_big.py:159-181).

``SupConResNet`` returns the UNNORMALIZED embedding; L2 normalization happens
in the train step, as in the JAX package and the reference driver. Linear
layers keep torch ``nn.Linear``'s default init, U(±1/sqrt(fan_in)) for
weight and bias, which is what the JAX package's ``TorchDense`` reproduces.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from simclr_pytorch_distributed_tpu_torch.models.resnet import MODEL_DICT


def projection_head(head: str, dim_in: int, feat_dim: int) -> nn.Module:
    """'mlp' (dim_in -> dim_in -> ReLU -> feat_dim, state-dict names
    ``head.0``/``head.2``) or 'linear' (``head``)."""
    if head == "mlp":
        return nn.Sequential(
            nn.Linear(dim_in, dim_in), nn.ReLU(), nn.Linear(dim_in, feat_dim)
        )
    if head == "linear":
        return nn.Linear(dim_in, feat_dim)
    raise NotImplementedError(f"head not supported: {head}")


class SupConResNet(nn.Module):
    """Backbone + projection head; NHWC images in, ``[N, feat_dim]`` out."""

    def __init__(self, model_name: str = "resnet50", head: str = "mlp", feat_dim: int = 128):
        super().__init__()
        model_fn, dim_in = MODEL_DICT[model_name]
        self.encoder = model_fn()
        self.head = projection_head(head, dim_in, feat_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.encoder(x))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder features only (the probe's frozen feature extractor)."""
        return self.encoder(x)

    def forward_with_features(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(projection, encoder_features)`` from one backbone forward."""
        h = self.encoder(x)
        return self.head(h), h
