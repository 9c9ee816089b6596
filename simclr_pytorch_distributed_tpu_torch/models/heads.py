"""Projection head and the SupCon encoder+head model (reference resnet_big.py:159-181).

``SupConResNet`` returns the UNNORMALIZED embedding; L2 normalization happens
in the train step, as in the JAX package and the reference driver. Linear
layers keep torch ``nn.Linear``'s default init, U(±1/sqrt(fan_in)) for
weight and bias, which is what the JAX package's ``TorchDense`` reproduces.
Under the encoder's bf16 compute dtype the head runs in bf16 as
``TorchDense(dtype=bf16)`` does (``heads.py:45-46``): input, weight and
bias cast to bf16, the product and then the bias add rounded to bf16; the
train step casts the embedding to fp32 before the loss.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
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


def head_forward(head: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``head`` (a ``projection_head``) on ``x`` in compute dtype ``dtype``;
    fp32 is the modules' own call."""
    if dtype == torch.float32:
        return head(x)
    for layer in head if isinstance(head, nn.Sequential) else (head,):
        if isinstance(layer, nn.Linear):
            x = F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)
        else:
            x = layer(x)
    return x


class SupConResNet(nn.Module):
    """Backbone + projection head; NHWC images in, ``[N, feat_dim]`` out.
    The encoder's train-mode conv path and the compute dtype of both are
    set on the encoder (``model.encoder.set_conv_impl``,
    ``model.encoder.set_compute_dtype``)."""

    def __init__(self, model_name: str = "resnet50", head: str = "mlp", feat_dim: int = 128):
        super().__init__()
        model_fn, dim_in = MODEL_DICT[model_name]
        self.encoder = model_fn()
        self.head = projection_head(head, dim_in, feat_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return head_forward(self.head, self.encoder(x), self.encoder.compute_dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder features only (the probe's frozen feature extractor)."""
        return self.encoder(x)

    def forward_with_features(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(projection, encoder_features)`` from one backbone forward."""
        h = self.encoder(x)
        return head_forward(self.head, h, self.encoder.compute_dtype), h
