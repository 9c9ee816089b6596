"""Projection head, the SupCon encoder+head model (reference
resnet_big.py:159-181), the supervised CE model (resnet_big.py:184-193),
the probe's linear classifier (resnet_big.py:196-204) and the BYOL/SimSiam
predictor (JAX ``models/heads.py:69-102``), and :func:`infer_architecture`,
which reads a ``SupConResNet``'s architecture off its state dict (the
serving engine's ``from_checkpoint``).

``SupConResNet`` returns the UNNORMALIZED embedding; L2 normalization happens
in the train step, as in the JAX package and the reference driver. Linear
layers keep torch ``nn.Linear``'s default init, U(±1/sqrt(fan_in)) for
weight and bias, which is what the JAX package's ``TorchDense`` reproduces.
Under the encoder's bf16 compute dtype the head runs in bf16 as
``TorchDense(dtype=bf16)`` does (``heads.py:45-46``): input, weight and
bias cast to bf16, the product and then the bias add rounded to bf16; the
train step casts the embedding to fp32 before the loss.

Under tensor parallelism (``--model_parallel N``) the encoder hands the
head its channel slice of the features (``ResNet.forward_local``); each
linear gathers its input (``models/resnet.tp_input``) and computes its own
slice of the output features, and the head's output is gathered whole for
the loss (``tp_whole``). ``encode`` and the features of
``forward_with_features`` are whole. The predictor routes its two linears
the same way, and its normalization's parameters are sharded with its
hidden layer (:class:`PredictorHead`).
"""

from __future__ import annotations

import math
import re
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from simclr_pytorch_distributed_tpu_torch.models.resnet import (
    MODEL_DICT,
    STAGE_PLANS,
    Bottleneck,
    tp_input,
    tp_whole,
)
from simclr_pytorch_distributed_tpu_torch.parallel.mesh import is_tp_sharded


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
    fp32 is the modules' own call. A channel slice of ``x``, or a sharded
    linear, takes the tensor-parallel path: each linear reads its input
    whole, and the output comes back whole."""
    layers = list(head) if isinstance(head, nn.Sequential) else [head]
    linears = [layer for layer in layers if isinstance(layer, nn.Linear)]
    sharded = x.shape[1] != linears[0].in_features or any(
        is_tp_sharded(layer.weight) for layer in linears)
    if dtype == torch.float32 and not sharded:
        return head(x)
    for layer in layers:
        if isinstance(layer, nn.Linear):
            x = tp_input(layer, x)
            if dtype == torch.float32:
                x = layer(x)
            else:
                x = F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)
        else:
            x = layer(x)
    return tp_whole(x, linears[-1].out_features)


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
        # what a second network of this shape is built from (the recipes'
        # EMA target and key encoder, recipes/base.ema_network)
        self.arch = (model_name, head, feat_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return head_forward(self.head, self.encoder.forward_local(x),
                            self.encoder.compute_dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder features only (the probe's frozen feature extractor)."""
        return self.encoder(x)

    def forward_with_features(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(projection, encoder_features)`` from one backbone forward."""
        h = self.encoder.forward_local(x)
        return (head_forward(self.head, h, self.encoder.compute_dtype),
                tp_whole(h, self.encoder.out_features))


def infer_architecture(state_dict) -> Tuple[str, str, int]:
    """``(model_name, head, feat_dim)`` of a ``SupConResNet`` state dict in
    the reference layout (``'module.'`` stripped), read off its keys and
    shapes: the blocks of each stage, a Bottleneck's ``conv3``, and
    ``head.0``/``head.2`` (mlp) or ``head`` (linear). The port's
    counterpart of JAX ``infer_architecture_from_variables``
    (``models/heads.py:156-201``); raises ``ValueError`` on a state dict
    that is not a ``SupConResNet``'s."""
    if not any(k.startswith("encoder.") for k in state_dict) or not any(
            k.startswith("head.") for k in state_dict):
        raise ValueError(
            "state dict has no encoder/head keys: not a SupConResNet checkpoint "
            f"(top-level names: {sorted({k.split('.')[0] for k in state_dict})})"
        )
    stages = [0, 0, 0, 0]
    for key in state_dict:
        if m := re.match(r"encoder\.layer(\d)\.(\d+)\.", key):
            layer, block = int(m.group(1)), int(m.group(2))
            stages[layer - 1] = max(stages[layer - 1], block + 1)
    bottleneck = any(k.startswith("encoder.layer1.0.conv3.") for k in state_dict)
    name = next((n for n, (block_cls, sizes) in STAGE_PLANS.items()
                 if tuple(sizes) == tuple(stages) and (block_cls is Bottleneck) == bottleneck),
                None)
    if name is None:
        raise ValueError(
            f"unrecognized encoder geometry: stages={tuple(stages)}, bottleneck={bottleneck}"
        )
    if "head.0.weight" in state_dict:
        head, feat_dim = "mlp", int(state_dict["head.2.weight"].shape[0])
    elif "head.weight" in state_dict:
        head, feat_dim = "linear", int(state_dict["head.weight"].shape[0])
    else:
        raise ValueError(f"unrecognized projection head keys: "
                         f"{sorted(k for k in state_dict if k.startswith('head.'))}")
    return name, head, feat_dim


class PredictorHead(nn.Module):
    """The BYOL/SimSiam prediction MLP over the projector output (JAX
    ``models/heads.py:69``): ``fc1`` (dim_out -> dim_hidden), a batch-
    statistics normalization (biased variance, eps 1e-5, no running
    statistics: the predictor only ever runs in train mode) with the
    parameters ``bn_scale`` and ``bn_bias``, ReLU, ``fc2`` (dim_hidden ->
    dim_out). The names are the JAX module's, so ``utils/convert.py`` maps
    them one to one (a ``TorchDense`` kernel ``[in, out]`` is the
    ``weight [out, in]`` here). fp32; the init is torch's ``nn.Linear``
    default, U(±1/sqrt(fan_in)) for weight and bias, drawn from the
    ``generator`` given (:meth:`reset_parameters`).

    Under tensor parallelism (``parallel/mesh.shard_module``) ``bn_scale``
    and ``bn_bias`` (:attr:`tp_channel_params`) are sharded by the rule of
    ``fc1``'s output, whose channels they scale: a shard normalizes its own
    channels exactly, since the statistics are per channel. The whole
    input reaches a sharded ``fc1`` through ``models/resnet.tp_input``
    (its gradient summed over the model group), a sharded hidden layer is
    gathered before ``fc2`` reads it, and the output comes back whole."""

    # the parameters outside a conv, linear or BN that shard_module shards
    tp_channel_params = ("bn_scale", "bn_bias")

    def __init__(self, dim_hidden: int = 512, dim_out: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = nn.Linear(dim_out, dim_hidden)
        self.bn_scale = nn.Parameter(torch.ones(dim_hidden))
        self.bn_bias = nn.Parameter(torch.zeros(dim_hidden))
        self.fc2 = nn.Linear(dim_hidden, dim_out)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The linear layers' default init from ``generator`` (the global
        generator when ``None``); ``bn_scale`` 1, ``bn_bias`` 0."""
        for fc in (self.fc1, self.fc2):
            bound = 1.0 / math.sqrt(fc.in_features)
            fc.weight.uniform_(-bound, bound, generator=generator)
            fc.bias.uniform_(-bound, bound, generator=generator)
        self.bn_scale.fill_(1.0)
        self.bn_bias.zero_()

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.fc1(tp_input(self.fc1, z))
        mean = h.mean(dim=0, keepdim=True)
        var = h.var(dim=0, unbiased=False, keepdim=True)
        h = (h - mean) / torch.sqrt(var + 1e-5)
        h = torch.relu(h * self.bn_scale + self.bn_bias)
        return tp_whole(self.fc2(tp_input(self.fc2, h)), self.fc2.out_features)


class SupCEResNet(nn.Module):
    """Encoder + linear classifier for supervised cross-entropy (JAX
    ``models/heads.py:204``, reference ``resnet_big.py:184-193``), under the
    reference's state-dict names ``encoder.*`` and ``fc.*``. The classifier
    runs in fp32 on the encoder's fp32 features whatever the encoder's
    compute dtype. Cross-replica BN is set on the encoder
    (``model.encoder.set_bn_sync``, ``--syncBN``)."""

    def __init__(self, model_name: str = "resnet50", num_classes: int = 10):
        super().__init__()
        model_fn, dim_in = MODEL_DICT[model_name]
        self.encoder = model_fn()
        self.fc = nn.Linear(dim_in, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.encoder(x).float())


class LinearClassifier(nn.Module):
    """The linear probe over encoder features (JAX ``models/heads.py:234``):
    one ``nn.Linear`` named ``fc`` (state-dict names ``fc.weight`` and
    ``fc.bias``), torch's default init, fp32."""

    def __init__(self, model_name: str = "resnet50", num_classes: int = 10):
        super().__init__()
        _, feat_dim = MODEL_DICT[model_name]
        self.fc = nn.Linear(feat_dim, num_classes)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.fc(features)
