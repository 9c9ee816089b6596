"""CIFAR-variant ResNet family (10/18/34/50/101) as torch modules.

Architecture of ``simclr_pytorch_distributed_tpu/models/resnet.py`` and the
reference ``networks/resnet_big.py``:

- CIFAR stem: one 3x3 stride-1 conv, no maxpool;
- four stages of widths 64/128/256/512 with strides 1/2/2/2;
- ``BasicBlock`` (expansion 1) and ``Bottleneck`` (expansion 4), with a
  1x1-conv+BN projection shortcut on shape change;
- global average pool giving 512 (rn10/18/34) or 2048 (rn50/101) features;
- Kaiming-normal fan-out conv init, BN weight 1 / bias 0.

Module names are the reference state-dict names (``conv1``, ``bn1``,
``layer{L}.{i}.conv{k}/bn{k}``, ``shortcut.0/1``), so a ``state_dict()`` is
the reference layout. Every 3x3 conv pads (1, 1), at stride 2 too, which is
the alignment the JAX package pins with explicit padding.

BN is ``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``: in train mode it
normalizes with the biased batch variance and updates the running variance
with the unbiased one, which is the JAX package's ``CrossReplicaBatchNorm``
over one whole-batch group.

Inputs are NHWC, as in the JAX package; ``ResNet.forward`` permutes them
once to NCHW, which on an NHWC-contiguous tensor is a ``channels_last`` view
and no copy.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, Type, Union

import torch
from torch import nn


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block, expansion 1 (reference resnet_big.py:7-34)."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.shortcut = _shortcut(in_planes, planes * self.expansion, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + self.shortcut(x))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual block, expansion 4 (reference resnet_big.py:37-67)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * self.expansion, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.shortcut = _shortcut(in_planes, planes * self.expansion, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + self.shortcut(x))


def _shortcut(in_planes: int, out_planes: int, stride: int) -> nn.Sequential:
    if stride == 1 and in_planes == out_planes:
        return nn.Sequential()
    return nn.Sequential(
        nn.Conv2d(in_planes, out_planes, 1, stride, bias=False),
        nn.BatchNorm2d(out_planes),
    )


Block = Union[Type[BasicBlock], Type[Bottleneck]]


class ResNet(nn.Module):
    """CIFAR-stem ResNet encoder: NHWC images -> ``[N, feat_dim]``."""

    def __init__(self, block: Block, stage_sizes: Sequence[int]):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        in_planes = 64
        for stage, (n_blocks, width, stride) in enumerate(
            zip(stage_sizes, (64, 128, 256, 512), (1, 2, 2, 2)), start=1
        ):
            blocks = []
            for i in range(n_blocks):
                blocks.append(block(in_planes, width, stride if i == 0 else 1))
                in_planes = width * block.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3))


def resnet10() -> ResNet:
    """One BasicBlock per stage: the JAX package's smoke-test extension,
    not in the reference model_dict."""
    return ResNet(BasicBlock, (1, 1, 1, 1))


def resnet18() -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2))


def resnet34() -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3))


def resnet50() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3))


def resnet101() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3))


# name -> (constructor, feature dim); reference model_dict resnet_big.py:137-142
MODEL_DICT: Dict[str, Tuple[Callable[[], ResNet], int]] = {
    "resnet10": (resnet10, 512),
    "resnet18": (resnet18, 512),
    "resnet34": (resnet34, 512),
    "resnet50": (resnet50, 2048),
    "resnet101": (resnet101, 2048),
}
