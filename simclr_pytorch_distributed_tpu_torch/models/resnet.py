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

``conv_impl`` (``ResNet.set_conv_impl``, the one place it is set):
``"eager"`` runs the cuDNN convs and ``nn.BatchNorm2d``; ``"fused"`` routes
train-mode forwards of the stem and of every BasicBlock (identity or
projection) and Bottleneck that the ``supports_*`` gates admit through the
fused conv+BN kernels of ``ops/fused_conv.py`` (the JAX package's
``conv_impl="pallas"``, ``models/resnet.py:94-134, 176-224, 303-328``); the
encoder passes the choice down to its blocks as ``forward``'s ``fused``
argument. The ``nn.Conv2d``/``nn.BatchNorm2d`` modules stay the owners of the
parameters and running buffers, so ``state_dict()`` does not depend on the
path; eval mode and sites the gates reject stay eager.

``compute_dtype`` (``ResNet.set_compute_dtype``, beside ``set_conv_impl``):
fp32 (the default; the model computes in the dtype of its parameters and
input) or bf16, the JAX package's ``--bf16`` (``models/resnet.py:297``,
Flax ``dtype``/``param_dtype``): the input is cast to bf16 at the encoder's
entry, eager convs cast their fp32 weights to bf16 per forward and return
bf16, BN runs on bf16 activations with fp32 statistics and buffers
(``models/norm.batch_norm``), the fused sites take bf16 activations and
the fp32 weights (the ops cast them), and the pooled features come back in
fp32. Parameters and buffers stay fp32, so checkpoints move between the
two dtypes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple, Type, Union

import torch
import torch.nn.functional as F
from torch import nn

from simclr_pytorch_distributed_tpu_torch.models.norm import apply_running_update, batch_norm
from simclr_pytorch_distributed_tpu_torch.ops import fused_conv

CONV_IMPLS = ("eager", "fused")


def conv(module: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``module`` applied to ``x``, its weight cast to ``x.dtype`` when the
    two differ (an fp32 weight under bf16 compute)."""
    if module.weight.dtype == x.dtype:
        return module(x)
    return F.conv2d(x, module.weight.to(x.dtype), None, module.stride, module.padding,
                    module.dilation, module.groups)


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
        self.stride = stride

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        """``fused``: run a train-mode forward through the fused kernels
        where ``supports_block`` admits this geometry."""
        n, cin, h, w = x.shape
        if (
            fused
            and self.training
            and fused_conv.supports_block(
                n, h, w, self.conv1.out_channels, stride=self.stride, in_channels=cin
            )
        ):
            return self._fused_forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        out = torch.relu(batch_norm(self.bn1, conv(self.conv1, x)))
        out = batch_norm(self.bn2, conv(self.conv2, out))
        return torch.relu(out + _shortcut_forward(self.shortcut, x))

    def _fused_forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC train-mode forward through ``fused_basic_block`` (identity
        shortcut) or ``fused_projection_block``, then the running updates,
        every BN over the output grid."""
        c, cin = self.conv1.out_channels, self.conv1.in_channels
        main = (
            x,
            self.conv1.weight.permute(2, 3, 1, 0), self.bn1.weight, self.bn1.bias,
            self.conv2.weight.permute(2, 3, 1, 0), self.bn2.weight, self.bn2.bias,
        )
        if len(self.shortcut):
            conv_s, bn_s = self.shortcut
            r = fused_conv.fused_projection_block(
                *main, conv_s.weight.reshape(c, cin).t(), bn_s.weight, bn_s.bias,
                stride=self.stride, eps=self.bn1.eps,
            )
        else:
            r = fused_conv.fused_basic_block(*main, eps=self.bn1.eps)
        n, h, w, _ = x.shape
        count = n * (h // self.stride) * (w // self.stride)
        apply_running_update(self.bn1, r[1], r[2], count)
        apply_running_update(self.bn2, r[3], r[4], count)
        if len(self.shortcut):
            apply_running_update(self.shortcut[1], r[5], r[6], count)
        return r[0]


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
        self.stride = stride

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        """``fused``: run a train-mode forward through the fused kernels
        where ``supports_bottleneck`` admits this geometry."""
        n, cin, h, w = x.shape
        if (
            fused
            and self.training
            and fused_conv.supports_bottleneck(
                n, h, w, self.conv2.in_channels, stride=self.stride, in_channels=cin
            )
        ):
            return self._fused_forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        out = torch.relu(batch_norm(self.bn1, conv(self.conv1, x)))
        out = torch.relu(batch_norm(self.bn2, conv(self.conv2, out)))
        out = batch_norm(self.bn3, conv(self.conv3, out))
        return torch.relu(out + _shortcut_forward(self.shortcut, x))

    def _fused_forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC train-mode forward through ``fused_bottleneck_block``, then
        the running updates: BN1 over the input grid, the rest over the
        output grid."""
        p, cin = self.conv1.out_channels, self.conv1.in_channels
        shortcut = None
        if len(self.shortcut):
            conv_s, bn_s = self.shortcut
            shortcut = (conv_s.weight.reshape(4 * p, cin).t(), bn_s.weight, bn_s.bias)
        r = fused_conv.fused_bottleneck_block(
            x,
            self.conv1.weight.reshape(p, cin).t(), self.bn1.weight, self.bn1.bias,
            self.conv2.weight.permute(2, 3, 1, 0), self.bn2.weight, self.bn2.bias,
            self.conv3.weight.reshape(4 * p, p).t(), self.bn3.weight, self.bn3.bias,
            shortcut, stride=self.stride, eps=self.bn1.eps,
        )
        n, h, w, _ = x.shape
        count1 = n * h * w
        count2 = n * (h // self.stride) * (w // self.stride)
        apply_running_update(self.bn1, r[1], r[2], count1)
        apply_running_update(self.bn2, r[3], r[4], count2)
        apply_running_update(self.bn3, r[5], r[6], count2)
        if shortcut is not None:
            apply_running_update(self.shortcut[1], r[7], r[8], count2)
        return r[0]


def _shortcut(in_planes: int, out_planes: int, stride: int) -> nn.Sequential:
    if stride == 1 and in_planes == out_planes:
        return nn.Sequential()
    return nn.Sequential(
        nn.Conv2d(in_planes, out_planes, 1, stride, bias=False),
        nn.BatchNorm2d(out_planes),
    )


def _shortcut_forward(shortcut: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """The eager shortcut: ``x`` itself, or its 1x1/s conv + BN."""
    if not len(shortcut):
        return x
    conv_s, bn_s = shortcut
    return batch_norm(bn_s, conv(conv_s, x))


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
        self.conv_impl = "eager"
        self.compute_dtype = torch.float32

    def set_conv_impl(self, conv_impl: str) -> "ResNet":
        """Route train-mode forwards through ``conv_impl`` ('eager' or
        'fused'), for the stem and every block."""
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {conv_impl!r}")
        self.conv_impl = conv_impl
        return self

    def set_compute_dtype(self, dtype: torch.dtype) -> "ResNet":
        """Compute in ``dtype`` (fp32 or bf16): activations and conv
        operands; parameters, buffers and BN statistics stay fp32."""
        if dtype not in fused_conv.COMPUTE_DTYPES:
            raise ValueError(f"compute dtype must be one of {fused_conv.COMPUTE_DTYPES}, "
                             f"got {dtype}")
        self.compute_dtype = dtype
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.bfloat16:
            x = x.to(torch.bfloat16)
        n, h, w, cin = x.shape
        if (
            self.conv_impl == "fused"
            and self.training
            and fused_conv.supports_stem(n, h, w, cin, self.conv1.out_channels)
        ):
            out, m, v = fused_conv.fused_conv_bn_relu(
                x, self.conv1.weight.permute(2, 3, 1, 0), self.bn1.weight, self.bn1.bias,
                eps=self.bn1.eps,
            )
            apply_running_update(self.bn1, m, v, n * h * w)
            x = out.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        else:
            x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
            x = torch.relu(batch_norm(self.bn1, conv(self.conv1, x)))
        fused = self.conv_impl == "fused"
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x, fused)
        feats = x.mean(dim=(2, 3))
        return feats.float() if feats.dtype == torch.bfloat16 else feats


# name -> (block, blocks per stage); resnet10, one BasicBlock per stage, is
# the JAX package's smoke-test extension, not in the reference model_dict
STAGE_PLANS: Dict[str, Tuple[Block, Tuple[int, ...]]] = {
    "resnet10": (BasicBlock, (1, 1, 1, 1)),
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
}


def resnet10() -> ResNet:
    return ResNet(*STAGE_PLANS["resnet10"])


def resnet18() -> ResNet:
    return ResNet(*STAGE_PLANS["resnet18"])


def resnet34() -> ResNet:
    return ResNet(*STAGE_PLANS["resnet34"])


def resnet50() -> ResNet:
    return ResNet(*STAGE_PLANS["resnet50"])


def resnet101() -> ResNet:
    return ResNet(*STAGE_PLANS["resnet101"])


# name -> (constructor, feature dim); reference model_dict resnet_big.py:137-142
MODEL_DICT: Dict[str, Tuple[Callable[[], ResNet], int]] = {
    "resnet10": (resnet10, 512),
    "resnet18": (resnet18, 512),
    "resnet34": (resnet34, 512),
    "resnet50": (resnet50, 2048),
    "resnet101": (resnet101, 2048),
}


def fused_site_plan(model: str, rows: int, size: int,
                    dtype: torch.dtype = torch.float32) -> List[dict]:
    """The per-site geometry walk for ``--conv_impl fused`` in compute dtype
    ``dtype`` (the JAX package's ``fused_site_plan``,
    ``models/resnet.py:400-469``).

    It walks ``STAGE_PLANS`` as ``ResNet.__init__`` does, building no
    model, and asks the same
    ``ops/fused_conv.supports_*`` gates the modules ask at run time, so the
    resolution banner and the modules agree on which sites fuse. ``h``/``w``
    are each block's INPUT dims; a stride-2 site's output is ``ceil(h/2)``
    ((1, 1) padding), which the even-dims rule makes exact where a stride-2
    site is admitted. ``rows`` is the encoder's batch (``2 * batch_size``
    for the two-crop step). One dict per site: ``name``, ``kind``
    ('stem'|'basic'|'proj'|'bottleneck'), ``h``, ``w``, ``in_channels``,
    ``width``, ``stride``, ``admitted``, ``desc``.
    """
    block_cls, stage_sizes = STAGE_PLANS[model]
    h = w = size
    sites = [{
        "name": "stem", "kind": "stem", "h": h, "w": w, "in_channels": 3,
        "width": 64, "stride": 1,
        "admitted": fused_conv.supports_stem(rows, h, w, 3, 64, dtype=dtype),
        "desc": f"stem 3->64@{h}x{w}",
    }]
    in_c = 64
    for stage, (width, stage_stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2)), 1):
        for block in range(stage_sizes[stage - 1]):
            stride = stage_stride if block == 0 else 1
            name = f"layer{stage}_block{block}"
            if block_cls is Bottleneck:
                kind = "bottleneck"
                admitted = fused_conv.supports_bottleneck(
                    rows, h, w, width, stride=stride, in_channels=in_c, dtype=dtype
                )
            else:
                kind = "basic" if (stride == 1 and in_c == width) else "proj"
                admitted = fused_conv.supports_block(
                    rows, h, w, width, stride=stride, in_channels=in_c, dtype=dtype
                )
            out_c = width * block_cls.expansion
            sites.append({
                "name": name, "kind": kind, "h": h, "w": w, "in_channels": in_c,
                "width": width, "stride": stride, "admitted": admitted,
                "desc": f"{name}[{kind}] {in_c}->{out_c}@{h}x{w}/s{stride}",
            })
            if stride != 1:
                h, w = (h + 1) // 2, (w + 1) // 2
            in_c = out_c
    return sites
