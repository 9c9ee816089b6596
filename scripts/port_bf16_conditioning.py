"""How well conditioned the port's bf16 step is, and what its pins catch.

    python3 scripts/port_bf16_conditioning.py [--gammas 1,0.2,0.1,0.05,0.02]

On one CUDA card, at the recipe's width (batch 256, 32 px, two crops) and
the seeded init and batch ``chip_smoke.py`` uses, for ResNet-50 and
ResNet-18:

- the gradient of every parameter for one fixed random cotangent on the
  projection, with each residual branch's last BN gamma scaled by each of
  ``--gammas``: fp32 eager against float64 eager, and eager and fused
  (the bf16 kernels) bf16 against fp32 eager. Per path the lowest
  per-parameter cosine and the median relative L2 distance;
- ``chip_smoke.step_check_bf16`` at each scale but 1 (the step check's
  readings, and whether its pins hold);
- simulated faults against the bf16 plain form: the Bottleneck kernel's
  own weight gradients at layer1's geometries with one 64-channel tile
  zeroed, or their first 32 rows of K, in relative L2.

Prints one line per reading; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import copy
import os
import statistics
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.data.cifar import synthetic_dataset  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.models.resnet import (  # noqa: E402
    BasicBlock,
    Bottleneck,
)
from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.ops.augment import (  # noqa: E402
    AugmentConfig,
    two_crop_batch,
)
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import two_view_forward  # noqa: E402


def scaled_branches(model, gamma):
    model = copy.deepcopy(model)
    with torch.no_grad():
        for block in model.modules():
            if isinstance(block, (BasicBlock, Bottleneck)):
                (block.bn3 if isinstance(block, Bottleneck) else block.bn2).weight.mul_(gamma)
    return model


def grads(model, views, impl, dtype, cot):
    m = copy.deepcopy(model).to(torch.float64 if dtype == torch.float64 else torch.float32)
    m.encoder.set_conv_impl(impl)
    if dtype != torch.float64:
        m.encoder.set_compute_dtype(dtype)
    m.train()
    out = two_view_forward(m, views.to(m.encoder.conv1.weight.dtype))
    (out.double() * cot).sum().backward()
    return {k: p.grad.double() for k, p in m.named_parameters()}


def compare(got, ref):
    cos = [cs.bf16_measure(got[k], r)[1] for k, r in ref.items()]
    l2 = [cs.rel_l2(got[k], r) for k, r in ref.items()]
    return f"cosine lowest {min(cos):.6f}, relative L2 median {statistics.median(l2):.3e}"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--gammas", default="1,0.2,0.1,0.05,0.02")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    data, _ = synthetic_dataset()
    images = torch.from_numpy(data["images"][:256]).to(dev)
    labels = torch.from_numpy(data["labels"][:256]).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    views = two_crop_batch(gen, images, AugmentConfig(mean=(0.5,) * 3, std=(0.25,) * 3))
    gammas = [float(g) for g in args.gammas.split(",")]
    for name in ("resnet50", "resnet18"):
        torch.manual_seed(0)
        model = SupConResNet(name).to(dev, memory_format=torch.channels_last)
        cot = torch.randn((512, 128), generator=torch.Generator().manual_seed(13)).to(dev).double()
        for gamma in gammas:
            m = scaled_branches(model, gamma)
            ref = grads(m, views, "eager", torch.float32, cot)
            exact = grads(m, views, "eager", torch.float64, cot)
            print(f"{name} branch gamma x {gamma} fixed-cotangent gradient: fp32 vs float64 "
                  f"{compare(ref, exact)}", flush=True)
            for impl in ("eager", "fused"):
                got = grads(m, views, impl, torch.bfloat16, cot)
                print(f"{name} branch gamma x {gamma} fixed-cotangent gradient: bf16 {impl} vs "
                      f"fp32 {compare(got, ref)}", flush=True)
            if gamma != 1.0:
                cs.BRANCH_GAMMA = gamma
                try:
                    cs.step_check_bf16(name, model, views, labels)
                    print(f"{name} branch gamma x {gamma}: step check holds")
                except AssertionError as e:
                    print(f"{name} branch gamma x {gamma}: step check fails on "
                          f"{str(e).count(chr(10))} readings")
            torch.cuda.empty_cache()
    for geo in ((512, 32, 32, 64, 64, 1), (512, 32, 32, 256, 64, 1)):
        _, _, fwd, bwd = cs.site_calls(fc, "bottleneck", geo, dev, 2, 0.0, torch.bfloat16)
        ref = fwd[1]()
        gout = cs.rand(tuple(ref[0].shape), torch.Generator().manual_seed(5), dev).bfloat16()
        bargs, kernel, plain_fn, names = bwd(ref[1:], gout)
        got, plain = kernel(*bargs), plain_fn(*bargs)
        for name, g, p in zip(names, got, plain):
            if not name.startswith("dk"):
                continue
            tile, chunk = g.clone(), g.clone()
            tile.view(-1, g.shape[-1])[:, :64] = 0
            chunk.view(-1, g.shape[-1])[:32] = 0
            print(f"simulated fault, bottleneck {geo} {name} {tuple(g.shape)}: relative L2 to "
                  f"the bf16 plain form {cs.rel_l2(g, p):.3e} as launched, "
                  f"{cs.rel_l2(tile, p):.3e} with a 64-channel tile zeroed, "
                  f"{cs.rel_l2(chunk, p):.3e} without its first 32 rows of K "
                  f"(pin {cs.BF16_REL_L2['grad']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
