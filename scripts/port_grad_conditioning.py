"""How far fp32 gradients of the rn50 SupConResNet sit from float64, per path.

    JAX_PLATFORMS=cpu python scripts/port_grad_conditioning.py [--size 16] [--rows 8]

One seeded set of weights (the PyTorch port's init with perturbed BN
affines) and one seeded batch go through four fp32 paths: the port's eager
modules, the port's ``conv_impl='fused'`` path (plain forms on the CPU), the
JAX package's XLA path and its Pallas path (interpret mode). Each path's
parameter gradients of ``sum(out * cos(out))`` are held against the port's
eager path run in float64, and the script prints, per path, the worst
per-tensor relative L2 error, the global one, and the worst single element
as a share of its tensor's largest entry; plus the port's fused path in
float64 against its eager path in float64. CPU only; it reads no device
metric. ``tests/test_torch_port_conv.py`` takes its gradient pin from these
numbers.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.utils.convert import (  # noqa: E402
    state_dict_to_variables,
    variables_to_state_dict,
)


def port_model(conv_impl: str, seed: int = 3) -> SupConResNet:
    torch.manual_seed(seed)
    model = SupConResNet("resnet50", "mlp", 16)
    model.encoder.set_conv_impl(conv_impl)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
    return model


def port_grads(conv_impl: str, x: np.ndarray, dtype: torch.dtype) -> dict:
    model = port_model(conv_impl).to(dtype).train()
    out = model(torch.from_numpy(x).to(dtype))
    (out * torch.cos(out)).sum().backward()
    return {k: p.grad.double().numpy() for k, p in model.named_parameters()}


def jax_grads(conv_impl: str, x: np.ndarray, keys) -> dict:
    variables = state_dict_to_variables(port_model("eager").state_dict())
    jm = JaxSupConResNet(model_name="resnet50", head="mlp", feat_dim=16, conv_impl=conv_impl)

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * jnp.cos(out)), mut

    (_, mut), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, variables["params"])
    )
    sd = variables_to_state_dict({"params": grads, "batch_stats": mut["batch_stats"]})
    return {k: sd[k].double().numpy() for k in keys}


def errors(got: dict, truth: dict) -> tuple:
    per = max((np.linalg.norm(got[k] - truth[k]) / np.linalg.norm(truth[k]), k) for k in truth)
    glob = np.sqrt(sum(((got[k] - truth[k]) ** 2).sum() for k in truth)
                   / sum((truth[k] ** 2).sum() for k in truth))
    elem = max(np.abs(got[k] - truth[k]).max() / np.abs(truth[k]).max() for k in truth)
    return per, glob, elem


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--rows", type=int, default=8)
    args = p.parse_args()
    x = np.random.default_rng(11).standard_normal(
        (args.rows, args.size, args.size, 3)).astype(np.float32)
    truth = port_grads("eager", x, torch.float64)
    paths = {
        "port eager fp32": port_grads("eager", x, torch.float32),
        "port fused fp32": port_grads("fused", x, torch.float32),
        "jax xla fp32": jax_grads("xla", x, truth.keys()),
        "jax pallas fp32": jax_grads("pallas", x, truth.keys()),
        "port fused fp64": port_grads("fused", x, torch.float64),
    }
    print(f"rn50 SupConResNet, {args.rows} rows at {args.size} px, gradients of "
          "sum(out * cos(out)) against the port's eager path in float64 (CPU):")
    for name, grads in paths.items():
        (per, key), glob, elem = errors(grads, truth)
        print(f"  {name}: worst per-tensor relative L2 {per:.3e} ({key}), global "
              f"{glob:.3e}, worst element / its tensor's max {elem:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
