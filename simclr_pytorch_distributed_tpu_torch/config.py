"""Pretraining configuration: the flags this port honours, with the JAX
package's names, defaults and derived fields (reference
``main_supcon.py:22-152``).

Derived fields: the ``model_name`` run string (``main_supcon.py:109-117``),
auto-warmup when ``batch_size > 256`` (``:120-121``), the closed-form
``warmup_to`` (``:124-131``) and the timestamped save folder (``:133-142``).

Flags the port does not implement yet are absent, so argparse rejects them.
Added here: ``--device {cuda,cpu}`` (default ``cuda``), ``--loss_impl
{dense,fused,auto}`` and ``--conv_impl {eager,fused,auto}`` (the JAX
package's ``--conv_impl {xla,pallas,auto}``). ``--bf16`` is the JAX
package's (``config.py:85, 348``): bf16 activations and conv/linear
operands with fp32 accumulation, fp32 parameters, BN statistics and loss.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
from typing import Tuple

from simclr_pytorch_distributed_tpu_torch.data.cifar import DATASETS
from simclr_pytorch_distributed_tpu_torch.ops.schedules import warmup_to_value


@dataclasses.dataclass
class SupConConfig:
    print_freq: int = 10
    save_freq: int = 20
    batch_size: int = 256
    epochs: int = 1000
    learning_rate: float = 0.5
    lr_decay_epochs: Tuple[int, ...] = (700, 800, 900)
    lr_decay_rate: float = 0.1
    weight_decay: float = 1e-4
    momentum: float = 0.9
    model: str = "resnet50"
    dataset: str = "cifar10"
    data_folder: str = "./datasets/"
    size: int = 32
    method: str = "SimCLR"
    temp: float = 0.5
    cosine: bool = False
    warm: bool = False
    trial: str = "0"
    sec: bool = False
    sec_wei: float = 0.0
    norm_momentum: float = 1.0
    l2reg: bool = False
    l2reg_wei: float = 0.0
    # the DDP gradient-mean divisor of the reference's --ngpu runs
    # (train/supcon_step.py); 'auto' = the number of devices (1 here)
    ngpu: object = 2
    head: str = "mlp"
    feat_dim: int = 128
    seed: int = 0
    workdir: str = "./work_space"
    loss_impl: str = "auto"
    conv_impl: str = "auto"
    device: str = "cuda"
    bf16: bool = False
    # derived (finalize_supcon)
    warm_epochs: int = 10
    warmup_from: float = 0.01
    warmup_to: float = 0.0
    model_name: str = ""
    save_folder: str = ""


def ngpu_arg(s: str):
    """``--ngpu``: a positive integer or 'auto'."""
    if s.strip().lower() == "auto":
        return "auto"
    try:
        v = int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--ngpu expects a positive integer or 'auto', got {s!r}"
        ) from None
    if v <= 0:
        raise argparse.ArgumentTypeError(f"--ngpu must be positive, got {v}")
    return v


def resolve_ngpu(ngpu, n_devices: int) -> int:
    return int(n_devices) if ngpu == "auto" else int(ngpu)


def supcon_parser() -> argparse.ArgumentParser:
    d = SupConConfig()
    p = argparse.ArgumentParser("argument for training")
    p.add_argument("--print_freq", type=int, default=d.print_freq)
    p.add_argument("--save_freq", type=int, default=d.save_freq)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--learning_rate", type=float, default=d.learning_rate)
    p.add_argument("--lr_decay_epochs", type=str, default="700,800,900")
    p.add_argument("--lr_decay_rate", type=float, default=d.lr_decay_rate)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--momentum", type=float, default=d.momentum)
    p.add_argument("--model", type=str, default=d.model)
    p.add_argument("--dataset", type=str, default=d.dataset, choices=list(DATASETS))
    p.add_argument("--data_folder", type=str, default=d.data_folder)
    p.add_argument("--size", type=int, default=d.size)
    p.add_argument("--method", type=str, default=d.method, choices=["SupCon", "SimCLR"])
    p.add_argument("--temp", type=float, default=d.temp)
    p.add_argument("--cosine", action="store_true")
    p.add_argument("--warm", action="store_true")
    p.add_argument("--trial", type=str, default=d.trial)
    p.add_argument("--sec", action="store_true")
    p.add_argument("--sec_wei", type=float, default=d.sec_wei)
    p.add_argument("--norm_momentum", type=float, default=d.norm_momentum)
    p.add_argument("--l2reg", action="store_true")
    p.add_argument("--l2reg_wei", type=float, default=d.l2reg_wei)
    p.add_argument("--ngpu", type=ngpu_arg, default=d.ngpu,
                   help="DDP grad-mean divisor (reference fidelity), or 'auto'")
    p.add_argument("--head", type=str, default=d.head, choices=["mlp", "linear"])
    p.add_argument("--feat_dim", type=int, default=d.feat_dim)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--workdir", type=str, default=d.workdir)
    p.add_argument("--loss_impl", type=str, default=d.loss_impl,
                   choices=["auto", "dense", "fused"],
                   help="contrastive loss: the fused CUDA kernels, the dense "
                        "PyTorch form, or auto (fused on cuda, dense on cpu)")
    p.add_argument("--conv_impl", type=str, default=d.conv_impl,
                   choices=["auto", "eager", "fused"],
                   help="encoder conv path in train mode: the fused conv+BN CUDA "
                        "kernels for the stem and Bottlenecks, eager cuDNN convs "
                        "and BatchNorm2d, or auto (fused on cuda, eager on cpu)")
    p.add_argument("--device", type=str, default=d.device, choices=["cuda", "cpu"])
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute: activations and conv/linear operands in bf16 with "
                        "fp32 accumulation; parameters, BN statistics and the loss fp32")
    return p


def parse_supcon(argv=None) -> SupConConfig:
    kwargs = vars(supcon_parser().parse_args(argv))
    kwargs["lr_decay_epochs"] = tuple(int(x) for x in kwargs["lr_decay_epochs"].split(","))
    return finalize_supcon(SupConConfig(**kwargs))


def finalize_supcon(cfg: SupConConfig) -> SupConConfig:
    """Derived fields, replicating main_supcon.py:92-150. The save folder
    is named here and created by the driver."""
    cfg.model_name = (
        f"{cfg.method}_{cfg.dataset}_{cfg.model}_lr_{cfg.learning_rate}"
        f"_decay_{cfg.weight_decay}_bsz_{cfg.batch_size}_temp_{cfg.temp}_trial_{cfg.trial}"
    )
    if cfg.cosine:
        cfg.model_name = f"{cfg.model_name}_cosine"
    if cfg.sec:
        cfg.model_name = f"{cfg.model_name}_sec"
    if cfg.batch_size > 256:
        cfg.warm = True
    if cfg.warm:
        cfg.model_name = f"{cfg.model_name}_warm"
        cfg.warmup_from = 0.01
        cfg.warm_epochs = 10
        cfg.warmup_to = warmup_to_value(
            cfg.learning_rate, cfg.lr_decay_rate, cfg.warm_epochs, cfg.epochs, cfg.cosine
        )
    now_time = datetime.datetime.now().strftime("%m%d_%H%M")
    cfg.save_folder = os.path.join(
        cfg.workdir, f"{cfg.dataset}_models", f"{cfg.dataset}_{now_time}_{cfg.model_name}"
    )
    return cfg


def impl_resolution_banner(flag: str, requested: str, resolved: str, reason: str) -> str:
    """One startup line naming the resolved implementation and why."""
    if requested == resolved:
        return f"[{flag}] '{resolved}': {reason}"
    return f"[{flag}] requested '{requested}' -> resolved '{resolved}': {reason}"
