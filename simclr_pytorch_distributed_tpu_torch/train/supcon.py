"""Contrastive pretraining driver (reference ``main_supcon.py``) on one device.

    python -m simclr_pytorch_distributed_tpu_torch.train.supcon \\
        --dataset synthetic --model resnet50 --batch_size 256 --epochs 1 \\
        --method SimCLR --temp 0.5 --learning_rate 0.5 --cosine

Loop: the host loader gathers a uint8 batch (prefetched on a thread) ->
one copy to the device -> two-crop augmentation on the device -> the train
step (forward, loss, backward, SGD) -> one readback of the step's metrics
for the meters and the progress line -> checkpoints at ``--save_freq`` and
as ``last.pth``. The run is on ``cuda`` unless ``--device cpu`` is given,
and raises when CUDA is asked for and absent.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List

import torch

from simclr_pytorch_distributed_tpu_torch import config as config_lib
from simclr_pytorch_distributed_tpu_torch.data.cifar import load_dataset
from simclr_pytorch_distributed_tpu_torch.data.pipeline import EpochLoader
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
from simclr_pytorch_distributed_tpu_torch.ops.augment import (
    DATASET_STATS,
    AugmentConfig,
    two_crop_batch,
)
from simclr_pytorch_distributed_tpu_torch.ops.metrics import AverageMeter
from simclr_pytorch_distributed_tpu_torch.ops.schedules import make_lr_schedule
from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
    METRIC_KEYS,
    SupConStepConfig,
    train_step,
)
from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import save_model
from simclr_pytorch_distributed_tpu_torch.utils.logging_utils import setup_logging


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default) or ``cpu``; CUDA asked for and absent raises."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: no CUDA device is available (pass --device cpu "
                "to run on the CPU)"
            )
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")


def resolve_loss_impl_reasoned(loss_impl: str, device: torch.device) -> tuple:
    """``(resolved_impl, reason)``: 'auto' is the fused kernels on CUDA and
    the dense form on the CPU."""
    if loss_impl != "auto":
        reason = "explicit request"
        if loss_impl == "fused" and device.type == "cpu":
            reason += " (on cpu the kernels' plain PyTorch forms run)"
        return loss_impl, reason
    if device.type == "cuda":
        return "fused", "CUDA device: hand-written sm_90a kernels (ops/fused_loss.py)"
    return "dense", (
        f"{device.type} device: the fused kernels run on CUDA only, so the "
        "dense PyTorch loss"
    )


def make_augment_config(cfg: config_lib.SupConConfig) -> AugmentConfig:
    if cfg.dataset in DATASET_STATS:
        mean, std = DATASET_STATS[cfg.dataset]
    else:  # the synthetic sets
        mean, std = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)
    return AugmentConfig(size=cfg.size, mean=mean, std=std)


def build(cfg: config_lib.SupConConfig, steps_per_epoch: int, device: torch.device):
    """``(TrainState, SupConStepConfig)``: the model from ``cfg.seed``
    (built on the CPU, so an init is the same on every device), SGD, the
    schedule, and the step configuration with the resolved loss path."""
    torch.manual_seed(cfg.seed)
    model = SupConResNet(cfg.model, cfg.head, cfg.feat_dim)
    model = model.to(device=device, memory_format=torch.channels_last)
    grad_div = config_lib.resolve_ngpu(cfg.ngpu, 1)
    if grad_div != 1:
        logging.warning(
            "--ngpu %d on one device: gradients are divided by %d (the "
            "reference's %d-GPU gradient mean), an effective learning rate "
            "of %.4g; pass --ngpu auto to scale with this device",
            grad_div, grad_div, grad_div, cfg.learning_rate / grad_div,
        )
    schedule = make_lr_schedule(
        learning_rate=cfg.learning_rate, epochs=cfg.epochs,
        steps_per_epoch=steps_per_epoch, cosine=cfg.cosine,
        lr_decay_rate=cfg.lr_decay_rate, lr_decay_epochs=cfg.lr_decay_epochs,
        warm=cfg.warm, warm_epochs=cfg.warm_epochs, warmup_from=cfg.warmup_from,
    )
    optimizer = make_optimizer(model, momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    loss_impl, reason = resolve_loss_impl_reasoned(cfg.loss_impl, device)
    logging.info(
        "%s", config_lib.impl_resolution_banner("loss_impl", cfg.loss_impl, loss_impl, reason)
    )
    step_cfg = SupConStepConfig(
        method=cfg.method, temperature=cfg.temp,
        sec=cfg.sec, sec_wei=cfg.sec_wei, l2reg=cfg.l2reg, l2reg_wei=cfg.l2reg_wei,
        norm_momentum=cfg.norm_momentum, epochs=cfg.epochs,
        steps_per_epoch=steps_per_epoch, grad_div=float(grad_div), loss_impl=loss_impl,
    )
    return TrainState(model=model, optimizer=optimizer, schedule=schedule), step_cfg


def train_one_epoch(
    epoch: int, loader: EpochLoader, state: TrainState, step_cfg: SupConStepConfig,
    aug_cfg: AugmentConfig, generator: torch.Generator, cfg: config_lib.SupConConfig,
    device: torch.device, history: List[Dict[str, float]],
) -> None:
    """One epoch (reference ``train()``, ``main_supcon.py:242-351``); appends
    each step's metrics, as floats, to ``history``.

    ``step_time`` in a history entry is the wall time from the batch's copy
    to the device to the readback of the step's metrics, which waits for the
    device to finish the step."""
    batch_time, data_time, losses = AverageMeter(), AverageMeter(), AverageMeter()
    steps = len(loader)
    device_keys = [k for k in METRIC_KEYS if k != "learning_rate"]
    end = time.time()
    for idx, (images_u8, labels) in enumerate(loader.epoch(epoch)):
        data_time.update(time.time() - end)
        t0 = time.time()
        images = torch.from_numpy(images_u8).to(device, non_blocking=True)
        labels_d = torch.from_numpy(labels).to(device, non_blocking=True)
        views = two_crop_batch(generator, images, aug_cfg)
        metrics = train_step(state, step_cfg, views, labels_d)
        values = torch.stack([metrics[k] for k in device_keys]).tolist()
        host = dict(zip(device_keys, values), learning_rate=float(metrics["learning_rate"]))
        host.update(epoch=epoch, step=state.step - 1, step_time=time.time() - t0)
        history.append(host)
        losses.update(host["loss"], cfg.batch_size)
        batch_time.update(time.time() - end)
        if (idx + 1) % cfg.print_freq == 0 or idx + 1 == steps:
            logging.info(
                "Train: [%d][%d/%d]\tBT %.3f (%.3f)\tDT %.3f (%.3f)\t"
                "loss %.3f (%.3f)\tnorm_mean %.3f (record: %.3f) var %.3f",
                epoch, idx + 1, steps, batch_time.val, batch_time.avg,
                data_time.val, data_time.avg, losses.val, losses.avg,
                host["norm_mean"], host["record_norm_mean"], host["norm_var"],
            )
        end = time.time()


@dataclasses.dataclass
class RunResult:
    state: TrainState
    history: List[Dict[str, float]]
    save_folder: str


def run(cfg: config_lib.SupConConfig) -> RunResult:
    device = resolve_device(cfg.device)
    setup_logging(cfg.save_folder)
    logging.info(
        "device: %s (%s)", device,
        torch.cuda.get_device_name(device) if device.type == "cuda" else "host CPU",
    )
    train_data, _, _ = load_dataset(cfg.dataset, cfg.data_folder)
    loader = EpochLoader(
        train_data["images"], train_data["labels"], cfg.batch_size, base_seed=cfg.seed
    )
    state, step_cfg = build(cfg, len(loader), device)
    aug_cfg = make_augment_config(cfg)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed + 1)
    history: List[Dict[str, float]] = []
    for epoch in range(1, cfg.epochs + 1):
        t1 = time.time()
        train_one_epoch(
            epoch, loader, state, step_cfg, aug_cfg, generator, cfg, device, history
        )
        logging.info("epoch %d, total time %.2f", epoch, time.time() - t1)
        if epoch % cfg.save_freq == 0:
            save_model(
                state.model, state.optimizer, cfg, epoch,
                os.path.join(cfg.save_folder, f"ckpt_epoch_{epoch}.pth"),
            )
    save_model(
        state.model, state.optimizer, cfg, cfg.epochs,
        os.path.join(cfg.save_folder, "last.pth"),
    )
    return RunResult(state=state, history=history, save_folder=cfg.save_folder)


def main(argv=None) -> RunResult:
    return run(config_lib.parse_supcon(argv))


if __name__ == "__main__":
    main()
