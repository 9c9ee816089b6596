"""Supervised cross-entropy baseline trainer (reference ``main_ce.py``'s lost
trainer; JAX ``train/ce.py``), on one device or data parallel over several.

    python -m simclr_pytorch_distributed_tpu_torch.train.ce \\
        --dataset synthetic --model resnet50 --batch_size 256 --epochs 1

    torchrun --nproc_per_node P -m simclr_pytorch_distributed_tpu_torch.train.ce \\
        --dataset synthetic --model resnet50 --batch_size 256 --epochs 1 --syncBN

``SupCEResNet`` (encoder and linear classifier) trained end to end with the
probe's augmentation (random resized crop and flip, no color ops; the
validation transform normalizes only), SGD with momentum and weight decay
on the shared per-iteration schedule, and top-1/top-5 validation over the
whole test split after every epoch (``train/linear.validate``). The best
top-1 and its top-5 are run state: they ride every checkpoint's
``run_meta``, so a resumed run that never beats its earlier peak still
reports it.

Like the JAX trainer, whose ``SupCEResNet`` takes no ``conv_impl``, the
encoder runs eager convolutions (cuDNN), not the fused conv kernels.
``--bf16`` runs the encoder in bf16 compute; the classifier and the loss
are fp32.

Per step: the uint8 batch (from ``--data_placement``'s store, as in the
pretrain driver, JAX ``train/ce.py:201-216``; validation reads the host
arrays), the augmentation on the device, the step, and the step's global loss and top-1/top-5 counts
written into the device-side metric ring; at each ``--print_freq``
boundary the window is flushed (``utils/telemetry.py``: one transfer, the
meters and the progress line on the telemetry thread under ``--telemetry
async``). The observability stack is the pretrain driver's
(``utils/obs.py``): ``events.jsonl``/``trace.json`` in the run folder,
``--watchdog_secs``, ``--metrics_port``, ``--trace_dir``.

Checkpoints are the pretrain driver's full-state ``.pth``
(``utils/checkpoint.py``): ``ckpt_epoch_N.pth`` every ``--save_freq``
epochs and ``last.pth`` at the end. ``--resume`` continues at the first
step not taken, bit for bit. SIGTERM/SIGINT: the run goes on to the next
``--print_freq`` flush boundary, where the processes vote, the state is
saved as ``preempt_epoch_{e}_step_{k}.pth`` (or
``preempt_epoch_{e}.pth`` at an epoch's end, unless the scheduled save
covers it) and the run exits 75.

Under ``torchrun`` each process takes its slice of every global batch (the
augmentation drawn for the global batch), the gradient mean is one
all-reduce (``parallel/collectives.mean_gradients``), ``--syncBN`` gives
cross-replica BN and without it each process normalizes over its own
slice, the BN running buffers following rank 0. Rank 0 alone logs and
writes. The run is on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import time
from typing import Dict, List, Optional

import torch

from simclr_pytorch_distributed_tpu_torch import config as config_lib
from simclr_pytorch_distributed_tpu_torch.data.cifar import ensure_dataset_available, load_dataset
from simclr_pytorch_distributed_tpu_torch.data.pipeline import EpochLoader
from simclr_pytorch_distributed_tpu_torch.models import SupCEResNet
from simclr_pytorch_distributed_tpu_torch.ops.augment import AugmentConfig, augment_batch
from simclr_pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from simclr_pytorch_distributed_tpu_torch.ops.metrics import AverageMeter, topk_correct
from simclr_pytorch_distributed_tpu_torch.ops.schedules import make_lr_schedule
from simclr_pytorch_distributed_tpu_torch.parallel import collectives, mesh
from simclr_pytorch_distributed_tpu_torch.train.linear import (
    PROBE_METRIC_KEYS,
    global_step_metrics,
    stats_for,
    validate,
)
from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
from simclr_pytorch_distributed_tpu_torch.train.supcon import (
    build_store,
    compute_dtype,
    resolve_device,
    step_batches,
)
from simclr_pytorch_distributed_tpu_torch.utils import preempt, tracing
from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import (
    capture_state,
    resolve_resume_path,
    restore_checkpoint,
    resume_position,
    save_checkpoint,
)
from simclr_pytorch_distributed_tpu_torch.utils.guard import exit_code_for, exit_with_code
from simclr_pytorch_distributed_tpu_torch.utils.logging_utils import TBLogger, setup_logging
from simclr_pytorch_distributed_tpu_torch.utils.obs import RunObservability
from simclr_pytorch_distributed_tpu_torch.utils.profiling import StepClock, StepTracer
from simclr_pytorch_distributed_tpu_torch.utils.telemetry import TelemetrySession


def build_ce(cfg: config_lib.LinearConfig, steps_per_epoch: int,
             device: torch.device) -> TrainState:
    """The CE train state: ``SupCEResNet`` from ``cfg.seed`` (built on the
    CPU, rank 0's weights on every process) in the compute dtype of
    ``--bf16``, with ``--syncBN``, the reference's SGD and the schedule."""
    torch.manual_seed(cfg.seed)
    model = SupCEResNet(cfg.model, cfg.n_cls)
    model.encoder.set_compute_dtype(compute_dtype(cfg.bf16))
    model.encoder.set_bn_sync(torch.distributed.group.WORLD
                              if cfg.syncBN and mesh.is_distributed() else None)
    model = model.to(device=device, memory_format=torch.channels_last)
    collectives.broadcast_from_rank0(model)
    schedule = make_lr_schedule(
        learning_rate=cfg.learning_rate, epochs=cfg.epochs,
        steps_per_epoch=steps_per_epoch, cosine=cfg.cosine,
        lr_decay_rate=cfg.lr_decay_rate, lr_decay_epochs=cfg.lr_decay_epochs,
        warm=cfg.warm, warm_epochs=cfg.warm_epochs, warmup_from=cfg.warmup_from,
    )
    optimizer = make_optimizer(model, momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule)


def ce_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
    """One update on augmented ``images`` (JAX ``make_ce_steps``'s train
    step): cross-entropy of the fp32 logits, SGD at the schedule's rate, the
    gradient averaged over the processes. Returns this process's ``loss``
    and top-1/top-5 correct counts, 0-dim tensors on the device."""
    state.model.train()
    logits = state.model(images)
    loss = cross_entropy_loss(logits, labels)
    state.set_learning_rate()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    collectives.mean_gradients(state.model.parameters())
    state.optimizer.step()
    if mesh.is_distributed():  # BN buffers follow rank 0 (equal already under --syncBN)
        collectives.broadcast_from_rank0(state.model, parameters=False)
    state.step += 1
    correct = topk_correct(logits.detach(), labels)
    return {"loss": loss.detach(), "top1": correct[1], "top5": correct[5]}


def eval_logits(model: SupCEResNet, images: torch.Tensor) -> torch.Tensor:
    """Eval-mode fp32 logits of normalized NHWC ``images``; no graph."""
    model.eval()
    with torch.no_grad():
        return model(images).float()


@dataclasses.dataclass
class CEResult:
    """``best_acc``/``best_acc5`` are the JAX driver's return pair;
    ``history`` has one entry a step (``loss``, ``top1``/``top5`` in
    percent, ``step_time``), ``val_history`` one an epoch."""

    best_acc: float
    best_acc5: float
    state: TrainState
    history: List[Dict[str, float]]
    val_history: List[Dict[str, float]]
    save_folder: str


def train_epoch(
    epoch: int, loader: EpochLoader, state: TrainState, aug_cfg: AugmentConfig,
    generator: torch.Generator, cfg: config_lib.LinearConfig, device: torch.device,
    history: List[Dict[str, float]], telemetry: TelemetrySession,
    tracer: Optional[StepTracer] = None, start_step: int = 0, first_step_span: bool = False,
    store=None,
):
    """One CE epoch from its step ``start_step`` through the metric ring,
    its batches from ``store`` when there is one.
    Returns ``(train meters, stopped_at)``: the loss and top-1 averages, and
    the steps of the epoch taken when a preemption was requested before its
    last step (else ``None``)."""
    losses, top1 = AverageMeter(), AverageMeter()
    steps = len(loader)
    bsz = cfg.batch_size
    entries: Dict[int, dict] = {}
    clock = StepClock(device)
    telemetry.start_window_clock()
    ring_buf = telemetry.init_buffer(device)

    def submit(boundary_idx: int, step_hint: int) -> None:
        def consume(fetched):
            for (_, gstep), m in fetched:
                entry = {"epoch": epoch, "step": gstep, "loss": m["loss"],
                         "top1": 100.0 * m["top1"] / bsz, "top5": 100.0 * m["top5"] / bsz,
                         "step_time": math.nan}
                history.append(entry)
                entries[gstep] = entry
                losses.update(entry["loss"], bsz)
                top1.update(entry["top1"], bsz)
            logging.info("Train: [%d][%d/%d]\tloss %.3f (%.3f)\tAcc@1 %.3f (%.3f)",
                         epoch, boundary_idx + 1, steps, losses.val, losses.avg,
                         top1.val, top1.avg)

        telemetry.flush_boundary(ring_buf, consume, step_hint=step_hint)

    def finish(boundary_idx: int, step_hint: int) -> None:
        telemetry.finish_epoch(lambda hint: submit(boundary_idx, hint), step_hint)
        clock.fill(entries, (epoch - 1) * steps + start_step)

    batches = step_batches(loader, store, epoch, start_step, device)
    try:
        clock.mark()
        for idx, x, y in batches:
            gstep = state.step
            span = (tracing.span("first_step", track="main:compile", step=gstep)
                    if first_step_span and idx == start_step else contextlib.nullcontext())
            with span:
                y = y.long()
                images = augment_batch(generator, x, aug_cfg, process_index=mesh.rank(),
                                       process_count=mesh.world_size())
                m = global_step_metrics(ce_step(state, images, y))
            telemetry.ring.write(ring_buf, m, gstep)
            telemetry.append((idx, gstep), gstep)
            clock.mark()
            if tracer is not None:
                tracer.step(gstep)
            if (idx + 1) % cfg.print_freq == 0 or idx + 1 == steps:
                submit(idx, gstep)
                # voted at the flush boundary only (JAX train/ce.py:346-348)
                if idx + 1 < steps and preempt.requested_global():
                    finish(idx, gstep)
                    return {"loss": losses.avg, "top1": top1.avg}, idx + 1
        finish(steps - 1, epoch * steps - 1)
    finally:
        batches.close()
    return {"loss": losses.avg, "top1": top1.avg}, None


def run(cfg: config_lib.LinearConfig) -> CEResult:
    """The run, inside the process group when ``torchrun`` launched it (the
    group is left at the end if this call joined it)."""
    joined = mesh.setup_distributed(cfg.device)
    try:
        return _train(cfg)
    finally:
        if joined:
            mesh.teardown_distributed()


def _train(cfg: config_lib.LinearConfig) -> CEResult:
    device = resolve_device(cfg.device)
    cfg.save_folder = mesh.broadcast_from_main(cfg.save_folder)
    cfg.tb_folder = mesh.broadcast_from_main(cfg.tb_folder)
    main_process = mesh.is_main_process()
    setup_logging(cfg.save_folder, main_process)
    logging.info(
        "device: %s (%s), process %d of %d", device,
        torch.cuda.get_device_name(device) if device.type == "cuda" else "host CPU",
        mesh.rank(), mesh.world_size(),
    )
    obs = RunObservability(cfg, name="ce")
    telemetry = tb = tracer = None
    exit_exc = None
    preempt.install()
    store = None
    try:
        ensure_dataset_available(cfg.dataset, cfg.data_folder, cfg.download)
        train_data, test_data, cfg.n_cls = load_dataset(cfg.dataset, cfg.data_folder)
        loader = EpochLoader(
            train_data["images"], train_data["labels"], cfg.batch_size, base_seed=cfg.seed,
            process_index=mesh.rank(), process_count=mesh.world_size(),
        )
        store = build_store(cfg, loader, device)  # before the model, as in pretraining
        state = build_ce(cfg, len(loader), device)
        logging.info("[conv_impl] 'eager': the CE model runs cuDNN convs and "
                     "nn.BatchNorm2d, as the JAX CE trainer runs XLA convs%s",
                     ", compute dtype bf16" if cfg.bf16 else "")
        mean, std = stats_for(cfg.dataset)
        aug_cfg = AugmentConfig(size=cfg.size, mean=mean, std=std, color_ops=False)
        generator = torch.Generator(device=device)
        generator.manual_seed(cfg.seed + 1)
        start_epoch, start_step = 1, 0
        best_acc, best_acc5 = 0.0, 0.0
        if cfg.resume:
            resume_path = resolve_resume_path(cfg.resume)
            meta = restore_checkpoint(resume_path, state, generator)
            start_epoch, start_step = resume_position(meta, len(loader))
            best_acc = float(meta["run_meta"].get("best_acc", 0.0))
            best_acc5 = float(meta["run_meta"].get("best_acc5", 0.0))
            logging.info("resumed from %s at epoch %d step %d (best accuracy %.2f)",
                         resume_path, start_epoch, start_step, best_acc)
        telemetry = TelemetrySession(cfg.print_freq, PROBE_METRIC_KEYS, cfg.telemetry,
                                     watchdog=obs.watchdog, gauges=obs.gauges)
        tb = TBLogger(cfg.tb_folder, enabled=main_process)
        tracer = StepTracer(cfg.trace_dir, cfg.trace_start_step, cfg.trace_steps,
                            enabled=main_process)

        def save(name: str, epoch: int, step_in_epoch: int = 0) -> str:
            with tracing.span("checkpoint_commit", track="main:checkpoint", ckpt=name):
                return save_checkpoint(
                    os.path.join(cfg.save_folder, name), capture_state(state, generator), cfg,
                    epoch, step_in_epoch, run_meta={"best_acc": best_acc, "best_acc5": best_acc5})

        def exit_preempted(path: str, epoch: int, step_in_epoch: Optional[int] = None) -> None:
            tracing.event("preempt_exit", track="main:guard", epoch=epoch,
                          **({} if step_in_epoch is None else {"step_in_epoch": step_in_epoch}))
            mesh.sync_processes("preempted")
            logging.warning("preempted (%s): state saved at %s; exiting %d (resume with "
                            "--resume %s)", preempt.signal_name(), path,
                            preempt.EXIT_PREEMPTED, cfg.save_folder)
            raise SystemExit(preempt.EXIT_PREEMPTED)

        history: List[Dict[str, float]] = []
        val_history: List[Dict[str, float]] = []
        for epoch in range(start_epoch, cfg.epochs + 1):
            t1 = time.time()
            obs.set_epoch(epoch)
            ss = start_step if epoch == start_epoch else 0
            with tracing.span("epoch", track="main:epoch", epoch=epoch):
                train, stopped_at = train_epoch(
                    epoch, loader, state, aug_cfg, generator, cfg, device, history, telemetry,
                    tracer, start_step=ss, first_step_span=epoch == start_epoch, store=store,
                )
            if stopped_at is not None:
                exit_preempted(save(f"preempt_epoch_{epoch}_step_{stopped_at}.pth", epoch - 1,
                                    stopped_at), epoch, stopped_at)
            logging.info("Train epoch %d, total time %.2f, accuracy:%.2f",
                         epoch, time.time() - t1, train["top1"])
            t2 = time.time()
            with tracing.span("validation", track="main:eval", epoch=epoch):
                val = validate(lambda x: eval_logits(state.model, x), test_data["images"],
                               test_data["labels"], cfg.val_batch_size, aug_cfg, device)
            val["seconds"] = time.time() - t2
            val_history.append(val)
            logging.info(" * Acc@1 %.3f, Acc@5 %.3f", val["top1"], val["top5"])
            if main_process:
                tb.log_value("ce/train_loss", train["loss"], epoch)
                tb.log_value("ce/train_acc1", train["top1"], epoch)
                tb.log_value("ce/val_loss", val["loss"], epoch)
                tb.log_value("ce/val_acc1", val["top1"], epoch)
                tb.log_value("ce/val_acc5", val["top5"], epoch)
            if val["top1"] > best_acc:
                best_acc, best_acc5 = val["top1"], val["top5"]
            path = None
            if epoch % cfg.save_freq == 0:
                path = save(f"ckpt_epoch_{epoch}.pth", epoch)
            if preempt.requested_global():
                exit_preempted(path or save(f"preempt_epoch_{epoch}.pth", epoch), epoch)
        save("last.pth", cfg.epochs)
        logging.info("best accuracy: %.2f, accuracy5: %.2f", best_acc, best_acc5)
        mesh.sync_processes("end of CE run")
    except BaseException as e:
        exit_exc = e
        raise
    finally:
        preempt.uninstall()
        if telemetry is not None:
            telemetry.close()
        if store is not None:
            store.close()
        if tracer is not None:
            tracer.close()
        if tb is not None:
            tb.close()
        obs.close(exit_code=exit_code_for(exit_exc))
    return CEResult(best_acc=best_acc, best_acc5=best_acc5, state=state, history=history,
                    val_history=val_history, save_folder=cfg.save_folder)


def main(argv=None) -> CEResult:
    """Exit codes: 0 a clean run, 2 a telemetry flush failure, 75 preempted
    with the state saved."""
    cfg = config_lib.parse_linear(argv, ce=True)
    return exit_with_code(lambda: run(cfg))


if __name__ == "__main__":
    main()
