"""Linear-probe driver (reference ``main_linear.py``), on one device or data
parallel over several.

    python -m simclr_pytorch_distributed_tpu_torch.train.linear \\
        --dataset synthetic --model resnet50 --ckpt <pretrain run>/last.pth

    torchrun --nproc_per_node P -m simclr_pytorch_distributed_tpu_torch.train.linear \\
        --dataset synthetic --model resnet50 --ckpt <pretrain run>/last.pth

The JAX package's ``train/linear.py`` (``stats_for :95``, ``build_probe
:101``, the train step ``:197``, the eval step ``:219``, ``run_validation
:242``, ``run :273``, ``main :533``), eagerly:

- the pretrained encoder is frozen and in eval mode: BN normalizes with its
  running statistics and nothing in it updates (``model.eval()``, its
  parameters ``requires_grad_(False)``, features under ``torch.no_grad()``,
  cast to fp32). The eval-mode encoder never reaches the fused conv kernels
  (they serve train mode only), as the JAX model's Pallas branches are
  gated on ``train``;
- the train transform is the crop and flip alone, one view an image, the
  validation transform normalize only (``main_ce.py:31-41``);
- SGD on the classifier alone, with the per-iteration schedule (step decay
  60/75/90 x 0.2 by default), cross-entropy; each step's loss and top-1/top-5
  counts go into the device-side metric ring (:data:`PROBE_METRIC_KEYS`),
  flushed once per ``--print_freq`` window (``utils/telemetry.py``), with
  the observability stack of the pretrain driver (``utils/obs.py``;
  ``classifier/*`` TensorBoard scalars, spans ``first_step``, ``epoch``,
  ``validation``);
- validation over the whole test split every epoch, the tail batch as it
  is; the best top-1 and its top-5 are kept, the best classifier is saved
  as ``classifier_best.pth`` and ``best accuracy: X, accuracy5: Y`` is
  logged at the end (the line ``scripts/ratchet.py`` reads).

Under ``torchrun`` (JAX ``train/linear.py:15-16, :242-300``) each process
joins the process group (``parallel/mesh.py``), takes its slice of every
global batch with the augmentation drawn for the global batch (so P
processes see the one-process crops), and averages the classifier's
gradient with one all-reduce (``collectives.mean_gradients``); the
encoder is frozen and the loss a per-example mean, so the update is the
one-process update. Validation splits every chunk of ``--val_batch_size``
rows between the processes, the tail chunk padded to full size and its pad
rows left out of the counts, and sums the counts in rank order. Each
step's loss and counts are the global batch's. Rank 0 alone logs and
writes; a signal on any process stops all of them at the next flush
boundary (``preempt.requested_global``, voted there only).

The training batches follow ``--data_placement`` as in the pretrain
driver (``train/supcon.build_store``; JAX ``train/linear.py:298-315``); the
validation pass reads the host arrays.

The probe keeps no full-state checkpoints: ``--resume`` is accepted and
retrains from scratch. SIGTERM/SIGINT stop it after the step in flight; it
saves the best classifier so far and exits 75. The run is on ``cuda``
unless ``--device cpu`` is given, and raises when CUDA is asked for and
absent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from simclr_pytorch_distributed_tpu_torch import config as config_lib
from simclr_pytorch_distributed_tpu_torch.data.cifar import ensure_dataset_available, load_dataset
from simclr_pytorch_distributed_tpu_torch.data.pipeline import EpochLoader
from simclr_pytorch_distributed_tpu_torch.models import LinearClassifier, SupConResNet
from simclr_pytorch_distributed_tpu_torch.ops.augment import (
    DATASET_STATS,
    AugmentConfig,
    augment_batch,
    eval_batch,
)
from simclr_pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from simclr_pytorch_distributed_tpu_torch.ops.metrics import AverageMeter, topk_correct
from simclr_pytorch_distributed_tpu_torch.ops.schedules import make_lr_schedule
from simclr_pytorch_distributed_tpu_torch.parallel import collectives, mesh
from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
from simclr_pytorch_distributed_tpu_torch.train.supcon import (
    build_store,
    compute_dtype,
    resolve_device,
    step_batches,
)
from simclr_pytorch_distributed_tpu_torch.utils import preempt, tracing
from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import (
    load_model_state,
    save_classifier,
)
from simclr_pytorch_distributed_tpu_torch.utils.guard import exit_code_for, exit_with_code
from simclr_pytorch_distributed_tpu_torch.utils.logging_utils import TBLogger, setup_logging
from simclr_pytorch_distributed_tpu_torch.utils.obs import RunObservability
from simclr_pytorch_distributed_tpu_torch.utils.profiling import StepClock, StepTracer
from simclr_pytorch_distributed_tpu_torch.utils.telemetry import TelemetrySession

# the metric ring's columns for the probe and CE steps: the global batch's
# loss and its top-1/top-5 correct counts (JAX train/linear.py:86)
PROBE_METRIC_KEYS = ("loss", "top1", "top5")


def stats_for(dataset: str) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    if dataset in DATASET_STATS:
        return DATASET_STATS[dataset]
    return ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))  # the synthetic sets


def load_encoder(model: SupConResNet, state_dict: Dict[str, torch.Tensor]) -> None:
    """The ``encoder.`` entries of a ``SupConResNet`` state dict into
    ``model.encoder`` (strict); the projection head is not the probe's."""
    prefix = "encoder."
    model.encoder.load_state_dict(
        {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    )


def build_probe(
    cfg: config_lib.LinearConfig, steps_per_epoch: int, device: torch.device
) -> Tuple[SupConResNet, TrainState]:
    """``(model, state)``: the frozen eval-mode encoder (from ``--ckpt``,
    else a random init from ``cfg.seed``) in the compute dtype of
    ``--bf16`` on ``device``, and the classifier's train state (its SGD
    and the per-iteration schedule)."""
    torch.manual_seed(cfg.seed)
    model = SupConResNet(cfg.model)
    if cfg.ckpt:
        load_encoder(model, load_model_state(cfg.ckpt))
        logging.info("loaded encoder from %s", cfg.ckpt)
    else:
        logging.warning("--ckpt not given: probing a RANDOM encoder")
    model.encoder.set_compute_dtype(compute_dtype(cfg.bf16))
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    model.requires_grad_(False)
    classifier = LinearClassifier(cfg.model, cfg.n_cls).to(device)
    schedule = make_lr_schedule(
        learning_rate=cfg.learning_rate, epochs=cfg.epochs,
        steps_per_epoch=steps_per_epoch, cosine=cfg.cosine,
        lr_decay_rate=cfg.lr_decay_rate, lr_decay_epochs=cfg.lr_decay_epochs,
        warm=cfg.warm, warm_epochs=cfg.warm_epochs, warmup_from=cfg.warmup_from,
    )
    optimizer = make_optimizer(classifier, momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    return model, TrainState(model=classifier, optimizer=optimizer, schedule=schedule)


def encode(model: SupConResNet, images: torch.Tensor) -> torch.Tensor:
    """Frozen fp32 features of normalized NHWC ``images``; no graph."""
    with torch.no_grad():
        return model.encode(images).float()


def probe_step(
    model: SupConResNet, state: TrainState, images: torch.Tensor, labels: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """One classifier update on augmented ``images`` (JAX
    ``train/linear.py:197``), this process's slice of the global batch
    under a process group, with the gradient averaged over the processes.
    Returns this process's ``loss`` and top-1/top-5 correct counts as
    0-dim tensors on the device; nothing here waits for it but the
    gradient mean."""
    logits = state.model(encode(model, images))
    loss = cross_entropy_loss(logits, labels)
    state.set_learning_rate()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    collectives.mean_gradients(state.model.parameters())
    state.optimizer.step()
    state.step += 1
    correct = topk_correct(logits.detach(), labels)
    return {"loss": loss.detach(), "top1": correct[1], "top5": correct[5]}


def run_validation(
    model: SupConResNet, classifier: torch.nn.Module, images: np.ndarray, labels: np.ndarray,
    batch_size: int, aug_cfg: AugmentConfig, device: torch.device,
) -> Dict[str, float]:
    """The probe's validation: :func:`validate` of the classifier on the
    frozen encoder's features."""
    return validate(lambda x: classifier(encode(model, x)), images, labels, batch_size,
                    aug_cfg, device)


def validate(
    logits_fn, images: np.ndarray, labels: np.ndarray, batch_size: int,
    aug_cfg: AugmentConfig, device: torch.device,
) -> Dict[str, float]:
    """Loss, top-1 and top-5 (percent) of ``logits_fn`` (normalized NHWC
    images -> fp32 logits) over the whole split (reference ``validate()``,
    ``main_linear.py:204-244``): every example counts once.
    Alone, a process takes each chunk of ``batch_size`` rows, the tail as it
    is. Under a process group (JAX ``train/linear.py:242-270``) it takes its
    slice of each chunk, the tail padded to ``batch_size`` with its first
    row and the pad rows left out of the counts, and the sums are added in
    rank order. The sums stay on the device until one readback."""
    p, r = mesh.world_size(), mesh.rank()
    if batch_size % p:
        raise ValueError(f"--val_batch_size {batch_size} not divisible by {p} processes")
    part = batch_size // p
    sums = torch.zeros(3, dtype=torch.float64, device=device)
    with torch.no_grad():
        for lo in range(0, len(images), batch_size):
            x, y = images[lo:lo + batch_size], labels[lo:lo + batch_size]
            valid = len(y)
            if p > 1:
                pad = batch_size - valid
                if pad:
                    x = np.concatenate([x, np.repeat(x[:1], pad, axis=0)])
                    y = np.concatenate([y, np.repeat(y[:1], pad)])
                x, y = x[r * part:(r + 1) * part], y[r * part:(r + 1) * part]
                valid = min(max(valid - r * part, 0), part)
            x = torch.from_numpy(x).to(device, non_blocking=True)
            y = torch.from_numpy(y).to(device, non_blocking=True).long()
            logits = logits_fn(eval_batch(x, aug_cfg))[:valid]
            y = y[:valid]
            correct = topk_correct(logits, y)
            sums += torch.stack([F.cross_entropy(logits, y, reduction="sum").double(),
                                 correct[1].double(), correct[5].double()])
    loss_sum, top1, top5 = collectives.rank_ordered_sum(sums).tolist()
    n = len(images)
    return {"loss": loss_sum / n, "top1": 100.0 * top1 / n, "top5": 100.0 * top5 / n}


def global_step_metrics(m: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A step's :data:`PROBE_METRIC_KEYS` for the global batch, on the
    device: the loss as the mean of the processes' equal slices and the
    correct counts summed, in rank order; no readback."""
    world = mesh.world_size()
    total = collectives.rank_ordered_sum(
        torch.stack([m["loss"] / world, m["top1"].float(), m["top5"].float()]))
    return dict(zip(PROBE_METRIC_KEYS, total.unbind()))


@dataclasses.dataclass
class ProbeResult:
    """``best_acc``/``best_acc5`` are the JAX driver's return pair.
    ``history`` has one entry a step (``loss``, ``top1``/``top5`` in
    percent, ``step_time`` from CUDA events, the host clock on the CPU),
    ``val_history`` one an epoch (``loss``, ``top1``, ``top5``,
    ``seconds``)."""

    best_acc: float
    best_acc5: float
    model: SupConResNet
    state: TrainState
    history: List[Dict[str, float]]
    val_history: List[Dict[str, float]]
    save_folder: str
    classifier_path: Optional[str]


def train_epoch(
    epoch: int, loader: EpochLoader, model: SupConResNet, state: TrainState,
    aug_cfg: AugmentConfig, generator: torch.Generator, cfg: config_lib.LinearConfig,
    device: torch.device, history: List[Dict[str, float]], telemetry: TelemetrySession,
    tracer: Optional[StepTracer] = None, first_step_span: bool = False, store=None,
) -> Tuple[Dict[str, float], bool]:
    """One probe epoch through the metric ring, its batches from ``store``
    when there is one. Returns ``(train meters, preempted)``: the loss,
    top-1 and top-5 averages, and whether a signal arrived (the epoch then
    stops after the step in flight)."""
    bt, losses, top1, top5 = AverageMeter(), AverageMeter(), AverageMeter(), AverageMeter()
    steps = len(loader)
    bsz = cfg.batch_size
    entries: Dict[int, dict] = {}
    clock = StepClock(device)
    telemetry.start_window_clock()
    ring_buf = telemetry.init_buffer(device)

    def submit(boundary_idx: int, step_hint: int) -> None:
        def consume(fetched, bt_now):
            for (_, gstep), m in fetched:
                entry = {"epoch": epoch, "step": gstep, "loss": m["loss"],
                         "top1": 100.0 * m["top1"] / bsz, "top5": 100.0 * m["top5"] / bsz,
                         "step_time": math.nan}
                history.append(entry)
                entries[gstep] = entry
                losses.update(entry["loss"], bsz)
                top1.update(entry["top1"], bsz)
                top5.update(entry["top5"], bsz)
            logging.info(
                "Train: [%d][%d/%d]\tBT %.3f (%.3f)\tloss %.3f (%.3f)\tAcc@1 %.3f (%.3f)",
                epoch, boundary_idx + 1, steps, bt_now[0], bt_now[1],
                losses.val, losses.avg, top1.val, top1.avg,
            )

        telemetry.flush_boundary(ring_buf, consume, batch_meter=bt, step_hint=step_hint)

    preempted = False
    batches = step_batches(loader, store, epoch, 0, device)
    try:
        clock.mark()
        for idx, x, y in batches:
            gstep = state.step
            span = (tracing.span("first_step", track="main:compile", step=gstep)
                    if first_step_span and idx == 0 else contextlib.nullcontext())
            with span:
                y = y.long()
                views = augment_batch(generator, x, aug_cfg, process_index=mesh.rank(),
                                      process_count=mesh.world_size())
                m = global_step_metrics(probe_step(model, state, views, y))
            telemetry.ring.write(ring_buf, m, gstep)
            telemetry.append((idx, gstep), gstep)
            clock.mark()
            if tracer is not None:
                tracer.step(gstep)
            if (idx + 1) % cfg.print_freq == 0 or idx + 1 == steps:
                submit(idx, gstep)
                # voted at the flush boundary only (JAX train/linear.py:452-454)
                if preempt.requested_global():
                    preempted = True
                    break
    finally:
        batches.close()
    telemetry.finish_epoch(lambda hint: submit(steps - 1, hint), state.step - 1)
    clock.fill(entries, (epoch - 1) * steps)
    return {"loss": losses.avg, "top1": top1.avg, "top5": top5.avg}, preempted


def run(cfg: config_lib.LinearConfig) -> ProbeResult:
    """The probe, inside the process group when ``torchrun`` launched it
    (the group is left at the end if this call joined it)."""
    joined = mesh.setup_distributed(cfg.device)
    try:
        return _probe(cfg)
    finally:
        if joined:
            mesh.teardown_distributed()


def _probe(cfg: config_lib.LinearConfig) -> ProbeResult:
    device = resolve_device(cfg.device)
    # the minute-stamped folders: every process adopts rank 0's
    cfg.save_folder = mesh.broadcast_from_main(cfg.save_folder)
    cfg.tb_folder = mesh.broadcast_from_main(cfg.tb_folder)
    main_process = mesh.is_main_process()
    setup_logging(cfg.save_folder, main_process)
    logging.info(
        "device: %s (%s), process %d of %d", device,
        torch.cuda.get_device_name(device) if device.type == "cuda" else "host CPU",
        mesh.rank(), mesh.world_size(),
    )
    obs = RunObservability(cfg, name="linear")
    telemetry = tb = tracer = None
    exit_exc = None
    preempted = False
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
        model, state = build_probe(cfg, len(loader), device)
        collectives.broadcast_from_rank0(state.model)
        mean, std = stats_for(cfg.dataset)
        aug_cfg = AugmentConfig(size=cfg.size, mean=mean, std=std, color_ops=False)
        generator = torch.Generator(device=device)
        generator.manual_seed(cfg.seed + 1)
        if cfg.resume:
            logging.warning("--resume %s: the probe keeps no full-state checkpoints; "
                            "retraining from scratch", cfg.resume)
        telemetry = TelemetrySession(cfg.print_freq, PROBE_METRIC_KEYS, cfg.telemetry,
                                     watchdog=obs.watchdog, gauges=obs.gauges)
        tb = TBLogger(cfg.tb_folder, enabled=main_process)
        tracer = StepTracer(cfg.trace_dir, cfg.trace_start_step, cfg.trace_steps,
                            enabled=main_process)
        best_acc, best_acc5, best_state = 0.0, 0.0, None
        history: List[Dict[str, float]] = []
        val_history: List[Dict[str, float]] = []
        for epoch in range(1, cfg.epochs + 1):
            t1 = time.time()
            obs.set_epoch(epoch)
            with tracing.span("epoch", track="main:epoch", epoch=epoch):
                train, preempted = train_epoch(
                    epoch, loader, model, state, aug_cfg, generator, cfg, device, history,
                    telemetry, tracer, first_step_span=epoch == 1, store=store,
                )
            if preempted:
                tracing.event("preempt_exit", track="main:guard", epoch=epoch)
                logging.warning("preempted (%s) during epoch %d: stopping the probe",
                                preempt.signal_name(), epoch)
                break
            logging.info("Train epoch %d, total time %.2f, accuracy:%.2f",
                         epoch, time.time() - t1, train["top1"])
            if main_process:
                tb.log_value("classifier/train_loss", train["loss"], epoch)
                tb.log_value("classifier/train_acc1", train["top1"], epoch)
                tb.log_value("classifier/train_acc5", train["top5"], epoch)
            t2 = time.time()
            with tracing.span("validation", track="main:eval", epoch=epoch):
                val = run_validation(model, state.model, test_data["images"],
                                     test_data["labels"], cfg.val_batch_size, aug_cfg, device)
            val["seconds"] = time.time() - t2
            val_history.append(val)
            logging.info(" * Acc@1 %.3f, Acc@5 %.3f", val["top1"], val["top5"])
            if main_process:
                tb.log_value("classifier/val_loss", val["loss"], epoch)
                tb.log_value("classifier/val_acc1", val["top1"], epoch)
                tb.log_value("classifier/val_acc5", val["top5"], epoch)
            if val["top1"] > best_acc:
                best_acc, best_acc5 = val["top1"], val["top5"]
                best_state = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
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
        # the preemption exit is raised after this block: the exit code
        # reads the flag
        obs.close(exit_code=(preempt.EXIT_PREEMPTED if preempted
                             else exit_code_for(exit_exc)))
    path = None
    if best_state is not None and main_process:
        path = save_classifier(cfg.save_folder, best_state, best_acc)
        logging.info("saved best classifier to %s", path)
    logging.info("best accuracy: %.2f, accuracy5: %.2f", best_acc, best_acc5)
    # every process leaves together; none before rank 0's write
    mesh.sync_processes("end of probe")
    if preempted:
        raise SystemExit(preempt.EXIT_PREEMPTED)
    return ProbeResult(best_acc=best_acc, best_acc5=best_acc5, model=model, state=state,
                       history=history, val_history=val_history,
                       save_folder=cfg.save_folder, classifier_path=path)


def main(argv=None) -> ProbeResult:
    """Exit codes: 0 a clean run, 2 a telemetry flush failure, 75
    preempted (the best classifier so far saved)."""
    cfg = config_lib.parse_linear(argv)
    return exit_with_code(lambda: run(cfg))


if __name__ == "__main__":
    main()
