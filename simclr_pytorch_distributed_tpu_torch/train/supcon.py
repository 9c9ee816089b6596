"""Contrastive pretraining driver (reference ``main_supcon.py``), on one
device or data parallel over several.

    python -m simclr_pytorch_distributed_tpu_torch.train.supcon \\
        --dataset synthetic --model resnet50 --batch_size 256 --epochs 1 \\
        --method SimCLR --temp 0.5 --learning_rate 0.5 --cosine

    torchrun --nproc_per_node P -m simclr_pytorch_distributed_tpu_torch.train.supcon \\
        --dataset synthetic --model resnet50 --batch_size 256 --epochs 1 \\
        --method SimCLR --temp 0.5 --learning_rate 0.5 --cosine --syncBN

Under ``torchrun`` (``WORLD_SIZE`` set) each process joins the process group
(``parallel/mesh.py``: NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device
cpu``), takes its slice of every global batch of ``--batch_size``, and runs
the data-parallel step (``train/supcon_step.py``): the feature gather, the
loss over the global batch (the fused loss in its sharded form), the
gradient mean, and with ``--syncBN`` cross-replica BN; with ``--loss_impl
ring`` no feature gather, the contrast blocks travelling around a ring of
the processes instead. Every process starts
from rank 0's weights; rank 0 alone logs and writes checkpoints into its
run folder, which every process adopts. The fused conv kernels stay
single-process (:func:`resolve_conv_impl`).

``--model_parallel N`` (JAX ``train/supcon.py:135, 278, 695``): the
processes form a grid of ``D = W // N`` data slices by ``N`` model shards
(``parallel/mesh.setup_grid``, named in the ``mesh: {...}`` banner). The
loader and the view draws slice the global batch by data index over ``D``
(the ranks of a model group see the same rows); the model is sharded after
rank 0's weights reach every process (``mesh.shard_module``); the loss and
conv ladders, ``--ngpu auto`` and ``--syncBN``'s group read ``D``; the
boundary exchange, the preemption vote and the failure-code exchange stay
world-wide. Saves hold whole tensors (``utils/checkpoint.py``).

Loop: the step's uint8 batch -> two-crop augmentation on the device -> the train step (forward, loss, backward,
SGD) -> the step's metrics written into a row of the device-side metric
ring, with no readback -> at each ``--print_freq`` boundary one snapshot of
the ring handed to the telemetry flush (``utils/telemetry.py``: one
transfer per window, then on a background thread under ``--telemetry
async`` the finite check, the meters, the TensorBoard ``info/*``,
``health/*`` and ``probe/*`` scalars, the health monitor and the progress
line) -> checkpoints at ``--save_freq`` and as ``last.pth``. The host
waits for the device only at flush boundaries, at epoch ends and in a
process group's collectives (under a process group also in the preemption
vote, taken at flush boundaries only). The run is on ``cuda`` unless ``--device cpu`` is given,
and raises when CUDA is asked for and absent.

Where the batch comes from is ``--data_placement`` (``data/device_store.py``,
JAX ``train/supcon.py:717-735``), resolved before the model is built, so
the budget reads the device's memory as the JAX package does: ``device``
(a view of an epoch buffer gathered on the device, one index upload an
epoch), ``window`` (a view of a window of batches, one upload a window,
the next window staged on a thread) or ``host`` (the loader's batch,
prefetched on a thread, copied each step through pinned memory);
``auto`` walks device -> window -> host against the budget. The batches
are the same bytes in every placement, so a run's history is too.
``DT`` (data time) is the wait for the batch: under a store the window
swap's blocking time. ``--dataset path`` reads an image tree
(``data/folder.py``) normalized by ``--mean``/``--std``; CIFAR is fetched
when absent unless ``--no_download``.

Observability (JAX ``train/supcon.py:720-930``, ``utils/obs.py``): the
flight recorder writes ``events.jsonl`` and, at the end, ``trace.json``
into the run folder (spans ``first_step``, ``epoch``, ``flush_boundary``,
``checkpoint_commit``; events ``preempt_exit``, ``nan_rollback``,
``health_window``, ``run_recipe``, ``run_exit``), ``--watchdog_secs`` arms the stall
watchdog, ``--metrics_port`` serves the Prometheus sidecar,
``--trace_dir`` takes a ``torch.profiler`` window, and ``--health_freq``
(default 10) feeds the health monitor (``--health_policy abort`` exits 3),
whose collapse bars are the recipe's (``utils/guard.thresholds_for_recipe``).
``history`` holds one entry a step, filled at each flush, with
``step_time`` from CUDA events read at the epoch's end (the host clock on
the CPU).

``--recipe`` (``recipes/``, JAX ``train/supcon.py:748-815``): the recipe and
its slots are attached to the state after it is built and before any
restore (``recipes.attach_for_config``); its metric columns join the ring
and log as ``recipe/<key>`` in TensorBoard; BYOL and the MoCo queue run a
second, gradient-free forward of the encoder through their EMA network
each step, so the fused conv kernels launch their forwards twice a step
there, and only the contrastive recipes without a queue run the loss
kernels.

Warm start, resume and exits (JAX ``train/supcon.py:770-798, 905-1010``):

- ``--ckpt``: the model's weights and BN buffers from a ``.pth``; SGD,
  step and generator start fresh.
- ``--resume``: the full training state (``utils/checkpoint.py``); the
  run re-enters the epoch at the first step not taken, and goes on as the
  run that did not stop would have, bit for bit.
- ``--nan_guard`` (on by default): a non-finite loss saves
  ``crash_epoch_{e}.pth`` from a copy of the epoch-top state held on the
  device, then ``--nan_policy`` decides: ``abort`` exits 1; ``rollback``
  (JAX ``train/supcon.py:821-956``) restores every process from its own
  epoch-top copy, skips the epoch (the step goes to ``e *
  steps_per_epoch``), multiplies the schedule by 0.5 and goes on, at most
  three times, then exits 1. The damping and the count ride every
  checkpoint. After a rollback the augmentation generator is in the state
  it would have at the epoch's end had no loss gone non-finite: the backup's
  state advanced past the skipped steps' draws (:func:`roll_back`), the
  counterpart of the JAX package's per-step keys. As in the JAX driver,
  a skipped epoch goes straight to the next: it writes no scheduled
  ``ckpt_epoch_{e}.pth``, and a signal that came during its failing step
  is acted on after the next epoch's first step.
- ``--optimizer lars``: LARS as ``optax.lars`` (``train/state.py``).
- Elastic resume: ``--resume`` under another world size continues at the
  same global step and warns that per-process BN and a non-``auto``
  ``--ngpu`` depend on the world size (``utils/checkpoint.py``).
- SIGTERM/SIGINT: the run goes on to the next ``--print_freq`` flush
  boundary (JAX ``train/supcon.py:633``), the state is saved as
  ``preempt_epoch_{e}_step_{k}.pth`` (or at an epoch boundary as
  ``preempt_epoch_{e}.pth``, unless the scheduled save covers it) and the
  run exits 75 (``utils/preempt.py``).
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
from torch.profiler import record_function

from simclr_pytorch_distributed_tpu_torch import config as config_lib
from simclr_pytorch_distributed_tpu_torch.data import device_store
from simclr_pytorch_distributed_tpu_torch.data.device_store import to_device
from simclr_pytorch_distributed_tpu_torch.data.cifar import ensure_dataset_available, load_dataset
from simclr_pytorch_distributed_tpu_torch.data.pipeline import EpochLoader
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
from simclr_pytorch_distributed_tpu_torch.models.resnet import fused_site_plan
from simclr_pytorch_distributed_tpu_torch.ops.augment import (
    DATASET_STATS,
    AugmentConfig,
    skip_view_draws,
    two_crop_batch,
)
from simclr_pytorch_distributed_tpu_torch.ops.metrics import AverageMeter
from simclr_pytorch_distributed_tpu_torch.ops.schedules import make_lr_schedule
from simclr_pytorch_distributed_tpu_torch.parallel import collectives, mesh
from simclr_pytorch_distributed_tpu_torch.recipes import ALL_RECIPE_METRIC_KEYS, attach_for_config
from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
    HEALTH_METRIC_KEYS,
    ONLINE_PROBE_METRIC_KEYS,
    SupConStepConfig,
    build_online_probe,
    host_metrics,
    ring_layout,
    train_step,
)
from simclr_pytorch_distributed_tpu_torch.utils import preempt, tracing
from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import (
    capture_state,
    load_model_state,
    restore_checkpoint,
    restore_snapshot,
    resolve_resume_path,
    resume_position,
    save_checkpoint,
)
from simclr_pytorch_distributed_tpu_torch.utils.guard import (
    MAX_ROLLBACKS,
    FailurePolicy,
    NonFiniteLossError,
    check_finite_loss,
    exit_code_for,
    exit_with_code,
)
from simclr_pytorch_distributed_tpu_torch.utils.logging_utils import TBLogger, setup_logging
from simclr_pytorch_distributed_tpu_torch.utils.obs import RunObservability
from simclr_pytorch_distributed_tpu_torch.utils.profiling import StepClock, StepTracer
from simclr_pytorch_distributed_tpu_torch.utils.telemetry import TelemetrySession


NAN_POLICY_REASONS = {
    "abort": "a non-finite loss saves crash_epoch_N.pth and exits 1",
    "rollback": ("a non-finite loss saves crash_epoch_N.pth, restores every process from "
                 "its epoch-top backup, skips the epoch and halves the learning rate, at "
                 f"most {MAX_ROLLBACKS} times, then exits 1"),
}
OPTIMIZER_REASONS = {
    "sgd": "the reference's SGD with momentum, weight decay on every parameter",
    "lars": ("LARS as optax.lars (train/state.py): weight decay and the 0.001 trust "
             "ratio on kernels only, momentum after the learning rate"),
}


# the reference's per-iteration scalars (main_supcon.py:327-333), as info/*
TB_ITER_SCALARS = ("norm_mean", "norm_var", "record_norm_mean", "loss_sec", "loss_l2reg")
# the health, probe and recipe columns' TensorBoard tags (JAX
# train/supcon.py:451-460): recipe/<key> for every recipe's keys, which
# runs without them never match
EXTRA_TB_TAGS = {
    **{k: "health/" + k[len("health_"):] for k in HEALTH_METRIC_KEYS},
    **{k: "probe/" + k[len("probe_"):] for k in ONLINE_PROBE_METRIC_KEYS},
    **{k: "recipe/" + k for k in ALL_RECIPE_METRIC_KEYS},
}


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


def resolve_loss_impl_reasoned(loss_impl: str, device: torch.device,
                               data_parallel: Optional[int] = None,
                               moco_queue: int = 0) -> tuple:
    """``(resolved_impl, reason)``: 'auto' is the fused kernels on CUDA and
    the dense form on the CPU, never the ring, and the dense form under the
    MoCo queue (JAX ``train/supcon.py:123-127``). With a process group of
    ``data_parallel`` processes the fused loss runs in its sharded form,
    and the reason says so."""
    if moco_queue and loss_impl == "auto":
        return "dense", (f"--moco_queue {moco_queue} extends the contrast side past the "
                         "fixed 2B geometry the fused/ring kernels tile")
    if loss_impl == "ring":
        procs = data_parallel or 1
        return "ring", (
            f"explicit request: anchors stay with their process and the contrast blocks "
            f"rotate around a ring of {procs} process(es) over point-to-point sends, with "
            "no feature gather (parallel/collectives.ring_supcon_loss; plain matrix "
            "products, as in the JAX package)")
    if loss_impl != "auto":
        resolved, reason = loss_impl, "explicit request"
        if loss_impl == "fused" and device.type == "cpu":
            reason += " (on cpu the kernels' plain PyTorch forms run)"
    elif device.type == "cuda":
        resolved = "fused"
        reason = "CUDA device: hand-written sm_90a kernels (ops/fused_loss.py)"
    else:
        resolved = "dense"
        reason = (f"{device.type} device: the fused kernels run on CUDA only, so the "
                  "dense PyTorch loss")
    if resolved == "fused" and data_parallel is not None:
        reason += (f"; sharded over {data_parallel} process(es): this process's anchor "
                   "rows against the all-gathered columns "
                   "(ops/fused_loss.fused_sharded_supcon_loss)")
    return resolved, reason


def conv_fused_sites(model: str, rows: int, size: int,
                     dtype: torch.dtype = torch.float32) -> List[str]:
    """Descriptions of the sites ``--conv_impl fused`` runs through the
    fused kernels at this geometry and compute dtype
    (``models/resnet.fused_site_plan``)."""
    return [site["desc"] for site in fused_site_plan(model, rows, size, dtype)
            if site["admitted"]]


def compute_dtype(bf16: bool) -> torch.dtype:
    """The model's compute dtype under ``--bf16``."""
    return torch.bfloat16 if bf16 else torch.float32


def resolve_conv_impl(
    conv_impl: str, model: str, batch_size: int, size: int, device: torch.device,
    bf16: bool = False, world_size: int = 1,
) -> tuple:
    """``(resolved_impl, reason)`` for ``--conv_impl``, the JAX package's
    ladder (``train/supcon.py:197-268``) on the port's devices.

    'auto' is the fused conv+BN kernels on CUDA (the reason lists the
    admitted sites; with none it degrades to eager and says so) and eager
    on the CPU. Explicit 'fused' is honoured on any device (on the CPU the
    kernels' plain PyTorch forms run) and raises where it could only be a
    silent no-op: a geometry with no admitted site. Sites the per-site
    gates reject stay eager; the banner lists the ones that fuse. Under
    ``bf16`` the reason names the compute dtype, as the JAX banner does
    (``compute dtype bf16``).

    Over a process group of ``world_size`` > 1 the kernels, which compute
    whole-batch BN statistics in one program, do not run: explicit 'fused'
    raises and 'auto' resolves to eager, saying why (JAX
    ``train/supcon.py:224-231, 254-258``).
    """
    tag = ", compute dtype bf16" if bf16 else ""
    if conv_impl == "eager":
        return "eager", f"explicit request: cuDNN convs and nn.BatchNorm2d{tag}"
    if conv_impl not in ("fused", "auto"):
        raise ValueError(f"conv_impl must be 'eager', 'fused' or 'auto', got {conv_impl!r}")
    single = ("the fused conv kernels compute whole-batch BN statistics inside one "
              "process (per-process BN groups and cross-replica BN run eager)")
    if world_size > 1:
        if conv_impl == "fused":
            raise ValueError(f"--conv_impl fused needs a single process, got a world of "
                             f"{world_size}: {single}; use auto or eager")
        return "eager", f"data parallel over {world_size} processes: {single}{tag}"
    rows = 2 * batch_size
    sites = conv_fused_sites(model, rows, size, compute_dtype(bf16))
    if conv_impl == "fused":
        if not sites:
            raise ValueError(
                f"--conv_impl fused admits no site for {model} at [{rows},{size},{size}] "
                "(ops/fused_conv.supports_*); use auto or eager"
            )
        where = (
            "on cpu the kernels' plain PyTorch forms run"
            if device.type == "cpu" else "hand-written sm_90a kernels"
        )
        return "fused", f"explicit request ({where}){tag}; fused sites: {', '.join(sites)}"
    if device.type != "cuda":
        return "eager", (
            f"{device.type} device: the fused conv kernels run on CUDA only, so "
            f"eager convs{tag}"
        )
    if not sites:
        return "eager", (
            f"no admitted geometry for {model} at [{rows},{size},{size}] "
            f"(ops/fused_conv.supports_*){tag}"
        )
    return "fused", (
        f"CUDA device: hand-written sm_90a kernels (ops/fused_conv.py){tag}; "
        f"fused sites: {', '.join(sites)}"
    )


def make_augment_config(cfg: config_lib.SupConConfig) -> AugmentConfig:
    if cfg.dataset in DATASET_STATS:
        mean, std = DATASET_STATS[cfg.dataset]
    elif cfg.dataset.startswith("synthetic"):
        mean, std = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)
    else:  # 'path': the user's strings (main_supcon.py:163-165, minus its std=eval(mean))
        mean = tuple(float(x) for x in cfg.mean.strip("()").split(","))
        std = tuple(float(x) for x in cfg.std.strip("()").split(","))
    return AugmentConfig(size=cfg.size, mean=mean, std=std)


def dataset_options(cfg) -> dict:
    """``load_dataset``'s keyword arguments beyond the dataset and folder:
    a ``path`` tree's crop size, stored size and memmap threshold."""
    if cfg.dataset != "path":
        return {}
    return {"size": cfg.size, "store_size": cfg.store_size,
            "mmap_threshold_mb": cfg.mmap_threshold_mb}


def build_store(cfg, loader: EpochLoader, device: torch.device):
    """``--data_placement``'s store for ``loader`` on ``device``
    (``data/device_store.make_store``), or ``None`` for the host loader."""
    return device_store.make_store(
        cfg.data_placement, loader, device,
        budget_bytes=device_store.budget_override_bytes(cfg.device_budget_mb),
        window_batches=cfg.data_window_batches,
    )


def step_batches(loader: EpochLoader, store, epoch: int, start_step: int,
                 device: torch.device):
    """``(idx, images_u8, labels)`` for the steps of ``epoch`` from
    ``start_step`` on, as tensors on ``device``: views of the store's
    buffers, or the loader's batches copied each step (:func:`to_device`).
    The copy and the store's call run when the step asks for its batch, so
    the caller's data-time meter reads their wait; a generator the caller
    closes."""
    loader.check_start_step(start_step)
    if store is not None:
        for idx in range(start_step, len(loader)):
            yield (idx, *store.batch(epoch, idx))
        return
    batches = loader.epoch(epoch, start_step)
    try:
        for idx, (images_u8, labels) in enumerate(batches, start=start_step):
            yield idx, to_device(images_u8, device), to_device(labels, device)
    finally:
        batches.close()


def build(cfg: config_lib.SupConConfig, steps_per_epoch: int, device: torch.device):
    """``(TrainState, SupConStepConfig)``: the model from ``cfg.seed``
    (built on the CPU, so an init is the same on every device; under data
    parallelism every process then takes rank 0's, and under
    ``--model_parallel`` keeps its model index's shards) with the resolved
    conv path, the compute dtype (``--bf16``) and ``--syncBN``, SGD, the
    schedule, and the step configuration with the resolved loss path."""
    world, distributed = mesh.world_size(), mesh.data_distributed()
    data_parallel = mesh.data_parallel()
    conv_impl, conv_reason = resolve_conv_impl(
        cfg.conv_impl, cfg.model, cfg.batch_size, cfg.size, device, bf16=cfg.bf16,
        world_size=world,
    )
    logging.info(
        "%s",
        config_lib.impl_resolution_banner("conv_impl", cfg.conv_impl, conv_impl, conv_reason),
    )
    torch.manual_seed(cfg.seed)
    model = SupConResNet(cfg.model, cfg.head, cfg.feat_dim)
    model.encoder.set_conv_impl(conv_impl).set_compute_dtype(compute_dtype(cfg.bf16))
    model.encoder.set_bn_sync((mesh.data_group() or torch.distributed.group.WORLD)
                              if cfg.syncBN and distributed else None)
    model = model.to(device=device, memory_format=torch.channels_last)
    collectives.broadcast_from_rank0(model)
    if mesh.model_parallel() > 1:
        layout = mesh.shard_module(model, mesh.model_parallel(), mesh.model_index())
        logging.info("tensor parallel: %d of %d state tensors sharded over a model group "
                     "of %d", len(layout), len(model.state_dict()), mesh.model_parallel())
    grad_div = config_lib.resolve_ngpu(cfg.ngpu, data_parallel)
    if grad_div != data_parallel:
        logging.warning(
            "%s", config_lib.ngpu_mismatch_banner(grad_div, data_parallel, cfg.learning_rate)
        )
    schedule = make_lr_schedule(
        learning_rate=cfg.learning_rate, epochs=cfg.epochs,
        steps_per_epoch=steps_per_epoch, cosine=cfg.cosine,
        lr_decay_rate=cfg.lr_decay_rate, lr_decay_epochs=cfg.lr_decay_epochs,
        warm=cfg.warm, warm_epochs=cfg.warm_epochs, warmup_from=cfg.warmup_from,
    )
    optimizer = make_optimizer(model, momentum=cfg.momentum, weight_decay=cfg.weight_decay,
                               optimizer=cfg.optimizer, model_group=mesh.model_group())
    logging.info("%s", config_lib.impl_resolution_banner(
        "optimizer", cfg.optimizer, cfg.optimizer, OPTIMIZER_REASONS[cfg.optimizer]))
    loss_impl, reason = resolve_loss_impl_reasoned(
        cfg.loss_impl, device, data_parallel if distributed else None,
        moco_queue=cfg.moco_queue
    )
    logging.info(
        "%s", config_lib.impl_resolution_banner("loss_impl", cfg.loss_impl, loss_impl, reason)
    )
    step_cfg = SupConStepConfig(
        method=cfg.method, temperature=cfg.temp,
        sec=cfg.sec, sec_wei=cfg.sec_wei, l2reg=cfg.l2reg, l2reg_wei=cfg.l2reg_wei,
        norm_momentum=cfg.norm_momentum, epochs=cfg.epochs,
        steps_per_epoch=steps_per_epoch, grad_div=float(grad_div), loss_impl=loss_impl,
        health_freq=cfg.health_freq,
        online_probe=cfg.online_probe == "on",
    )
    return TrainState(model=model, optimizer=optimizer, schedule=schedule), step_cfg


@dataclasses.dataclass
class EpochHooks:
    """What an epoch reports to besides ``history``: the telemetry session
    (the ring and its flush), and optionally TensorBoard, the health
    monitor, the sidecar gauges and the profiler window."""

    telemetry: TelemetrySession
    tb: Optional[TBLogger] = None
    health: object = None
    gauges: object = None
    tracer: Optional[StepTracer] = None


def train_one_epoch(
    epoch: int, loader: EpochLoader, state: TrainState, step_cfg: SupConStepConfig,
    aug_cfg: AugmentConfig, generator: torch.Generator, cfg: config_lib.SupConConfig,
    device: torch.device, history: List[Dict[str, float]], hooks: EpochHooks,
    start_step: int = 0, first_step_span: bool = False, store=None,
) -> Optional[int]:
    """One epoch from its step ``start_step`` (reference ``train()``,
    ``main_supcon.py:242-351``; JAX ``train/supcon.py:464``).

    Each step writes its metrics into the ring; at each ``print_freq``
    boundary, and at the epoch's end, the window goes to the flush, whose
    job appends each step's metrics, as floats, to ``history``, checks the
    loss (``NonFiniteLossError`` under ``--nan_guard``, raised here at a
    later boundary or at the epoch-end drain), updates the meters, writes
    the TensorBoard scalars, feeds the health monitor and logs the
    progress line. Returns the steps of the epoch taken when a preemption
    was requested before its last step, else ``None``; the flush is
    drained either way, and each entry of the epoch gets its
    ``step_time``. With a ``store`` (``data/device_store.py``) each step's
    batch is a view of its buffers, and the loader only gives the
    geometry."""
    telemetry = hooks.telemetry
    batch_time, data_time, losses = AverageMeter(), AverageMeter(), AverageMeter()
    steps = len(loader)
    last: Dict[str, float] = {}
    entries: Dict[int, dict] = {}
    clock = StepClock(device)
    telemetry.start_window_clock()
    ring_buf = telemetry.init_buffer(device)
    main_process = mesh.is_main_process()

    def submit(boundary_idx: int, step_hint: int) -> None:
        dt = (data_time.val, data_time.avg)

        def consume(fetched, bt):
            rows = []
            for (_, gstep), row in fetched:
                m = host_metrics(row)
                entry = dict(m, epoch=epoch, step=gstep, step_time=math.nan)
                history.append(entry)
                entries[gstep] = entry
                check_finite_loss(m["loss"], gstep, cfg.nan_guard)
                losses.update(m["loss"], cfg.batch_size)
                if hooks.tb is not None and main_process:
                    for name in TB_ITER_SCALARS:
                        hooks.tb.log_value(f"info/{name}", m[name], gstep)
                    for name, tag in EXTRA_TB_TAGS.items():
                        # NaN: the sentinel of a step that is not a health step
                        if name in m and math.isfinite(m[name]):
                            hooks.tb.log_value(tag, m[name], gstep)
                last.clear()
                last.update(m)
                rows.append((gstep, m))
            if hooks.health is not None:
                hooks.health.ingest(rows, gauges=hooks.gauges)
            logging.info(
                "Train: [%d][%d/%d]\tBT %.3f (%.3f)\tDT %.3f (%.3f)\t"
                "loss %.3f (%.3f)\tnorm_mean %.3f (record: %.3f) var %.3f",
                epoch, boundary_idx + 1, steps, bt[0], bt[1], dt[0], dt[1],
                losses.val, losses.avg, last["norm_mean"], last["record_norm_mean"],
                last["norm_var"],
            )

        telemetry.flush_boundary(ring_buf, consume, batch_meter=batch_time,
                                 step_hint=step_hint)

    def finish(boundary_idx: int, step_hint: int) -> None:
        telemetry.finish_epoch(lambda hint: submit(boundary_idx, hint), step_hint)
        clock.fill(entries, (epoch - 1) * steps + start_step)

    end = time.time()
    batches = step_batches(loader, store, epoch, start_step, device)
    try:
        clock.mark()
        for idx, images, labels_d in batches:
            data_time.update(time.time() - end)
            gstep = state.step
            span = (tracing.span("first_step", track="main:compile", step=gstep)
                    if first_step_span and idx == start_step else contextlib.nullcontext())
            with span:
                # named ranges for a profiler window (utils/profiling.StepTracer)
                with record_function("augment"):
                    views = two_crop_batch(generator, images, aug_cfg,
                                           process_index=mesh.data_index(),
                                           process_count=mesh.data_parallel())
                with record_function("train_step"):
                    metrics = train_step(state, step_cfg, views, labels_d)
            with record_function("metric_ring"):
                telemetry.ring.write(ring_buf, metrics, gstep)
            telemetry.append((idx, gstep), gstep)
            clock.mark()
            if hooks.tracer is not None:
                hooks.tracer.step(gstep)
            if (idx + 1) % cfg.print_freq == 0 or idx + 1 == steps:
                submit(idx, gstep)
                # the preemption vote at the flush boundary only (JAX
                # train/supcon.py:633-635): every process votes there, so
                # all stop at one step, and no step between boundaries
                # waits on the all-reduce; the last step's vote is the
                # epoch end's
                if idx + 1 < steps and preempt.requested_global():
                    finish(idx, gstep)
                    return idx + 1
            end = time.time()
        finish(steps - 1, epoch * steps - 1)
    finally:
        batches.close()
    return None


def roll_back(state: TrainState, generator: torch.Generator, backup: dict, epoch: int,
              start_step: int, steps_per_epoch: int, lr_scale: float, image_hw,
              aug_cfg: AugmentConfig, batch_size: int) -> None:
    """``--nan_policy rollback`` (JAX ``train/supcon.py:932-956``): restore
    the epoch-top ``backup`` (taken at step ``start_step`` of ``epoch``)
    into ``state`` and ``generator``, skip the rest of the epoch and damp
    the schedule by ``lr_scale``.

    The step goes to ``epoch * steps_per_epoch``; the learning rate is read
    from the step (``TrainState.set_learning_rate``), so nothing else
    follows it. The generator, which the JAX package does not have (it
    keys its draws by step), is restored and then advanced past the draws
    of the skipped steps (``ops/augment.skip_view_draws``), so it is in the
    state it would have at the epoch's end had no loss gone non-finite,
    and every later draw is the one the run would have made there. The
    choice is deterministic: two runs with the same failures end equal."""
    restore_snapshot(backup, state, generator)
    skip_view_draws(generator, steps_per_epoch - start_step, batch_size, *image_hw, aug_cfg)
    state.step = epoch * steps_per_epoch
    state.lr_scale = lr_scale


@dataclasses.dataclass
class RunResult:
    state: TrainState
    history: List[Dict[str, float]]
    save_folder: str


def run(cfg: config_lib.SupConConfig) -> RunResult:
    """The run, inside the process group when ``torchrun`` launched it (the
    group is left at the end if this call joined it), on the grid of
    ``--model_parallel`` (forgotten at the end)."""
    joined = mesh.setup_distributed(cfg.device)
    try:
        mesh.setup_grid(cfg.model_parallel)
        return _train(cfg)
    finally:
        mesh.reset_grid()
        if joined:
            mesh.teardown_distributed()


def _train(cfg: config_lib.SupConConfig) -> RunResult:
    device = resolve_device(cfg.device)
    # the minute-stamped folders: every process writes into rank 0's
    cfg.save_folder = mesh.broadcast_from_main(cfg.save_folder)
    cfg.tb_folder = mesh.broadcast_from_main(cfg.tb_folder)
    main_process = mesh.is_main_process()
    setup_logging(cfg.save_folder, main_process)
    logging.info(
        "device: %s (%s), process %d of %d", device,
        torch.cuda.get_device_name(device) if device.type == "cuda" else "host CPU",
        mesh.rank(), mesh.world_size(),
    )
    logging.info("%s", mesh.grid_banner())
    # the flight recorder, watchdog, sidecar and health monitor
    # (utils/obs.py); closed last, with the run's exit code
    obs = RunObservability(cfg, name="supcon")
    telemetry = tb = tracer = None
    exit_exc = None
    preempt.install()
    store = None
    try:
        ensure_dataset_available(cfg.dataset, cfg.data_folder, cfg.download)
        train_data, _, _ = load_dataset(cfg.dataset, cfg.data_folder, **dataset_options(cfg))
        loader = EpochLoader(
            train_data["images"], train_data["labels"], cfg.batch_size, base_seed=cfg.seed,
            process_index=mesh.data_index(), process_count=mesh.data_parallel(),
        )
        # before the model, so the budget reads the device's free memory as
        # the JAX driver's does; an explicit placement that cannot be met
        # raises here, before step 1, on every process
        store = build_store(cfg, loader, device)
        state, step_cfg = build(cfg, len(loader), device)
        # the recipe and its slots, before any restore, so a resume brings
        # the slots back (or starts them fresh, saying why)
        state, recipe = attach_for_config(cfg, state)
        logging.info("recipe: %s%s", recipe.name,
                     f" (moco_queue={cfg.moco_queue})" if cfg.moco_queue else "")
        if step_cfg.online_probe:
            n_cls = int(train_data["labels"].max()) + 1
            state.probe = build_online_probe(cfg.model, n_cls, cfg.probe_lr, seed=cfg.seed,
                                             device=device)
            logging.info("online probe: %d-class linear head on the detached encoder "
                         "features (lr %g)", n_cls, cfg.probe_lr)
        aug_cfg = make_augment_config(cfg)
        generator = torch.Generator(device=device)
        generator.manual_seed(cfg.seed + 1)
        start_epoch, start_step = 1, 0
        policy = FailurePolicy(cfg.nan_policy)
        logging.info("%s", config_lib.impl_resolution_banner(
            "nan_policy", cfg.nan_policy, cfg.nan_policy, NAN_POLICY_REASONS[cfg.nan_policy]))
        if cfg.ckpt:
            # warm start: weights and BN buffers only (main_supcon.py:216-220)
            state.model.load_state_dict(mesh.reshard_like(load_model_state(cfg.ckpt),
                                                          state.model.state_dict()))
            logging.info("load model from %s ...", cfg.ckpt)
        if cfg.resume:
            resume_path = resolve_resume_path(cfg.resume)
            meta = restore_checkpoint(resume_path, state, generator, recipe=recipe.name,
                                      moco_queue=cfg.moco_queue)
            start_epoch, start_step = resume_position(meta, len(loader))
            logging.info("resumed from %s at epoch %d step %d",
                         resume_path, start_epoch, start_step)
            # the damping is run state: a resumed run keeps it and its budget
            policy.lr_scale, policy.rollbacks = meta["lr_scale"], meta["rollbacks"]
            state.lr_scale = policy.lr_scale
            if policy.lr_scale != 1.0:
                logging.warning("resumed with rollback damping: lr_scale %.3g after %d "
                                "rollbacks", policy.lr_scale, policy.rollbacks)
        keys, blocks = ring_layout(step_cfg.health_freq > 0, step_cfg.online_probe, cfg.feat_dim,
                                   recipe.metric_keys)
        telemetry = TelemetrySession(cfg.print_freq, keys, cfg.telemetry,
                                     watchdog=obs.watchdog, gauges=obs.gauges, blocks=blocks)
        # the recipe on the recorder stream, for offline readers' per-recipe bars
        tracing.event("run_recipe", track="main:guard", recipe=recipe.name,
                      moco_queue=cfg.moco_queue)
        tb = TBLogger(cfg.tb_folder, enabled=main_process)
        tracer = StepTracer(cfg.trace_dir, cfg.trace_start_step, cfg.trace_steps,
                            enabled=main_process)
        hooks = EpochHooks(telemetry=telemetry, tb=tb, health=obs.health, gauges=obs.gauges,
                           tracer=tracer)

        def save(name: str, snapshot: dict, epoch: int, step_in_epoch: int = 0) -> str:
            with tracing.span("checkpoint_commit", track="main:checkpoint", ckpt=name):
                return save_checkpoint(os.path.join(cfg.save_folder, name), snapshot, cfg,
                                       epoch, step_in_epoch, policy.lr_scale, policy.rollbacks)

        def exit_preempted(path: str, epoch: int, step_in_epoch: Optional[int] = None) -> None:
            tracing.event("preempt_exit", track="main:guard", epoch=epoch,
                          **({} if step_in_epoch is None else {"step_in_epoch": step_in_epoch}))
            # every process leaves at this step; none before rank 0's save
            mesh.sync_processes("preempted")
            logging.warning("preempted (%s): state saved at %s; exiting %d (resume with "
                            "--resume %s)", preempt.signal_name(), path,
                            preempt.EXIT_PREEMPTED, cfg.save_folder)
            raise SystemExit(preempt.EXIT_PREEMPTED)

        history: List[Dict[str, float]] = []
        for epoch in range(start_epoch, cfg.epochs + 1):
            t1 = time.time()
            ss = start_step if epoch == start_epoch else 0
            obs.set_epoch(epoch)
            # the step updates the state in place: the crash save needs a
            # copy of the epoch top, taken on the device (by the writer, and
            # under rollback by every process, since every process restores;
            # under tensor parallelism by every process, whose shards the
            # crash save gathers)
            backup = (capture_state(state, generator, copy=True)
                      if cfg.nan_guard and (main_process or policy.policy == "rollback"
                                            or mesh.model_parallel() > 1)
                      else None)
            try:
                with tracing.span("epoch", track="main:epoch", epoch=epoch):
                    stopped_at = train_one_epoch(
                        epoch, loader, state, step_cfg, aug_cfg, generator, cfg, device,
                        history, hooks, start_step=ss, first_step_span=epoch == start_epoch,
                        store=store,
                    )
            except NonFiniteLossError:
                # step_in_epoch = ss: after a mid-epoch resume the backup
                # sits mid-epoch, and its resume must not replay those steps
                path = save(f"crash_epoch_{epoch}.pth", backup, epoch - 1, ss)
                logging.error("non-finite loss: saved %s", path)
                if not policy.should_rollback():
                    mesh.sync_processes("non-finite loss")
                    raise
                roll_back(state, generator, backup, epoch, ss, len(loader), policy.lr_scale,
                          train_data["images"].shape[1:3], aug_cfg, cfg.batch_size)
                tracing.event("nan_rollback", track="main:guard", epoch=epoch,
                              rollbacks=policy.rollbacks, lr_scale=policy.lr_scale)
                logging.warning("nan_policy=rollback (%d/%d): epoch %d skipped from its "
                                "epoch-top backup, lr scaled to %.3g", policy.rollbacks,
                                MAX_ROLLBACKS, epoch, policy.lr_scale)
                continue
            if stopped_at is not None:
                exit_preempted(save(f"preempt_epoch_{epoch}_step_{stopped_at}.pth",
                                    capture_state(state, generator), epoch - 1, stopped_at),
                               epoch, stopped_at)
            logging.info("epoch %d, total time %.2f", epoch, time.time() - t1)
            if main_process:
                epoch_losses = [h["loss"] for h in history if h["epoch"] == epoch]
                tb.log_value("loss", sum(epoch_losses) / len(epoch_losses), epoch)
                tb.log_value("learning_rate", float(state.schedule(
                    (epoch - 1) * len(loader))) * policy.lr_scale, epoch)
            path = None
            if epoch % cfg.save_freq == 0:
                path = save(f"ckpt_epoch_{epoch}.pth", capture_state(state, generator), epoch)
            if preempt.requested_global():
                # the signal came during the epoch's last step
                exit_preempted(path or save(f"preempt_epoch_{epoch}.pth",
                                            capture_state(state, generator), epoch), epoch)
        save("last.pth", capture_state(state, generator), cfg.epochs)
        mesh.sync_processes("end of run")
    except BaseException as e:
        exit_exc = e
        raise
    finally:
        preempt.uninstall()
        if telemetry is not None:
            telemetry.close()
        if store is not None:
            # a staged window nobody reads must not hold up the exit
            store.close()
        if tracer is not None:
            tracer.close()
        if tb is not None:
            tb.close()
        obs.close(exit_code=exit_code_for(exit_exc))
    return RunResult(state=state, history=history, save_folder=cfg.save_folder)


def main(argv=None) -> RunResult:
    """Exit codes (``utils/guard.py``): 0 a clean run, 1 a non-finite loss,
    2 a telemetry flush failure, 3 a health abort, 75 preempted with the
    state saved."""
    cfg = config_lib.parse_supcon(argv)
    return exit_with_code(lambda: run(cfg))


if __name__ == "__main__":
    main()
