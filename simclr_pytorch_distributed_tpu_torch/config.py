"""Pretraining and linear-probe configuration: the flags this port
honours, with the JAX package's names, defaults and derived fields
(reference ``main_supcon.py:22-152``, ``main_linear.py:21-116``).

Derived fields: the ``model_name`` run string (``main_supcon.py:109-117``),
auto-warmup when ``batch_size > 256`` (``:120-121``), the closed-form
``warmup_to`` (``:124-131``) and the timestamped save folder (``:133-142``);
for the probe, ``n_cls`` per dataset and the ``classifier_<time>_<model_name>``
run folder (``main_linear.py:65-114``).

The observability flags are the JAX package's, with its names, defaults
and checks (``config.py:129-166, :378-430, :457-530``): ``--telemetry
{async,sync}`` (where the per-window metric flush runs), ``--trace_dir``,
``--trace_start_step``, ``--trace_steps`` (a ``torch.profiler`` window),
``--flight_recorder``, ``--watchdog_secs``, ``--metrics_port`` and
``--metrics_host``; on pretraining also ``--health_freq`` (0 = off),
``--health_policy``, ``--online_probe`` and ``--probe_lr``.
``linear_parser(ce=True)`` is the CE trainer's (``train/ce.py``): the
``ce_`` run-folder prefix, ``--syncBN`` and ``--resume`` as the full-state
resume, and no ``--ckpt``.

The data flags are the JAX package's (``config.py:51-58, :82-84,
:137-148, :319-330, :473-490, :777``), on all three trainers:
``--data_placement {auto,device,window,host}`` (where training batches
live, ``data/device_store.py``), ``--data_window_batches`` and
``--device_budget_mb``, and ``--no_download`` (no CIFAR fetch). The
pretraining parser also takes ``--dataset path`` (an image tree under
``--data_folder``, ``data/folder.py``) with ``--mean``/``--std`` (required
there), ``--store_size`` and ``--mmap_threshold_mb``;
:func:`validate_data_placement` refuses ``device`` with ``path`` at parse
time. The probe and CE parsers have no ``path``, as in JAX.

The SSL recipe flags are the JAX package's (``config.py:167-187,
:392-418``): ``--recipe {auto,supcon,simclr,byol,simsiam,vicreg}``,
``--moco_queue``, ``--ema_momentum``, ``--byol_predictor {mlp,none}``,
``--predictor_hidden`` and ``--vicreg_{sim,std,cov}_coeff``, checked at
parse time by :func:`validate_recipe` (JAX ``config.py:572-640``, word for
word). ``--num_workers`` (pretraining and the probe, JAX ``config.py:38,
:310, :694, :752``) is accepted and ignored, as in the JAX package: the
reference's command lines pass it, and the augmentation runs on the device.

Flags the port does not take are absent, so argparse rejects them:
``--compile_cache``, a cache of XLA programs that the port does not
compile. ``--model_parallel N`` (default 1) is the JAX package's
(``config.py:87, 350``), on the pretraining parser only, as there: the
world forms a grid of ``W // N`` data slices by ``N`` model shards
(``parallel/mesh.setup_grid``; ``W % N != 0`` raises at start-up), and the
probe and CE parsers reject it. Every recipe runs under it, the MoCo
queue included, as in the JAX package.
Added here: ``--device {cuda,cpu}`` (default ``cuda``), ``--loss_impl
{dense,fused,ring,auto}`` (``ring`` only when asked for, as in JAX
``config.py:92-96``) and ``--conv_impl {eager,fused,auto}`` (the JAX
package's ``--conv_impl {xla,pallas,auto}``). ``--optimizer {sgd,lars}``
and ``--nan_policy {abort,rollback}`` are the JAX package's
(``config.py:366, 372``).
``--bf16`` is the JAX package's (``config.py:85, 348``): bf16 activations
and conv/linear operands with fp32 accumulation, fp32 parameters, BN
statistics and loss. ``--ckpt`` (a warm start of the model's weights and
BN buffers), ``--resume`` (the full training state) and ``--nan_guard``
are the JAX package's pretrain flags (``config.py:342, 349, 370``).
``--syncBN`` is the reference's and the JAX package's (``config.py:64``):
cross-replica BN over every process of a ``torchrun`` launch (over the
data group under ``--model_parallel``); without it each process normalizes
over its own slice of the batch. ``--ngpu auto`` is the launch's world
size, the data-parallel size ``W // N`` under ``--model_parallel``.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
from typing import Optional, Tuple

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
    # 'path' datasets: the normalization (required there), the stored
    # resolution (0 = 2 * size) and the memmap threshold (data/folder.py)
    mean: Optional[str] = None
    std: Optional[str] = None
    store_size: int = 0
    mmap_threshold_mb: int = 1024
    download: bool = True
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
    # (train/supcon_step.py); 'auto' = the world size
    ngpu: object = 2
    syncBN: bool = False
    head: str = "mlp"
    feat_dim: int = 128
    seed: int = 0
    workdir: str = "./work_space"
    loss_impl: str = "auto"
    conv_impl: str = "auto"
    device: str = "cuda"
    bf16: bool = False
    ckpt: str = ""
    resume: str = ""
    # channel-wise tensor parallelism over a data x model process grid
    model_parallel: int = 1
    nan_guard: bool = True
    nan_policy: str = "abort"
    optimizer: str = "sgd"
    telemetry: str = "async"
    trace_dir: str = ""
    trace_start_step: int = 10
    trace_steps: int = 10
    flight_recorder: str = "on"
    watchdog_secs: float = 0.0
    metrics_port: int = 0
    metrics_host: str = "127.0.0.1"
    health_freq: int = 10
    health_policy: str = "warn"
    online_probe: str = "off"
    probe_lr: float = 0.1
    data_placement: str = "auto"
    data_window_batches: int = 32
    device_budget_mb: int = 0
    # accepted for the reference's command lines and ignored
    num_workers: int = 16
    # the SSL recipe (recipes/): 'auto' is the --method-matching contrastive
    # recipe; the MoCo queue (simclr only, K a multiple of 2 * batch_size,
    # the dense loss; 0 = off); the EMA momentum of BYOL's target and the
    # queue's key encoder; BYOL's predictor ('none' ablates it); the
    # predictor's hidden width; VICReg's term weights
    recipe: str = "auto"
    moco_queue: int = 0
    ema_momentum: float = 0.996
    byol_predictor: str = "mlp"
    predictor_hidden: int = 512
    vicreg_sim_coeff: float = 25.0
    vicreg_std_coeff: float = 25.0
    vicreg_cov_coeff: float = 1.0
    # derived (finalize_supcon)
    warm_epochs: int = 10
    warmup_from: float = 0.01
    warmup_to: float = 0.0
    model_name: str = ""
    tb_folder: str = ""
    save_folder: str = ""


def parse_bool(s: str) -> bool:
    """A boolean flag value: 1/true/yes/on or 0/false/no/off."""
    v = s.lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


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
    """``--ngpu``: 'auto' is the world size ``n_devices``."""
    return int(n_devices) if ngpu == "auto" else int(ngpu)


def ngpu_mismatch_banner(ngpu: int, data_parallel: int, learning_rate: float) -> str:
    """Startup banner for an explicit ``--ngpu`` that differs from the world
    size (JAX ``config.py:277``): the step divides the exact global
    gradient by ``ngpu``, which then rescales the effective learning
    rate."""
    eff = learning_rate * data_parallel / ngpu
    bar = "=" * 72
    return (
        f"\n{bar}\n"
        f"  --ngpu {ngpu} but the run is data-parallel over {data_parallel} "
        f"device(s).\n"
        f"  Gradients are divided by {ngpu} (recipe fidelity with the "
        f"reference's {ngpu}-GPU runs): relative to world-matched scaling the "
        f"applied update is {data_parallel}/{ngpu} = "
        f"{data_parallel / ngpu:.3g}x, i.e. an EFFECTIVE learning rate of "
        f"~{eff:.4g} instead of the configured {learning_rate:g}.\n"
        f"  Pass --ngpu auto (or --ngpu {data_parallel}) to scale with this "
        f"run instead.\n"
        f"{bar}"
    )


def positive_int_arg(name: str):
    """argparse type for flags that must be >= 1 (JAX ``config.py:244``)."""

    def parse(s: str) -> int:
        try:
            v = int(s)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"--{name} expects a positive integer, got {s!r}"
            ) from None
        if v <= 0:
            raise argparse.ArgumentTypeError(f"--{name} must be positive, got {v}")
        return v

    return parse


def nonnegative_int_arg(name: str):
    """argparse type for cadence flags where 0 means off (JAX
    ``config.py:432``)."""

    def parse(s: str) -> int:
        try:
            v = int(s)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"--{name} expects a non-negative integer, got {s!r}"
            ) from None
        if v < 0:
            raise argparse.ArgumentTypeError(f"--{name} must be >= 0 (0 = off), got {v}")
        return v

    return parse


def add_runtime_flags(p: argparse.ArgumentParser, d) -> None:
    """The telemetry, data-placement, profiler and observability flags every
    trainer takes (JAX ``config.py:457-530``)."""
    p.add_argument("--telemetry", type=str, default=d.telemetry, choices=["async", "sync"],
                   help="metric flush: a background thread (no host sync between "
                        "print_freq boundaries; NaN detection at most one window late) "
                        "or inline")
    p.add_argument("--data_placement", type=str, default=d.data_placement,
                   choices=["host", "device", "window", "auto"],
                   help="training batches: 'device' = the dataset on the device, one "
                        "index upload and one gather an epoch; 'window' = a "
                        "double-buffered window of batches, one upload a window (for "
                        "datasets the device cannot hold, memmap-backed trees included); "
                        "'auto' walks the device->window->host ladder; 'host' = one copy "
                        "a step")
    p.add_argument("--data_window_batches", type=positive_int_arg("data_window_batches"),
                   default=d.data_window_batches,
                   help="windowed placement: batches a window (device memory: 2 windows)")
    p.add_argument("--device_budget_mb", type=positive_int_arg("device_budget_mb"),
                   default=d.device_budget_mb,
                   help="override the per-device placement budget in MB (default: 0.4 x "
                        "the device's free memory; 4 GB where it reports none)")
    p.add_argument("--no_download", dest="download", action="store_false", default=True,
                   help="never fetch CIFAR over the network")
    p.add_argument("--trace_dir", type=str, default=d.trace_dir,
                   help="write a torch.profiler Chrome trace of --trace_steps steps here")
    p.add_argument("--trace_start_step", type=int, default=d.trace_start_step)
    p.add_argument("--trace_steps", type=int, default=d.trace_steps)
    p.add_argument("--flight_recorder", type=str, default=d.flight_recorder,
                   choices=["on", "off"],
                   help="host-boundary span/event recorder -> <run folder>/events.jsonl "
                        "and trace.json (utils/tracing.py); adds no device sync")
    p.add_argument("--watchdog_secs", type=float, default=d.watchdog_secs,
                   help="stall watchdog: dump every thread's stack and a recorder "
                        "snapshot when the flush boundary stalls this long (0 = off)")
    p.add_argument("--metrics_port", type=int, default=d.metrics_port,
                   help="Prometheus /metrics sidecar port (step, last-boundary age, "
                        "windows in flight, health means); 0 = off")
    p.add_argument("--metrics_host", type=str, default=d.metrics_host,
                   help="sidecar bind address (default loopback)")


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
    p.add_argument("--mean", type=str, default=None,
                   help="path datasets: the per-channel mean, as a tuple string")
    p.add_argument("--std", type=str, default=None,
                   help="path datasets: the per-channel std, as a tuple string")
    p.add_argument("--data_folder", type=str, default=None,
                   help=f"the dataset's folder (default {d.data_folder}; required with "
                        "--dataset path)")
    p.add_argument("--size", type=int, default=d.size)
    p.add_argument("--store_size", type=int, default=d.store_size,
                   help="path datasets: stored resolution (0 = 2*size)")
    p.add_argument("--mmap_threshold_mb", type=int, default=d.mmap_threshold_mb,
                   help="path datasets: decode to an on-disk memmap above this size")
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
                   help="DDP grad-mean divisor (reference fidelity), or 'auto' (the "
                        "world size)")
    p.add_argument("--syncBN", action="store_true",
                   help="cross-replica BatchNorm over every process of the launch "
                        "(default: each process normalizes over its own batch slice)")
    p.add_argument("--head", type=str, default=d.head, choices=["mlp", "linear"])
    p.add_argument("--feat_dim", type=int, default=d.feat_dim)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--workdir", type=str, default=d.workdir)
    p.add_argument("--loss_impl", type=str, default=d.loss_impl,
                   choices=["auto", "dense", "fused", "ring"],
                   help="contrastive loss: the fused CUDA kernels, the dense "
                        "PyTorch form, the ring (contrast blocks rotate between the "
                        "processes, no feature gather), or auto (fused on cuda, dense on "
                        "cpu; never ring)")
    p.add_argument("--conv_impl", type=str, default=d.conv_impl,
                   choices=["auto", "eager", "fused"],
                   help="encoder conv path in train mode: the fused conv+BN CUDA "
                        "kernels for the stem and Bottlenecks, eager cuDNN convs "
                        "and BatchNorm2d, or auto (fused on cuda, eager on cpu)")
    p.add_argument("--device", type=str, default=d.device, choices=["cuda", "cpu"])
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute: activations and conv/linear operands in bf16 with "
                        "fp32 accumulation; parameters, BN statistics and the loss fp32")
    p.add_argument("--ckpt", type=str, default=d.ckpt,
                   help="warm start: a .pth (or run folder) whose model weights and BN "
                        "buffers initialize the model; the optimizer starts fresh")
    p.add_argument("--resume", type=str, default=d.resume,
                   help="a full-state .pth, or a run folder (its latest complete "
                        "checkpoint): model, SGD buffers, step, record_norm_mean and "
                        "the augmentation generator; the run continues where it stopped")
    p.add_argument("--model_parallel", type=positive_int_arg("model_parallel"),
                   default=d.model_parallel,
                   help="tensor parallelism: the launch's processes form a grid of "
                        "world/N data slices by N model shards; parameters, BN statistics "
                        "and momentum of 64+ output channels are sharded on that dim over "
                        "each model group")
    p.add_argument("--nan_guard", type=parse_bool, default=d.nan_guard,
                   help="on a non-finite loss, save crash_epoch_N.pth from the epoch-top "
                        "state, then act by --nan_policy")
    p.add_argument("--nan_policy", type=str, default=d.nan_policy,
                   choices=["abort", "rollback"],
                   help="on a non-finite loss: exit with code 1 after the crash save, or "
                        "restore the epoch-top state on every process, skip the epoch, "
                        "halve the learning rate and go on (at most 3 times)")
    p.add_argument("--optimizer", type=str, default=d.optimizer, choices=["sgd", "lars"],
                   help="sgd (the reference's), or lars: layer-adaptive scaling for large "
                        "global batches (optax.lars: weight decay and trust ratio on "
                        "kernels only)")
    p.add_argument("--health_freq", type=nonnegative_int_arg("health_freq"),
                   default=d.health_freq,
                   help="compute the representation-health diagnostics (alignment, "
                        "uniformity, contrastive top-1, negative similarities, gradient "
                        "norm, effective rank) every Nth step, shipped through the "
                        "metric ring; 0 = off")
    p.add_argument("--health_policy", type=str, default=d.health_policy,
                   choices=["warn", "abort"],
                   help="on a windowed collapse/divergence verdict: log and record an "
                        "event, or exit with code 3 (never rolled back)")
    p.add_argument("--online_probe", type=str, default=d.online_probe, choices=["on", "off"],
                   help="train a detached linear probe on the detached encoder features "
                        "of every step; its loss and top-1 stream through the ring")
    p.add_argument("--probe_lr", type=float, default=d.probe_lr,
                   help="online probe SGD learning rate (constant)")
    p.add_argument("--recipe", type=str, default=d.recipe,
                   choices=["auto", "supcon", "simclr", "byol", "simsiam", "vicreg"],
                   help="SSL loss head (recipes/): 'auto' = the --method-matching "
                        "contrastive recipe; supcon/simclr force the method; byol = "
                        "predictor + EMA target; simsiam = predictor + stop-gradient; "
                        "vicreg = invariance/variance/covariance")
    p.add_argument("--moco_queue", type=nonnegative_int_arg("moco_queue"),
                   default=d.moco_queue,
                   help="MoCo-style negative queue: an EMA key encoder + a device-side "
                        "ring of K past keys as extra NT-Xent negatives (simclr recipe "
                        "only; K a multiple of 2*batch_size; dense loss path); 0=off")
    p.add_argument("--ema_momentum", type=float, default=d.ema_momentum,
                   help="EMA momentum in [0, 1) of the slow branch: byol's target "
                        "network / the moco queue's key encoder")
    p.add_argument("--byol_predictor", type=str, default=d.byol_predictor,
                   choices=["mlp", "none"],
                   help="byol predictor head; 'none' ablates it (the known-collapsing "
                        "form)")
    p.add_argument("--predictor_hidden", type=positive_int_arg("predictor_hidden"),
                   default=d.predictor_hidden,
                   help="byol/simsiam predictor MLP hidden width")
    p.add_argument("--vicreg_sim_coeff", type=float, default=d.vicreg_sim_coeff,
                   help="vicreg invariance weight (paper: 25)")
    p.add_argument("--vicreg_std_coeff", type=float, default=d.vicreg_std_coeff,
                   help="vicreg variance-hinge weight (paper: 25)")
    p.add_argument("--vicreg_cov_coeff", type=float, default=d.vicreg_cov_coeff,
                   help="vicreg covariance weight (paper: 1)")
    p.add_argument("--num_workers", type=int, default=d.num_workers,
                   help="accepted for the reference's command lines and ignored: the "
                        "augmentation runs on the device")
    add_runtime_flags(p, d)
    return p


def parse_supcon(argv=None) -> SupConConfig:
    kwargs = vars(supcon_parser().parse_args(argv))
    kwargs["lr_decay_epochs"] = tuple(int(x) for x in kwargs["lr_decay_epochs"].split(","))
    return finalize_supcon(SupConConfig(**kwargs))


def validate_data_placement(dataset: str, data_placement: str) -> None:
    """Parse-time check (JAX ``config.py:521``): a ``path`` tree may decode
    into an on-disk memmap (above ``--mmap_threshold_mb``), which is never
    made device-resident, and whether it does is known only after the
    decode; so an explicit ``device`` is refused here. ``auto`` resolves
    against the decoded array, and ``window`` streams from a memmap."""
    if data_placement == "device" and dataset == "path":
        raise ValueError(
            "--data_placement device is not accepted with --dataset path: "
            "folder datasets may decode to an on-disk memmap "
            "(--mmap_threshold_mb), which cannot be made device-resident — "
            "use --data_placement auto (decides from the decoded size, "
            "falls back to host with a banner) or host"
        )


def validate_recipe(cfg: SupConConfig) -> None:
    """Resolve ``--recipe auto`` and check the recipe flag interactions at
    parse time (JAX ``config.py:572-640``).

    Mutates ``cfg.recipe`` to the concrete name and, for the contrastive
    recipes, forces ``cfg.method`` to match (``--recipe`` is the outer
    selector; a method the recipe contradicts is an error only for the
    label-free recipes, where an explicit ``--method SupCon`` would be
    silently meaningless).
    """
    if cfg.recipe == "auto":
        cfg.recipe = "supcon" if cfg.method == "SupCon" else "simclr"
    elif cfg.recipe == "supcon":
        # forcing the method here is unambiguous: --method defaults to
        # SimCLR, so a SimCLR value cannot be distinguished from "not given"
        cfg.method = "SupCon"
    elif cfg.recipe == "simclr":
        if cfg.method == "SupCon":
            # SupCon is NOT the --method default, so this is an explicit,
            # contradictory ask — dropping the labels silently would train
            # unsupervised while the user believes otherwise
            raise ValueError(
                "--recipe simclr contradicts --method SupCon (the recipe "
                "is label-free NT-Xent) — drop --method, or use "
                "--recipe supcon"
            )
        cfg.method = "SimCLR"
    else:  # byol / simsiam / vicreg: label-free
        if cfg.method == "SupCon":
            raise ValueError(
                f"--recipe {cfg.recipe} is label-free; --method SupCon has "
                "no effect there — drop the flag (or use --recipe supcon)"
            )
    if cfg.moco_queue:
        if cfg.recipe != "simclr":
            raise ValueError(
                f"--moco_queue holds NEGATIVES only, which --recipe "
                f"{cfg.recipe} cannot use "
                + ("(supervised positives may sit in the queue)"
                   if cfg.recipe == "supcon" else "(no contrastive term)")
                + " — it requires --recipe simclr"
            )
        if cfg.moco_queue % (2 * cfg.batch_size) != 0:
            raise ValueError(
                f"--moco_queue {cfg.moco_queue} must be a multiple of "
                f"2*batch_size ({2 * cfg.batch_size}): the ring write at the "
                "pointer would otherwise straddle the queue's edge, so "
                "partial-batch rotations would corrupt the queue"
            )
        if cfg.loss_impl in ("fused", "ring"):
            raise ValueError(
                f"--moco_queue extends the contrast side past the fixed "
                f"2B geometry the {cfg.loss_impl!r} kernel tiles — use "
                "--loss_impl dense (or auto, which resolves to dense)"
            )
    if not 0.0 <= cfg.ema_momentum < 1.0:
        raise ValueError(
            f"--ema_momentum must be in [0, 1), got {cfg.ema_momentum}"
        )
    for name in ("vicreg_sim_coeff", "vicreg_std_coeff", "vicreg_cov_coeff"):
        if getattr(cfg, name) < 0:
            raise ValueError(
                f"--{name} must be >= 0, got {getattr(cfg, name)}"
            )


def finalize_supcon(cfg: SupConConfig) -> SupConConfig:
    """Derived fields, replicating main_supcon.py:92-150. The save folder
    is named here and created by the driver."""
    validate_data_placement(cfg.dataset, cfg.data_placement)
    validate_recipe(cfg)
    if cfg.dataset == "path" and (cfg.data_folder is None or cfg.mean is None
                                  or cfg.std is None):
        raise ValueError("--dataset path needs --data_folder, --mean and --std")
    if cfg.data_folder is None:
        cfg.data_folder = "./datasets/"
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
    run = f"{cfg.dataset}_{now_time}_{cfg.model_name}"
    cfg.save_folder = os.path.join(cfg.workdir, f"{cfg.dataset}_models", run)
    cfg.tb_folder = os.path.join(cfg.workdir, f"{cfg.dataset}_tensorboard", run)
    return cfg


@dataclasses.dataclass
class LinearConfig:
    """The probe's configuration (JAX ``config.py:688``, reference
    ``main_linear.py:21-116``); also the CE trainer's."""

    print_freq: int = 10
    save_freq: int = 10
    batch_size: int = 512
    epochs: int = 100
    learning_rate: float = 0.1
    lr_decay_epochs: Tuple[int, ...] = (60, 75, 90)
    lr_decay_rate: float = 0.2
    weight_decay: float = 0.0
    momentum: float = 0.9
    model: str = "resnet50"
    dataset: str = "cifar10"
    cosine: bool = False
    warm: bool = False
    # CE trainer only: cross-replica BN (the probe's encoder is frozen)
    syncBN: bool = False
    ckpt: str = ""
    # the CE trainer's full-state resume; the probe accepts it for the
    # exit-75 relaunch contract and retrains from scratch
    resume: str = ""
    data_folder: str = "./datasets/"
    size: int = 32
    val_batch_size: int = 256  # main_ce.py:64-66
    bf16: bool = False
    seed: int = 0
    workdir: str = "./work_space"
    trial: str = "0"
    device: str = "cuda"
    telemetry: str = "async"
    trace_dir: str = ""
    trace_start_step: int = 10
    trace_steps: int = 10
    flight_recorder: str = "on"
    watchdog_secs: float = 0.0
    metrics_port: int = 0
    metrics_host: str = "127.0.0.1"
    data_placement: str = "auto"
    data_window_batches: int = 32
    device_budget_mb: int = 0
    download: bool = True
    # accepted for the reference's command lines and ignored
    num_workers: int = 16
    # derived (finalize_linear)
    n_cls: int = 10
    warm_epochs: int = 10
    warmup_from: float = 0.01
    warmup_to: float = 0.0
    model_name: str = ""
    tb_folder: str = ""
    save_folder: str = ""


N_CLASSES = {"cifar10": 10, "cifar100": 100, "synthetic": 10, "synthetic_hard": 10,
             "synthetic_hard32": 32}


def linear_parser(ce: bool = False) -> argparse.ArgumentParser:
    """The probe's flags, or with ``ce`` the CE trainer's (JAX
    ``config.py:746``): the CE trainer takes ``--syncBN`` and a full-state
    ``--resume``, and no ``--ckpt``."""
    d = LinearConfig()
    p = argparse.ArgumentParser("argument for training")
    p.add_argument("--print_freq", type=int, default=d.print_freq)
    p.add_argument("--save_freq", type=int, default=d.save_freq)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--learning_rate", type=float, default=d.learning_rate)
    p.add_argument("--lr_decay_epochs", type=str, default="60,75,90")
    p.add_argument("--lr_decay_rate", type=float, default=d.lr_decay_rate)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--momentum", type=float, default=d.momentum)
    p.add_argument("--model", type=str, default=d.model)
    # no 'path': the probe and CE trainers validate on a test split
    p.add_argument("--dataset", type=str, default=d.dataset,
                   choices=[name for name in DATASETS if name != "path"])
    p.add_argument("--cosine", action="store_true")
    p.add_argument("--warm", action="store_true")
    if ce:
        p.add_argument("--syncBN", action="store_true",
                       help="cross-replica BatchNorm over every process of the launch "
                            "(default: each process normalizes over its own batch slice)")
        p.add_argument("--resume", type=str, default=d.resume,
                       help="a full-state .pth, or a run folder (its latest complete "
                            "checkpoint): the run continues where it stopped")
    else:
        p.add_argument("--ckpt", type=str, default=d.ckpt,
                       help="the pretrained encoder: a .pth in the reference layout, or a "
                            "run folder (its last.pth)")
        p.add_argument("--resume", type=str, default=d.resume,
                       help="accepted for the exit-75 relaunch contract (re-run the same "
                            "command with --resume); the probe keeps no full-state "
                            "checkpoints, so it retrains from scratch")
    p.add_argument("--data_folder", type=str, default=d.data_folder)
    p.add_argument("--val_batch_size", type=int, default=d.val_batch_size)
    p.add_argument("--bf16", action="store_true",
                   help="run the frozen encoder in bf16 compute; features, classifier "
                        "and loss fp32")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--workdir", type=str, default=d.workdir)
    p.add_argument("--trial", type=str, default=d.trial)
    p.add_argument("--device", type=str, default=d.device, choices=["cuda", "cpu"])
    p.add_argument("--num_workers", type=int, default=d.num_workers,
                   help="accepted for the reference's command lines and ignored: the "
                        "augmentation runs on the device")
    add_runtime_flags(p, d)
    return p


def parse_linear(argv=None, ce: bool = False) -> LinearConfig:
    kwargs = vars(linear_parser(ce).parse_args(argv))
    kwargs["lr_decay_epochs"] = tuple(int(x) for x in kwargs["lr_decay_epochs"].split(","))
    return finalize_linear(LinearConfig(**kwargs), prefix="ce_" if ce else "classifier_")


def finalize_linear(cfg: LinearConfig, prefix: str = "classifier_") -> LinearConfig:
    """Derived fields, replicating main_linear.py:65-114 (JAX
    ``config.py:797``); ``prefix`` starts the run folder's name
    (``classifier_`` for the probe, ``ce_`` for the CE trainer). The save
    folder is named here and created by the driver."""
    cfg.model_name = (
        f"{cfg.dataset}_{cfg.model}_lr_{cfg.learning_rate}"
        f"_decay_{cfg.weight_decay}_bsz_{cfg.batch_size}"
    )
    if cfg.cosine:
        cfg.model_name = f"{cfg.model_name}_cosine"
    if cfg.warm:
        cfg.model_name = f"{cfg.model_name}_warm"
        cfg.warmup_from = 0.01
        cfg.warm_epochs = 10
        cfg.warmup_to = warmup_to_value(
            cfg.learning_rate, cfg.lr_decay_rate, cfg.warm_epochs, cfg.epochs, cfg.cosine
        )
    cfg.n_cls = N_CLASSES[cfg.dataset]
    now_time = datetime.datetime.now().strftime("%m%d_%H%M")
    run = f"{prefix}{now_time}_{cfg.model_name}"
    cfg.save_folder = os.path.join(cfg.workdir, f"{cfg.dataset}_models", run)
    cfg.tb_folder = os.path.join(cfg.workdir, f"{cfg.dataset}_tensorboard", run)
    return cfg


def config_dict(cfg) -> dict:
    """The configuration as plain types (tuples as lists), for a
    checkpoint's ``opt`` entry: ``torch.load(weights_only=True)`` reads it."""
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}


def impl_resolution_banner(flag: str, requested: str, resolved: str, reason: str) -> str:
    """One startup line naming the resolved implementation and why."""
    if requested == resolved:
        return f"[{flag}] '{resolved}': {reason}"
    return f"[{flag}] requested '{requested}' -> resolved '{resolved}': {reason}"
