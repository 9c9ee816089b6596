#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version on the card, drives the port's pretraining entry point
(``train.supcon.main``) for one epoch of SimCLR on ResNet-50 at the published
recipe's width (batch 256, 32 px, two crops, so the loss sees N = 512 rows),
checks that the run went through the kernels, and times kernels and train
steps with CUDA events. Phases: device, build, kernel_parity, train, timing.
Any failure raises and the script exits non-zero.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``: launches on the main path, error against the plain
version, times, and the least time the card could take) and then
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result. TF32 is off throughout, so every number is
fp32.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

N_ROWS, DIM = 512, 128  # the recipe's loss shape: 2 x 256 views, feat_dim 128
TEMP, BASE_TEMP = 0.5, 0.07


def phase(name):
    print(f"== phase {name}", flush=True)
    return time.time()


def done(name, t0):
    print(f"== phase {name} passed in {time.time() - t0:.2f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def unit_features(n, d, seed, device):
    g = torch.Generator().manual_seed(seed)
    f = torch.randn(n, d, generator=g)
    return (f / f.norm(dim=1, keepdim=True)).to(device)


def loss_inputs(batch, seed, device, n_classes=None):
    """View-major unit features and ids for a [batch, 2] problem."""
    f = unit_features(2 * batch, DIM, seed, device)
    if n_classes is None:
        base = torch.arange(batch)
    else:
        g = torch.Generator().manual_seed(seed + 1)
        base = torch.randint(0, n_classes, (batch,), generator=g)
    ids = base.repeat(2).to(device=device, dtype=torch.int32)
    gid = torch.arange(2 * batch, device=device, dtype=torch.int32)
    return f, ids, gid


def cuda_time_ms(fn, reps=100, rounds=5, warmup=10):
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back calls,
    by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def forward_flops(model, size, device) -> int:
    """FLOPs (2 per multiply-add) of one image's forward through the
    model's convolutions and linear layers, counted from their shapes."""
    total = 0

    def count(m, inp, out):
        nonlocal total
        if isinstance(m, torch.nn.Conv2d):
            k = (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]
        else:
            k = m.in_features
        total += 2 * out.numel() * k

    handles = [
        m.register_forward_hook(count)
        for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))
    ]
    try:
        with torch.no_grad():
            model.eval()(torch.zeros(1, size, size, 3, device=device))
    finally:
        for h in handles:
            h.remove()
    return total


def bound(flops, nbytes):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to test",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
    from simclr_pytorch_distributed_tpu_torch.ops import fused_loss, native
    from simclr_pytorch_distributed_tpu_torch.ops.augment import AugmentConfig, two_crop_batch
    from simclr_pytorch_distributed_tpu_torch.ops.losses import supcon_loss
    from simclr_pytorch_distributed_tpu_torch.data.cifar import synthetic_dataset
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
        SupConStepConfig,
        train_step,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- device ------------------------------------------------------------
    t0 = phase("device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"device {kind} capability {cap[0]}.{cap[1]} count {torch.cuda.device_count()}")
    print(f"nvidia-smi name, power.limit: {card}")
    if cap != (9, 0):
        raise RuntimeError(f"need a compute capability 9.0 card, got {cap}")
    done("device", t0)

    # -- build -------------------------------------------------------------
    t0 = phase("build")
    tb = time.time()
    lib_path = native.build("fused_supcon_loss")
    print(f"built {os.path.relpath(lib_path, REPO)} in {time.time() - tb:.2f} s")
    print(lib_path.with_suffix(".log").read_text().strip())
    done("build", t0)

    # -- kernel_parity -----------------------------------------------------
    t0 = phase("kernel_parity")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errors = {}
    for case, batch, classes in (("a", 256, None), ("b", 256, 10), ("c", 37, None)):
        f, ids, gid = loss_inputs(batch, seed=1, device=dev, n_classes=classes)
        args = (f, f, ids, ids, gid, gid)
        got = fused_loss.fused_rows(*args, TEMP, BASE_TEMP)
        ref = fused_loss.fused_rows_reference(*args, TEMP, BASE_TEMP)
        _, lse, cnt = ref
        coeff = (TEMP / BASE_TEMP) / f.shape[0]
        d_got = fused_loss.fused_bwd(*args, lse, lse, cnt, cnt, TEMP, coeff)
        d_ref = fused_loss.fused_bwd_reference(*args, lse, lse, cnt, cnt, TEMP, coeff)
        torch.cuda.synchronize()
        line = [f"case {case}: N={f.shape[0]} D={DIM} "
                f"{'SupCon %d classes' % classes if classes else 'SimCLR'}"]
        for name, g, r in zip(("loss_row", "lse", "cnt"), got, ref):
            abs_err = (g - r).abs().max().item()
            rel_err = ((g - r).abs() / r.abs()).max().item()
            line.append(f"{name} abs {abs_err:.3e} rel {rel_err:.3e}")
            ok = torch.equal(g, r) if name == "cnt" else rel_err <= 1e-5
            if not ok:
                raise AssertionError(f"case {case}: {name} off: abs {abs_err} rel {rel_err}")
            errors[(case, name)] = abs_err
        d_abs = (d_got - d_ref).abs().max().item()
        d_scale = d_ref.abs().max().item()
        line.append(f"dF abs {d_abs:.3e} (max|dF| {d_scale:.3e}, rel {d_abs / d_scale:.3e})")
        print("; ".join(line))
        if not d_abs <= 1e-5 * d_scale:
            raise AssertionError(f"case {case}: dF off: {d_abs} > 1e-5 * {d_scale}")
        errors[(case, "dF")] = d_abs
    print("bounds: cnt exact; loss_row, lse rtol 1e-5; dF atol 1e-5 x max|dF|")
    done("kernel_parity", t0)

    # -- train: the main path, through the port's entry point ---------------
    t0 = phase("train")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    batch_size = 256
    argv = [
        "--device", "cuda", "--dataset", "synthetic", "--model", "resnet50",
        "--batch_size", str(batch_size), "--size", "32", "--epochs", "1",
        "--method", "SimCLR", "--temp", str(TEMP), "--learning_rate", "0.5",
        "--cosine", "--loss_impl", "fused", "--print_freq", "1", "--save_freq", "1",
        "--workdir", workdir,
    ]
    fused_loss.fwd_launches = 0
    fused_loss.bwd_launches = 0
    result = supcon.main(argv)
    launches = {"fwd": fused_loss.fwd_launches, "bwd": fused_loss.bwd_launches}
    losses = [h["loss"] for h in result.history]
    print(f"losses {losses}")
    print(f"kernel launches in the run: fwd {launches['fwd']} bwd {launches['bwd']}")
    if len(losses) != 7 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected 7 finite losses, got {losses}")
    if launches != {"fwd": 7, "bwd": 7}:
        raise AssertionError(f"expected 7 launches of each kernel, got {launches}")
    last = os.path.join(result.save_folder, "last.pth")
    if not os.path.isfile(last):
        raise AssertionError(f"{last} was not written")

    # one step, dense against fused, from one seeded init on one batch
    data, _ = synthetic_dataset()
    images = torch.from_numpy(data["images"][:batch_size]).to(dev)
    labels = torch.from_numpy(data["labels"][:batch_size]).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    views = two_crop_batch(gen, images, AugmentConfig(mean=(0.5,) * 3, std=(0.25,) * 3))
    torch.manual_seed(0)
    model = SupConResNet("resnet50").to(dev, memory_format=torch.channels_last)
    step_loss, stepped = {}, {}
    for impl in ("dense", "fused"):
        m = copy.deepcopy(model)
        st = TrainState(model=m, optimizer=make_optimizer(m), schedule=lambda s: 0.5)
        cfg = SupConStepConfig(temperature=TEMP, loss_impl=impl, epochs=1, steps_per_epoch=7)
        before = (fused_loss.fwd_launches, fused_loss.bwd_launches)
        step_loss[impl] = train_step(st, cfg, views, labels)["loss"].item()
        after = (fused_loss.fwd_launches, fused_loss.bwd_launches)
        expected = (1, 1) if impl == "fused" else (0, 0)
        if (after[0] - before[0], after[1] - before[1]) != expected:
            raise AssertionError(f"{impl} step launched {before} -> {after} kernels")
        stepped[impl] = m.state_dict()
    rel = abs(step_loss["fused"] - step_loss["dense"]) / abs(step_loss["dense"])
    print(f"one step dense {step_loss['dense']!r} fused {step_loss['fused']!r} "
          f"rel diff {rel:.3e} (bound 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError(f"dense and fused step losses differ by {rel}")
    param_diff = max(
        (stepped["fused"][k] - v).abs().max().item()
        for k, v in stepped["dense"].items() if v.is_floating_point()
    )
    print(f"after that step, max |param or BN buffer difference| dense vs fused: "
          f"{param_diff:.3e} (reported, not bounded: cuDNN's backward sums in its own order)")
    done("train", t0)

    # -- timing ------------------------------------------------------------
    t0 = phase("timing")
    f, ids, gid = loss_inputs(N_ROWS // 2, seed=2, device=dev)
    args = (f, f, ids, ids, gid, gid)
    _, lse, cnt = fused_loss.fused_rows(*args, TEMP, BASE_TEMP)
    coeff = (TEMP / BASE_TEMP) / N_ROWS
    bwd_args = args + (lse, lse, cnt, cnt, TEMP, coeff)
    fwd_ms = cuda_time_ms(lambda: fused_loss.fused_rows(*args, TEMP, BASE_TEMP))
    fwd_plain_ms = cuda_time_ms(lambda: fused_loss.fused_rows_reference(*args, TEMP, BASE_TEMP))
    bwd_ms = cuda_time_ms(lambda: fused_loss.fused_bwd(*bwd_args))
    bwd_plain_ms = cuda_time_ms(lambda: fused_loss.fused_bwd_reference(*bwd_args))
    feats3 = f.reshape(2, N_ROWS // 2, DIM).transpose(0, 1)
    dense_ms = cuda_time_ms(
        lambda: supcon_loss(feats3, temperature=TEMP, base_temperature=BASE_TEMP)
    )
    aug_cfg = AugmentConfig(mean=(0.5,) * 3, std=(0.25,) * 3)
    aug_ms = cuda_time_ms(lambda: two_crop_batch(gen, images, aug_cfg), reps=5, rounds=3, warmup=2)
    step_times = [h["step_time"] for h in result.history[2:7]]
    step_ms = statistics.median(step_times) * 1e3
    step_flops = 3 * forward_flops(model, 32, dev) * 2 * batch_size
    where = f"on {card}"
    print(f"fused fwd kernel {fwd_ms * 1e3:.2f} us, plain {fwd_plain_ms * 1e3:.2f} us {where}")
    print(f"fused bwd kernel {bwd_ms * 1e3:.2f} us, plain {bwd_plain_ms * 1e3:.2f} us {where}")
    print(f"dense supcon_loss forward (several PyTorch calls; context, not a yardstick) "
          f"{dense_ms * 1e3:.2f} us {where}")
    print(f"train step (resnet50, batch {batch_size}, 32 px, fp32) median of steps 3-7 "
          f"{step_ms:.2f} ms = {batch_size / step_ms * 1e3:.1f} imgs/s; "
          f"all steps ms {[round(t * 1e3, 2) for t in step_times]} {where}")
    print(f"two-crop augmentation of the {batch_size}-image batch {aug_ms:.3f} ms {where}")
    print(f"train step model FLOPs (3 x forward of convs and linears, {2 * batch_size} views) "
          f"{step_flops / 1e9:.1f} GFLOP -> {step_flops / step_ms / 1e9:.2f} TFLOP/s = "
          f"{step_flops / step_ms * 1e3 / PEAK_FP32_FLOPS * 100:.1f}% of the fp32 non-tensor "
          f"peak {where}")
    done("timing", t0)

    # each input read once, each output written once: features, ids and
    # global ids in, three [n] rows out (forward); features, ids, global
    # ids, lse and cnt in, [n, d] out (backward); FMA FLOPs of the logits
    # tile (forward) and of the logits tile plus h @ F (backward)
    n, d = f.shape
    fwd_bound = bound(2 * n * n * d, n * d * 4 + 2 * n * 4 + 3 * n * 4)
    bwd_bound = bound(4 * n * n * d, n * d * 4 + 4 * n * 4 + n * d * 4)
    source = "simclr_pytorch_distributed_tpu_torch/csrc/fused_supcon_loss.cu"
    kernels = [
        {
            "name": "fused_supcon_loss_fwd", "route": "cuda", "source": source,
            "replaces": "simclr_pytorch_distributed_tpu/ops/pallas_loss.py:69",
            "launches": launches["fwd"],
            "max_abs_err": max(errors[("a", "loss_row")], errors[("a", "lse")]),
            "ms": fwd_ms, "plain_ms": fwd_plain_ms,
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": None,
        },
        {
            "name": "fused_supcon_loss_bwd", "route": "cuda", "source": source,
            "replaces": "simclr_pytorch_distributed_tpu/ops/pallas_loss.py:114",
            "launches": launches["bwd"], "max_abs_err": errors[("a", "dF")],
            "ms": bwd_ms, "plain_ms": bwd_plain_ms,
            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": None,
        },
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
