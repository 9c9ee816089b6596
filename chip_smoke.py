#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (one nvcc per source, all
started together), holds each against its plain PyTorch version on the card
(the loss pair at ``LOSS_CASES``: N = 512 SimCLR and SupCon, 74 rows,
the sharded form's row offset, D = 18 and nr = nc = 2; the stem,
Bottleneck, BasicBlock and projection-block pairs at every distinct
geometry of the ResNet-50 and ResNet-18 recipe sites and at ragged shapes,
in fp32 and, for the conv kernels, in bf16 against both their bf16 and
their fp32 plain forms),
drives the port's pretraining entry point (``train.supcon.main``) for one
epoch of SimCLR at the published recipe's width (batch 256, 32 px, two
crops, so the encoder and the loss see 512 rows) with ``--conv_impl fused
--loss_impl fused`` on four paths, ResNet-50 (17 conv sites: the stem and
16 Bottlenecks) and ResNet-18 (9: the stem, 5 identity and 3 projection
BasicBlocks), each in fp32 and under ``--bf16``, checks that each run went
through every kernel of its path (and of its dtype) and that all its sites
fused, compares one step of each model's fused conv path with its eager
one (fp32: the loss, each parameter's update and the BN buffers, beside a
float64 run; bf16: the eager and the fused bf16 step each against the fp32
eager step, from an init with small residual-branch BN gammas where the
step is well conditioned), checks that two forward calls and two backward
calls of the stem, the Bottleneck and the BasicBlock and projection-block
entry points, and of the loss kernels, give bitwise-equal outputs, and
times kernels and train steps with CUDA events (the loss kernels also at
N = 8192), the loss kernels and the stem, Bottleneck, BasicBlock and
projection-block forwards and backwards also split by device kernel
(``torch.profiler``), the conv entry points with their peak memory.
Phases: device, build, kernel_parity, train, timing. Any failure raises
and the script exits non-zero.

    python3 chip_smoke.py --split-only --root <checkout>

builds only the kernel libraries of another checkout (a parent commit
unpacked with ``git archive``, say) and prints its loss split (device time
per kernel name, CUDA-event time and the wrapper's host time, at N = 512
and 8192) and its stem, Bottleneck, BasicBlock and projection-block forward
and backward splits, for a comparison inside one call.

The last lines of standard output are the card's name and power limit, one
JSON object with an entry per kernel (``{"kernels": [...]}``: launches on
the main path, error against the plain version, times, and the least time
the card could take) and then
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result. TF32 is off throughout, so every fp32
number is full fp32; the bf16 kernels and the bf16 eager chains multiply
bf16 operands with fp32 accumulation.
"""

from __future__ import annotations

import concurrent.futures
import copy
import functools
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
# cores, dense bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

N_ROWS, DIM = 512, 128  # the recipe's loss shape: 2 x 256 views, feat_dim 128
TEMP, BASE_TEMP = 0.5, 0.07
EPS = 1e-5
SOURCES = ("fused_supcon_loss", "fused_conv_bn")
PALLAS_CONV = "simclr_pytorch_distributed_tpu/ops/pallas_conv.py"

# Conv kernel parity pins. Forward values and moments, and everything at
# the ragged shapes: the JAX package's elementwise pins against the plain
# fp32 form (tests/test_pallas_conv.py:46-47; moments with the 2.5e-6
# BN-statistics pin). Gradients at the recipe's sites go against the plain
# form run in float64, because there the plain fp32 form is no oracle:
# with 10^7-10^8 ReLU inputs per call, a few lie within fp32 rounding of
# zero, and a flipped mask moves single gradient entries by up to 20% of
# their tensor's max, in the plain fp32 form as in the kernel (PERF.md,
# Findings). So, at the recipe's sites, per gradient tensor in relative L2
# norm against float64: with the main path's inputs, at most GRAD_REL_L2;
# with inputs whose BN shifts keep the ReLU inputs away from zero, at most
# GRAD_VS_PLAIN times the plain fp32 form's own error (floor
# GRAD_L2_FLOOR). With margin inputs the Bottleneck's db2 is left out:
# every ReLU passes, so db2 = sum(dy3 @ k3^T) sums a BN backward's output,
# which is zero per channel, and its relative error measures rounding over
# a zero (PERF.md). MARGIN_EXEMPT names such gradients per kernel. The
# BasicBlocks' db1 = sum(conv3x3^T(dy2)) is no such zero and stays pinned:
# each tap's sum of dy2 over the grid is zero but for the one-pixel border
# strip that tap shifts out, so db1 keeps the border terms, a part of its
# size that grows as the grid shrinks (PERF.md, Findings).
VAL_RTOL, VAL_ATOL = 3e-5, 3e-5
STAT_RTOL, STAT_ATOL = 3e-5, 2.5e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3
GRAD_REL_L2 = 1e-2
GRAD_VS_PLAIN, GRAD_L2_FLOOR = 4.0, 1e-5
# The BN-beta shift of the margin inputs: with normalized pre-activations
# and gammas of 1 +- 0.2, a ReLU input lies within fp32 rounding of zero
# with odds under 1e-11 per element, against ~1e-7 unshifted.
MARGIN = 8.0
# The eager-vs-fused train step on the card: each parameter's update, in
# relative L2 against the eager update, at most STEP_UPDATE_REL_L2; BN
# buffers elementwise at STEP_BUF_TOL, as the CPU test
# test_one_step_fused_matches_eager pins them. At this init the fp32 step
# itself is ill-conditioned: each fp32 path's update is up to ~2e-2 from a
# float64 step (the run prints it), so two fp32 paths may differ by the
# sum, ~4e-2 (PERF.md, Findings).
STEP_UPDATE_REL_L2 = 5e-2
STEP_BUF_TOL = 1e-4
MARGIN_EXEMPT = {"fused_bottleneck_bwd": ("db2",), "fused_bottleneck_bwd_bf16": ("db2",)}
# the fused_conv launch counters, one per entry point and compute dtype
CONV_COUNTERS = tuple(f"{kind}_{d}_launches" for kind in ("stem", "basic", "proj", "bottleneck")
                      for d in ("fwd", "bwd"))
BF16_COUNTERS = tuple(name.replace("_launches", "_bf16_launches") for name in CONV_COUNTERS)
# bf16 conv kernel pins. The JAX package's round-19 bounds for its bf16
# kernels against the fp32 reference (tests/test_pallas_conv.py:49-77),
# applied to each bf16 kernel against its bf16 plain form and against the
# fp32 plain form. Values: max |a - b| / max |b| and cosine; gradients
# (every dW, dx, dgamma, dbeta): cosine and max |a - b| / max |b|; BN
# moments: max |a - b| / max |b|. They are wide enough to admit the fp32
# plain form in place of a bf16 kernel, so against the bf16 plain form,
# which rounds at the kernels' points, each tensor is also pinned in
# relative L2 (BF16_REL_L2): gradients and moments at about three times
# the kernels' worst reading over every case, values at twice it, which is
# under the fp32 plain form's least distance from the bf16 one (PERF.md,
# Findings, gives the readings). A kernel that drops or misplaces one tile
# of a gradient breaks it.
BF16_VAL_SCALED, BF16_VAL_COS = 2e-2, 0.9999
BF16_GRAD_COS, BF16_GRAD_SCALED = 0.95, 0.5
BF16_STATS_SCALED = 2e-2
BF16_REL_L2 = {"value": 1.5e-3, "stats": 4e-5, "grad": 5e-2}
# The bf16 step check (step_check_bf16) starts from the recipe's init with
# the last BN gamma of every residual branch scaled by BRANCH_GAMMA. At the
# plain init the ResNet-50 backward is ill-conditioned (for a fixed
# cotangent its bf16 gradient is uncorrelated with the fp32 one: PERF.md,
# Findings, and scripts/port_bf16_conditioning.py), so no bf16 update can
# meet a per-parameter pin there. Small branch gammas, as zero-init-residual
# recipes use (not zero, so that every conv's gradient stays nonzero), make
# the backward well conditioned, and each parameter's update is held to
# the round-19 gradient pins.
BRANCH_GAMMA = 0.1


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


def loss_inputs(batch, seed, device, n_classes=None, dim=DIM):
    """View-major unit features and ids for a [batch, 2] problem."""
    f = unit_features(2 * batch, dim, seed, device)
    if n_classes is None:
        base = torch.arange(batch)
    else:
        g = torch.Generator().manual_seed(seed + 1)
        base = torch.randint(0, n_classes, (batch,), generator=g)
    ids = base.repeat(2).to(device=device, dtype=torch.int32)
    gid = torch.arange(2 * batch, device=device, dtype=torch.int32)
    return f, ids, gid


# The loss parity cases: (case, batch, classes, dim, anchor rows, contrast
# columns), rows and columns each ``(lo, hi)`` of the 2 x batch view-major
# rows or None for all. a-c square at the recipe's D; d the sharded form:
# anchor rows 128..255 of N = 512 against all 512 columns (the row ids
# offset by 128), the column lse/cnt from the forward over all rows, as a
# sharded backward gets them; e N = 74 at D = 18 (no multiple of 4: the
# scalar load path; most column splits empty); f the smallest, nr = nc = 2:
# the first views of a batch of two against their second views (no self
# pair; each row has one positive of two columns; the column lse/cnt from
# the columns as anchors against the rows). Square, nr = nc = 2 leaves each
# row one live column: its positive (loss and dF exactly 0, so the pins
# have no scale) or not (cnt 0).
LOSS_CASES = (("a", 256, None, DIM, None, None), ("b", 256, 10, DIM, None, None),
              ("c", 37, None, DIM, None, None), ("d", 256, 10, DIM, (128, 256), None),
              ("e", 37, None, 18, None, None), ("f", 2, None, DIM, (0, 2), (2, 4)))


def loss_case(fused_loss, dev, batch, classes, dim, rows, cols, seed=1):
    """``(fwd_args, bwd_args)`` of one loss case (``LOSS_CASES``): the
    anchor rows against the contrast columns, and for the backward the
    plain forward's lse/cnt of the rows and of the columns."""
    f, ids, gid = loss_inputs(batch, seed, dev, classes, dim)
    r, c = slice(*(rows or (0, f.shape[0]))), slice(*(cols or (0, f.shape[0])))
    args = (f[r], f[c], ids[r], ids[c], gid[r], gid[c])
    if cols is None:  # the columns' statistics over every row
        _, lse, cnt = fused_loss.fused_rows_reference(f, f, ids, ids, gid, gid, TEMP, BASE_TEMP)
        lse_r, cnt_r, lse_c, cnt_c = lse[r], cnt[r], lse, cnt
    else:  # two blocks: each side's statistics against the other
        _, lse_r, cnt_r = fused_loss.fused_rows_reference(*args, TEMP, BASE_TEMP)
        _, lse_c, cnt_c = fused_loss.fused_rows_reference(
            *(args[i] for i in (1, 0, 3, 2, 5, 4)), TEMP, BASE_TEMP)
    coeff = (TEMP / BASE_TEMP) / f.shape[0]
    return args, args + (lse_r, lse_c, cnt_r, cnt_c, TEMP, coeff)


def loss_parity(fused_loss, dev):
    """The loss kernels against their plain forms at ``LOSS_CASES``: ``cnt``
    exact, ``loss_row``/``lse`` rtol 1e-5, ``dF`` atol 1e-5 x max|dF|.
    Returns the errors per (case, tensor)."""
    errors = {}
    for case, batch, classes, dim, rows, cols in LOSS_CASES:
        args, bwd_args = loss_case(fused_loss, dev, batch, classes, dim, rows, cols)
        got = fused_loss.fused_rows(*args, TEMP, BASE_TEMP)
        ref = fused_loss.fused_rows_reference(*args, TEMP, BASE_TEMP)
        d_got = fused_loss.fused_bwd(*bwd_args)
        d_ref = fused_loss.fused_bwd_reference(*bwd_args)
        torch.cuda.synchronize()
        n = 2 * batch
        shape = (f"N={n}" if rows is None else f"rows {rows[0]}..{rows[1] - 1} of N={n}"
                 + ("" if cols is None else f" against columns {cols[0]}..{cols[1] - 1}"))
        line = [f"case {case}: {shape} D={dim} "
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
        errors[(case, "dF_rel_l2")] = rel_l2(d_got, d_ref)
    print("bounds: cnt exact; loss_row, lse rtol 1e-5; dF atol 1e-5 x max|dF|")
    return errors


def loss_determinism(fused_loss, dev):
    """Two forward and two backward calls of the loss kernels on the same
    inputs, at N = 512 (case a) and in the sharded form (case d): every
    output bitwise equal, or raise. The splits combine in rank order and
    no kernel uses atomics."""
    for case, batch, classes, dim, rows, cols in (LOSS_CASES[0], LOSS_CASES[3]):
        args, bwd_args = loss_case(fused_loss, dev, batch, classes, dim, rows, cols)
        for entry, call, names in (
                ("loss_fwd", lambda: fused_loss.fused_rows(*args, TEMP, BASE_TEMP),
                 ("loss_row", "lse", "cnt")),
                ("loss_bwd", lambda: (fused_loss.fused_bwd(*bwd_args),), ("dF",))):
            first, second = call(), call()
            same = [torch.equal(a, b) for a, b in zip(first, second)]
            print(f"{entry} determinism case {case}: two calls bitwise equal on "
                  f"{sum(same)} of {len(same)} outputs")
            if not all(same):
                raise AssertionError(f"{entry} case {case}: outputs differ between two calls: "
                                     f"{[n for n, ok in zip(names, same) if not ok]}")


# the loss split's sizes: the recipe's N = 512 and ImageNet SimCLR's
# global batch of 4096 (N = 8192), both at D = 128
LOSS_SPLIT_ROWS = (512, 8192)


def host_ms_per_call(fn, calls=200):
    """The host's wall time per call of ``fn`` over ``calls`` back-to-back
    calls that are only enqueued (the device is synchronised before and
    after, outside the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def loss_split(fused_loss, dev, where):
    """One forward and one backward call of the loss kernels at each of
    ``LOSS_SPLIT_ROWS``: the device time per kernel name
    (:func:`device_times`), the CUDA-event time of back-to-back calls
    beside the plain form's, the wrapper's host time per call
    (:func:`host_ms_per_call`) and the bound. Returns ``{(direction, n):
    {"device_ms": ms or None, "ms": ..., "plain_ms": ..., "host_ms": ...}}``."""
    res = {}
    for n in LOSS_SPLIT_ROWS:
        f, ids, gid = loss_inputs(n // 2, seed=2, device=dev)
        args = (f, f, ids, ids, gid, gid)
        _, lse, cnt = fused_loss.fused_rows(*args, TEMP, BASE_TEMP)
        bwd_args = args + (lse, lse, cnt, cnt, TEMP, (TEMP / BASE_TEMP) / n)
        reps = dict(reps=100, rounds=5, warmup=10) if n <= 512 else dict(reps=10, rounds=3,
                                                                          warmup=2)
        bounds = loss_bounds(n, DIM)
        for direction, call, plain in (
                ("fwd", lambda: fused_loss.fused_rows(*args, TEMP, BASE_TEMP),
                 lambda: fused_loss.fused_rows_reference(*args, TEMP, BASE_TEMP)),
                ("bwd", lambda: fused_loss.fused_bwd(*bwd_args),
                 lambda: fused_loss.fused_bwd_reference(*bwd_args))):
            per = device_times(call)
            got = {"device_ms": sum(per.values()) if per else None,
                   "ms": cuda_time_ms(call, **reps), "plain_ms": cuda_time_ms(plain, **reps),
                   "host_ms": host_ms_per_call(call, calls=200 if n <= 512 else 20)}
            res[(direction, n)] = got
            names = (", ".join(f"{k} {v * 1e3:.2f} us" for k, v in sorted(per.items()))
                     if per else "not measured (the profiler shows no device time)")
            print(f"loss_{direction} split N={n} D={DIM}: device time (profiler, one call) "
                  f"{names}; CUDA events {got['ms'] * 1e3:.2f} us a call, plain form "
                  f"{got['plain_ms'] * 1e3:.2f} us; wrapper host time {got['host_ms'] * 1e3:.2f} "
                  f"us a call; bound {bounds[direction][0] * 1e3:.2f} us "
                  f"({bounds[direction][1]}) {where}", flush=True)
        del f, ids, gid, args, lse, cnt, bwd_args
        torch.cuda.empty_cache()
    return res


def loss_bounds(n, d):
    """``{"fwd": (ms, by), "bwd": (ms, by)}`` of the square loss at ``n``
    rows of depth ``d``: each input read once, each output written once
    (features, ids and global ids in, three [n] rows out; features, ids,
    global ids, lse and cnt in, [n, d] out), FMA FLOPs of the logits
    (forward) and of the logits plus h @ F (backward)."""
    return {"fwd": bound(2 * n * n * d, n * d * 4 + 2 * n * 4 + 3 * n * 4),
            "bwd": bound(4 * n * n * d, n * d * 4 + 4 * n * 4 + n * d * 4)}


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


def bound(flops, nbytes, peak=PEAK_FP32_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rand(shape, gen, dev, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen) * scale + shift).to(dev)


def stem_inputs(n, h, w, cin, cout, dev, seed, margin=0.0):
    """x, the HWIO kernel, gamma and beta; ``margin`` shifts beta, so the
    ReLU inputs sit away from zero."""
    g = torch.Generator().manual_seed(seed)
    return (rand((n, h, w, cin), g, dev), rand((3, 3, cin, cout), g, dev, 0.3),
            rand((cout,), g, dev, 0.2, 1.0), rand((cout,), g, dev, 0.1, margin))


def bottleneck_inputs(n, h, w, cin, p, stride, dev, seed, margin=0.0):
    """x, the three main kernels with their BN affines (Kaiming-scale
    weights, gammas near 1), and the shortcut triple or None. ``margin``
    shifts the BN betas before each ReLU; in a projection block the two
    biases that meet in the last ReLU take 5/8 of it each (that ReLU's
    input is the sum of two normalized terms, so its spread is wider)."""
    g = torch.Generator().manual_seed(seed)
    c4 = 4 * p
    proj = stride != 1 or cin != c4
    last = 0.625 * margin if proj else margin
    args = (rand((n, h, w, cin), g, dev),
            rand((cin, p), g, dev, (2 / p) ** 0.5), rand((p,), g, dev, 0.2, 1.0),
            rand((p,), g, dev, 0.1, margin),
            rand((3, 3, p, p), g, dev, (2 / (9 * p)) ** 0.5), rand((p,), g, dev, 0.2, 1.0),
            rand((p,), g, dev, 0.1, margin),
            rand((p, c4), g, dev, (2 / c4) ** 0.5), rand((c4,), g, dev, 0.2, 1.0),
            rand((c4,), g, dev, 0.1, last))
    short = None
    if proj:
        short = (rand((cin, c4), g, dev, (2 / c4) ** 0.5), rand((c4,), g, dev, 0.2, 1.0),
                 rand((c4,), g, dev, 0.1, last))
    return args, short


def block_inputs(n, h, w, cin, c, stride, dev, seed, margin=0.0):
    """x and the BasicBlock's two 3x3 kernels with their BN affines
    (Kaiming-scale weights, gammas near 1), and the shortcut triple
    (projection geometries) or None. ``margin`` shifts the BN betas before
    each ReLU as in :func:`bottleneck_inputs`."""
    g = torch.Generator().manual_seed(seed)
    proj = stride != 1 or cin != c
    last = 0.625 * margin if proj else margin
    args = (rand((n, h, w, cin), g, dev),
            rand((3, 3, cin, c), g, dev, (2 / (9 * c)) ** 0.5), rand((c,), g, dev, 0.2, 1.0),
            rand((c,), g, dev, 0.1, margin),
            rand((3, 3, c, c), g, dev, (2 / (9 * c)) ** 0.5), rand((c,), g, dev, 0.2, 1.0),
            rand((c,), g, dev, 0.1, last))
    short = None
    if proj:
        short = (rand((cin, c), g, dev, (2 / c) ** 0.5), rand((c,), g, dev, 0.2, 1.0),
                 rand((c,), g, dev, 0.1, last))
    return args, short


def elem(rtol, atol):
    return ("elem", rtol, atol)


def rel_l2(got, ref):
    """``||got - ref|| / ||ref||`` in float64."""
    ref = ref.double()
    return ((got.double() - ref).norm() / ref.norm()).item()


def bf16_measure(got, ref):
    """``(max |got - ref| / max |ref|, cosine)`` in float64."""
    a, b = got.double().flatten(), ref.double().flatten()
    scaled = ((a - b).abs().max() / (b.abs().max() + 1e-30)).item()
    cos = (a @ b / (a.norm() * b.norm() + 1e-30)).item()
    return scaled, cos


def bf16_ok(kind, scaled, cos):
    """The round-19 pin of a tensor of ``kind`` 'value', 'stats' or 'grad'."""
    if kind == "value":
        return scaled <= BF16_VAL_SCALED and cos >= BF16_VAL_COS
    if kind == "stats":
        return scaled <= BF16_STATS_SCALED
    return cos >= BF16_GRAD_COS and scaled <= BF16_GRAD_SCALED


class Parity:
    """Collects every compared tensor's error, prints one line per case, and
    raises at the end if any tensor broke its pin (so one run shows all).
    ``ref`` is the yardstick tensor or an ``(exact, plain)`` pair of the
    yardstick and another plain form. A pin is ``("elem", rtol, atol)``
    (elementwise against ``exact``), ``("l2", bound)`` (relative L2 error
    against ``exact`` at most ``bound``), ``("l2_vs", factor, floor)`` (at
    most ``factor`` times plain's own, and at least ``floor``), or
    ``("r19", kind)``: the round-19 pin of a tensor of ``kind`` (see
    :func:`bf16_ok`). The L2 pins print plain's error beside the kernel's;
    an ``"l2"`` pin with a third entry ``kind`` holds the round-19 pin of
    that kind as well. A gradient that breaks an ``"r19"`` pin only in the
    halves (cosine, scaled max error) that ``plain`` breaks too is excused:
    printed beside plain's reading and counted in ``excused``, not pinned.
    ``max_abs`` keeps each kernel's largest elementwise error (against
    ``exact`` for the L2 pins; none for ``"r19"``), ``max_rel_l2`` its
    largest relative L2 error under an L2 pin, ``worst`` per ``(kernel,
    pin, kind)`` of the bf16 pins the largest scaled error, the lowest
    cosine, the largest relative L2 error, and of the tensors read how
    many plain breaks the L2 pin on, and how many there were."""

    def __init__(self):
        self.failures, self.excused = [], []
        self.max_abs, self.max_rel_l2, self.worst = {}, {}, {}

    def _worst(self, key, scaled, cos, l2=0.0, plain_breaks=False):
        w = self.worst.get(key, (0.0, 1.0, 0.0, 0, 0))
        self.worst[key] = (max(w[0], scaled), min(w[1], cos), max(w[2], l2),
                           w[3] + plain_breaks, w[4] + 1)

    def case(self, kernel, label, pairs):
        parts = []
        for name, got, ref, pin in pairs:
            if got is None:
                continue
            exact, plain = ref if isinstance(ref, tuple) else (ref, None)
            scale = exact.abs().max().item()
            if pin[0] == "elem":
                diff = (got - exact).abs()
                err = diff.max().item()
                ok = (diff - (pin[2] + pin[1] * exact.abs())).max().item() <= 0.0
                parts.append(f"{name} {err:.2e}/{scale:.2e}")
                self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0), err)
            elif pin[0] == "r19":
                err, cos = bf16_measure(got, exact)
                ok = bf16_ok(pin[1], err, cos)
                parts.append(f"{name} {err:.2e}" + ("" if pin[1] == "stats" else f" cos {cos:.6f}"))
                if not ok and plain is not None and pin[1] == "grad":
                    p_err, p_cos = bf16_measure(plain, exact)
                    if ((cos >= BF16_GRAD_COS or p_cos < BF16_GRAD_COS)
                            and (err <= BF16_GRAD_SCALED or p_err > BF16_GRAD_SCALED)):
                        parts[-1] += f" (plain {p_err:.2e} cos {p_cos:.6f}: excused)"
                        self.excused.append(f"{kernel} {label} {name}: kernel {err:.3e} cos "
                                            f"{cos:.6f}, plain {p_err:.3e} cos {p_cos:.6f}")
                        continue
                self._worst((kernel, "r19", pin[1]), err, cos)
            else:
                err = rel_l2(got, exact)
                plain_err = rel_l2(plain, exact)
                bound = pin[1] if pin[0] == "l2" else max(pin[1] * plain_err, pin[2])
                ok = err <= bound
                abs_err = (got.double() - exact.double()).abs().max().item()
                parts.append(f"{name} relL2 {err:.2e} (plain {plain_err:.2e}) "
                             f"abs {abs_err:.2e}/{scale:.2e}")
                self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0), abs_err)
                self.max_rel_l2[kernel] = max(self.max_rel_l2.get(kernel, 0.0), err)
                if pin[0] == "l2" and len(pin) > 2:
                    scaled, cos = bf16_measure(got, exact)
                    ok = ok and bf16_ok(pin[2], scaled, cos)
                    parts[-1] += f" scaled {scaled:.2e} cos {cos:.6f}"
                    self._worst((kernel, "l2", pin[2]), scaled, cos, err, plain_err > bound)
            if not ok:
                self.failures.append(f"{kernel} {label} {name}: {pin} err {err:.3e} "
                                     f"max|ref| {scale:.3e}")
        print(f"{kernel} {label}: " + ", ".join(parts), flush=True)

    def raise_if_failed(self):
        if self.failures:
            raise AssertionError("kernel parity failed:\n" + "\n".join(self.failures))


def _f64(args):
    return [None if a is None else tuple(t.double() for t in a) if isinstance(a, tuple)
            else a.double() if isinstance(a, torch.Tensor) else a for a in args]


# ragged rows (360 and 90 a call, not multiples of the 128-row tile),
# channel counts that leave a ragged last 64-channel tile (160) or are no
# multiple of 4 (10, 40: the kernels' scalar load paths)
RAGGED_BOTTLENECKS = (
    ("ragged proj s2 [6,10,6,24] P=40", (6, 10, 6, 24, 40, 2)),
    ("ragged identity [6,10,6,40] P=10", (6, 10, 6, 40, 10, 1)),
)
# odd h/w at stride 1, cin != c at stride 1, channel counts no multiple of
# 4 (10, 6) or leaving a ragged 64-channel tile (72), and row counts that
# leave a partial 128-row tile (378, 360, 315, 75, 48)
RAGGED_BLOCKS = (
    ("ragged identity [6,9,7,10]", (6, 9, 7, 10, 10, 1)),
    ("ragged identity [6,10,6,72]", (6, 10, 6, 72, 72, 1)),
    ("ragged proj s1 [5,7,9,12]->20", (5, 7, 9, 12, 20, 1)),
    ("ragged proj s2 [5,10,6,24]->40", (5, 10, 6, 24, 40, 2)),
    ("ragged proj s2 [3,8,8,6]->10", (3, 8, 8, 6, 10, 2)),
)
# (label, (n, h, w, cin, cout), margin, seed of its own upstream-gradient
# draw or None): the recipe's stem, and ragged ones. [5,7,9,5]->72 has 315
# rows (a 59-row last tile), K = 45 in two chunks, the first straddling a
# tap, cin no multiple of 4 and a 72-wide output past one 64-channel block;
# it draws its gradient from a generator of its own, so every case after
# the stem's draws what it drew before the case was added.
STEM_CASES = (("recipe [512,32,32,3]", (512, 32, 32, 3, 64), 0.0, None),
              ("recipe [512,32,32,3] margin", (512, 32, 32, 3, 64), MARGIN, None),
              ("ragged [6,10,6,3]", (6, 10, 6, 3, 64), 0.0, None),
              ("ragged [5,7,9,5]->72", (5, 7, 9, 5, 72), 0.0, 23))
STEM_OUT = ("out", "mean", "var")
STEM_GRADS = ("dx", "dk", "dgamma", "dbeta")
BOT_OUT = ("out", "m1", "v1", "m2", "v2", "m3", "v3", "m_sc", "v_sc")
BOT_GRADS = ("dx", "dk1", "dg1", "db1", "dk2", "dg2", "db2", "dk3", "dg3", "db3",
             "dk_sc", "dg_sc", "db_sc")
BLOCK_OUT = ("out", "m1", "v1", "m2", "v2", "m_sc", "v_sc")
BASIC_GRADS = ("dx", "dk1", "dk2", "dg1", "db1", "dg2", "db2")
PROJ_GRADS = ("dx", "dk1", "dk2", "dk_sc", "dg1", "db1", "dg2", "db2", "dg_sc", "db_sc")


def model_sites(model, rows=512, size=32):
    """The recipe's block sites of ``model`` as ``(name, kind, (n, h, w,
    cin, width, stride))``, kind 'bottleneck', 'basic' or 'proj'."""
    from simclr_pytorch_distributed_tpu_torch.models.resnet import fused_site_plan
    return [(s["name"], s["kind"], (rows, s["h"], s["w"], s["in_channels"], s["width"],
                                    s["stride"]))
            for s in fused_site_plan(model, rows, size) if s["kind"] != "stem"]


def in_dtype(tensors, slots, dtype):
    """``tensors`` with the entries at ``slots`` (x and the conv kernels) in
    the compute dtype ``dtype``; None stays None."""
    if tensors is None:
        return None
    return tuple(t.to(dtype) if i in slots else t for i, t in enumerate(tensors))


def site_calls(fc, family, geo, dev, seed, margin=0.0, dtype=torch.float32):
    """One call at ``geo``: ``(x, kind, fwd, bwd)`` with ``fwd`` the
    ``(kernel, plain)`` forward calls and ``bwd(moments, gout)`` giving
    ``(args, kernel, plain, gradient names)`` of the backward. ``family``
    is 'stem' (``geo`` ``(n, h, w, cin, cout)``; ``dx`` off the recipe's
    shape only, as on the main path), 'bottleneck' or 'block' (a
    BasicBlock: identity or projection, as the geometry says). ``dtype``
    is the compute dtype: x and the kernels are drawn in fp32 and cast to
    it."""
    if family == "stem":  # geo (n, h, w, cin, cout)
        x, k, gam, bet = in_dtype(stem_inputs(*geo, dev, seed=seed, margin=margin), (0, 1), dtype)
        fwd = (lambda: fc.stem_fwd(x, k, gam, bet, EPS),
               lambda: fc.stem_fwd_reference(x, k, gam, bet, EPS))
        need_dx = geo[0] != 512  # the main path needs no dx of the images

        def bwd(moments, gout):
            bargs = (x, k, gam, bet, *moments, gout, EPS)
            return (bargs, functools.partial(fc.stem_bwd, need_dx=need_dx),
                    functools.partial(fc.stem_bwd_reference, need_dx=need_dx), STEM_GRADS)
        return x, "stem", fwd, bwd
    stride = geo[5]
    if family == "bottleneck":
        args, short = bottleneck_inputs(*geo, dev, seed=seed, margin=margin)
        args, short = in_dtype(args, (0, 1, 4, 7), dtype), in_dtype(short, (0,), dtype)
        fwd = (lambda: fc.bottleneck_fwd(*args, short, stride, EPS),
               lambda: fc.bottleneck_fwd_reference(*args, short, stride, EPS))

        def bwd(moments, gout):
            short_b = short + tuple(moments[6:8]) if short is not None else None
            bargs = (*args, short_b, *moments[:6], gout, stride, EPS)
            return bargs, fc.bottleneck_bwd, fc.bottleneck_bwd_reference, BOT_GRADS
        return args[0], "bottleneck", fwd, bwd
    args, short = block_inputs(*geo, dev, seed=seed, margin=margin)
    args, short = in_dtype(args, (0, 1, 4), dtype), in_dtype(short, (0,), dtype)
    if short is None:
        fwd = (lambda: fc.basic_fwd(*args, EPS), lambda: fc.basic_block_fwd_reference(*args, EPS))

        def bwd(moments, gout):
            bargs = (*args, *moments, gout, EPS)
            return bargs, fc.basic_bwd, fc.basic_block_bwd_reference, BASIC_GRADS
        return args[0], "basic", fwd, bwd
    fwd = (lambda: fc.proj_fwd(*args, *short, stride, EPS),
           lambda: fc.proj_block_fwd_reference(*args, *short, stride, EPS))

    def bwd(moments, gout):
        bargs = (*args, *short, *moments, gout, stride, EPS)
        return bargs, fc.proj_bwd, fc.proj_block_bwd_reference, PROJ_GRADS
    return args[0], "proj", fwd, bwd


def parity_cases(sites, ragged):
    """``(label, geometry, margin)``: every distinct geometry of ``sites``
    with main-path inputs, then with ReLU-margin inputs, then the
    ``ragged`` shapes."""
    names = {}
    for name, _, geo in sites:
        names.setdefault(geo, []).append(name)
    recipe = [(f"{'/'.join(n)} [{g[0]},{g[1]},{g[2]},{g[3]}] width {g[4]} s{g[5]}", g)
              for g, n in names.items()]
    cases = [(label, geo, 0.0) for label, geo in recipe]
    cases += [(label + " margin", geo, MARGIN) for label, geo in recipe]
    return cases + [(label, geo, 0.0) for label, geo in ragged]


def block_parity(dev, parity, family, sites, ragged, seed, gen):
    """One family's block kernels against their plain forms, forward
    (value, moments) and backward (every gradient), at every distinct
    geometry of ``sites`` (main-path inputs, and inputs with ReLU margin)
    and at the ``ragged`` shapes. ``gen`` draws the output gradients."""
    from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc
    for label, geo, margin in parity_cases(sites, ragged):
        _, kind, fwd, bwd = site_calls(fc, family, geo, dev, seed, margin)
        got, ref = fwd[0](), fwd[1]()
        out_names = BOT_OUT if kind == "bottleneck" else BLOCK_OUT
        parity.case(f"fused_{kind}_fwd", label, [
            (name, a, b, elem(VAL_RTOL, VAL_ATOL) if name == "out" else elem(STAT_RTOL, STAT_ATOL))
            for name, a, b in zip(out_names, got, ref)])
        gout = rand(tuple(ref[0].shape), gen, dev)
        bargs, kernel, plain_fn, grad_names = bwd(ref[1:], gout)
        got, plain = kernel(*bargs), plain_fn(*bargs)
        refs, pin = plain, elem(GRAD_RTOL, GRAD_ATOL)
        if geo[0] == 512:  # a recipe site
            exact = plain_fn(*_f64(bargs))
            refs = list(zip(exact, plain))
            pin = ("l2_vs", GRAD_VS_PLAIN, GRAD_L2_FLOOR) if margin else ("l2", GRAD_REL_L2)
        exempt = MARGIN_EXEMPT.get(f"fused_{kind}_bwd", ()) if margin else ()
        parity.case(f"fused_{kind}_bwd", label, [
            (name, a, b, pin) for name, a, b in zip(grad_names, got, refs) if name not in exempt])
        del fwd, bwd, got, ref, refs, plain, gout, bargs
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


def stem_gen(seed, shared):
    """The generator a stem case draws its upstream gradient from: its own
    (``seed``) or the one the parity phase shares (seed None)."""
    return shared if seed is None else torch.Generator().manual_seed(seed)


def stem_parity(dev, parity, g):
    """The stem kernels against their plain forms at ``STEM_CASES``; ``g``
    draws the upstream gradients of the cases without a seed of their own."""
    from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc
    for label, geo, margin, gseed in STEM_CASES:
        recipe = geo[0] == 512
        _, _, fwd, bwd = site_calls(fc, "stem", geo, dev, seed=1, margin=margin)
        got, ref = fwd[0](), fwd[1]()
        parity.case("fused_stem_fwd", label, [
            (name, a, b, elem(VAL_RTOL, VAL_ATOL) if name == "out" else elem(STAT_RTOL, STAT_ATOL))
            for name, a, b in zip(STEM_OUT, got, ref)])
        gout = rand(tuple(ref[0].shape), stem_gen(gseed, g), dev)
        bargs, kernel, plain_fn, names = bwd(ref[1:], gout)
        got, plain = kernel(*bargs), plain_fn(*bargs)
        refs, pin = plain, elem(GRAD_RTOL, GRAD_ATOL)
        if recipe:
            exact = plain_fn(*_f64(bargs))
            refs = list(zip(exact, plain))
            pin = ("l2_vs", GRAD_VS_PLAIN, GRAD_L2_FLOOR) if margin else ("l2", GRAD_REL_L2)
        parity.case("fused_stem_bwd", label, [
            (name, a, b, pin) for name, a, b in zip(names, got, refs)])


def conv_parity(dev, parity):
    """The stem, Bottleneck, BasicBlock and projection-block kernels
    against their plain forms at every distinct geometry of the ResNet-50
    and ResNet-18 recipe's sites and at ragged shapes."""
    g = torch.Generator().manual_seed(7)
    stem_parity(dev, parity, g)
    block_parity(dev, parity, "bottleneck", model_sites("resnet50"), RAGGED_BOTTLENECKS, 2, g)
    block_parity(dev, parity, "block", model_sites("resnet18"), RAGGED_BLOCKS, 5,
                 torch.Generator().manual_seed(9))


def bf16_case(parity, kernel, label, names, got, r16, r32, kinds):
    """One bf16 call against both yardsticks. Against the bf16 plain form
    ``r16`` each tensor is pinned in relative L2 (``BF16_REL_L2``, the fp32
    plain form's distance printed beside it) and at the round-19 pin;
    against the fp32 plain form ``r32`` at the round-19 pin, a gradient
    excused where the bf16 plain form breaks the same halves of it."""
    rows = [row for row in zip(names, got, r16, r32, kinds) if row[1] is not None]
    parity.case(kernel, f"{label} vs bf16 plain", [
        (name, a, (b, c), ("l2", BF16_REL_L2[kind], kind)) for name, a, b, c, kind in rows])
    parity.case(kernel, f"{label} vs fp32 plain", [
        (name, a, (c, b) if kind == "grad" else c, ("r19", kind))
        for name, a, b, c, kind in rows])


def stem_bf16_parity(dev, parity, gen):
    """``stem_fwd_bf16`` / ``stem_bwd_bf16`` against the bf16 and the fp32
    plain forms (:func:`bf16_case`) at ``STEM_CASES``; ``gen`` draws the
    upstream gradients of the cases without a seed of their own."""
    from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc
    bf16 = torch.bfloat16
    for label, geo, margin, gseed in STEM_CASES:
        _, _, fwd, bwd = site_calls(fc, "stem", geo, dev, seed=1, margin=margin, dtype=bf16)
        _, _, fwd32, bwd32 = site_calls(fc, "stem", geo, dev, seed=1, margin=margin)
        got, r16, r32 = fwd[0](), fwd[1](), fwd32[1]()
        bf16_case(parity, "fused_stem_fwd_bf16", label, STEM_OUT, got, r16, r32,
                  ("value", "stats", "stats"))
        gout = rand(tuple(got[0].shape), stem_gen(gseed, gen), dev).to(bf16)
        bargs, kernel, plain_fn, names = bwd(r16[1:], gout)
        bargs32 = bwd32(r32[1:], gout.float())[0]
        got, g16, g32 = kernel(*bargs), plain_fn(*bargs), plain_fn(*bargs32)
        bf16_case(parity, "fused_stem_bwd_bf16", label, names, got, g16, g32, ("grad",) * 4)


def bf16_parity(dev, parity):
    """The eight bf16 entry points against their bf16 plain forms and
    against the fp32 plain forms (:func:`bf16_case`), at the cases
    :func:`conv_parity` runs (every distinct rn50 and rn18 recipe geometry
    with main-path and with ReLU-margin inputs, and the ragged shapes). x
    and the kernels are drawn in fp32 and cast to bf16 for the kernel and
    the bf16 plain form; the upstream gradient is drawn in bf16 and widened
    for the fp32 form; each backward takes the moments of its own
    yardstick's forward."""
    from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(17)
    stem_bf16_parity(dev, parity, gen)
    for family, model, ragged, seed in (("bottleneck", "resnet50", RAGGED_BOTTLENECKS, 2),
                                        ("block", "resnet18", RAGGED_BLOCKS, 5)):
        for label, geo, margin in parity_cases(model_sites(model), ragged):
            _, kind, fwd, bwd = site_calls(fc, family, geo, dev, seed, margin, bf16)
            _, _, fwd32, bwd32 = site_calls(fc, family, geo, dev, seed, margin)
            got, r16, r32 = fwd[0](), fwd[1](), fwd32[1]()
            out_names = BOT_OUT if kind == "bottleneck" else BLOCK_OUT
            bf16_case(parity, f"fused_{kind}_fwd_bf16", label, out_names, got, r16, r32,
                      ("value",) + ("stats",) * (len(got) - 1))
            gout = rand(tuple(r16[0].shape), gen, dev).to(bf16)
            bargs, kernel, plain_fn, grad_names = bwd(r16[1:], gout)
            bargs32 = bwd32(r32[1:], gout.float())[0]
            got, g16, g32 = kernel(*bargs), plain_fn(*bargs), plain_fn(*bargs32)
            exempt = MARGIN_EXEMPT.get(f"fused_{kind}_bwd_bf16", ()) if margin else ()
            keep = [i for i in range(len(got)) if grad_names[i] not in exempt]
            bf16_case(parity, f"fused_{kind}_bwd_bf16", label, [grad_names[i] for i in keep],
                      *([t[i] for i in keep] for t in (got, g16, g32)), ("grad",) * len(keep))
            del fwd, bwd, fwd32, bwd32, got, r16, r32, g16, g32, gout, bargs, bargs32
            torch.cuda.empty_cache()
    torch.cuda.synchronize()


def bottleneck_work(n, h, w, cin, p, stride, act=4):
    """``(fwd_flops, bwd_flops, fwd_bytes, bwd_bytes)`` of one Bottleneck
    call: 2 FLOPs per multiply-add of the four convs; the backward
    recomputes the forward convs (its inputs are x, the weights and the
    moments), then takes the data and weight gradients, so 3x. Bytes:
    each input read once, each output written once; activations, kernels
    and their gradients ``act`` bytes an element (4 fp32, 2 bf16), the
    per-channel rows 4."""
    ho, wo = h // stride, w // stride
    m1, m2, c4 = n * h * w, n * ho * wo, 4 * p
    proj = stride != 1 or cin != c4
    fwd = 2 * (m1 * cin * p + m2 * 9 * p * p + m2 * p * c4 + (m2 * cin * c4 if proj else 0))
    weights = cin * p + 9 * p * p + p * c4 + (cin * c4 if proj else 0)
    rows = 2 * p + 2 * p + 2 * c4 + (2 * c4 if proj else 0)  # gammas, betas
    moments = rows
    fwd_bytes = act * (m1 * cin + weights + m2 * c4) + 4 * (rows + moments)
    bwd_bytes = (act * (m1 * cin + weights + m2 * c4) + 4 * (rows + moments)  # inputs
                 + act * (m1 * cin + weights) + 4 * rows)                  # dx, dW, dgamma/dbeta
    return fwd, 3 * fwd, fwd_bytes, bwd_bytes


def block_work(n, h, w, cin, c, stride, act=4):
    """``(fwd_flops, bwd_flops, fwd_bytes, bwd_bytes)`` of one BasicBlock
    call, counted as :func:`bottleneck_work` counts: the two 3x3 convs and
    the 1x1/s shortcut (projection), the backward 3x."""
    m = n * (h // stride) * (w // stride)
    proj = stride != 1 or cin != c
    weights = 9 * cin * c + 9 * c * c + (cin * c if proj else 0)
    fwd = 2 * m * weights
    rows = (6 if proj else 4) * c  # gammas, betas
    moments = rows
    fwd_bytes = act * (n * h * w * cin + weights + m * c) + 4 * (rows + moments)
    bwd_bytes = (act * (n * h * w * cin + weights + m * c) + 4 * (rows + moments)  # inputs
                 + act * (n * h * w * cin + weights) + 4 * rows)  # dx, dW, dgamma/dbeta
    return fwd, 3 * fwd, fwd_bytes, bwd_bytes


def stem_timing(dev, where, dtype=torch.float32):
    """CUDA-event times (ms) of the stem kernels at the recipe's shape in
    compute dtype ``dtype``,
    beside their plain forms and, as context, the eager chain they replace
    (cuDNN conv + BatchNorm2d + ReLU, forward and forward+backward)."""
    from torch import nn
    from simclr_pytorch_distributed_tpu_torch.models.norm import batch_norm
    from simclr_pytorch_distributed_tpu_torch.models.resnet import conv as conv_of
    from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc
    reps = dict(reps=2, rounds=3, warmup=1)
    x, k, g, b = stem_inputs(512, 32, 32, 3, 64, dev, seed=3)
    x, k = x.to(dtype), k.to(dtype)
    y, m, v = fc.stem_fwd(x, k, g, b, EPS)
    gout = torch.randn_like(y)
    conv_m = nn.Conv2d(3, 64, 3, 1, 1, bias=False).to(dev, memory_format=torch.channels_last)
    bn = nn.BatchNorm2d(64).to(dev)
    xe, ge = x.permute(0, 3, 1, 2), gout.permute(0, 3, 1, 2)

    def conv(t):
        return conv_m(t) if dtype == torch.float32 else conv_of(conv_m, t)

    def bn_(t):
        return bn(t) if dtype == torch.float32 else batch_norm(bn, t)
    stem = {
        "fwd": cuda_time_ms(lambda: fc.stem_fwd(x, k, g, b, EPS), **reps),
        "fwd_plain": cuda_time_ms(lambda: fc.stem_fwd_reference(x, k, g, b, EPS), **reps),
        "bwd": cuda_time_ms(
            lambda: fc.stem_bwd(x, k, g, b, m, v, gout, EPS, need_dx=False), **reps),
        "bwd_plain": cuda_time_ms(
            lambda: fc.stem_bwd_reference(x, k, g, b, m, v, gout, EPS, need_dx=False), **reps),
        "eager_fwd": cuda_time_ms(lambda: torch.relu(bn_(conv(xe))), **reps),
        "eager_fwd_bwd": cuda_time_ms(lambda: torch.relu(bn_(conv(xe))).backward(ge), **reps),
    }
    tag = "" if dtype == torch.float32 else " bf16"
    print(f"stem{tag} [512,32,32,3]->64 ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stem.items()) + f" {where}", flush=True)
    return stem


def sites_timing(dev, where, family, sites, seed, dtype=torch.float32):
    """CUDA-event times (ms) of one family's block kernels at each of
    ``sites`` in compute dtype ``dtype``, beside their plain forms and, as
    context, the eager module
    each replaces (``Bottleneck`` or ``BasicBlock``: cuDNN convs +
    BatchNorm2d + ReLU, forward and forward+backward; under bf16 on a bf16
    input, the weights cast per forward). Sites that share a
    geometry share one measurement. Returns the per-site list and, per
    kind, the sums over its sites (one step's worth)."""
    from simclr_pytorch_distributed_tpu_torch.models.resnet import BasicBlock, Bottleneck
    from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc
    module, work = (Bottleneck, bottleneck_work) if family == "bottleneck" else (BasicBlock,
                                                                                  block_work)
    reps = dict(reps=2, rounds=3, warmup=1)
    per_geo = {}
    for _, _, geo in sites:
        if geo in per_geo:
            continue
        x, _, fwd, bwd = site_calls(fc, family, geo, dev, seed, dtype=dtype)
        r = fwd[0]()
        gout = torch.randn_like(r[0])
        bargs, kernel, plain_fn, _ = bwd(r[1:], gout)
        blk = module(*geo[3:]).to(dev, memory_format=torch.channels_last).train()
        xe = x.permute(0, 3, 1, 2).detach().requires_grad_()
        ge = gout.permute(0, 3, 1, 2)
        per_geo[geo] = {
            "fwd": cuda_time_ms(fwd[0], **reps),
            "fwd_plain": cuda_time_ms(fwd[1], **reps),
            "bwd": cuda_time_ms(lambda: kernel(*bargs), **reps),
            "bwd_plain": cuda_time_ms(lambda: plain_fn(*bargs), **reps),
            "eager_fwd": cuda_time_ms(lambda: blk(xe), **reps),
            "eager_fwd_bwd": cuda_time_ms(lambda: blk(xe).backward(ge), **reps),
        }
        del x, fwd, bwd, r, gout, bargs, blk, xe, ge
        torch.cuda.empty_cache()
    res = {"sites": []}
    bf16 = dtype == torch.bfloat16
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS
    for name, kind, geo in sites:
        fwd_f, bwd_f, fwd_b, bwd_b = work(*geo, act=2 if bf16 else 4)
        res["sites"].append({"site": name, "kind": kind, "geometry": list(geo), **per_geo[geo],
                             "bound_fwd": bound(fwd_f, fwd_b, peak),
                             "bound_bwd": bound(bwd_f, bwd_b, peak)})
        site = res["sites"][-1]
        print(f"{kind}{' bf16' if bf16 else ''} {name} {geo} ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in per_geo[geo].items())
              + f"; bound fwd {site['bound_fwd'][0]:.3f} bwd {site['bound_bwd'][0]:.3f}"
              + f" {where}", flush=True)
    keys = ("fwd", "fwd_plain", "bwd", "bwd_plain", "eager_fwd", "eager_fwd_bwd")
    for kind in sorted({site["kind"] for site in res["sites"]}):
        mine = [site for site in res["sites"] if site["kind"] == kind]
        res[kind] = {key: sum(site[key] for site in mine) for key in keys}
        print(f"{kind}{' bf16' if bf16 else ''}, sum over the {len(mine)} sites (one step) ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in res[kind].items()) + f" {where}")
    return res


def summed_bound(sites, direction):
    """``(ms, by)``: the sum of the sites' bounds, and the kind that bounds
    the larger share of it."""
    total = sum(site[f"bound_{direction}"][0] for site in sites)
    by = max(("operations", "bytes"), key=lambda kind: sum(
        site[f"bound_{direction}"][0] for site in sites if site[f"bound_{direction}"][1] == kind))
    return total, by


def kernel_group(name):
    """'gemm' for a convolution's or a weight gradient's device kernel (a
    stem pass, which recomputes the stem's conv, among them), else
    'elementwise' (BN passes, partial sums, the dW combine, copies)."""
    return ("gemm" if "gemm" in name or "wgrad" in name or name.startswith("stem_kernel")
            else "elementwise")


def short_kernel_name(name):
    """A device kernel's name without its namespace and argument list:
    ``conv_gemm_kernel<true>``."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    if head.startswith("void "):
        head = head[5:]
    return head.split("::")[-1].strip()


# each family's determinism check: the recipe's stem and the ragged one of
# STEM_CASES (with dx); one recipe geometry per stride of the blocks: a
# ResNet-50 identity Bottleneck and its stride-2 projection, a ResNet-18
# identity BasicBlock and its stride-2 projection block
DETERMINISM_GEOMETRIES = {
    "stem": ((512, 32, 32, 3, 64), (5, 7, 9, 5, 72)),
    "bottleneck": ((512, 16, 16, 512, 128, 1), (512, 16, 16, 512, 256, 2)),
    "block": ((512, 16, 16, 128, 128, 1), (512, 32, 32, 64, 128, 2)),
}


def determinism(dev, family):
    """Two forward calls and two backward calls of ``family``'s entry
    points on the same inputs, in each compute dtype, at each of its
    ``DETERMINISM_GEOMETRIES``: every output bitwise equal, or raise. The
    kernels use no atomics and combine partial sums in a fixed order."""
    from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc
    for geo in DETERMINISM_GEOMETRIES[family]:
        for dtype in (torch.float32, torch.bfloat16):
            _, kind, fwd, bwd = site_calls(fc, family, geo, dev, seed=8, dtype=dtype)
            r, r_again = fwd[0](), fwd[0]()
            bargs, kernel, _, names = bwd(r[1:], torch.randn_like(r[0]))
            out_names = {"stem": STEM_OUT, "bottleneck": BOT_OUT}.get(kind, BLOCK_OUT)
            for entry, first, second, what in (
                    (f"{kind}_fwd", r, r_again, out_names),
                    (f"{kind}_bwd", kernel(*bargs), kernel(*bargs), names)):
                same = [a is b is None or (a is not None and b is not None and torch.equal(a, b))
                        for a, b in zip(first, second)]
                print(f"{entry} determinism {geo} {dtype}: two calls bitwise equal on "
                      f"{sum(same)} of {len(same)} outputs")
                if not all(same):
                    raise AssertionError(
                        f"{entry} {geo} {dtype}: outputs differ between two calls: "
                        f"{[n for n, ok in zip(what, same) if not ok]}")
            del fwd, bwd, r, r_again, bargs, first, second
            torch.cuda.empty_cache()


def device_times(call):
    """``{kernel name: ms}`` of one ``call`` traced by ``torch.profiler``
    (``key_averages()``, self device time), or ``{}`` when the profiler
    shows no device time. A trace now and then comes back empty or short
    of some kernels (one read 0.12 of a call's 1.7 ms): three traces, the
    fullest kept."""
    from torch.profiler import ProfilerActivity, profile
    per = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        trace = {}
        for avg in prof.key_averages():
            us = getattr(avg, "self_device_time_total", None)
            if us is None:
                us = getattr(avg, "self_cuda_time_total", 0.0)
            if us > 0:
                name = short_kernel_name(avg.key)
                trace[name] = trace.get(name, 0.0) + us / 1e3
        if sum(trace.values()) > sum(per.values()):
            per = trace
    return per


def conv_split(dev, where, family, direction, dtype=torch.float32):
    """One forward (``direction`` 'fwd') or backward ('bwd') call of
    ``family``'s entry point at each distinct recipe geometry of its model
    (``stem_*`` at the recipe's stem, ``bottleneck_*`` at ResNet-50's
    sites, ``basic_*`` and ``proj_*`` at ResNet-18's; the backward without
    ``dx`` where the main path takes none), traced by ``torch.profiler``:
    device time per kernel name (``key_averages()``, self device time),
    one step's worth (each geometry times its number of sites) summed per
    entry point, per name and per group (:func:`kernel_group`), from
    :func:`device_times`; beside it the peak device memory of one call
    beyond its inputs (``max_memory_allocated`` after a reset). Prints
    "not measured" when the profiler shows no device time."""
    from simclr_pytorch_distributed_tpu_torch.ops import fused_conv as fc
    dt = "fp32" if dtype == torch.float32 else "bf16"
    sites = {}  # geometry -> (kind, number of sites)
    family_sites = ([("stem", "stem", STEM_CASES[0][1])] if family == "stem" else
                    model_sites("resnet50" if family == "bottleneck" else "resnet18"))
    for _, kind, geo in family_sites:
        sites[geo] = (kind, sites.get(geo, (kind, 0))[1] + 1)
    step = {}  # kind -> {kernel name: ms in one step}
    for geo, (kind, k) in sites.items():
        tag = f"{kind}_{direction} split {dt}"
        _, _, fwd, bwd = site_calls(fc, family, geo, dev, seed=4, dtype=dtype)
        r = fwd[0]()
        if direction == "fwd":
            call = fwd[0]
        else:
            bargs, kernel, _, _ = bwd(r[1:], torch.randn_like(r[0]))
            call = functools.partial(kernel, *bargs)
            del bargs
        del r
        call()
        torch.cuda.synchronize()
        # the device memory the call takes beyond its inputs: outputs,
        # workspace (with its compute-dtype copies) and the weight copies
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        extra_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
        per = device_times(call)
        if not per:
            print(f"{tag}: not measured (the profiler shows no device time on this machine) "
                  f"{where}")
            return
        total = sum(per.values())
        print(f"{tag} {geo} x{k} sites, one call {total:.3f} ms, peak device memory beyond its "
              f"inputs {extra_mb:.1f} MiB: "
              + ", ".join(f"{n} {ms:.3f}" for n, ms in sorted(per.items(), key=lambda p: -p[1]))
              + f" {where}", flush=True)
        mine = step.setdefault(kind, {})
        for name, ms in per.items():
            mine[name] = mine.get(name, 0.0) + k * ms
        del fwd, bwd, call
        torch.cuda.empty_cache()
    for kind, per in step.items():
        n_sites = sum(k for knd, k in sites.values() if knd == kind)
        groups = {g: sum(ms for n, ms in per.items() if kernel_group(n) == g)
                  for g in ("gemm", "elementwise")}
        total = sum(per.values())
        print(f"{kind}_{direction} split {dt}, sum over the {n_sites} sites (one step) "
              f"{total:.3f} ms: GEMMs {groups['gemm']:.3f} ms "
              f"({100 * groups['gemm'] / total:.1f}%), elementwise "
              f"{groups['elementwise']:.3f} ms; "
              + ", ".join(f"{n} {ms:.3f}" for n, ms in sorted(per.items(), key=lambda p: -p[1]))
              + f" {where}", flush=True)


# the splits a run prints: (family, direction), each in both compute dtypes
SPLITS = (("stem", "fwd"), ("stem", "bwd"), ("bottleneck", "fwd"), ("bottleneck", "bwd"),
          ("block", "fwd"), ("block", "bwd"))


def splits(dev, where):
    """Every split of ``SPLITS`` in both compute dtypes (:func:`conv_split`)."""
    for family, direction in SPLITS:
        for dtype in (torch.float32, torch.bfloat16):
            conv_split(dev, where, family, direction, dtype)


def train_epochs(model, workdir, expected, banner_sites, bf16=False):
    """One 7-step epoch of ``model`` at the recipe's width through
    ``train.supcon.main`` with ``--conv_impl fused --loss_impl fused`` (and
    ``--bf16`` with ``bf16``), the
    launch counters set to 0 just before it and read just after, then the
    same epoch with ``--conv_impl eager``. Raises unless the fused run
    launched exactly ``expected``, wrote its checkpoint, and printed one
    ``[conv_impl]`` banner listing the stem and ``banner_sites`` (kind ->
    count), and under ``bf16`` naming ``compute dtype bf16``. Returns
    ``(fused_result, eager_result, launches)``."""
    from simclr_pytorch_distributed_tpu_torch.ops import fused_conv, fused_loss
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    argv = [
        "--device", "cuda", "--dataset", "synthetic", "--model", model,
        "--batch_size", "256", "--size", "32", "--epochs", "1",
        "--method", "SimCLR", "--temp", str(TEMP), "--learning_rate", "0.5",
        "--cosine", "--loss_impl", "fused", "--conv_impl", "fused", "--print_freq", "1",
        "--save_freq", "1",
        # a directory of its own: the run folder is named by the model and
        # the minute, not the dtype, so two runs in one minute would share it
        "--workdir", tempfile.mkdtemp(prefix=f"{model}_", dir=workdir),
    ] + (["--bf16"] if bf16 else [])
    model = f"{model}{' bf16' if bf16 else ''}"
    counters = [(fused_loss, "fwd_launches"), (fused_loss, "bwd_launches")]
    counters += [(fused_conv, name) for name in CONV_COUNTERS + BF16_COUNTERS]
    for mod, name in counters:
        setattr(mod, name, 0)
    result = supcon.main(argv)
    launches = {name: getattr(mod, name) for mod, name in counters}
    losses = [h["loss"] for h in result.history]
    print(f"{model} losses {losses}")
    print(f"{model} kernel launches in the run: {launches}")
    if len(losses) != 7 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{model}: expected 7 finite losses, got {losses}")
    if launches != expected:
        raise AssertionError(f"{model}: expected launches {expected}, got {launches}")
    last = os.path.join(result.save_folder, "last.pth")
    if not os.path.isfile(last):
        raise AssertionError(f"{last} was not written")
    with open(os.path.join(result.save_folder, "log-ing")) as fh:
        banner = [line for line in fh if "[conv_impl]" in line]
    print(f"{model} banner: {banner[0].strip() if banner else None}")
    if (len(banner) != 1 or "stem 3->64@32x32" not in banner[0]
            or bf16 != ("compute dtype bf16" in banner[0])
            or any(banner[0].count(f"[{kind}]") != k for kind, k in banner_sites.items())):
        raise AssertionError(f"{model}: the [conv_impl] banner does not list the stem and "
                             f"{banner_sites}: {banner}")
    eager_argv = list(argv)
    eager_argv[eager_argv.index("--conv_impl") + 1] = "eager"
    return result, supcon.main(eager_argv), launches


def step_check(name, model, views, labels):
    """One train step of ``model`` (called ``name`` in the printout) from
    one init on one batch, eager against fused conv
    (both fp32, fused loss), beside the eager step in float64 (dense loss)
    as the yardstick of fp32 noise. Binds the loss (rel 1e-4), each
    parameter's update in relative L2 (``STEP_UPDATE_REL_L2``) and the BN
    buffers (``STEP_BUF_TOL``); prints the float64 readings."""
    from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
        SupConStepConfig,
        train_step,
    )
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = {k for k, _ in model.named_parameters()}
    losses, states = {}, {}
    for impl, dtype, loss_impl in (("eager", torch.float32, "fused"),
                                   ("fused", torch.float32, "fused"),
                                   ("eager64", torch.float64, "dense")):
        m = copy.deepcopy(model).to(dtype)
        m.encoder.set_conv_impl(impl[:5])
        st = TrainState(model=m, optimizer=make_optimizer(m), schedule=lambda s: 0.5)
        cfg = SupConStepConfig(temperature=TEMP, loss_impl=loss_impl, epochs=1, steps_per_epoch=7)
        losses[impl] = train_step(st, cfg, views.to(dtype), labels)["loss"].item()
        states[impl] = {k: v.double() if v.is_floating_point() else v
                        for k, v in m.state_dict().items()}
        del m, st
        torch.cuda.empty_cache()
    rel = abs(losses["fused"] - losses["eager"]) / abs(losses["eager"])
    print(f"{name} one step conv eager {losses['eager']!r} fused {losses['fused']!r} "
          f"rel diff {rel:.3e} (bound 1e-4); float64 eager {losses['eager64']!r}")
    failures = []
    if not rel <= 1e-4:
        failures.append(f"eager and fused conv step losses differ by {rel}")

    def update_err(impl, ref, key):
        upd = ref[key] - init[key].double()
        return ((states[impl][key] - init[key].double() - upd).norm() / upd.norm()).item()

    worst = {}
    for impl, ref in (("fused", "eager"), ("fused", "eager64"), ("eager", "eager64")):
        errs = [(update_err(impl, states[ref], key), key) for key in states[ref] if key in params]
        worst[(impl, ref)] = max(errs)
        print(f"{name} step update relative L2, {impl} vs {ref}: worst {max(errs)[0]:.3e} at "
              f"{max(errs)[1]}, median {statistics.median(e for e, _ in errs):.3e} "
              f"over {len(errs)} parameters")
    if not worst[("fused", "eager")][0] <= STEP_UPDATE_REL_L2:
        failures.append(f"fused vs eager update relative L2 {worst[('fused', 'eager')]} "
                        f"> {STEP_UPDATE_REL_L2}")
    buf_worst = (0.0, None)
    for key, ref in states["eager"].items():
        if key in params:
            continue
        got = states["fused"][key]
        if not ref.is_floating_point():
            if not torch.equal(got, ref):
                failures.append(f"buffer {key}: {got} != {ref}")
            continue
        excess = ((got - ref).abs() - STEP_BUF_TOL * (1 + ref.abs())).max().item()
        buf_worst = max(buf_worst, ((got - ref).abs().max().item(), key))
        if excess > 0:
            failures.append(f"buffer {key} off by more than rtol/atol {STEP_BUF_TOL}")
    print(f"{name} BN buffers after the step, fused vs eager: max abs diff {buf_worst[0]:.3e} at "
          f"{buf_worst[1]} (bound rtol/atol {STEP_BUF_TOL})")
    if failures:
        raise AssertionError(f"{name} eager-vs-fused step:\n" + "\n".join(failures))


def step_check_bf16(name, model, views, labels):
    """One train step of ``model`` under ``--bf16`` from one init (the
    model's, each residual branch's last BN gamma scaled by
    ``BRANCH_GAMMA``) on one batch, eager and fused conv (fused loss), each
    against the fp32 eager step, beside a float64 eager step (dense loss)
    that shows how well conditioned the step is. Both bf16 paths: the loss
    (relative, at the values' scaled pin), each parameter's update at the
    round-19 gradient pins (cosine, scaled max error), and the BN buffers
    (scaled max error at the statistics pin; ``num_batches_tracked``
    exactly). The two bf16 paths round at other points (eager rounds each
    conv's output before BN, fused keeps the pre-BN y in fp32), so neither
    is held against the other. The fused bf16 step must launch the bf16
    conv kernels and no fp32 one."""
    from simclr_pytorch_distributed_tpu_torch.models.resnet import BasicBlock, Bottleneck
    from simclr_pytorch_distributed_tpu_torch.ops import fused_conv
    from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
        SupConStepConfig,
        train_step,
    )
    model = copy.deepcopy(model)
    with torch.no_grad():
        for block in model.modules():
            if isinstance(block, (BasicBlock, Bottleneck)):
                (block.bn3 if isinstance(block, Bottleneck) else block.bn2).weight.mul_(
                    BRANCH_GAMMA)
    init = {k: v.detach().clone().double() for k, v in model.state_dict().items()}
    params = sorted(k for k, _ in model.named_parameters())
    losses, states = {}, {}
    for tag, impl, dtype in (("fp32 eager", "eager", torch.float32),
                             ("bf16 eager", "eager", torch.bfloat16),
                             ("bf16 fused", "fused", torch.bfloat16),
                             ("float64 eager", "eager", torch.float64)):
        m = copy.deepcopy(model).to(torch.float64 if dtype == torch.float64 else torch.float32)
        m.encoder.set_conv_impl(impl)
        if dtype != torch.float64:
            m.encoder.set_compute_dtype(dtype)
        st = TrainState(model=m, optimizer=make_optimizer(m), schedule=lambda s: 0.5)
        cfg = SupConStepConfig(temperature=TEMP, epochs=1, steps_per_epoch=7,
                               loss_impl="dense" if dtype == torch.float64 else "fused")
        before = {c: getattr(fused_conv, c) for c in CONV_COUNTERS + BF16_COUNTERS}
        losses[tag] = train_step(st, cfg, views.to(m.encoder.conv1.weight.dtype),
                                 labels)["loss"].item()
        ran = {c for c in before if getattr(fused_conv, c) != before[c]}
        kinds = ("stem", "bottleneck") if name == "resnet50" else ("stem", "basic", "proj")
        want = {c for c in BF16_COUNTERS if c.split("_")[0] in kinds}
        if ran != (want if impl == "fused" else set()):
            raise AssertionError(f"{name} {tag} step launched {sorted(ran)}")
        states[tag] = {k: v.double() if v.is_floating_point() else v
                       for k, v in m.state_dict().items()}
        del m, st
        torch.cuda.empty_cache()
    ref = states["fp32 eager"]
    failures = []
    for tag in ("bf16 eager", "bf16 fused", "float64 eager"):
        rel = abs(losses[tag] - losses["fp32 eager"]) / abs(losses["fp32 eager"])
        print(f"{name} one step loss {tag} {losses[tag]!r} vs fp32 eager "
              f"{losses['fp32 eager']!r}: rel diff {rel:.3e} (bound {BF16_VAL_SCALED})")
        upd = {}
        for key in params:
            got, want = states[tag][key] - init[key], ref[key] - init[key]
            upd[key] = bf16_measure(got, want) + (rel_l2(got, want),)
        worst = min(params, key=lambda k: upd[k][1])
        widest = max(params, key=lambda k: upd[k][0])
        print(f"{name} step update, {tag} vs fp32 eager over {len(params)} parameters: "
              f"cosine lowest {upd[worst][1]:.6f} at {worst}, median "
              f"{statistics.median(u[1] for u in upd.values()):.6f}; scaled max error largest "
              f"{upd[widest][0]:.3e} at {widest}; relative L2 median "
              f"{statistics.median(u[2] for u in upd.values()):.3e} (bounds cosine >= "
              f"{BF16_GRAD_COS}, scaled <= {BF16_GRAD_SCALED})")
        if tag == "float64 eager":  # a reading of the step's conditioning
            continue
        if not rel <= BF16_VAL_SCALED:
            failures.append(f"{tag} loss rel diff {rel}")
        failures += [f"{tag} update {k}: scaled {u[0]:.3e} cos {u[1]:.6f}"
                     for k, u in upd.items() if not bf16_ok("grad", u[0], u[1])]
        buf_worst = (0.0, None)
        for key, r in ref.items():
            if key in params:
                continue
            got = states[tag][key]
            if not r.is_floating_point():
                if not torch.equal(got, r):
                    failures.append(f"{tag} buffer {key}: {got} != {r}")
                continue
            scaled, _ = bf16_measure(got, r)
            buf_worst = max(buf_worst, (scaled, key))
            if not bf16_ok("stats", scaled, 1.0):
                failures.append(f"{tag} buffer {key}: scaled {scaled:.3e}")
        print(f"{name} BN buffers after the step, {tag} vs fp32 eager: largest scaled max error "
              f"{buf_worst[0]:.3e} at {buf_worst[1]} (bound {BF16_STATS_SCALED})")
    if failures:
        raise AssertionError(f"{name} bf16 step check:\n" + "\n".join(failures))


def split_only() -> int:
    """The ``--split-only`` run: the build, the loss split
    (:func:`loss_split`) and the per-kernel splits of ``SPLITS`` (the
    stem, Bottleneck, BasicBlock and projection-block forwards and
    backwards) in both compute dtypes."""
    from simclr_pytorch_distributed_tpu_torch.ops import fused_loss, native
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"nvidia-smi name, power.limit: {card}")
    tb = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        for lib in pool.map(native.build, SOURCES):
            print(f"built {lib}")
    print(f"built {len(SOURCES)} libraries in parallel in {time.time() - tb:.2f} s")
    loss_split(fused_loss, dev, f"on {card}")
    splits(dev, f"on {card}")
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--split-only", action="store_true",
                    help="only build the kernels and print the per-kernel splits of the loss "
                         "(N = 512 and 8192) and of the stem, Bottleneck, BasicBlock and "
                         "projection-block forwards and backwards (fp32 and bf16), then exit")
    ap.add_argument("--root", default=REPO,
                    help="the checkout whose port package is imported and built (default: "
                         "this script's directory; another checkout, for example a parent "
                         "commit's, with --split-only)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to test",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(opts.root))
    if opts.split_only:
        return split_only()
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
    from simclr_pytorch_distributed_tpu_torch.ops import fused_loss, native
    from simclr_pytorch_distributed_tpu_torch.ops.augment import AugmentConfig, two_crop_batch
    from simclr_pytorch_distributed_tpu_torch.ops.losses import supcon_loss
    from simclr_pytorch_distributed_tpu_torch.data.cifar import synthetic_dataset
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
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        built = dict(zip(SOURCES, pool.map(native.build, SOURCES)))
    print(f"built {len(built)} libraries in parallel in {time.time() - tb:.2f} s")
    for name, lib_path in built.items():
        print(f"{os.path.relpath(lib_path, REPO)} (ptxas: registers, shared memory, spills):")
        print(lib_path.with_suffix(".log").read_text().strip())
    done("build", t0)

    # -- kernel_parity -----------------------------------------------------
    t0 = phase("kernel_parity")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errors = loss_parity(fused_loss, dev)
    parity = Parity()
    conv_parity(dev, parity)
    print(f"conv bounds: out rtol {VAL_RTOL} atol {VAL_ATOL}; moments rtol {STAT_RTOL} "
          f"atol {STAT_ATOL}; ragged gradients rtol {GRAD_RTOL} atol {GRAD_ATOL}; recipe "
          f"gradients vs float64, relative L2: <= {GRAD_REL_L2} (main-path inputs), <= "
          f"{GRAD_VS_PLAIN} x the plain fp32 form's, floor {GRAD_L2_FLOOR} (margin inputs)")
    parity.raise_if_failed()
    bf16_parity(dev, parity)
    print(f"bf16 conv bounds: round-19 against the bf16 and the fp32 plain forms (values "
          f"scaled max <= {BF16_VAL_SCALED} and cosine >= {BF16_VAL_COS}; gradients cosine >= "
          f"{BF16_GRAD_COS} and scaled max <= {BF16_GRAD_SCALED}; moments scaled max <= "
          f"{BF16_STATS_SCALED}); against the bf16 plain form also relative L2 <= "
          f"{BF16_REL_L2}")
    for (kernel, pin, what), (scaled, cos, l2, breaks, count) in sorted(parity.worst.items()):
        yard = "bf16" if pin == "l2" else "fp32"
        print(f"bf16 worst {kernel} vs {yard} plain, {what}: scaled {scaled:.3e}"
              + ("" if what == "stats" else f", cosine {cos:.6f}")
              + (f", relL2 {l2:.3e} (the fp32 plain form in the kernel's place breaks "
                 f"{BF16_REL_L2[what]} on {breaks} of {count} tensors)" if pin == "l2" else ""))
    print(f"bf16 gradient pins against fp32 excused because the bf16 plain form breaks them "
          f"too: {len(parity.excused)}")
    for line in parity.excused:
        print(f"  excused: {line}")
    parity.raise_if_failed()
    determinism(dev, "stem")
    determinism(dev, "bottleneck")
    determinism(dev, "block")
    loss_determinism(fused_loss, dev)
    done("kernel_parity", t0)

    # -- train: each main path, through the port's entry point --------------
    t0 = phase("train")
    batch_size = 256
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    rn50_expected = {name: 0 for name in ("fwd_launches", "bwd_launches") + CONV_COUNTERS
                     + BF16_COUNTERS}
    rn50_expected.update(fwd_launches=7, bwd_launches=7, stem_fwd_launches=7,
                         stem_bwd_launches=7, bottleneck_fwd_launches=16 * 7,
                         bottleneck_bwd_launches=16 * 7)
    result, eager_result, main_path = train_epochs(
        "resnet50", workdir, rn50_expected, {"bottleneck": 16})
    rn18_expected = dict(rn50_expected, bottleneck_fwd_launches=0, bottleneck_bwd_launches=0,
                         basic_fwd_launches=5 * 7, basic_bwd_launches=5 * 7,
                         proj_fwd_launches=3 * 7, proj_bwd_launches=3 * 7)
    rn18_result, rn18_eager_result, rn18_path = train_epochs(
        "resnet18", workdir, rn18_expected, {"basic": 5, "proj": 3})
    launches = {"fwd": main_path["fwd_launches"], "bwd": main_path["bwd_launches"]}

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

    del stepped
    step_check("resnet50", model, views, labels)
    torch.manual_seed(0)
    rn18 = SupConResNet("resnet18").to(dev, memory_format=torch.channels_last)
    step_check("resnet18", rn18, views, labels)

    # -- the same two paths under --bf16 -----------------------------------
    rn50_bf16_expected = dict(rn50_expected, stem_fwd_launches=0, stem_bwd_launches=0,
                              bottleneck_fwd_launches=0, bottleneck_bwd_launches=0,
                              stem_fwd_bf16_launches=7, stem_bwd_bf16_launches=7,
                              bottleneck_fwd_bf16_launches=16 * 7,
                              bottleneck_bwd_bf16_launches=16 * 7)
    bf16_runs = {"resnet50": train_epochs("resnet50", workdir, rn50_bf16_expected,
                                          {"bottleneck": 16}, bf16=True)}
    rn18_bf16_expected = dict(rn18_expected, stem_fwd_launches=0, stem_bwd_launches=0,
                              basic_fwd_launches=0, basic_bwd_launches=0,
                              proj_fwd_launches=0, proj_bwd_launches=0,
                              stem_fwd_bf16_launches=7, stem_bwd_bf16_launches=7,
                              basic_fwd_bf16_launches=5 * 7, basic_bwd_bf16_launches=5 * 7,
                              proj_fwd_bf16_launches=3 * 7, proj_bwd_bf16_launches=3 * 7)
    bf16_runs["resnet18"] = train_epochs("resnet18", workdir, rn18_bf16_expected,
                                         {"basic": 5, "proj": 3}, bf16=True)
    step_check_bf16("resnet50", model, views, labels)
    step_check_bf16("resnet18", rn18, views, labels)
    done("train", t0)

    # -- timing ------------------------------------------------------------
    t0 = phase("timing")
    where = f"on {card}"
    split = loss_split(fused_loss, dev, where)
    loss_ms = {direction: split[(direction, N_ROWS)] for direction in ("fwd", "bwd")}
    f, _, _ = loss_inputs(N_ROWS // 2, seed=2, device=dev)
    feats3 = f.reshape(2, N_ROWS // 2, DIM).transpose(0, 1)
    dense_ms = cuda_time_ms(
        lambda: supcon_loss(feats3, temperature=TEMP, base_temperature=BASE_TEMP)
    )
    leaf3 = feats3.detach().requires_grad_()
    dense_fwd_bwd_ms = cuda_time_ms(
        lambda: supcon_loss(leaf3, temperature=TEMP, base_temperature=BASE_TEMP).backward()
    )
    aug_cfg = AugmentConfig(mean=(0.5,) * 3, std=(0.25,) * 3)
    aug_ms = cuda_time_ms(lambda: two_crop_batch(gen, images, aug_cfg), reps=5, rounds=3, warmup=2)
    for direction, got in loss_ms.items():
        print(f"fused {direction} kernel {got['ms'] * 1e3:.2f} us, plain "
              f"{got['plain_ms'] * 1e3:.2f} us {where}")
    print(f"dense supcon_loss (several PyTorch calls; context, not a yardstick) forward "
          f"{dense_ms * 1e3:.2f} us, forward+backward {dense_fwd_bwd_ms * 1e3:.2f} us {where}")
    for name, net, runs in (("resnet50", model, (result, eager_result)),
                            ("resnet18", rn18, (rn18_result, rn18_eager_result))):
        step_flops = 3 * forward_flops(net, 32, dev) * 2 * batch_size
        for impl, run in zip(("fused", "eager"), runs):
            times = [h["step_time"] for h in run.history[2:7]]
            ms = statistics.median(times) * 1e3
            print(f"train step ({name}, batch {batch_size}, 32 px, fp32, --conv_impl {impl}) "
                  f"median of steps 3-7 {ms:.2f} ms = {batch_size / ms * 1e3:.1f} imgs/s, "
                  f"{step_flops / ms / 1e9:.2f} TFLOP/s of model FLOPs = "
                  f"{step_flops / ms * 1e3 / PEAK_FP32_FLOPS * 100:.1f}% of the fp32 "
                  f"non-tensor peak; all steps ms {[round(t * 1e3, 2) for t in times]} {where}")
        print(f"{name} train step model FLOPs (3 x forward of convs and linears, "
              f"{2 * batch_size} views) {step_flops / 1e9:.1f} GFLOP")
        for impl, run in zip(("fused", "eager"), bf16_runs[name][:2]):
            times = [h["step_time"] for h in run.history[2:7]]
            ms = statistics.median(times) * 1e3
            print(f"train step ({name}, batch {batch_size}, 32 px, --bf16, --conv_impl {impl}) "
                  f"median of steps 3-7 {ms:.2f} ms = {batch_size / ms * 1e3:.1f} imgs/s, "
                  f"{step_flops / ms / 1e9:.2f} TFLOP/s of model FLOPs = "
                  f"{step_flops / ms * 1e3 / PEAK_BF16_FLOPS * 100:.2f}% of the bf16 "
                  f"tensor-core peak; all steps ms {[round(t * 1e3, 2) for t in times]} {where}")
    print(f"two-crop augmentation of the {batch_size}-image batch {aug_ms:.3f} ms {where}")
    times = {"stem": stem_timing(dev, where)}
    sites = []
    for family, model_name, seed in (("bottleneck", "resnet50", 4), ("block", "resnet18", 6)):
        res = sites_timing(dev, where, family, model_sites(model_name), seed)
        sites += res.pop("sites")
        times.update(res)
    times16 = {"stem": stem_timing(dev, where, torch.bfloat16)}
    sites16 = []
    for family, model_name, seed in (("bottleneck", "resnet50", 4), ("block", "resnet18", 6)):
        res = sites_timing(dev, where, family, model_sites(model_name), seed, torch.bfloat16)
        sites16 += res.pop("sites")
        times16.update(res)
    splits(dev, where)
    done("timing", t0)

    loss_bound = loss_bounds(*f.shape)
    source = "simclr_pytorch_distributed_tpu_torch/csrc/fused_supcon_loss.cu"
    kernels = [
        {
            "name": "fused_supcon_loss_fwd", "route": "cuda", "source": source,
            "replaces": "simclr_pytorch_distributed_tpu/ops/pallas_loss.py:69",
            "launches": launches["fwd"],
            "max_abs_err": max(errors[("a", "loss_row")], errors[("a", "lse")]),
            "ms": loss_ms["fwd"]["ms"], "plain_ms": loss_ms["fwd"]["plain_ms"],
            "bound_ms": loss_bound["fwd"][0], "bound_by": loss_bound["fwd"][1],
            "library_ms": None,
        },
        {
            "name": "fused_supcon_loss_bwd", "route": "cuda", "source": source,
            "replaces": "simclr_pytorch_distributed_tpu/ops/pallas_loss.py:114",
            "launches": launches["bwd"], "max_abs_err": errors[("a", "dF")],
            "max_rel_l2": errors[("a", "dF_rel_l2")],
            "ms": loss_ms["bwd"]["ms"], "plain_ms": loss_ms["bwd"]["plain_ms"],
            "bound_ms": loss_bound["bwd"][0], "bound_by": loss_bound["bwd"][1],
            "library_ms": None,
        },
    ]
    # the stem at the recipe shape: fwd reads x and writes out; its main-
    # path backward takes no dx, so it recomputes the conv and takes dW
    m_rows = 2 * batch_size * 32 * 32
    stem_fwd_flops = 2 * m_rows * 27 * 64
    small = 4 * (27 * 64 + 4 * 64)  # kernel, gamma, beta, moments
    stem_bounds = {
        "fwd": bound(stem_fwd_flops, 4 * m_rows * (3 + 64) + small),
        "bwd": bound(2 * stem_fwd_flops, 4 * m_rows * (3 + 64) + small + 4 * (27 * 64 + 2 * 64)),
    }
    stem16_bounds = {
        "fwd": bound(stem_fwd_flops, 2 * m_rows * (3 + 64) + 2 * 27 * 64 + 4 * 4 * 64,
                     PEAK_BF16_FLOPS),
        "bwd": bound(2 * stem_fwd_flops, 2 * m_rows * (3 + 64) + 2 * 27 * 64 + 4 * 4 * 64
                     + 2 * 27 * 64 + 4 * 2 * 64, PEAK_BF16_FLOPS),
    }
    print("per-site list: " + json.dumps(sites))
    print("per-site list, bf16: " + json.dumps(sites16))
    conv_source = "simclr_pytorch_distributed_tpu_torch/csrc/fused_conv_bn.cu"
    # (kernel, TPU kernel lines, the run of the path it belongs to); a block
    # kernel's times and bound are sums over its path's sites, one step's
    rows = [("stem", 401, 443, main_path), ("basic", 639, 705, rn18_path),
            ("proj", 930, 1006, rn18_path), ("bottleneck", 1289, 1408, main_path)]
    for block, fwd_line, bwd_line, path in rows:
        for direction, line in (("fwd", fwd_line), ("bwd", bwd_line)):
            name = f"fused_{block}_{direction}"
            bnd = (stem_bounds[direction] if block == "stem" else summed_bound(
                [site for site in sites if site["kind"] == block], direction))
            entry = {
                "name": name, "route": "cuda", "source": conv_source,
                "replaces": f"{PALLAS_CONV}:{line}",
                "launches": path[f"{block}_{direction}_launches"],
                "max_abs_err": parity.max_abs[name],
                "ms": times[block][direction], "plain_ms": times[block][f"{direction}_plain"],
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            }
            if direction == "bwd":  # at the recipe's sites, vs float64
                entry["max_rel_l2"] = parity.max_rel_l2[name]
            kernels.append(entry)
    # the bf16 entry points: errors against their bf16 plain forms over
    # every parity case, times and bounds (bf16 peak, 2-byte activations)
    # of the bf16 path's run
    for block, fwd_line, bwd_line, model_name in (
            ("stem", 401, 443, "resnet50"), ("basic", 639, 705, "resnet18"),
            ("proj", 930, 1006, "resnet18"), ("bottleneck", 1289, 1408, "resnet50")):
        for direction, line in (("fwd", fwd_line), ("bwd", bwd_line)):
            name = f"fused_{block}_{direction}_bf16"
            bnd = (stem16_bounds[direction] if block == "stem" else summed_bound(
                [site for site in sites16 if site["kind"] == block], direction))
            kernels.append({
                "name": name, "route": "cuda", "source": conv_source,
                "replaces": f"{PALLAS_CONV}:{line}",
                "launches": bf16_runs[model_name][2][f"{block}_{direction}_bf16_launches"],
                "max_abs_err": parity.max_abs[name], "max_rel_l2": parity.max_rel_l2[name],
                "ms": times16[block][direction],
                "plain_ms": times16[block][f"{direction}_plain"],
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
