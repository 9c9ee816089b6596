#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (one nvcc per source, all
started together), holds each against its plain PyTorch version on the card
(the loss pair at ``LOSS_CASES``: N = 512 SimCLR and SupCon, 74 rows,
a row offset, D = 18, nr = nc = 2, and the data-parallel sharded form's
two-slab rows of processes 1 of 2 and 2 of 4; the stem,
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
It then drives the linear probe's entry point (``train.linear.main``) at
full width from the ResNet-50 fp32 and ``--bf16`` runs' ``last.pth``
(checking that the frozen encoder is bitwise unchanged, that no kernel
launched, that ``classifier_best.pth`` reloads and that one eval batch's
logits match the port's CPU run of the same weights, and timing the probe
step and the validation pass), and proves resume on ResNet-18 at full
width: two epochs straight, one epoch then ``--resume``, and a run
SIGTERM'd after step 3 (exit 75) then resumed end bitwise equal, and a
non-finite loss exits 1 with ``crash_epoch_1.pth``.
Then the data-parallel path (``distributed``): (a) the pretraining entry
point under torchrun's environment at world size 1 (NCCL) for the
ResNet-50 fp32 epoch with ``--syncBN``, through the process group, the
feature gather, the sharded fused loss and the gradient mean, bitwise equal
to the train phase's run; (b) two processes on the one card over gloo
(NCCL takes one process a card), one ResNet-50 step at the recipe's width
with ``--syncBN``, eager convs and the sharded fused loss against the
one-process step on the global batch, both processes launching both loss
kernels; with the step and collective times of both.
Then the large-batch composition and the resilience of a multi-process
run (``large_batch``): (a) the ResNet-50 fp32 fused epoch at world size 1
(NCCL) with ``--syncBN --optimizer lars`` and ``--loss_impl ring``, against
the same with ``--loss_impl fused``; in two processes on the one card over
gloo, each against one process, (b) the ring loss alone at N = 8192 with
its peak memory beside the dense loss's, (c) one ResNet-18 LARS ring step,
(d) the probe, (e) a ResNet-18 run SIGTERM'd after step 3 and resumed at
world size 1 (elastic resume); and (f) ``--nan_policy rollback`` with a
non-finite loss injected in epoch 1 of 2, under ``--telemetry sync`` and
the default ``async``.
Then the run-observability stack (``observability``): ResNet-50 fp32 and
``--bf16`` fused epochs with the health diagnostics and the online probe,
under ``--telemetry async`` (no host sync between flush boundaries, one
transfer a window) and ``sync`` (bitwise the same history; the health
columns against the CPU's; the fp32 async run's ``events.jsonl`` through
``scripts/port_health_report.py``, its consistency bound and the
``health_report`` gate's record on it printed), a run with the sidecar
scraped and a stall
the watchdog dumps, and ``torch.profiler`` windows of the ResNet-18 bf16
fused step and the ResNet-50 fp32 LARS step, summarized; and the CE
trainer (``ce``): ResNet-50 ``SupCEResNet`` in fp32 and ``--bf16`` through
``train.ce.main``, its step time, card-vs-CPU logits, and a SIGTERM'd and
resumed run bitwise the straight one.
Every phase above runs with ``--data_placement host`` (the loader's batch
copied each step). Then the data placements (``placement``): the ResNet-50
fp32 fused epoch under ``--data_placement device`` (the dataset on the
card, one index upload and one gather an epoch) and ``window`` (windows
of 3 batches, staged on a side stream), each bitwise the train phase's run
with its uploads counted through the stores' hooks and no host sync
between flush boundaries; a ResNet-18 run under ``window`` SIGTERM'd after
step 3 and resumed mid-window, bitwise the resume phase's; the ladder's
verdicts and an explicit placement over its budget stopping before step
1; a memmap-backed dataset windowed; the probe and the CE trainer under
``device``, bitwise their host runs; and the step times, data waits and
window swaps of ResNet-50 fp32 and ResNet-18 bf16 under the three
placements.
Then the SSL recipes (``recipes``): supcon, simclr, byol, simsiam, vicreg
and simclr with a MoCo queue through the entry point at ResNet-50 fp32
fused width (and byol under ``--bf16``), their launches (the EMA network's
second forward, the loss kernels only for the contrastive recipes), no host
sync, simclr bitwise the train phase's run and the step's inline path, one
fused-vs-eager step of each at the train phase's pins, ResNet-18 byol and
queue runs SIGTERM'd and resumed bitwise, a two-process byol step against
one process, the accuracy arms and the supcon bit-identity through
``scripts/port_recipes_eval.py`` with the ``recipes`` gate's record, the
``health_report`` gate on its own rn10 smoke, the collapse arm's exit 3,
and the native host gather on the card's host.
Then the port's supervisor (``supervise``) on the trainer, through
``scripts/port_supervisor_victim.py`` in child processes: (a) ``kill -9``
in epoch 2 of a ResNet-50 fp32 fused run, relaunched bitwise to a straight
run's ``last.pth``; (b) a ResNet-18 bf16 run wedged at a flush boundary
behind the port launchers' torchrun wrapper, killed off the scraped
boundary age through the grace window, its worker with it; (c) a
non-finite loss; (d) a collapse given up with exit 3; (e) an outside
SIGTERM resumed without backoff, bitwise the straight run; (f) the skew
gauges at world size 1 over NCCL with no host sync between boundaries;
(g) a resize: a ResNet-18 bf16 run of two gloo processes on the one card
(``scripts/port_fleet_launcher.py --trainer``) gets a ``resize_request`` of
1, saves at one boundary and resumes on one process (the fused kernels
again), ``restart_resized`` then ``done``;
with each scenario's decisions, launches, recovery time and each child's
kernel launches. After serve, ``evidence``: the ``supervisor_gate``,
``chaos_matrix``, ``serve_fleet`` and ``fleet_report`` records of
``scripts/port_ratchet.py`` over the committed port artifacts
(``docs/evidence/port_*_r21.json``), each ok and naming an NVIDIA card.
Then the serving stack (``serve``), from the train phase's ResNet-50 fp32
``last.pth`` at buckets 1, 8, 32, 128: (a) ``EmbeddingEngine`` features
and projections against the port's CPU engine, bf16 against fp32, padded
batches bitwise the exact ones, buckets against buckets, a 300-image
request chunked, the cache-hit path, every dispatch under
``torch.cuda.set_sync_debug_mode("error")``, and each bucket's time in
fp32 and bf16; (b) ``serve.server.build_stack`` at ``--max_inflight`` 1
and 2 under 16 client threads' 256 requests, each reply bitwise the
engine's rows at a bucket the request could use, ``/stats``,
``/metrics`` and a 400; (c) the fleet frontend: ``/neighbors`` against a
numpy oracle, IVF's recall@10, a tenant over quota refused with 503, a
promote to the resume phase's ResNet-18 ``last.pth`` under load; with
every fused launch counter 0 and every served state dict bitwise its
checkpoint's; (d) ``ReplicaFleetSupervisor`` over two fleet replicas on
the card, their spawn-to-healthy times, a ``kill -9`` restarted on its
port.
Before serve, tensor parallelism (``tensor_parallel``, ``--model_parallel``,
gloo over CUDA tensors on the one card): (a) one ResNet-50 step at the
recipe's width, batch 128, on 2 processes of one model group (the fused
loss's single-device form launched once a step on each) against the
one-process step and a float64 step, with each rank's state bytes, the
step's time and its collectives by group; (b) one ResNet-18 step at data 2
x model 2 with ``--syncBN`` through the sharded fused loss over the data
group; (c) ``train.supcon.main --model_parallel 2`` for two ResNet-18
epochs, its whole-tensor ``last.pth`` read by ``train.linear.main`` and its
first-epoch save resumed at ``--model_parallel 1``; the health
gradient norm of (a) and (b) free of host syncs under
``torch.cuda.set_sync_debug_mode("error")``; and (d) one ResNet-18 step of
each of byol, simsiam, vicreg and the MoCo queue at data 1 x model 2
against the one-process recipe step, and ``--recipe byol --model_parallel
2`` through the driver, its whole save resumed at ``--model_parallel 1``.
Phases: device, build, kernel_parity, train, probe, resume, distributed,
large_batch, observability, ce, placement, recipes, supervise,
tensor_parallel, serve, evidence, timing. Any failure raises and the script
exits non-zero.

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
import glob
import json
import math
import os
import signal
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
# Recipes whose loss does not change when the same vector is added to every
# projection row: BYOL and SimSiam normalize the predictor's hidden layer
# over the batch, and VICReg's terms are differences, variances and
# centred covariances. The gradient of the projection head's last bias is
# then zero, its update is weight decay plus rounding, and its bf16 reading
# measures rounding over a zero, as MARGIN_EXEMPT's db2 does. The bf16 step
# check leaves it out of the update pins and holds instead, in its float64
# arm, its gradient's norm to SHIFT_INVARIANT_REL of the same layer's
# weight gradient.
SHIFT_INVARIANT = {name: ("head.2.bias",) for name in ("byol", "simsiam", "vicreg")}
SHIFT_INVARIANT_REL = 1e-3
# the step checks' learning rate and SGD weight decay (make_optimizer's)
STEP_LR, STEP_WD = 0.5, 1e-4
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
# have no scale) or not (cnt 0). g and h the data-parallel sharded form
# (ops/fused_loss.fused_sharded_supcon_loss): a process's rows are two slabs
# of the global view-major rows, its first views and its second views, fed
# with their global ids; g is process 1 of 2 (rows 128..255 and 384..511 of
# N = 512, SimCLR), h process 2 of 4 (rows 128..191 and 384..447, SupCon).
LOSS_CASES = (("a", 256, None, DIM, None, None), ("b", 256, 10, DIM, None, None),
              ("c", 37, None, DIM, None, None), ("d", 256, 10, DIM, (128, 256), None),
              ("e", 37, None, 18, None, None), ("f", 2, None, DIM, (0, 2), (2, 4)),
              ("g", 256, None, DIM, ((128, 256), (384, 512)), None),
              ("h", 256, 10, DIM, ((128, 192), (384, 448)), None))


def row_index(spec, n, dev):
    """A loss case's rows: all ``n`` (None), one ``(lo, hi)`` slice, or a
    tuple of such slabs (an index tensor)."""
    if spec is None:
        return slice(0, n)
    if isinstance(spec[0], tuple):
        return torch.cat([torch.arange(lo, hi) for lo, hi in spec]).to(dev)
    return slice(*spec)


def rows_label(spec):
    slabs = spec if isinstance(spec[0], tuple) else (spec,)
    return "+".join(f"{lo}..{hi - 1}" for lo, hi in slabs)


def loss_case(fused_loss, dev, batch, classes, dim, rows, cols, seed=1):
    """``(fwd_args, bwd_args)`` of one loss case (``LOSS_CASES``): the
    anchor rows against the contrast columns, and for the backward the
    plain forward's lse/cnt of the rows and of the columns."""
    f, ids, gid = loss_inputs(batch, seed, dev, classes, dim)
    r, c = row_index(rows, f.shape[0], dev), row_index(cols, f.shape[0], dev)
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
        shape = (f"N={n}" if rows is None else f"rows {rows_label(rows)} of N={n}"
                 + ("" if cols is None else f" against columns {rows_label(cols)}"))
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
    inputs, at N = 512 (case a), at a row offset (case d) and in the
    data-parallel sharded form (cases g and h): every output bitwise equal,
    or raise. The splits combine in rank order and no kernel uses
    atomics."""
    for case, batch, classes, dim, rows, cols in (LOSS_CASES[i] for i in (0, 3, 6, 7)):
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


def kernel_counters():
    """Every launch counter of the port's kernels, as (module, name)."""
    from simclr_pytorch_distributed_tpu_torch.ops import fused_conv, fused_loss
    return ([(fused_loss, "fwd_launches"), (fused_loss, "bwd_launches")]
            + [(fused_conv, name) for name in CONV_COUNTERS + BF16_COUNTERS])


def recipe_argv(model, workdir, bf16=False):
    """``train.supcon.main``'s arguments for one 7-step epoch of ``model`` at
    the recipe's width with ``--conv_impl fused --loss_impl fused``, in a
    new directory under ``workdir``."""
    return [
        "--device", "cuda", "--dataset", "synthetic", "--model", model,
        "--batch_size", "256", "--size", "32", "--epochs", "1",
        "--method", "SimCLR", "--temp", str(TEMP), "--learning_rate", "0.5",
        "--cosine", "--loss_impl", "fused", "--conv_impl", "fused", "--print_freq", "1",
        "--save_freq", "1", "--data_placement", "host",
        # a directory of its own: the run folder is named by the model and
        # the minute, not the dtype, so two runs in one minute would share it
        "--workdir", tempfile.mkdtemp(prefix=f"{model}_", dir=workdir),
    ] + (["--bf16"] if bf16 else [])


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
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    argv = recipe_argv(model, workdir, bf16)
    model = f"{model}{' bf16' if bf16 else ''}"
    counters = kernel_counters()
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


def attach_recipe(state, recipe):
    """Attach the recipe of the ``SupConConfig`` overrides ``recipe`` (a
    dict; ``None`` leaves the step's inline path) and its slots to
    ``state``, as the driver does at the recipe's width (batch 256).
    Returns ``(method, loss_impl)`` for the step: the recipe's method, and
    the dense loss under the MoCo queue, else the fused one."""
    if recipe is None:
        return "SimCLR", "fused"
    from simclr_pytorch_distributed_tpu_torch import config as config_lib
    from simclr_pytorch_distributed_tpu_torch import recipes
    cfg = config_lib.SupConConfig(batch_size=256, **recipe)
    config_lib.validate_recipe(cfg)
    recipes.attach_for_config(cfg, state)
    return cfg.method, "dense" if cfg.moco_queue else "fused"


def with_predictor(state, tensors):
    """``tensors`` (a model's state dict) with the recipe predictor's
    parameters beside them as ``predictor.<name>``, in float64."""
    out = {k: v.double() if v.is_floating_point() else v for k, v in tensors.items()}
    if state.recipe_params is not None:
        out.update({f"predictor.{k}": v.detach().double()
                    for k, v in state.recipe_params.state_dict().items()})
    return out


def step_check(name, model, views, labels, recipe=None):
    """One train step of ``model`` (called ``name`` in the printout) from
    one init on one batch, eager against fused conv
    (both fp32, fused loss), beside the eager step in float64 (dense loss)
    as the yardstick of fp32 noise. Binds the loss (rel 1e-4), each
    parameter's update in relative L2 (``STEP_UPDATE_REL_L2``) and the BN
    buffers (``STEP_BUF_TOL``); prints the float64 readings. With
    ``recipe`` (:func:`attach_recipe`) the step goes through that recipe,
    and its predictor's parameters are held with the model's."""
    from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
        SupConStepConfig,
        train_step,
    )
    init = None
    params = {k for k, _ in model.named_parameters()}
    losses, states = {}, {}
    for impl, dtype, loss_impl in (("eager", torch.float32, "fused"),
                                   ("fused", torch.float32, "fused"),
                                   ("eager64", torch.float64, "dense")):
        m = copy.deepcopy(model).to(dtype)
        m.encoder.set_conv_impl(impl[:5])
        st = TrainState(model=m, optimizer=make_optimizer(m), schedule=lambda s: 0.5)
        method, recipe_loss = attach_recipe(st, recipe)
        if init is None:
            init = with_predictor(st, m.state_dict())
            params |= {k for k in init if k.startswith("predictor.")}
        cfg = SupConStepConfig(method=method, temperature=TEMP,
                               loss_impl="dense" if dtype == torch.float64 else recipe_loss,
                               epochs=1, steps_per_epoch=7)
        losses[impl] = train_step(st, cfg, views.to(dtype), labels)["loss"].item()
        states[impl] = with_predictor(st, m.state_dict())
        del m, st
        torch.cuda.empty_cache()
    rel = abs(losses["fused"] - losses["eager"]) / abs(losses["eager"])
    print(f"{name} one step conv eager {losses['eager']!r} fused {losses['fused']!r} "
          f"rel diff {rel:.3e} (bound 1e-4); float64 eager {losses['eager64']!r}")
    failures = []
    if not rel <= 1e-4:
        failures.append(f"eager and fused conv step losses differ by {rel}")

    def update_err(impl, ref, key):
        upd = ref[key] - init[key]
        return ((states[impl][key] - init[key] - upd).norm() / upd.norm()).item()

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


def step_check_bf16(name, model, views, labels, recipe=None):
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
    conv kernels and no fp32 one. With ``recipe`` (:func:`attach_recipe`)
    the step goes through that recipe, and its predictor's parameters
    (fp32 in every arm) are held with the model's."""
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
    init = None
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
        st = TrainState(model=m, optimizer=make_optimizer(m, weight_decay=STEP_WD),
                        schedule=lambda s: STEP_LR)
        method, recipe_loss = attach_recipe(st, recipe)
        if init is None:
            init = with_predictor(st, m.state_dict())
            params += sorted(k for k in init if k.startswith("predictor."))
        cfg = SupConStepConfig(method=method, temperature=TEMP, epochs=1, steps_per_epoch=7,
                               loss_impl="dense" if dtype == torch.float64 else recipe_loss)
        before = {c: getattr(fused_conv, c) for c in CONV_COUNTERS + BF16_COUNTERS}
        losses[tag] = train_step(st, cfg, views.to(m.encoder.conv1.weight.dtype),
                                 labels)["loss"].item()
        ran = {c for c in before if getattr(fused_conv, c) != before[c]}
        kinds = (("stem", "bottleneck") if any(isinstance(b, Bottleneck) for b in m.modules())
                 else ("stem", "basic", "proj"))
        want = {c for c in BF16_COUNTERS if c.split("_")[0] in kinds}
        if ran != (want if impl == "fused" else set()):
            raise AssertionError(f"{name} {tag} step launched {sorted(ran)}")
        states[tag] = with_predictor(st, m.state_dict())
        del m, st
        torch.cuda.empty_cache()
    ref = states["fp32 eager"]
    failures = []
    exempt = SHIFT_INVARIANT.get((recipe or {}).get("recipe"), ())
    for key in exempt:
        # the first SGD step: update = -lr (g + wd p), so g from the update
        def grad(k):
            return -(states["float64 eager"][k] - init[k]) / STEP_LR - STEP_WD * init[k]
        ratio = (grad(key).norm() / grad(key.replace("bias", "weight")).norm()).item()
        print(f"{name} {key}: the loss is shift-invariant, so its gradient is zero: float64 "
              f"arm |g| / |g of the layer's weight| {ratio:.3e} (bound {SHIFT_INVARIANT_REL}); "
              f"left out of the bf16 update pins")
        if not ratio <= SHIFT_INVARIANT_REL:
            failures.append(f"{key}: gradient {ratio:.3e} of the weight's, not zero")
    for tag in ("bf16 eager", "bf16 fused", "float64 eager"):
        rel = abs(losses[tag] - losses["fp32 eager"]) / abs(losses["fp32 eager"])
        print(f"{name} one step loss {tag} {losses[tag]!r} vs fp32 eager "
              f"{losses['fp32 eager']!r}: rel diff {rel:.3e} (bound {BF16_VAL_SCALED})")
        upd = {}
        for key in params:
            got, want = states[tag][key] - init[key], ref[key] - init[key]
            upd[key] = bf16_measure(got, want) + (rel_l2(got, want),)
        pinned = [k for k in params if k not in exempt]
        worst = min(pinned, key=lambda k: upd[k][1])
        widest = max(pinned, key=lambda k: upd[k][0])
        print(f"{name} step update, {tag} vs fp32 eager over {len(pinned)} parameters: "
              f"cosine lowest {upd[worst][1]:.6f} at {worst}, median "
              f"{statistics.median(upd[k][1] for k in pinned):.6f}; scaled max error largest "
              f"{upd[widest][0]:.3e} at {widest}; relative L2 median "
              f"{statistics.median(upd[k][2] for k in pinned):.3e} (bounds cosine >= "
              f"{BF16_GRAD_COS}, scaled <= {BF16_GRAD_SCALED})"
              + "".join(f"; {k} (left out) cosine {upd[k][1]:.6f}, scaled {upd[k][0]:.3e}"
                        for k in exempt))
        if tag == "float64 eager":  # a reading of the step's conditioning
            continue
        if not rel <= BF16_VAL_SCALED:
            failures.append(f"{tag} loss rel diff {rel}")
        failures += [f"{tag} update {k}: scaled {u[0]:.3e} cos {u[1]:.6f}"
                     for k, u in upd.items() if not bf16_ok("grad", u[0], u[1])
                     and k not in exempt]
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


# The probe phase's card-vs-CPU check of one eval batch's logits (64 rows
# of the test split, the frozen encoder and the trained classifier run by
# the port on the card and on the CPU), relative L2 over the logits. fp32
# (TF32 off): two summation orders of a K-term product differ by about
# sqrt(K) u relative (K <= 4608 for rn50, u = 2^-24: 4e-6 a layer); the
# eval-mode encoder is affine between ReLUs, so ~54 layers add up to
# ~2.2e-4, and the bound is ~4x that. bf16: both sides round each conv and
# BN output to bf16 from fp32 sums that differ by the fp32 amount, so ~1e-3
# of the elements (4e-6 over bf16's 2^-8 spacing, times sqrt(K)) land one
# bf16 step (2^-8 relative) apart: ~1.2e-4 relative L2 a layer, ~6.6e-3
# over 54 layers, and the bound is ~3x that.
PROBE_LOGITS_REL_L2 = {False: 1e-3, True: 2e-2}
PROBE_ROWS = 64


def cuda_call_ms(fn, calls=20, warmup=3):
    """Median of ``calls`` single calls, each timed by its own CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def probe_argv(workdir, ckpt, bf16):
    """``train.linear.main``'s arguments for the probe at full width (rn50,
    batch 512, one epoch of ``--dataset synthetic``) from ``ckpt``."""
    return [
        "--model", "resnet50", "--dataset", "synthetic", "--epochs", "1", "--batch_size", "512",
        "--ckpt", ckpt, "--print_freq", "1", "--data_placement", "host",
        "--workdir", tempfile.mkdtemp(prefix="probe_", dir=workdir),
    ] + (["--bf16"] if bf16 else [])


def probe_run(dev, workdir, ckpt, bf16, where):
    """The probe's entry point ``train.linear.main`` at full width (rn50,
    batch 512, one epoch of ``--dataset synthetic``) on ``cuda`` from the
    pretrain checkpoint ``ckpt``, the launch counters set to 0 just before
    and read just after. Raises unless the losses are finite, top-1 and
    top-5 lie in [0, 100], no kernel launched (the frozen eval-mode encoder
    runs no fused kernel), the encoder's parameters and BN buffers are
    bitwise those of ``ckpt``, ``classifier_best.pth`` reloads to the same
    logits, and one eval batch's logits on the card match the port's CPU
    run of the same weights (``PROBE_LOGITS_REL_L2``). Prints the probe
    step's and the validation pass's times. Returns the run's ``history``,
    ``val`` and ``classifier`` state as the run ended."""
    from simclr_pytorch_distributed_tpu_torch.data.cifar import synthetic_dataset
    from simclr_pytorch_distributed_tpu_torch.models import LinearClassifier, SupConResNet
    from simclr_pytorch_distributed_tpu_torch.ops.augment import (
        AugmentConfig,
        augment_batch,
        eval_batch,
    )
    from simclr_pytorch_distributed_tpu_torch.train import linear
    from simclr_pytorch_distributed_tpu_torch.train.supcon import compute_dtype
    from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import (
        load_classifier,
        load_model_state,
    )
    name = f"probe resnet50 {'bf16' if bf16 else 'fp32'}"
    before = load_model_state(ckpt)
    counters = kernel_counters()
    for mod, counter in counters:
        setattr(mod, counter, 0)
    t0 = time.time()
    result = linear.main(probe_argv(workdir, ckpt, bf16))
    wall = time.time() - t0
    # the timing below steps the classifier on: the run as it ended
    reference = {"history": result.history, "val": result.val_history,
                 "classifier": {k: v.clone() for k, v in result.state.model.state_dict().items()}}
    launches = {counter: getattr(mod, counter) for mod, counter in counters}
    val = result.val_history[0]
    losses = [h["loss"] for h in result.history]
    print(f"{name}: {len(losses)} steps, losses {losses}, validation {val}, best top-1 "
          f"{result.best_acc} top-5 {result.best_acc5}, run wall {wall:.2f} s")
    failures = []
    if any(launches.values()):
        failures.append(f"kernel launches in the probe: {launches}")
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses + [val["loss"]]):
        failures.append("expected 3 finite step losses and a finite validation loss")
    if not all(0.0 <= x <= 100.0 for x in (val["top1"], val["top5"], result.best_acc,
                                           result.best_acc5)):
        failures.append("top-1 or top-5 outside [0, 100]")
    after = result.model.state_dict()
    changed = [k for k in before if k.startswith("encoder.")
               and not torch.equal(after[k].cpu(), before[k])]
    print(f"{name}: encoder tensors changed by the probe: {len(changed)} of "
          f"{sum(k.startswith('encoder.') for k in before)}")
    if changed:
        failures.append(f"the probe changed encoder tensors {changed[:4]}")
    if result.classifier_path is None:
        failures.append("no classifier_best.pth was written")
        raise AssertionError(f"{name}:\n" + "\n".join(failures))
    reloaded = LinearClassifier("resnet50", 10).to(dev)
    reloaded.load_state_dict(load_classifier(result.classifier_path))
    data, test = synthetic_dataset()
    mean, std = linear.stats_for("synthetic")
    aug_cfg = AugmentConfig(mean=mean, std=std, color_ops=False)
    x = torch.from_numpy(test["images"][:PROBE_ROWS]).to(dev)
    feats = linear.encode(result.model, eval_batch(x, aug_cfg))
    with torch.no_grad():
        card = result.state.model(feats)
        if not torch.equal(reloaded(feats), card):
            failures.append("classifier_best.pth does not reload to the same logits")
    cpu_model = SupConResNet("resnet50")
    linear.load_encoder(cpu_model, before)
    cpu_model.encoder.set_compute_dtype(compute_dtype(bf16))
    cpu_model.eval().requires_grad_(False)
    cpu_clf = LinearClassifier("resnet50", 10)
    cpu_clf.load_state_dict({k: v.cpu() for k, v in result.state.model.state_dict().items()})
    with torch.no_grad():
        host = cpu_clf(linear.encode(cpu_model, eval_batch(x.cpu(), aug_cfg)))
    rel = (torch.linalg.norm(card.cpu() - host) / torch.linalg.norm(host)).item()
    print(f"{name}: {PROBE_ROWS} eval rows' logits, card vs the port on the CPU: relative L2 "
          f"{rel:.3e} (bound {PROBE_LOGITS_REL_L2[bf16]}), top-1 agreement "
          f"{(card.cpu().argmax(1) == host.argmax(1)).float().mean().item():.4f}")
    if not rel <= PROBE_LOGITS_REL_L2[bf16]:
        failures.append(f"card vs CPU logits relative L2 {rel:.3e}")
    if failures:
        raise AssertionError(f"{name}:\n" + "\n".join(failures))
    # times: one probe step as the driver runs it, and one validation pass
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x = torch.from_numpy(data["images"][:512]).to(dev)
    y = torch.from_numpy(data["labels"][:512]).to(dev).long()
    step_ms = cuda_call_ms(
        lambda: linear.probe_step(result.model, result.state, augment_batch(gen, x, aug_cfg), y))
    val_ms = cuda_call_ms(lambda: linear.run_validation(
        result.model, result.state.model, test["images"], test["labels"], 256, aug_cfg, dev),
        calls=5, warmup=1)
    steps_ms = [h["step_time"] * 1e3 for h in result.history]
    print(f"{name} step (augment, frozen eval-mode encoder, classifier, loss, SGD; batch 512, "
          f"32 px) median of 20 {step_ms:.2f} ms by CUDA events; the run's step times "
          f"{[round(t, 2) for t in steps_ms]} ms; validation pass over the {len(test['images'])}"
          f"-image test split at batch 256 {val_ms:.2f} ms (median of 5), the run's "
          f"{val['seconds'] * 1e3:.2f} ms {where}")
    return reference


RESUME_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from simclr_pytorch_distributed_tpu_torch.train import supcon
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import train_step
from simclr_pytorch_distributed_tpu_torch.utils import preempt
losses = []
def step(state, cfg, views, labels):
    metrics = train_step(state, cfg, views, labels)
    losses.append(metrics["loss"].item())
    if len(losses) == 3:
        # hold after step 3 until the parent's SIGTERM sets the flag
        print("STEP3", flush=True)
        deadline = time.time() + 120
        while not preempt.requested():
            if time.time() > deadline:
                raise RuntimeError("no SIGTERM came")
            time.sleep(0.01)
    return metrics
supcon.train_step = step
try:
    supcon.main(json.loads(sys.argv[3]))
finally:
    with open(sys.argv[2], "w") as fh:
        json.dump(losses, fh)
"""


def same_run(name, got, got_losses, want, want_losses, phase="resume", want_name="straight"):
    """Raises unless two pretrain runs ended bitwise equal: every step's
    loss, model parameters and BN buffers, SGD momentum, ``step`` and
    ``record_norm_mean``."""
    bad = []
    if got_losses != want_losses:
        bad.append(f"losses {got_losses} vs {want_losses}")
    if got.state.step != want.state.step:
        bad.append(f"step {got.state.step} vs {want.state.step}")
    if not torch.equal(got.state.record_norm_mean, want.state.record_norm_mean):
        bad.append("record_norm_mean")
    gs, ws = got.state.model.state_dict(), want.state.model.state_dict()
    bad += [k for k in ws if not torch.equal(gs[k], ws[k])]
    go = got.state.optimizer.state_dict()["state"]
    wo = want.state.optimizer.state_dict()["state"]
    bad += [f"momentum {k}" for k in wo
            if not torch.equal(go[k]["momentum_buffer"], wo[k]["momentum_buffer"])]
    print(f"{phase}: {name} vs {want_name}: {len(got_losses)} losses, {len(ws)} model "
          f"tensors, {len(wo)} momentum buffers, step {got.state.step}: "
          + ("bitwise equal" if not bad else f"{len(bad)} differ"))
    if bad:
        raise AssertionError(f"{phase}: {name} differs from the {want_name} run: {bad[:8]}")


def resume_argv(workdir, epochs, *extra):
    """The resume phase's rn18 run at full width (batch 256, 32 px) with
    ``--conv_impl fused --loss_impl fused``, constant lr 0.5, in a new
    directory under ``workdir``."""
    return ["--device", "cuda", "--dataset", "synthetic", "--model", "resnet18",
            "--batch_size", "256", "--size", "32", "--method", "SimCLR", "--temp", str(TEMP),
            "--learning_rate", "0.5", "--loss_impl", "fused", "--conv_impl", "fused",
            "--print_freq", "1", "--data_placement", "host", "--epochs", str(epochs),
            "--workdir", tempfile.mkdtemp(prefix="resume_", dir=workdir)] + list(extra)


def sigterm_after_step3(child, argv, workdir, label):
    """Run ``argv`` in a subprocess of ``child`` (``RESUME_CHILD`` or
    ``CE_CHILD``), SIGTERM it when it prints ``STEP3``; returns ``(exit
    code, saved .pth paths, the child's step losses)``."""
    losses_path = os.path.join(workdir, f"{label}_losses.json")
    proc = subprocess.Popen([sys.executable, "-c", child, REPO, losses_path, json.dumps(argv)],
                            stdout=subprocess.PIPE, text=True)
    try:
        for line in proc.stdout:
            if line.strip() == "STEP3":
                proc.send_signal(signal.SIGTERM)
                break
        proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    saved = glob.glob(os.path.join(argv[argv.index("--workdir") + 1], "*", "*", "*.pth"))
    with open(losses_path) as fh:
        return proc.returncode, saved, json.load(fh)


def resume_phase(workdir):
    """rn18 at full width (:func:`resume_argv`) through
    ``train.supcon.main``: two epochs straight;
    one epoch, then ``--resume`` for the second; a subprocess that gets
    SIGTERM after step 3 of epoch 1, must exit 75, and whose ``--resume``
    finishes the two epochs. All three must end bitwise equal. Then a
    non-finite loss (``--learning_rate inf``) must exit 1 with
    ``crash_epoch_1.pth`` holding the epoch-top state (the seed's init).
    No ``--cosine``: its schedule depends on ``--epochs``, and the
    one-epoch run must follow the two-epoch run's. Returns the straight
    run."""
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import load_model_state

    straight = supcon.main(resume_argv(workdir, 2))
    want = [h["loss"] for h in straight.history]
    first = supcon.main(resume_argv(workdir, 1))
    resumed = supcon.main(resume_argv(workdir, 2, "--resume", first.save_folder))
    same_run("one epoch, then --resume", resumed,
             [h["loss"] for h in first.history + resumed.history], straight, want)

    code, saved, child_losses = sigterm_after_step3(RESUME_CHILD, resume_argv(workdir, 2),
                                                    workdir, "preempted")
    print(f"resume: the SIGTERM'd run exited {code}, saved "
          f"{[os.path.basename(p) for p in saved]}")
    if code != 75 or [os.path.basename(p) for p in saved] != ["preempt_epoch_1_step_3.pth"]:
        raise AssertionError("the SIGTERM'd run must exit 75 with preempt_epoch_1_step_3.pth")
    again = supcon.main(resume_argv(workdir, 2, "--resume", os.path.dirname(saved[0])))
    same_run("SIGTERM after step 3, then --resume", again,
             child_losses + [h["loss"] for h in again.history], straight, want)

    crash_argv = resume_argv(workdir, 1, "--learning_rate", "inf")
    try:
        supcon.main(crash_argv)
        code = 0
    except SystemExit as e:
        code = e.code
    crash = glob.glob(os.path.join(crash_argv[crash_argv.index("--workdir") + 1], "*", "*",
                                   "crash_epoch_1.pth"))
    print(f"resume: a non-finite loss exited {code}, saved {[os.path.basename(p) for p in crash]}")
    if code != 1 or len(crash) != 1:
        raise AssertionError("a non-finite loss must exit 1 with crash_epoch_1.pth")
    meta = torch.load(crash[0], map_location="cpu", weights_only=True)
    torch.manual_seed(0)
    init = SupConResNet("resnet18").state_dict()
    top = load_model_state(crash[0])
    if ((meta["epoch"], meta["step"], meta["step_in_epoch"]) != (0, 0, 0)
            or any(not torch.equal(top[k], v) for k, v in init.items())):
        raise AssertionError("crash_epoch_1.pth does not hold the epoch-top state")
    print("resume: crash_epoch_1.pth holds epoch 0, step 0, step_in_epoch 0 and the seed's "
          "init, bitwise")
    return straight


def recipe_batch(dev, batch_size=256):
    """The step checks' batch: the first ``batch_size`` synthetic images and
    labels on the card, the generator (seeded 3) and its two crops
    ``[batch_size, 2, 32, 32, 3]``; the same on every call."""
    from simclr_pytorch_distributed_tpu_torch.data.cifar import synthetic_dataset
    from simclr_pytorch_distributed_tpu_torch.ops.augment import AugmentConfig, two_crop_batch
    data, _ = synthetic_dataset()
    images = torch.from_numpy(data["images"][:batch_size]).to(dev)
    labels = torch.from_numpy(data["labels"][:batch_size]).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    views = two_crop_batch(gen, images, AugmentConfig(mean=(0.5,) * 3, std=(0.25,) * 3))
    return images, labels, gen, views


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# (b)'s ranks: two processes on the one card, gloo over CUDA tensors
GLOO_WORLD = 2
GLOO_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
getattr(chip_smoke, sys.argv[5])(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
"""
COLLECTIVES = ("all_reduce", "all_gather", "broadcast")


def time_collectives(fn):
    """Run ``fn`` with every ``torch.distributed`` collective the port calls
    timed on the host clock, the card synchronized before and after each
    call. Returns ``(total_s, {name: [calls, seconds, longest call's
    seconds]})``."""
    import torch.distributed as dist
    spent = {name: [0, 0.0, 0.0] for name in COLLECTIVES}
    originals = {name: getattr(dist, name) for name in COLLECTIVES}

    def timed(name, call):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call(*args, **kwargs)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            spent[name][0] += 1
            spent[name][1] += took
            spent[name][2] = max(spent[name][2], took)
            return out
        return run

    for name, call in originals.items():
        setattr(dist, name, timed(name, call))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for name, call in originals.items():
            setattr(dist, name, call)
    return total, spent


def torchrun_world1(argv):
    """``train.supcon.main(argv)`` under torchrun's environment for a world
    of one process: the entry point joins a process group over NCCL."""
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return supcon.main(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def gloo_rank(rank, world, outdir):
    """One process of the distributed phase's run (b): process ``rank`` of
    ``world`` on the one card, gloo over CUDA tensors, rendezvous through
    ``file://outdir/store``. One ResNet-50 step at the recipe's width with
    ``--syncBN``, eager convs and the sharded fused loss on its slice of
    the global batch of 256; then three timed steps and one with its
    collectives timed. Writes its state after the first step and a JSON
    summary into ``outdir``."""
    import datetime
    import torch.distributed as dist
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
    from simclr_pytorch_distributed_tpu_torch.ops import fused_loss
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
        SupConStepConfig,
        train_step,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh.setup_distributed("cuda", init_method=f"file://{os.path.join(outdir, 'store')}",
                           rank=rank, world_size=world, backend="gloo",
                           timeout=datetime.timedelta(seconds=300))
    _, labels, _, views = recipe_batch(dev)
    b = views.shape[0] // world
    mine = (views[rank * b:(rank + 1) * b], labels[rank * b:(rank + 1) * b])
    torch.manual_seed(0)
    model = SupConResNet("resnet50").to(dev, memory_format=torch.channels_last)
    model.encoder.set_conv_impl("eager").set_bn_sync(dist.group.WORLD)
    state = TrainState(model=model, optimizer=make_optimizer(model), schedule=lambda s: 0.5)
    cfg = SupConStepConfig(temperature=TEMP, loss_impl="fused", epochs=1, steps_per_epoch=7)
    fused_loss.fwd_launches = fused_loss.bwd_launches = 0
    loss = train_step(state, cfg, *mine)["loss"].item()
    launches = [fused_loss.fwd_launches, fused_loss.bwd_launches]
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(outdir, f"state{rank}.pt"))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, cfg, *mine)["loss"].item()
        times.append(time.perf_counter() - t0)
    total, spent = time_collectives(lambda: train_step(state, cfg, *mine)["loss"].item())
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump({"loss": loss, "launches": launches, "step_s": times,
                   "timed_step_s": total, "collectives": spent}, fh)
    mesh.teardown_distributed()


def run_gloo_ranks(outdir, world=GLOO_WORLD, timeout=600, target="gloo_rank",
                   label="distributed (b)"):
    """Run ``target`` (:func:`gloo_rank` unless named) in ``world``
    processes to the end; a failed or overrunning process kills its peers,
    and the phase fails. Returns each rank's ``rank{r}.json``."""
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_CHILD, REPO, str(r), str(world),
                               outdir, target], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for r, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=timeout)
            outs.append(out)
            if proc.returncode != 0:
                raise AssertionError(f"{label}: rank {r} exited {proc.returncode}:\n"
                                     f"{out[-6000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    summaries = []
    for r in range(world):
        with open(os.path.join(outdir, f"rank{r}.json")) as fh:
            summaries.append(json.load(fh))
    return summaries


def distributed_phase(workdir, result, expected, model, views, labels, where):
    """The data-parallel path on the card.

    (a) ``train.supcon.main`` under torchrun's environment at world size 1
    (NCCL), one epoch of ResNet-50 fp32 at the recipe's width with
    ``--conv_impl fused --loss_impl fused --syncBN``: it goes through the
    process group, the feature gather, the sharded loss and the gradient
    mean, and must end bitwise equal to the train phase's run ``result``
    (the same arguments without a process group), launching ``expected``.
    (b) Two processes on the one card over gloo (NCCL takes one process a
    card): one step of ResNet-50 at the recipe's width, 128 rows a process,
    ``--syncBN``, eager convs, the sharded fused loss, against the
    one-process eager step on the global batch from the same init (``model``,
    ``views``, ``labels``) at the step pins; both processes launch both loss
    kernels once and end equal. Its times go through host memory: context,
    no measure of scaling."""
    from simclr_pytorch_distributed_tpu_torch.ops import fused_loss
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
        SupConStepConfig,
        train_step,
    )
    # (a) world size 1 through NCCL
    def world1_run():
        return torchrun_world1(recipe_argv("resnet50", workdir) + ["--syncBN"])

    counters = kernel_counters()
    for mod, name in counters:
        setattr(mod, name, 0)
    world1 = world1_run()
    launches = {name: getattr(mod, name) for mod, name in counters}
    print(f"distributed (a): world size 1 (NCCL) kernel launches in the run: {launches}; "
          f"the loss's {launches['fwd_launches']} forward and {launches['bwd_launches']} "
          f"backward launches all through the sharded form (fused_sharded_supcon_loss)")
    if launches != expected:
        raise AssertionError(f"distributed (a): expected launches {expected}, got {launches}")
    with open(os.path.join(world1.save_folder, "log-ing")) as fh:
        banner = [line.strip() for line in fh if "[loss_impl]" in line]
    print(f"distributed (a) banner: {banner}")
    if len(banner) != 1 or "sharded over 1 process(es)" not in banner[0]:
        raise AssertionError(f"distributed (a): the [loss_impl] banner does not name the "
                             f"sharded form: {banner}")
    same_run("world size 1 under torchrun's environment, --syncBN", world1,
             [h["loss"] for h in world1.history], result, [h["loss"] for h in result.history],
             phase="distributed (a)", want_name="the train phase's run without a process group")
    # the step times in turns: without, with, with, without a process group
    runs = [result, world1, world1_run(), supcon.main(recipe_argv("resnet50", workdir))]
    ms = [statistics.median(h["step_time"] for h in run.history[2:7]) * 1e3 for run in runs]
    print(f"distributed (a): ResNet-50 fp32 fused step, median of steps 3-7, runs in turns "
          f"without / with / with / without a process group: "
          f"{' / '.join(f'{t:.2f}' for t in ms)} ms; with minus without "
          f"{(ms[1] + ms[2] - ms[0] - ms[3]) / 2:+.2f} ms {where}")
    del world1, runs
    torch.cuda.empty_cache()

    # (b) two ranks on the one card over gloo
    outdir = tempfile.mkdtemp(prefix="gloo_", dir=workdir)
    ranks = run_gloo_ranks(outdir)
    states = [torch.load(os.path.join(outdir, f"state{r}.pt"), map_location="cpu",
                         weights_only=True) for r in range(GLOO_WORLD)]
    bad = [k for k in states[0] if not torch.equal(states[0][k], states[1][k])]
    print(f"distributed (b): {GLOO_WORLD} processes on one card (gloo): loss kernel launches "
          f"per rank in the step {[r['launches'] for r in ranks]}, losses "
          f"{[r['loss'] for r in ranks]}, rank 1's state after the step equal to rank 0's on "
          f"{len(states[0]) - len(bad)} of {len(states[0])} tensors")
    failures = []
    if any(r["launches"] != [1, 1] for r in ranks):
        failures.append("a rank did not launch both loss kernels once")
    if bad or len({r["loss"] for r in ranks}) != 1:
        failures.append(f"the ranks differ: {bad[:8]}")
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = {k for k, _ in model.named_parameters()}
    m = copy.deepcopy(model)
    m.encoder.set_conv_impl("eager")
    st = TrainState(model=m, optimizer=make_optimizer(m), schedule=lambda s: 0.5)
    cfg = SupConStepConfig(temperature=TEMP, loss_impl="fused", epochs=1, steps_per_epoch=7)
    ref_loss = train_step(st, cfg, views, labels)["loss"].item()
    ref = {k: v.detach().double().cpu() for k, v in m.state_dict().items()}
    del m, st
    torch.cuda.empty_cache()
    rel = abs(ranks[0]["loss"] - ref_loss) / abs(ref_loss)
    got = {k: v.double() if v.is_floating_point() else v for k, v in states[0].items()}
    upd_err = []
    buf_worst = (0.0, None)
    for key, want in ref.items():
        if key in params:
            upd = want - init[key].double().cpu()
            err = ((got[key] - init[key].double().cpu()) - upd).norm() / upd.norm()
            upd_err.append((err.item(), key))
        elif want.is_floating_point():
            buf_worst = max(buf_worst, ((got[key] - want).abs().max().item(), key))
            if ((got[key] - want).abs() - STEP_BUF_TOL * (1 + want.abs())).max().item() > 0:
                failures.append(f"buffer {key} off by more than rtol/atol {STEP_BUF_TOL}")
        elif not torch.equal(got[key], want):
            failures.append(f"buffer {key}: {got[key]} != {want}")
    worst = max(upd_err)
    print(f"distributed (b) vs the one-process eager --syncBN step on the global batch: loss "
          f"{ranks[0]['loss']!r} vs {ref_loss!r}, rel diff {rel:.3e} (bound 1e-4); update "
          f"relative L2 worst {worst[0]:.3e} at {worst[1]}, median "
          f"{statistics.median(e for e, _ in upd_err):.3e} over {len(upd_err)} parameters "
          f"(bound {STEP_UPDATE_REL_L2}); BN buffers max abs diff {buf_worst[0]:.3e} at "
          f"{buf_worst[1]} (bound rtol/atol {STEP_BUF_TOL})")
    if not rel <= 1e-4:
        failures.append(f"loss off by {rel}")
    if not worst[0] <= STEP_UPDATE_REL_L2:
        failures.append(f"update relative L2 {worst}")
    for r, summary in enumerate(ranks):
        spent = summary["collectives"]
        print(f"distributed (b) rank {r}: step {statistics.median(summary['step_s']) * 1e3:.2f} "
              f"ms (median of 3; all {[round(t * 1e3, 2) for t in summary['step_s']]}); a step "
              f"with each collective synchronized and timed {summary['timed_step_s'] * 1e3:.2f} "
              f"ms, of which " + ", ".join(
                  f"{name} {calls} calls {sec * 1e3:.2f} ms (longest {top * 1e3:.2f})"
                  for name, (calls, sec, top) in spent.items())
              + f" {where}; gloo stages CUDA tensors through host memory on "
              "one card: context, not a measure of scaling")
    if failures:
        raise AssertionError("distributed (b):\n" + "\n".join(failures))


# The tensor_parallel phase (``--model_parallel``): gloo over CUDA tensors on
# the one card (NCCL takes one process a card), lines ``tensor_parallel (a)``
# to ``(c)``.
TP_N = 2
TP_BATCH = 128  # (a), (b): global batch; gloo moves rn50 activations via the host
TP_STEP_LOSS_RTOL, TP_PARAM_RTOL, TP_PARAM_ATOL = 2e-5, 1e-3, 2e-5  # JAX's TP pins
TP_DRIVER_BATCH = 512  # (c): 3 steps an epoch of the 1792 synthetic images
# (d): the recipes at data 1 x model 2, ResNet-18 at the recipe's width and
# the global batch TP_BATCH: label -> the SupConConfig overrides
# (attach_recipe); the queue's K a multiple of 2 x 256. The default
# predictor (hidden 512) shards fc1, its normalization and fc2 at N = 2
TP_RECIPE_QUEUE = 512
TP_RECIPES = {
    "byol": {"recipe": "byol"}, "simsiam": {"recipe": "simsiam"},
    "vicreg": {"recipe": "vicreg"},
    "simclr+queue": {"recipe": "simclr", "moco_queue": TP_RECIPE_QUEUE},
}
TP_RECIPE_MODEL = "resnet18"
TP_QUEUE_REL_L2 = 1e-4  # the keys written: a forward of the same weights


def tp_state_bytes(model, optimizer) -> int:
    """This process's training state: parameters, buffers and momentum."""
    tensors = list(model.state_dict().values()) + [
        t for st in optimizer.state.values() for t in st.values() if torch.is_tensor(t)]
    return sum(t.numel() * t.element_size() for t in tensors)


def tp_step_run(model_name, world, rank, outdir, sync_bn):
    """One tensor-parallel step of ``model_name`` at the recipe's width on
    this process's data slice and shards of the global batch of
    :data:`TP_BATCH`: eager convs, the fused loss (its single-device form at
    data 1, the sharded form over the data group above). Then a second step
    with its collectives counted. Saves the shards and returns a summary."""
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
    from simclr_pytorch_distributed_tpu_torch.ops import fused_loss
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    from simclr_pytorch_distributed_tpu_torch.train import supcon_step
    from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
    from simclr_pytorch_distributed_tpu_torch.utils import profiling
    dev = torch.device("cuda", 0)
    mesh.setup_grid(TP_N)
    _, labels, _, views = recipe_batch(dev, TP_BATCH)
    d, n_data = mesh.data_index(), mesh.data_parallel()
    b = TP_BATCH // n_data
    mine = (views[d * b:(d + 1) * b], labels[d * b:(d + 1) * b])
    torch.manual_seed(0)
    model = SupConResNet(model_name).to(dev, memory_format=torch.channels_last)
    model.encoder.set_conv_impl("eager").set_bn_sync(mesh.data_group() if sync_bn else None)
    replicated = 2 * sum(p.numel() * p.element_size() for p in model.parameters()) + sum(
        t.numel() * t.element_size() for t in model.buffers())
    layout = mesh.shard_module(model, TP_N, mesh.model_index())
    state = TrainState(model=model, optimizer=make_optimizer(model), schedule=lambda s: 0.5)
    cfg = supcon_step.SupConStepConfig(temperature=TEMP, loss_impl="fused", epochs=1,
                                       steps_per_epoch=7)
    sharded_calls = [0]
    sharded = supcon_step.fused_sharded_supcon_loss

    def counting(*args, **kwargs):
        sharded_calls[0] += 1
        return sharded(*args, **kwargs)

    supcon_step.fused_sharded_supcon_loss = counting
    try:
        fused_loss.fwd_launches = fused_loss.bwd_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = supcon_step.train_step(state, cfg, *mine)["loss"].item()
        step_s = time.perf_counter() - t0
        launches = [fused_loss.fwd_launches, fused_loss.bwd_launches, sharded_calls[0]]
        torch.save({"state": {k: v.cpu() for k, v in model.state_dict().items()},
                    "momentum": {n: state.optimizer.state[p]["momentum_buffer"].cpu()
                                 for n, p in model.named_parameters()}},
                   os.path.join(outdir, f"{model_name}_{rank}.pt"))
        state_bytes = tp_state_bytes(model, state.optimizer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        supcon_step.train_step(state, cfg, *mine)["loss"].item()
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spent = profiling.count_collectives(
            lambda: supcon_step.train_step(state, cfg, *mine)["loss"].item())
        counted_s = time.perf_counter() - t0
    finally:
        supcon_step.fused_sharded_supcon_loss = sharded
    health_sync = tp_health_norm_sync(model)
    del state, model
    torch.cuda.empty_cache()
    return {"loss": loss, "launches": launches, "step_s": step_s, "warm_s": warm_s,
            "counted_s": counted_s,
            "collectives": spent, "state_bytes": state_bytes, "replicated_bytes": replicated,
            "sharded_tensors": len(layout), "rows": 2 * b, "health_sync": health_sync}


def tp_health_norm_sync(model):
    """The health gradient norm of a tensor-parallel step
    (``supcon_step.global_grad_norm`` over ``mesh.whole_norms``) run a
    second time under ``torch.cuda.set_sync_debug_mode("error")``, with the
    model group's all-reduce stubbed (gloo stages CUDA tensors through the
    host and waits; NCCL does not): ``None`` when nothing in it waits for
    the card, else the error. The first call uploads the sharded-leaf
    flags, once."""
    import torch.distributed as dist
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    from simclr_pytorch_distributed_tpu_torch.train import supcon_step
    supcon_step.global_grad_norm(model.parameters(), mesh.model_group())
    torch.cuda.synchronize()
    all_reduce = dist.all_reduce
    dist.all_reduce = lambda tensor, group=None: None
    torch.cuda.set_sync_debug_mode("error")
    try:
        supcon_step.global_grad_norm(model.parameters(), mesh.model_group())
        return None
    except RuntimeError as e:
        return str(e).splitlines()[0][:200]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        dist.all_reduce = all_reduce


def tp_driver_argv(workdir, name, *extra):
    return ["--dataset", "synthetic", "--model", "resnet18", "--batch_size",
            str(TP_DRIVER_BATCH), "--epochs", "2", "--save_freq", "1", "--learning_rate", "0.5",
            "--temp", str(TEMP), "--cosine", "--method", "SimCLR", "--syncBN",
            "--loss_impl", "fused", "--print_freq", "3", "--data_placement", "host",
            "--workdir", os.path.join(workdir, name), "--trial", name, *extra]


def tp_rank(rank, world, outdir):
    """One process of the tensor_parallel phase on the one card (gloo over
    CUDA tensors). At world 2 (data 1 x model 2): (a) the ResNet-50 step,
    then (c) the driver at ``--model_parallel 2`` for two epochs of
    ResNet-18 and its first-epoch save resumed at ``--model_parallel 1``,
    then (d) a step of each of ``TP_RECIPES`` and the byol driver at
    ``--model_parallel 2`` with its first-epoch save resumed at 1. At
    world 4 (data 2 x model 2): (b) the ResNet-18 ``--syncBN`` step through
    the sharded fused loss over the data group."""
    import datetime
    from simclr_pytorch_distributed_tpu_torch.ops import fused_loss
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(torch.device("cuda", 0))
    mesh.setup_distributed("cuda", init_method=f"file://{os.path.join(outdir, 'store')}",
                           rank=rank, world_size=world, backend="gloo",
                           timeout=datetime.timedelta(seconds=600))
    out = {}
    if world == 2:
        out["a"] = tp_step_run("resnet50", world, rank, outdir, sync_bn=True)
        fused_loss.fwd_launches = fused_loss.bwd_launches = 0
        t0 = time.perf_counter()
        straight = supcon.main(tp_driver_argv(outdir, "straight", "--model_parallel", "2"))
        out["c"] = {"losses": [h["loss"] for h in straight.history],
                    "folder": straight.save_folder, "s": time.perf_counter() - t0,
                    "launches": [fused_loss.fwd_launches, fused_loss.bwd_launches]}
        del straight
        torch.cuda.empty_cache()
        resumed = supcon.main(tp_driver_argv(
            outdir, "resumed", "--model_parallel", "1", "--resume",
            os.path.join(out["c"]["folder"], "ckpt_epoch_1.pth")))
        out["c"]["resumed_losses"] = [h["loss"] for h in resumed.history]
        out["c"]["resumed_folder"] = resumed.save_folder
        del resumed
        torch.cuda.empty_cache()
        out["d"] = {label: tp_recipe_step_run(label, rank, outdir) for label in TP_RECIPES}
        out["d_driver"] = tp_recipe_driver_run(outdir)
    else:
        out["b"] = tp_step_run("resnet18", world, rank, outdir, sync_bn=True)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    mesh.teardown_distributed()


def tp_reference(model_name, dev):
    """The one-process eager step of :func:`tp_step_run` on the global
    batch from the same init: fp32 with the fused loss, and float64 with the
    dense loss (the yardstick of fp32 noise, as in :func:`step_check`).
    Returns ``{"init", "fp32", "f64"}``: ``(loss, state, momentum)`` on the
    host for each dtype, and the init. TF32 is off, as in the processes."""
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
    from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
        SupConStepConfig,
        train_step,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, labels, _, views = recipe_batch(dev, TP_BATCH)
    out = {}
    for name, dtype, loss_impl in (("fp32", torch.float32, "fused"),
                                   ("f64", torch.float64, "dense")):
        torch.manual_seed(0)
        model = SupConResNet(model_name).to(dev, memory_format=torch.channels_last)
        out.setdefault("init", {k: v.detach().cpu().clone()
                                for k, v in model.state_dict().items()})
        model = model.to(dtype)
        model.encoder.set_conv_impl("eager")
        st = TrainState(model=model, optimizer=make_optimizer(model), schedule=lambda s: 0.5)
        cfg = SupConStepConfig(temperature=TEMP, loss_impl=loss_impl, epochs=1,
                               steps_per_epoch=7)
        loss = train_step(st, cfg, views.to(dtype), labels)["loss"].item()
        out[name] = (loss, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     {n: st.optimizer.state[p]["momentum_buffer"].cpu()
                      for n, p in model.named_parameters()})
        del st, model
        torch.cuda.empty_cache()
    return out


def tp_compare(label, outdir, model_name, ranks, ref, failures):
    """Each rank's shards against its slice of the one-process step: the
    loss at JAX's pin (rtol 2e-5), each parameter's update and momentum in
    relative L2 (``STEP_UPDATE_REL_L2``) and the BN buffers at
    ``STEP_BUF_TOL``, the recipe-scale step pins of :func:`step_check`.
    JAX's elementwise parameter pins (rtol 1e-3, atol 2e-5) are printed
    beside, for the tensor-parallel step and for the one-process fp32 step
    against the float64 one: at the recipe's width two fp32 orderings of a
    step already differ beyond them (ReLU masks of values within rounding of
    zero), so they cannot bind here. Returns the worst of each measure,
    ``{name: (value, where)}``."""
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    init = ref["init"]
    ref_loss, ref_state, ref_momentum = ref["fp32"]
    f64_loss, f64_state, _ = ref["f64"]

    def shard(t, m):
        return mesh.shard_of(t, TP_N, m) if t.dim() else t

    def update_err(got, want, start):
        upd = want.double() - start.double()
        return (((got.double() - start.double()) - upd).norm() / upd.norm().clamp_min(1e-30)).item()

    def beyond_jax(got, want):
        return ((got.double() - want.double()).abs()
                - (TP_PARAM_ATOL + TP_PARAM_RTOL * want.double().abs())).max().item() > 0

    worst = {k: (0.0, "-") for k in ("update", "momentum", "update_f64", "fp32_f64", "buffer")}
    jax_beyond = {"tp": 0, "fp32_vs_f64": 0}
    bad = []
    for r, summary in enumerate(ranks):
        got = torch.load(os.path.join(outdir, f"{model_name}_{r}.pt"), weights_only=True)
        m = r % TP_N
        for key, want in ref_state.items():
            g, w = got["state"][key], shard(want, m)
            if tuple(g.shape) != tuple(w.shape):
                bad.append(f"rank {r} {key}: shape {tuple(g.shape)} != {tuple(w.shape)}")
                continue
            if not want.is_floating_point():
                if not torch.equal(g, w):
                    bad.append(f"rank {r} {key}: {g} != {w}")
                continue
            ema = key.startswith(("target.", "key."))  # updated, but without momentum
            if key not in ref_momentum and not ema:  # a BN running buffer
                excess = ((g - w).abs() - STEP_BUF_TOL * (1 + w.abs())).max().item()
                worst["buffer"] = max(worst["buffer"], ((g - w).abs().max().item(),
                                                        f"rank {r} {key}"))
                if excess > 0:
                    bad.append(f"rank {r} buffer {key}: beyond rtol/atol {STEP_BUF_TOL}")
                continue
            start, w64 = shard(init[key], m), shard(f64_state[key], m)
            tagged = lambda e: (e, f"rank {r} {key}")  # noqa: E731
            err = update_err(g, w, start)
            worst["update"] = max(worst["update"], tagged(err))
            worst["update_f64"] = max(worst["update_f64"], tagged(update_err(g, w64, start)))
            worst["fp32_f64"] = max(worst["fp32_f64"], tagged(update_err(w, w64, start)))
            merr = 0.0 if ema else relative_l2(got["momentum"][key], shard(ref_momentum[key], m))
            worst["momentum"] = max(worst["momentum"], tagged(merr))
            jax_beyond["tp"] += beyond_jax(g, w)
            jax_beyond["fp32_vs_f64"] += beyond_jax(w, w64)
            if err > STEP_UPDATE_REL_L2 or merr > STEP_UPDATE_REL_L2:
                bad.append(f"rank {r} {key}: update relative L2 {err:.3e}, momentum {merr:.3e}")
        rel = abs(summary["loss"] - ref_loss) / abs(ref_loss)
        worst["loss"] = max(worst.get("loss", (0.0, "-")), (rel, f"rank {r}"))
        if rel > TP_STEP_LOSS_RTOL:
            bad.append(f"rank {r} loss {summary['loss']!r} vs {ref_loss!r}: rel {rel:.3e}")
    n_params = sum(k in ref_momentum or k.startswith(("target.", "key."))
                   for k in ref_state) * len(ranks)
    print(f"{label} vs the one-process step on the card: losses "
          f"{[s['loss'] for s in ranks]} vs {ref_loss!r} (JAX's rtol {TP_STEP_LOSS_RTOL}; "
          f"float64 dense {f64_loss!r}); each rank's shards against their slices: update "
          f"relative L2 worst {worst['update'][0]:.3e} at {worst['update'][1]}, momentum "
          f"worst {worst['momentum'][0]:.3e} at {worst['momentum'][1]} (bound "
          f"{STEP_UPDATE_REL_L2}), BN buffers max abs diff {worst['buffer'][0]:.3e} at "
          f"{worst['buffer'][1]} (bound rtol/atol {STEP_BUF_TOL})")
    print(f"{label} beside the float64 step: update relative L2 worst, tensor-parallel vs "
          f"float64 {worst['update_f64'][0]:.3e} at {worst['update_f64'][1]}, one-process "
          f"fp32 vs float64 {worst['fp32_f64'][0]:.3e} at {worst['fp32_f64'][1]}; parameter "
          f"shards beyond JAX's elementwise pins (rtol {TP_PARAM_RTOL}, atol "
          f"{TP_PARAM_ATOL}): tensor-parallel vs one-process fp32 {jax_beyond['tp']} of "
          f"{n_params}, one-process fp32 vs float64 {jax_beyond['fp32_vs_f64']} of {n_params}")
    failures.extend(f"{label}: {b}" for b in bad[:20])
    return worst


def tp_report(label, ranks, where, rows_at=512):
    """The step's launches, state bytes, wall times and collectives, rank by
    rank; the model group's bytes also scaled to ``rows_at`` rows (the
    recipe's batch 256: every gathered tensor has one row per encoder row)."""
    for r, s in enumerate(ranks):
        groups = {}
        for key, (calls, nbytes, sec) in sorted(s["collectives"].items()):
            groups.setdefault(key, []).append(f"{calls} calls {nbytes / 2**20:.1f} MiB "
                                              f"{sec * 1e3:.1f} ms")
        print(f"{label} rank {r}: fused loss launches fwd/bwd {s['launches'][0]}/"
              f"{s['launches'][1]}, sharded-form calls {s['launches'][2]}; state "
              f"{s['state_bytes'] / 2**20:.2f} MiB (parameters, buffers, momentum; "
              f"{s['sharded_tensors']} tensors sharded) against the replicated "
              f"{s['replicated_bytes'] / 2**20:.2f} MiB = "
              f"{s['state_bytes'] / s['replicated_bytes']:.3f}; first step "
              f"{s['step_s'] * 1e3:.1f} ms, second {s['warm_s'] * 1e3:.1f} ms, a third with "
              f"every collective synchronized and counted {s['counted_s'] * 1e3:.1f} ms "
              f"{where}; collectives by name@group: " + "; ".join(f"{k}: {', '.join(v)}" for k, v in groups.items()))
    s = ranks[0]
    model_bytes = sum(nbytes for key, (calls, nbytes, sec) in s["collectives"].items()
                      if key.endswith("@model"))
    print(f"{label}: the model group's collective bytes a step "
          f"{model_bytes / 2**20:.1f} MiB at {s['rows']} encoder rows a process, "
          f"{model_bytes / s['rows'] * rows_at / 2**30:.3f} GiB scaled to {rows_at} rows")


def tp_recipe_tensors(state):
    """A recipe step's state on the host: ``(tensors, momentum, queue)``;
    ``tensors`` the model's state dict with the predictor's and the EMA
    network's parameters beside it (``predictor.*``, ``target.*``,
    ``key.*``), ``momentum`` the model's and the predictor's momentum
    buffers by those names, ``queue`` the MoCo queue and its pointer (whole
    on every rank: no sharding rule reads it)."""
    tensors = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    named = [(n, p, state.optimizer) for n, p in state.model.named_parameters()]
    if state.recipe_params is not None:
        for n, p in state.recipe_params.named_parameters():
            tensors[f"predictor.{n}"] = p.detach().cpu()
            named.append((f"predictor.{n}", p, state.recipe_opt_state))
    # the buffers a step made (none before the first)
    momentum = {n: opt.state[p]["momentum_buffer"].cpu() for n, p, opt in named
                if p in opt.state}
    queue = {}
    for key, value in (state.recipe_state or {}).items():
        if isinstance(value, torch.nn.Module):
            tensors.update({f"{key}.{n}": p.detach().cpu() for n, p in value.named_parameters()})
        elif torch.is_tensor(value):
            queue[key] = value.detach().cpu()
        else:
            queue[key] = torch.tensor(value)
    return tensors, momentum, queue


def tp_recipe_state(over, dev, dtype=torch.float32, shard=False):
    """The (d) state of one recipe: ResNet-18 from seed 0, eager convs, the
    recipe's slots attached as the driver does (:func:`attach_recipe`), the
    model sharded first under ``shard``. Returns ``(state, step config)``."""
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import SupConStepConfig
    torch.manual_seed(0)
    model = SupConResNet(TP_RECIPE_MODEL).to(dev, memory_format=torch.channels_last)
    model = model.to(dtype)
    model.encoder.set_conv_impl("eager")
    group = None
    if shard:
        mesh.shard_module(model, TP_N, mesh.model_index())
        group = mesh.model_group()
    state = TrainState(model=model, optimizer=make_optimizer(model, model_group=group),
                       schedule=lambda s: 0.5)
    method, loss_impl = attach_recipe(state, over)
    cfg = SupConStepConfig(method=method, temperature=TEMP,
                           loss_impl="dense" if dtype == torch.float64 else loss_impl,
                           epochs=1, steps_per_epoch=7)
    return state, cfg


def tp_recipe_step_run(label, rank, outdir):
    """(d) on this process: one step of recipe ``label`` at data 1 x model
    2 on the global batch, from the one-process init sharded. Saves the
    shards as :func:`tp_compare` reads them (``{label}_{rank}.pt``) and
    returns the loss, the step's wall time and the sharded slot tensors."""
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import train_step
    dev = torch.device("cuda", 0)
    mesh.setup_grid(TP_N)
    _, labels, _, views = recipe_batch(dev, TP_BATCH)
    state, cfg = tp_recipe_state(TP_RECIPES[label], dev, shard=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = train_step(state, cfg, views, labels)["loss"].item()
    step_s = time.perf_counter() - t0
    tensors, momentum, queue = tp_recipe_tensors(state)
    torch.save({"state": tensors, "momentum": momentum, "queue": queue},
               os.path.join(outdir, f"{tp_label_file(label)}_{rank}.pt"))
    sharded = sorted(k for k in tensors if k.startswith(("predictor.", "target.", "key."))
                     and mesh.is_tp_sharded(tp_live_tensor(state, k)))
    del state
    torch.cuda.empty_cache()
    return {"loss": loss, "step_s": step_s, "sharded_slots": sharded}


def tp_label_file(label):
    return label.replace("+", "_")


def tp_live_tensor(state, key):
    """The live slot parameter of a :func:`tp_recipe_tensors` name."""
    owner, name = key.split(".", 1)
    module = state.recipe_params if owner == "predictor" else state.recipe_state[owner]
    return dict(module.named_parameters())[name]


def tp_recipe_reference(label, dev):
    """The one-process step of :func:`tp_recipe_step_run` on the card from the
    same init, fp32 and float64 (dense), in :func:`tp_reference`'s form."""
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import train_step
    _, labels, _, views = recipe_batch(dev, TP_BATCH)
    out = {}
    for name, dtype in (("fp32", torch.float32), ("f64", torch.float64)):
        state, cfg = tp_recipe_state(TP_RECIPES[label], dev, dtype)
        if "init" not in out:
            out["init"] = {k: v.clone() for k, v in tp_recipe_tensors(state)[0].items()}
        loss = train_step(state, cfg, views.to(dtype), labels)["loss"].item()
        tensors, momentum, queue = tp_recipe_tensors(state)
        out[name] = (loss, tensors, momentum)
        out[f"{name}_queue"] = queue
        del state
        torch.cuda.empty_cache()
    return out


def tp_recipe_driver_argv(outdir, name, n, *extra):
    return tp_driver_argv(outdir, name, "--model_parallel", str(n), "--recipe", "byol", *extra)


def tp_recipe_driver_run(outdir):
    """(d)'s driver: ``--recipe byol --model_parallel 2`` for two epochs of
    ResNet-18 (:func:`tp_driver_argv`), then its first-epoch save resumed at
    ``--model_parallel 1``."""
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    t0 = time.perf_counter()
    straight = supcon.main(tp_recipe_driver_argv(outdir, "byol_straight", 2))
    out = {"losses": [h["loss"] for h in straight.history], "folder": straight.save_folder,
           "s": time.perf_counter() - t0}
    del straight
    torch.cuda.empty_cache()
    resumed = supcon.main(tp_recipe_driver_argv(
        outdir, "byol_resumed", 1, "--resume", os.path.join(out["folder"], "ckpt_epoch_1.pth")))
    out.update(resumed_losses=[h["loss"] for h in resumed.history],
               resumed_folder=resumed.save_folder)
    return out


def tp_recipe_checks(outdir, ranks, dev, where, failures):
    """(d) on the host: each recipe's shards against the one-process step
    (:func:`tp_compare`, the EMA network's parameters held by their update
    as the model's are), its queue whole and equal on both ranks and near
    the one-process queue, and the byol driver's whole save and its
    resume at ``--model_parallel 1``."""
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
    for label in TP_RECIPES:
        steps = [r["d"][label] for r in ranks]
        ref = tp_recipe_reference(label, dev)
        tp_compare(f"tensor_parallel (d) {TP_RECIPE_MODEL} {label}", outdir,
                   tp_label_file(label), steps, ref, failures)
        predictor = [k for k in steps[0]["sharded_slots"] if k.startswith("predictor.")]
        print(f"tensor_parallel (d) {label}: step wall time rank by rank "
              f"{[round(s['step_s'] * 1e3, 1) for s in steps]} ms {where}; sharded slot "
              f"tensors: the predictor's {len(predictor)} ({', '.join(predictor)}), the EMA "
              f"network's {len(steps[0]['sharded_slots']) - len(predictor)}")
        if label != "vicreg" and not steps[0]["sharded_slots"]:
            failures.append(f"tensor_parallel (d) {label}: no recipe slot is sharded")
        queues = [torch.load(os.path.join(outdir, f"{tp_label_file(label)}_{r}.pt"),
                             weights_only=True)["queue"] for r in range(len(ranks))]
        if queues[0]:
            want = ref["fp32_queue"]
            rel = relative_l2(queues[0]["queue_emb"], want["queue_emb"])
            same = all(torch.equal(q[k], queues[0][k]) for q in queues for k in q)
            shape = tuple(queues[0]["queue_emb"].shape)
            print(f"tensor_parallel (d) {label}: queue {shape} whole on every rank and equal "
                  f"across the model group: {same}; pointer {int(queues[0]['queue_ptr'])} "
                  f"(one process {int(want['queue_ptr'])}); relative L2 to the one-process "
                  f"queue {rel:.3e} (bound {TP_QUEUE_REL_L2})")
            if not (same and shape == tuple(want["queue_emb"].shape) and rel <= TP_QUEUE_REL_L2
                    and int(queues[0]["queue_ptr"]) == int(want["queue_ptr"])):
                failures.append(f"tensor_parallel (d) {label}: the queue differs: {shape}, "
                                f"same {same}, rel {rel}")
        torch.cuda.empty_cache()

    d = ranks[0]["d_driver"]
    last = torch.load(os.path.join(d["folder"], "last.pth"), map_location="cpu",
                      weights_only=True)
    resumed = torch.load(os.path.join(d["resumed_folder"], "last.pth"), map_location="cpu",
                         weights_only=True)
    whole = {k: tuple(v.shape) for k, v in SupConResNet(TP_RECIPE_MODEL).state_dict().items()}
    saved = {k.removeprefix("module."): tuple(v.shape) for k, v in last["model"].items()}
    predictor = {k: tuple(v.shape) for k, v in last["recipe"]["recipe_params"].items()}
    target = {k: tuple(v.shape) for k, v in last["recipe"]["recipe_state"]["target"].items()}
    whole_target = {k: v for k, v in whole.items() if k in target}
    momentum = [tuple(e["momentum_buffer"].shape)
                for e in last["recipe"]["recipe_opt_state"]["state"].values()]
    ok_whole = (saved == whole and target == whole_target
                and predictor["fc1.weight"] == (512, 128) and predictor["bn_scale"] == (512,)
                and predictor["fc2.weight"] == (128, 512)
                and momentum == [predictor[k] for k in predictor])
    tail = d["losses"][-len(d["resumed_losses"]):]
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(d["resumed_losses"], tail))

    def flat(ckpt):
        out = {f"model.{k}": v for k, v in ckpt["model"].items() if v.is_floating_point()}
        out.update({f"predictor.{k}": v for k, v in ckpt["recipe"]["recipe_params"].items()})
        out.update({f"target.{k}": v for k, v in ckpt["recipe"]["recipe_state"]["target"].items()})
        return out

    a, b = flat(resumed), flat(last)
    rel = relative_l2(torch.cat([a[k].double().flatten() for k in b]),
                      torch.cat([b[k].double().flatten() for k in b]))
    with open(os.path.join(d["resumed_folder"], "log-ing")) as fh:
        fresh = [ln.strip() for ln in fh if "start fresh" in ln or "recipe slots" in ln]
    print(f"tensor_parallel (d) driver: --recipe byol --model_parallel 2, {TP_RECIPE_MODEL} "
          f"batch {TP_DRIVER_BATCH}, 2 epochs: {len(d['losses'])} steps in {d['s']:.1f} s, "
          f"losses {[round(x, 4) for x in d['losses']]}; last.pth whole (model, predictor, "
          f"its momentum, target): {ok_whole}; the epoch-1 save resumed at --model_parallel "
          f"1: epoch-2 losses worst rel {loss_rel:.3e} (bound 1e-4), last.pth (model, "
          f"predictor, target) relative L2 {rel:.3e} (bound {STEP_UPDATE_REL_L2}), slots "
          f"restored: {not fresh}")
    if not (ok_whole and loss_rel <= 1e-4 and rel <= STEP_UPDATE_REL_L2 and not fresh):
        failures.append(f"tensor_parallel (d) driver: whole {ok_whole}, losses {loss_rel}, "
                        f"state {rel}, {fresh}")


def tensor_parallel_phase(workdir, where):
    """``--model_parallel`` on the card, two and four processes over gloo.

    (a) ResNet-50 at the recipe's width (CIFAR stem, 32 px, fp32, TF32 off),
    global batch :data:`TP_BATCH`, ``--model_parallel 2`` on 2 processes:
    one step against the one-process step (:func:`tp_compare`: JAX's loss
    pin, the recipe-scale update pins, a float64 step beside), the fused loss's
    single-device form launched once a step on each rank, each rank's state
    bytes against the replicated state's, the step's wall time and its
    collectives by group. (b) ResNet-18 at world 4, data 2 x model 2,
    ``--syncBN``: the sharded fused loss over the data group, against the
    one-process step. (c) ``train.supcon.main --model_parallel 2`` for two
    epochs of ResNet-18 on ``synthetic``: its ``last.pth`` holds whole
    tensors and loads in ``train.linear.main``, and its first-epoch save
    resumed at ``--model_parallel 1`` ends near the straight run. (d) In the
    2-process launch, ResNet-18 at data 1 x model 2: one step of each of
    byol, simsiam, vicreg and simclr with the MoCo queue against the
    one-process recipe step from the same init (:func:`tp_recipe_checks`:
    the model, the predictor and the EMA network by :func:`tp_compare`'s
    pins, the queue whole and equal on both ranks), then the byol driver at
    ``--model_parallel 2``: its ``last.pth`` whole, recipe payload
    included, and its first-epoch save resumed at ``--model_parallel 1``
    with the slots restored."""
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
    from simclr_pytorch_distributed_tpu_torch.train import linear
    dev = torch.device("cuda", 0)
    failures = []
    t0 = time.time()
    out2 = tempfile.mkdtemp(prefix="tp2_", dir=workdir)
    ranks2 = run_gloo_ranks(out2, world=2, timeout=900, target="tp_rank",
                            label="tensor_parallel (a)/(c)")
    t2 = time.time() - t0
    out4 = tempfile.mkdtemp(prefix="tp4_", dir=workdir)
    ranks4 = run_gloo_ranks(out4, world=4, timeout=600, target="tp_rank",
                            label="tensor_parallel (b)")
    t4 = time.time() - t0 - t2
    print(f"tensor_parallel: the 2-process launch ((a) and (c)) {t2:.1f} s, the 4-process "
          f"launch ((b)) {t4:.1f} s of wall time, imports and rendezvous included")

    a = [r["a"] for r in ranks2]
    tp_report("tensor_parallel (a) resnet50 N=2 world 2", a, where)
    tp_compare("tensor_parallel (a)", out2, "resnet50", a, tp_reference("resnet50", dev),
               failures)
    if any(s["launches"][:2] != [1, 1] or s["launches"][2] != 0 for s in a):
        failures.append(f"tensor_parallel (a): expected the single-device fused loss once "
                        f"forward and backward on each rank, got {[s['launches'] for s in a]}")
    b = [r["b"] for r in ranks4]
    tp_report("tensor_parallel (b) resnet18 data 2 x model 2 --syncBN", b, where, rows_at=512)
    tp_compare("tensor_parallel (b)", out4, "resnet18", b, tp_reference("resnet18", dev),
               failures)
    if any(s["launches"] != [1, 1, 1] for s in b):
        failures.append(f"tensor_parallel (b): expected the sharded fused loss once forward "
                        f"and backward on each rank, got {[s['launches'] for s in b]}")
    syncs = [s["health_sync"] for s in a + b]
    print(f"tensor_parallel (a)/(b): the health gradient norm under "
          f"set_sync_debug_mode('error'), its all-reduce stubbed, rank by rank: "
          f"{['no sync' if e is None else e for e in syncs]}")
    if any(e is not None for e in syncs):
        failures.append(f"tensor_parallel: the health gradient norm waits for the card: {syncs}")

    c = ranks2[0]["c"]
    steps = len(c["losses"])
    print(f"tensor_parallel (c): train.supcon.main --model_parallel 2, resnet18 batch "
          f"{TP_DRIVER_BATCH}, 2 epochs: {steps} steps in {c['s']:.1f} s, fused loss launches "
          f"fwd/bwd {c['launches']} on rank 0, losses {[round(x, 4) for x in c['losses']]}")
    if c["launches"] != [steps, steps]:
        failures.append(f"tensor_parallel (c): loss launches {c['launches']} for {steps} steps")
    last = torch.load(os.path.join(c["folder"], "last.pth"), map_location="cpu",
                      weights_only=True)
    whole = {k: tuple(v.shape) for k, v in SupConResNet("resnet18").state_dict().items()}
    saved = {k.removeprefix("module."): tuple(v.shape) for k, v in last["model"].items()}
    print(f"tensor_parallel (c): last.pth holds {len(saved)} tensors, whole: "
          f"{saved == whole}; opt model_parallel {last['opt']['model_parallel']}, world_size "
          f"{last['world_size']}")
    if saved != whole:
        failures.append("tensor_parallel (c): last.pth does not hold whole tensors")
    probe = linear.main(["--model", "resnet18", "--dataset", "synthetic", "--epochs", "1",
                         "--batch_size", "512", "--ckpt", os.path.join(c["folder"], "last.pth"),
                         "--print_freq", "1", "--data_placement", "host", "--workdir",
                         os.path.join(workdir, "tp_probe")])
    print(f"tensor_parallel (c): train.linear.main from that last.pth: "
          f"{len(probe.history)} steps, top-1 {probe.best_acc:.2f}")
    resumed = torch.load(os.path.join(c["resumed_folder"], "last.pth"), map_location="cpu",
                         weights_only=True)
    tail = c["losses"][-len(c["resumed_losses"]):]
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(c["resumed_losses"], tail))
    num = sum(float(((resumed["model"][k].double() - v.double()) ** 2).sum())
              for k, v in last["model"].items() if v.is_floating_point())
    den = sum(float((v.double() ** 2).sum()) for v in last["model"].values()
              if v.is_floating_point())
    rel = (num / den) ** 0.5
    print(f"tensor_parallel (c): the epoch-1 save resumed at --model_parallel 1 (2 processes, "
          f"data parallel): epoch-2 losses {[round(x, 4) for x in c['resumed_losses']]} vs "
          f"the straight run's, worst rel {loss_rel:.3e} (bound 1e-4); last.pth relative L2 "
          f"{rel:.3e} (bound {STEP_UPDATE_REL_L2})")
    if not (loss_rel <= 1e-4 and rel <= STEP_UPDATE_REL_L2):
        failures.append(f"tensor_parallel (c): the N = 1 resume differs: losses {loss_rel}, "
                        f"state {rel}")
    tp_recipe_checks(out2, ranks2, dev, where, failures)
    if failures:
        raise AssertionError("tensor_parallel:\n" + "\n".join(failures))


# The large-batch phase: the ring loss, LARS, the probe over processes,
# elastic resume and NaN rollback (lines ``large_batch (a)`` to ``(f)``).
RING_BATCH = 4096  # the BASELINE bs = 4096 geometry: N = 8192 rows, D = 128
RING_LOSS_RTOL, RING_GRAD_SCALED = 2e-5, 1e-5  # the JAX ring pin; the dF pin
LARGE_STEP_LOSS_RTOL = 1e-5  # (c) and (e): the loss, as the dense-vs-fused step
PROBE_CLASSIFIER_REL = 1e-5
ELASTIC_STOP_AFTER = 3  # (e): the two-process run gets SIGTERM after this step


def elastic_argv(workdir, name):
    """(e)'s run: rn18 eager at the recipe's width, ``--syncBN --ngpu 2``,
    one 7-step epoch, in a new directory under ``workdir``."""
    return ["--device", "cuda", "--dataset", "synthetic", "--model", "resnet18",
            "--batch_size", "256", "--size", "32", "--epochs", "1", "--method", "SimCLR",
            "--temp", str(TEMP), "--learning_rate", "0.5", "--cosine", "--loss_impl", "fused",
            "--conv_impl", "eager", "--syncBN", "--ngpu", "2", "--print_freq", "1",
            "--data_placement", "host",
            "--workdir", tempfile.mkdtemp(prefix=f"{name}_", dir=workdir)]


def large_step(model_name, optimizer, loss_impl, views, labels, sync=None):
    """One eager step of ``model_name`` from the seed-0 init on ``views``
    (this process's slice under a group), with ``optimizer`` and
    ``loss_impl``; returns ``(loss, init state, state after)``."""
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
    from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
        SupConStepConfig,
        train_step,
    )
    torch.manual_seed(0)
    model = SupConResNet(model_name).to(views.device, memory_format=torch.channels_last)
    model.encoder.set_conv_impl("eager").set_bn_sync(sync)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    state = TrainState(model=model, optimizer=make_optimizer(model, optimizer=optimizer),
                       schedule=lambda s: 0.5)
    cfg = SupConStepConfig(temperature=TEMP, loss_impl=loss_impl, epochs=1, steps_per_epoch=7)
    loss = train_step(state, cfg, views, labels)["loss"].item()
    return loss, init, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def large_batch_rank(rank, world, outdir):
    """One process of the large-batch phase's two on the one card (gloo
    over CUDA tensors, rendezvous through ``file://outdir/store``): (b) the
    ring loss alone at N = 8192 on its slice, with its peak memory; (c) one
    rn18 ``--optimizer lars --loss_impl ring --syncBN`` eager step at the
    recipe's width; (d) the probe's entry point from ``spec.json``'s
    checkpoint; (e) the elastic run straight, then again with SIGTERM after
    step ``ELASTIC_STOP_AFTER`` on the last rank. Writes its tensors and a
    JSON summary into ``outdir``."""
    import datetime
    import torch.distributed as dist
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    from simclr_pytorch_distributed_tpu_torch.parallel.collectives import ring_supcon_loss
    from simclr_pytorch_distributed_tpu_torch.train import linear, supcon
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh.setup_distributed("cuda", init_method=f"file://{os.path.join(outdir, 'store')}",
                           rank=rank, world_size=world, backend="gloo",
                           timeout=datetime.timedelta(seconds=300))
    with open(os.path.join(outdir, "spec.json")) as fh:
        spec = json.load(fh)
    out = {}

    # (b) the ring loss alone
    f, _, _ = loss_inputs(RING_BATCH, seed=9, device=dev)
    b = RING_BATCH // world
    feats = f.reshape(2, RING_BATCH, DIM).transpose(0, 1)
    local = feats[rank * b:(rank + 1) * b].clone().requires_grad_()
    ring_supcon_loss(local, None, temperature=TEMP, base_temperature=BASE_TEMP).backward()
    local.grad = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loss = ring_supcon_loss(local, None, temperature=TEMP, base_temperature=BASE_TEMP)
    loss.backward()
    torch.cuda.synchronize()
    out["ring"] = {"loss": loss.item(), "s": time.perf_counter() - t0,
                   "peak_bytes": torch.cuda.max_memory_allocated() - base}
    torch.save(local.grad.cpu(), os.path.join(outdir, f"ring_grad{rank}.pt"))
    del f, feats, local, loss
    torch.cuda.empty_cache()

    # (c) one rn18 LARS ring step
    _, labels, _, views = recipe_batch(dev)
    b = views.shape[0] // world
    loss, _, after = large_step("resnet18", "lars", "ring", views[rank * b:(rank + 1) * b],
                                labels[rank * b:(rank + 1) * b], dist.group.WORLD)
    out["step_loss"] = loss
    torch.save(after, os.path.join(outdir, f"step_state{rank}.pt"))

    # (d) the probe's entry point
    probe = linear.main(["--model", "resnet50", "--dataset", "synthetic", "--epochs", "1",
                         "--batch_size", "512", "--ckpt", spec["ckpt"], "--print_freq", "1",
                         "--data_placement", "host", "--workdir", os.path.join(outdir, "probe")])
    out["probe"] = {"val": probe.val_history, "best": [probe.best_acc, probe.best_acc5],
                    "losses": [h["loss"] for h in probe.history],
                    "path": probe.classifier_path}
    torch.save({k: v.cpu() for k, v in probe.state.model.state_dict().items()},
               os.path.join(outdir, f"classifier{rank}.pt"))
    del probe
    torch.cuda.empty_cache()

    # (e) the elastic run straight, then SIGTERM'd
    straight = supcon.main(elastic_argv(outdir, f"straight{rank}"))
    out["straight"] = {"losses": [h["loss"] for h in straight.history],
                       "folder": straight.save_folder}
    del straight
    losses = []

    def step(state, cfg, views, labels):
        metrics = train_step(state, cfg, views, labels)
        losses.append(metrics["loss"].item())
        if state.step == ELASTIC_STOP_AFTER and rank == world - 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return metrics

    supcon.train_step = step
    try:
        supcon.main(elastic_argv(outdir, f"preempt{rank}"))
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        supcon.train_step = train_step
    saved = glob.glob(os.path.join(outdir, "preempt0_*", "*", "*", "*.pth"))
    out["preempt"] = {"code": code, "losses": losses, "saved": saved}
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    mesh.teardown_distributed()


def relative_l2(got, want):
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def updates_within(name, got, want, init, params, failures):
    """Each parameter's update of ``got`` against ``want``'s (relative L2,
    ``STEP_UPDATE_REL_L2``), buffers at ``STEP_BUF_TOL``; prints the worst."""
    errs, buf_worst = [], (0.0, None)
    for key, ref in want.items():
        if key in params:
            errs.append((relative_l2(got[key] - init[key], ref - init[key]), key))
        elif ref.is_floating_point():
            diff = (got[key].double() - ref.double()).abs()
            buf_worst = max(buf_worst, (diff.max().item(), key))
            if (diff - STEP_BUF_TOL * (1 + ref.double().abs())).max().item() > 0:
                failures.append(f"{name}: buffer {key} off by more than {STEP_BUF_TOL}")
        elif not torch.equal(got[key], ref):
            failures.append(f"{name}: buffer {key} differs")
    worst = max(errs)
    print(f"{name}: update relative L2 worst {worst[0]:.3e} at {worst[1]}, median "
          f"{statistics.median(e for e, _ in errs):.3e} over {len(errs)} parameters (bound "
          f"{STEP_UPDATE_REL_L2}); buffers max abs diff {buf_worst[0]:.3e} at {buf_worst[1]} "
          f"(bound rtol/atol {STEP_BUF_TOL})")
    if not worst[0] <= STEP_UPDATE_REL_L2:
        failures.append(f"{name}: update relative L2 {worst}")


def large_batch_phase(workdir, result, rn50_expected, rn18_expected, where):
    """The large-batch composition (``--optimizer lars --loss_impl ring``)
    and the multi-process resilience on the card.

    (a) ``train.supcon.main`` under torchrun's environment at world size 1
    (NCCL): one 7-step epoch of ResNet-50 fp32 at the recipe's width with
    ``--syncBN --optimizer lars --loss_impl ring --conv_impl fused``, and the
    same with ``--loss_impl fused``: the step-1 losses within rtol 1e-5,
    every loss finite, the conv kernels 7 stem and 112 Bottleneck launches
    each way in both runs (the loss kernels none in the ring's), and the
    step medians beside the train phase's SGD epoch (``result``).
    (b)-(e) in two processes on the one card over gloo
    (:func:`large_batch_rank`), each held here against one process:
    (b) the ring loss at N = 8192 against the dense loss (rtol 2e-5, dF at
    1e-5 x max|dF|), with each process's peak memory beside the dense
    loss's; (c) one rn18 LARS ring step against the one-process LARS step
    with the fused loss (loss 1e-5, updates at ``STEP_UPDATE_REL_L2``); (d)
    the probe against the one-process probe (classifier within 1e-5
    relative, top-1/top-5 equal); (e) the elastic run, SIGTERM'd after step
    3 (both exit 75), resumed at world size 1 over NCCL, against the
    straight two-process run at (c)'s pins, the warning in its log.
    (f) ``--nan_policy rollback``: rn18 fp32 fused at world size 1 over 2
    epochs with a non-finite loss injected at global step 0 (the driver's
    finite check raises there, as the CPU tests inject it), once under
    ``--telemetry sync`` and once under the default ``async``: exit 0, the
    steps after the skip at 0.5 x the schedule with finite losses,
    ``last.pth`` holding ``lr_scale`` 0.5 and ``rollbacks`` 1; the kernel
    launches of 8 steps under ``sync`` (the poisoned one and the 7 after
    the skip) and of 8 to 14 under ``async``, whose flush may see the
    poisoned step at any later boundary of its epoch."""
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
    from simclr_pytorch_distributed_tpu_torch.ops.losses import supcon_loss
    from simclr_pytorch_distributed_tpu_torch.ops.schedules import make_lr_schedule
    from simclr_pytorch_distributed_tpu_torch.train import linear, supcon
    from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import load_model_state
    from simclr_pytorch_distributed_tpu_torch.utils.guard import NonFiniteLossError
    dev = torch.device("cuda", 0)
    failures = []

    # (a) ResNet-50, LARS + ring against LARS + fused, world size 1 (NCCL)
    counters = kernel_counters()
    runs = {}
    for loss_impl in ("ring", "fused"):
        argv = recipe_argv("resnet50", workdir) + ["--syncBN", "--optimizer", "lars"]
        argv[argv.index("--loss_impl") + 1] = loss_impl
        for mod, name in counters:
            setattr(mod, name, 0)
        run = torchrun_world1(argv)
        launches = {name: getattr(mod, name) for mod, name in counters}
        expected = (rn50_expected if loss_impl == "fused"
                    else dict(rn50_expected, fwd_launches=0, bwd_launches=0))
        losses = [h["loss"] for h in run.history]
        with open(os.path.join(run.save_folder, "log-ing")) as fh:
            banners = [line.split(" INFO ")[-1].strip() for line in fh
                       if "[loss_impl]" in line or "[optimizer]" in line]
        print(f"large_batch (a): rn50 fp32 --optimizer lars --loss_impl {loss_impl} world size "
              f"1 (NCCL) losses {losses}; kernel launches {launches}; banners {banners}")
        if launches != expected:
            failures.append(f"(a) {loss_impl}: launches {launches}, expected {expected}")
        if len(losses) != 7 or not all(math.isfinite(x) for x in losses):
            failures.append(f"(a) {loss_impl}: expected 7 finite losses")
        runs[loss_impl] = run
    rel = abs(runs["ring"].history[0]["loss"] - runs["fused"].history[0]["loss"]) / abs(
        runs["fused"].history[0]["loss"])
    ms = {name: statistics.median(h["step_time"] for h in run.history[2:7]) * 1e3
          for name, run in (("lars ring", runs["ring"]), ("lars fused", runs["fused"]),
                            ("sgd fused (train phase)", result))}
    print(f"large_batch (a): step-1 loss ring vs fused rel diff {rel:.3e} (bound "
          f"{LARGE_STEP_LOSS_RTOL}); step median of steps 3-7: "
          + ", ".join(f"{name} {t:.2f} ms" for name, t in ms.items()) + f" {where}")
    if not rel <= LARGE_STEP_LOSS_RTOL:
        failures.append(f"(a): step-1 loss ring vs fused {rel}")
    del runs
    torch.cuda.empty_cache()

    # (b)-(e): two processes on the one card
    outdir = tempfile.mkdtemp(prefix="large_", dir=workdir)
    with open(os.path.join(outdir, "spec.json"), "w") as fh:
        json.dump({"ckpt": os.path.join(result.save_folder, "last.pth")}, fh)
    ranks = run_gloo_ranks(outdir, target="large_batch_rank", label="large_batch")

    # (b) the ring loss against the dense loss on one process
    f, _, _ = loss_inputs(RING_BATCH, seed=9, device=dev)
    feats = f.reshape(2, RING_BATCH, DIM).transpose(0, 1).clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    dense = supcon_loss(feats, temperature=TEMP, base_temperature=BASE_TEMP)
    dense.backward()
    torch.cuda.synchronize()
    dense_s, dense_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base
    grad = feats.grad.cpu()
    b = RING_BATCH // GLOO_WORLD
    worst = 0.0
    for r, summary in enumerate(ranks):
        got = torch.load(os.path.join(outdir, f"ring_grad{r}.pt"), weights_only=True)
        worst = max(worst, (got - grad[r * b:(r + 1) * b]).abs().max().item())
        lrel = abs(summary["ring"]["loss"] - dense.item()) / abs(dense.item())
        print(f"large_batch (b) rank {r}: ring loss N = {2 * RING_BATCH} D = {DIM} "
              f"{summary['ring']['loss']!r} vs dense {dense.item()!r} rel {lrel:.3e} (bound "
              f"{RING_LOSS_RTOL}); peak memory of the loss beyond its inputs "
              f"{summary['ring']['peak_bytes'] / 2**20:.1f} MiB (the dense loss on one "
              f"process: {dense_peak / 2**20:.1f} MiB, of which its [{2 * RING_BATCH}, "
              f"{2 * RING_BATCH}] fp32 logits {4 * (2 * RING_BATCH) ** 2 / 2**20:.0f} MiB); "
              f"forward+backward {summary['ring']['s'] * 1e3:.2f} ms through gloo on one card "
              f"(dense {dense_s * 1e3:.2f} ms) {where}")
        if not lrel <= RING_LOSS_RTOL:
            failures.append(f"(b) rank {r}: ring loss rel {lrel}")
    scale = grad.abs().max().item()
    print(f"large_batch (b): dF max abs diff {worst:.3e} against 1e-5 x max|dF| = "
          f"{RING_GRAD_SCALED * scale:.3e}")
    if not worst <= RING_GRAD_SCALED * scale:
        failures.append(f"(b): dF off by {worst}")
    del f, feats, dense, grad
    torch.cuda.empty_cache()

    # (c) the rn18 LARS ring step against the one-process LARS fused step
    _, labels, _, views = recipe_batch(dev)
    ref_loss, init, ref = large_step("resnet18", "lars", "fused", views, labels)
    params = {k for k, _ in SupConResNet("resnet18").named_parameters()}
    states = [torch.load(os.path.join(outdir, f"step_state{r}.pt"), weights_only=True)
              for r in range(GLOO_WORLD)]
    lrel = abs(ranks[0]["step_loss"] - ref_loss) / abs(ref_loss)
    same = all(torch.equal(states[0][k], states[1][k]) for k in states[0])
    print(f"large_batch (c): rn18 --optimizer lars --loss_impl ring --syncBN eager step, two "
          f"processes: losses {[r['step_loss'] for r in ranks]} vs one process (fused loss) "
          f"{ref_loss!r}, rel {lrel:.3e} (bound {LARGE_STEP_LOSS_RTOL}); ranks equal after the "
          f"step: {same}")
    if not lrel <= LARGE_STEP_LOSS_RTOL or not same:
        failures.append(f"(c): loss rel {lrel}, ranks equal {same}")
    updates_within("large_batch (c)", states[0], ref, init, params, failures)
    del views

    # (d) the probe in two processes against one
    single = linear.main(["--model", "resnet50", "--dataset", "synthetic", "--epochs", "1",
                          "--batch_size", "512", "--ckpt",
                          os.path.join(result.save_folder, "last.pth"), "--print_freq", "1",
                          "--data_placement", "host",
                          "--workdir", tempfile.mkdtemp(prefix="probe1_", dir=workdir)])
    want = {k: v.cpu() for k, v in single.state.model.state_dict().items()}
    for r, summary in enumerate(ranks):
        got = torch.load(os.path.join(outdir, f"classifier{r}.pt"), weights_only=True)
        rels = {k: relative_l2(got[k], v) for k, v in want.items()}
        val = [(v["top1"], v["top5"]) for v in summary["probe"]["val"]]
        want_val = [(v["top1"], v["top5"]) for v in single.val_history]
        print(f"large_batch (d) rank {r}: probe (rn50, batch 512, 3 steps) classifier relative "
              f"L2 vs one process {rels} (bound {PROBE_CLASSIFIER_REL}); validation top-1/top-5 "
              f"{val} vs {want_val}; losses {summary['probe']['losses']} vs "
              f"{[h['loss'] for h in single.history]}; wrote {summary['probe']['path']}")
        if max(rels.values()) > PROBE_CLASSIFIER_REL or val != want_val:
            failures.append(f"(d) rank {r}: classifier {rels}, validation {val} vs {want_val}")
    if ranks[0]["probe"]["path"] is None or ranks[1]["probe"]["path"] is not None:
        failures.append("(d): only rank 0 must write classifier_best.pth")
    del single
    torch.cuda.empty_cache()

    # (e) elastic: SIGTERM'd under two processes, resumed under one (NCCL)
    codes = [r["preempt"]["code"] for r in ranks]
    saved = ranks[0]["preempt"]["saved"]
    print(f"large_batch (e): the two-process run SIGTERM'd after step {ELASTIC_STOP_AFTER} "
          f"exited {codes}, saved {[os.path.basename(p) for p in saved]}")
    if codes != [75, 75] or len(saved) != 1:
        raise AssertionError("large_batch (e): both processes must exit 75 with one save:\n"
                             + "\n".join(failures))
    resumed = torchrun_world1(elastic_argv(workdir, "resumed")
                              + ["--resume", os.path.dirname(saved[0])])
    losses = ranks[0]["preempt"]["losses"] + [h["loss"] for h in resumed.history]
    want_losses = ranks[0]["straight"]["losses"]
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    with open(os.path.join(resumed.save_folder, "log-ing")) as fh:
        warning = [line.strip() for line in fh if "elastic resume" in line]
    print(f"large_batch (e): resumed at world size 1 (NCCL): losses {losses} vs the straight "
          f"two-process run {want_losses}, worst rel {worst_loss:.3e} (bound "
          f"{LARGE_STEP_LOSS_RTOL}); warning {warning}")
    if len(losses) != len(want_losses) or not worst_loss <= LARGE_STEP_LOSS_RTOL:
        failures.append(f"(e): losses rel {worst_loss}")
    if len(warning) != 1 or "saved under 2 process(es), restoring under 1" not in warning[0]:
        failures.append("(e): the elastic-resume warning is missing")
    straight = load_model_state(os.path.join(ranks[0]["straight"]["folder"], "last.pth"))
    torch.manual_seed(0)  # the driver's init (seed 0)
    init = SupConResNet("resnet18").state_dict()
    updates_within("large_batch (e) resumed vs straight", {
        k: v.cpu() for k, v in resumed.state.model.state_dict().items()}, straight, init,
        params, failures)
    del resumed
    torch.cuda.empty_cache()

    # (f) NaN rollback at world size 1, under each flush: the inline flush
    # sees the poisoned step at its own boundary, so the poisoned epoch runs
    # that one step; the background flush sees it at a later boundary of
    # the same epoch, or at the epoch's end at the latest
    check = supcon.check_finite_loss

    def poisoned(loss, step, enabled=True):
        if step == 0:
            raise NonFiniteLossError(float("nan"), step)
        return check(loss, step, enabled)

    sched = make_lr_schedule(learning_rate=0.5, epochs=2, steps_per_epoch=7, cosine=True)
    for mode in ("sync", "async"):
        argv = ["--device", "cuda", "--dataset", "synthetic", "--model", "resnet18",
                "--batch_size", "256", "--size", "32", "--epochs", "2", "--method", "SimCLR",
                "--temp", str(TEMP), "--learning_rate", "0.5", "--cosine", "--loss_impl",
                "fused", "--conv_impl", "fused", "--nan_policy", "rollback", "--print_freq",
                "1", "--telemetry", mode, "--data_placement", "host",
                "--workdir", tempfile.mkdtemp(prefix="rollback_", dir=workdir)]
        supcon.check_finite_loss = poisoned
        for mod, name in counters:
            setattr(mod, name, 0)
        try:
            rolled = supcon.main(argv)
            code = 0
        except SystemExit as e:
            code, rolled = e.code, None
        finally:
            supcon.check_finite_loss = check
        launches = {name: getattr(mod, name) for mod, name in counters}
        # the steps launched, from each kernel's count and its 7 a 7-step
        # epoch: the poisoned epoch's (1 under sync, 1 to 7 under async)
        # and the 7 after the skip
        per_step = {name: n // 7 for name, n in rn18_expected.items()}
        allowed = [8] if mode == "sync" else range(8, 15)
        matches = [n for n in allowed
                   if launches == {name: k * n for name, k in per_step.items()}]
        steps_launched = matches[0] if matches else None
        if steps_launched is None:
            failures.append(f"(f) {mode}: launches {launches}, expected {allowed} steps of "
                            f"{per_step}")
        if rolled is None:
            raise AssertionError(f"large_batch (f) {mode}: the rollback run exited {code}:\n"
                                 + "\n".join(failures))
        steps = [h["step"] for h in rolled.history]
        lr_rel = max(abs(h["learning_rate"] - 0.5 * sched(h["step"])) / (0.5 * sched(h["step"]))
                     for h in rolled.history[1:])
        last = torch.load(os.path.join(rolled.save_folder, "last.pth"), map_location="cpu",
                          weights_only=True)
        crash = os.path.isfile(os.path.join(rolled.save_folder, "crash_epoch_1.pth"))
        print(f"large_batch (f) --telemetry {mode}: rollback run exited {code}; kernel launches "
              f"{launches} ({steps_launched} steps); steps {steps}; learning rates after "
              f"the skip vs 0.5 x the schedule worst rel {lr_rel:.3e}; last.pth lr_scale "
              f"{last['lr_scale']} rollbacks {last['rollbacks']} step {last['step']}; "
              f"crash_epoch_1.pth {'written' if crash else 'missing'}; losses "
              f"{[h['loss'] for h in rolled.history]}")
        if (steps != [0] + list(range(7, 14)) or not lr_rel <= 1e-6 or not crash
                or (last["lr_scale"], last["rollbacks"], last["step"]) != (0.5, 1, 14)
                or not all(math.isfinite(h["loss"]) for h in rolled.history[1:])):
            failures.append(f"(f) {mode}: the rollback run is not as expected")
        del rolled
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("large_batch:\n" + "\n".join(failures))


# -- observability: the metric ring, the flush, health, probe, recorder ------

OBS_PRINT_FREQ = 3  # 7 steps: windows of 3, 3 and 1
OBS_WINDOWS = 3
OBS_STALL_S = 2.0  # the watchdog deadline of the stall run
# con_top1 is an argmax over 511 similarities: fp32 rounding may flip a row
# whose best two similarities nearly tie (one row of 512 moves it 0.2%)
HEALTH_RTOL = {"health_align": 1e-4, "health_con_top1": 1e-2, "health_neg_max": 1e-4,
               "health_neg_mean": 1e-4, "health_unif": 1e-4, "health_grad_norm": 1e-4,
               "health_eff_rank": 1e-4}
CE_LOGITS_REL_L2 = {False: 1e-4, True: 5e-2}  # card vs the port on the CPU
# the namespace of the fused conv kernels (csrc/conv_gemm_sm90.cuh) in a
# trace's kernel names
FUSED_CONV_KERNEL = "sm90::conv_"


class SyncGuard:
    """``torch.cuda.set_sync_debug_mode("error")`` from each step's batch
    until the next flush boundary (and off inside the boundary and the
    epoch's end, where the host waits by design), so any host sync in
    between raises; with ``MetricRing.fetch`` (the one transfer of a
    window) counted. A step's batch is the call of one of ``entries``
    (``(owner, attribute)`` pairs): by default the host loader's copy,
    ``train.supcon.to_device``; under a store its ``batch``. Install around
    one driver run."""

    def __init__(self, entries=None):
        self.entries = entries
        self.fetches = 0
        self.guarded_steps = 0

    def __enter__(self):
        from simclr_pytorch_distributed_tpu_torch.ops.metrics import MetricRing
        from simclr_pytorch_distributed_tpu_torch.train import supcon
        from simclr_pytorch_distributed_tpu_torch.utils.telemetry import TelemetrySession
        entries = self.entries or [(supcon, "to_device")]
        self._saved = [(owner, name, getattr(owner, name)) for owner, name in entries] + [
            (TelemetrySession, "flush_boundary", TelemetrySession.flush_boundary),
            (TelemetrySession, "finish_epoch", TelemetrySession.finish_epoch),
            (MetricRing, "fetch", MetricRing.fetch)]
        guard = self

        def guarded(fn):
            def run(*args, **kwargs):
                if torch.cuda.get_sync_debug_mode() == 0:
                    guard.guarded_steps += 1
                torch.cuda.set_sync_debug_mode("error")
                return fn(*args, **kwargs)
            return run

        def unguarded(fn):
            def run(*args, **kwargs):
                torch.cuda.set_sync_debug_mode(0)
                return fn(*args, **kwargs)
            return run

        fetch = MetricRing.fetch

        def counted_fetch(ring, snapshot):
            guard.fetches += 1
            return fetch(ring, snapshot)

        for owner, name, saved in self._saved[:len(entries)]:
            setattr(owner, name, guarded(saved))
        TelemetrySession.flush_boundary = unguarded(TelemetrySession.flush_boundary)
        TelemetrySession.finish_epoch = unguarded(TelemetrySession.finish_epoch)
        MetricRing.fetch = counted_fetch
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        for owner, name, saved in self._saved:
            setattr(owner, name, saved)
        return False


def obs_argv(model, workdir, bf16, *extra):
    """``recipe_argv`` with the observability phase's flags."""
    argv = recipe_argv(model, workdir, bf16)
    argv[argv.index("--print_freq") + 1] = str(OBS_PRINT_FREQ)
    return argv + ["--health_freq", "2", "--online_probe", "on"] + list(extra)


def load_script(name):
    """``scripts/<name>.py`` as a module (``scripts/`` is not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def health_report_run(folder, label, windows, failures):
    """``scripts/port_health_report.py`` over a run's ``events.jsonl`` (its
    CLI, as a user runs it after a run), then the ``health_report`` gate's
    record (``scripts/port_ratchet.health_report_gate_record``) on its
    artifact, printed. Fails unless the stream is consistent with
    ``windows`` windows. The record is printed, not bound: the gate's
    healthy smoke is its own run (:func:`recipe_accuracy`), and a 7-step
    ResNet-50 from its init sits below the detector's effective-rank bar
    (1.76-1.77 against 2 on an H100), which its alarms say."""
    out = os.path.join(folder, "health_report.json")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "port_health_report.py"),
                           "--events", os.path.join(folder, "events.jsonl"), "--json", out,
                           "--device", "cuda"], capture_output=True, text=True, timeout=300)
    table = [ln for ln in proc.stdout.splitlines() if ln.startswith(("health_", "probe_",
                                                                     "FINDING", "online"))]
    print(f"{label}: scripts/port_health_report.py exit {proc.returncode}: " + " | ".join(
        " ".join(ln.split()) for ln in table))
    if not os.path.exists(out):
        failures.append(f"{label}: the health report wrote no artifact: {proc.stderr[-600:]}")
        return
    with open(out) as fh:
        artifact = json.load(fh)
    record = load_script("port_ratchet").health_report_gate_record(artifact)
    print(f"{label}: health_report gate record on this stream {json.dumps(record)}")
    n = artifact["report"]["consistency"]["n_windows"]
    if proc.returncode != 0 or n != windows:
        failures.append(f"{label}: health report exit {proc.returncode}, {n} windows, "
                        f"expected {windows}")


def history_equal(a, b):
    """Two drivers' histories equal bitwise, every column but
    ``step_time`` (NaN sentinels equal where both are NaN)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.keys() != y.keys():
            return False
        for k in x:
            if k != "step_time" and not (x[k] == y[k] or (math.isnan(x[k]) and math.isnan(y[k]))):
                return False
    return True


def capture_health_inputs(store):
    """Wrap the step's health diagnostics so that the first health step's
    embeddings, every parameter's gradient and the card's outputs land on
    the CPU in ``store``. Returns the undo."""
    from simclr_pytorch_distributed_tpu_torch.train import supcon_step
    health, grad_norm = supcon_step.contrastive_health_metrics, supcon_step.global_grad_norm

    def norm(params, *args):
        params = list(params)
        if "grads" not in store:
            store["grads"] = [p.grad.detach().cpu() for p in params if p.grad is not None]
        return grad_norm(params, *args)

    def metrics(emb, gn):
        out = health(emb, gn)
        if "emb" not in store:
            store["emb"] = emb.detach().cpu()
            store["card"] = {k: v.detach().cpu() for k, v in out.items()}
        return out

    supcon_step.contrastive_health_metrics, supcon_step.global_grad_norm = metrics, norm

    def undo():
        supcon_step.contrastive_health_metrics, supcon_step.global_grad_norm = health, grad_norm
    return undo


def health_against_cpu(name, store, failures):
    """The card's health columns of one step against the port's plain
    computation on the CPU from the same embeddings and gradients
    (``HEALTH_RTOL``; the effective rank from each covariance on the
    host)."""
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
        contrastive_health_metrics,
        host_metrics,
    )
    norms = torch.stack([torch.linalg.vector_norm(g.double()) for g in store["grads"]])
    cpu = contrastive_health_metrics(store["emb"], torch.linalg.vector_norm(norms).float())
    as_host = lambda m: host_metrics({k: (v.numpy() if v.ndim else v.item())  # noqa: E731
                                      for k, v in m.items()})
    card, host = as_host(store["card"]), as_host(cpu)
    worst = {k: abs(card[k] - host[k]) / max(abs(host[k]), 1e-12) for k in HEALTH_RTOL}
    print(f"observability {name}: health columns of step 0, card vs the CPU from the same "
          f"{tuple(store['emb'].shape)} embeddings and {len(store['grads'])} gradients: "
          + ", ".join(f"{k} {card[k]:.6g} vs {host[k]:.6g} (rel {worst[k]:.2e})"
                      for k in HEALTH_RTOL))
    bad = [k for k, rel in worst.items() if not rel <= HEALTH_RTOL[k]]
    if bad:
        failures.append(f"{name}: health columns {bad} differ from the CPU's")


def trace_summary(path, label, steps, top=8):
    """Top device operations and the host gaps between them in a
    ``StepTracer`` Chrome trace of ``steps`` steps (the window's edges wait
    for the device, so it holds exactly their work): each kernel, copy and
    set's summed device time; the device's busy and idle time over the
    window; the same for each named range (the drivers' ``augment``,
    ``train_step``, ``metric_ring`` and the optimizer's
    ``Optimizer.step#...``: the device span of the work launched inside
    it, from the profiler's ``gpu_user_annotation`` events); and the
    longest idle gaps with the operations around them. Returns ``None``
    when the trace holds no device operation."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    device = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])
    if not device:
        print(f"trace {label}: no device events in {path} (CUPTI gave none)")
        return None

    def busy_in(lo, hi):
        """Device time of the operations inside [lo, hi], overlaps merged."""
        busy, cursor = 0.0, lo
        for e in device:
            a, b = max(e["ts"], cursor), min(e["ts"] + e["dur"], hi)
            if b > a:
                busy += b - a
                cursor = b
        return busy

    by_name = {}
    for e in device:
        entry = by_name.setdefault(e["name"][:80], [0, 0.0])
        entry[0] += 1
        entry[1] += e["dur"]
    start, end = device[0]["ts"], max(e["ts"] + e["dur"] for e in device)
    busy = busy_in(start, end)
    gaps, cursor, prev = [], start, None
    for e in device:
        if e["ts"] > cursor:
            gaps.append((e["ts"] - cursor, prev["name"][:50] if prev else "-", e["name"][:50]))
        if e["ts"] + e["dur"] > cursor:
            cursor, prev = e["ts"] + e["dur"], e
    span = end - start
    print(f"trace {label}: {steps} steps, device span {span / 1e3:.3f} ms "
          f"({span / 1e3 / steps:.3f} ms a step), busy {busy / 1e3:.3f} ms "
          f"({busy / 1e3 / steps:.3f} a step), idle {(span - busy) / 1e3:.3f} ms "
          f"({100 * (span - busy) / span:.1f}%) in {len(gaps)} gaps; {len(device)} device "
          f"operations ({len(device) / steps:.0f} a step)")
    ranges = {}
    for e in events:
        if e.get("cat") == "gpu_user_annotation" and e.get("ph") == "X":
            name = e["name"].split("#")[0] if e["name"].startswith("ProfilerStep") else e["name"]
            entry = ranges.setdefault(name, [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += e["dur"]
            entry[2] += busy_in(e["ts"], e["ts"] + e["dur"])
    for name, (count, rspan, rbusy) in sorted(ranges.items(), key=lambda kv: -kv[1][1]):
        print(f"trace {label} range {name}: {count} times, device span {rspan / 1e3 / steps:.3f} "
              f"ms a step, busy {rbusy / 1e3 / steps:.3f} ms a step, idle inside "
              f"{(rspan - rbusy) / 1e3 / steps:.3f} ms a step")
    for name, (count, dur) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"trace {label} top op: {dur / 1e3 / steps:.3f} ms a step in {count / steps:.0f} "
              f"calls a step ({100 * dur / busy:.1f}% of busy): {name}")
    for gap, before, after in sorted(gaps, reverse=True)[:5]:
        print(f"trace {label} gap: {gap / 1e3:.3f} ms idle after {before} before {after}")
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3, "steps": steps,
            "fused_conv_ops": sum(FUSED_CONV_KERNEL in e["name"] for e in device)}


def scrape(port):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
        return resp.read().decode()


def observability_phase(workdir, rn50_expected, rn50_bf16_expected, where):
    """The metric ring, the telemetry flush, health, the online probe and
    the run-observability stack at the recipe's width: ResNet-50 in fp32
    and ``--bf16`` with ``--conv_impl fused --loss_impl fused --health_freq
    2 --online_probe on --print_freq 3``, one 7-step epoch each under
    ``--telemetry async`` (no host sync from a step's batch copy to the
    next flush boundary: ``SyncGuard``; one transfer a window; the kernel
    launches of the train phase) and under ``--telemetry sync`` (bitwise
    the async run's history, every column but the step time; the health
    columns of step 0 against the CPU's from the same embeddings and
    gradients; the sidecar scraped once over 127.0.0.1; a 4 s stall inside
    a step against a 2 s watchdog, whose dump is read back; the recorder's
    ``events.jsonl`` and ``trace.json``), with the step times of both.
    Then a ``StepTracer`` window of 3 steps on the ResNet-18 ``--bf16``
    fused step and one on the ResNet-50 fp32 ``--optimizer lars`` fused
    step, summarized by ``trace_summary``; a trace with no device operation
    or no fused conv kernel fails the phase."""
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    counters = kernel_counters()
    failures = []
    for bf16, expected in ((False, rn50_expected), (True, rn50_bf16_expected)):
        name = f"resnet50 {'bf16' if bf16 else 'fp32'}"
        runs = {}
        for mode in ("async", "sync", "stall"):
            extra = ["--telemetry", "sync" if mode == "stall" else mode]
            store, undo, port = {}, None, None
            if mode == "sync":
                undo = capture_health_inputs(store)
            if mode == "stall":
                port = free_port()
                extra += ["--metrics_port", str(port), "--watchdog_secs", str(OBS_STALL_S)]
            step, scraped = supcon.train_step, {}

            def probing(state, cfg, views, labels, mode=mode, port=port, scraped=scraped):
                metrics = step(state, cfg, views, labels)
                if mode == "stall" and state.step == 5:
                    scraped["text"] = scrape(port)
                    time.sleep(2 * OBS_STALL_S)  # a stall the watchdog must see
                return metrics

            supcon.train_step = probing
            for mod, counter in counters:
                setattr(mod, counter, 0)
            try:
                if mode == "async":
                    with SyncGuard() as guard:
                        result = supcon.main(obs_argv("resnet50", workdir, bf16, *extra))
                else:
                    result = supcon.main(obs_argv("resnet50", workdir, bf16, *extra))
            finally:
                supcon.train_step = step
                if undo is not None:
                    undo()
            launches = {counter: getattr(mod, counter) for mod, counter in counters}
            runs[mode] = result
            if launches != expected:
                failures.append(f"{name} {mode}: launches {launches}, expected {expected}")
            if mode != "stall":
                times = [h["step_time"] * 1e3 for h in result.history]
                print(f"observability {name} --telemetry {mode}: losses "
                      f"{[h['loss'] for h in result.history]}; step times by CUDA events "
                      f"{[round(t, 3) for t in times]} ms, median of steps 3-7 "
                      f"{statistics.median(times[2:7]):.3f} ms {where}")
                print(f"observability {name} --telemetry {mode}: health_eff_rank "
                      f"{[round(h['health_eff_rank'], 4) for h in result.history]}, probe_top1 "
                      f"{[round(h['probe_top1'], 2) for h in result.history]}")
            if mode == "async":
                print(f"observability {name}: no host sync in {guard.guarded_steps} guarded "
                      f"step windows; {guard.fetches} transfers for {OBS_WINDOWS} windows")
                if guard.fetches != OBS_WINDOWS or guard.guarded_steps != OBS_WINDOWS:
                    failures.append(f"{name}: {guard.fetches} transfers, "
                                    f"{guard.guarded_steps} guarded windows")
                if not bf16:
                    health_report_run(result.save_folder, f"observability {name}", OBS_WINDOWS,
                                      failures)
                continue
            if mode == "sync":
                health_against_cpu(name, store, failures)
                continue
            text = scraped.get("text", "")
            lines = [ln for ln in text.splitlines()
                     if ln.startswith(("train_step ", "train_health_", "train_probe_",
                                       "train_inflight"))]
            print(f"observability {name}: sidecar scrape of 127.0.0.1:{port}: {lines}")
            if "train_step " not in text or "train_health_eff_rank" not in text:
                failures.append(f"{name}: the sidecar scrape lacks train_step or the health means")
            folder = result.save_folder
            dumps = sorted(glob.glob(os.path.join(folder, "stall_dump_*.txt")))
            head, frame = [], []
            for dump in dumps:
                with open(dump) as fh:
                    lines = fh.read().splitlines()
                if any("probing" in ln for ln in lines):
                    head, frame = lines[:1], [ln.strip() for ln in lines if "probing" in ln]
            print(f"observability {name}: watchdog dumps {[os.path.basename(d) for d in dumps]}; "
                  f"{head}; the stalled frame {frame[:1]}")
            if not dumps or not frame:
                failures.append(f"{name}: the injected stall left no watchdog dump")
            events = [json.loads(ln) for ln in open(os.path.join(folder, "events.jsonl"))]
            with open(os.path.join(folder, "trace.json")) as fh:
                chrome = json.load(fh)["traceEvents"]
            names = {e["name"] for e in events}
            print(f"observability {name}: events.jsonl {len(events)} records "
                  f"({sorted(names)}), trace.json {len(chrome)} events")
            if not {"first_step", "epoch", "flush_boundary", "checkpoint_commit",
                    "health_window", "stall_detected", "run_exit"} <= names:
                failures.append(f"{name}: the recorder lacks spans or events: {sorted(names)}")
        same = history_equal(runs["async"].history, runs["sync"].history)
        print(f"observability {name}: --telemetry async vs sync histories (losses, health and "
              f"probe columns): {'bitwise equal' if same else 'DIFFER'}")
        if not same:
            failures.append(f"{name}: async and sync histories differ")
        del runs
        torch.cuda.empty_cache()
    for label, model, bf16, extra in (
            ("resnet18 bf16 fused", "resnet18", True, []),
            ("resnet50 fp32 fused lars", "resnet50", False, ["--optimizer", "lars"])):
        trace_dir = tempfile.mkdtemp(prefix="trace_", dir=workdir)
        argv = recipe_argv(model, workdir, bf16) + extra + [
            "--trace_dir", trace_dir, "--trace_start_step", "3", "--trace_steps", "3"]
        argv[argv.index("--print_freq") + 1] = "10"  # the default: no flush in the window
        run = supcon.main(argv)
        traces = glob.glob(os.path.join(trace_dir, "trace_steps_4_7.json"))
        if len(traces) != 1:
            failures.append(f"{label}: no profiler trace in {trace_dir}")
            continue
        untraced = [h["step_time"] * 1e3 for h in run.history[1:3]]
        print(f"observability {label}: profiler trace {os.path.basename(traces[0])} "
              f"{os.path.getsize(traces[0])} bytes; the run's steps 2-3 before the window "
              f"{[round(t, 3) for t in untraced]} ms by CUDA events {where}")
        summary = trace_summary(traces[0], label, 3)
        if summary is None:
            failures.append(f"{label}: the profiler trace holds no device operation")
        elif not summary["fused_conv_ops"]:
            failures.append(f"{label}: the profiler trace holds no {FUSED_CONV_KERNEL} kernel")
    if failures:
        raise AssertionError("observability:\n" + "\n".join(failures))


# -- ce: the supervised cross-entropy trainer -------------------------------

CE_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from simclr_pytorch_distributed_tpu_torch.train import ce
from simclr_pytorch_distributed_tpu_torch.utils import preempt
losses = []
step = ce.ce_step
def held(state, images, labels):
    metrics = step(state, images, labels)
    losses.append(metrics["loss"].item())
    if len(losses) == 3:
        print("STEP3", flush=True)
        deadline = time.time() + 120
        while not preempt.requested():
            if time.time() > deadline:
                raise RuntimeError("no SIGTERM came")
            time.sleep(0.01)
    return metrics
ce.ce_step = held
try:
    ce.main(json.loads(sys.argv[3]))
finally:
    with open(sys.argv[2], "w") as fh:
        json.dump(losses, fh)
"""


def ce_argv(workdir, bf16, epochs=1):
    return ["--device", "cuda", "--dataset", "synthetic", "--model", "resnet50",
            "--batch_size", "256", "--epochs", str(epochs), "--learning_rate", "0.1",
            "--cosine", "--print_freq", "1", "--save_freq", "1", "--data_placement", "host",
            "--workdir", tempfile.mkdtemp(prefix="ce_", dir=workdir)] + (
        ["--bf16"] if bf16 else [])


def ce_phase(workdir, where):
    """The CE trainer's entry point ``train.ce.main`` at the recipe's width
    (ResNet-50 ``SupCEResNet``, batch 256, 32 px, one 7-step epoch of
    ``--dataset synthetic`` and validation over its 256 test images) in
    fp32 and ``--bf16``: finite losses, no fused kernel launched (the CE
    model runs eager convs, as the JAX trainer runs XLA's), top-1/top-5 in
    [0, 100], the step time by CUDA events, and one eval batch's logits on
    the card against the port's CPU run of the same weights
    (``CE_LOGITS_REL_L2``). Then, with cuDNN's deterministic algorithms,
    two epochs straight against a subprocess SIGTERM'd after step 3 (exit
    75, ``preempt_epoch_1_step_3.pth``) and resumed: bitwise equal.
    Returns the straight two-epoch run (deterministic cuDNN)."""
    from simclr_pytorch_distributed_tpu_torch.data.cifar import synthetic_dataset
    from simclr_pytorch_distributed_tpu_torch.models import SupCEResNet
    from simclr_pytorch_distributed_tpu_torch.ops.augment import AugmentConfig, eval_batch
    from simclr_pytorch_distributed_tpu_torch.train import ce, linear
    from simclr_pytorch_distributed_tpu_torch.train.supcon import compute_dtype
    counters = kernel_counters()
    failures = []
    _, test = synthetic_dataset()
    mean, std = linear.stats_for("synthetic")
    aug_cfg = AugmentConfig(mean=mean, std=std, color_ops=False)
    for bf16 in (False, True):
        name = f"ce resnet50 {'bf16' if bf16 else 'fp32'}"
        for mod, counter in counters:
            setattr(mod, counter, 0)
        t0 = time.time()
        result = ce.main(ce_argv(workdir, bf16))
        wall = time.time() - t0
        launches = {counter: getattr(mod, counter) for mod, counter in counters}
        losses = [h["loss"] for h in result.history]
        times = [h["step_time"] * 1e3 for h in result.history]
        val = result.val_history[0]
        print(f"{name}: losses {losses}; train top-1 {[round(h['top1'], 2) for h in result.history]}"
              f"; validation {val}; best {result.best_acc} / {result.best_acc5}; run wall "
              f"{wall:.2f} s")
        print(f"{name} step (augment, forward, cross-entropy, backward, SGD; batch 256, 32 px) "
              f"by CUDA events {[round(t, 3) for t in times]} ms, median of steps 3-7 "
              f"{statistics.median(times[2:7]):.3f} ms; validation {val['seconds'] * 1e3:.2f} ms "
              f"{where}")
        if any(launches.values()):
            failures.append(f"{name}: fused kernels launched: {launches}")
        if len(losses) != 7 or not all(math.isfinite(x) for x in losses):
            failures.append(f"{name}: expected 7 finite losses")
        if not all(0.0 <= x <= 100.0 for x in (val["top1"], val["top5"])):
            failures.append(f"{name}: top-1/top-5 outside [0, 100]")
        if not os.path.isfile(os.path.join(result.save_folder, "last.pth")):
            failures.append(f"{name}: no last.pth")
        dev = next(result.state.model.parameters()).device
        x = torch.from_numpy(test["images"][:PROBE_ROWS]).to(dev)
        card = ce.eval_logits(result.state.model, eval_batch(x, aug_cfg)).cpu()
        cpu_model = SupCEResNet("resnet50", 10)
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   result.state.model.state_dict().items()})
        cpu_model.encoder.set_compute_dtype(compute_dtype(bf16))
        host = ce.eval_logits(cpu_model, eval_batch(x.cpu(), aug_cfg))
        rel = (torch.linalg.norm(card - host) / torch.linalg.norm(host)).item()
        print(f"{name}: {PROBE_ROWS} eval rows' logits, card vs the port on the CPU: relative "
              f"L2 {rel:.3e} (bound {CE_LOGITS_REL_L2[bf16]}), top-1 agreement "
              f"{(card.argmax(1) == host.argmax(1)).float().mean().item():.4f}")
        if not rel <= CE_LOGITS_REL_L2[bf16]:
            failures.append(f"{name}: card vs CPU logits relative L2 {rel:.3e}")
        del result
        torch.cuda.empty_cache()
    # resume: cuDNN's deterministic algorithms, here and in the child
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        straight = ce.main(ce_argv(workdir, False, epochs=2))
        code, saved, child_losses = sigterm_after_step3(
            CE_CHILD, ce_argv(workdir, False, epochs=2), workdir, "ce_preempted")
        print(f"ce: the SIGTERM'd run exited {code}, saved "
              f"{[os.path.basename(p) for p in saved]}")
        if code != 75 or [os.path.basename(p) for p in saved] != ["preempt_epoch_1_step_3.pth"]:
            raise AssertionError("ce: the SIGTERM'd run must exit 75 with "
                                 "preempt_epoch_1_step_3.pth")
        again = ce.main(ce_argv(workdir, False, epochs=2)
                        + ["--resume", os.path.dirname(saved[0])])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    got_losses = child_losses + [h["loss"] for h in again.history]
    want_losses = [h["loss"] for h in straight.history]
    bad = [] if got_losses == want_losses else ["losses"]
    gs, ws = again.state.model.state_dict(), straight.state.model.state_dict()
    bad += [k for k in ws if not torch.equal(gs[k], ws[k])]
    go = again.state.optimizer.state_dict()["state"]
    wo = straight.state.optimizer.state_dict()["state"]
    bad += [f"momentum {k}" for k in wo
            if not torch.equal(go[k]["momentum_buffer"], wo[k]["momentum_buffer"])]
    if (again.best_acc, again.best_acc5) != (straight.best_acc, straight.best_acc5):
        bad.append("best accuracy")
    print(f"ce: SIGTERM after step 3, then --resume vs straight: {len(got_losses)} losses, "
          f"{len(ws)} model tensors, {len(wo)} momentum buffers, best {again.best_acc}: "
          + ("bitwise equal" if not bad else f"{len(bad)} differ: {bad[:6]}"))
    if bad:
        failures.append(f"ce: the resumed run differs from the straight run: {bad[:8]}")
    if failures:
        raise AssertionError("ce:\n" + "\n".join(failures))
    return straight


# The placement phase. (a): windows of 3, 3 and a padded 1 over the 7-step
# epoch; (c): windows of 2, so the resume after step 3 lands mid-window.
PLACEMENT_WINDOW, RESUME_WINDOW = 3, 2
# (d), (g): --device_budget_mb values for the synthetic set at batch 256,
# whose resident store needs 16.5 MB and a double-buffered window of 3
# batches 4.7 MB: 10 MB holds the window alone, 1 MB neither.
WINDOW_ONLY_MB, HOST_ONLY_MB = 10, 1
# (g): the ladder picks each placement from its budget; the banner says which
LADDER_ARMS = (
    ("host", ["--device_budget_mb", str(HOST_ONLY_MB)], "data_placement auto -> host: "),
    ("device", [], "data_placement: device ("),
    ("window", ["--device_budget_mb", str(WINDOW_ONLY_MB), "--data_window_batches",
                str(PLACEMENT_WINDOW)], "data_placement: window ("),
)


def with_placement(argv, placement, *extra):
    """``argv`` with its ``--data_placement`` replaced, and ``extra``."""
    argv = list(argv)
    argv[argv.index("--data_placement") + 1] = placement
    return argv + list(extra)


class TransferCount:
    """Counts, over one driver run, the stores' uploads through their hooks
    (``DeviceStore``: the dataset once and the index matrix each epoch;
    ``WindowStore``: each window) and the host loader's per-step copies
    (``train.supcon.to_device``)."""

    def __enter__(self):
        from simclr_pytorch_distributed_tpu_torch.data.device_store import (
            DeviceStore,
            WindowStore,
        )
        from simclr_pytorch_distributed_tpu_torch.train import supcon
        self.counts = {}
        self._saved = []
        for owner, name, key in ((DeviceStore, "_upload_dataset", "dataset"),
                                 (DeviceStore, "_default_index_put", "index"),
                                 (WindowStore, "_default_put", "window"),
                                 (supcon, "to_device", "step_copy")):
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            self.counts[key] = 0

            def counted(*args, _fn=fn, _key=key, **kwargs):
                self.counts[_key] += 1
                return _fn(*args, **kwargs)

            setattr(owner, name, counted)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False


class BatchWait:
    """The host time of each step's wait for its batch (the driver's ``DT``,
    which its log prints to the millisecond): each ``next()`` of
    ``train.supcon.step_batches``, over one driver run; and of that, the
    host loader's pinned copies (``train.supcon.to_device``, two a step)."""

    def __enter__(self):
        from simclr_pytorch_distributed_tpu_torch.train import supcon
        self.waits, self.copies = [], []
        self._module, self._fn, self._copy = supcon, supcon.step_batches, supcon.to_device

        def timed_copy(*args, **kwargs):
            t0 = time.perf_counter()
            out = self._copy(*args, **kwargs)
            self.copies.append(time.perf_counter() - t0)
            return out

        def timed(*args, **kwargs):
            batches = self._fn(*args, **kwargs)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = next(batches)
                    except StopIteration:
                        return
                    self.waits.append(time.perf_counter() - t0)
                    yield item
            finally:
                batches.close()

        supcon.step_batches, supcon.to_device = timed, timed_copy
        return self

    def __exit__(self, *exc):
        self._module.step_batches, self._module.to_device = self._fn, self._copy
        return False


def run_log(result):
    """The run folder's ``log-ing`` and its ``events.jsonl`` records."""
    with open(os.path.join(result.save_folder, "log-ing")) as fh:
        log = fh.read()
    with open(os.path.join(result.save_folder, "events.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    return log, events


def same_validation(a, b):
    """Two runs' ``val_history`` equal bitwise, but for each pass's wall
    ``seconds``."""
    strip = [[{k: v for k, v in val.items() if k != "seconds"} for val in run] for run in (a, b)]
    return strip[0] == strip[1]


def same_tensors(got, want):
    """Names of the tensors of ``want`` that ``got`` does not hold bitwise."""
    return [k for k in want if not torch.equal(got[k].cpu(), want[k].cpu())]


def placement_phase(workdir, result, rn50_expected, resume_ref, probe_ref, ce_ref, where):
    """The data placements on the card (``data/device_store.py``), against
    the earlier phases' host-placement runs:

    (a) the train phase's rn50 fp32 fused epoch under ``--data_placement
        device`` and ``window`` (windows of 3): history and final tensors
        bitwise the host run's, the same kernel launches;
    (b) in those runs, the uploads through the stores' hooks (device: the
        dataset once, the index matrix once; window: 3 windows; neither a
        per-step copy) and no host sync from a step's batch to its flush
        boundary (``SyncGuard`` on the stores' ``batch``);
    (c) rn18 fp32 fused, two epochs under ``window`` (windows of 2): straight,
        and a subprocess SIGTERM'd after step 3 (exit 75; the resume lands
        mid-window) then resumed, both bitwise the resume phase's host run;
    (d) the ladder: an explicit ``device`` over ``--device_budget_mb 1``
        raises before step 1; the banners of (g)'s runs, whose placement
        the ladder picks from the card's budget, 10 MB and 1 MB;
    (e) a memmap-backed dataset through ``make_store('auto')``: a window
        store, its batches on the card byte-equal to the host loader's; and
        ``--dataset path`` through the driver where PIL imports;
    (f) the probe (from the rn50 fp32 ``last.pth``) and the CE trainer
        (two epochs, deterministic cuDNN) under ``device``, bitwise their
        host runs;
    (g) step times by CUDA events (median of steps 3-7), the data time
        (``DT``) and the ``window_swap`` span's host time under host,
        device and window, for rn50 fp32 fused, rn18 bf16 fused, and rn18
        bf16 fused with ``--health_freq 0``."""
    import numpy as np

    from simclr_pytorch_distributed_tpu_torch.data import device_store
    from simclr_pytorch_distributed_tpu_torch.data.cifar import synthetic_dataset
    from simclr_pytorch_distributed_tpu_torch.data.device_store import DeviceStore, WindowStore
    from simclr_pytorch_distributed_tpu_torch.data.pipeline import EpochLoader
    from simclr_pytorch_distributed_tpu_torch.train import ce, linear, supcon
    counters = kernel_counters()
    failures = []
    dev = torch.device("cuda", 0)

    # (a), (b)
    window = ["--data_window_batches", str(PLACEMENT_WINDOW)]
    for placement, extra, want in (
            ("device", [], {"dataset": 1, "index": 1, "window": 0, "step_copy": 0}),
            ("window", window, {"dataset": 0, "index": 0, "window": 3, "step_copy": 0})):
        for mod, counter in counters:
            setattr(mod, counter, 0)
        with TransferCount() as tc, SyncGuard([(DeviceStore, "batch"),
                                               (WindowStore, "batch")]) as guard:
            run = supcon.main(with_placement(recipe_argv("resnet50", workdir), placement, *extra))
        launches = {counter: getattr(mod, counter) for mod, counter in counters}
        log, _ = run_log(run)
        same = history_equal(run.history, result.history)
        differ = same_tensors(run.state.model.state_dict(), result.state.model.state_dict())
        print(f"placement (a) resnet50 fp32 fused --data_placement {placement} {extra}: "
              f"{len(run.history)} steps, history "
              f"{'bitwise equal to' if same else 'DIFFERS from'} the train phase's host run, "
              f"final tensors {'bitwise equal' if not differ else f'{len(differ)} differ'}, "
              f"launches {'as the host run' if launches == rn50_expected else launches}")
        print(f"placement (b) {placement}: uploads {tc.counts} (expected {want}); no host sync "
              f"in {guard.guarded_steps} guarded steps; {guard.fetches} metric-ring transfers")
        if not same or differ:
            failures.append(f"(a) {placement}: not bitwise the host run ({differ[:4]})")
        if launches != rn50_expected:
            failures.append(f"(a) {placement}: launches {launches}")
        if f"data_placement: {placement} (" not in log:
            failures.append(f"(a) {placement}: no '{placement}' banner")
        if tc.counts != want or guard.guarded_steps != 7 or guard.fetches != 7:
            failures.append(f"(b) {placement}: uploads {tc.counts}, {guard.guarded_steps} "
                            f"guarded steps, {guard.fetches} transfers")
        del run

    # (c)
    resume_window = ["--data_window_batches", str(RESUME_WINDOW)]
    want_losses = [h["loss"] for h in resume_ref.history]
    straight = supcon.main(with_placement(resume_argv(workdir, 2), "window", *resume_window))
    same_run("straight under window", straight, [h["loss"] for h in straight.history],
             resume_ref, want_losses, phase="placement (c)", want_name="host straight")
    code, saved, child_losses = sigterm_after_step3(
        RESUME_CHILD, with_placement(resume_argv(workdir, 2), "window", *resume_window),
        workdir, "window_preempted")
    print(f"placement (c): the SIGTERM'd window run exited {code}, saved "
          f"{[os.path.basename(p) for p in saved]}")
    if code != 75 or [os.path.basename(p) for p in saved] != ["preempt_epoch_1_step_3.pth"]:
        failures.append(f"(c): the SIGTERM'd run exited {code} with {saved}")
    else:
        again = supcon.main(with_placement(resume_argv(
            workdir, 2, "--resume", os.path.dirname(saved[0])), "window", *resume_window))
        got = child_losses + [h["loss"] for h in again.history]
        for ref, ref_losses, label in ((straight, [h["loss"] for h in straight.history],
                                        "window straight"), (resume_ref, want_losses,
                                                             "host straight")):
            same_run("SIGTERM after step 3 under window, then --resume", again, got, ref,
                     ref_losses, phase="placement (c)", want_name=label)
        del again
    del straight

    # (d) an explicit placement the budget refuses stops before step 1
    argv = with_placement(recipe_argv("resnet18", workdir, bf16=True), "device",
                          "--device_budget_mb", str(HOST_ONLY_MB))
    try:
        supcon.main(argv)
        refused = None
    except ValueError as e:
        refused = str(e)
    (folder,) = glob.glob(os.path.join(argv[argv.index("--workdir") + 1], "*", "*"))
    with open(os.path.join(folder, "log-ing")) as fh:
        steps_logged = fh.read().count("Train:")
    print(f"placement (d): --data_placement device --device_budget_mb {HOST_ONLY_MB} raised "
          f"before step 1 ({steps_logged} steps logged): {refused}")
    if refused is None or "cannot be satisfied" not in refused or steps_logged:
        failures.append(f"(d): the explicit over-budget placement did not stop: {refused}")

    # (e) a memmap-backed dataset is windowed, never resident
    train, _ = synthetic_dataset()
    path = os.path.join(workdir, "images.npy")
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8, shape=train["images"].shape)
    mm[:] = train["images"]
    mm.flush()
    del mm
    loader = EpochLoader(np.load(path, mmap_mode="r"), train["labels"], 256, base_seed=0)
    store = device_store.make_store("auto", loader, dev, window_batches=PLACEMENT_WINDOW)
    bad = 0
    for idx, (h_imgs, h_labs) in enumerate(loader.epoch(1)):
        b_imgs, b_labs = store.batch(1, idx)
        bad += not (np.array_equal(b_imgs.cpu().numpy(), h_imgs)
                    and np.array_equal(b_labs.cpu().numpy(), h_labs))
    store.close()
    print(f"placement (e): a memmap-backed dataset under make_store('auto') on the card's budget "
          f"-> {type(store).__name__}; {loader.steps_per_epoch - bad} of "
          f"{loader.steps_per_epoch} batches byte-equal to the host loader's")
    if not isinstance(store, WindowStore) or bad:
        failures.append(f"(e): {type(store).__name__}, {bad} batches differ")
    del store, loader
    try:
        import PIL  # noqa: F401
        pil = None
    except ImportError as e:
        pil = str(e)
    if pil is not None:
        print(f"placement (e): PIL does not import here ({pil}): the --dataset path run "
              "through the driver is not made")
    else:
        tree = os.path.join(workdir, "tree")
        rng = np.random.default_rng(3)
        from PIL import Image
        for cls in ("a", "b"):
            os.makedirs(os.path.join(tree, cls))
            for i in range(256):
                Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                    os.path.join(tree, cls, f"{i}.png"))
        argv = with_placement(recipe_argv("resnet18", workdir), "auto", "--dataset", "path",
                              "--data_folder", tree, "--mean", "(0.5,0.5,0.5)", "--std",
                              "(0.25,0.25,0.25)", "--mmap_threshold_mb", "0",
                              "--data_window_batches", "1")
        run = supcon.main(argv)
        log, _ = run_log(run)
        losses = [h["loss"] for h in run.history]
        print(f"placement (e): --dataset path (512 PNGs, the memmap cache) through the driver: "
              f"{'window' if 'data_placement: window (' in log else 'NOT window'}, losses "
              f"{losses}")
        if "data_placement: window (" not in log or not all(map(math.isfinite, losses)):
            failures.append("(e): the --dataset path run")

    # (f) the probe and the CE trainer under device placement
    probe = linear.main(with_placement(probe_argv(workdir, os.path.join(
        result.save_folder, "last.pth"), False), "device"))
    same = (history_equal(probe.history, probe_ref["history"])
            and same_validation(probe.val_history, probe_ref["val"]))
    differ = same_tensors(probe.state.model.state_dict(), probe_ref["classifier"])
    print(f"placement (f) probe resnet50 fp32 --data_placement device: history and validation "
          f"{'bitwise equal' if same else 'DIFFER'}, classifier "
          f"{'bitwise equal' if not differ else 'DIFFERS'} to the probe phase's host run")
    if not same or differ:
        failures.append("(f): the probe under device placement")
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        run = ce.main(with_placement(ce_argv(workdir, False, epochs=2), "device"))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    same = (history_equal(run.history, ce_ref.history)
            and same_validation(run.val_history, ce_ref.val_history))
    differ = same_tensors(run.state.model.state_dict(), ce_ref.state.model.state_dict())
    print(f"placement (f) ce resnet50 fp32, 2 epochs, --data_placement device: history and "
          f"validation {'bitwise equal' if same else 'DIFFER'}, model "
          f"{'bitwise equal' if not differ else f'{len(differ)} tensors differ'} to the ce "
          f"phase's host run")
    if not same or differ:
        failures.append("(f): CE under device placement")
    del run, probe

    # (g) the placements' step times, the ladder choosing each (d)
    for model, bf16, extra in (("resnet50", False, []), ("resnet18", True, []),
                               ("resnet18", True, ["--health_freq", "0"])):
        label = f"{model} {'bf16' if bf16 else 'fp32'} fused{' ' + ' '.join(extra) if extra else ''}"
        ref = None
        for placement, arm, banner in LADDER_ARMS:
            with BatchWait() as wait:
                run = supcon.main(with_placement(recipe_argv(model, workdir, bf16), "auto",
                                                 *arm, *extra))
            log, events = run_log(run)
            times = [h["step_time"] * 1e3 for h in run.history]
            dts = [w * 1e3 for w in wait.waits]
            copies = [(a + b) * 1e3 for a, b in zip(wait.copies[::2], wait.copies[1::2])]
            swaps = [e["dur"] * 1e3 for e in events if e.get("name") == "window_swap"]
            gathers = [e["dur"] * 1e3 for e in events if e.get("name") == "epoch_gather"]
            line = next((ln for ln in log.splitlines() if "data_placement" in ln), "")
            print(f"placement (g) {label} --data_placement auto {' '.join(arm)}: banner "
                  f"'{line.split('] ')[-1].strip()[:200]}'")
            print(f"placement (g) {label} {placement}: step by CUDA events median of steps 3-7 "
                  f"{statistics.median(times[2:7]):.2f} ms, all {[round(t, 2) for t in times]}; "
                  f"DT (wait for the batch) median of 3-7 {statistics.median(dts[2:7]):.3f} "
                  f"ms, all {[round(d, 3) for d in dts]}, of which pinned copies "
                  f"{[round(c, 3) for c in copies]} ms; window_swap host ms "
                  f"{[round(x, 3) for x in swaps]}; epoch_gather host ms "
                  f"{[round(x, 3) for x in gathers]} {where}")
            if banner not in log:
                failures.append(f"(d) {label}: no '{banner}' banner for {arm}")
            if len(dts) != 7:
                failures.append(f"(g) {label} {placement}: {len(dts)} batch waits")
            if ref is None:
                ref = run.history
            elif not history_equal(run.history, ref):
                failures.append(f"(g) {label}: {placement} history differs from host")
            del run
    if failures:
        raise AssertionError("placement:\n" + "\n".join(failures))


# The recipes phase: every SSL recipe through the pretraining entry point at
# the recipe's width (rn50 fp32 fused, batch 256, 32 px, the dataset on the
# card), then its checks. (label, extra arguments) of each run; the queue's
# K is a multiple of 2 x 256 and takes the dense loss.
RECIPE_QUEUE = 2048
RECIPE_RUNS = (
    ("supcon", ["--recipe", "supcon"]),
    ("simclr", ["--recipe", "simclr"]),
    ("byol", ["--recipe", "byol"]),
    ("simsiam", ["--recipe", "simsiam"]),
    ("vicreg", ["--recipe", "vicreg"]),
    ("simclr+queue", ["--recipe", "simclr", "--moco_queue", str(RECIPE_QUEUE),
                      "--loss_impl", "dense"]),
)
# the SupConConfig overrides of the same recipes, for the one-step checks
RECIPE_STEP_OVERRIDES = {
    "supcon": {"recipe": "supcon"}, "simclr": {"recipe": "simclr"},
    "byol": {"recipe": "byol"}, "simsiam": {"recipe": "simsiam"},
    "vicreg": {"recipe": "vicreg"},
    "simclr+queue": {"recipe": "simclr", "moco_queue": RECIPE_QUEUE},
}
# The accuracy arms run through scripts/port_recipes_eval.py (its PROBE_ARMS
# and full configuration: rn10, synthetic, batch 64, 16 px, 2 epochs, lr 0.05
# cosine, temp 0.5, --predictor_hidden 128, --print_freq 5, the health stream
# every 2nd step and the online probe on), beside the JAX package's CPU
# figures (docs/evidence/recipes_r12.json: the best windowed probe top-1)
# and its bar (scripts/ratchet.py:286-292).
RECIPE_JAX_CPU_TOP1 = {"supcon": 50.585938, "byol": 46.09375, "simsiam": 45.410156,
                       "vicreg": 49.121094, "simclr_queue": 47.753906}
RECIPE_PROBE_BAR = 20.0


def recipe_expected(expected, extra):
    """The launches of one 7-step epoch of a recipe run with ``extra``, from
    the simclr run's ``expected``: the loss kernels only for the
    contrastive recipes without a queue, and every conv forward twice for
    BYOL and the queue (their EMA network's gradient-free forward)."""
    out = dict(expected)
    contrastive = extra[1] in ("supcon", "simclr") and "--moco_queue" not in extra
    if not contrastive:
        out.update(fwd_launches=0, bwd_launches=0)
    if extra[1] == "byol" or "--moco_queue" in extra:
        for name in CONV_COUNTERS + BF16_COUNTERS:
            if "_fwd_" in name:
                out[name] *= 2
    return out


def same_slots(name, got, want, phase):
    """Raises unless two runs' recipe slots are bitwise equal: the
    predictor's parameters and momentum, the EMA network's parameters, the
    queue and its pointer."""
    def flat(state):
        out = {}
        if state.recipe_params is not None:
            out.update({f"predictor.{k}": v for k, v in state.recipe_params.state_dict().items()})
            for i, buf in state.recipe_opt_state.state_dict()["state"].items():
                out[f"predictor.momentum.{i}"] = buf["momentum_buffer"]
        for key, value in (state.recipe_state or {}).items():
            if isinstance(value, torch.nn.Module):
                out.update({f"{key}.{k}": p for k, p in value.named_parameters()})
            else:
                out[key] = value
        return out
    a, b = flat(got), flat(want)
    bad = sorted(set(a) ^ set(b)) + [
        k for k in b if k in a and not (torch.equal(a[k], b[k]) if torch.is_tensor(b[k])
                                        else a[k] == b[k])]
    print(f"{phase}: {name}: {len(b)} recipe slot tensors and entries "
          + ("bitwise equal" if not bad else f"{len(bad)} differ"))
    if bad:
        raise AssertionError(f"{phase}: {name}: recipe slots differ: {bad[:8]}")


def recipe_gloo_rank(rank, world, outdir):
    """One process of the recipes phase's data-parallel check: process
    ``rank`` of ``world`` on the one card over gloo, one BYOL step of
    ResNet-50 at the recipe's width with ``--syncBN`` and eager convs on its
    slice of the global batch of 256. Writes its model, predictor and
    target after the step and its loss into ``outdir``."""
    import datetime
    import torch.distributed as dist
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
        SupConStepConfig,
        train_step,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh.setup_distributed("cuda", init_method=f"file://{os.path.join(outdir, 'store')}",
                           rank=rank, world_size=world, backend="gloo",
                           timeout=datetime.timedelta(seconds=300))
    _, labels, _, views = recipe_batch(dev)
    b = views.shape[0] // world
    torch.manual_seed(0)
    model = SupConResNet("resnet50").to(dev, memory_format=torch.channels_last)
    model.encoder.set_conv_impl("eager").set_bn_sync(dist.group.WORLD)
    state = TrainState(model=model, optimizer=make_optimizer(model), schedule=lambda s: 0.5)
    method, loss_impl = attach_recipe(state, {"recipe": "byol"})
    cfg = SupConStepConfig(method=method, temperature=TEMP, loss_impl=loss_impl, epochs=1,
                           steps_per_epoch=7)
    loss = train_step(state, cfg, views[rank * b:(rank + 1) * b],
                      labels[rank * b:(rank + 1) * b])["loss"].item()
    out = with_predictor(state, model.state_dict())
    out.update({f"target.{k}": p.detach().double()
                for k, p in state.recipe_state["target"].named_parameters()})
    torch.save({k: v.cpu() for k, v in out.items()}, os.path.join(outdir, f"state{rank}.pt"))
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump({"loss": loss}, fh)
    mesh.teardown_distributed()


def recipe_runs(workdir, result, rn50_expected, rn50_bf16_expected, failures, where):
    """The recipes phase's (a) (:func:`recipes_phase`); appends to
    ``failures``."""
    from simclr_pytorch_distributed_tpu_torch.data.device_store import DeviceStore
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    counters = kernel_counters()

    def driven(label, argv, want):
        for mod, counter in counters:
            setattr(mod, counter, 0)
        with SyncGuard([(DeviceStore, "batch")]) as guard:
            run = supcon.main(argv)
        launches = {counter: getattr(mod, counter) for mod, counter in counters}
        log, events = run_log(run)
        losses = [h["loss"] for h in run.history]
        banner = next((ln for ln in log.splitlines() if "[conv_impl]" in ln), "")
        sites = banner.count("[bottleneck]") + ("stem 3->64@32x32" in banner)
        ms = statistics.median(h["step_time"] for h in run.history[2:7]) * 1e3
        print(f"recipes (a) {label}: losses {[round(x, 4) for x in losses]}; launches "
              f"{'as expected' if launches == want else launches}; fused sites {sites} of 17; "
              f"{guard.guarded_steps} steps guarded, no host sync; {guard.fetches} ring "
              f"transfers; step median of 3-7 {ms:.2f} ms {where}")
        if len(losses) != 7 or not all(map(math.isfinite, losses)):
            failures.append(f"(a) {label}: losses {losses}")
        if launches != want:
            failures.append(f"(a) {label}: launches {launches}, expected {want}")
        if sites != 17:
            failures.append(f"(a) {label}: {sites} fused sites in '{banner}'")
        if guard.guarded_steps != 7 or guard.fetches != 7:
            failures.append(f"(a) {label}: {guard.guarded_steps} guarded steps, "
                            f"{guard.fetches} transfers")
        if not any(e.get("name") == "run_recipe" for e in events):
            failures.append(f"(a) {label}: no run_recipe event")
        return run, ms

    step_ms = {}
    simclr_run = None
    for label, extra in RECIPE_RUNS:
        argv = with_placement(recipe_argv("resnet50", workdir), "device", *extra)
        run, step_ms[label] = driven(label, argv, recipe_expected(rn50_expected, extra))
        if label == "simclr":
            simclr_run = run
        del run
    run, step_ms["byol bf16"] = driven(
        "byol --bf16", with_placement(recipe_argv("resnet50", workdir, True), "device",
                                      "--recipe", "byol"),
        recipe_expected(rn50_bf16_expected, ["--recipe", "byol"]))
    del run
    attach = supcon.attach_for_config

    def inline(cfg, state):  # the step's inline path: no recipe on the state
        state, recipe = attach(cfg, state)
        state.recipe = None
        return state, recipe

    supcon.attach_for_config = inline
    try:
        control = supcon.main(with_placement(recipe_argv("resnet50", workdir), "device",
                                             "--recipe", "simclr"))
    finally:
        supcon.attach_for_config = attach
    for other, tag in ((control, "the run with no recipe on the state"),
                       (result, "the train phase's host run")):
        same = history_equal(simclr_run.history, other.history)
        differ = same_tensors(simclr_run.state.model.state_dict(), other.state.model.state_dict())
        print(f"recipes (a) --recipe simclr vs {tag}: history "
              f"{'bitwise equal' if same else 'DIFFERS'}, final tensors "
              f"{'bitwise equal' if not differ else f'{len(differ)} differ'}")
        if not same or differ:
            failures.append(f"(a) --recipe simclr is not bitwise {tag}")
    ckpt = torch.load(os.path.join(simclr_run.save_folder, "last.pth"), map_location="cpu",
                      weights_only=True)
    if "recipe" in ckpt:
        failures.append("(a) the simclr recipe's checkpoint holds a recipe payload")
    del control, simclr_run, ckpt
    print("recipes (a) step times, median of steps 3-7, ResNet-50 fp32 fused (byol also "
          "--bf16): " + ", ".join(f"{k} {v:.2f} ms" for k, v in step_ms.items())
          + "; over simclr: " + ", ".join(f"{k} {v / step_ms['simclr']:.3f}x"
                                           for k, v in step_ms.items()) + f" {where}")
    torch.cuda.empty_cache()


def recipe_step_checks(model, views, labels, failures):
    """The recipes phase's (b): one fused-vs-eager step of each recipe in
    fp32 and bf16."""
    for label, over in RECIPE_STEP_OVERRIDES.items():
        try:
            step_check(f"recipes (b) resnet50 {label}", model, views, labels, recipe=over)
            step_check_bf16(f"recipes (b) resnet50 {label}", model, views, labels, recipe=over)
        except AssertionError as e:
            failures.append(f"(b) {label}: {e}")
        torch.cuda.empty_cache()


def recipe_resumes(workdir, failures):
    """The recipes phase's (c): ResNet-18 byol and queue runs SIGTERM'd
    after step 3 and resumed, against the straight runs."""
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    for label, extra in (("byol", ["--recipe", "byol"]),
                         ("simclr+queue", ["--recipe", "simclr", "--moco_queue", "512",
                                           "--loss_impl", "dense"])):
        straight = supcon.main(resume_argv(workdir, 2, *extra))
        want = [h["loss"] for h in straight.history]
        code, saved, child_losses = sigterm_after_step3(RESUME_CHILD,
                                                        resume_argv(workdir, 2, *extra),
                                                        workdir, f"recipe_{label}")
        print(f"recipes (c) resnet18 {label}: the SIGTERM'd run exited {code}, saved "
              f"{[os.path.basename(p) for p in saved]}")
        if code != 75 or [os.path.basename(p) for p in saved] != ["preempt_epoch_1_step_3.pth"]:
            failures.append(f"(c) {label}: the SIGTERM'd run exited {code} with {saved}")
            continue
        again = supcon.main(resume_argv(workdir, 2, *extra, "--resume",
                                        os.path.dirname(saved[0])))
        try:
            same_run(f"{label}: SIGTERM after step 3, then --resume", again,
                     child_losses + [h["loss"] for h in again.history], straight, want,
                     phase="recipes (c)")
            same_slots(label, again.state, straight.state, "recipes (c)")
        except AssertionError as e:
            failures.append(f"(c) {e}")
        del straight, again


def recipe_data_parallel(workdir, model, views, labels, failures):
    """The recipes phase's (d): two gloo processes' BYOL step against one
    process on the global batch."""
    from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
        SupConStepConfig,
        train_step,
    )
    outdir = tempfile.mkdtemp(prefix="recipe_gloo_", dir=workdir)
    ranks = run_gloo_ranks(outdir, target="recipe_gloo_rank", label="recipes (d)")
    states = [torch.load(os.path.join(outdir, f"state{r}.pt"), map_location="cpu",
                         weights_only=True) for r in range(GLOO_WORLD)]
    bad = [k for k in states[0] if not torch.equal(states[0][k], states[1][k])]
    m = copy.deepcopy(model)
    m.encoder.set_conv_impl("eager")
    init = {k: v.detach().double().cpu() for k, v in m.state_dict().items()}
    st = TrainState(model=m, optimizer=make_optimizer(m), schedule=lambda s: 0.5)
    method, loss_impl = attach_recipe(st, {"recipe": "byol"})
    init.update({k: v.cpu() for k, v in with_predictor(st, {}).items()})
    init.update({f"target.{k}": p.detach().double().cpu()
                 for k, p in st.recipe_state["target"].named_parameters()})
    cfg = SupConStepConfig(method=method, temperature=TEMP, loss_impl=loss_impl, epochs=1,
                           steps_per_epoch=7)
    ref_loss = train_step(st, cfg, views, labels)["loss"].item()
    ref = {k: v.cpu() for k, v in with_predictor(st, m.state_dict()).items()}
    ref.update({f"target.{k}": p.detach().double().cpu()
                for k, p in st.recipe_state["target"].named_parameters()})
    params = {k for k, _ in m.named_parameters()} | {
        k for k in ref if k.startswith(("predictor.", "target."))}
    del m, st
    torch.cuda.empty_cache()
    rel = abs(ranks[0]["loss"] - ref_loss) / abs(ref_loss)
    upd_err, buf_worst = [], (0.0, None)
    for key, want in ref.items():
        got = states[0][key]
        if key in params:
            upd = want - init[key]
            err = ((got.double() - init[key]) - upd).norm() / upd.norm()
            upd_err.append((err.item(), key))
        elif want.is_floating_point():
            buf_worst = max(buf_worst, ((got.double() - want).abs().max().item(), key))
            if ((got.double() - want).abs() - STEP_BUF_TOL * (1 + want.abs())).max() > 0:
                failures.append(f"(d) buffer {key} off by more than rtol/atol {STEP_BUF_TOL}")
    worst = max(upd_err)
    for part in ("predictor.", "target."):
        part_worst = max(e for e in upd_err if e[1].startswith(part))
        print(f"recipes (d) byol, {GLOO_WORLD} processes (gloo, --syncBN) vs one on the global "
              f"batch: {part[:-1]} update relative L2 worst {part_worst[0]:.3e} at "
              f"{part_worst[1]}")
    print(f"recipes (d) byol: losses {[r['loss'] for r in ranks]} vs {ref_loss!r}, rel diff "
          f"{rel:.3e} (bound 1e-4); update relative L2 worst {worst[0]:.3e} at {worst[1]}, "
          f"median {statistics.median(e for e, _ in upd_err):.3e} over {len(upd_err)} parameters "
          f"(bound {STEP_UPDATE_REL_L2}); BN buffers max abs diff {buf_worst[0]:.3e} (bound "
          f"rtol/atol {STEP_BUF_TOL}); rank 1 equal to rank 0 on {len(states[0]) - len(bad)} "
          f"of {len(states[0])} tensors")
    if bad or not rel <= 1e-4 or not worst[0] <= STEP_UPDATE_REL_L2:
        failures.append(f"(d): ranks differ {bad[:4]}, loss rel {rel}, worst update {worst}")


def recipe_accuracy(workdir, failures, where):
    """The recipes phase's (e): the accuracy arms and the supcon
    bit-identity through ``scripts/port_recipes_eval.py``'s functions, the
    ``recipes`` gate's record on their artifact, the ``health_report``
    gate on its own smoke, and the collapse arm."""
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    ev = load_script("port_recipes_eval")
    args = ev.parse_args(["--device", "cuda", "--workdir",
                          tempfile.mkdtemp(prefix="recipes_eval_", dir=workdir)])
    recipes = {}
    for arm, extra in ev.PROBE_ARMS:
        rec = recipes[arm] = ev.probe_arm(args, arm, extra)
        best = rec["probe_best_top1"] if rec["probe_best_top1"] is not None else float("nan")
        print(f"recipes (e) accuracy {arm}: best windowed probe top-1 {best:.2f} over "
              f"{rec['windows']} windows (first {rec['probe_first_top1']}, last "
              f"{rec['probe_last_top1']}), {rec['alarms']} collapse alarms, health stream "
              f"consistent {rec['consistency_ok']}; the JAX package's CPU figure "
              f"{RECIPE_JAX_CPU_TOP1[arm]:.2f}; bar {RECIPE_PROBE_BAR} {where}")
        if not best > RECIPE_PROBE_BAR or rec["alarms"] or not rec["consistency_ok"]:
            failures.append(f"(e) {arm}: best probe top-1 {best}, {rec['alarms']} alarms")
    bit = ev.bit_identity_check(args)
    print(f"recipes (e) bit-identity: --recipe supcon through the interface against the "
          f"inline step, {bit['steps']} steps over {bit['epochs']} epochs, bitwise equal by "
          f"--data_placement: {bit['placements']}")
    artifact = ev.build_output("cuda", False, ev.config_of(args), bit, recipes)
    ratchet = load_script("port_ratchet")
    record = ratchet.recipe_gate_record(artifact)
    print(f"recipes (e) recipes gate record {json.dumps(record)}")
    if not (bit["ok"] and record["ok"]):
        failures.append(f"(e) bit-identity {bit}, gate {record}")
    # the health_report gate on its own smoke: one rn10 epoch, the trainer
    # and the report's CLI in child processes, as scripts/port_ratchet.py runs it
    t0 = time.time()
    record = ratchet.run_health_report_gate(
        tempfile.mkdtemp(prefix="health_gate_", dir=workdir), "cuda", 0)
    print(f"recipes (e) health_report gate record ({time.time() - t0:.1f} s) "
          f"{json.dumps(record)}")
    if not record["ok"]:
        failures.append(f"(e) the health_report gate: {record}")
    argv = ev.run_argv(args, "byol_none", [
        "--recipe", "byol", "--byol_predictor", "none", "--online_probe", "on",
        "--health_freq", "2", "--health_policy", "abort"])
    try:
        supcon.main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    print(f"recipes (e) byol --byol_predictor none --health_policy abort: exit code {code} "
          f"(expected 3)")
    if code != 3:
        failures.append(f"(e) the ablated byol exited {code}, not 3")


def recipe_native_gather(workdir, failures, where):
    """The recipes phase's (f): the native gather on the card's host."""
    from simclr_pytorch_distributed_tpu_torch.data import native_gather
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    lib = native_gather.load()
    print(f"recipes (f) native gather: {native_gather.library_path() if lib else 'NOT LOADED'}")
    if lib is None:
        failures.append("(f) the native gather did not load")
    for placement, extra in (("host", []), ("window", ["--data_window_batches",
                                                       str(PLACEMENT_WINDOW)])):
        native_gather.native_calls = 0
        with BatchWait() as wait:
            run = supcon.main(with_placement(recipe_argv("resnet50", workdir), placement, *extra))
        calls = native_gather.native_calls
        dts = [w * 1e3 for w in wait.waits]
        print(f"recipes (f) resnet50 fp32 fused --data_placement {placement}: {calls} native "
              f"gathers; DT (wait for the batch) median of steps 3-7 "
              f"{statistics.median(dts[2:7]):.3f} ms, all {[round(d, 3) for d in dts]} {where}")
        if not calls > 0:
            failures.append(f"(f) {placement}: no native gather")
        del run


def recipes_phase(workdir, result, rn50_expected, rn50_bf16_expected, model, views, labels,
                  where):
    """The SSL recipes on the card (``recipes/``), each through
    ``train.supcon.main``:

    (a) ResNet-50 fp32 with ``--conv_impl fused``, batch 256, 32 px,
        ``--data_placement device``, one 7-step epoch of each of
        ``RECIPE_RUNS`` (supcon and simclr with the fused loss; byol,
        simsiam, vicreg; simclr with a queue of 2048 and the dense loss),
        then byol under ``--bf16``: every site fused, the launches of each
        recipe (:func:`recipe_expected`: BYOL and the queue forward twice,
        only supcon and simclr launch the loss kernels), no host sync
        between flush boundaries under ``--telemetry async`` and one
        transfer a window, 7 finite losses; the simclr run bitwise the
        train phase's run and a run with the recipe taken off the state
        (the step's inline path); the step times (median of steps 3-7);
    (b) one step of each recipe, fused against eager conv, at the train
        phase's fp32 and bf16 pins (:func:`step_check`,
        :func:`step_check_bf16`), the predictor held with the model;
    (c) ResNet-18 at full width, byol and the queue (512): two epochs
        straight, and a run SIGTERM'd after step 3 (exit 75) then resumed,
        bitwise equal, the recipe slots included;
    (d) two processes on the one card over gloo, one ResNet-50 BYOL step
        with ``--syncBN`` and eager convs, against one process on the
        global batch at the step pins (the predictor's gradient and the
        gathered target rows);
    (e) the accuracy arms of ``scripts/port_recipes_eval.py``: each arm's
        best windowed online-probe top-1 (read through the health report)
        above ``RECIPE_PROBE_BAR`` with no collapse alarm, beside the JAX
        package's CPU figures; the supcon bit-identity under host and
        device placement; the ``recipes`` gate's record; the
        ``health_report`` gate (``scripts/port_ratchet.py``); and byol with
        ``--byol_predictor none --health_policy abort`` exits 3;
    (f) the native host gather loaded, and taken by the host and window
        placements' runs (its counter above 0), with their data waits."""
    failures = []
    recipe_runs(workdir, result, rn50_expected, rn50_bf16_expected, failures, where)
    recipe_step_checks(model, views, labels, failures)
    recipe_resumes(workdir, failures)
    recipe_data_parallel(workdir, model, views, labels, failures)
    recipe_accuracy(workdir, failures, where)
    recipe_native_gather(workdir, failures, where)
    if failures:
        raise AssertionError("recipes:\n" + "\n".join(failures))


# -- supervise: the port's supervisor on the port's trainer ----------------

VICTIM = os.path.join(REPO, "scripts", "port_supervisor_victim.py")
# the fused kernels one step launches, per (model, --bf16), in the victim's
# KERNELS names (utils: fused_loss's counters prefixed "loss_")
STEP_LAUNCHES = {
    ("resnet50", False): {"loss_fwd_launches": 1, "loss_bwd_launches": 1,
                          "stem_fwd_launches": 1, "stem_bwd_launches": 1,
                          "bottleneck_fwd_launches": 16, "bottleneck_bwd_launches": 16},
    ("resnet18", True): {"loss_fwd_launches": 1, "loss_bwd_launches": 1,
                         "stem_fwd_bf16_launches": 1, "stem_bwd_bf16_launches": 1,
                         "basic_fwd_bf16_launches": 5, "basic_bwd_bf16_launches": 5,
                         "proj_fwd_bf16_launches": 3, "proj_bwd_bf16_launches": 3},
}
# the port launchers' child: torchrun's agent at one process, its worker in
# a session of its own ((b) runs behind it)
TORCHRUN_1 = ["-m", "simclr_pytorch_distributed_tpu_torch.parallel.torchrun", "--standalone",
              "--nproc_per_node", "1"]
# (b)'s liveness deadline, the trainer's watchdog and the grace window:
# the scraped boundary age passes the deadline first; the watchdog dumps
# inside the grace window, which then lapses to SIGKILL. The watchdog arms
# when the run starts, so its deadline must pass what a child does before
# its first boundary (the victim imports torch._dynamo before the run;
# PERF.md §6), or a healthy start reads as a stall
SUP_STALL_S, SUP_WATCHDOG_S, SUP_GRACE_S = 5.0, 12.0, 12.0
SUP_TIMEOUT_S = 240
# (a) and (e) signal the child at this step of its run: step 3 of epoch 2
SUP_HOLD_STEP = 10
# (g): the fleet launcher's trainer mode, two processes resized to one
FLEET_LAUNCHER = os.path.join(REPO, "scripts", "port_fleet_launcher.py")
RESIZE_BEFORE, RESIZE_AFTER, RESIZE_HOLD_STEP = 2, 1, 9


def victim_argv(model, workdir, epochs=2, bf16=False):
    """The trainer's arguments for a supervised child: ``model`` at the
    recipe's width (batch 256, 32 px) with ``--conv_impl fused --loss_impl
    fused``, a boundary every step, a save every epoch, in ``workdir``."""
    return (["--device", "cuda", "--dataset", "synthetic", "--model", model,
             "--batch_size", "256", "--size", "32", "--epochs", str(epochs), "--method", "SimCLR",
             "--temp", str(TEMP), "--learning_rate", "0.5", "--loss_impl", "fused",
             "--conv_impl", "fused", "--print_freq", "1", "--save_freq", "1",
             "--data_placement", "host", "--workdir", workdir] + (["--bf16"] if bf16 else []))


class Supervised:
    """``python -m simclr_pytorch_distributed_tpu_torch.supervise`` over the
    victim (behind ``launcher``, arguments to the interpreter before the
    victim's path), in a session of its own, its merged output read line by
    line with the time each line came."""

    def __init__(self, workdir, sup_flags, victim_flags, trainer_argv, launcher=(),
                 victim=True):
        import threading
        self.workdir = workdir
        # victim=False: the launcher starts the victim itself (the fleet
        # launcher's trainer mode, from the flags after its "--")
        cmd = ([sys.executable, "-m", "simclr_pytorch_distributed_tpu_torch.supervise",
                "--workdir", workdir, "--poll_secs", "0.2", "--backoff_base_s", "0.5"]
               + sup_flags + ["--", sys.executable] + list(launcher)
               + ([VICTIM] if victim else []) + victim_flags + trainer_argv)
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.lines = []
        self.proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     start_new_session=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append((time.time(), line.rstrip("\n")))

    def wait_line(self, prefix, timeout=SUP_TIMEOUT_S):
        """The first line starting with ``prefix`` and its time."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            for t, line in list(self.lines):
                if line.startswith(prefix):
                    return t, line
            if self.proc.poll() is not None and not self._reader.is_alive():
                break
            time.sleep(0.05)
        raise AssertionError(f"no line starting {prefix!r} came: {self.tail()}")

    def tail(self, n=30):
        return "\n".join(line for _, line in self.lines[-n:])

    def stop(self):
        """Kill whatever is left of the supervisor's tree (torchrun's workers
        leave its session, so the tree and not the session)."""
        from simclr_pytorch_distributed_tpu_torch.supervise.launch import kill_tree
        if self.proc.poll() is None:
            kill_tree(self.proc.pid)
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except OSError:
            pass
        self.proc.wait()

    def finish(self):
        try:
            rc = self.proc.wait(timeout=SUP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            self.stop()
            self._reader.join(timeout=10)
        if rc is None:
            raise AssertionError(f"the supervisor did not finish in {SUP_TIMEOUT_S} s:\n"
                                 f"{self.tail()}")
        with open(os.path.join(self.workdir, "supervise", "events.jsonl")) as fh:
            self.events = [json.loads(ln) for ln in fh]
        self.decisions = [e["args"]["action"] for e in self.events if e["name"] == "decision"]
        return rc

    def attempts(self):
        """The output split at each launch: one list of ``(time, line)`` a
        child, the supervisor's decision line after it included."""
        out = []
        for t, line in self.lines:
            if "supervise: attempt " in line:
                out.append([])
            if out:
                out[-1].append((t, line))
        return out


def with_flag(argv, flag, value):
    """``argv`` with ``flag``'s value replaced by ``value``."""
    out = list(argv)
    out[out.index(flag) + 1] = value
    return out


def child_kernels(lines):
    """The last ``KERNELS`` report of one child, and how many steps it logged."""
    reports = [json.loads(line.split(" ", 1)[1]) for _, line in lines
               if line.startswith("KERNELS ")]
    steps = sum(1 for _, line in lines if "Train: [" in line)
    return (reports[-1] if reports else None), steps


def wall(lines, prefix):
    """The wall clock a child printed on its first ``prefix`` line."""
    for _, line in lines:
        if line.startswith(prefix):
            return float(line.split("wall=")[1].split()[0])
    return None


def recovery(sup, kill_t=None):
    """Seconds from the first child's end (the kill when this script made
    it, else the supervisor's decision line, logged when it reaped the
    child) to the relaunched child's first finished step, and its split:
    to the relaunch's start (the decision, the backoff, the spawn), its
    start-up to its first step's call (imports, CUDA, data, model,
    restore), and that first step."""
    attempts = sup.attempts()
    if len(attempts) < 2:
        return None, None
    decided = [t for t, line in attempts[0] if "supervise decision:" in line]
    marks = [wall(attempts[1], p) for p in ("START", "RUN", "STEP_BEGIN", "FIRST_STEP")]
    imports = [line for _, line in attempts[1] if line.startswith("RUN ")]
    if not decided or None in marks or not imports:
        return None, None
    start = kill_t if kill_t is not None else decided[0]
    fields = dict(kv.split("=") for kv in imports[0].split()[2:])
    return marks[3] - start, {
        "to_start": round(marks[0] - start, 3), "imports": round(marks[1] - marks[0], 3),
        "of_which_torch": float(fields["import_torch_s"]),
        "of_which_dynamo": float(fields["import_dynamo_s"]),
        "run_to_first_step": round(marks[2] - marks[1], 3),
        "first_step": round(marks[3] - marks[2], 3)}


def report_scenario(label, sup, rc, want, want_rc, failures, per_step, kill_t=None,
                    where=""):
    """Prints the scenario's line and its children's kernels; records a
    failure unless the decisions and the exit code are ``want`` and
    ``want_rc`` and each child that ran to its end launched ``per_step`` a
    logged step."""
    took, split = recovery(sup, kill_t)
    launches = sum(1 for e in sup.events if e["name"] == "launch")
    print(f"supervise {label}: decisions {sup.decisions}, supervisor exit {rc}, launches "
          f"{launches}, first child's end to the relaunch's first finished step "
          + (f"{took:.3f} s {split}" if took is not None else "n/a") + f" {where}")
    if sup.decisions != want or rc != want_rc:
        failures.append(f"{label}: decisions {sup.decisions} exit {rc}, expected {want} "
                        f"exit {want_rc}:\n{sup.tail()}")
    codes = [e["args"]["rc"] for e in sup.events if e["name"] == "child_run"]
    for i, lines in enumerate(sup.attempts()):
        kernels, steps = child_kernels(lines)
        rc_i = codes[i] if i < len(codes) else None
        print(f"supervise {label}: child {i + 1} exit {rc_i}, {steps} steps logged, fused "
              f"kernels launched (its last report) {kernels}")
        if rc_i == 0:
            expect = {k: v * steps for k, v in per_step.items()}
            if kernels != expect or not steps:
                failures.append(f"{label}: child {i + 1} launched {kernels} in {steps} steps, "
                                f"expected {expect}")
    return took


def process_alive(pid):
    """Whether ``pid`` runs: a zombie (exited, not yet reaped) does not."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def last_state(workdir):
    """The ``last.pth`` of the newest run folder under ``workdir``."""
    from simclr_pytorch_distributed_tpu_torch.supervise.launch import find_resume_dir
    run_dir = find_resume_dir(workdir, require_checkpoint=True)
    if run_dir is None or not os.path.isfile(os.path.join(run_dir, "last.pth")):
        raise AssertionError(f"no last.pth under {workdir}")
    return torch.load(os.path.join(run_dir, "last.pth"), map_location="cpu", weights_only=True)


def same_last(label, got_dir, want, failures):
    got = last_state(got_dir)
    bad = [k for k in want["model"] if not torch.equal(got["model"][k], want["model"][k])]
    if got["step"] != want["step"]:
        bad.append(f"step {got['step']} vs {want['step']}")
    print(f"supervise {label}: last.pth vs the straight run's: {len(want['model'])} parameters "
          f"and buffers, step {got['step']}: "
          + ("bitwise equal" if not bad else f"{len(bad)} differ"))
    if bad:
        failures.append(f"{label}: last.pth differs from the straight run: {bad[:8]}")


def supervise_gauges(workdir, expected, failures):
    """(f): the ResNet-18 bf16 fused epoch under torchrun's environment at
    world size 1 (NCCL) with ``--metrics_port``, the sidecar scraped after
    two boundaries: the boundary exchange publishes zero skew, straggler -1
    and one process, and ``SyncGuard`` sees no host sync between
    boundaries; the run launches ``expected``."""
    from simclr_pytorch_distributed_tpu_torch.supervise.observe import parse_prometheus_text
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    port = free_port()
    argv = victim_argv("resnet18", workdir, epochs=1, bf16=True) + ["--metrics_port", str(port)]
    step, scraped = supcon.train_step, {}

    def scraping(state, cfg, views, labels):
        metrics = step(state, cfg, views, labels)
        if state.step == 3:  # two boundaries in
            scraped.update(parse_prometheus_text(scrape(port)))
        return metrics

    counters = kernel_counters()
    for mod, counter in counters:
        setattr(mod, counter, 0)
    supcon.train_step = scraping
    try:
        with SyncGuard() as guard:
            torchrun_world1(argv)
    finally:
        supcon.train_step = step
    launches = {counter: getattr(mod, counter) for mod, counter in counters}
    gauges = {k: scraped.get(k) for k in ("train_boundary_skew_seconds",
                                          "train_boundary_straggler", "train_process_count",
                                          "train_collective_wait_seconds")}
    print(f"supervise (f) world size 1 over NCCL: scraped {gauges}; no host sync in "
          f"{guard.guarded_steps} guarded step windows, {guard.fetches} transfers for 7 windows")
    if (gauges["train_boundary_skew_seconds"] != 0.0 or gauges["train_boundary_straggler"] != -1.0
            or gauges["train_process_count"] != 1.0):
        failures.append(f"(f): the world-1 gauges are {gauges}")
    if guard.guarded_steps != 7 or guard.fetches != 7 or launches != expected:
        failures.append(f"(f): {guard.guarded_steps} guarded windows, {guard.fetches} transfers, "
                        f"launches {launches} (expected {expected})")


def supervise_phase(workdir, rn18_bf16_expected, where):
    """The port's supervisor (``python -m
    simclr_pytorch_distributed_tpu_torch.supervise``) on the port's trainer
    through ``scripts/port_supervisor_victim.py``, on the card: (a) ``kill
    -9`` in epoch 2 of a ResNet-50 fp32 fused run gives ``backoff_restart``
    then ``done``, its ``last.pth`` bitwise that of a straight unsupervised
    run; (b) a ResNet-18 bf16 run whose main thread wedges at a flush
    boundary is killed off the scraped boundary age, its watchdog's dump
    appears, the grace window lapses to SIGKILL, and the relaunch finishes;
    (c) a non-finite loss exits 1, then ``backoff_restart`` and ``done``;
    (d) a collapse exits 3 and the supervisor gives up with 3; (e) an
    outside SIGTERM gives exit 75, ``restart_resume`` with no backoff, then
    ``done``, bitwise the straight run; (f) the skew gauges at world size 1
    over NCCL, scraped mid-run, with no host sync between boundaries.
    (b)'s child is the port launchers' ``parallel/torchrun.py`` at one
    process over NCCL, and its wedged worker must be gone after the kill.
    (a)-(e) run at once on the card, so each recovery time is read with the
    other scenarios' children beside it. Resize and the straggler ladder
    need two processes, and the card's machine has one card: the CPU tests
    run them."""
    failures = []
    rn50, rn18 = STEP_LAUNCHES[("resnet50", False)], STEP_LAUNCHES[("resnet18", True)]

    def fresh(name):
        return tempfile.mkdtemp(prefix=f"sup_{name}_", dir=workdir)

    # the straight run (a) and (e) are held to, through the entry point in
    # this process (the resume phase holds a child's steps to this
    # process's bitwise)
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    straight_dir = fresh("straight")
    t0 = time.time()
    supcon.main(victim_argv("resnet50", straight_dir))
    straight = last_state(straight_dir)
    print(f"supervise: the straight unsupervised ResNet-50 fp32 run, 2 epochs, took "
          f"{time.time() - t0:.2f} s of wall time {where}")

    # (a)-(e) run at once, their children sharing the card: (d) a collapse
    # under --health_policy abort; (a) kill -9 and (e) an outside SIGTERM in
    # epoch 2; (b) a stall behind the torchrun launcher, whose worker the
    # kill must take too; (c) a non-finite loss
    wd = {k: fresh(name) for k, name in (("a", "sigkill"), ("b", "stall"), ("c", "nan"),
                                          ("d", "collapse"), ("e", "preempt"), ("g", "resize"))}
    port = free_port()
    hold = ["--fault", "hold", "--fault_step", str(SUP_HOLD_STEP)]
    specs = {
        "d": ([], ["--fault", "collapse"], victim_argv("resnet18", wd["d"], epochs=1, bf16=True)
              + ["--health_freq", "1", "--health_policy", "abort"], ()),
        "a": ([], hold + ["--fault_marker", os.path.join(wd["a"], "hold.marker")],
              victim_argv("resnet50", wd["a"]), ()),
        "e": ([], hold + ["--fault_marker", os.path.join(wd["e"], "hold.marker")],
              victim_argv("resnet50", wd["e"]), ()),
        "b": (["--stall_secs", str(SUP_STALL_S), "--metrics_port", str(port),
               "--grace_secs", str(SUP_GRACE_S)],
              ["--fault", "stall", "--fault_step", "3", "--fault_marker",
               os.path.join(wd["b"], "stall.marker")],
              victim_argv("resnet18", wd["b"], epochs=1, bf16=True)
              + ["--metrics_port", str(port), "--watchdog_secs", str(SUP_WATCHDOG_S)],
              TORCHRUN_1),
        "c": ([], ["--fault", "nan", "--fault_step", "3", "--fault_marker",
                   os.path.join(wd["c"], "nan.marker")],
              victim_argv("resnet18", wd["c"], epochs=1, bf16=True), ()),
        # --conv_impl auto: eager convs at world size 2, the fused kernels at 1
        "g": (["--devices", str(RESIZE_BEFORE), "--grace_secs", "120"],
              ["--fault", "hold", "--fault_step", str(RESIZE_HOLD_STEP), "--fault_marker",
               os.path.join(wd["g"], "hold.marker")],
              with_flag(victim_argv("resnet18", wd["g"], bf16=True), "--conv_impl", "auto")
              + ["--ngpu", "auto"],
              (FLEET_LAUNCHER, "--trainer", "--workdir", wd["g"], "--")),
    }
    sups, rcs, kill_t = {}, {}, {}
    try:
        for k, (sup_flags, victim_flags, trainer_argv, launcher) in specs.items():
            sups[k] = Supervised(wd[k], sup_flags, victim_flags, trainer_argv, launcher,
                                 victim=launcher[:1] != (FLEET_LAUNCHER,))
        for k, sig in (("a", signal.SIGKILL), ("e", signal.SIGTERM)):
            _, line = sups[k].wait_line("HOLD ")
            kill_t[k] = time.time()
            os.kill(int(line.split("pid=")[1]), sig)
        # (g): the fleet's output reaches the supervisor only at its end, so
        # the hold is read off its marker
        marker = os.path.join(wd["g"], "hold.marker")
        deadline = time.time() + SUP_TIMEOUT_S
        while not os.path.exists(marker):
            if time.time() > deadline or sups["g"].proc.poll() is not None:
                raise AssertionError(f"(g): no hold came:\n{sups['g'].tail()}")
            time.sleep(0.05)
        kill_t["g"] = time.time()
        with open(os.path.join(wd["g"], "supervise", "resize_request"), "w") as fh:
            fh.write(str(RESIZE_AFTER))
        for k in sups:
            rcs[k] = sups[k].finish()
    finally:
        for sup in sups.values():
            sup.stop()

    report_scenario("(d) collapse resnet18 bf16", sups["d"], rcs["d"], ["give_up"], 3, failures,
                    rn18, where=where)
    took = {"a": report_scenario("(a) sigkill resnet50 fp32", sups["a"], rcs["a"],
                                 ["backoff_restart", "done"], 0, failures, rn50, kill_t["a"],
                                 where)}
    same_last("(a) sigkill", wd["a"], straight, failures)

    sup = sups["b"]
    took["b"] = report_scenario("(b) stall resnet18 bf16 under torchrun", sup, rcs["b"],
                                ["backoff_restart", "done"], 0, failures, rn18, where=where)
    stalls = [e["args"] for e in sup.events if e["name"] == "liveness_stall"]
    codes = [e["args"]["rc"] for e in sup.events if e["name"] == "child_run"]
    dumps = glob.glob(os.path.join(wd["b"], "*", "*", "stall_dump_*.txt"))
    wedged = [d for d in dumps if "stalling_vote" in open(d).read()]
    _, line = sup.wait_line("FAULT stall")
    worker = int(line.split("pid=")[1])
    left = process_alive(worker)
    print(f"supervise (b): liveness verdicts {stalls}; child exits {codes}; watchdog dumps "
          f"{[os.path.basename(d) for d in dumps]} ({len(wedged)} showing the wedged frame); "
          f"the wedged torchrun worker (pid {worker}) "
          + ("is still running" if left else "is gone"))
    if left:
        os.kill(worker, signal.SIGKILL)
        failures.append(f"(b): the wedged worker {worker} outlived the kill of its launcher")
    if (len(stalls) != 1 or stalls[0]["age_s"] is None or stalls[0]["age_s"] < SUP_STALL_S
            or codes[:1] != [-signal.SIGKILL] or not wedged):
        failures.append(f"(b): expected one verdict off the scraped age >= {SUP_STALL_S} s, "
                        f"a SIGKILL after the grace window and a dump of the wedged frame: "
                        f"{stalls}, {codes}, {dumps}")

    codes = [e["args"]["rc"] for e in sups["c"].events if e["name"] == "child_run"]
    took["c"] = report_scenario("(c) nan resnet18 bf16", sups["c"], rcs["c"],
                                ["backoff_restart", "done"], 0, failures, rn18, where=where)
    if codes[:1] != [1]:
        failures.append(f"(c): the first child exited {codes}, expected 1")

    sup = sups["e"]
    took["e"] = report_scenario("(e) preempt resnet50 fp32", sup, rcs["e"],
                                ["restart_resume", "done"], 0, failures, rn50, kill_t["e"], where)
    delays = [e["args"]["delay_s"] for e in sup.events if e["name"] == "decision"]
    codes = [e["args"]["rc"] for e in sup.events if e["name"] == "child_run"]
    if codes[:1] != [75] or delays[:1] != [0.0]:
        failures.append(f"(e): the first child exited {codes} with delays {delays}, "
                        f"expected 75 and no backoff")
    same_last("(e) preempt", wd["e"], straight, failures)

    # (g) the resize: two gloo processes on the card, relaunched on one
    sup = sups["g"]
    took["g"] = report_scenario("(g) resize resnet18 bf16 2 -> 1", sup, rcs["g"],
                                ["restart_resized", "done"], 0, failures, rn18, kill_t["g"],
                                where)
    launches = [e["args"] for e in sup.events if e["name"] == "launch"]
    codes = [e["args"]["rc"] for e in sup.events if e["name"] == "child_run"]
    final = last_state(wd["g"])
    steps = 2 * -(-1792 // 256)
    print(f"supervise (g): launches' devices {[la.get('devices') for la in launches]}, resumed "
          f"{[bool(la.get('resume')) for la in launches]}, child exits {codes}, last.pth step "
          f"{final['step']} of {steps}")
    if ([la.get("devices") for la in launches] != [RESIZE_BEFORE, RESIZE_AFTER]
            or not launches[-1].get("resume") or codes[:1] != [75]
            or final["step"] != steps):
        failures.append(f"(g): launches {launches}, exits {codes}, step {final['step']}")

    # (f) the boundary gauges at world size 1 over NCCL, no host sync between boundaries
    supervise_gauges(fresh("gauges"), rn18_bf16_expected, failures)
    print("supervise: the straggler ladder and the chaos run are scripts/"
          "port_supervisor_matrix.py's (docs/evidence/port_chaos_matrix_r21.json; the "
          "evidence phase judges it)")
    print("supervise recovery seconds (first child's end to the relaunch's first finished step): "
          + json.dumps({k: round(v, 3) if v is not None else None for k, v in took.items()})
          + f" {where}")
    if failures:
        raise AssertionError("supervise:\n" + "\n".join(failures))


# -- serve: the serving stack on the card ---------------------------------------

SERVE_DEVICE = "cuda"
SERVE_BUCKETS = (1, 8, 32, 128)
SERVE_BUCKETS_ARG = ",".join(map(str, SERVE_BUCKETS))
# across buckets cuDNN may take another algorithm, so another summation
# order: the JAX engine's cross-program pin (test_serve_engine.py:59-67)
SERVE_CROSS_BUCKET_TOL = 1e-5
# bf16 against fp32 serving: the JAX engine's pin (test_serve_engine.py:151-169)
SERVE_BF16_ATOL = 0.05
SERVE_BF16_COS = 0.995
SERVE_ROWS = 64  # the card-vs-CPU rows
SERVE_HTTP_REQUESTS = 256
SERVE_HTTP_CLIENTS = 16
SERVE_HTTP_MAX_ROWS = 64
SERVE_INDEX_CAPACITY = 4096
SERVE_CORPUS = 2048
SERVE_QUERIES = 32
SERVE_K = 10
SERVE_SCORE_ATOL = 1e-5  # cosine scores: the card's fp32 product against numpy's
SERVE_QUOTA_ROWS = 64
SERVE_REPLICAS = 2
SERVE_REPLICA_TIMEOUT_S = 240


def serve_images(n, seed, size=32):
    """``n`` uint8 ``[size, size, 3]`` images drawn from ``seed``."""
    import numpy as np
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


class NoHostSync:
    """Calls ``fn`` under ``torch.cuda.set_sync_debug_mode("error")``, so a
    host sync inside it raises; ``calls`` counts the guarded calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, fn, *args):
        self.calls += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)


def post_json(base, path, obj, timeout=120):
    """``(status, body, headers)`` of a JSON POST, an HTTP error's too."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def get_text(base, path, timeout=60):
    import urllib.request
    with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
        return r.status, r.read().decode()


def b64_payload(images, **extra):
    import base64
    return {"images_b64": base64.b64encode(images.tobytes()).decode(),
            "shape": list(images.shape), **extra}


def at_bucket(engine, images, bucket):
    """``engine``'s rows of ``images`` computed at ``bucket`` (whole buckets,
    the last padded with zero images; within one bucket rows are
    independent bitwise)."""
    import numpy as np
    out = []
    for lo in range(0, len(images), bucket):
        chunk = images[lo:lo + bucket]
        padded = np.zeros((bucket,) + chunk.shape[1:], np.uint8)
        padded[:len(chunk)] = chunk
        out.append(engine.embed(padded)[:len(chunk)])
    return np.concatenate(out)


def scaled_excess(a, b, tol):
    """max |a - b| / (tol + tol |b|): above 1 breaks allclose(rtol = atol = tol)."""
    import numpy as np
    return float(np.max(np.abs(a - b) / (tol + tol * np.abs(b))))


def serve_engine_checks(ckpt, failures, where):
    """(a): ``EmbeddingEngine`` on the card from ``ckpt`` (the train phase's
    rn50 fp32 fused ``last.pth``) at ``SERVE_BUCKETS``, features and
    projections in fp32 and bf16: card against the CPU engine, bf16 against
    fp32, padded against exact batches, bucket against bucket, a 300-image
    request, the cache-hit path, every dispatch with host syncs raising,
    and the time of each bucket. Returns the engines and the times."""
    import numpy as np
    from simclr_pytorch_distributed_tpu_torch.ops.augment import eval_batch
    from simclr_pytorch_distributed_tpu_torch.serve.cache import EmbeddingCache
    from simclr_pytorch_distributed_tpu_torch.serve.engine import EmbeddingEngine

    guard = NoHostSync()
    engines = {(output, dtype): EmbeddingEngine.from_checkpoint(
        ckpt, device=SERVE_DEVICE, buckets=SERVE_BUCKETS, output=output, dtype=dtype)
        for output in ("features", "projection") for dtype in ("fp32", "bf16")}
    eng = engines[("features", "fp32")]
    print(f"serve (a): {eng.model_name} from {os.path.basename(ckpt)}, img_size "
          f"{eng.img_size}, buckets {list(eng.buckets)}, feature dims {eng.feat_dim} and "
          f"{engines[('projection', 'fp32')].feat_dim}")

    def embed(engine, images):  # dispatch with host syncs raising, result outside
        return guard(engine.dispatch, images).result()

    x = serve_images(300, seed=11)
    got = {key: embed(engine, x[:SERVE_ROWS]) for key, engine in engines.items()}
    for output in ("features", "projection"):
        host = EmbeddingEngine.from_checkpoint(ckpt, device="cpu", buckets=SERVE_BUCKETS,
                                               output=output).embed(x[:SERVE_ROWS])
        card = got[(output, "fp32")]
        rel = float(np.linalg.norm(card - host) / np.linalg.norm(host))
        print(f"serve (a): {SERVE_ROWS} rows' {output}, card vs the port on the CPU: relative "
              f"L2 {rel:.3e} (bound {PROBE_LOGITS_REL_L2[False]}), max |ref| "
              f"{np.abs(host).max():.3e}")
        if not rel <= PROBE_LOGITS_REL_L2[False]:
            failures.append(f"serve (a): card vs CPU {output} relative L2 {rel:.3e}")
        a, b = card, got[(output, "bf16")]
        worst = float(np.max(np.abs(b - a) - SERVE_BF16_ATOL * np.abs(a)))
        cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
        print(f"serve (a): bf16 vs fp32 {output}: max |diff| {np.abs(b - a).max():.3e}, "
              f"max(|diff| - {SERVE_BF16_ATOL} |fp32|) {worst:.3e} (bound {SERVE_BF16_ATOL}), "
              f"lowest cosine {cos.min():.6f} (bound > {SERVE_BF16_COS}), {b.dtype}")
        if not (b.dtype == np.float32 and worst <= SERVE_BF16_ATOL
                and cos.min() > SERVE_BF16_COS):
            failures.append(f"serve (a): bf16 vs fp32 {output} outside the pin")

    # padded = exact within one bucket, bitwise; across buckets, the pin
    peers = serve_images(128, seed=12)
    for n, bucket in ((5, 8), (20, 32), (100, 128)):
        padded = embed(eng, x[:n])
        exact = embed(eng, np.concatenate([x[:n], peers[:bucket - n]]))[:n]
        same = np.array_equal(padded, exact)
        print(f"serve (a): {n} rows padded to bucket {bucket} vs an exact bucket-{bucket} "
              f"batch: {'bitwise equal' if same else 'DIFFER'}")
        if not same:
            failures.append(f"serve (a): padded bucket {bucket} differs from the exact batch")
    rows = {b: embed(eng, x[:b]) for b in SERVE_BUCKETS}
    top = SERVE_BUCKETS[-1]
    for b in SERVE_BUCKETS[:-1]:
        ref = rows[top][:b]
        excess = scaled_excess(rows[b], ref, SERVE_CROSS_BUCKET_TOL)
        print(f"serve (a): rows 0-{b - 1} at bucket {b} vs bucket {top}: max |diff| "
              f"{np.abs(rows[b] - ref).max():.3e}, scaled {excess:.3e} (allclose rtol = atol = "
              f"{SERVE_CROSS_BUCKET_TOL}: <= 1), "
              f"{'bitwise equal' if np.array_equal(rows[b], ref) else 'not bitwise equal'}")
        if not excess <= 1.0:
            failures.append(f"serve (a): bucket {b} vs {top} outside the pin")
    before = eng.stats()["bucket_dispatches"][top]
    chunked = embed(eng, x)
    delta = eng.stats()["bucket_dispatches"][top] - before
    pieces = all(np.array_equal(chunked[lo:lo + top], embed(eng, x[lo:lo + top]))
                 for lo in range(0, len(x), top))
    print(f"serve (a): a {len(x)}-image request: {delta} bucket-{top} dispatches (want 3), the "
          f"chunks {'bitwise equal to' if pieces else 'DIFFER from'} the pieces embedded alone")
    if delta != 3 or not pieces or chunked.shape != (len(x), eng.feat_dim):
        failures.append(f"serve (a): the {len(x)}-image request was not chunked")
    cached = EmbeddingEngine.from_checkpoint(ckpt, device=SERVE_DEVICE, buckets=SERVE_BUCKETS,
                                             cache=EmbeddingCache(1024))
    first = embed(cached, x[:SERVE_ROWS])
    dispatched = sum(cached.stats()["bucket_dispatches"].values())
    second = embed(cached, x[:SERVE_ROWS])
    s = cached.stats()
    extra = sum(s["bucket_dispatches"].values()) - dispatched
    hit_ok = (extra == 0 and s["cache_hit_rows"] == SERVE_ROWS
              and np.array_equal(first, second) and np.array_equal(first, got[("features",
                                                                                "fp32")]))
    print(f"serve (a): a repeated {SERVE_ROWS}-image request: {s['cache_hit_rows']} cache-hit "
          f"rows, {extra} dispatches, {'bitwise equal' if hit_ok else 'NOT equal'}; cache "
          f"{s['cache']}")
    if not hit_ok:
        failures.append("serve (a): the cache-hit path dispatched or changed rows")
    traces = {key: e.stats()["traces"] for key, e in engines.items()}
    print(f"serve (a): {guard.calls} dispatches under sync debug mode 'error' (no host sync); "
          f"first forwards per bucket {traces[('features', 'fp32')]}")
    if any(set(t.values()) != {1} for t in traces.values()):
        failures.append(f"serve (a): a bucket counted more than one first forward: {traces}")

    # times by CUDA events: one embed (the host stages, H2D, forward, D2H, the
    # wait on its event) per bucket, and the forward alone on resident inputs
    times = {}
    for dtype in ("fp32", "bf16"):
        engine = engines[("features", dtype)]
        for b in SERVE_BUCKETS:
            xd = torch.from_numpy(x[:b]).to(engine.device)

            def forward(engine=engine, xd=xd):
                with torch.inference_mode():
                    engine.model.encode(eval_batch(xd, engine._aug_cfg))

            times[(dtype, b)] = (
                cuda_time_ms(lambda: engine.embed(x[:b]), reps=10, rounds=3, warmup=3),
                cuda_time_ms(forward, reps=10, rounds=3, warmup=3))
        line = ", ".join(f"bucket {b} {times[(dtype, b)][0]:.3f} ms (forward alone "
                         f"{times[(dtype, b)][1]:.3f})" for b in SERVE_BUCKETS)
        print(f"serve (a): {eng.model_name} features {dtype}, one embed by CUDA events: {line}; bucket "
              f"{top} {top / times[(dtype, top)][0] * 1e3:.1f} images/s {where}")
    return list(engines.values()) + [cached], times


def http_load(base, requests, clients):
    """POST each of ``requests`` (uint8 image arrays) to ``base``/embed from
    ``clients`` threads; returns ``(replies, seconds, wall)``: each reply's
    ``(status, body)`` in order, each request's seconds, the load's wall
    seconds."""
    import threading
    replies, seconds = [None] * len(requests), [0.0] * len(requests)
    cursor = iter(range(len(requests)))
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                k = next(cursor, None)
            if k is None:
                return
            t = time.perf_counter()
            status, body, _ = post_json(base, "/embed", b64_payload(requests[k]))
            seconds[k] = time.perf_counter() - t
            replies[k] = (status, body)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return replies, seconds, time.perf_counter() - t0


def serve_http_checks(ckpt, failures, where):
    """(b): ``serve.server.build_stack`` (projections, no cache,
    ``SERVE_BUCKETS``) at ``--max_inflight`` 1 and 2, under 16 client
    threads POSTing 256 requests of 1-64 images: every reply bitwise the
    stack's engine on the same images at one of the buckets the request
    could have been batched into, ``/stats`` and ``/metrics`` parsed, a
    wrong geometry answered 400. Returns the engines and the numbers."""
    import numpy as np
    from simclr_pytorch_distributed_tpu_torch.serve import server as serve_server
    from simclr_pytorch_distributed_tpu_torch.supervise.observe import parse_prometheus_text

    sizes = np.random.default_rng(13).integers(1, SERVE_HTTP_MAX_ROWS + 1, SERVE_HTTP_REQUESTS)
    requests = [serve_images(int(n), seed=1000 + k) for k, n in enumerate(sizes)]
    rows_total = int(sizes.sum())
    engines, numbers = [], {}
    for inflight in (1, 2):
        args = serve_server.build_parser().parse_args([
            "--ckpt", ckpt, "--device", SERVE_DEVICE, "--buckets", SERVE_BUCKETS_ARG, "--port", "0",
            "--output", "projection", "--cache_capacity", "0", "--max_wait_ms", "2",
            "--max_inflight", str(inflight)])
        engine, batcher, server = serve_server.build_stack(args)
        engines.append(engine)
        serve_server.start_in_thread(server)
        base = "http://%s:%d" % server.server_address[:2]
        try:
            replies, seconds, wall = http_load(base, requests, SERVE_HTTP_CLIENTS)
            stats = json.loads(get_text(base, "/stats")[1])
            metrics = parse_prometheus_text(get_text(base, "/metrics")[1])
            bad_status = post_json(base, "/embed", b64_payload(serve_images(2, 3, size=16)))[0]
        finally:
            server.shutdown()
            server.server_close()
            batcher.close()
        label = f"serve (b) --max_inflight {inflight}"
        codes = sorted({status for status, _ in replies})
        if codes != [200]:
            failures.append(f"{label}: reply codes {codes}")
            continue
        # each reply against the engine's rows at every bucket it could use
        refs = {}
        for b in SERVE_BUCKETS:
            ks = [k for k, n in enumerate(sizes) if n <= b]
            if ks:
                rows = at_bucket(engine, np.concatenate([requests[k] for k in ks]), b)
                offsets = np.cumsum([0] + [int(sizes[k]) for k in ks])
                for i, k in enumerate(ks):
                    refs[(k, b)] = rows[offsets[i]:offsets[i + 1]]
        matched = {b: 0 for b in SERVE_BUCKETS}
        for k, (_, body) in enumerate(replies):
            emb = np.asarray(body["embeddings"], np.float32)
            hit = next((b for b in SERVE_BUCKETS
                        if (k, b) in refs and np.array_equal(emb, refs[(k, b)])), None)
            matched[hit] = matched.get(hit, 0) + 1
        unmatched = matched.pop(None, 0)
        bs = stats["batcher"]
        ms = np.asarray(seconds) * 1e3
        numbers[inflight] = {"p50_ms": float(np.percentile(ms, 50)),
                             "p99_ms": float(np.percentile(ms, 99)),
                             "rows_per_s": rows_total / wall}
        print(f"{label}: {SERVE_HTTP_REQUESTS} requests ({rows_total} rows) from "
              f"{SERVE_HTTP_CLIENTS} clients in {wall:.3f} s: {rows_total / wall:.1f} rows/s, "
              f"request latency p50 {numbers[inflight]['p50_ms']:.2f} ms p99 "
              f"{numbers[inflight]['p99_ms']:.2f} ms (client clock); {bs['batches']} batches "
              f"of {bs.get('avg_batch_images', 0):.1f} rows on average, at most "
              f"{bs['max_inflight_observed']} in flight, pipeline occupancy "
              f"{bs['pipeline_occupancy']:.3f} {where}")
        print(f"{label}: replies bitwise equal to the engine, by the first bucket that "
              f"matches {matched}, unmatched "
              f"{unmatched}; /stats errors {bs['errors']}, latency buckets "
              f"{sorted(stats.get('latency', {}))}; /metrics serve_batcher_batches "
              f"{metrics.get('serve_batcher_batches')} serve_engine_images_total "
              f"{metrics.get('serve_engine_images_total')}; a 16x16 request got {bad_status}")
        if (unmatched or bs["errors"] or bad_status != 400 or not stats.get("latency")
                or metrics.get("serve_batcher_batches") != bs["batches"]
                or metrics.get("serve_engine_images_total") != rows_total
                or bs["max_inflight_observed"] > inflight):
            failures.append(f"{label}: the replies, /stats, /metrics or the 400 check failed")
    return engines, numbers


def serve_fleet_checks(rn50_ckpt, rn18_ckpt, failures, where):
    """(c): the fleet frontend (``build_fleet_stack``: projections, brute
    retrieval at ``--index_capacity 4096``, ``--tenant_quota_rows 64``) on
    rn50: ``/neighbors`` over a corpus served through ``/embed`` against a
    numpy oracle, and IVF's recall@10 against it; a tenant over its quota
    refused with 503 and ``Retry-After``; a promote to the rn18
    ``last.pth`` under load with zero failed requests, the requests after it
    served by the rn18 engine. Returns the serving engine."""
    import threading

    import numpy as np
    from simclr_pytorch_distributed_tpu_torch.serve.fleet import IVFIndex, frontend
    from simclr_pytorch_distributed_tpu_torch.serve.server import start_in_thread

    args = frontend.build_parser().parse_args([
        "--ckpt", rn50_ckpt, "--name", "prod", "--device", SERVE_DEVICE, "--buckets",
        SERVE_BUCKETS_ARG, "--output", "projection", "--index_capacity",
        str(SERVE_INDEX_CAPACITY), "--retrieval_impl", "brute", "--tenant_quota_rows",
        str(SERVE_QUOTA_ROWS), "--port", "0", "--max_wait_ms", "2"])
    registry, server = frontend.build_fleet_stack(args)
    start_in_thread(server)
    base = "http://%s:%d" % server.server_address[:2]
    try:
        # /neighbors over a corpus served through /embed into the empty index
        corpus_imgs = serve_images(SERVE_CORPUS, seed=24)
        corpus = np.concatenate([
            np.asarray(post_json(base, "/embed", b64_payload(corpus_imgs[lo:lo + 64]))[1]
                       ["embeddings"], np.float32) for lo in range(0, SERVE_CORPUS, 64)])
        keys = [registry.content_id(img) for img in corpus_imgs]
        queries = serve_images(SERVE_QUERIES, seed=25)
        status, body, _ = post_json(base, "/neighbors", b64_payload(queries, k=SERVE_K))
        q = registry._serving("prod").embed(queries)  # the bucket /neighbors used
        index_stats = registry.stats()["models"]["prod"]["index"]
        unit = lambda m: m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-12)  # noqa
        scores = unit(q) @ unit(corpus).T
        oracle = np.argsort(-scores, axis=1, kind="stable")[:, :SERVE_K]
        ids_ok = status == 200 and all(
            [h["id"] for h in hits] == [keys[j] for j in oracle[i]]
            for i, hits in enumerate(body["neighbors"]))
        score_err = max(abs(h["score"] - scores[i, oracle[i, r]])
                        for i, hits in enumerate(body["neighbors"]) for r, h in enumerate(hits))
        print(f"serve (c): /neighbors k={SERVE_K} for {SERVE_QUERIES} queries over "
              f"{index_stats['entries']} served rows (capacity {index_stats['capacity']}): ids "
              f"{'equal to' if ids_ok else 'DIFFER from'} the numpy oracle, max |score diff| "
              f"{score_err:.3e} (bound {SERVE_SCORE_ATOL})")
        if not ids_ok or not score_err <= SERVE_SCORE_ATOL:
            failures.append("serve (c): /neighbors does not match the numpy oracle")
        ivf = IVFIndex(q.shape[1], capacity=SERVE_INDEX_CAPACITY)
        for lo in range(0, SERVE_CORPUS, 64):
            ivf.add(keys[lo:lo + 64], corpus[lo:lo + 64])
        t0 = time.perf_counter()
        approx = ivf.query(q, SERVE_K)
        ivf_ms = (time.perf_counter() - t0) * 1e3
        recall = float(np.mean([len({key for key, _ in approx[i]}
                                    & {keys[j] for j in oracle[i]}) / SERVE_K
                                for i in range(SERVE_QUERIES)]))
        s = ivf.stats()
        print(f"serve (c): IVF ({s['nlist']} lists, nprobe {s['nprobe']}, {s['retrains']} "
              f"trains) recall@{SERVE_K} against brute {recall:.4f} over {SERVE_QUERIES} "
              f"queries, {ivf_ms:.2f} ms of host time for them")
        if not (0.0 < recall <= 1.0 and s["retrains"] >= 1):
            failures.append(f"serve (c): IVF recall@{SERVE_K} {recall}")

        over, body, headers = post_json(base, "/embed", b64_payload(
            serve_images(SERVE_QUOTA_ROWS + 1, seed=22), tenant="greedy"))
        within = post_json(base, "/embed", b64_payload(
            serve_images(SERVE_QUOTA_ROWS, seed=23), tenant="modest"))[0]
        print(f"serve (c): a tenant over its {SERVE_QUOTA_ROWS}-row quota got {over}, "
              f"Retry-After {headers.get('Retry-After')!r} ({body.get('error')}); a tenant at "
              f"its quota got {within}")
        if over != 503 or headers.get("Retry-After") != "1" or within != 200:
            failures.append("serve (c): the tenant quota did not answer 503 with Retry-After")

        stop = threading.Event()
        codes = []
        lock = threading.Lock()

        def load(client):
            k = 0
            while not stop.is_set():
                status = post_json(base, "/embed", b64_payload(
                    serve_images(8, seed=100000 * (client + 1) + k), tenant=f"c{client}"))[0]
                k += 1
                with lock:
                    codes.append(status)

        def until_served(n):
            deadline = time.time() + 60
            while len(codes) < n and time.time() < deadline:
                time.sleep(0.01)

        threads = [threading.Thread(target=load, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        until_served(20)
        t0 = time.perf_counter()
        status, reply, _ = post_json(base, "/models/promote",
                                     {"model": "prod", "ckpt": rn18_ckpt})
        promote_s = time.perf_counter() - t0
        until_served(len(codes) + 20)
        stop.set()
        for t in threads:
            t.join()
        drained = registry.wait_drained("prod", 1, timeout=60)
        states = [v["state"] for v in json.loads(get_text(base, "/models")[1])
                  ["models"]["prod"]["versions"]]
        print(f"serve (c): promote prod rn50 -> rn18 under 4 loading clients: {status} "
              f"{reply} in {promote_s:.3f} s; {len(codes)} requests, codes "
              f"{sorted(set(codes))}; v1 drained {drained}; versions {states} {where}")
        if (status != 200 or set(codes) != {200} or not drained
                or states != ["retired", "serving"]):
            failures.append("serve (c): the promote under load failed requests or did not drain")
        engine = registry._serving("prod")
        probe = serve_images(8, seed=21)
        body = post_json(base, "/embed", b64_payload(probe))[1]
        routed = np.array_equal(np.asarray(body["embeddings"], np.float32), engine.embed(probe))
        print(f"serve (c): after the promote a request is served by {engine.model_name}: "
              f"{'bitwise its engine' if routed else 'NOT its engine'}")
        if not routed or engine.model_name != "resnet18":
            failures.append("serve (c): requests after the promote did not reach the rn18 engine")
    finally:
        server.shutdown()
        server.server_close()
        registry.close()
    return engine


def answers_healthz(port, timeout=0.5):
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=timeout) as r:
            return r.status == 200
    except OSError:
        return False


def serve_replica_checks(rn18_ckpt, workdir, failures, where):
    """(d): ``ReplicaFleetSupervisor`` over 2 replicas of the port's fleet
    frontend on the card (two processes, two CUDA contexts) with each
    replica's spawn-to-healthy time; ``kill -9`` of replica 0 restarted on
    its port, the decisions in the supervisor's events. Stops every replica.
    Returns the spawn-to-healthy seconds and the kill-to-healthy seconds."""
    from simclr_pytorch_distributed_tpu_torch.supervise.replica import ReplicaPolicy
    from simclr_pytorch_distributed_tpu_torch.supervise.replica_fleet import (
        ReplicaFleetConfig,
        ReplicaFleetSupervisor,
        fleet_command,
    )
    from simclr_pytorch_distributed_tpu_torch.utils import tracing

    events = os.path.join(workdir, "replica_fleet_events.jsonl")
    recorder = tracing.FlightRecorder(events)
    tracing.install(recorder)
    config = ReplicaFleetConfig(
        command=fleet_command("--ckpt", rn18_ckpt, "--device", SERVE_DEVICE, "--buckets",
                              SERVE_BUCKETS_ARG, "--output", "projection"),
        min_replicas=SERVE_REPLICAS, max_replicas=SERVE_REPLICAS, poll_interval_s=0.5,
        grace_s=10.0)
    path = [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    sup = ReplicaFleetSupervisor(
        config, ReplicaPolicy(SERVE_REPLICAS, SERVE_REPLICAS, startup_grace_s=120.0),
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(path)))

    def until_healthy(since):
        """Step the supervisor until each replica of ``since`` (id -> start
        time) answers ``/healthz``; each one's seconds from its start."""
        took = {}
        deadline = time.time() + SERVE_REPLICA_TIMEOUT_S
        while len(took) < len(since):
            if time.time() > deadline:
                raise AssertionError(f"serve (d): replicas {sorted(since)} not healthy in "
                                     f"{SERVE_REPLICA_TIMEOUT_S} s: {sup.replicas()}")
            sup.step()
            for rid, info in sup.replicas().items():
                if rid in since and rid not in took and answers_healthz(info["port"]):
                    took[rid] = time.time() - since[rid]
            time.sleep(0.2)
        return took

    try:
        t0 = time.time()
        for _ in range(SERVE_REPLICAS):  # the policy spawns one a tick up to the floor
            sup.step()
        reps = sup.replicas()
        first = until_healthy({rid: t0 for rid in reps})
        codes = [post_json(f"http://127.0.0.1:{info['port']}", "/embed",
                           b64_payload(serve_images(4, seed=31))) for info in reps.values()]
        codes = [(status, body.get("dim")) for status, body, _ in codes]
        print(f"serve (d): {len(reps)} replicas of the fleet frontend on the card, ports "
              f"{[r['port'] for r in reps.values()]}: spawn to first answered /healthz "
              f"{ {rid: round(s, 2) for rid, s in first.items()} } s; /embed replies {codes} "
              f"{where}")
        victim = min(reps)
        port = reps[victim]["port"]
        os.kill(reps[victim]["pid"], signal.SIGKILL)
        t_kill = time.time()
        decision = None
        while decision is None:
            if time.time() - t_kill > 60:
                raise AssertionError("serve (d): no decision on the killed replica in 60 s")
            decision = next((d for d in sup.step() if d["replica"] == victim), None)
            time.sleep(0.1)
        back = until_healthy({victim: t_kill})[victim]
        print(f"serve (d): kill -9 of replica {victim} (port {port}) -> {decision['action']} "
              f"on port {decision.get('port')} (old return code "
              f"{decision.get('old_returncode')}), answering /healthz {back:.2f} s after the "
              f"kill; replicas {sup.replicas()}")
        if (any(c != (200, 128) for c in codes) or decision["action"] != "restart_replica"
                or decision.get("port") != port or sup.replicas()[victim]["restarts"] != 1):
            failures.append("serve (d): the killed replica was not restarted on its port")
    finally:
        sup.stop_all()
        tracing.uninstall()
        recorder.close()
    names = [e.get("name") for e in tracing.load_events_jsonl(events)]
    seen = {n: names.count(n) for n in ("replica_spawn", "replica_restart")}
    print(f"serve (d): supervisor events {seen}; every replica stopped")
    if seen != {"replica_spawn": SERVE_REPLICAS, "replica_restart": 1}:
        failures.append(f"serve (d): the supervisor's events hold {seen}")
    return first, back


def serve_phase(workdir, rn50_ckpt, rn18_ckpt, where):
    """The serving stack on the card: (a) the engine, (b) the HTTP stack,
    (c) the fleet frontend, (d) the replica fleet; every fused launch
    counter 0 through (a)-(c) and every served state dict bitwise its
    checkpoint's. Raises on any failure; returns the numbers."""
    from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import load_model_state
    counters = kernel_counters()
    for mod, name in counters:
        setattr(mod, name, 0)
    failures = []
    engines, times = serve_engine_checks(rn50_ckpt, failures, where)
    http_engines, http = serve_http_checks(rn50_ckpt, failures, where)
    engines += http_engines + [serve_fleet_checks(rn50_ckpt, rn18_ckpt, failures, where)]
    launches = {name: getattr(mod, name) for mod, name in counters}
    print(f"serve: fused kernel launches through (a)-(c): "
          f"{'every counter 0' if not any(launches.values()) else launches}")
    if any(launches.values()):
        failures.append(f"serve: fused kernels launched: {launches}")
    changed = 0
    for engine in engines:
        want = load_model_state(rn50_ckpt if engine.model_name == "resnet50" else rn18_ckpt)
        got = engine.model.state_dict()
        changed += sum(not torch.equal(got[k].cpu(), v) for k, v in want.items())
    print(f"serve: state-dict tensors changed by serving, over {len(engines)} engines: "
          f"{changed}")
    if changed:
        failures.append(f"serve: serving changed {changed} state-dict tensors")
    spawn_s, restart_s = serve_replica_checks(rn18_ckpt, workdir, failures, where)
    if failures:
        raise AssertionError("serve:\n" + "\n".join(failures))
    return {"times": times, "http": http, "spawn_s": spawn_s, "restart_s": restart_s}


EVIDENCE_GATES = ("supervisor_gate", "chaos_matrix", "serve_fleet", "fleet_report")


def evidence_phase():
    """The four artifact gates of ``scripts/port_ratchet.py`` over the
    committed port artifacts, which ``scripts/port_supervisor_matrix.py`` and
    ``scripts/port_serve_fleet_scenario.py`` wrote on the card: each record
    ok, each artifact naming an NVIDIA card."""
    ratchet = load_script("port_ratchet")
    failures = []
    for name in EVIDENCE_GATES:
        record = ratchet.run_artifact_gate(name)
        print(f"evidence {name}: {json.dumps(record)}")
        if not record["ok"]:
            failures.append(f"{name}: {record.get('error')}")
        if "NVIDIA" not in str(record.get("card")):
            failures.append(f"{name}: the artifact names no NVIDIA card ({record.get('card')})")
    if failures:
        raise AssertionError("evidence:\n" + "\n".join(failures))


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
    images, labels, gen, views = recipe_batch(dev, batch_size)
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

    # -- probe: the linear probe's entry point from each rn50 run -----------
    t0 = phase("probe")
    probe_refs = [probe_run(dev, workdir, os.path.join(run.save_folder, "last.pth"), bf16,
                            f"on {card}")
                  for bf16, run in ((False, result), (True, bf16_runs["resnet50"][0]))]
    done("probe", t0)

    # -- resume: straight = resumed = preempted and resumed, exit 75 and 1 --
    t0 = phase("resume")
    resume_ref = resume_phase(workdir)
    done("resume", t0)

    # -- distributed: world size 1 over NCCL, two ranks over gloo ----------
    t0 = phase("distributed")
    distributed_phase(workdir, result, rn50_expected, model, views, labels, f"on {card}")
    done("distributed", t0)

    # -- large_batch: LARS + ring, the probe over processes, elastic, rollback
    t0 = phase("large_batch")
    large_batch_phase(workdir, result, rn50_expected, rn18_expected, f"on {card}")
    done("large_batch", t0)

    # -- observability: ring, flush, health, probe, recorder, profiler ------
    t0 = phase("observability")
    observability_phase(workdir, rn50_expected, rn50_bf16_expected, f"on {card}")
    done("observability", t0)

    # -- ce: the supervised cross-entropy trainer --------------------------
    t0 = phase("ce")
    ce_ref = ce_phase(workdir, f"on {card}")
    done("ce", t0)

    # -- placement: the device-resident and windowed data stores -----------
    t0 = phase("placement")
    placement_phase(workdir, result, rn50_expected, resume_ref, probe_refs[0], ce_ref,
                    f"on {card}")
    rn18_last = os.path.join(resume_ref.save_folder, "last.pth")
    del resume_ref, probe_refs, ce_ref
    done("placement", t0)

    # -- recipes: the SSL recipes on the fused encoder, the native gather --
    t0 = phase("recipes")
    recipes_phase(workdir, result, rn50_expected, rn50_bf16_expected, model, views, labels,
                  f"on {card}")
    done("recipes", t0)

    # -- supervise: the supervisor on the trainer, through kills and relaunches
    t0 = phase("supervise")
    supervise_phase(workdir, rn18_bf16_expected, f"on {card}")
    done("supervise", t0)

    # -- tensor_parallel: --model_parallel over two and four processes ----
    t0 = phase("tensor_parallel")
    tensor_parallel_phase(workdir, f"on {card}")
    done("tensor_parallel", t0)

    # -- serve: the engine, the HTTP stack, the fleet, the replica fleet ---
    t0 = phase("serve")
    serve_phase(workdir, os.path.join(result.save_folder, "last.pth"), rn18_last, f"on {card}")
    done("serve", t0)

    # -- evidence: the port's committed scenario artifacts, judged ------------
    t0 = phase("evidence")
    evidence_phase()
    done("evidence", t0)

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
