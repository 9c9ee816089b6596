"""Tensor-parallel steps of the PyTorch port over NCCL, one process a card.

    python3 scripts/port_tp_nccl.py [--world 4] [--model resnet50] [--batch 256]
                                    [--steps 5] [--json OUT]

Starts ``--world`` processes on the cards of one host (NCCL, ``env://`` on
127.0.0.1), builds the fused loss kernels once beforehand, and for each
``--model_parallel N`` that divides the world (1, 2, 4): the model from
seed 0 at the recipe's width (CIFAR stem, 32 px, fp32 with TF32 off, eager
convs, ``--syncBN`` over the data group, the fused loss: its single-device
form at one data slice, the sharded form over the data group above), this
process's shards (``parallel/mesh.shard_module``), one step on its data
slice of the synthetic set's first ``--batch`` images in two crops, then
``--steps`` steps timed by CUDA events, then one step with every collective
synchronized and counted by group. Every N starts from the same init and
batch, so each rank's shards after the first step are held against their
slice of the ``N = 1`` (data-parallel) step: the loss and each parameter's
update in relative L2. It also holds ``collectives.reduce_scatter_channels``
(NCCL's ``reduce_scatter``) against an all-reduce and a slice of the same
tensor: the two sum the ranks' values in other orders, so to 1e-6 of the
tensor's largest value, not bitwise.

Rank 0 prints the cards (``nvidia-smi`` name and power limit) and one JSON
line per N: loss, the worst update relative L2 against ``N = 1``, the
median step in ms, the state bytes a rank and the collectives by group
(calls, MiB, ms). Exits 2 without ``--world`` cards.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

UPDATE_REL_L2 = 5e-2  # chip_smoke.py's STEP_UPDATE_REL_L2
LOSS_RTOL = 2e-5  # the JAX package's TP loss pin


def card_lines() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(out.stdout.strip().splitlines())


def batch(dev, size):
    """The synthetic set's first ``size`` images in two crops (generator
    seeded 3), and their labels, on ``dev``."""
    from simclr_pytorch_distributed_tpu_torch.data.cifar import synthetic_dataset
    from simclr_pytorch_distributed_tpu_torch.ops.augment import AugmentConfig, two_crop_batch
    data, _ = synthetic_dataset()
    images = torch.from_numpy(data["images"][:size]).to(dev)
    labels = torch.from_numpy(data["labels"][:size]).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    views = two_crop_batch(gen, images, AugmentConfig(mean=(0.5,) * 3, std=(0.25,) * 3))
    return views, labels


REDUCE_SCATTER_REL = 1e-6


def reduce_scatter_check(dev) -> float:
    """``reduce_scatter_channels`` over the world against an all-reduce and
    this rank's slice of a channels-last ``[B, C, H, W]`` tensor: the
    largest difference over the largest value, the worst rank's."""
    import torch.distributed as dist
    from simclr_pytorch_distributed_tpu_torch.parallel import collectives
    gen = torch.Generator(device=dev)
    gen.manual_seed(7 + dist.get_rank())
    x = torch.randn(8, 64, 4, 4, device=dev, generator=gen).to(
        memory_format=torch.channels_last)
    got = collectives.reduce_scatter_channels(x, None)
    whole = x.clone()
    dist.all_reduce(whole)
    want = whole.chunk(dist.get_world_size(), dim=1)[dist.get_rank()]
    err = ((got - want).abs().max() / want.abs().max()).reshape(1)
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return err.item()


def run_grid(n, args, dev, views, labels, reference):
    """One ``--model_parallel n`` pass of this rank (module docstring)."""
    import torch.distributed as dist
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
    from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
        SupConStepConfig,
        train_step,
    )
    from simclr_pytorch_distributed_tpu_torch.utils import profiling
    mesh.setup_grid(n)
    d, n_data = mesh.data_index(), mesh.data_parallel()
    b = args.batch // n_data
    mine = (views[d * b:(d + 1) * b], labels[d * b:(d + 1) * b])
    torch.manual_seed(0)
    model = SupConResNet(args.model).to(dev, memory_format=torch.channels_last)
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    model.encoder.set_conv_impl("eager").set_bn_sync(
        (mesh.data_group() or dist.group.WORLD) if n_data > 1 else None)
    mesh.shard_module(model, n, mesh.model_index())
    state = TrainState(model=model, optimizer=make_optimizer(model), schedule=lambda s: 0.5)
    cfg = SupConStepConfig(temperature=0.5, loss_impl="fused", epochs=1, steps_per_epoch=7)
    loss = train_step(state, cfg, *mine)["loss"].item()
    after = {k: v.detach().clone() for k, v in model.named_parameters()}
    if reference is None:
        reference = {"loss": loss, "after": after}
    worst = 0.0
    for key, got in after.items():
        start = mesh.shard_of(init[key], n, mesh.model_index())
        want = mesh.shard_of(reference["after"][key], n, mesh.model_index())
        upd = (want - start).double()
        worst = max(worst, (((got - start).double() - upd).norm() / upd.norm()).item())
    state_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values()) + sum(
        t.numel() * t.element_size() for st in state.optimizer.state.values()
        for t in st.values() if torch.is_tensor(t))
    times = []
    for _ in range(args.steps):
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        train_step(state, cfg, *mine)
        end_ev.record()
        end_ev.synchronize()
        times.append(start_ev.elapsed_time(end_ev))
    spent = profiling.count_collectives(lambda: train_step(state, cfg, *mine)["loss"].item())
    worst_all = torch.tensor([worst], device=dev)
    dist.all_reduce(worst_all, op=dist.ReduceOp.MAX)
    record = {
        "model_parallel": n, "data_parallel": n_data, "model": args.model,
        "batch": args.batch, "loss": loss, "loss_rel_vs_n1": abs(loss - reference["loss"])
        / abs(reference["loss"]), "update_rel_l2_vs_n1": worst_all.item(),
        "step_ms_median": statistics.median(times), "step_ms": times,
        "state_mib": state_bytes / 2**20,
        "collectives": {k: [c, nb / 2**20, s * 1e3] for k, (c, nb, s) in sorted(spent.items())},
    }
    del state, model
    torch.cuda.empty_cache()
    return reference, record


def worker(args) -> int:
    import torch.distributed as dist
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh.setup_distributed("cuda", timeout=datetime.timedelta(seconds=600))
    dev = torch.device("cuda", torch.cuda.current_device())
    views, labels = batch(dev, args.batch)
    records = [{"reduce_scatter_channels_rel_err": reduce_scatter_check(dev),
                "bound": REDUCE_SCATTER_REL}]
    reference = None
    for n in (1, 2, 4):
        if args.world % n == 0:
            reference, record = run_grid(n, args, dev, views, labels, reference)
            records.append(record)
    lines = [json.dumps(r) for r in records]
    out = f"{args.json}.rank{dist.get_rank()}" if args.json else ""
    if out:
        with open(out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    ok = records[0]["reduce_scatter_channels_rel_err"] <= REDUCE_SCATTER_REL and all(
        r["loss_rel_vs_n1"] <= LOSS_RTOL and r["update_rel_l2_vs_n1"] <= UPDATE_REL_L2
        for r in records[1:])
    mesh.teardown_distributed()
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--json", default=os.path.join(REPO, "work_space", "port_tp_nccl.jsonl"),
                    help="where each rank writes its JSON lines (OUT.rank<r>)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.world:
        print(f"port_tp_nccl: needs {args.world} CUDA devices", file=sys.stderr)
        return 2
    from simclr_pytorch_distributed_tpu_torch.ops import native
    native.build("fused_supcon_loss")
    print(f"nvidia-smi name, power.limit: {card_lines()}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(args.world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(args.world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", "--world", str(args.world),
             "--model", args.model, "--batch", str(args.batch), "--steps", str(args.steps),
             "--json", args.json], env=env))
    codes = []
    try:
        for proc in procs:
            codes.append(proc.wait(timeout=1800))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(f"{args.json}.rank0") as fh:
        for line in fh:
            print(line.strip(), flush=True)
    print(json.dumps({"exit_codes": codes}), flush=True)
    return 0 if not any(codes) else 1


if __name__ == "__main__":
    sys.exit(main())
