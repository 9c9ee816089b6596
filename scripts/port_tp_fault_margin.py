"""Planted tensor-parallel faults against the card's tensor-parallel gate.

    python3 scripts/port_tp_fault_margin.py [--faults no_share_sum no_grad_mean]

``chip_smoke.py``'s ``tensor_parallel`` phase holds each rank's shards
after one step against their slice of the one-process step on the card:
the loss at the JAX package's rtol 2e-5, each parameter's update and
momentum in relative L2 at ``STEP_UPDATE_REL_L2``. This script runs the
same steps with one fault planted in the processes (the code on disk is
not changed) and prints, for each fault, the worst loss and update errors
beside their bounds, so the gate's margin over a wrong step is on record.
Faults:

- ``no_share_sum``: step (a), ResNet-50 at ``--model_parallel 2`` on 2
  processes. ``GatherChannels``' backward keeps this rank's channels of its
  own gradient everywhere, so a sharded layer's input gradient loses the
  peer's share. The forward, and so the loss, is unchanged.
- ``no_grad_mean``: step (b), ResNet-18 at data 2 x model 2 on 4
  processes, ``--syncBN``. The gradient mean over the data group is
  skipped: each data slice steps on its own share of the gradient. The
  forward is unchanged.

Builds the fused loss kernels once beforehand. Prints the card's name and
power limit, one JSON line per fault, and exits 1 when a planted fault
passes the gate (or 2 without a card).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# fault -> (model, world)
FAULTS = {"no_share_sum": ("resnet50", 2), "no_grad_mean": ("resnet18", 4)}


def plant(fault: str) -> None:
    """Install ``fault`` in this process."""
    from simclr_pytorch_distributed_tpu_torch.parallel import collectives
    if fault == "no_share_sum":
        backward = collectives.GatherChannels.backward

        def own_share_only(ctx, grad):
            ctx.partial = False
            return backward(ctx, grad)

        collectives.GatherChannels.backward = staticmethod(own_share_only)
    elif fault == "no_grad_mean":
        collectives.mean_gradients = lambda *args, **kwargs: None
    else:
        raise ValueError(f"unknown fault {fault!r}")


def child(rank: int, world: int, outdir: str, fault: str) -> None:
    """One process: chip_smoke's tensor-parallel step with ``fault``."""
    import chip_smoke
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(torch.device("cuda", 0))
    mesh.setup_distributed("cuda", init_method=f"file://{os.path.join(outdir, 'store')}",
                           rank=rank, world_size=world, backend="gloo",
                           timeout=datetime.timedelta(seconds=600))
    plant(fault)
    summary = chip_smoke.tp_step_run(FAULTS[fault][0], world, rank, outdir, sync_bn=True)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump(summary, fh)
    mesh.teardown_distributed()


def run(fault: str, workdir: str) -> dict:
    """The fault's step on every rank, held against the one-process step."""
    import chip_smoke
    model, world = FAULTS[fault]
    outdir = tempfile.mkdtemp(prefix=f"{fault}_", dir=workdir)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", str(r),
                               str(world), outdir, fault],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        for r, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"{fault}: rank {r} exited {proc.returncode}:\n{out[-4000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks = []
    for r in range(world):
        with open(os.path.join(outdir, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    failures = []
    worst = chip_smoke.tp_compare(f"fault {fault}", outdir, model, ranks,
                                  chip_smoke.tp_reference(model, torch.device("cuda", 0)),
                                  failures)
    return {"fault": fault, "model": model, "world": world,
            "loss_rel": worst["loss"][0], "loss_bound": chip_smoke.TP_STEP_LOSS_RTOL,
            "update_rel_l2": worst["update"][0], "momentum_rel_l2": worst["momentum"][0],
            "update_bound": chip_smoke.STEP_UPDATE_REL_L2, "where": worst["update"][1],
            "gate_fails": bool(failures)}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        return 0
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--faults", nargs="+", default=list(FAULTS), choices=list(FAULTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_tp_fault_margin: no CUDA device", file=sys.stderr)
        return 2
    from simclr_pytorch_distributed_tpu_torch.ops import native
    native.build("fused_supcon_loss")  # once, before the processes load it
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True,
                         timeout=60)
    print(f"card: {out.stdout.strip()}")
    passed = []
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="tp_fault_", dir=os.path.join(REPO, "build")) \
            as workdir:
        for fault in args.faults:
            result = run(fault, workdir)
            print(json.dumps(result))
            if not result["gate_fails"]:
                passed.append(fault)
    if passed:
        print(f"port_tp_fault_margin: planted faults passed the gate: {passed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
