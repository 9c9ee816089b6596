#!/usr/bin/env python
"""The replica-fleet scenario of the PyTorch/CUDA port: the port of the JAX
package's ``scripts/serve_fleet_scenario.py``, on the card.

    python3 scripts/port_serve_fleet_scenario.py \\
        --json docs/evidence/port_serve_fleet_r21.json [--device cuda|cpu]

It drives the port's real serving stack, ``python -m
simclr_pytorch_distributed_tpu_torch.serve.fleet --device cuda`` replica
processes under the port's ``supervise.replica_fleet.ReplicaFleetSupervisor``,
scraped over live HTTP, through four legs:

1. **spawn**: the supervisor raises the fleet to ``min_replicas=2`` and
   scrapes both replicas' ``/metrics``; both serve ``/embed``;
2. **restart**: replica 0 is SIGKILLed; the next supervision step decides
   ``restart_replica`` on the same port within the restart budget, and the
   replica serves again;
3. **promote**: ``/models/promote`` lands on replica 1 while three client
   threads post ``/embed`` to it; the old version drains to ``retired``,
   version 2 serves, and no request fails;
4. **neighbors**: embedded images answer ``/neighbors`` with the query
   image itself as the top-1 at cosine ~1.0.

The checkpoints are ResNet-18 at 32 px from two seeds, made by the port in
this process (random weights; the scenario is about the fleet, not the
features). The artifact has the JAX scenario's schema (``serve_fleet/v1``),
each leg's seconds, and the card's name and power limit (``nvidia-smi``)
and card count. Exits 1 if a leg is not ok, 2 without a card (unless
``--device cpu``).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from simclr_pytorch_distributed_tpu_torch.serve.fleet.registry import ModelRegistry  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.supervise.replica import ReplicaPolicy  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.supervise.replica_fleet import (  # noqa: E402
    FLEET_MODULE,
    ReplicaFleetConfig,
    ReplicaFleetSupervisor,
    fleet_command,
)

SCHEMA = "serve_fleet/v1"
MIN_REPLICAS, MAX_REPLICAS, MAX_RESTARTS = 2, 3, 2
LOAD_THREADS = 3


def build_checkpoint(path: str, model_name: str, size: int, seed: int) -> str:
    """A ``.pth`` the fleet serves: the port's seeded init of ``model_name``
    in the reference layout, its ``opt`` naming the dataset and size."""
    import torch

    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet

    torch.manual_seed(seed)
    model = SupConResNet(model_name)
    torch.save({"opt": {"model": model_name, "dataset": "cifar10", "size": size},
                "model": {f"module.{k}": v for k, v in model.state_dict().items()},
                "epoch": 1}, path)
    return path


def post(port, path, obj, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def get(port, path, timeout=10):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.status, json.loads(r.read())


def embed_req(port, images, tenant="", timeout=120):
    body = {"images_b64": base64.b64encode(np.ascontiguousarray(images).tobytes()).decode(),
            "shape": list(images.shape)}
    if tenant:
        body["tenant"] = tenant
    return post(port, "/embed", body, timeout=timeout)


def wait_until(predicate, timeout_s, what, poll_s=0.25):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(poll_s)
    raise RuntimeError(f"timed out waiting for {what}")


def serving_ok(port):
    try:
        return get(port, "/healthz", timeout=2)[0] == 200
    except (urllib.error.URLError, OSError):
        return False


def load_window(port, rng, size, stop, counters, lock):
    """One client thread: ``/embed`` until told to stop, each reply counted."""
    while not stop.is_set():
        images = rng.integers(0, 256, size=(2, size, size, 3), dtype=np.uint8)
        try:
            status, _ = embed_req(port, images, tenant="load")
            key = "ok" if status == 200 else "other"
        except urllib.error.HTTPError as e:
            key = f"http_{e.code}"
        except (urllib.error.URLError, OSError):
            key = "transport"
        with lock:
            counters[key] = counters.get(key, 0) + 1


def run_scenario(workdir: str, device: str, model_name: str, size: int) -> dict:
    ck1 = build_checkpoint(os.path.join(workdir, "ckpt_v1.pth"), model_name, size, seed=0)
    ck2 = build_checkpoint(os.path.join(workdir, "ckpt_v2.pth"), model_name, size, seed=1)
    path = [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    config = ReplicaFleetConfig(
        command=fleet_command("--ckpt", ck1, "--device", device, "--name", "prod",
                              "--host", "127.0.0.1", "--buckets", "2,8",
                              "--max_wait_ms", "2"),
        min_replicas=MIN_REPLICAS, max_replicas=MAX_REPLICAS, poll_interval_s=0.5,
        grace_s=10.0)
    policy = ReplicaPolicy(MIN_REPLICAS, MAX_REPLICAS, startup_grace_s=180.0,
                           max_restarts=MAX_RESTARTS)
    sup = ReplicaFleetSupervisor(config, policy,
                                 env=dict(os.environ, PYTHONPATH=os.pathsep.join(path)))
    rng = np.random.default_rng(0)
    out = {"phases": {}}

    def images(n):
        return rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)

    try:
        # 1. the supervisor raises the fleet to its floor, and scrapes it
        t0 = time.monotonic()
        sup.step()
        sup.step()
        replicas = sup.replicas()
        assert len(replicas) == MIN_REPLICAS, replicas
        ports = {rid: r["port"] for rid, r in replicas.items()}
        wait_until(lambda: all(serving_ok(p) for p in ports.values()), 300,
                   "both replicas serving /healthz")
        healthy_s = time.monotonic() - t0
        wait_until(lambda: all(o.metrics is not None for o in sup.observe()), 60,
                   "both replicas scrapeable")
        warm = {}
        for rid, port in ports.items():
            status, r = embed_req(port, images(2))
            warm[str(rid)] = {"status": status, "dim": r["dim"], "model": r["model"]}
            assert status == 200 and r["model"] == "prod", r
        out["phases"]["spawn"] = {
            "replicas": {str(k): v for k, v in sup.replicas().items()},
            "decisions": sup.decisions(), "warm_embed": warm,
            "spawn_to_healthy_s": round(healthy_s, 3), "ok": True,
        }

        # 2. SIGKILL replica 0: the next step restarts it on its port
        victim = min(ports)
        victim_pid = sup.replicas()[victim]["pid"]
        os.kill(victim_pid, signal.SIGKILL)
        t_kill = time.monotonic()
        wait_until(lambda: sup.replicas()[victim]["alive"] is False, 30,
                   "the kill to register")
        decisions = sup.step()
        restart = [d for d in decisions if d["action"] == "restart_replica"]
        assert restart and restart[0]["replica"] == victim, decisions
        assert restart[0]["port"] == ports[victim], restart
        wait_until(lambda: serving_ok(ports[victim]), 300,
                   "the restarted replica to serve again")
        back_s = time.monotonic() - t_kill
        status, _ = embed_req(ports[victim], images(2))
        out["phases"]["restart"] = {
            "killed_pid": victim_pid, "replica": victim, "port": ports[victim],
            "decisions": decisions, "served_after_restart": status == 200,
            "restarts": sup.replicas()[victim]["restarts"],
            "kill_to_healthy_s": round(back_s, 3),
            "restart_budget": MAX_RESTARTS,
            "ok": status == 200 and sup.replicas()[victim]["restarts"] <= MAX_RESTARTS,
        }

        # 3. promote on the other replica under load: no request may fail
        target = max(ports)
        port = ports[target]
        counters, lock, stop = {"ok": 0, "other": 0}, threading.Lock(), threading.Event()
        threads = [threading.Thread(target=load_window, args=(
            port, np.random.default_rng(100 + i), size, stop, counters, lock), daemon=True)
            for i in range(LOAD_THREADS)]
        for t in threads:
            t.start()
        wait_until(lambda: counters["ok"] >= 10, 120, "load to flow")
        t_promote = time.monotonic()
        status, promoted = post(port, "/models/promote", {"model": "prod", "ckpt": ck2},
                                timeout=300)
        promote_s = time.monotonic() - t_promote
        assert status == 200 and promoted["version"] == 2, promoted
        time.sleep(2.0)  # the load goes on through the drain window
        stop.set()
        for t in threads:
            t.join(timeout=60)

        def versions():
            return {v["version"]: v["state"]
                    for v in get(port, "/models")[1]["models"]["prod"]["versions"]}

        wait_until(lambda: versions().get(1) == "retired", 60,
                   "the old version to drain and retire")
        states = versions()
        failures = {k: v for k, v in counters.items() if k != "ok" and v}
        out["phases"]["promote"] = {
            "response": promoted, "embed_ok": counters["ok"], "embed_failures": failures,
            "versions": {str(k): v for k, v in states.items()},
            "drained": states.get(1) == "retired" and states.get(2) == "serving",
            "promote_s": round(promote_s, 3), "load_threads": LOAD_THREADS,
            "ok": not failures and states.get(2) == "serving",
        }

        # 4. the index answers a served image with itself
        corpus = images(4)
        embed_req(port, corpus)
        query = corpus[1:2]
        status, r = post(port, "/neighbors", {
            "images_b64": base64.b64encode(query.tobytes()).decode(),
            "shape": list(query.shape), "k": 2})
        top = r["neighbors"][0][0]
        self_id = ModelRegistry.content_id(query[0])
        hit = top["id"] == self_id and top["score"] > 0.999
        out["phases"]["neighbors"] = {
            "status": status, "top1_id": top["id"], "expected_id": self_id,
            "top1_score": top["score"], "k": r["k"], "self_top1": hit, "ok": hit,
        }
        out["ok"] = all(p["ok"] for p in out["phases"].values())
        out["gave_up"] = sup.gave_up()
        out["decisions"] = sup.decisions()
        return out
    finally:
        sup.stop_all()


def card_fields(device: str) -> dict:
    if device == "cpu":
        return {"device": "cpu", "card": None, "card_count": 0}
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return {"device": "cuda", "card": smi.stdout.strip().splitlines()[0],
            "card_count": torch.cuda.device_count()}


def build_output(result: dict, device: str, model_name: str, size: int) -> dict:
    """The artifact the ``serve_fleet`` gate judges (the JAX scenario's
    keys, then the port's: the model and the card)."""
    return {"metric": "serve_fleet_scenario", "schema": SCHEMA,
            "replica_command": f"python -m {FLEET_MODULE} --device {device}",
            "min_replicas": MIN_REPLICAS, "img_size": size, "model": model_name,
            **result, **card_fields(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir",
                    default=os.path.join(REPO, "work_space", "port_serve_fleet_scenario"))
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model", default="resnet18")
    ap.add_argument("--size", type=int, default=32)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("port_serve_fleet_scenario: no CUDA device", file=sys.stderr)
            return 2
    os.makedirs(args.workdir, exist_ok=True)
    if args.json and os.path.exists(args.json):
        os.remove(args.json)  # a failed run must not leave a stale green artifact
    out = build_output(run_scenario(args.workdir, args.device, args.model, args.size),
                       args.device, args.model, args.size)
    print(json.dumps({"metric": out["metric"], "ok": out["ok"], "card": out["card"],
                      **{k: {kk: vv for kk, vv in v.items() if kk.endswith("_s")}
                         for k, v in out["phases"].items()}}), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
