"""The port's representation-health diagnostics, health monitor and online
probe against the JAX package's, on the CPU at a small size.

- ``contrastive_health_metrics`` on seeded unit embeddings ``[2B, D]``
  against JAX's (rtol 1e-5; ``eff_rank`` 1e-4, its spectrum taken on the
  host in float64 from the covariance the port ships through the ring,
  JAX's by ``eigvalsh`` in fp32), and the global gradient norm against
  ``optax.global_norm``;
- the collapse signature: identical rows read align 1, neg_mean and
  neg_max 1, eff_rank 1, unif 0;
- ``HealthMonitor``: the same windows of rows (sentinel rows, healthy and
  collapsed samples, an infinite gradient norm) give the JAX monitor's
  findings, window means, sample and alarm counts; ``abort`` raises;
- the pretrain driver with ``--health_policy abort`` and a bar every
  sample breaks exits 3, with no crash save (never rolled back);
- two online-probe steps from carried weights against JAX's probe update
  (the post-hoc probe's head and SGD, both views' labels): loss rtol 1e-5,
  top-1 exact, weights rtol 1e-5 atol 1e-6;
- checkpoints: with the probe off ``last.pth`` holds exactly the keys it
  held before the probe existed, with the probe on it adds ``probe`` only;
  the probe leaves the encoder's update bitwise unchanged; a probe-on run
  resumed after an epoch ends bitwise equal to the straight run, probe
  included.
"""

import glob
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simclr_pytorch_distributed_tpu.ops import losses as jlosses
from simclr_pytorch_distributed_tpu.ops import metrics as jmetrics
from simclr_pytorch_distributed_tpu.train import supcon_step as jstep
from simclr_pytorch_distributed_tpu.utils import guard as jguard
from simclr_pytorch_distributed_tpu_torch.train import supcon
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
    DEVICE_HEALTH_KEYS,
    HEALTH_COV,
    HEALTH_METRIC_KEYS,
    build_online_probe,
    contrastive_health_metrics,
    effective_rank,
    global_grad_norm,
    host_metrics,
    metric_keys,
    probe_update,
)
from simclr_pytorch_distributed_tpu_torch.utils import guard, obs
from simclr_pytorch_distributed_tpu_torch.utils.convert import classifier_params_to_state_dict
from torch_threads import limit_threads

limit_threads()

RTOL, EFF_RANK_RTOL = 1e-5, 1e-4
PROBE_LOSS_RTOL, PROBE_RTOL, PROBE_ATOL = 1e-5, 1e-5, 1e-6


def unit_rows(rng, n, d, spread=1.0):
    base = rng.standard_normal((1, d))
    x = base + spread * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def port_health(emb, grads):
    params = []
    for g in grads.values():
        p = torch.nn.Parameter(torch.zeros(g.shape))
        p.grad = torch.from_numpy(g)
        params.append(p)
    m = contrastive_health_metrics(torch.from_numpy(emb), global_grad_norm(params))
    return host_metrics({k: (v.numpy() if k == HEALTH_COV else v.item()) for k, v in m.items()})


@pytest.mark.parametrize("n, d, spread, seed", [
    (16, 8, 1.0, 0), (32, 16, 0.3, 1), (24, 32, 3.0, 2), (64, 128, 0.5, 3),
])
def test_health_metrics_match_jax(n, d, spread, seed):
    rng = np.random.default_rng(seed)
    emb = unit_rows(rng, n, d, spread)
    grads = {"w": rng.standard_normal((d, 5)).astype(np.float32),
             "b": rng.standard_normal(5).astype(np.float32)}
    got = port_health(emb, grads)
    want = jstep.contrastive_health_metrics(jnp.asarray(emb), jax.tree.map(jnp.asarray, grads))
    assert set(got) == set(HEALTH_METRIC_KEYS) == set(want)
    for key in HEALTH_METRIC_KEYS:
        rtol = EFF_RANK_RTOL if key == "health_eff_rank" else RTOL
        np.testing.assert_allclose(got[key], float(want[key]), rtol=rtol, atol=1e-6,
                                   err_msg=key)


def test_collapse_signature():
    emb = np.tile(unit_rows(np.random.default_rng(4), 1, 16), (12, 1))
    got = port_health(emb, {"g": np.ones(3, np.float32)})
    for key, value in (("health_align", 1.0), ("health_neg_mean", 1.0), ("health_neg_max", 1.0),
                       ("health_eff_rank", 1.0), ("health_unif", 0.0),
                       ("health_grad_norm", math.sqrt(3.0))):
        assert got[key] == pytest.approx(value, abs=1e-5), key
    assert got["health_con_top1"] <= 100.0


def test_effective_rank_of_a_sentinel_is_nan():
    assert math.isnan(effective_rank(np.full((4, 4), np.nan)))
    assert effective_rank(np.eye(5)) == pytest.approx(5.0)
    assert effective_rank(np.zeros((3, 3))) == pytest.approx(1.0)  # JAX's clamp: p = 0 -> 1


def health_row(rng, collapsed=False, sentinel=False, inf_grad=False):
    if sentinel:
        row = {k: math.nan for k in HEALTH_METRIC_KEYS}
    else:
        row = {k: float(rng.uniform(0.1, 0.9)) for k in HEALTH_METRIC_KEYS}
        row["health_eff_rank"] = float(rng.uniform(4, 10))
        row["health_grad_norm"] = math.inf if inf_grad else float(rng.uniform(0.5, 2))
        if collapsed:
            row.update(health_align=0.999, health_neg_mean=0.998, health_eff_rank=1.01)
    row.update(loss=float(rng.uniform(5, 6)), probe_top1=float(rng.uniform(0, 100)))
    return row


def monitor_windows():
    rng = np.random.default_rng(5)
    kinds = ([{}] + [{"sentinel": True}] * 2 + [{}, {}, {"inf_grad": True}, {}]
             + [{"collapsed": True}] * 9 + [{"sentinel": True}] * 3 + [{}] * 12)
    rows = [(step, health_row(rng, **kind)) for step, kind in enumerate(kinds)]
    return [rows[i:i + 4] for i in range(0, len(rows), 4)]


@pytest.mark.parametrize("grad_norm_max", [0.0, 1.5])
def test_health_monitor_reaches_jax_verdicts(grad_norm_max):
    port = guard.HealthMonitor(thresholds=guard.HealthThresholds(grad_norm_max=grad_norm_max))
    want = jguard.HealthMonitor(thresholds=jguard.HealthThresholds(grad_norm_max=grad_norm_max))
    verdicts = []
    for window in monitor_windows():
        got = port.ingest(window)
        assert got == want.ingest(window)
        assert port.last_means == want.last_means
        verdicts.append(bool(got))
    assert (port.samples, port.alarms, port.nonfinite_keys) == (
        want.samples, want.alarms, want.nonfinite_keys)
    assert any(verdicts) and not all(verdicts)


def test_health_monitor_abort_raises():
    monitor = guard.HealthMonitor(policy="abort")
    with pytest.raises(guard.RepresentationHealthError, match="divergence") as exc:
        for window in monitor_windows():
            monitor.ingest(window)
    assert guard.exit_code_for(exc.value) == guard.EXIT_HEALTH == 3
    with pytest.raises(ValueError):
        guard.HealthMonitor(policy="retry")


def test_metric_keys_match_jax():
    for health in (False, True):
        for probe in (False, True):
            assert metric_keys(health, probe) == jstep.metric_keys(health, probe)
    assert set(DEVICE_HEALTH_KEYS) == set(HEALTH_METRIC_KEYS) - {"health_eff_rank"}


def test_two_probe_steps_match_jax():
    rng = np.random.default_rng(6)
    n_cls, feat, b = 5, 512, 6
    spec, params, opt = jstep.build_online_probe("resnet18", feat, n_cls, 0.3, seed=2)
    probe = build_online_probe("resnet18", n_cls, 0.3)
    probe.classifier.load_state_dict(classifier_params_to_state_dict(params))
    for step in range(2):
        feats = rng.standard_normal((2 * b, feat)).astype(np.float32)
        labels = rng.integers(0, n_cls, b).astype(np.int32)
        labels2 = jnp.concatenate([labels, labels])

        def loss_fn(pp):
            logits = spec.classifier.apply({"params": pp}, jnp.asarray(feats))
            return jlosses.cross_entropy_loss(logits, labels2), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt = spec.tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        top1 = 100.0 * float(jmetrics.topk_correct(logits, labels2, ks=(1,))[1]) / (2 * b)
        got = probe_update(probe, torch.from_numpy(feats), torch.from_numpy(labels))
        np.testing.assert_allclose(got["probe_loss"].item(), float(loss), rtol=PROBE_LOSS_RTOL)
        assert got["probe_top1"].item() == pytest.approx(top1, rel=1e-6)
        np.testing.assert_allclose(probe.classifier.fc.weight.detach().numpy(),
                                   np.asarray(params["fc"]["kernel"]).T,
                                   rtol=PROBE_RTOL, atol=PROBE_ATOL, err_msg=f"step {step}")
        np.testing.assert_allclose(probe.classifier.fc.bias.detach().numpy(),
                                   np.asarray(params["fc"]["bias"]),
                                   rtol=PROBE_RTOL, atol=PROBE_ATOL)


# -- the driver ---------------------------------------------------------------

STEPS = 8  # 64 images / batch 8
ARGV = [
    "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--size", "8",
    "--batch_size", "8", "--learning_rate", "0.05", "--temp", "0.5", "--print_freq", "4",
    "--feat_dim", "16", "--loss_impl", "fused", "--save_freq", "1",
]
# the keys of a full-state checkpoint before the online probe existed
CHECKPOINT_KEYS = {"opt", "model", "optimizer", "epoch", "step", "step_in_epoch",
                   "record_norm_mean", "generator", "generator_device", "seed", "world_size",
                   "lr_scale", "rollbacks"}


def tiny_dataset(dataset, data_folder):
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, 80).astype(np.int32)
    means = rng.uniform(48, 208, (10, 1, 1, 3))
    images = np.clip(means[labels] + rng.normal(0, 32, (80, 8, 8, 3)), 0, 255).astype(np.uint8)
    return ({"images": images[:64], "labels": labels[:64]},
            {"images": images[64:], "labels": labels[64:]}, 10)


def pretrain(workdir, *extra):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(supcon, "load_dataset", tiny_dataset)
        return supcon.main(ARGV + ["--workdir", str(workdir), *extra])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("health")
    out = {"off": pretrain(root / "off", "--epochs", "2", "--online_probe", "off"),
           "on": pretrain(root / "on", "--epochs", "2", "--online_probe", "on")}
    first = pretrain(root / "first", "--epochs", "1", "--online_probe", "on")
    out["resumed"] = pretrain(root / "resumed", "--epochs", "2", "--online_probe", "on",
                              "--resume", first.save_folder)
    return out


def load(run, name="last.pth"):
    return torch.load(os.path.join(run.save_folder, name), map_location="cpu",
                      weights_only=True)


def test_probe_off_checkpoint_keeps_its_layout(runs):
    off, on = load(runs["off"]), load(runs["on"])
    assert set(off) == CHECKPOINT_KEYS
    assert set(on) == CHECKPOINT_KEYS | {"probe"}
    for key in ("model", "optimizer"):
        assert off[key].keys() == on[key].keys()
    assert set(on["probe"]) == {"classifier", "optimizer"}
    assert set(on["probe"]["classifier"]) == {"fc.weight", "fc.bias"}


def test_the_probe_leaves_the_encoder_update_bitwise_unchanged(runs):
    got, want = runs["on"].state.model.state_dict(), runs["off"].state.model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert [h["loss"] for h in runs["on"].history] == [h["loss"] for h in runs["off"].history]
    assert all(0.0 <= h["probe_top1"] <= 100.0 for h in runs["on"].history)
    assert "probe_loss" not in runs["off"].history[0]


def test_health_columns_every_tenth_step_by_default(runs):
    history = runs["off"].history
    assert len(history) == 2 * STEPS
    finite = [math.isfinite(h["health_eff_rank"]) for h in history]
    assert finite == [h["step"] % 10 == 0 for h in history]


def test_probe_resume_is_the_straight_run(runs):
    got, want = runs["resumed"].state, runs["on"].state
    for k, v in want.probe.classifier.state_dict().items():
        assert torch.equal(got.probe.classifier.state_dict()[k], v), k
    got_opt = got.probe.optimizer.state_dict()["state"]
    for k, v in want.probe.optimizer.state_dict()["state"].items():
        assert torch.equal(got_opt[k]["momentum_buffer"], v["momentum_buffer"]), k
    for k, v in want.model.state_dict().items():
        assert torch.equal(got.model.state_dict()[k], v), k


def test_health_abort_exits_3_without_a_crash_save(tmp_path, monkeypatch):
    # a bar every real sample breaks: the run aborts at its first window
    # (the monitor takes the run's recipe's bars: patch where it looks them up)
    monkeypatch.setattr(obs, "thresholds_for_recipe",
                        lambda recipe: guard.HealthThresholds(eff_rank_min=1e9))
    with pytest.raises(SystemExit) as exc:
        pretrain(tmp_path, "--epochs", "1", "--health_freq", "1", "--health_policy", "abort")
    assert exc.value.code == guard.EXIT_HEALTH == 3
    assert isinstance(exc.value.__cause__, guard.RepresentationHealthError)
    folder = glob.glob(str(tmp_path / "*_models" / "*"))[0]
    assert not glob.glob(os.path.join(folder, "crash_epoch_*.pth"))
    names = [json.loads(line)["name"] for line in open(os.path.join(folder, "events.jsonl"))]
    assert "health_alarm" in names and names[-1] == "run_exit"
