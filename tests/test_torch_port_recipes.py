"""The port's SSL recipe pieces against the JAX package's, on the CPU.

- The recipe losses (``byol_loss``, ``simsiam_loss`` with its stop-gradient,
  ``vicreg_loss`` with its three parts, ``moco_queue_loss``): values and
  input gradients against the JAX functions on the same numpy inputs (rtol
  1e-5, atol 1e-6), and the queue loss with ``K = 0`` and ``key == query``
  equal to the port's SimCLR ``supcon_loss`` exactly.
- ``PredictorHead`` against the JAX module with the same parameters
  (carried across by ``utils/convert.py``): output and parameter
  gradients.
- ``config.validate_recipe``: every rejection of the JAX package's
  ``tests/test_recipes.py``, the method resolution, and ``--loss_impl
  auto`` resolving to dense under a queue; ``--num_workers`` parsed and
  ignored by the pretraining, probe and CE parsers.
- The slots each recipe attaches, the health bars per recipe, and the
  weight bridge for the slots (JAX -> port -> JAX).
- Checkpoints: the slots' round trip, a slot-free recipe's keys, and the
  cross-recipe hygiene warnings (captured from the log).
- The collapse arm: ``--recipe byol --byol_predictor none`` under
  ``--health_policy abort`` with a collapsed forward exits with code 3.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_pytorch_distributed_tpu import config as jax_config
from simclr_pytorch_distributed_tpu import recipes as jax_recipes
from simclr_pytorch_distributed_tpu.models.heads import PredictorHead as JaxPredictorHead
from simclr_pytorch_distributed_tpu.ops import losses as jax_losses
from simclr_pytorch_distributed_tpu_torch import config as config_lib
from simclr_pytorch_distributed_tpu_torch import recipes
from simclr_pytorch_distributed_tpu_torch.models import PredictorHead, SupConResNet
from simclr_pytorch_distributed_tpu_torch.ops import losses
from simclr_pytorch_distributed_tpu_torch.train import supcon, supcon_step
from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
from simclr_pytorch_distributed_tpu_torch.utils import checkpoint, convert
from simclr_pytorch_distributed_tpu_torch.utils.guard import (
    HealthThresholds,
    thresholds_for_recipe,
)
from torch_threads import limit_threads

limit_threads()

RTOL, ATOL = 1e-5, 1e-6


def _two_view(seed, b=6, d=10):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2 * b, d)).astype(np.float32)


def _port_value_and_grads(fn, *arrays):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*leaves)
    value = out[0] if isinstance(out, tuple) else out
    value.backward()
    # an input the loss detaches gets no gradient, which JAX reports as zeros
    return out, [np.zeros_like(a) if t.grad is None else t.grad.numpy()
                 for a, t in zip(arrays, leaves)]


def _jax_value_and_grads(fn, *arrays):
    def scalar(*xs):
        out = fn(*xs)
        return (out[0], out) if isinstance(out, tuple) else (out, out)

    (_, out), grads = jax.value_and_grad(scalar, argnums=tuple(range(len(arrays))),
                                         has_aux=True)(*map(jnp.asarray, arrays))
    return out, [np.asarray(g) for g in grads]


LOSS_CASES = {
    "byol": (losses.byol_loss, jax_losses.byol_loss, 2),
    "simsiam": (losses.simsiam_loss, jax_losses.simsiam_loss, 2),
    "vicreg": (lambda a, b: losses.vicreg_loss(a, b, sim_coeff=25.0, std_coeff=25.0,
                                               cov_coeff=1.0),
               lambda a, b: jax_losses.vicreg_loss(a, b, sim_coeff=25.0, std_coeff=25.0,
                                                   cov_coeff=1.0), 2),
    "moco_queue": (lambda q, k, queue: losses.moco_queue_loss(
        q, k, queue, temperature=0.5, base_temperature=0.07),
        lambda q, k, queue: jax_losses.moco_queue_loss(
        q, k, queue, temperature=0.5, base_temperature=0.07), 3),
}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_recipe_loss_and_input_gradients_match_jax(name):
    ours, theirs, n_args = LOSS_CASES[name]
    if name == "vicreg":
        # the two views' unnormalized [B, D] projections, scaled so the
        # variance hinge is active on some dimensions and not on others
        x = _two_view(3) * np.linspace(0.3, 2.0, 10, dtype=np.float32)
        arrays = [x[:6], x[6:]]
    elif name == "moco_queue":
        q = losses.l2_normalize(torch.from_numpy(_two_view(4))).numpy()
        k = losses.l2_normalize(torch.from_numpy(_two_view(5))).numpy()
        queue = losses.l2_normalize(torch.from_numpy(_two_view(6, b=8))).numpy()
        arrays = [q, k, queue]
    else:
        arrays = [_two_view(1), _two_view(2)]
    assert len(arrays) == n_args
    got, got_grads = _port_value_and_grads(ours, *arrays)
    want, want_grads = _jax_value_and_grads(theirs, *arrays)
    if name == "vicreg":
        (got, got_parts), (want, want_parts) = got, want
        assert set(got_parts) == set(want_parts) == {"vicreg_inv", "vicreg_var", "vicreg_cov"}
        for key in got_parts:
            np.testing.assert_allclose(got_parts[key].item(), float(want_parts[key]),
                                       rtol=RTOL, atol=ATOL, err_msg=key)
        assert got_parts["vicreg_var"].item() > 0  # the hinge is active
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    for i, (g, w) in enumerate(zip(got_grads, want_grads)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"gradient {i}")
    if name == "simsiam":
        # the stop-gradient is inside the loss: nothing reaches the
        # projection through the cross-view side, only through the pred side
        pred = torch.from_numpy(arrays[0]).requires_grad_()
        proj = torch.from_numpy(arrays[1]).requires_grad_()
        losses.simsiam_loss(pred, proj).backward()
        assert proj.grad is None and pred.grad.abs().sum() > 0


def test_moco_queue_loss_with_no_queue_is_the_simclr_loss():
    feats = losses.l2_normalize(torch.from_numpy(_two_view(7)))
    b = feats.shape[0] // 2
    simclr = losses.supcon_loss(torch.stack([feats[:b], feats[b:]], dim=1),
                                temperature=0.5, base_temperature=0.07)
    queued = losses.moco_queue_loss(feats, feats, torch.zeros(0, feats.shape[1]),
                                    temperature=0.5, base_temperature=0.07)
    assert queued.item() == simclr.item()
    jax_simclr = jax_losses.supcon_loss(
        jnp.asarray(torch.stack([feats[:b], feats[b:]], dim=1).numpy()),
        temperature=0.5, base_temperature=0.07)
    np.testing.assert_allclose(queued.item(), float(jax_simclr), rtol=RTOL)


def test_predictor_head_matches_jax():
    rng = np.random.default_rng(8)
    z = rng.normal(size=(12, 16)).astype(np.float32)
    head = PredictorHead(32, 16, generator=torch.Generator().manual_seed(3))
    params = convert.predictor_state_dict_to_params(head.state_dict())
    # bn_scale/bn_bias away from their init, so a swapped pair would show
    params["bn_scale"] = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    params["bn_bias"] = rng.normal(0, 0.3, 32).astype(np.float32)
    head.load_state_dict(convert.predictor_params_to_state_dict(params))
    jhead = JaxPredictorHead(dim_hidden=32, dim_out=16)
    jparams = jax.tree.map(jnp.asarray, params)

    out = head(torch.from_numpy(z))
    cot = rng.normal(size=out.shape).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    want, vjp = jax.vjp(lambda p: jhead.apply({"params": p}, jnp.asarray(z)), jparams)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    (jgrads,) = vjp(jnp.asarray(cot))
    ours = convert.predictor_state_dict_to_params(
        {k: p.grad for k, p in head.named_parameters()})
    for path, ref in jax.tree_util.tree_leaves_with_path(jgrads):
        got = ours
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    # the init: torch's nn.Linear default, U(+-1/sqrt(fan_in))
    fresh = PredictorHead(32, 16, generator=torch.Generator().manual_seed(0))
    assert fresh.fc1.weight.abs().max() <= 1 / 4 and fresh.fc2.weight.abs().max() <= 1 / 32 ** 0.5
    assert torch.equal(fresh.bn_scale, torch.ones(32))


# -- the configuration ---------------------------------------------------------


REJECTIONS = [
    (dict(recipe="byol", method="SupCon"), "label-free"),
    (dict(recipe="simclr", method="SupCon"), "contradicts"),
    (dict(recipe="supcon", moco_queue=512), "NEGATIVES only"),
    (dict(recipe="byol", moco_queue=512), "NEGATIVES only"),
    (dict(recipe="simclr", moco_queue=100, batch_size=64), "multiple of"),
    (dict(recipe="simclr", moco_queue=512, loss_impl="fused"), "dense"),
    (dict(recipe="simclr", moco_queue=512, loss_impl="ring"), "dense"),
    (dict(recipe="byol", ema_momentum=1.0), "ema_momentum"),
    (dict(recipe="byol", ema_momentum=-0.1), "ema_momentum"),
    (dict(recipe="vicreg", vicreg_std_coeff=-1.0), "vicreg_std_coeff"),
]


@pytest.mark.parametrize("over,match", REJECTIONS)
def test_validate_recipe_rejects_what_jax_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        config_lib.validate_recipe(config_lib.SupConConfig(**over))
    with pytest.raises(ValueError, match=match):
        jax_config.validate_recipe(jax_config.SupConConfig(**over))


def test_validate_recipe_resolves_as_jax():
    for over, want in ((dict(method="SimCLR"), ("simclr", "SimCLR")),
                       (dict(method="SupCon"), ("supcon", "SupCon")),
                       (dict(recipe="supcon", method="SimCLR"), ("supcon", "SupCon")),
                       (dict(recipe="byol"), ("byol", "SimCLR"))):
        ours, theirs = config_lib.SupConConfig(**over), jax_config.SupConConfig(**over)
        config_lib.validate_recipe(ours)
        jax_config.validate_recipe(theirs)
        assert (ours.recipe, ours.method) == (theirs.recipe, theirs.method) == want


def test_loss_impl_auto_is_dense_under_a_queue():
    for device in ("cuda", "cpu"):
        impl, reason = supcon.resolve_loss_impl_reasoned("auto", torch.device(device),
                                                         moco_queue=512)
        assert impl == "dense" and "--moco_queue 512" in reason
    assert supcon.resolve_loss_impl_reasoned("auto", torch.device("cuda"))[0] == "fused"


def test_recipe_flags_and_num_workers_parse(tmp_path):
    cfg = config_lib.parse_supcon(["--recipe", "byol", "--ema_momentum", "0.99",
                                   "--predictor_hidden", "64", "--num_workers", "8",
                                   "--workdir", str(tmp_path)])
    assert (cfg.recipe, cfg.ema_momentum, cfg.predictor_hidden) == ("byol", 0.99, 64)
    cfg = config_lib.parse_supcon(["--recipe", "simclr", "--moco_queue", "512",
                                   "--workdir", str(tmp_path)])
    assert (cfg.moco_queue, cfg.num_workers, cfg.recipe) == (512, 16, "simclr")
    for ce in (False, True):  # the probe's parser and the CE trainer's
        lcfg = config_lib.parse_linear(["--num_workers", "8", "--workdir", str(tmp_path)], ce=ce)
        assert lcfg.num_workers == 8
    with pytest.raises(SystemExit):
        config_lib.parse_supcon(["--recipe", "moco"])


# -- slots, bars and the bridge -------------------------------------------------


def _state(recipe_name, **over):
    torch.manual_seed(0)
    model = SupConResNet("resnet10", "mlp", 16)
    state = TrainState(model, make_optimizer(model), lambda s: 0.1)
    cfg = config_lib.SupConConfig(feat_dim=16, predictor_hidden=32, batch_size=4,
                                  recipe=recipe_name, **over)
    config_lib.validate_recipe(cfg)
    return recipes.attach_for_config(cfg, state)


def test_attached_slots_per_recipe():
    for name in ("supcon", "simclr", "vicreg"):
        state, recipe = _state(name)
        assert state.recipe is recipe and recipe.name == name
        assert (state.recipe_params, state.recipe_opt_state, state.recipe_state) == (None,) * 3
    assert recipes.recipe_metric_keys("vicreg") == ("vicreg_cov", "vicreg_inv", "vicreg_var")
    state, recipe = _state("simclr", moco_queue=16)
    assert state.recipe_params is None and state.recipe_opt_state is None
    queue = state.recipe_state["queue_emb"]
    assert queue.shape == (16, 16) and state.recipe_state["queue_ptr"] == 0
    np.testing.assert_allclose(queue.norm(dim=1).numpy(), 1.0, rtol=1e-6)
    key = state.recipe_state["key"]
    assert key is not state.model and not any(p.requires_grad for p in key.parameters())
    for (name, p), q in zip(state.model.named_parameters(), key.parameters()):
        assert torch.equal(p, q) and p.data_ptr() != q.data_ptr(), name
    state, recipe = _state("byol")
    assert recipe.trainable and isinstance(state.recipe_params, PredictorHead)
    assert isinstance(state.recipe_opt_state, torch.optim.SGD)
    assert set(state.recipe_state) == {"target"}
    state, recipe = _state("byol", byol_predictor="none")
    assert not recipe.trainable and state.recipe_params is None and state.recipe_state
    state, recipe = _state("simsiam", optimizer="lars")
    assert recipe.trainable and state.recipe_state is None
    assert type(state.recipe_opt_state).__name__ == "LARS"
    # the draws come from the recipe generator, not the global one
    model = SupConResNet("resnet10", "mlp", 16)
    state = TrainState(model, make_optimizer(model), lambda s: 0.1)
    before = torch.random.get_rng_state()
    cfg = config_lib.SupConConfig(feat_dim=16, predictor_hidden=32, recipe="byol")
    recipes.attach_for_config(cfg, state)
    assert torch.equal(torch.random.get_rng_state(), before)


def test_thresholds_for_recipe_are_jax_bars():
    from simclr_pytorch_distributed_tpu.utils.guard import thresholds_for_recipe as jax_bars
    for name in ("supcon", "simclr", "byol", "simsiam", "vicreg", None):
        assert thresholds_for_recipe(name).eff_rank_min == jax_bars(name).eff_rank_min
    assert thresholds_for_recipe("byol").eff_rank_min == 3.0
    assert thresholds_for_recipe(None) == HealthThresholds()


def test_recipe_metric_keys_are_jax_keys():
    for name in jax_recipes.RECIPE_NAMES:
        assert recipes.recipe_metric_keys(name) == jax_recipes.recipe_metric_keys(name)
    assert recipes.ALL_RECIPE_METRIC_KEYS == jax_recipes.ALL_RECIPE_METRIC_KEYS
    assert supcon_step.metric_keys(True, True, ("vicreg_inv",)) == tuple(sorted(
        supcon_step.METRIC_KEYS + supcon_step.HEALTH_METRIC_KEYS
        + supcon_step.ONLINE_PROBE_METRIC_KEYS + ("vicreg_inv",)))


def test_slot_bridge_round_trips():
    state, _ = _state("byol")
    jax_slots = convert.recipe_slots_from_torch(state.recipe_params, state.recipe_state)
    assert set(jax_slots["recipe_params"]) == {"fc1", "fc2", "bn_scale", "bn_bias"}
    assert jax_slots["recipe_params"]["fc1"]["kernel"].shape == (16, 32)  # [in, out]
    back = convert.recipe_slots_to_torch(**jax_slots)
    assert set(back["recipe_state"]["target"]) == {
        k for k, _ in state.recipe_state["target"].named_parameters()}
    for k, v in state.recipe_params.state_dict().items():
        assert torch.equal(back["recipe_params"][k], v), k
    state, _ = _state("simclr", moco_queue=16)
    state.recipe_state["queue_ptr"] = 8
    jax_slots = convert.recipe_slots_from_torch(None, state.recipe_state)
    assert set(jax_slots["recipe_state"]) == {"key_params", "queue_emb", "queue_ptr"}
    back = convert.recipe_slots_to_torch(**jax_slots)["recipe_state"]
    assert back["queue_ptr"] == 8 and torch.equal(back["queue_emb"],
                                                  state.recipe_state["queue_emb"])


# -- checkpoints ---------------------------------------------------------------


def _save(tmp_path, state, name="ck.pth"):
    cfg = config_lib.SupConConfig(recipe=state.recipe.name)
    gen = torch.Generator()
    return checkpoint.save_checkpoint(str(tmp_path / name), checkpoint.capture_state(state, gen),
                                      cfg, epoch=1)


def _perturb(state):
    """Move every slot away from its init, as training would."""
    with torch.no_grad():
        for slot in (state.recipe_params, *(state.recipe_state or {}).values()):
            if isinstance(slot, torch.nn.Module):
                for p in slot.parameters():
                    p.add_(0.25)
        if state.recipe_params is not None:
            for p in state.recipe_params.parameters():
                p.grad = torch.ones_like(p)
            state.recipe_opt_state.step()
    if state.recipe_state and "queue_ptr" in state.recipe_state:
        state.recipe_state["queue_emb"].mul_(-1.0)
        state.recipe_state["queue_ptr"] = 8


def _slots(state):
    return checkpoint._recipe_payload(state, lambda t: t.detach().clone())


def _assert_same(a, b):
    assert type(a) is type(b) or (torch.is_tensor(a) and torch.is_tensor(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    elif isinstance(a, list):
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("name,over", [("byol", {}), ("simclr", {"moco_queue": 16}),
                                       ("simsiam", {})])
def test_recipe_slots_round_trip(tmp_path, name, over):
    state, _ = _state(name, **over)
    _perturb(state)
    path = _save(tmp_path, state)
    ckpt = torch.load(path, weights_only=True)
    assert ckpt["recipe"]["name"] == name
    assert ckpt["recipe"]["moco_queue"] == over.get("moco_queue", 0)
    if name == "byol":  # the EMA network: parameters only, no BN buffers
        assert not [k for k in ckpt["recipe"]["recipe_state"]["target"] if "running" in k]
    fresh, _ = _state(name, **over)
    checkpoint.restore_checkpoint(path, fresh, torch.Generator(), recipe=name,
                                  moco_queue=over.get("moco_queue", 0))
    _assert_same(_slots(fresh), _slots(state))
    if name == "simclr":
        assert fresh.recipe_state["queue_ptr"] == 8


def test_slot_free_checkpoint_keeps_todays_keys(tmp_path):
    state, _ = _state("simclr")
    keys = set(torch.load(_save(tmp_path, state), weights_only=True))
    assert keys == {"opt", "model", "optimizer", "epoch", "step", "step_in_epoch",
                    "record_norm_mean", "generator", "generator_device", "seed", "world_size",
                    "lr_scale", "rollbacks"}


HYGIENE = [
    # (saved recipe, its options, resumed recipe, its options, warning)
    ("byol", {}, "supcon", {}, "does not use; recipe slots ignored"),
    ("supcon", {}, "byol", {}, "has no recipe payload"),
    ("byol", {}, "simsiam", {}, "was trained with recipe 'byol' but this run uses 'simsiam'"),
    ("simclr", {"moco_queue": 16}, "simclr", {"moco_queue": 32},
     "was trained with --moco_queue 16 but this run uses 32"),
]


@pytest.mark.parametrize("saved,saved_over,resumed,resumed_over,warning", HYGIENE)
def test_cross_recipe_resume_restores_the_encoder_and_starts_slots_fresh(
        tmp_path, caplog, saved, saved_over, resumed, resumed_over, warning):
    src, _ = _state(saved, **saved_over)
    if src.recipe_params is not None or src.recipe_state is not None:
        _perturb(src)
    with torch.no_grad():
        for p in src.model.parameters():
            p.mul_(0.5)
    path = _save(tmp_path, src)
    dst, _ = _state(resumed, **resumed_over)
    before = _slots(dst)
    with caplog.at_level(logging.WARNING):
        checkpoint.restore_checkpoint(path, dst, torch.Generator(), recipe=dst.recipe.name,
                                      moco_queue=resumed_over.get("moco_queue", 0))
    assert warning in caplog.text
    _assert_same(_slots(dst), before)  # the slots keep their fresh init
    for p, q in zip(dst.model.parameters(), src.model.parameters()):
        assert torch.equal(p, q)  # the encoder trajectory restored


def test_mismatched_slot_structure_starts_fresh(tmp_path, caplog):
    src, _ = _state("byol")
    _perturb(src)
    path = _save(tmp_path, src)
    torch.manual_seed(0)
    model = SupConResNet("resnet10", "mlp", 16)
    dst = TrainState(model, make_optimizer(model), lambda s: 0.1)
    cfg = config_lib.SupConConfig(feat_dim=16, predictor_hidden=48, recipe="byol")
    recipes.attach_for_config(cfg, dst)
    before = _slots(dst)
    with caplog.at_level(logging.WARNING):
        checkpoint.restore_checkpoint(path, dst, torch.Generator(), recipe="byol", moco_queue=0)
    assert "does not match this run's recipe-slot structure" in caplog.text
    _assert_same(_slots(dst), before)


# -- the collapse arm ------------------------------------------------------------


def test_ablated_byol_collapse_exits_3(tmp_path, monkeypatch):
    """The JAX package's collapse injection (tests/test_recipes.py:781): a
    forward whose embeddings are all equal (and still a function of the
    weights, so the step's backward runs) trips the raised eff-rank bar of
    ``--recipe byol --byol_predictor none`` under ``--health_policy
    abort``: exit code 3, with the alarm on the recorder stream."""
    import json

    from simclr_pytorch_distributed_tpu_torch.recipes import base

    def constant_forward(model, images, with_features=False):
        out = model.forward_with_features(images.transpose(0, 1).reshape(
            (-1,) + tuple(images.shape[2:])))
        feats = out[0] * 0.0 + 1.0
        return (feats, out[1]) if with_features else feats

    monkeypatch.setattr(supcon_step, "two_view_forward", constant_forward)
    monkeypatch.setattr(base, "two_view_forward", constant_forward)
    images = np.random.default_rng(0).integers(0, 256, (64, 8, 8, 3)).astype(np.uint8)
    labels = np.arange(64, dtype=np.int32) % 10
    monkeypatch.setattr(supcon, "load_dataset", lambda *a, **k: (
        {"images": images, "labels": labels}, {"images": images, "labels": labels}, 10))
    argv = ["--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--size", "8",
            "--batch_size", "8", "--epochs", "1", "--feat_dim", "16", "--learning_rate", "0.05",
            "--recipe", "byol", "--byol_predictor", "none", "--health_freq", "1",
            "--health_policy", "abort", "--print_freq", "2", "--workdir", str(tmp_path)]
    with pytest.raises(SystemExit) as exc:
        supcon.main(argv)
    assert exc.value.code == 3
    (events,) = list(tmp_path.rglob("events.jsonl"))
    names = [json.loads(line)["name"] for line in events.read_text().splitlines()]
    assert "run_recipe" in names and "health_alarm" in names
    assert os.path.exists(events)
