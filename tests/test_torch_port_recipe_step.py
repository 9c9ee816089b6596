"""The port's recipe train step and driver against the JAX package's.

- Two ``train_step`` calls of each recipe (byol, byol with
  ``--byol_predictor none``, simsiam, vicreg, simclr with a MoCo queue)
  from one rn10 init on fixed pre-augmented views against the JAX
  package's ``make_train_step(recipe=...)``, with the recipe slots carried
  across (``utils/convert.recipe_slots_from_torch``): the loss and the
  recipe's metric columns at every step (rtol 1e-4), and after the second
  step every encoder parameter and BN buffer, the predictor, the EMA
  network, the queue rows and the pointer (rtol 1e-3, atol 1e-5), the pins
  of ``tests/test_torch_port_step.py``.
- ``ContrastiveRecipe`` (``--recipe simclr``/``supcon``, no queue) against
  the inline step (``state.recipe = None``): bitwise, dense and fused.
- The driver: a run SIGTERM'd between flush boundaries under ``byol`` and
  under the MoCo queue stops at the boundary, and its resume is bitwise
  the straight run (the predictor's momentum, the EMA network, the queue
  and its pointer included); the vicreg columns reach ``history``.
- Two processes over gloo (``tests/torch_parallel_child.py`` suite
  ``recipes``): byol and vicreg steps with ``--syncBN`` at P = 2 against
  one process on the global batch (the predictor's gradient and the
  gathered target rows), under the step pins; and byol under
  ``--loss_impl ring``, which gathers the rows as dense does.
- The preemption vote at flush boundaries only: a gloo pair (the same
  suite) and one process, ``--print_freq 3`` and a signal after step 1,
  stop at step 3 (JAX's boundary) with one vote at the boundary and one
  at the epoch's end, and resume bitwise.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_pytorch_distributed_tpu import config as jax_config
from simclr_pytorch_distributed_tpu import recipes as jax_recipes
from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.ops.schedules import make_lr_schedule as jax_schedule
from simclr_pytorch_distributed_tpu.train import state as jax_state
from simclr_pytorch_distributed_tpu.train import supcon_step as jax_step
from simclr_pytorch_distributed_tpu_torch import config as config_lib
from simclr_pytorch_distributed_tpu_torch import recipes
from simclr_pytorch_distributed_tpu_torch.ops.schedules import make_lr_schedule
from simclr_pytorch_distributed_tpu_torch.recipes import ContrastiveRecipe
from simclr_pytorch_distributed_tpu_torch.train import supcon
from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import SupConStepConfig, train_step
from simclr_pytorch_distributed_tpu_torch.utils import convert, preempt
import torch_parallel_child as child
from torch_threads import limit_threads

limit_threads()

B, SIZE, STEPS, FEAT, HIDDEN = 4, 8, 2, 16, 32
SCHED = dict(learning_rate=0.05, epochs=1, steps_per_epoch=4, cosine=True)
STEP_KW = dict(temperature=0.5, epochs=1, steps_per_epoch=4, grad_div=2.0, loss_impl="dense",
               sec=True, sec_wei=0.5, norm_momentum=0.6)

RECIPE_CASES = {
    "byol": dict(recipe="byol"),
    "byol_none": dict(recipe="byol", byol_predictor="none"),
    "simsiam": dict(recipe="simsiam"),
    "vicreg": dict(recipe="vicreg"),
    "simclr_queue": dict(recipe="simclr", moco_queue=16),
}


def _views():
    rng = np.random.default_rng(11)
    views = [rng.standard_normal((B, 2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(STEPS)]
    return views, rng.integers(0, 3, B).astype(np.int32)


def _tree_allclose(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _tree_allclose(got[k], want[k], f"{where}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-3, atol=1e-5,
                                   err_msg=where)


@pytest.mark.parametrize("case", list(RECIPE_CASES))
def test_two_recipe_steps_match_jax(case):
    over = dict(RECIPE_CASES[case], feat_dim=FEAT, predictor_hidden=HIDDEN, batch_size=B,
                ema_momentum=0.9)
    views, labels = _views()
    # the port: an rn10 init, the recipe and its slots
    torch.manual_seed(5)
    model = child.SupConResNet("resnet10", "mlp", FEAT)
    state = TrainState(model, make_optimizer(model), make_lr_schedule(**SCHED))
    cfg = config_lib.SupConConfig(**over)
    config_lib.validate_recipe(cfg)
    state, recipe = recipes.attach_for_config(cfg, state)
    step_cfg = SupConStepConfig(method=cfg.method, **STEP_KW)

    # the JAX package, from the same weights and slots
    jcfg = jax_config.SupConConfig(**over)
    jax_config.validate_recipe(jcfg)
    schedule = jax_schedule(**SCHED)
    jrecipe = jax_recipes.build_recipe(jcfg, schedule=schedule)
    variables = convert.state_dict_to_variables(model.state_dict())
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = jax_state.make_optimizer(schedule, momentum=0.9, weight_decay=1e-4)
    slots = jax.tree.map(jnp.asarray, convert.recipe_slots_from_torch(
        state.recipe_params, state.recipe_state))
    jstate = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), record_norm_mean=jnp.zeros((), jnp.float32),
        recipe_params=slots.get("recipe_params"),
        recipe_opt_state=(jrecipe.tx.init(slots["recipe_params"])
                          if "recipe_params" in slots else None),
        recipe_state=slots.get("recipe_state"),
    )
    jstep = jax.jit(jax_step.make_train_step(
        JaxSupConResNet(model_name="resnet10", head="mlp", feat_dim=FEAT), tx, schedule,
        jax_step.SupConStepConfig(method=cfg.method, **STEP_KW), recipe=jrecipe))

    for i in range(STEPS):
        m = train_step(state, step_cfg, torch.from_numpy(views[i]), torch.from_numpy(labels))
        jstate, jm = jstep(jstate, jnp.asarray(views[i]), jnp.asarray(labels))
        assert set(m) == set(jm)
        for key in ("loss", "record_norm_mean", "loss_sec", *recipe.metric_keys):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-4,
                                       err_msg=f"{key}, step {i}")
    final = convert.variables_to_state_dict({"params": jstate.params,
                                             "batch_stats": jstate.batch_stats})
    ours = model.state_dict()
    for key, ref in final.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(ours[key].numpy(), ref.numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=key)
    got = convert.recipe_slots_from_torch(state.recipe_params, state.recipe_state)
    if "recipe_params" in got:
        _tree_allclose(got["recipe_params"], jax.device_get(jstate.recipe_params), "predictor")
    if "recipe_state" in got:
        want = jax.device_get(jstate.recipe_state)
        assert set(got["recipe_state"]) == set(want)
        for key in want:
            _tree_allclose(got["recipe_state"][key], want[key], key)
        if "queue_ptr" in want:
            # both steps' keys written: rows 0..2*2B-1 of the queue, pointer wrapped
            assert state.recipe_state["queue_ptr"] == int(want["queue_ptr"]) == 0


@pytest.mark.parametrize("loss_impl", ["dense", "fused"])
@pytest.mark.parametrize("name", ["simclr", "supcon"])
def test_contrastive_recipe_is_the_inline_step_bitwise(name, loss_impl):
    views, labels = _views()
    runs = []
    for recipe in (None, ContrastiveRecipe(name=name, feat_dim=FEAT)):
        torch.manual_seed(5)
        model = child.SupConResNet("resnet10", "mlp", FEAT)
        state = TrainState(model, make_optimizer(model), make_lr_schedule(**SCHED))
        if recipe is not None:
            recipes.attach_recipe_slots(recipe, state, torch.Generator().manual_seed(2))
            assert (state.recipe_params, state.recipe_opt_state, state.recipe_state) == (None,) * 3
        cfg = SupConStepConfig(method="SupCon" if name == "supcon" else "SimCLR",
                               **dict(STEP_KW, loss_impl=loss_impl))
        history = [{k: v.item() for k, v in train_step(
            state, cfg, torch.from_numpy(v), torch.from_numpy(labels)).items()} for v in views]
        runs.append((history, model.state_dict(), state.optimizer.state_dict()["state"]))
    (h0, s0, o0), (h1, s1, o1) = runs
    assert h0 == h1
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    for k in o0:
        assert torch.equal(o0[k]["momentum_buffer"], o1[k]["momentum_buffer"]), k


# -- the driver -------------------------------------------------------------------

DRIVER_ARGV = [
    "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--size", "8",
    "--batch_size", "8", "--learning_rate", "0.05", "--temp", "0.5", "--print_freq", "3",
    "--feat_dim", "16", "--predictor_hidden", "32", "--epochs", "1", "--save_freq", "1",
    "--cosine", "--ema_momentum", "0.9",
]
STEPS_PER_EPOCH = 8  # 64 images / batch 8


def tiny_dataset(dataset, data_folder, **kwargs):
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, 80).astype(np.int32)
    means = rng.uniform(48, 208, (10, 1, 1, 3))
    images = np.clip(means[labels] + rng.normal(0, 32, (80, 8, 8, 3)), 0, 255).astype(np.uint8)
    return ({"images": images[:64], "labels": labels[:64]},
            {"images": images[64:], "labels": labels[64:]}, 10)


def _same_state(got, want):
    for k, v in want.model.state_dict().items():
        assert torch.equal(got.model.state_dict()[k], v), k
    a = convert.recipe_slots_from_torch(got.recipe_params, got.recipe_state)
    b = convert.recipe_slots_from_torch(want.recipe_params, want.recipe_state)
    jax.tree.map(np.testing.assert_array_equal, a, b)
    if want.recipe_opt_state is not None:
        ga, wa = got.recipe_opt_state.state_dict(), want.recipe_opt_state.state_dict()
        for k in wa["state"]:
            assert torch.equal(ga["state"][k]["momentum_buffer"],
                               wa["state"][k]["momentum_buffer"]), k


@pytest.mark.parametrize("extra", [["--recipe", "byol"],
                                   ["--recipe", "simclr", "--moco_queue", "32"]],
                         ids=["byol", "simclr_queue"])
def test_preempted_recipe_run_resumes_bitwise(tmp_path, monkeypatch, extra):
    monkeypatch.setattr(supcon, "load_dataset", tiny_dataset)
    straight = supcon.main(DRIVER_ARGV + extra + ["--workdir", str(tmp_path / "straight")])
    losses = []

    def step(state, cfg, views, labels):
        metrics = train_step(state, cfg, views, labels)
        losses.append(metrics["loss"].item())
        if state.step == 4:  # between the flush boundaries after steps 3 and 6
            preempt.request()
        return metrics

    monkeypatch.setattr(supcon, "train_step", step)
    with pytest.raises(SystemExit) as exc:
        supcon.main(DRIVER_ARGV + extra + ["--workdir", str(tmp_path / "a")])
    assert exc.value.code == 75
    (saved,) = glob.glob(str(tmp_path / "a" / "*" / "*" / "preempt_*.pth"))
    assert os.path.basename(saved) == "preempt_epoch_1_step_6.pth"
    assert "recipe" in torch.load(saved, weights_only=True)
    monkeypatch.setattr(supcon, "train_step", train_step)
    resumed = supcon.main(DRIVER_ARGV + extra + ["--workdir", str(tmp_path / "b"),
                                                 "--resume", os.path.dirname(saved)])
    assert losses + [h["loss"] for h in resumed.history] == [
        h["loss"] for h in straight.history]
    _same_state(resumed.state, straight.state)


def test_vicreg_columns_reach_the_history(tmp_path, monkeypatch):
    monkeypatch.setattr(supcon, "load_dataset", tiny_dataset)
    result = supcon.main(DRIVER_ARGV + ["--recipe", "vicreg", "--workdir", str(tmp_path)])
    assert len(result.history) == STEPS_PER_EPOCH
    for h in result.history:
        assert {"vicreg_inv", "vicreg_var", "vicreg_cov"} <= set(h)
        assert all(np.isfinite(h[k]) for k in ("vicreg_inv", "vicreg_var", "vicreg_cov"))
    log = open(os.path.join(result.save_folder, "log-ing")).read()
    assert "recipe: vicreg" in log


# -- data parallel ------------------------------------------------------------------


@pytest.fixture(scope="module")
def recipe_ranks(tmp_path_factory):
    return child.spawn(2, str(tmp_path_factory.mktemp("recipes_p2")), "recipes")


@pytest.mark.parametrize("name", child.RECIPE_STEP_CASES)
def test_two_processes_equal_one_on_the_global_batch(recipe_ranks, name):
    want = child.recipe_case(name, 0, 1, distributed=False)
    for rank, out in enumerate(recipe_ranks):
        got = out[name]
        assert got["same_on_every_rank"], rank
        for g, w in zip(got["history"], want["history"]):
            for key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-6,
                                           err_msg=f"{name} rank {rank} {key}")
        for part in ("state", "slots"):
            for key, ref in want[part].items():
                np.testing.assert_allclose(got[part][key].numpy(), ref.numpy(), rtol=1e-3,
                                           atol=1e-5, err_msg=f"{name} rank {rank} {key}")


# -- the preemption vote at flush boundaries ------------------------------------------


def test_one_process_votes_at_flush_boundaries_only(tmp_path, monkeypatch):
    monkeypatch.setattr(supcon, "load_dataset", child.tiny_dataset)
    out = child.boundary_preempt_case(0, 1, str(tmp_path))
    assert out["preempt_code"] == 75 and out["saved"] == ["preempt_epoch_1_step_3.pth"]
    assert out["votes"] == 1  # at the boundary after step 3; none after steps 1 and 2
    assert out["straight_votes"] == 2  # the boundary after step 3 and the epoch's end
    assert out["resumed_losses"] == out["straight_losses"]
    assert out["resumed_equal"]


def test_two_processes_vote_at_flush_boundaries_only(recipe_ranks):
    for out in (ranks["preempt_boundary"] for ranks in recipe_ranks):
        assert out["preempt_code"] == 75 and out["saved"] == ["preempt_epoch_1_step_3.pth"]
        assert out["votes"] == 1 and out["straight_votes"] == 2
        assert out["resumed_losses"] == out["straight_losses"]
        assert out["resumed_equal"]
