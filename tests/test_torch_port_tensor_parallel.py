"""The port's tensor parallelism (``--model_parallel``) over gloo on the CPU.

One module-scoped spawn per world size W in {2, 3, 4} runs the ``tp`` suite
of ``tests/torch_parallel_child.py``: W = 2 is one model group (data 1 x
model 2), W = 4 is data 2 x model 2, and W = 3 is one model group of 3 with
a 96-wide head, where every encoder width fails ``% 3`` and stays
replicated while the head's last linear is sharded and reads the whole
hidden layer (a replicated tensor that carries a gradient into a sharded
layer). The tests compare what the processes computed:

- the sharding rule (``parallel/mesh.tp_shard_dim``) against the JAX
  package's ``tp_leaf_spec`` over every leaf of the rn10 and rn50 trees
  mapped through the weight bridge, and JAX's own four cases
  (``tests/test_distributed.py:265-268``); the grid's layout and groups; the
  ``W % N`` error; the probe and CE parsers rejecting the flag, and the
  recipes refused under it;
- the tensor-parallel step against the JAX package's one-device step from
  the same converted weights: the dense loss at JAX's pins (loss rtol
  2e-5; parameters rtol 1e-3, atol 2e-5; ``test_distributed.py:287-291``),
  the fused loss (its plain form on the CPU) at JAX's fused pins (loss
  rtol 2e-5, parameters atol 5e-3; ``:322-328``) and the ring at W = 4
  (``:350-354``), each with ``--syncBN`` and without (JAX's
  ``bn_local_groups`` = the data-parallel size);
- LARS against the one-process LARS step; each rank's parameters, BN
  buffers and momentum against its slice of the one-process step's; the
  health gradient norm against the one-process one;
- the driver: its save at N = 2 whole and within the driver pins of the
  N = 1 run's, and a resume from each into the other;
- at ``--model_parallel 1`` the data-parallel step bitwise the one without
  a grid.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_child as child
from simclr_pytorch_distributed_tpu import config as jax_config
from simclr_pytorch_distributed_tpu import recipes as jax_recipes
from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.ops.schedules import (
    make_lr_schedule as jax_make_lr_schedule,
)
from simclr_pytorch_distributed_tpu.parallel.mesh import tp_leaf_spec
from simclr_pytorch_distributed_tpu.train import state as jax_state
from simclr_pytorch_distributed_tpu.train import supcon_step as jax_step
from simclr_pytorch_distributed_tpu_torch import config as config_lib
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
from simclr_pytorch_distributed_tpu_torch.models.heads import PredictorHead
from simclr_pytorch_distributed_tpu_torch.parallel import mesh
from simclr_pytorch_distributed_tpu_torch.utils import checkpoint, convert
from simclr_pytorch_distributed_tpu_torch.utils.convert import (
    state_dict_to_variables,
    variables_to_shard_state_dict,
    variables_to_state_dict,
)
from torch_threads import limit_threads

limit_threads()

WORLDS = (2, 4)
N = child.TP
# (world, --model_parallel, feat_dim) of every spawn
LAYOUTS = [(w,) + child.tp_layout(w) for w in (2, 3, 4)]
STEP_LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-5, 1e-3, 2e-5  # test_distributed.py:287-291
FUSED_PARAM_ATOL = 5e-3  # test_distributed.py:322-328, :350-354
HEALTH_RTOL = 1e-4  # PERF.md §2: health within 1e-4 of the one-process reading
DRIVER_REL_L2 = 5e-2  # test_torch_port_parallel.py's driver pin
RESUME_REL_L2 = 1e-4  # a resume against the straight run it continues
# a momentum buffer is a step's update over lr, held per tensor as
# chip_smoke.py holds an update (STEP_UPDATE_REL_L2): elementwise it reads
# the step's fp32 conditioning (one process at 1 and 8 threads already
# differs by 6e-3 relative L2 on the SupCon case's momentum)
MOMENTUM_REL_L2 = 5e-2


@pytest.fixture(scope="module", autouse=True)
def started(request, tmp_path_factory):
    """The three spawns, started together as the module begins when any of
    its selected tests reads them, so they overlap each other and the
    in-process tests: ``{W: (processes, outdir)}``."""
    wanted = any("results" in item.fixturenames for item in request.session.items
                 if item.module is request.module)
    procs = {}
    if wanted:
        for world, _, _ in LAYOUTS:
            outdir = tmp_path_factory.mktemp(f"tp{world}")
            procs[world] = (child.start(world, outdir, "tp"), outdir)
    yield procs
    for group, _ in procs.values():
        for proc in group:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture(scope="module")
def results(started):
    """``results(W)``: the W processes' tp-suite results."""
    spawned = {}

    def get(world):
        if world not in spawned:
            group, outdir = started[world]
            spawned[world] = child.collect(group, outdir)
            for r in range(world):  # read: ~0.1-0.3 GB a rank on disk
                (outdir / f"rank{r}.pt").unlink()
        return spawned[world]

    return get


@pytest.fixture(scope="module")
def reference():
    """``reference(name)``: the one-process port step of a tp case (whole
    model, global batch, no process group) on one thread, as each child
    runs, once per case."""
    done = {}

    def get(name, feat=child.FEAT):
        if (name, feat) not in done:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)  # the children's reduction order
            try:
                done[(name, feat)] = child.tp_step_case(name, False, feat)
            finally:
                torch.set_num_threads(threads)
        return done[(name, feat)]

    return get


def jax_steps(groups, method, feat=child.FEAT):
    """The JAX package's one-device step over the global batches from the
    step cases' init: ``(losses, final torch-layout state dict)``; groups >
    1: per-device BN (``bn_local_groups``)."""
    views, labels = child.step_inputs()
    variables = state_dict_to_variables(child.init_model(feat).state_dict())
    jmodel = JaxSupConResNet(model_name="resnet10", head="mlp", feat_dim=feat,
                             sync_bn=groups == 1, bn_local_groups=groups, bn_group_views=2)
    schedule = jax_make_lr_schedule(**child.SCHED)
    tx = jax_state.make_optimizer(schedule, momentum=0.9, weight_decay=1e-4)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), record_norm_mean=jnp.zeros((), jnp.float32),
    )
    step = jax.jit(jax_step.make_train_step(
        jmodel, tx, schedule,
        jax_step.SupConStepConfig(method=method, loss_impl="dense", **child.STEP_KW),
    ))
    losses = []
    for i in range(child.STEPS):
        jstate, m = step(jstate, jnp.asarray(views[i].numpy()), jnp.asarray(labels.numpy()))
        losses.append(float(m["loss"]))
    return losses, variables_to_state_dict({"params": jstate.params,
                                            "batch_stats": jstate.batch_stats})


@pytest.fixture(scope="module")
def jax_reference():
    done = {}

    def get(groups, method, feat=child.FEAT):
        if (groups, method, feat) not in done:
            done[(groups, method, feat)] = jax_steps(groups, method, feat)
        return done[(groups, method, feat)]

    return get


@functools.lru_cache(maxsize=None)
def whole_shapes(feat):
    return {k: tuple(v.shape) for k, v in SupConResNet("resnet10", "mlp", feat)
            .state_dict().items()}


def assemble(ranks, case, key="state", n=N, feat=child.FEAT):
    """A step case's whole tensors from the shards of data slice 0 (``n``
    model shards, a ``feat``-wide head)."""
    out = {}
    for k, first in ranks[0]["step"][case][key].items():
        parts = [r["step"][case][key][k] for r in ranks[:n]]
        out[k] = torch.cat(parts) if mesh.tp_shard_dim(whole_shapes(feat)[k], n) == 0 else first
    return out


def assert_close_state(got, want, atol=PARAM_ATOL, rtol=PARAM_RTOL):
    for key, ref in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].numpy(), ref.numpy(), rtol=rtol, atol=atol,
                                   err_msg=key)


def rel_l2(got, want):
    num = sum(float(((got[k].double() - v.double()) ** 2).sum()) for k, v in want.items()
              if not k.endswith("num_batches_tracked"))
    den = sum(float((v.double() ** 2).sum()) for k, v in want.items()
              if not k.endswith("num_batches_tracked"))
    return (num / den) ** 0.5


# -- the sharding rule, the grid, the flags (this process) -------------------

def leaf_shapes(model_name):
    """Each port state-dict key's shape beside the shape of the JAX leaf the
    weight bridge maps it to (found by filling each tensor with its index)."""
    sd = {k: v for k, v in SupConResNet(model_name, "mlp", 128).state_dict().items()
          if not k.endswith("num_batches_tracked")}
    keys = list(sd)
    marked = {k: torch.full_like(v, float(i)) for i, (k, v) in enumerate(sd.items())}
    pairs = {}
    for leaf in jax.tree.leaves(state_dict_to_variables(marked)):
        leaf = np.asarray(leaf)
        key = keys[int(leaf.reshape(-1)[0])]
        pairs[key] = (tuple(sd[key].shape), leaf.shape)
    assert len(pairs) == len(keys)
    return pairs


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("model_name", ("resnet10", "resnet50"))
def test_tp_shard_dim_matches_jax_tp_leaf_spec(model_name, n):
    pairs = leaf_shapes(model_name)
    sharded = 0
    for key, (port_shape, jax_shape) in pairs.items():
        jax_sharded = tp_leaf_spec(jax_shape, n) != P()
        assert (mesh.tp_shard_dim(port_shape, n) == 0) == jax_sharded, key
        sharded += jax_sharded
    assert sharded > 0


# JAX's cases (test_distributed.py:265-268) with their port shapes: conv HWIO
# (3, 3, 64, 128) is OIHW (128, 64, 3, 3); Dense [2048, 8] is Linear [8, 2048]
@pytest.mark.parametrize("port_shape,jax_shape,n", [
    ((128, 64, 3, 3), (3, 3, 64, 128), 4),
    ((130,), (130,), 4),
    ((8, 2048), (2048, 8), 4),
    ((64,), (64,), 1),
])
def test_tp_shard_dim_on_jax_cases(port_shape, jax_shape, n):
    assert (mesh.tp_shard_dim(port_shape, n) == 0) == (tp_leaf_spec(jax_shape, n) != P())


def test_grid_layout_at_world_4():
    model_groups, data_groups = mesh.grid_layout(4, 2)
    assert model_groups == [[0, 1], [2, 3]]
    assert data_groups == [[0, 2], [1, 3]]


@pytest.mark.parametrize("world,n", [(4, 3), (2, 4), (6, 4)])
def test_grid_rejects_an_indivisible_world(world, n):
    with pytest.raises(ValueError, match=f"{world} processes not divisible by "
                                         f"model_parallel={n}"):
        mesh.grid_layout(world, n)


@pytest.mark.parametrize("ce", (False, True))
def test_probe_and_ce_parsers_reject_model_parallel(ce):
    argv = ["--dataset", "synthetic", "--model_parallel", "2"]
    with pytest.raises(SystemExit):
        config_lib.linear_parser(ce=ce).parse_args(argv)


def test_pretrain_parser_takes_model_parallel():
    assert config_lib.parse_supcon(["--dataset", "synthetic"]).model_parallel == 1
    assert config_lib.parse_supcon(["--dataset", "synthetic", "--model_parallel",
                                    "2"]).model_parallel == 2
    with pytest.raises(SystemExit):
        config_lib.supcon_parser().parse_args(["--model_parallel", "0"])


@pytest.mark.parametrize("extra", [["--recipe", "byol"], ["--recipe", "simsiam"],
                                   ["--recipe", "vicreg"], ["--moco_queue", "512"]])
def test_pretrain_parser_takes_every_recipe_under_model_parallel(extra):
    cfg = config_lib.parse_supcon(["--dataset", "synthetic", "--model_parallel", "2"] + extra)
    assert cfg.model_parallel == 2
    assert (cfg.recipe, cfg.moco_queue) == ((extra[1], 0) if extra[0] == "--recipe"
                                            else ("simclr", 512))


@pytest.mark.parametrize("loss_impl", ["fused", "ring"])
def test_moco_queue_takes_the_dense_loss_only_under_model_parallel(loss_impl):
    argv = ["--dataset", "synthetic", "--model_parallel", "2", "--moco_queue", "512"]
    with pytest.raises(ValueError, match="--loss_impl dense"):
        config_lib.parse_supcon(argv + ["--loss_impl", loss_impl])
    assert config_lib.parse_supcon(argv + ["--loss_impl", "auto"]).loss_impl == "auto"


@pytest.mark.parametrize("index", range(N))
def test_converted_shards_are_shard_modules(index):
    torch.manual_seed(3)
    model = SupConResNet("resnet10", "mlp", 128)
    variables = state_dict_to_variables(model.state_dict())
    layout = mesh.shard_module(model, N, index)
    got = variables_to_shard_state_dict(variables, N, index)
    want = model.state_dict()
    assert set(got) == set(want) and layout
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        if k in layout:
            assert tuple(layout[k])[0] == v.shape[0] * N
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


# -- the processes ---------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_grid_indices_and_groups(results, world):
    model_groups, data_groups = mesh.grid_layout(world, N)
    for r, out in enumerate(results(world)):
        g = out["grid"]
        assert (g["data_index"], g["model_index"]) == (r // N, r % N)
        assert (g["data_parallel"], g["model_parallel"]) == (world // N, N)
        assert g["model_group"] == model_groups[r // N]
        assert g["data_group"] == data_groups[r % N]


DENSE_CASES = ("sync_dense_supcon", "local_dense_simclr")
FUSED_CASES = ("sync_fused_simclr", "local_fused_simclr")


def jax_groups(world, case):
    return 1 if child.TP_STEP_CASES[case][0] else world // N


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", DENSE_CASES)
def test_tp_step_matches_jax(results, jax_reference, world, case):
    ranks = results(world)
    losses, final = jax_reference(jax_groups(world, case), child.TP_STEP_CASES[case][2])
    np.testing.assert_allclose(ranks[0]["step"][case]["losses"], losses, rtol=STEP_LOSS_RTOL)
    assert_close_state(assemble(ranks, case), final)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", FUSED_CASES)
def test_tp_fused_loss_matches_the_dense_jax_step(results, jax_reference, world, case):
    ranks = results(world)
    losses, final = jax_reference(jax_groups(world, case), "SimCLR")
    np.testing.assert_allclose(ranks[0]["step"][case]["losses"], losses, rtol=STEP_LOSS_RTOL)
    assert_close_state(assemble(ranks, case), final, atol=FUSED_PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("case", child.TP_RING_CASES)
def test_tp_ring_loss_matches_the_dense_jax_step(results, jax_reference, case):
    ranks = results(4)
    losses, final = jax_reference(jax_groups(4, case), "SimCLR")
    np.testing.assert_allclose(ranks[0]["step"][case]["losses"], losses, rtol=STEP_LOSS_RTOL)
    assert_close_state(assemble(ranks, case), final, atol=FUSED_PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_tp_lars_step_matches_one_process(results, reference, world):
    case = "sync_dense_lars_simclr"
    ref = reference(case)
    ranks = results(world)
    np.testing.assert_allclose(ranks[0]["step"][case]["losses"], ref["losses"],
                               rtol=STEP_LOSS_RTOL)
    assert_close_state(assemble(ranks, case), ref["state"])


def slice_cases(world):
    """Cases whose one-process step is the grid's: every case at data 1,
    the --syncBN ones at data 2."""
    return [(world, c) for c in child.tp_cases(world)
            if world == 2 or child.TP_STEP_CASES[c][0]]


@pytest.mark.parametrize("world,case", slice_cases(2) + slice_cases(4))
@pytest.mark.parametrize("key", ("state", "momentum"))
def test_each_rank_holds_its_slice_of_the_one_process_step(results, reference, world, case,
                                                           key):
    ref = reference(case)[key]
    for r, out in enumerate(results(world)):
        got = out["step"][case][key]
        assert set(got) == set(ref)
        sliced = {k: mesh.shard_of(v, N, r % N) if v.dim() else v for k, v in ref.items()}
        for k, v in got.items():
            assert tuple(v.shape) == tuple(sliced[k].shape), k
        if key == "state":
            assert_close_state(got, sliced)
        else:
            for k, v in sliced.items():
                assert rel_l2({k: got[k]}, {k: v}) < MOMENTUM_REL_L2, k


@pytest.mark.parametrize("world,case", slice_cases(2) + slice_cases(4))
def test_health_grad_norm_is_the_whole_models(results, reference, world, case):
    want = reference(case)["grad_norms"]
    for out in results(world):
        np.testing.assert_allclose(out["step"][case]["grad_norms"], want, rtol=HEALTH_RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_of_a_model_index_hold_the_same_shards(results, world):
    ranks = results(world)
    for case in child.tp_cases(world):
        for r, out in enumerate(ranks):
            mine = out["step"][case]
            assert mine["losses"] == ranks[0]["step"][case]["losses"], (case, r)
            twin = ranks[r % N]["step"][case]["state"]
            for k, v in mine["state"].items():
                assert torch.equal(v, twin[k]), (case, r, k)


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_of_a_step_by_group(results, world):
    """Two steps of the fused --syncBN case, the same on every rank: each
    model-group gather has a backward reduce-scatter but one a step, the
    input of the head's last linear, which is replicated at feat_dim 16 <
    64; the model group's one all-reduce a step is the health gradient
    norm's. The data group carries the BN sums and the gradient mean only
    when it holds more than one slice."""
    ranks = results(world)
    spent = ranks[0]["collectives"]
    assert all({k: v[:2] for k, v in r["collectives"].items()}
               == {k: v[:2] for k, v in spent.items()} for r in ranks)
    # rn10: 8 gathers in the blocks and 2 in the head a step
    assert spent["all_gather@model"][0] == 10 * child.STEPS
    assert spent["reduce_scatter@model"][0] == 9 * child.STEPS
    assert spent["all_reduce@model"][0] == child.STEPS
    # a reduce-scatter's input is its gather's output
    assert spent["reduce_scatter@model"][1] < spent["all_gather@model"][1]
    assert spent["all_gather@model"][1] > 0
    data_keys = {k for k in spent if k.endswith("@data")}
    if world == 2:
        assert not data_keys
    else:
        assert {"all_reduce@data", "all_gather@data"} <= data_keys


# -- W = 3: replicated encoder layers before a sharded head layer ----------

MIXED_WORLD, MIXED_N, MIXED_FEAT = LAYOUTS[1]


def test_mixed_layout_grid_and_sharding(results):
    """At N = 3 no rn10 width is sharded, and of the head only its 96-wide
    output layer is."""
    model = SupConResNet("resnet10", "mlp", MIXED_FEAT)
    sharded = {k for k, v in model.state_dict().items()
               if mesh.tp_shard_dim(tuple(v.shape), MIXED_N) == 0}
    assert sharded == {"head.2.weight", "head.2.bias"}
    for r, out in enumerate(results(MIXED_WORLD)):
        assert (out["grid"]["model_index"], out["grid"]["data_parallel"]) == (r, 1)


def test_mixed_layout_step_matches_jax(results, jax_reference):
    """The gradient a sharded layer gives its whole input is summed over
    the model group (``collectives.reduce_grad``): without that sum each
    rank's replicated encoder takes its own partial gradient."""
    case = "sync_dense_supcon"
    ranks = results(MIXED_WORLD)
    losses, final = jax_reference(1, child.TP_STEP_CASES[case][2], MIXED_FEAT)
    np.testing.assert_allclose(ranks[0]["step"][case]["losses"], losses, rtol=STEP_LOSS_RTOL)
    assert_close_state(assemble(ranks, case, n=MIXED_N, feat=MIXED_FEAT), final)


@pytest.mark.parametrize("case", child.TP_MIXED_CASES)
def test_mixed_layout_replicated_leaves_agree_across_the_model_group(results, case):
    ranks = results(MIXED_WORLD)
    replicated = {k for k, shape in whole_shapes(MIXED_FEAT).items()
                  if mesh.tp_shard_dim(shape, MIXED_N) is None}
    assert len(replicated) > 50
    for key in ("state", "momentum"):
        first = ranks[0]["step"][case][key]
        for r in range(1, MIXED_N):
            for k, v in ranks[r]["step"][case][key].items():
                if k in replicated:
                    assert torch.equal(v, first[k]), (case, key, r, k)


@pytest.mark.parametrize("case", child.TP_MIXED_CASES)
@pytest.mark.parametrize("key", ("state", "momentum"))
def test_mixed_layout_ranks_hold_their_slices_of_the_one_process_step(
        results, reference, case, key):
    ref = reference(case, MIXED_FEAT)
    np.testing.assert_allclose(results(MIXED_WORLD)[0]["step"][case]["losses"], ref["losses"],
                               rtol=STEP_LOSS_RTOL)
    for r, out in enumerate(results(MIXED_WORLD)):
        got = out["step"][case][key]
        sliced = {k: mesh.shard_of(v, MIXED_N, r) if v.dim() else v
                  for k, v in ref[key].items()}
        if key == "state":
            assert_close_state(got, sliced)
        else:
            for k, v in sliced.items():
                assert rel_l2({k: got[k]}, {k: v}) < MOMENTUM_REL_L2, k
        np.testing.assert_allclose(out["step"][case]["grad_norms"], ref["grad_norms"],
                                   rtol=HEALTH_RTOL)


def test_mixed_layout_collectives_of_a_step(results):
    """A step at N = 3 (the dense SupCon case, counted): the head's output
    gathered whole for the loss, its hidden layer's gradient summed over
    the model group, and the health norm's all-reduce; nothing
    reduce-scattered (no sharded layer reads a slice)."""
    spent = results(MIXED_WORLD)[0]["collectives"]
    assert spent["all_gather@model"][0] == child.STEPS
    assert spent["all_reduce@model"][0] == 2 * child.STEPS
    assert "reduce_scatter@model" not in spent


def test_a_grid_of_one_model_shard_is_bitwise_the_data_parallel_step(results):
    for out in results(2):
        before, after = out["n1"]["before"], out["n1"]["after"]
        assert before["history"] == after["history"]
        for k, v in before["state"].items():
            assert torch.equal(after["state"][k], v), k


def test_tp_driver_saves_whole_tensors_near_the_one_shard_run(results):
    runs = results(2)[0]["driver"]
    assert runs["n2"]["code"] == runs["n1"]["code"] == 0
    tp, plain = runs["n2"]["last"], runs["n1"]["last"]
    assert tp["opt"]["model_parallel"] == 2 and plain["opt"]["model_parallel"] == 1
    for part in ("model",):
        assert {k: tuple(v.shape) for k, v in tp[part].items()} == {
            k: tuple(v.shape) for k, v in plain[part].items()}
    for i, entry in plain["optimizer"]["state"].items():
        assert tp["optimizer"]["state"][i]["momentum_buffer"].shape == \
            entry["momentum_buffer"].shape
    np.testing.assert_allclose(runs["n2"]["losses"], runs["n1"]["losses"], rtol=STEP_LOSS_RTOL)
    assert rel_l2(tp["model"], plain["model"]) < DRIVER_REL_L2


@pytest.mark.parametrize("src,dst", [(2, 1), (1, 2)])
def test_tp_driver_resumes_across_model_parallel(results, src, dst):
    runs = results(2)[0]["driver"]
    resumed, straight = runs[f"resume_{src}_{dst}"], runs[f"n{src}"]
    assert resumed["code"] == 0
    assert resumed["last"]["opt"]["model_parallel"] == dst
    steps = len(resumed["losses"])
    np.testing.assert_allclose(resumed["losses"], straight["losses"][-steps:],
                               rtol=STEP_LOSS_RTOL)
    assert rel_l2(resumed["last"]["model"], straight["last"]["model"]) < RESUME_REL_L2


# -- the recipes under --model_parallel -------------------------------------

RECIPE_METRIC_RTOL = 1e-4  # test_torch_port_recipe_step.py's pins
RECIPE_RTOL, RECIPE_ATOL = 1e-3, 1e-5
RECIPE_WORLDS = [(w, name) for w in WORLDS for name in child.TP_RECIPE_CASES]
# the one documented exception to the sharding rule: the MoCo queue is
# whole and replicated over the model group (JAX shards its feature axis)
WHOLE_SLOTS = ("queue_emb", "queue_ptr")
RECIPE_DRIVER_EPOCH = 4  # steps: the 64-image set at batch 16


def jax_recipe_steps(name, feat=child.FEAT):
    """The JAX package's one-device ``make_train_step(recipe=...)`` over the
    global batches from the recipe case's converted init (``--syncBN``):
    ``(history, final state dict, final slots by the children's names)``."""
    variables, slots = child.tp_recipe_init(name, feat)
    over = dict(child.TP_RECIPE_CASES[name], feat_dim=feat, batch_size=child.B,
                predictor_hidden=child.TP_RECIPE_HIDDEN, ema_momentum=child.TP_RECIPE_EMA)
    jcfg = jax_config.SupConConfig(**over)
    jax_config.validate_recipe(jcfg)
    schedule = jax_make_lr_schedule(**child.SCHED)
    jrecipe = jax_recipes.build_recipe(jcfg, schedule=schedule)
    tx = jax_state.make_optimizer(schedule, momentum=0.9, weight_decay=1e-4)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jslots = jax.tree.map(jnp.asarray, slots)
    jstate = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), record_norm_mean=jnp.zeros((), jnp.float32),
        recipe_params=jslots.get("recipe_params"),
        recipe_opt_state=(jrecipe.tx.init(jslots["recipe_params"])
                          if "recipe_params" in jslots else None),
        recipe_state=jslots.get("recipe_state"),
    )
    jmodel = JaxSupConResNet(model_name="resnet10", head="mlp", feat_dim=feat, sync_bn=True,
                             bn_local_groups=1, bn_group_views=2)
    step = jax.jit(jax_step.make_train_step(
        jmodel, tx, schedule,
        jax_step.SupConStepConfig(method="SimCLR", loss_impl="dense", **child.STEP_KW),
        recipe=jrecipe))
    views, labels = child.step_inputs()
    history = []
    for i in range(child.STEPS):
        jstate, m = step(jstate, jnp.asarray(views[i].numpy()), jnp.asarray(labels.numpy()))
        history.append({k: float(v) for k, v in m.items() if np.ndim(v) == 0})
    final = variables_to_state_dict({"params": jstate.params,
                                     "batch_stats": jstate.batch_stats})
    got = convert.recipe_slots_to_torch(
        *jax.device_get((jstate.recipe_params, jstate.recipe_state)))
    flat = {f"predictor.{k}": v for k, v in got.get("recipe_params", {}).items()}
    for key, value in got.get("recipe_state", {}).items():
        if isinstance(value, dict):
            flat.update({f"{key}.{k}": v for k, v in value.items()})
        else:
            flat[key] = torch.as_tensor(value)
    return history, final, flat


@pytest.fixture(scope="module")
def jax_recipe_reference():
    done = {}

    def get(name, feat=child.FEAT):
        if (name, feat) not in done:
            done[(name, feat)] = jax_recipe_steps(name, feat)
        return done[(name, feat)]

    return get


@pytest.fixture(scope="module")
def recipe_reference():
    """``recipe_reference(name)``: the one-process port recipe case on one
    thread, as each child runs."""
    done = {}

    def get(name, feat=child.FEAT):
        if (name, feat) not in done:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                done[(name, feat)] = child.tp_recipe_case(name, False, feat)
            finally:
                torch.set_num_threads(threads)
        return done[(name, feat)]

    return get


def assemble_whole(ranks, name, whole, key, n):
    """A recipe case's whole tensors from data slice 0's ``n`` ranks: a
    tensor of its whole shape (``whole``) as rank 0 holds it, a shard
    concatenated over the model group."""
    out = {}
    for k, ref in whole.items():
        parts = [r["recipe"][name][key][k] for r in ranks[:n]]
        out[k] = parts[0] if tuple(parts[0].shape) == tuple(ref.shape) else torch.cat(parts)
    return out


def expected_shard(k, v, n, index):
    return v if k in WHOLE_SLOTS or not v.dim() else mesh.shard_of(v, n, index)


def check_recipe_against_jax(ranks, name, jax_ref, one_process, n, feat):
    history, final, slots = jax_ref
    recipe_keys = child.recipes.recipe_metric_keys(child.TP_RECIPE_CASES[name]["recipe"])
    for r, out in enumerate(ranks):
        for step, (got, want) in enumerate(zip(out["recipe"][name]["history"], history)):
            for key in ("loss", "record_norm_mean", "loss_sec", *recipe_keys):
                np.testing.assert_allclose(got[key], want[key], rtol=RECIPE_METRIC_RTOL,
                                           err_msg=f"{name} rank {r} step {step} {key}")
    state = assemble_whole(ranks, name, one_process["state"], "state", n)
    assert_close_state(state, final, atol=RECIPE_ATOL, rtol=RECIPE_RTOL)
    got = assemble_whole(ranks, name, one_process["slots"], "slots", n)
    assert {k for k in got if not k.startswith("predictor_momentum.")} == set(slots)
    for k, want in slots.items():
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=RECIPE_RTOL,
                                   atol=RECIPE_ATOL, err_msg=f"{name} {k}")


@pytest.mark.parametrize("world,name", RECIPE_WORLDS)
def test_tp_recipe_step_matches_the_jax_recipe_step(results, jax_recipe_reference,
                                                    recipe_reference, world, name):
    check_recipe_against_jax(results(world), name, jax_recipe_reference(name),
                             recipe_reference(name), N, child.FEAT)


@pytest.mark.parametrize("world,name", RECIPE_WORLDS)
def test_each_rank_holds_its_slice_of_the_one_process_recipe_step(results, recipe_reference,
                                                                  world, name):
    ref = recipe_reference(name)
    for r, out in enumerate(results(world)):
        case = out["recipe"][name]
        assert case["init_is_converted"], r
        np.testing.assert_allclose([h["loss"] for h in case["history"]],
                                   [h["loss"] for h in ref["history"]], rtol=STEP_LOSS_RTOL)
        for key in ("state", "slots"):
            sliced = {k: expected_shard(k, v, N, r % N) for k, v in ref[key].items()}
            got = case[key]
            assert set(got) == set(sliced), key
            for k, v in sliced.items():
                assert tuple(got[k].shape) == tuple(v.shape), k
            if key == "state":
                assert_close_state(got, sliced)
                continue
            for k, v in sliced.items():
                if k.startswith("predictor_momentum."):
                    assert rel_l2({k: got[k]}, {k: v}) < MOMENTUM_REL_L2, k
                else:
                    np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=PARAM_RTOL,
                                               atol=PARAM_ATOL, err_msg=f"{name} rank {r} {k}")
        sharded = {k for k, v in case["slots"].items() if v.shape != ref["slots"][k].shape}
        # the predictor (fc1, its normalization) and the EMA network are
        # really sharded; vicreg has no slot
        assert bool(sharded) == (name != "vicreg") and not sharded & set(WHOLE_SLOTS), name


@pytest.mark.parametrize("world", WORLDS)
def test_the_queue_is_whole_and_the_same_on_every_rank(results, world):
    """K = 64 at N = 2 passes the dim-0 rule, which would split the queue by
    rows: nothing reads the rule for it, and every rank holds it whole."""
    k = child.TP_RECIPE_CASES["simclr_queue"]["moco_queue"]
    assert mesh.tp_shard_dim((k, child.FEAT), N) == 0
    ranks = results(world)
    first = ranks[0]["recipe"]["simclr_queue"]["slots"]
    assert tuple(first["queue_emb"].shape) == (k, child.FEAT)
    for out in ranks:
        slots = out["recipe"]["simclr_queue"]["slots"]
        for key in WHOLE_SLOTS:
            assert torch.equal(slots[key], first[key]), key


def test_mixed_layout_byol_matches_jax(results, jax_recipe_reference, recipe_reference):
    """N = 3 with the 96-wide head: the predictor's 128-wide hidden layer
    fails % 3 and stays replicated, and its sharded fc2 reads that whole
    hidden layer, which carries a gradient (``collectives.reduce_grad``)."""
    name = "byol"
    ranks = results(MIXED_WORLD)
    one = recipe_reference(name, MIXED_FEAT)
    # the replicated leaves (the encoder, the predictor's fc1 and norm) stay
    # bitwise equal over the model group: without the summed gradient each
    # rank's would take its own share
    for key in ("state", "slots"):
        first = ranks[0]["recipe"][name][key]
        for r in range(1, MIXED_N):
            for k, v in ranks[r]["recipe"][name][key].items():
                if v.shape == one[key][k].shape and k not in WHOLE_SLOTS:
                    assert torch.equal(v, first[k]), (key, r, k)
    check_recipe_against_jax(ranks, name, jax_recipe_reference(name, MIXED_FEAT), one,
                             MIXED_N, MIXED_FEAT)
    shapes = {k: tuple(v.shape) for k, v in ranks[0]["recipe"][name]["slots"].items()}
    assert shapes["predictor.fc2.weight"] == (MIXED_FEAT // MIXED_N, child.TP_RECIPE_HIDDEN)
    assert shapes["predictor.fc1.weight"] == (child.TP_RECIPE_HIDDEN, MIXED_FEAT)
    assert shapes["predictor.bn_scale"] == (child.TP_RECIPE_HIDDEN,)
    for r, out in enumerate(ranks):
        got = out["recipe"][name]["slots"]
        for k, v in one["slots"].items():
            want = expected_shard(k, v, MIXED_N, r)
            if not k.startswith("predictor_momentum."):
                np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=PARAM_RTOL,
                                           atol=PARAM_ATOL, err_msg=f"rank {r} {k}")


def slot_leaf_shapes(hidden, feat):
    """Each port recipe-slot tensor's shape beside the shape of the JAX slot
    leaf the bridge maps it to: a BYOL predictor and target, and a queue's
    key encoder (filled with each tensor's index, as :func:`leaf_shapes`)."""
    torch.manual_seed(3)
    model = SupConResNet("resnet10", "mlp", feat)
    state = child.TrainState(model, child.make_optimizer(model),
                             child.make_lr_schedule(**child.SCHED))
    pairs = {}
    for over in (dict(recipe="byol"), dict(recipe="simclr", moco_queue=64)):
        offset = len(pairs)
        cfg = config_lib.SupConConfig(**over, feat_dim=feat, predictor_hidden=hidden,
                                      batch_size=child.B)
        child.recipes.attach_for_config(cfg, state)
        mods = {"predictor": state.recipe_params} if state.recipe_params is not None else {}
        mods.update((k, v) for k, v in state.recipe_state.items()
                    if isinstance(v, torch.nn.Module))
        tensors = [(f"{m}.{k}", p) for m, mod in mods.items() for k, p in mod.named_parameters()]
        with torch.no_grad():
            for i, (_, p) in enumerate(tensors):
                p.fill_(float(offset + i))
        trees = convert.recipe_slots_from_torch(state.recipe_params, {
            k: v for k, v in state.recipe_state.items() if isinstance(v, torch.nn.Module)})
        for leaf in jax.tree.leaves(trees):
            leaf = np.asarray(leaf)
            key, p = tensors[int(leaf.reshape(-1)[0]) - offset]
            pairs[key] = (tuple(p.shape), leaf.shape)
    return pairs


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("hidden,feat", [(128, 16), (512, 128)])
def test_tp_shard_dim_of_the_recipe_slots_matches_jax_tp_leaf_spec(hidden, feat, n):
    pairs = slot_leaf_shapes(hidden, feat)
    assert {k.split(".")[0] for k in pairs} == {"predictor", "target", "key"}
    sharded = set()
    for key, (port_shape, jax_shape) in pairs.items():
        jax_sharded = tp_leaf_spec(jax_shape, n) != P()
        assert (mesh.tp_shard_dim(port_shape, n) == 0) == jax_sharded, key
        if jax_sharded:
            sharded.add(key)
    assert {"predictor.fc1.weight", "predictor.bn_scale", "predictor.bn_bias"} <= sharded
    # shard_module shards exactly those leaves of a live predictor
    predictor = PredictorHead(hidden, feat)
    layout = mesh.shard_module(predictor, n, 0)
    assert {f"predictor.{k}" for k in layout} == {k for k in sharded
                                                   if k.startswith("predictor.")}
    # the queue is the documented exception: JAX shards a 128-wide queue's
    # feature axis, the port keeps it whole (never a path the rule reads)
    assert (tp_leaf_spec((64, feat), n) != P()) == (feat >= 64)


def test_capture_state_lists_the_recipe_shards_and_never_the_queue():
    """The checkpoint's gather list under N = 2 (no process group needed to
    read it): the key encoder's sharded parameters, not the queue."""
    model = init_sharded_model()
    state = child.TrainState(model, child.make_optimizer(model),
                             child.make_lr_schedule(**child.SCHED))
    cfg = config_lib.SupConConfig(recipe="simclr", moco_queue=64, feat_dim=child.FEAT,
                                  batch_size=child.B)
    child.recipes.attach_for_config(cfg, state)
    snap = checkpoint.capture_state(state, torch.Generator())
    paths = snap["tp_layout"]["recipe"]
    key = state.recipe_state["key"]
    assert paths == [("recipe_state", "key", k) for k, p in key.named_parameters()
                     if mesh.is_tp_sharded(p)]
    assert paths and tuple(state.recipe_state["queue_emb"].shape) == (64, child.FEAT)
    assert key.tp_layout == model.tp_layout


def init_sharded_model():
    torch.manual_seed(3)
    model = SupConResNet("resnet10", "mlp", child.FEAT)
    mesh.shard_module(model, N, 1)
    return model


@pytest.mark.parametrize("name", child.TP_RECIPE_DRIVER_CASES)
def test_tp_recipe_driver_saves_whole_tensors_and_resumes_across_n(results, name):
    """Every save, the N = 2 runs' included, holds whole tensors, the recipe
    payload too; each resume's first epoch (4 steps at the other N) against
    the same epoch of the run it continues, with the slots restored."""
    runs = results(2)[0]["recipe_driver"][name]
    assert {k: r["code"] for k, r in runs.items()} == {k: 0 for k in runs}
    whole = {k: tuple(v.shape) for k, v in checkpoint_payload_shapes(name).items()}
    for run in runs.values():
        for save in child.TP_RECIPE_DRIVER_SAVES:
            if save in run:  # the last resume starts after the second epoch
                assert {k: tuple(v.shape) for k, v in flat_payload(run[save]["recipe"]).items()
                        } == whole
    for key, src, straight, save in (("resume_2_1", 1, runs["n2"], "ckpt_epoch_2.pth"),
                                     ("resume_1_2", 2, runs["resume_2_1"], "last.pth")):
        resumed = runs[key]
        assert f"ckpt_epoch_{src}.pth at epoch {src + 1} step 0" in resumed["log"]
        assert "start fresh" not in resumed["log"] and "recipe slots" not in resumed["log"]
        first = resumed["losses"][:RECIPE_DRIVER_EPOCH]
        np.testing.assert_allclose(first, straight["losses"][-len(resumed["losses"]):][:len(first)],
                                   rtol=STEP_LOSS_RTOL)
        assert rel_l2(resumed[save]["model"], straight[save]["model"]) < RESUME_REL_L2
        mine, want = flat_payload(resumed[save]["recipe"]), flat_payload(straight[save]["recipe"])
        assert rel_l2({k: v for k, v in mine.items() if k != "queue_ptr"},
                      {k: v for k, v in want.items() if k != "queue_ptr"}) < RESUME_REL_L2
        assert int(mine.get("queue_ptr", 0)) == int(want.get("queue_ptr", 0))


def flat_payload(payload):
    """A checkpoint's recipe payload as ``{path: tensor}`` (the predictor,
    its momentum buffers, the EMA network, the queue and its pointer)."""
    out = {}

    def walk(prefix, value):
        if isinstance(value, dict):
            for k, v in value.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(value, torch.Tensor) and value.is_floating_point():
            out[prefix] = value
        elif prefix.endswith("queue_ptr"):
            out["queue_ptr"] = torch.tensor(float(value))

    for slot in checkpoint.RECIPE_SLOTS:
        if slot in payload:
            walk(slot, payload[slot] if slot != "recipe_opt_state" else payload[slot]["state"])
    return out


def checkpoint_payload_shapes(name):
    """The recipe payload a one-process run of the driver case saves, by
    :func:`flat_payload`'s paths (shapes only: the whole tensors)."""
    argv = child.TP_RECIPE_DRIVER_ARGV + child.TP_RECIPE_DRIVER_CASES[name]
    cfg = config_lib.parse_supcon(argv + ["--workdir", "unused"])
    torch.manual_seed(cfg.seed)
    model = SupConResNet(cfg.model, cfg.head, cfg.feat_dim)
    state = child.TrainState(model, child.make_optimizer(model),
                             child.make_lr_schedule(**child.SCHED))
    child.recipes.attach_for_config(cfg, state)
    if state.recipe_params is not None:  # the momentum buffers a step makes
        for p in state.recipe_params.parameters():
            state.recipe_opt_state.state[p]["momentum_buffer"] = torch.zeros_like(p)
    return flat_payload(checkpoint.capture_state(state, torch.Generator())["recipe"])
