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
from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.ops.schedules import (
    make_lr_schedule as jax_make_lr_schedule,
)
from simclr_pytorch_distributed_tpu.parallel.mesh import tp_leaf_spec
from simclr_pytorch_distributed_tpu.train import state as jax_state
from simclr_pytorch_distributed_tpu.train import supcon_step as jax_step
from simclr_pytorch_distributed_tpu_torch import config as config_lib
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
from simclr_pytorch_distributed_tpu_torch.parallel import mesh
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


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """``results(W)``: the W processes' tp-suite results, one spawn each."""
    spawned = {}

    def get(world):
        if world not in spawned:
            outdir = tmp_path_factory.mktemp(f"tp{world}")
            spawned[world] = child.spawn(world, outdir, "tp")
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
def test_recipes_without_a_tp_port_are_refused_by_name(extra):
    argv = ["--dataset", "synthetic", "--model_parallel", "2"] + extra
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1"):
        config_lib.parse_supcon(argv)
    config_lib.parse_supcon(argv[:2] + extra)  # accepted at --model_parallel 1


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
