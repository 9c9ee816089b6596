"""Weight bridge between a JAX-style ``{'params', 'batch_stats'}`` tree of
numpy arrays and this package's ``SupConResNet`` state dict.

The port's module names are the reference ``resnet_big.py`` state-dict
names, so its ``state_dict()`` is the reference layout that the JAX package's
``utils/torch_convert.py`` reads and writes. This module is the port's own
copy of that mapping (the port imports nothing of the JAX package):

- conv kernels HWIO <-> OIHW; linear kernels ``[in, out]`` <-> ``[out, in]``;
- BN ``scale/bias`` <-> ``weight/bias``, ``batch_stats mean/var`` <->
  ``running_mean/var``; ``num_batches_tracked`` is written as 0 and dropped
  on the way back (momentum-0.1 BNs never read it);
- ``encoder/layer{L}_block{i}/Conv_{k-1}`` <-> ``encoder.layer{L}.{i}.conv{k}``,
  ``shortcut_conv``/``shortcut_bn`` <-> ``shortcut.0``/``shortcut.1``;
- ``proj_head/fc1|fc2`` <-> ``head.0|head.2`` (mlp), ``proj_head/fc`` <->
  ``head`` (linear);
- the probe's ``LinearClassifier`` params ``fc/kernel [in, out]``, ``fc/bias``
  <-> ``fc.weight [out, in]``, ``fc.bias`` (:func:`classifier_params_to_state_dict`
  and back);
- ``SupCEResNet`` (the CE trainer's model): the encoder as above and its
  classifier ``fc`` like the probe's, in the same two functions as
  ``SupConResNet`` (a tree holds ``proj_head`` or ``fc``);
- a params tree without ``batch_stats`` (an EMA network's, which carries
  parameters only) maps to the parameters alone and back;
- the recipe slots (:func:`recipe_slots_to_torch` and back): the
  ``PredictorHead`` params ``fc1``/``fc2`` (``kernel [in, out]``) and
  ``bn_scale``/``bn_bias`` <-> its state dict, BYOL's ``target_params`` and
  the queue's ``key_params`` <-> the EMA network's parameters (as above),
  ``queue_emb`` and ``queue_ptr`` <-> a tensor and an int;
- under tensor parallelism (:func:`variables_to_shard_state_dict`), a
  tree's leaves as one model index's shards: the state dict above, each
  leaf that ``parallel/mesh.tp_shard_dim`` shards sliced on its
  output-channel dim 0 (JAX's trailing axis, where ``tp_leaf_spec`` cuts),
  and the recipe slots likewise (:func:`recipe_slots_to_shard_torch`), the
  MoCo queue whole on every rank.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from simclr_pytorch_distributed_tpu_torch.parallel.mesh import shard_state_dict


def _conv_to_torch(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)))


def _conv_from_torch(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def variables_to_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """``{'params', 'batch_stats'}`` -> the port's ``SupConResNet`` (a
    ``proj_head`` tree) or ``SupCEResNet`` (an ``fc`` tree) state dict (CPU
    tensors). Raises on a tree node with no place in that layout."""
    params = variables["params"]
    # an EMA network's tree carries parameters only
    params_only = "batch_stats" not in variables
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    def put(key: str, arr) -> None:
        sd[key] = np.array(arr, dtype=np.float32, order="C")  # a writable copy

    def put_bn(dst: str, p: dict, path: Tuple[str, ...]) -> None:
        if params_only:
            put(f"{dst}.weight", p["scale"])
            put(f"{dst}.bias", p["bias"])
            return
        node = stats
        for name in path:
            if not isinstance(node, dict) or name not in node:
                raise ValueError(f"batch_stats has no node '{'/'.join(path)}'")
            node = node[name]
        put(f"{dst}.weight", p["scale"])
        put(f"{dst}.bias", p["bias"])
        put(f"{dst}.running_mean", node["mean"])
        put(f"{dst}.running_var", node["var"])
        sd[f"{dst}.num_batches_tracked"] = np.asarray(0, np.int64)

    def put_linear(dst: str, p: dict) -> None:
        put(f"{dst}.weight", np.asarray(p["kernel"], np.float32).T)
        put(f"{dst}.bias", p["bias"])

    for name, sub in params["encoder"].items():
        if name == "conv1":
            put("encoder.conv1.weight", _conv_to_torch(sub["kernel"]))
        elif name == "bn1":
            put_bn("encoder.bn1", sub, ("encoder", "bn1"))
        elif m := re.match(r"layer(\d)_block(\d+)$", name):
            dst = f"encoder.layer{m.group(1)}.{m.group(2)}"
            for part, leaf in sub.items():
                if cm := re.match(r"Conv_(\d)$", part):
                    put(f"{dst}.conv{int(cm.group(1)) + 1}.weight",
                        _conv_to_torch(leaf["kernel"]))
                elif re.match(r"bn\d$", part):
                    put_bn(f"{dst}.{part}", leaf, ("encoder", name, part))
                elif part == "shortcut_conv":
                    put(f"{dst}.shortcut.0.weight", _conv_to_torch(leaf["kernel"]))
                elif part == "shortcut_bn":
                    put_bn(f"{dst}.shortcut.1", leaf, ("encoder", name, part))
                else:
                    raise ValueError(f"cannot place encoder/{name}/{part}")
        else:
            raise ValueError(f"cannot place encoder/{name}")

    extra = set(params) - {"encoder", "proj_head", "fc"}
    if extra or ("proj_head" in params) == ("fc" in params):
        raise ValueError(f"expected encoder and one of proj_head, fc: got {sorted(params)}")
    if "fc" in params:
        put_linear("fc", params["fc"])
        return {k: torch.from_numpy(v) for k, v in sd.items()}
    head = params["proj_head"]
    if "fc1" in head:
        put_linear("head.0", head["fc1"])
        put_linear("head.2", head["fc2"])
    elif "fc" in head:
        put_linear("head", head["fc"])
    else:
        raise ValueError(f"unrecognized proj_head tree: {sorted(head)}")
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def variables_to_shard_state_dict(variables: dict, model_size: int, model_index: int
                                  ) -> Dict[str, torch.Tensor]:
    """``{'params', 'batch_stats'}`` -> model index ``model_index``'s shards
    of the port's state dict under ``--model_parallel model_size``: what
    ``parallel/mesh.shard_module`` leaves in a model built from the same
    tree."""
    return shard_state_dict(variables_to_state_dict(variables), model_size, model_index)


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def state_dict_to_variables(state_dict) -> dict:
    """The inverse of :func:`variables_to_state_dict`: a ``SupConResNet``
    or ``SupCEResNet`` state dict (tensors or arrays, ``'module.'`` prefixes allowed) ->
    ``{'params', 'batch_stats'}`` of numpy arrays. Raises on any key it
    does not consume. The arrays are copies: a later in-place update of the
    model does not reach them."""
    sd = {}
    for k, v in state_dict.items():
        key = k[len("module."):] if k.startswith("module.") else k
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        sd[key] = arr.copy()
    params: dict = {}
    stats: dict = {}
    consumed = set()

    def take(key: str) -> np.ndarray:
        consumed.add(key)
        return np.asarray(sd[key], np.float32)

    def bn(src: str, dst: Tuple[str, ...]) -> None:
        _set(params, dst + ("scale",), take(f"{src}.weight"))
        _set(params, dst + ("bias",), take(f"{src}.bias"))
        if f"{src}.running_mean" not in sd:  # parameters only
            return
        _set(stats, dst + ("mean",), take(f"{src}.running_mean"))
        _set(stats, dst + ("var",), take(f"{src}.running_var"))
        consumed.add(f"{src}.num_batches_tracked")

    def linear(src: str, dst: Tuple[str, ...]) -> None:
        _set(params, dst + ("kernel",), np.ascontiguousarray(take(f"{src}.weight").T))
        _set(params, dst + ("bias",), take(f"{src}.bias"))

    for key in sd:
        if key in consumed:
            continue
        if key == "encoder.conv1.weight":
            _set(params, ("encoder", "conv1", "kernel"), _conv_from_torch(take(key)))
        elif key.startswith("encoder.bn1."):
            bn("encoder.bn1", ("encoder", "bn1"))
        elif m := re.match(r"encoder\.layer(\d)\.(\d+)\.(conv|bn)(\d)\.", key):
            layer, block, kind, idx = m.groups()
            scope = ("encoder", f"layer{layer}_block{block}")
            src = f"encoder.layer{layer}.{block}.{kind}{idx}"
            if kind == "conv":
                _set(params, scope + (f"Conv_{int(idx) - 1}", "kernel"),
                     _conv_from_torch(take(f"{src}.weight")))
            else:
                bn(src, scope + (f"bn{idx}",))
        elif m := re.match(r"encoder\.layer(\d)\.(\d+)\.shortcut\.(\d)\.", key):
            layer, block, idx = m.groups()
            scope = ("encoder", f"layer{layer}_block{block}")
            src = f"encoder.layer{layer}.{block}.shortcut.{idx}"
            if idx == "0":
                _set(params, scope + ("shortcut_conv", "kernel"),
                     _conv_from_torch(take(f"{src}.weight")))
            else:
                bn(src, scope + ("shortcut_bn",))
        elif key.startswith("head.0."):
            linear("head.0", ("proj_head", "fc1"))
        elif key.startswith("head.2."):
            linear("head.2", ("proj_head", "fc2"))
        elif key in ("head.weight", "head.bias"):
            linear("head", ("proj_head", "fc"))
        elif key in ("fc.weight", "fc.bias"):
            linear("fc", ("fc",))

    leftover = set(sd) - consumed
    if leftover:
        raise ValueError(f"unmapped state-dict keys: {sorted(leftover)[:8]}")
    if not stats and not any(k.endswith("running_mean") for k in sd):
        return {"params": params}
    return {"params": params, "batch_stats": stats}


def classifier_params_to_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """A JAX ``LinearClassifier`` param tree ``{'fc': {'kernel', 'bias'}}``
    -> the port's ``LinearClassifier`` state dict (CPU tensors, copies)."""
    fc = params["fc"]
    return {
        "fc.weight": torch.from_numpy(np.array(np.asarray(fc["kernel"], np.float32).T)),
        "fc.bias": torch.from_numpy(np.array(fc["bias"], dtype=np.float32)),
    }


def classifier_state_dict_to_params(state_dict) -> dict:
    """The inverse: ``fc.weight``/``fc.bias`` -> ``{'fc': {'kernel', 'bias'}}``
    of numpy copies. Raises on any other key."""
    extra = set(state_dict) - {"fc.weight", "fc.bias"}
    if extra:
        raise ValueError(f"unmapped classifier keys: {sorted(extra)}")
    weight = state_dict["fc.weight"].detach().cpu().numpy()
    return {"fc": {
        "kernel": np.ascontiguousarray(weight.T, dtype=np.float32),
        "bias": np.array(state_dict["fc.bias"].detach().cpu().numpy(), dtype=np.float32),
    }}


def predictor_params_to_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """A JAX ``PredictorHead`` param tree -> the port's ``PredictorHead``
    state dict (CPU tensors, copies)."""
    sd = {}
    for fc in ("fc1", "fc2"):
        sd[f"{fc}.weight"] = np.asarray(params[fc]["kernel"], np.float32).T
        sd[f"{fc}.bias"] = params[fc]["bias"]
    sd["bn_scale"], sd["bn_bias"] = params["bn_scale"], params["bn_bias"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def predictor_state_dict_to_params(state_dict) -> dict:
    """The inverse: the port's ``PredictorHead`` state dict -> the JAX param
    tree of numpy copies. Raises on any other key."""
    want = {"fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias", "bn_scale", "bn_bias"}
    if set(state_dict) != want:
        raise ValueError(f"unmapped predictor keys: {sorted(set(state_dict) ^ want)}")
    arr = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
           for k, v in state_dict.items()}
    out = {fc: {"kernel": np.ascontiguousarray(arr[f"{fc}.weight"].T, dtype=np.float32),
                "bias": np.array(arr[f"{fc}.bias"], dtype=np.float32)} for fc in ("fc1", "fc2")}
    out["bn_scale"] = np.array(arr["bn_scale"], dtype=np.float32)
    out["bn_bias"] = np.array(arr["bn_bias"], dtype=np.float32)
    return out


# the JAX recipe_state's EMA params trees -> the port's recipe_state entries
_EMA_SLOTS = {"target_params": "target", "key_params": "key"}


def recipe_slots_to_torch(recipe_params=None, recipe_state=None) -> dict:
    """The JAX package's recipe slots -> the port's slot snapshot
    (``utils/checkpoint.restore_recipe_slots`` loads it into a state):
    ``recipe_params`` the predictor's state dict; ``recipe_state`` with the
    EMA networks' parameters by name, ``queue_emb`` a tensor and
    ``queue_ptr`` an int. Absent slots are left out."""
    out = {}
    if recipe_params is not None:
        out["recipe_params"] = predictor_params_to_state_dict(recipe_params)
    if recipe_state is not None:
        state = {}
        for key, value in recipe_state.items():
            if key in _EMA_SLOTS:
                state[_EMA_SLOTS[key]] = variables_to_state_dict({"params": value})
            elif key == "queue_emb":
                state[key] = torch.from_numpy(np.array(value, dtype=np.float32))
            elif key == "queue_ptr":
                state[key] = int(np.asarray(value))
            else:
                raise ValueError(f"cannot place recipe_state/{key}")
        out["recipe_state"] = state
    return out


def recipe_slots_to_shard_torch(model_size: int, model_index: int, recipe_params=None,
                                recipe_state=None) -> dict:
    """:func:`recipe_slots_to_torch`'s snapshot as model index
    ``model_index`` holds it under ``--model_parallel model_size``: the
    predictor's and the EMA networks' shards (``parallel/mesh.shard_state_dict``,
    what ``recipes/base.shard_like`` leaves in slots built from the same
    trees); the queue whole and the pointer as they are, on every rank."""
    out = recipe_slots_to_torch(recipe_params, recipe_state)
    if "recipe_params" in out:
        out["recipe_params"] = shard_state_dict(out["recipe_params"], model_size, model_index)
    for key in _EMA_SLOTS.values():
        if key in out.get("recipe_state", {}):
            out["recipe_state"][key] = shard_state_dict(out["recipe_state"][key], model_size,
                                                        model_index)
    return out


def recipe_slots_from_torch(recipe_params=None, recipe_state=None) -> dict:
    """The inverse of :func:`recipe_slots_to_torch`, from the port's live
    slots (a ``PredictorHead``; the ``recipe_state`` dict): ``{'recipe_params':
    tree, 'recipe_state': {'target_params' | 'key_params': tree,
    'queue_emb': array, 'queue_ptr': int32 array}}`` of numpy copies."""
    out = {}
    if recipe_params is not None:
        out["recipe_params"] = predictor_state_dict_to_params(recipe_params.state_dict())
    if recipe_state is not None:
        inverse = {v: k for k, v in _EMA_SLOTS.items()}
        state = {}
        for key, value in recipe_state.items():
            if key in inverse:
                named = dict(value.named_parameters())
                state[inverse[key]] = state_dict_to_variables(named)["params"]
            elif key == "queue_emb":
                state[key] = value.detach().cpu().numpy().copy()
            elif key == "queue_ptr":
                state[key] = np.asarray(value, np.int32)
            else:
                raise ValueError(f"cannot place recipe_state/{key}")
        out["recipe_state"] = state
    return out
