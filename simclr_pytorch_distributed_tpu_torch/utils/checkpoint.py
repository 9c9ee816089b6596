"""Checkpoints in the reference's ``.pth`` layout (reference ``util.py:87-96``),
with the full training state a resume needs.

A pretrain checkpoint is ``torch.save`` of a dict holding the reference's
four keys, ``'opt'`` (the run's configuration as plain types), ``'model'``
(the ``SupConResNet`` state dict with the ``'module.'`` prefix of the
reference's DDP-wrapped model), ``'optimizer'`` (the SGD state dict) and
``'epoch'`` (completed epochs), so the JAX package's
``convert_reference_checkpoint`` reads it as it is. Beside them:
``'step'`` (the global step), ``'step_in_epoch'`` (steps of the next epoch
already taken; nonzero only in a mid-epoch preemption or crash save),
``'record_norm_mean'``, ``'generator'`` (the augmentation generator's
``get_state()``) with ``'generator_device'``, ``'seed'``, ``'world_size'``
(the processes of the saving run), and the NaN-rollback state
``'lr_scale'`` and ``'rollbacks'`` (``utils/guard.FailurePolicy``). Every
value is a tensor or a plain type, so ``torch.load(weights_only=True)``
reads it. A checkpoint written before the last three existed resumes as
one saved by one process with no rollback. A run with the online probe
(``--online_probe on``) adds ``'probe'``: the classifier's and its SGD's
state dicts; without the probe the checkpoint holds exactly the keys
above (JAX ``train/state.py:32-42``).

A recipe with slots (``recipes/``: BYOL, SimSiam, the MoCo queue) adds
``'recipe'``: its ``name``, its ``moco_queue`` geometry and its non-``None``
slots, ``recipe_params`` (the predictor's parameters), ``recipe_opt_state``
(its optimizer's state dict, the momentum buffers) and ``recipe_state``
(an EMA network's parameters, not its unread BN buffers; the queue and its
pointer). A slot-free recipe's checkpoint keeps exactly the keys above. On
restore the payload comes back only when the checkpoint's recipe and queue
geometry are this run's (JAX ``utils/checkpoint.py:293-370``); otherwise
the encoder's trajectory is restored and the slots start fresh, with a
warning that says why.

Elastic resume (JAX ``utils/checkpoint.py:278-284, :526-550``): a
checkpoint resumes under any world size, at the same global step; only
the loader's process slices change, since the augmentation draws are
global. :func:`restore_checkpoint` names a change of world size in a
warning, because per-process BN statistics (without ``--syncBN``) and a
non-``auto`` ``--ngpu`` make the training math depend on it.

Files are written through a temporary name and renamed, so a crash
mid-write never leaves a truncated file under a checkpoint's name. In a
data-parallel run rank 0 writes and every process reads: each process holds
the same state (the same initial weights, averaged gradients, and an
augmentation generator in the same state), so rank 0's file resumes all of
them.

Tensor parallelism (``--model_parallel N``): each process holds its model
index's shards of the sharded leaves (``parallel/mesh.shard_module``), and
:func:`capture_state` records which entries those are. A save gathers them
over the model group first (every process calls :func:`save_checkpoint`),
so a checkpoint holds whole tensors whatever ``N`` wrote it, and the probe,
the server and a resume at another ``N`` read it as any other. The recipe
payload's shards (the predictor, its momentum, an EMA network) are
gathered alike; the MoCo queue is whole on every rank and saved as it is.
A restore fits each tensor to the model's or the slot's own shape
(``mesh.reshard_like``): a whole tensor becomes this process's shard. The
JAX counterparts: ``resume_position`` ``utils/checkpoint.py:96``,
``resolve_resume_path :372``, ``restore_checkpoint :428``,
``save_classifier :567``, ``load_classifier :577``.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from simclr_pytorch_distributed_tpu_torch.config import config_dict
from simclr_pytorch_distributed_tpu_torch.parallel import collectives, mesh
from simclr_pytorch_distributed_tpu_torch.parallel.mesh import is_main_process, world_size

CLASSIFIER_FILE = "classifier_best.pth"
RECIPE_SLOTS = ("recipe_params", "recipe_opt_state", "recipe_state")


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _atomic_save(obj, path: str) -> str:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def _load(path: str, mmap: bool = False) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True, mmap=mmap)


def _strip_module(state_dict) -> Dict[str, torch.Tensor]:
    return {k.removeprefix("module."): v for k, v in state_dict.items()}


def _slot_snapshot(value, clone):
    """A recipe slot as tensors and plain types: a module's parameters by
    name, an optimizer's state dict, a dict entry by entry."""
    if isinstance(value, nn.Module):
        return {k: clone(p) for k, p in value.named_parameters()}
    if isinstance(value, torch.optim.Optimizer):
        return _tree_map(clone, value.state_dict())
    if isinstance(value, dict):
        return {k: _slot_snapshot(v, clone) for k, v in value.items()}
    return clone(value) if isinstance(value, torch.Tensor) else value


def _sharded_slot_paths(value) -> list:
    """The paths, in a slot's :func:`_slot_snapshot`, of the entries that
    hold shards (``parallel/mesh.is_tp_sharded``): a module's sharded
    parameters by name, an optimizer's state entries of sharded parameters
    (``('state', i)``), a dict's entries' own. A plain tensor (the queue)
    is never one."""
    if isinstance(value, nn.Module):
        return [(k,) for k, p in value.named_parameters() if mesh.is_tp_sharded(p)]
    if isinstance(value, torch.optim.Optimizer):
        params = [p for group in value.param_groups for p in group["params"]]
        return [("state", i) for i, p in enumerate(params) if mesh.is_tp_sharded(p)]
    if isinstance(value, dict):
        return [(k, *path) for k, v in value.items() for path in _sharded_slot_paths(v)]
    return []


@torch.no_grad()
def _restore_slot(current, saved):
    """Put a :func:`_slot_snapshot` back into the live slot ``current``;
    returns the slot (a new value for a plain entry). A module's parameters
    and an optimizer's buffers are fitted to the slot's shards first
    (``mesh.reshard_like``: a whole save restores under any
    ``--model_parallel``); a plain tensor is restored as it was saved.
    Raises on a name or shape that does not match."""
    if isinstance(current, nn.Module):
        params = dict(current.named_parameters())
        if params.keys() != saved.keys():
            raise ValueError(f"parameters {sorted(set(params) ^ set(saved))[:4]} differ")
        saved = mesh.reshard_like(saved, params)
        for k, p in params.items():
            if p.shape != saved[k].shape:
                raise ValueError(f"{k}: shape {tuple(saved[k].shape)} != {tuple(p.shape)}")
            p.copy_(saved[k])
        return current
    if isinstance(current, torch.optim.Optimizer):
        current.load_state_dict(_reshard_optimizer(saved, current))
        return current
    if isinstance(current, dict):
        if current.keys() != saved.keys():
            raise ValueError(f"entries {sorted(set(current) ^ set(saved))} differ")
        for k in current:
            current[k] = _restore_slot(current[k], saved[k])
        return current
    if isinstance(current, torch.Tensor):
        if current.shape != saved.shape:
            raise ValueError(f"shape {tuple(saved.shape)} != {tuple(current.shape)}")
        current.copy_(saved)
        return current
    return type(current)(saved)


def _recipe_payload(state, clone) -> dict:
    """The non-``None`` recipe slots of ``state`` (empty for a slot-free
    recipe)."""
    return {slot: _slot_snapshot(value, clone) for slot in RECIPE_SLOTS
            if (value := getattr(state, slot, None)) is not None}


def restore_recipe_slots(snapshot: dict, state) -> None:
    """Load a snapshot of recipe slots (``{slot: value}`` in the payload's
    form, ``utils/convert.recipe_slots_to_torch`` makes one from the JAX
    package's slots) into ``state``'s live slots; raises on a mismatch."""
    for slot, saved in snapshot.items():
        setattr(state, slot, _restore_slot(getattr(state, slot), saved))


def capture_state(state, generator: torch.Generator, copy: bool = False) -> dict:
    """What a resume needs of ``state`` (a ``train.state.TrainState``) and
    the augmentation ``generator``. ``copy=True`` clones every tensor where
    it lies (the drivers' epoch-top backup, held on the device); otherwise
    the entries alias the live tensors and must be saved before the next
    step."""
    clone = (lambda t: t.detach().clone()) if copy else (lambda t: t.detach())
    record = state.record_norm_mean
    snapshot = {
        "model": _tree_map(clone, state.model.state_dict()),
        "optimizer": _tree_map(clone, state.optimizer.state_dict()),
        "step": int(state.step),
        "record_norm_mean": None if record is None else clone(record),
        "generator": generator.get_state(),
        "generator_device": generator.device.type,
    }
    if state.probe is not None:
        snapshot["probe"] = {
            "classifier": _tree_map(clone, state.probe.classifier.state_dict()),
            "optimizer": _tree_map(clone, state.probe.optimizer.state_dict()),
        }
    slots = _recipe_payload(state, clone)
    if slots:
        queue = getattr(state.recipe, "moco_queue", 0)
        snapshot["recipe"] = {"name": state.recipe.name, "moco_queue": int(queue), **slots}
    layout = getattr(state.model, "tp_layout", None)
    recipe_paths = [(slot, *path) for slot in RECIPE_SLOTS
                    if (value := getattr(state, slot, None)) is not None
                    for path in _sharded_slot_paths(value)]
    if layout or recipe_paths:
        params = [p for group in state.optimizer.param_groups for p in group["params"]]
        snapshot["tp_layout"] = {
            "model": sorted(layout or ()),
            "optimizer": [i for i, p in enumerate(params) if mesh.is_tp_sharded(p)],
            "recipe": recipe_paths,
        }
    return snapshot


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A shard gathered over the model group into the whole tensor."""
    return torch.cat(collectives.all_gather(t, mesh.model_group()))


def _whole_entry(entry):
    """A sharded entry made whole: a shard, or an optimizer state entry's
    buffers (its 0-dim step count kept)."""
    if isinstance(entry, torch.Tensor):
        return _whole(entry)
    return {k: _whole(v) if isinstance(v, torch.Tensor) and v.dim() else v
            for k, v in entry.items()}


def _whole_at(tree: dict, path: tuple) -> dict:
    """``tree`` with its entry at ``path`` gathered whole (:func:`_whole_entry`),
    the dicts along the path copied; an entry the tree does not hold yet
    (an optimizer state before the first step) is left out."""
    head, rest = path[0], path[1:]
    if head not in tree:
        return tree
    return {**tree, head: _whole_at(tree[head], rest) if rest else _whole_entry(tree[head])}


def whole_snapshot(snapshot: dict) -> dict:
    """``snapshot`` with its sharded entries (its ``tp_layout``: the model,
    the optimizer and the recipe payload) gathered whole over the model
    group, and the layout dropped: what a checkpoint holds. Collective over the model group; a snapshot without a layout (or
    the ``None`` that a process holding no backup passes) is returned as it
    is."""
    tp = snapshot.get("tp_layout") if snapshot else None
    if not tp:
        return snapshot
    out = {k: v for k, v in snapshot.items() if k != "tp_layout"}
    out["model"] = {k: _whole(v) if k in tp["model"] else v
                    for k, v in snapshot["model"].items()}
    opt = dict(snapshot["optimizer"])
    opt["state"] = {i: _whole_entry(entry) if i in tp["optimizer"] else entry
                    for i, entry in snapshot["optimizer"]["state"].items()}
    out["optimizer"] = opt
    for path in tp["recipe"]:
        out["recipe"] = _whole_at(out["recipe"], path)
    return out


def _reshard_optimizer(saved: dict, optimizer: torch.optim.Optimizer) -> dict:
    """An optimizer state dict fitted to ``optimizer``'s parameter shapes
    (``mesh.reshard_like``): whole momentum buffers become this process's
    shards."""
    if mesh.model_parallel() == 1:
        return saved
    params = [p for group in optimizer.param_groups for p in group["params"]]
    state = {}
    for i, entry in saved["state"].items():
        shape = {k: params[int(i)] for k, v in entry.items() if isinstance(v, torch.Tensor)}
        state[i] = {**entry, **mesh.reshard_like(
            {k: v for k, v in entry.items() if k in shape}, shape)}
    return {**saved, "state": state}


def restore_snapshot(snapshot: dict, state, generator: torch.Generator) -> None:
    """Put a :func:`capture_state` snapshot (or a loaded checkpoint, whose
    model keys may carry ``'module.'``) back into ``state`` and
    ``generator``: the model, the optimizer, ``step``,
    ``record_norm_mean``, the generator's state, the probe, and the recipe
    slots where the snapshot holds them (a snapshot of the same run: a
    checkpoint of another run goes through :func:`restore_checkpoint`'s
    checks first)."""
    state.model.load_state_dict(
        mesh.reshard_like(_strip_module(snapshot["model"]), state.model.state_dict()))
    state.optimizer.load_state_dict(_reshard_optimizer(snapshot["optimizer"], state.optimizer))
    state.step = int(snapshot["step"])
    record = snapshot["record_norm_mean"]
    device = next(state.model.parameters()).device
    state.record_norm_mean = None if record is None else record.to(device)
    generator.set_state(snapshot["generator"])
    if state.probe is not None:
        if "probe" in snapshot:
            state.probe.classifier.load_state_dict(snapshot["probe"]["classifier"])
            state.probe.optimizer.load_state_dict(snapshot["probe"]["optimizer"])
        else:
            logging.warning("the checkpoint holds no online probe: the probe starts "
                            "from its fresh init")
    if "recipe" in snapshot and any(getattr(state, s, None) is not None for s in RECIPE_SLOTS):
        restore_recipe_slots({k: v for k, v in snapshot["recipe"].items()
                               if k in RECIPE_SLOTS}, state)


def _restore_recipe_payload(path: str, ckpt: dict, state, recipe: Optional[str],
                            moco_queue: Optional[int]) -> None:
    """Cross-recipe hygiene (JAX ``utils/checkpoint.py:293-370``): restore
    the checkpoint's ``recipe`` payload into ``state``'s slots only when the
    recorded recipe and queue geometry are this run's and the slots match
    in structure; otherwise a warning says why, and the slots keep their
    fresh init while the encoder's trajectory restores."""
    wanted = {slot for slot in RECIPE_SLOTS if getattr(state, slot, None) is not None}
    payload = ckpt.get("recipe")
    saved = payload["name"] if payload else (ckpt.get("opt") or {}).get("recipe")
    if not wanted:
        if payload:
            # e.g. a BYOL checkpoint resumed with --recipe supcon
            logging.warning("checkpoint %s carries a %r recipe payload this run's recipe "
                            "(%r) does not use; recipe slots ignored", path, saved, recipe)
        return
    if not payload:
        logging.warning("checkpoint %s has no recipe payload (saved recipe %r, this run "
                        "%r); recipe slots start fresh", path, saved, recipe)
        return
    if recipe is not None and saved != recipe:
        logging.warning("checkpoint %s was trained with recipe %r but this run uses %r; the "
                        "encoder trajectory is restored, recipe slots (predictor/EMA "
                        "target/queue) start fresh", path, saved, recipe)
        return
    if moco_queue is not None and int(payload["moco_queue"]) != int(moco_queue):
        logging.warning("checkpoint %s was trained with --moco_queue %s but this run uses "
                        "%s; the queue/key-encoder slots start fresh (the ring geometry "
                        "changed)", path, payload["moco_queue"], moco_queue)
        return
    if set(wanted) != set(payload) - {"name", "moco_queue"}:
        logging.warning("checkpoint %s recipe payload holds slots %s, this run's recipe %s; "
                        "recipe slots start fresh", path,
                        sorted(set(payload) - {"name", "moco_queue"}), sorted(wanted))
        return
    fresh = _recipe_payload(state, lambda t: t.detach().clone())
    try:
        restore_recipe_slots({slot: payload[slot] for slot in wanted}, state)
    except (ValueError, KeyError, RuntimeError) as e:
        restore_recipe_slots(fresh, state)
        logging.warning("checkpoint %s recipe payload does not match this run's recipe-slot "
                        "structure (%s); recipe slots start fresh", path, e)


def save_checkpoint(path: str, snapshot: dict, cfg, epoch: int, step_in_epoch: int = 0,
                    lr_scale: float = 1.0, rollbacks: int = 0,
                    run_meta: Optional[dict] = None) -> str:
    """Write ``snapshot`` (:func:`capture_state`) with the run's ``cfg`` to
    ``path``; ``epoch`` counts completed epochs, ``step_in_epoch`` the
    steps of the next one already taken, ``lr_scale`` and ``rollbacks``
    the NaN-rollback state, ``run_meta`` other run state of plain types
    (the CE trainer's best accuracy), saved under ``'run_meta'`` when
    given. Returns the absolute path. Only rank 0 writes; the other
    processes return the path it writes. Under tensor parallelism every
    process calls it: the shards are gathered whole first
    (:func:`whole_snapshot`)."""
    snapshot = whole_snapshot(snapshot)
    if not is_main_process():
        return os.path.abspath(path)
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    record = snapshot["record_norm_mean"]
    payload = {
        "opt": config_dict(cfg),
        "model": {f"module.{k}": cpu(v) for k, v in snapshot["model"].items()},
        "optimizer": _tree_map(cpu, snapshot["optimizer"]),
        "epoch": int(epoch),
        "step": int(snapshot["step"]),
        "step_in_epoch": int(step_in_epoch),
        "record_norm_mean": None if record is None else cpu(record),
        "generator": snapshot["generator"].cpu(),
        "generator_device": snapshot["generator_device"],
        "seed": int(cfg.seed),
        "world_size": world_size(),
        "lr_scale": float(lr_scale),
        "rollbacks": int(rollbacks),
    }
    if "probe" in snapshot:
        payload["probe"] = _tree_map(cpu, snapshot["probe"])
    if "recipe" in snapshot:
        payload["recipe"] = _tree_map(cpu, snapshot["recipe"])
    if run_meta is not None:
        payload["run_meta"] = dict(run_meta)
    return _atomic_save(payload, path)


def load_model_state(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict (CPU tensors, ``'module.'`` stripped) of a
    ``.pth`` in the reference layout: one this package writes, the
    reference's own, or the JAX package's ``export_reference_checkpoint``.
    A run folder resolves to its ``last.pth``."""
    if os.path.isdir(path):
        path = os.path.join(path, "last.pth")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return _model_of(_load(path))


def _model_of(ckpt) -> Dict[str, torch.Tensor]:
    state_dict = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    return _strip_module(state_dict)


def load_model_payload(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """``(state_dict, meta)`` of any ``--ckpt`` spelling, for a consumer
    that infers the architecture from the state dict
    (``models.heads.infer_architecture``): a ``.pth`` in the reference
    layout (a trainer's ``last.pth``, ``ckpt_epoch_N.pth`` or
    ``preempt_*``, the reference's own, or the JAX package's
    ``torch_convert --export``) or a run folder, resolved to its latest
    complete checkpoint (:func:`resolve_resume_path`). ``state_dict`` is
    :func:`load_model_state`'s; ``meta`` is the checkpoint's ``'opt'``
    (``{}`` without one). The port's counterpart of JAX
    ``load_model_payload`` (``utils/checkpoint.py:644-669``), which reads
    orbax directories; the port reads none: ``torch_convert --export``
    turns one into a ``.pth``."""
    if os.path.isdir(path):
        path = resolve_resume_path(path)
    elif not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    ckpt = _load(path)
    opt = ckpt.get("opt") if isinstance(ckpt, dict) else None
    return _model_of(ckpt), dict(opt) if isinstance(opt, dict) else {}


def resume_position(meta: dict, steps_per_epoch: int) -> Tuple[int, int]:
    """``(start_epoch, start_step)`` from a checkpoint's ``epoch`` and
    ``step_in_epoch``. An offset at or past ``steps_per_epoch`` (the
    configuration changed across the resume) and an unparsable one both
    degrade, with a warning, to the next epoch boundary and the epoch's
    start."""
    start_epoch = int(meta.get("epoch", 0)) + 1
    try:
        start_step = int(meta.get("step_in_epoch") or 0)
    except (TypeError, ValueError):
        logging.warning(
            "unparseable step_in_epoch %r in checkpoint meta; resuming at "
            "the epoch boundary", meta.get("step_in_epoch"),
        )
        start_step = 0
    if start_step >= steps_per_epoch:
        logging.warning(
            "checkpoint step_in_epoch %d >= %d steps/epoch (config changed "
            "across resume?); starting at the next epoch",
            start_step, steps_per_epoch,
        )
        start_epoch += 1
        start_step = 0
    return start_epoch, start_step


def _progress(meta) -> Optional[Tuple[int, int]]:
    if not isinstance(meta, dict) or "epoch" not in meta or "step" not in meta:
        return None  # not a full-state checkpoint (or no checkpoint at all)
    try:
        step = int(meta.get("step_in_epoch") or 0)
    except (TypeError, ValueError):
        step = 0
    return int(meta["epoch"]), step


def readable_checkpoint(path: str) -> Optional[dict]:
    """The checkpoint at ``path`` (tensors memory-mapped), or ``None`` for a
    file that does not load: a torn write, or not a checkpoint at all."""
    try:
        return _load(path, mmap=True)
    except Exception:  # noqa: BLE001 - a torn or foreign file is skipped
        return None


def resolve_resume_path(path: str) -> str:
    """A full-state ``.pth`` as it is, or a run folder's latest complete
    checkpoint: the one with the most progress, ``(epoch, step_in_epoch)``
    in order, a scheduled save (``ckpt_epoch_N``, ``last``) winning a tie
    with a crash or preemption save. A file that does not load (a torn
    write) never wins."""
    path = os.path.abspath(path)
    if os.path.isfile(path):
        return path
    candidates = []
    for name in sorted(glob.glob(os.path.join(path, "*.pth"))):
        progress = _progress(readable_checkpoint(name))  # None for a torn file
        if progress is not None:
            scheduled = 0 if os.path.basename(name).startswith(("crash", "preempt")) else 1
            candidates.append((*progress, scheduled, name))
    if not candidates:
        raise FileNotFoundError(f"{path} holds no complete full-state checkpoint (*.pth)")
    return max(candidates)[3]


def restore_checkpoint(path: str, state, generator: torch.Generator,
                       recipe: Optional[str] = None, moco_queue: Optional[int] = None) -> dict:
    """Restore the model, the optimizer's buffers, ``step``,
    ``record_norm_mean`` and the augmentation generator from ``path`` into
    ``state`` (a ``train.state.TrainState`` built as the saving run built
    it) and ``generator``, under this run's world size, whatever the saving
    run's was (module docstring), and the recipe slots when the
    checkpoint's recipe (``recipe``, ``moco_queue``) is this run's
    (:func:`_restore_recipe_payload`). Returns the checkpoint's ``epoch``,
    ``step_in_epoch``, ``step``, ``seed``, ``world_size`` (``None`` when it
    predates the key), ``lr_scale``, ``rollbacks`` and ``run_meta`` (``{}``
    when absent)."""
    ckpt = _load(path)
    if _progress(ckpt) is None or "generator" not in ckpt:
        raise ValueError(f"{path} holds no full training state (keys {sorted(ckpt)}); "
                         "warm-start from it with --ckpt instead")
    if ckpt["generator_device"] != generator.device.type:
        raise ValueError(f"{path} holds a {ckpt['generator_device']} generator state; this "
                         f"run's augmentation generator is on {generator.device.type}")
    _restore_recipe_payload(path, ckpt, state, recipe, moco_queue)
    restore_snapshot({k: v for k, v in ckpt.items() if k != "recipe"}, state, generator)
    saved = ckpt.get("world_size")
    if saved is not None and int(saved) != world_size():
        logging.warning(
            "elastic resume: checkpoint %s was saved under %d process(es), restoring under "
            "%d; the state is the same and batch composition is unchanged (seed + epoch "
            "permutation, global augmentation draws), but per-process BN statistics "
            "(--syncBN off) and a non-auto --ngpu divisor do depend on the world size",
            path, int(saved), world_size(),
        )
    meta = {k: ckpt[k] for k in ("epoch", "step_in_epoch", "step", "seed")}
    meta.update(world_size=saved, lr_scale=float(ckpt.get("lr_scale", 1.0)),
                rollbacks=int(ckpt.get("rollbacks", 0)), run_meta=ckpt.get("run_meta", {}))
    return meta


def save_classifier(save_folder: str, classifier_state: Dict[str, torch.Tensor],
                    best_acc: float) -> str:
    """Write the best probe classifier's state dict and its top-1 to
    ``<save_folder>/classifier_best.pth``; returns the path."""
    payload = {
        "model": {k: v.detach().cpu() for k, v in classifier_state.items()},
        "best_acc": float(best_acc),
    }
    return _atomic_save(payload, os.path.join(save_folder, CLASSIFIER_FILE))


def load_classifier(path: str) -> Dict[str, torch.Tensor]:
    """The classifier state dict :func:`save_classifier` wrote (``path`` is
    the file or its run folder)."""
    if os.path.isdir(path):
        path = os.path.join(path, CLASSIFIER_FILE)
    return _load(path)["model"]
