"""The process group: rendezvous, rank gating, small broadcasts and barriers.

The counterpart of the JAX package's ``parallel/mesh.py``, whose name it
keeps so that a reader finds the pair. It holds a ``torch.distributed``
process group, not a device mesh: one process per GPU, as the reference
launches them (``torch.distributed.launch``, ``main_supcon.py:359-364``),
now under ``torchrun``. The backend follows the device: NCCL for CUDA, gloo
for the CPU (the tests). Without ``WORLD_SIZE`` in the environment and no
explicit ``init_method`` nothing is initialized, and every function here
answers as the one process of a world of one.

- :func:`setup_distributed`: reads torchrun's ``RANK``/``WORLD_SIZE``/
  ``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT`` (``env://``), or takes an
  explicit ``init_method`` (``file://...`` in the tests); on CUDA it sets
  the device to ``LOCAL_RANK`` before ``init_process_group``.
- :func:`broadcast_from_main`: every process adopts rank 0's string (the
  timestamped run folder, JAX ``mesh.py:80``).
- :func:`sync_processes`: a barrier before exit paths (JAX ``mesh.py:106``).
- :func:`is_main_process`: rank-0 gating of logging and checkpoint writes
  (JAX ``mesh.py:122``).
- :func:`setup_grid` (``--model_parallel N``, JAX ``create_mesh``,
  ``mesh.py:64-77``): the world of ``W`` processes as a grid of ``D = W //
  N`` data slices by ``N`` model shards. Model groups are consecutive
  ranks, as in JAX's ``reshape(n // mp, mp)``: rank ``r`` has data index
  ``r // N`` and model index ``r % N``; a data group is the ranks that
  share a model index. :func:`data_group` and :func:`model_group` are
  their process groups (``None``, the world or nothing, at ``N = 1``, so
  every collective is today's there).
- :func:`tp_shard_dim` and :func:`state_sharding` (JAX ``tp_leaf_spec``
  and ``state_sharding``, ``mesh.py:183-213``): which state leaves a model
  group shards, on PyTorch's output-channel dim 0 (JAX's trailing axis);
  :func:`shard_module` keeps a module's own slices, :func:`shard_state_dict`
  slices a whole state dict and :func:`reshard_like` fits a saved one to a
  module's shapes.

A failed collective raises (``torch.distributed``'s own error, or its
``timeout``); nothing here catches it.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import logging
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

# how long a collective may wait for its peers before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def local_rank() -> int:
    """torchrun's ``LOCAL_RANK`` (0 when it is not set)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def setup_distributed(
    device_type: str = "cuda",
    *,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join the process group; returns whether this call initialized it.

    Nothing happens when a group already exists, or when neither
    ``init_method`` nor ``WORLD_SIZE`` is given (a single process, as
    before). ``init_method`` defaults to ``env://`` with ``RANK`` and
    ``WORLD_SIZE`` from the environment. ``backend`` defaults to NCCL for
    ``device_type`` 'cuda' and gloo for 'cpu'; gloo also carries CUDA
    tensors, through host memory. CUDA asked for and absent raises."""
    if dist.is_initialized():
        return False
    if init_method is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        init_method = "env://"
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: no CUDA device is available (pass --device cpu "
                "to run on the CPU)"
            )
        torch.cuda.set_device(local_rank())
    elif device_type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device_type!r}")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    logging.info("distributed: rank %d of %d, backend %s, local rank %d",
                 rank, world_size, backend, local_rank())
    return True


def teardown_distributed() -> None:
    """Leave the process group, if there is one (and the grid with it)."""
    reset_grid()
    if dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    """Whether a process group exists (of any size, one included)."""
    return dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank-0 gating for I/O (the reference's ``local_rank == 0`` checks)."""
    return rank() == 0


def collective_device() -> torch.device:
    """Where a collective's small host-side values go: the current CUDA
    device under NCCL (which takes CUDA tensors only), else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_from_main(s: str, max_len: int = 512) -> str:
    """Every process adopts rank 0's value of a short string. The run folder
    embeds a minute-stamped time that each process derives on its own, and
    one minute boundary between them would split the run's files."""
    if world_size() == 1:
        return s
    raw = s.encode()
    if len(raw) > max_len:
        raise ValueError(f"string too long to broadcast ({len(raw)} > {max_len})")
    buf = torch.zeros(max_len, dtype=torch.uint8)
    buf[: len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    buf = buf.to(collective_device())
    dist.broadcast(buf, src=0)
    return bytes(buf.cpu().tolist()).rstrip(b"\x00").decode()


def sync_processes(tag: str) -> None:
    """Barrier before an exit path: rank 0 may still be writing a
    checkpoint when the others reach the end, and a launcher that sees one
    process leave tears down the rest. An all-reduce of one value, so that
    it runs on either backend's tensors."""
    if world_size() == 1:
        return
    logging.debug("sync_processes: %s", tag)
    dist.all_reduce(torch.zeros(1, device=collective_device()))


# -- the data x model grid (--model_parallel) --------------------------------

# JAX's rule (mesh.py:183-201): a leaf narrower than this is not worth splitting
TP_MIN_OUT = 64


@dataclasses.dataclass(frozen=True)
class Grid:
    """This process's place in the ``data x model`` grid and its groups."""

    data_parallel: int
    model_parallel: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object


_GRID: Optional[Grid] = None


def grid_layout(world: int, model_parallel: int) -> Tuple[List[List[int]], List[List[int]]]:
    """``(model_groups, data_groups)``: the ranks of each model group
    (consecutive, ``[d * N .. d * N + N - 1]`` for data index ``d``) and of
    each data group (``[m, m + N, ...]`` for model index ``m``). Raises
    JAX's ``ValueError`` (``mesh.py:74-75``) when ``N`` does not divide
    ``world``."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    if world % model_parallel != 0:
        raise ValueError(f"{world} processes not divisible by model_parallel={model_parallel}")
    d = world // model_parallel
    model_groups = [[i * model_parallel + m for m in range(model_parallel)] for i in range(d)]
    data_groups = [[i * model_parallel + m for i in range(d)] for m in range(model_parallel)]
    return model_groups, data_groups


def setup_grid(model_parallel: int = 1) -> Grid:
    """Lay the world out as ``D x N`` (:func:`grid_layout`) and make the
    groups. Every process calls it with the same ``N``: each
    ``new_group`` is collective over the world. At ``N = 1`` no group is
    made: the data group is the world (``None``), and there is no model
    group."""
    global _GRID
    world, r = world_size(), rank()
    model_groups, data_groups = grid_layout(world, model_parallel)
    data_group = model_group = None
    if model_parallel > 1:
        for ranks in model_groups:
            group = dist.new_group(ranks)
            if r in ranks:
                model_group = group
        for ranks in data_groups:
            group = dist.new_group(ranks)
            if r in ranks:
                data_group = group
    _GRID = Grid(world // model_parallel, model_parallel, r // model_parallel,
                 r % model_parallel, data_group, model_group)
    return _GRID


def reset_grid() -> None:
    """Forget the grid: every query answers for the whole world again (the
    groups :func:`setup_grid` made stay with the process group)."""
    global _GRID
    _GRID = None


def _grid() -> Grid:
    return _GRID if _GRID is not None else Grid(world_size(), 1, rank(), 0, None, None)


def model_parallel() -> int:
    """``N``, the processes of a model group (1 without a grid)."""
    return _grid().model_parallel


def data_parallel() -> int:
    """``D = W // N``, the data slices: the world size at ``N = 1``."""
    return _grid().data_parallel


def data_index() -> int:
    """This process's data slice, ``rank // N``: its rank at ``N = 1``."""
    return _grid().data_index


def model_index() -> int:
    """This process's shard of every sharded leaf, ``rank % N``."""
    return _grid().model_index


def data_group():
    """The ranks that share this process's model index (``None``, the
    world, at ``N = 1``)."""
    return _grid().data_group


def model_group():
    """The ranks of this process's data slice (``None`` at ``N = 1``)."""
    return _grid().model_group


def data_distributed() -> bool:
    """Whether the step's data-parallel collectives run: a process group
    exists and, under a grid, its data axis holds more than one slice. At
    ``N > 1, D = 1`` the step is the one-process step but for the model
    group's collectives."""
    return is_distributed() and (model_parallel() == 1 or data_parallel() > 1)


def tp_shard_dim(shape: Sequence[int], model_size: int, min_out: int = TP_MIN_OUT
                 ) -> Optional[int]:
    """0 when a leaf of ``shape`` is sharded over a model group of
    ``model_size`` on its output-channel dim (conv OIHW weights, Linear
    ``[out, in]`` weights and 1-D leaves: dim 0), else ``None``
    (replicated). JAX's ``tp_leaf_spec`` rule on its trailing axis: the dim
    divides evenly and is at least ``min_out``."""
    if model_size > 1 and len(shape) > 0 and shape[0] % model_size == 0 and shape[0] >= min_out:
        return 0
    return None


def state_sharding(state_dict: Mapping[str, torch.Tensor], model_size: int
                   ) -> Dict[str, Optional[int]]:
    """``{name: tp_shard_dim}`` of every entry of a whole state dict (JAX
    ``state_sharding``): parameters, BN running statistics and momentum
    alike, since their shapes mirror the parameters'."""
    return {k: tp_shard_dim(tuple(v.shape), model_size) for k, v in state_dict.items()}


def shard_of(t: torch.Tensor, model_size: int, index: int) -> torch.Tensor:
    """Model index ``index``'s slice of a whole tensor, or the tensor
    itself when :func:`tp_shard_dim` replicates it."""
    if tp_shard_dim(tuple(t.shape), model_size) is None:
        return t
    n = t.shape[0] // model_size
    return t[index * n:(index + 1) * n]


def shard_state_dict(state_dict: Mapping[str, torch.Tensor], model_size: int, index: int
                     ) -> Dict[str, torch.Tensor]:
    """Model index ``index``'s shards of a whole state dict (copies)."""
    return {k: shard_of(v, model_size, index).clone() for k, v in state_dict.items()}


def is_tp_sharded(t) -> bool:
    """Whether ``t`` is a shard that :func:`shard_module` made."""
    return bool(getattr(t, "tp_sharded", False))


@functools.lru_cache(maxsize=16)
def _flags_on(flags: Tuple[bool, ...], device: torch.device) -> torch.Tensor:
    """``flags`` as a bool tensor on ``device``: uploaded once, since a
    host list sent to the card is a blocking copy every time."""
    return torch.tensor(flags, device=device)


def whole_norms(norms: torch.Tensor, tensors: Sequence[torch.Tensor], group) -> torch.Tensor:
    """``norms[..., i]``, the norm of this process's ``tensors[i]``, as the
    norm of the whole leaf: a shard's (:func:`is_tp_sharded`) squared norm
    summed over the model ``group`` (one all-reduce of every shard's at
    once), a replicated tensor's kept. ``norms`` itself at ``group``
    ``None``. LARS's trust ratio and the step's health gradient norm read
    it."""
    if group is None:
        return norms
    sharded = _flags_on(tuple(is_tp_sharded(t) for t in tensors), norms.device)
    squares = norms.square()
    summed = torch.where(sharded, squares, 0.0)
    dist.all_reduce(summed, group=group)
    return torch.where(sharded, summed, squares).sqrt()


def _shardable(sub: nn.Module):
    """The ``(name, tensor)`` pairs of ``sub``'s own that :func:`shard_module`
    judges: every parameter and buffer of a conv, linear or BN, and the
    parameters a module names in ``tp_channel_params`` (the predictor's
    normalization, ``models/heads.PredictorHead``)."""
    if isinstance(sub, (nn.Conv2d, nn.Linear, nn.BatchNorm2d)):
        return list(sub.named_parameters(recurse=False)) + list(sub.named_buffers(recurse=False))
    return [(name, getattr(sub, name)) for name in getattr(sub, "tp_channel_params", ())]


@torch.no_grad()
def shard_module(module: nn.Module, model_size: int, index: int) -> Dict[str, tuple]:
    """Keep model index ``index``'s slice of every sharded parameter and
    buffer of ``module``'s convs, linears and BNs (and of the parameters a
    submodule names in ``tp_channel_params``), in place; returns the
    layout ``{state-dict name: whole shape}`` of the sharded entries, which
    is also set as ``module.tp_layout``, and ``(model_size, index)`` as
    ``module.tp_shard`` (what a second network built like it is sharded
    by, ``recipes/base.ema_network``). Conv and Linear modules keep their
    whole ``in_channels``/``out_channels``; each shard is marked
    (:func:`is_tp_sharded`), which is how the forward
    (``models/resnet.tp_input``, ``models/heads.head_forward``), LARS, the
    health norm and the checkpoint tell a sharded leaf. Call before the
    optimizer is built."""
    layout: Dict[str, tuple] = {}
    module.tp_shard = (model_size, index)
    if model_size == 1:
        module.tp_layout = layout
        return layout
    for prefix, sub in module.named_modules():
        for name, t in _shardable(sub):
            if t is None or tp_shard_dim(tuple(t.shape), model_size) is None:
                continue
            shard = shard_of(t.detach(), model_size, index).clone()
            if isinstance(t, nn.Parameter):
                shard = nn.Parameter(shard, requires_grad=t.requires_grad)
                setattr(sub, name, shard)
            else:
                sub.register_buffer(name, shard)
            shard.tp_sharded = True
            layout[f"{prefix}.{name}" if prefix else name] = tuple(t.shape)
        if isinstance(sub, nn.BatchNorm2d) and getattr(sub, "weight", None) is not None \
                and is_tp_sharded(sub.weight):
            sub.num_features = sub.weight.shape[0]
    module.tp_layout = layout
    return layout


def reshard_like(saved: Mapping[str, torch.Tensor], current: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """``saved`` fitted to ``current``'s shapes: an entry whose dim 0 is
    ``N`` times the current one's becomes this process's model-index slice
    (a whole checkpoint restored under ``--model_parallel N``); an entry of
    the current shape is kept as it is. Keys outside ``current`` pass
    through for ``load_state_dict`` to judge."""
    n, index = model_parallel(), model_index()
    out = {}
    for k, v in saved.items():
        cur = current.get(k)
        if (cur is not None and n > 1 and isinstance(v, torch.Tensor) and v.dim() > 0
                and tuple(v.shape) != tuple(cur.shape)
                and v.shape[0] == cur.shape[0] * n and v.shape[1:] == cur.shape[1:]):
            v = v[index * cur.shape[0]:(index + 1) * cur.shape[0]]
        out[k] = v
    return out


def grid_banner() -> str:
    """The startup line naming the grid (JAX's ``mesh: {...}`` log line,
    ``train/supcon.py:696``)."""
    g = _grid()
    return (f"mesh: {{'data': {g.data_parallel}, 'model': {g.model_parallel}}} over "
            f"{world_size()} process(es); this process: data index {g.data_index}, "
            f"model index {g.model_index}")
