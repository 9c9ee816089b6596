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

A failed collective raises (``torch.distributed``'s own error, or its
``timeout``); nothing here catches it.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

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
    """Leave the process group, if there is one."""
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
