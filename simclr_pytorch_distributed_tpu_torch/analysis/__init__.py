"""Static invariant linter for the port's distributed and zero-sync contracts.

The counterpart of the JAX package's ``analysis/`` (the module names are
its own, so a reader finds each pair), retargeted at PyTorch: stdlib
``ast`` only, importing neither torch nor jax, over the port package and
``scripts/port_*.py``:

- :mod:`.rule_collectives`: no ``torch.distributed`` collective (or a
  port wrapper of one, the tensor-parallel model-group and data-group
  collectives among them) under a process-dependent conditional, after a
  process-dependent early exit, or inside an exception-swallowing ``try``;
- :mod:`.rule_donation`: no host use of a tensor that a
  ``non_blocking=True`` copy may still be reading or writing (the port has
  no buffer donation; this is the hazard in its place);
- :mod:`.rule_hotloop`: no host sync (``.item()``, ``.cpu()``,
  ``.synchronize()``, a blocking ``torch.tensor(..., device=...)``, ...)
  inside the flush-boundary loops, the step functions or the kernel
  wrappers;
- :mod:`.rule_registry`: metric-key tuples sorted, unique and
  single-sourced, artifact schemas pinned to module constants, the
  trainers' shared flags agreeing through ``config.py``.

Designed matched points live in :mod:`.allowlist` with a recorded reason;
everything else is a finding. ``scripts/port_invariant_lint.py`` is the
CLI and ``scripts/port_ratchet.py --configs invariant_lint`` the gate.
"""

from simclr_pytorch_distributed_tpu_torch.analysis.core import Finding  # noqa: F401
from simclr_pytorch_distributed_tpu_torch.analysis.runner import (  # noqa: F401
    RULE_FAMILIES,
    SCHEMA,
    build_output,
    run_lint,
)
