"""The matched-point registry: designed exceptions, each with its reason.

An entry here says: this finding's shape is real, but the point is MATCHED
across processes (or the sync, or the later use of an asynchronously
copied tensor, is designed) by a mechanism the static rule cannot see, and
the reason records that mechanism so that a reviewer can check it again
when the cited code changes. An entry with an empty reason is invalid (the
runner rejects it), and an entry matching no finding is STALE and reported
as one: the allowlist must shrink when the code gets cleaner.

Keys are ``Finding.allowlist_key``: ``<rule>:<file>:<scope>:<symbol>``,
free of line numbers, so edits above a designed point do not invalidate
its entry.
"""

from __future__ import annotations

from typing import Dict

ALLOWLIST: Dict[str, str] = {
    # -- train/supcon.py: the NaN-rollback recovery point -----------------
    # The counterpart of the JAX linter's one entry. The except
    # NonFiniteLossError handler makes the collective crash save and may
    # swallow (rollback) rather than re-raise. NonFiniteLossError is raised
    # on EVERY process at the same flush boundary: the boundary's
    # failure-code exchange (TelemetrySession.check_failures_global, one
    # all-gather) gathers every rank's code, and the exception raised is a
    # pure function of the gathered codes; should_rollback() reads the
    # policy state that every checkpoint carries, the same on every rank.
    # So all ranks enter the handler, save together, and take the same
    # branch.
    "collective-schedule:swallowed-try:simclr_pytorch_distributed_tpu_torch/"
    "train/supcon.py:_train:NonFiniteLossError:train_one_epoch":
        "matched point: NonFiniteLossError is raised on every rank at one flush "
        "boundary by check_failures_global's failure-code all-gather, and the "
        "rollback-or-reraise branch is deterministic from the policy state every "
        "checkpoint carries: all ranks swallow or re-raise together",
    # -- serve/engine.py: the staged chunk --------------------------------
    # _dispatch_chunk enqueues the upload of the pinned `staging` buffer
    # and the readback into the pinned `host` buffer, records a CUDA event
    # after them, and hands both buffers to a _Chunk. The _Chunk only holds
    # them: _Chunk.wait synchronizes on that event before it reads `host`,
    # and `staging` (filled through its numpy view BEFORE the upload) is
    # never written again; it is kept alive so that its pinned block is not
    # reused while the upload may still read it.
    "donation-safety:unsynced-async-copy:simclr_pytorch_distributed_tpu_torch/"
    "serve/engine.py:EmbeddingEngine._dispatch_chunk:host":
        "handed to the chunk unread: _Chunk.wait synchronizes on the event "
        "recorded after this readback before it reads the buffer",
    "donation-safety:unsynced-async-copy:simclr_pytorch_distributed_tpu_torch/"
    "serve/engine.py:EmbeddingEngine._dispatch_chunk:staging":
        "handed to the chunk only to keep the pinned input alive until "
        "_Chunk.wait synchronizes on the chunk's event; nothing writes it after "
        "the upload is enqueued",
}


def validate(allowlist: Dict[str, str] = None) -> None:
    """Reject malformed entries up front (the gate's reason contract)."""
    if allowlist is None:
        allowlist = ALLOWLIST
    for key, reason in allowlist.items():
        if not isinstance(reason, str) or not reason.strip():
            raise ValueError(
                f"allowlist entry {key!r} carries no reason — every "
                "designed matched point must record why it is safe"
            )
