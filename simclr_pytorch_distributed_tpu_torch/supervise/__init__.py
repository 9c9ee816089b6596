"""supervise/: the elastic, self-healing training supervisor and the
serving replica fleet (the port's copy of JAX ``supervise/``).

The observability layer produces every signal an automated operator needs:
the ``/metrics`` liveness gauge ``train_last_boundary_age_seconds`` and the
boundary-skew gauges (``utils/prom.py``, ``utils/telemetry.py``), the
stall watchdog's dumps, ``health_alarm`` recorder events and the typed exit
codes (75 preempted; health 3 > flush 2 > NaN 1, ``utils/guard.py``). The
supervisor closes the loop: it launches a training job as a child process,
watches it through those channels, and decides through an explicit,
testable policy whether to relaunch with ``--resume``, relaunch resized
onto another process count (legal because a checkpoint resumes under any
world size, ``utils/checkpoint.py``), back off and retry, or give up. Every
observation and decision lands as an event in the supervisor's own
``events.jsonl`` through the port's ``FlightRecorder``.

One concern a module:

- :mod:`policy`: the pure decision policy, ``ExitObservation`` in,
  ``Decision`` out; no I/O;
- :mod:`observe`: the Prometheus text parser and sidecar scraper, the
  straggler tracker, and the run-folder watcher (stall dumps, recorder
  events, new checkpoints);
- :mod:`launch`: resume-folder resolution, ``--resume`` injection, the
  process-count and share hooks, graceful terminate-then-kill;
- :mod:`supervisor`: the loop tying them together;
- :mod:`__main__`: the CLI, ``python -m
  simclr_pytorch_distributed_tpu_torch.supervise [flags] -- <command>``;
- :mod:`replica` / :mod:`replica_fleet`: the same discipline from one
  trainer to N serving replicas: the pure ``ReplicaPolicy`` decision table
  (liveness from the ``serve_batcher_last_completion_age_s`` gauge,
  saturation from occupancy and queue depth, per-replica restart budgets)
  and the ``ReplicaFleetSupervisor`` loop that spawns, restarts and drains
  ``serve.fleet`` replicas off their scraped ``/metrics``.
"""

from simclr_pytorch_distributed_tpu_torch.supervise.policy import (  # noqa: F401
    Decision,
    DecisionPolicy,
    ExitObservation,
)
from simclr_pytorch_distributed_tpu_torch.supervise.replica import (  # noqa: F401
    ReplicaDecision,
    ReplicaObservation,
    ReplicaPolicy,
)
from simclr_pytorch_distributed_tpu_torch.supervise.replica_fleet import (  # noqa: F401
    ReplicaFleetConfig,
    ReplicaFleetSupervisor,
)
from simclr_pytorch_distributed_tpu_torch.supervise.supervisor import (  # noqa: F401
    SuperviseConfig,
    Supervisor,
)
