"""RunObservability: the epoch drivers' one-call observability wiring (JAX
``utils/obs.py``).

Every driver wants the same stack (flight recorder, stall watchdog,
Prometheus sidecar, health monitor) with the same lifecycle, and the
teardown order matters: the recorder outlives the last checkpoint commit,
so its span lands in the record, and the watchdog keeps watching while
that can wedge. Keeping the wiring here keeps the order the same in every
driver::

    obs = RunObservability(cfg, name="supcon")
    telemetry = TelemetrySession(..., watchdog=obs.watchdog, gauges=obs.gauges)
    try:
        ...
    finally:
        ...
        obs.close(exit_code=exit_code_for(exc))

The port's checkpoint saves are synchronous, so there is no pending-save
gauge. The health monitor takes the run's recipe's bars
(``utils/guard.thresholds_for_recipe``) and its extra metric columns; the
probe and CE trainers, which have no recipe, the defaults.
"""

from __future__ import annotations

import logging

from simclr_pytorch_distributed_tpu_torch.utils import prom, tracing
from simclr_pytorch_distributed_tpu_torch.utils.guard import (
    HealthMonitor,
    thresholds_for_recipe,
)

logger = logging.getLogger(__name__)


class RunObservability:
    """Build, and later tear down in order, the per-run observability
    stack of a trainer config:

    - ``recorder``: installed as the module-level tracing recorder, writing
      ``<save_folder>/events.jsonl`` and, on close, ``trace.json``; ``None``
      under ``--flight_recorder off``;
    - ``watchdog``: a started :class:`tracing.StallWatchdog` beaten at the
      flush boundaries; ``None`` unless ``--watchdog_secs > 0``;
    - ``gauges`` and the ``--metrics_port`` sidecar; ``None`` when the port
      is 0;
    - ``health``: a :class:`guard.HealthMonitor` when the config has
      ``health_freq > 0`` (pretraining only); ``None`` otherwise.
    """

    def __init__(self, cfg, name: str):
        self.recorder = tracing.recorder_for_run(
            cfg.save_folder, enabled=(cfg.flight_recorder != "off")
        )
        tracing.install(self.recorder)
        self.watchdog = None
        if cfg.watchdog_secs > 0:
            self.watchdog = tracing.StallWatchdog(
                cfg.watchdog_secs, cfg.save_folder, recorder=self.recorder, name=name,
            )
        self.health = None
        if getattr(cfg, "health_freq", 0) > 0:
            from simclr_pytorch_distributed_tpu_torch.recipes import recipe_metric_keys

            # the recipe's bars (guard.RECIPE_HEALTH_THRESHOLDS: raised for
            # the negative-free recipes) and its metric columns in the
            # window means (JAX utils/obs.py:66-82)
            recipe = getattr(cfg, "recipe", None)
            self.health = HealthMonitor(
                policy=getattr(cfg, "health_policy", "warn"),
                thresholds=thresholds_for_recipe(recipe),
                extra_keys=recipe_metric_keys(recipe),
            )
        self.gauges = self.sidecar = None
        if cfg.metrics_port:
            self.gauges = prom.TrainerGauges()
            if self.recorder is not None:
                # records evicted from the recorder's bounded ring
                rec = self.recorder
                self.gauges.register("recorder_dropped_records", lambda: rec.dropped)
            self.sidecar = prom.start_metrics_server(
                cfg.metrics_port, self.gauges.prometheus_text,
                host=getattr(cfg, "metrics_host", "127.0.0.1"),
            )
            logger.info("metrics sidecar on %s:%d", *self.sidecar.server_address[:2])

    def set_epoch(self, epoch: int) -> None:
        if self.gauges is not None:
            self.gauges.set(epoch=epoch)

    def close(self, exit_code: int = None) -> None:
        """Teardown, last in the driver's ``finally``: stamp the terminal
        ``train_exit_code`` gauge and a ``run_exit`` event, stop the
        watchdog and the sidecar, then uninstall and close the recorder
        (which exports ``trace.json`` and never raises)."""
        if exit_code is not None:
            if self.gauges is not None:
                self.gauges.set_exit_code(exit_code)
            tracing.event("run_exit", track="main:guard", code=int(exit_code))
        if self.watchdog is not None:
            self.watchdog.close()
        if self.sidecar is not None:
            self.sidecar.shutdown()
            self.sidecar.server_close()
        tracing.uninstall()
        if self.recorder is not None:
            self.recorder.close()
