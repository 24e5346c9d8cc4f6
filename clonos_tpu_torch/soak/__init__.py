"""Soak & chaos harness: open-loop SLO tracking with exactly-once
asserted under injected failure (port of ``clonos_tpu/soak``, over the
port's runner on the card).

Every bench number elsewhere in this repo is a closed-loop burst; this
package is the open-loop counterpart — a fixed-rate load driver
(:mod:`soak.driver`) paced by a token bucket whose latency samples are
measured from *intended*-send time (coordinated-omission-corrected), a
windowed SLO engine (:mod:`soak.slo`), and a seeded, replayable chaos
schedule (:mod:`soak.chaos`) injecting cascading kills, slow-worker
gray failures, leader-lease loss, and checkpoint-storage write stalls —
with the epoch audit ledger re-validated against a fault-free control
chain after every injected event. The Clonos reference ships a
Jepsen-style harness for exactly this reason: exactly-once claims only
mean something under repeated, overlapping, adversarial failures.
"""

from .chaos import (ChaosEvent, ChaosSchedule,  # noqa: F401
                    parse_schedule)
from .slo import (SLOSpec, SLOTracker, Window,  # noqa: F401
                  corrected_closed_loop, quantile)
from .driver import (SoakConfig, SoakDriver, SoakHarness,  # noqa: F401
                     build_soak_fixture, default_kill_targets,
                     next_autoscale_artifact_path,
                     next_rescale_artifact_path,
                     next_serve_artifact_path, next_soak_artifact_path)
from .serveload import ServeLoad  # noqa: F401

__all__ = ["ChaosEvent", "ChaosSchedule", "parse_schedule",
           "SLOSpec", "SLOTracker", "Window", "quantile",
           "corrected_closed_loop",
           "SoakConfig", "SoakDriver", "SoakHarness",
           "build_soak_fixture", "default_kill_targets",
           "next_soak_artifact_path", "next_serve_artifact_path",
           "next_rescale_artifact_path",
           "next_autoscale_artifact_path", "ServeLoad"]
