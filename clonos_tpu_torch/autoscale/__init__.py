"""Deterministic autoscaler (port of ``clonos_tpu/autoscale``): the
policy engine that closes the loop on ``ClusterRunner.rescale_live`` and
the read tier.

- :mod:`autoscale.signals` — rolling-window aggregation of the metrics
  the system already exports into a typed, quantized ``ScaleSignals``
  snapshot per completed fence;
- :mod:`autoscale.policy` — a pure, deterministic
  ``ScalePolicy.decide(signals, state)`` with hysteresis, sustain
  windows, cooldowns, and bounded step size;
- :mod:`autoscale.controller` — fence-aligned evaluation that logs
  every decision as a ``SCALE`` determinant (plus the signal snapshot
  it saw) BEFORE acting, so recovery replays decisions bit-identically
  instead of deciding again, and executes re-cuts through the
  fence→drain→migrate→redirect path.
"""

from clonos_tpu_torch.autoscale.signals import (  # noqa: F401
    DEFAULT_WINDOW, ScaleSignals, SignalAggregator, signals_for_level)
from clonos_tpu_torch.autoscale.policy import (  # noqa: F401
    ACTION_CODES, HOLD, SCALE_REPLICAS, SCALE_WORKERS, PolicyConfig,
    PolicyState, ScaleDecision, ScalePolicy)
from clonos_tpu_torch.autoscale.controller import (  # noqa: F401
    AutoscaleController, DecisionLog, decision_row)

__all__ = [
    "DEFAULT_WINDOW", "ScaleSignals", "SignalAggregator",
    "signals_for_level", "ACTION_CODES", "HOLD", "SCALE_REPLICAS",
    "SCALE_WORKERS", "PolicyConfig", "PolicyState", "ScaleDecision",
    "ScalePolicy", "AutoscaleController", "DecisionLog", "decision_row",
]
