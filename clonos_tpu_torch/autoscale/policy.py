"""Pure deterministic scaling policy: ``decide(signals, state)`` (port of
``clonos_tpu/autoscale/policy.py``).

No clocks, no I/O, no device — the same (signals, state) pair ALWAYS
yields the same (decision, state') pair, which is what makes a logged
decision replayable bit-for-bit (controller.py) and the policy
explorable at small bounds (the reference's
``verify/models.ScalePolicyModel`` is this function at abstract load
levels).

Three disciplines keep the loop stable:

- **hysteresis** — scale-up and scale-down trigger on different
  thresholds (``high_load`` / ``low_load``) with a dead band between
  them where streaks reset;
- **sustain** — a threshold crossing must persist ``sustain_fences``
  consecutive fences before it counts (one noisy fence is not a trend);
- **cooldown** — after any scale action, ``cooldown_fences`` fences
  must complete before the next one (the system needs time to show the
  effect of the last action before being judged again).

Priority when multiple arms fire: health > cooldown > worker scale-up
> replica add > worker scale-down > replica drop > hold. An unhealthy
cluster (failed subtask, unfenced epoch) always holds — rescaling over
an in-progress recovery is the one thing the exactly-once machinery
cannot absorb (``rescale_live`` refuses it too; the policy refusing
first keeps the refusal out of the hot path).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from clonos_tpu_torch.autoscale.signals import ScaleSignals

# decision actions
HOLD = "hold"
SCALE_WORKERS = "scale-workers"
SCALE_REPLICAS = "scale-replicas"

#: action string <-> SCALE determinant row code (causal/determinant.py)
ACTION_CODES = {HOLD: 0, SCALE_WORKERS: 1, SCALE_REPLICAS: 2}
CODE_ACTIONS = {v: k for k, v in ACTION_CODES.items()}


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    high_load: float = 1.25      # sustained offered/achieved above: up
    low_load: float = 0.55       # sustained below: down (hysteresis band)
    sustain_fences: int = 2      # consecutive fences a signal must hold
    cooldown_fences: int = 3     # fences between scale actions
    max_step: int = 1            # bounded step size per action
    min_workers: int = 1
    max_workers: int = 8
    staleness_high: int = 2      # replica lag (epochs) that adds a replica
    read_p99_high_ms: float = 50.0
    min_replicas: int = 1
    max_replicas: int = 4

    def __post_init__(self):
        if self.min_workers < 1 or self.max_workers < self.min_workers:
            raise ValueError("worker bounds must satisfy "
                             "1 <= min_workers <= max_workers")
        if self.max_step < 1 or self.sustain_fences < 1:
            raise ValueError("max_step and sustain_fences must be >= 1")
        if self.low_load >= self.high_load:
            raise ValueError("hysteresis requires low_load < high_load")


@dataclasses.dataclass(frozen=True)
class PolicyState:
    """Everything the policy carries between fences. Reconstructable
    from the decision log (controller.py replays the log through
    ``decide`` to rebuild it — no hidden state)."""

    cooldown: int = 0        # fences left before the next action allowed
    over_streak: int = 0     # consecutive fences with load >= high_load
    under_streak: int = 0    # consecutive fences with load <= low_load
    stale_streak: int = 0    # consecutive fences with read tier lagging
    seq: int = 0             # decisions issued so far
    last_action: str = HOLD
    last_epoch: int = -1


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    epoch: int
    seq: int                 # 1-based decision sequence number
    action: str              # HOLD | SCALE_WORKERS | SCALE_REPLICAS
    delta: int = 0           # signed step; 0 for hold
    target_workers: int = 0
    target_replicas: int = 0
    reason: str = ""
    signal_crc: int = 0

    @property
    def scales(self) -> bool:
        return self.action != HOLD

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ScalePolicy:
    """The deterministic decision function. Stateless — all memory
    lives in the :class:`PolicyState` threaded through ``decide``."""

    def __init__(self, config: PolicyConfig = None):
        self.cfg = config or PolicyConfig()

    def decide(self, s: ScaleSignals,
               st: PolicyState) -> Tuple[ScaleDecision, PolicyState]:
        cfg = self.cfg
        # Fold this fence's signals into the streaks; hysteresis dead
        # band (low_load < load < high_load) resets both rate streaks.
        over = st.over_streak + 1 if s.load >= cfg.high_load else 0
        under = st.under_streak + 1 if s.load <= cfg.low_load else 0
        lagging = (s.max_staleness > cfg.staleness_high
                   or s.p99_read_ms > cfg.read_p99_high_ms)
        stale = st.stale_streak + 1 if lagging else 0
        cooldown = max(0, st.cooldown - 1)
        seq = st.seq + 1
        # A cluster with a sustained gray suspect is unhealthy too: a
        # re-cut would assign key groups to a worker already diagnosed
        # as limping (obs/detect.py feeds gray_suspects).
        healthy = (s.failed_subtasks == 0 and not s.unfenced
                   and s.gray_suspects == 0)

        action, delta, tgt_w, tgt_r, reason = (
            HOLD, 0, s.workers, s.replicas_total, "steady")
        if not healthy:
            reason = ("gray-suspect" if s.gray_suspects
                      and s.failed_subtasks == 0 and not s.unfenced
                      else "unhealthy")
        elif cooldown > 0:
            reason = "cooldown"
        elif over >= cfg.sustain_fences and s.workers < cfg.max_workers:
            delta = min(cfg.max_step, cfg.max_workers - s.workers)
            action, tgt_w = SCALE_WORKERS, s.workers + delta
            reason = "sustained-high-load"
        elif stale >= cfg.sustain_fences \
                and s.replicas_total < cfg.max_replicas:
            delta = 1
            action, tgt_r = SCALE_REPLICAS, s.replicas_total + 1
            reason = "read-tier-lagging"
        elif under >= cfg.sustain_fences and s.workers > cfg.min_workers:
            delta = -min(cfg.max_step, s.workers - cfg.min_workers)
            action, tgt_w = SCALE_WORKERS, s.workers + delta
            reason = "sustained-low-load"
        elif under >= cfg.sustain_fences \
                and s.replicas_total > cfg.min_replicas:
            delta = -1
            action, tgt_r = SCALE_REPLICAS, s.replicas_total - 1
            reason = "read-tier-idle"

        if action != HOLD:
            # the world is about to change: restart the cooldown clock
            # and every streak — post-action signals are a new trend.
            cooldown = cfg.cooldown_fences
            over = under = stale = 0
        decision = ScaleDecision(
            epoch=s.epoch, seq=seq, action=action, delta=delta,
            target_workers=tgt_w, target_replicas=tgt_r,
            reason=reason, signal_crc=s.crc())
        new_state = PolicyState(
            cooldown=cooldown, over_streak=over, under_streak=under,
            stale_streak=stale, seq=seq, last_action=action,
            last_epoch=s.epoch)
        return decision, new_state
