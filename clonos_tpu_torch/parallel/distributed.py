"""Worker placement helpers of the port (``clonos_tpu/parallel/
distributed.py``).

For now this module holds only :func:`standby_worker_order`, the pure
placement rule the slot-pool scheduler (``runtime/scheduler.py``) needs.
The rest of the reference module — the multi-host bootstrap, the device
mesh and the sharded-step helpers — is not ported yet (ROADMAP Queue 1
item 9).
"""

from __future__ import annotations

from typing import Sequence


def standby_worker_order(num_workers: int) -> Sequence[int]:
    """The slot-pool scheduler's anti-affinity rule: task group ``i``'s
    standby (the redeploy target when its primary worker dies) is the
    NEXT worker in registration order, so one process loss never takes a
    group and its standby together (reference
    RunStandbyTaskStrategy.java:186 placement)."""
    if num_workers < 1:
        raise ValueError("standby_worker_order: need at least one worker")
    return [(i + 1) % num_workers for i in range(num_workers)]
