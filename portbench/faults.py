"""Faults planted under the timed path, and the controls, for the checks
that the comparison fails when it should (``controls.py`` on the card,
``tests/test_portbench_faults.py`` on the CPU). A benchmark run plants
none of them.

Faults patch the program's operator classes for the process that plants
them:

- ``state_unchanged``: the window returns its state unchanged from every
  block (a step that leaves its state as it found it);
- ``half_batch``: the source leaves out the second half of every batch;
- ``answer_altered``: the reduce adds one to every total it emits.

The exchange between chips cannot be left out: every cell runs on one
card. Controls break a guarantee the configuration states:

- ``drop_overflow``: the program at an edge capacity of one batch a
  lane, so keyBy drops what a lane gets beyond its share (the
  configuration guarantees no record is dropped);
- ``rollback``: recovery in the reference's stead restores the last
  completed checkpoint and does not replay the pending epoch (the
  configuration guarantees the state of a run that never failed).
"""

from __future__ import annotations

import contextlib

FAULTS = ("state_unchanged", "half_batch", "answer_altered")
CONTROLS = ("drop_overflow", "rollback")


@contextlib.contextmanager
def planted(name: str):
    """Patch the program with fault ``name`` while open."""
    from clonos_tpu_torch.api import operators as ops
    from clonos_tpu_torch.api.records import zero_invalid
    saved = []

    def patch(cls, attr, fn):
        saved.append((cls, attr, getattr(cls, attr)))
        setattr(cls, attr, fn)

    if name == "state_unchanged":
        inner = ops.TumblingWindowCountOperator.process_block

        def window_block(self, state, batches, bctx):
            _, out = inner(self, state, batches, bctx)
            return state, out
        patch(ops.TumblingWindowCountOperator, "process_block", window_block)
    elif name == "half_batch":
        for cls in (ops.SyntheticSource, ops.HostFeedSource):
            def source_block(self, state, batches, bctx,
                             inner=cls.process_block):
                state, out = inner(self, state, batches, bctx)
                valid = out.valid.clone()
                valid[..., valid.shape[-1] // 2:] = False
                return state, zero_invalid(out._replace(valid=valid))
            patch(cls, "process_block", source_block)
    elif name == "answer_altered":
        inner = ops.KeyedReduceOperator.process_block_static_keys

        def reduce_block(self, state, batches, bctx, slot_keys):
            state, out = inner(self, state, batches, bctx, slot_keys)
            return state, zero_invalid(out._replace(values=out.values + 1))
        patch(ops.KeyedReduceOperator, "process_block_static_keys",
              reduce_block)
    elif name not in ("none",) + CONTROLS:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for cls, attr, fn in reversed(saved):
            setattr(cls, attr, fn)


def overrides(name: str, config: dict) -> dict:
    """Configuration overrides a control runs at."""
    if name == "drop_overflow":
        return {"edge_capacity": config["batch"]}
    return {}


def rollback(ctx, cap: dict, device) -> None:
    """Put, in place of each recovered state, the state a recovery that
    restored the last completed checkpoint without replay would leave:
    the reference's state one epoch before the kill."""
    spe = ctx.config["steps_per_epoch"]
    ref = ctx.topology.reference(ctx, cap["steps"], device)
    cap["recovered"] = [(s, ref.state_at(s - spe))
                        for s, _ in cap["recovered"]]
