"""The multi-rank probe (``__graft_entry__.dryrun_multichip`` /
``_dryrun_impl``): the flagship job's supersteps sharded over ``n`` rank
processes of a ``torch.distributed`` task mesh, and on one rank, timed;
one JSON line with the measured aggregate and per-shard rates and the
scaling efficiency of the sharded run against the one-rank run.

The load-bearing checks are that the sharded program runs, holds only
its shards on every rank, and ends with the one-rank run's record counts
bit for bit. Ranks that share one card over gloo (``--backend gloo``
with ``--device cuda``) stage every collective through host memory:
their rates measure that protocol, not a link between cards.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

#: timed supersteps per run (after a 2-step warm-up)
N_STEPS = 6
#: records a source subtask emits per superstep (the flagship's batch)
BATCH = 32


def _timed_run(compiled, device):
    """Init, 2 warm-up supersteps, then :data:`N_STEPS` timed ones."""
    from clonos_tpu_torch.runtime.executor import StepInputs
    carry = compiled.init_carry(device)
    dev = torch.device(device)
    inputs = StepInputs(torch.full((), 5, dtype=torch.int32, device=dev),
                        torch.full((), 9, dtype=torch.int32, device=dev))
    for _ in range(2):               # the second step exercises the edges
        carry, _ = compiled.superstep(carry, inputs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    for _ in range(N_STEPS):
        carry, _ = compiled.superstep(carry, inputs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.monotonic() - t0, carry


def _compiled(n_devices: int, mesh):
    from clonos_tpu_torch.examples.flagship import flagship_job
    from clonos_tpu_torch.runtime.executor import CompiledJob
    # Parallelism == ranks, so every [P]-leading leaf shards 1:1.
    return CompiledJob(flagship_job(parallelism=n_devices),
                       log_capacity=1 << 9, max_epochs=8,
                       inflight_ring_steps=16, mesh=mesh)


def _rank(ctx, n_devices: int) -> dict:
    """One rank: the sharded run; rank 0 then runs the same job alone."""
    from clonos_tpu_torch.causal import log as clog
    from clonos_tpu_torch.parallel import distributed as dist_
    dev = ctx.device
    mesh = dist_.task_mesh(device=dev)
    if sorted(dist_.standby_device_order(mesh)) != list(range(n_devices)):
        raise RuntimeError("standby order is not a permutation of the ranks")
    compiled = _compiled(n_devices, mesh)
    wall, carry = _timed_run(compiled, dev)
    compiled.constrain_carry(carry)
    shards = [(x.shape[0] if x.dim() else 0) for x in
              (carry.op_states[0]["seq"], carry.record_counts)]
    full = dist_.all_gather_tree(carry, compiled.placements(), mesh)
    out = {"wall_s": wall, "rank": ctx.process_id, "local_rows": shards,
           "sizes": clog.size(full.logs).cpu().numpy(),
           "records": full.record_counts.cpu().numpy(),
           "local_records": carry.record_counts.cpu().numpy()}
    if ctx.process_id == 0:
        one = _compiled(n_devices, None)
        wall1, carry1 = _timed_run(one, dev)
        out["wall_1dev"] = wall1
        out["records_1dev"] = carry1.record_counts.cpu().numpy()
    return out


def dryrun_multichip(n_devices: int, device="cuda",
                     backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> dict:
    """Spawn ``n_devices`` ranks, time the flagship job's supersteps
    sharded and on one rank, assert the sharded record counts equal the
    one-rank ones, and print one JSON line (the reference's keys, plus
    ``backend`` and ``device``). ``device`` defaults to the card and
    raises without one."""
    from clonos_tpu_torch import device as _device
    from clonos_tpu_torch.parallel import distributed as dist_
    dev = _device.resolve(device)
    be = dist_.backend_for(dev, backend)
    share = dev.type == "cuda" and n_devices > torch.cuda.device_count()
    res = dist_.spawn("clonos_tpu_torch.parallel.dryrun:_rank", n_devices,
                      {"n_devices": n_devices}, device=str(dev), backend=be,
                      timeout_s=timeout_s, share_device=share)
    r0 = res[0]
    sizes = r0["sizes"]
    if not (sizes > 0).all():
        raise RuntimeError("causal logs did not grow")
    recs = r0["records"]
    if not np.array_equal(recs, r0["records_1dev"]):
        raise RuntimeError("sharded record counts diverged from the "
                           "one-rank run")
    for r in res:
        if not np.array_equal(r["records"], recs):
            raise RuntimeError(f"rank {r['rank']} gathered other record "
                               f"counts")
    per_step = BATCH * n_devices
    wall = max(r["wall_s"] for r in res)
    rate = N_STEPS * per_step / wall
    rate_1 = N_STEPS * per_step / r0["wall_1dev"]
    # Per-shard rates from each rank's own share of the record counts.
    total = max(1, int(recs.sum()))
    per_shard = [round(rate * int(r["local_records"].sum()) / total, 1)
                 for r in res] if recs.shape[0] % n_devices == 0 else None
    payload = {
        "ok": True,
        "n_devices": n_devices,
        "subtasks": int(recs.shape[0]),
        "log_rows_per_subtask": int(sizes[0]),
        "records_per_sec_sharded": round(rate, 1),
        "records_per_sec_1dev": round(rate_1, 1),
        "per_shard_records_per_sec": per_shard,
        "speedup": round(rate / rate_1, 3),
        "scaling_efficiency": round(rate / rate_1 / n_devices, 3),
        "timed_supersteps": N_STEPS,
        "backend": be,
        "device": dev.type,
    }
    print(json.dumps(payload), flush=True)
    return payload
