#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``clonos_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels from ``clonos_tpu_torch/ops/csrc``
at first use, holds each against its plain PyTorch version at the main
path's shapes, drives the job of ``bench.py``'s headline ("bench-allround":
8 sources -> keyBy -> 8 tumbling windows -> keyBy -> 8 reduces -> 8
sinks, 128 records per source subtask per step, 997 keys, edge capacity
1024) on the card, checks the card run against a CPU run of the same
blocks, runs the local-recovery protocol against a golden run, and seals
audit ledgers on the card and on the CPU. Every phase raises on failure,
so the script exits non-zero. Without a CUDA card it exits non-zero
before any phase runs.

Phases:
  1. device line and kernel build;
  2. kernel vs plain version on the card, bit for bit, with times (CUDA
     events, CUPTI device time, host time per call) against the bound,
     the plain version and ``scatter_add_``, at the paths' shapes, a
     one-launch floor, two skewed-key rows and an unaligned view;
     then the interval join's keyed-rank kernel at config #5's replay
     and fill shapes, bit for bit, timed against its bound, its plain
     version and the one-hot ``torch.cumsum`` (``[keyed-rank]`` lines);
  3. the card's run of two blocks equals the CPU's, bit for bit; a third
     block on the card under torch.profiler (where the time goes);
  4. the main path: 3 epochs + 256 steps, counting kernel launches;
  5. recovery, each bit-identical to the golden run that follows the
     same schedule: one subtask of every vertex class (source, window,
     reduce, sink), a window with the reduce it feeds, a window with a
     sink, a recovery across an open epoch whose checkpoint is pending,
     and a failover drill; the window recovery takes the device-resident
     determinant stream and its synchronising calls are counted;
  6. the audit: ledgers sealed on the card and on the CPU over phase 3's
     job and step count are equal, and a recovery on the card validates
     against its ledger;
  7. the overlapped runtime at phase 4's widths, with the audit on and
     checkpoints on disk, each against its sequential control: (a) the
     pipelined fence (``overlap_epoch=True``, latency markers every 64
     steps) equals the sequential fence leaf for leaf and ledger for
     ledger, and its capture windows make no synchronising call; (b) a
     window kill while a fence tail is in flight; (c) the overlapped
     recovery finalize against ``overlap_finalize=False`` on the same
     failure, across a pending checkpoint; (d) two window subtasks failed
     together, sharing routed windows; (e) ``bootstrap_standby`` of the
     whole job from the durable checkpoint and mirror rows of the
     control's logs, equal to it at the fence and one epoch on;
  8. tiered storage at the same widths with ``bench.py --spill``'s
     schedule (spool and checkpoint dirs under ``build/``, up to ~1 GB,
     removed at the end): (a) the steady state with spill off,
     ``availability`` and ``eager``, leaf-equal, the spill hook making no
     synchronising call; (b) a window kill whose replay span is four rings
     long, refilled from the host and disk tiers, its ledger and carry
     equal to a no-spill control's; (c) a torn segment of that span
     refused with a labelled RecoveryError; (d) a window and a reduce
     subtask recovered from an incremental checkpoint chain, bit-identical
     to a golden run, with no synchronising call in the pipelined
     fence's capture windows.

  9. the host boundaries of BASELINE configs #4 and #5 at full width:
     (a) config #4 (a Kafka-like feed, 64 subtasks): a failover drill and
     a cascading kill of a feed source, a window and a reduce subtask,
     timers on a window subtask re-firing once each, equal committed feed
     offsets, no synchronising call in the pending epoch's block window
     (``[feeds]``); (b) config #5 (an interval join, 128 subtasks, >= 10M
     buffered determinants): a join drill and the kill of a join subtask
     whose causal services made three external calls, replayed from the
     sidecar without calling out again (``[join]``); (c) two feeds ->
     union -> event-time window -> transactional file sink through the
     pipelined fence: a union, a window and a sink subtask killed, the
     committed part files byte-identical to the golden run's; then the
     sliding and the session window (``[egress]``);
 10. in-process observability at the headline's widths
     (``[observability]``): (a) ``bench.py``'s overhead probe under the
     process profiler (``overhead.ft-fraction`` in [0, 1], the expected
     sections, profiler fences counted), and the spill sections of
     phase 8 (a)'s epochs with spill off, ``availability`` and
     ``eager``; (b) phase 7's pipelined runner traced to a file through
     two epochs and a window recovery equal to a golden run, the file's
     Chrome export valid and each ``recovery.<phase>`` span equal to
     ``phase_ms`` within 0.01 ms; (c) 0 synchronising calls in the
     traced capture windows, and source records/s with the tracer off,
     on, on, off (a reading); (d) ``MetricsEndpoint`` on 127.0.0.1
     serving ``/metrics``, ``/metrics.json``, ``/metrics/history.json``
     and ``/trace``, ``overhead.ft-fraction`` in both metric views;
 11. the process runtime: (a) BASELINE config #1, the socket wordcount
     fed over TCP with a window recovery (``[socket]``); (b) the wordcount
     job's host-loss failover across two processes (``[failover]``);
 12. the read tier at the headline's widths (``[serve]``): (a) point and
     batched reads through a replica, equal to the owner's at the same
     epoch stamp, the replicas' tables equal to the reduce's state and to
     a CPU run's, one gather per batch and no synchronising call in the
     serve window; (b) routed reads from a reader thread while the
     pipelined, audited runner ingests, a replica killed and revived with
     no client-visible error, the sealed ledger equal to the same
     runner's without a tier, no synchronising call in the capture
     windows.
 13. the slot pool (``[spanning]``, ``[multitenant]``): (a) the headline
     job cut on its window -> reduce edge across two ``python -m
     clonos_tpu_torch slotworker`` processes, deployed by a
     ``SlotPoolScheduler`` here; an in-process upstream times the edge
     export's ``publish`` (0 synchronising calls) and its stream equals
     worker a's; worker b is SIGKILLed after its sixth epoch and only
     its group is rebuilt, on a, equal to b's reported fence; every
     fence of b and of the rebuilt slice equals an in-process control on
     the card; a deposed fencing token's DEPLOY is refused. (b) three
     tenants of the wordcount job under an embedded ``Dispatcher`` (one
     submitted by the ``submit`` CLI, all listed by ``jobs --json``),
     worker b killed between two rounds, red and blue rebuilt on a to
     fences b reported, green deployed once and fencing through the
     storm within max(30 s, 25 x its median gap), every digest equal to
     one control, per-job ledgers and trace files, exactly-once per job.
 14. the cross-process observability planes (``[planes]``): (a) their
     cost in-process, phase 7's pipelined runner at the headline's widths
     with every plane off, the HLC and timeline on, lineage on (audit
     off: the window captured for lineage alone) and all on: source
     records/s, ``fence.lineage-observe`` ms a fence, 0 synchronising
     calls in every capture window, state digests and ledgers equal
     across the turns; (b) phase 11 (b)'s failover with
     ``--timeline-dir``, lineage and incidents on and a transactional
     sink, the worker killed on sight: the merged timeline (the
     ``timeline --report json`` CLI) has no causality inversion and a
     send and a receive for each verb, the gray-failure detector calls
     the killed worker a suspect and ``incident explain`` names it, the
     rebuild equals the worker's reported digest, and every sink part a
     dyed key's path reaches is committed across the failover; (c) phase
     13 (a)'s spanned job with the HLC on, its DEPLOY and FETCH_EDGE
     receives ordered after their sends.

 15. live rescaling and the autoscaler (``[rescale]``), on the headline's
     widths with a hash exchange into its sinks: (a) ``restore_rescaled``
     8 -> 16 and 8 -> 4 lanes from a completed checkpoint, the sink
     multiset of the next 2 epochs equal to a never-rescaled control's,
     every table holding only its owner's keys, every ``keyed_hist``
     launch of the re-cut equal to its plain version; (b) ``rescale_live``
     8 -> 16 on phase 7's runner: the protocol's transitions in order,
     in-flight records drained, the fenced-off runner refused, a twin
     killed in the first epoch at 16 lanes recovered equal to the re-cut
     run, the stall, the first epoch and records/s at 8 and 16 lanes; (c)
     a read tier on the reduce with a reader thread through the re-cut,
     0 client errors, re-homed replicas equal to the owner, a replica
     added and dropped; (d) an ``AutoscaleController`` on the live runner
     and tier deciding 16 -> 8 once on a seeded load trace and executing
     it through ``rescale_live``, cooldown and a failed subtask holding,
     a replay from its log executing nothing, the same trace logging the
     same bytes, ``scale.decision`` records in the timeline; every
     epoch's ledger equal to a never-rescaled control's through the
     key-group directory, and the exact diff not.
 16. the soak and chaos harness (``[soak]``) at the headline's widths as
     phase 15 cuts them, 256-step epochs, 8-step chunks: (a) the paced
     loop's chunk back to back (records/s, chunk ms, launches and
     synchronising calls a chunk, which must be 0, and the chunk's
     ``keyed_hist`` shapes, each checked in phase 2); (b) the open-loop
     soak at half of (a)'s rate with a 2-replica read tier on the reduce
     and a kill cascade, a gray worker, a leader loss, a storage stall, a
     backlog, a replica kill and a live re-cut to 16 lanes over a window ->
     reduce buffer that holds records: the verdict passes exactly once, 0
     read errors, reads rerouted, the staleness peak above its final
     value, the runner's ledger equal to its control twin's through the
     group directory; (c) one unlogged perturbation fails the run with a
     ring divergence; (d) a load spike makes the autoscaler re-cut the job
     itself, with no operator event, at most one action per cooldown, a
     clean audit, and its decision log replayed to the same digest.
 17. the sharded deployment (``[mesh]``) at phase 7's widths and settings
     on a ``torch.distributed`` task mesh, each run through 2 completed
     epochs, 1 pending, the window subtask on rank 1 killed and
     recovered, 1 completed epoch, against an unsharded control on the
     same schedule: (a) one rank over NCCL, (b) two ranks sharing the
     card over gloo, each collective staged through pinned host memory
     (records/s a rank, collective ms, collectives and synchronising
     calls a block), (c) the kill recovered on its rank (recovery ms,
     ``restore_bytes`` against ``checkpoint_bytes``, every other live
     shard unchanged): each ledger and digest equal to the control's,
     ``per_shard_health`` of shape (n, 3), every keyed_hist launch of the
     first epoch equal to its plain version at a shape phase 2 timed;
     (d) ``python -m clonos_tpu_torch dryrun --devices 2`` on the card's
     two gloo ranks; (e) (b)-(c) again with the pipelined fence, whose
     worker gathers each fence to rank 0 over its own gloo group; and
     what NCCL says when two ranks share one card, printed as it said
     it. Timers on the killed subtask fire again once after its
     recovery, on the rank that runs it alone.
 18. the sharded deployment's host boundaries and storage
     (``[mesh-storage]``) at config #4's widths: (a) a host-fed source,
     (b) a transactional file sink under a lineage plane (rank 0's
     observation file equal to the control's, every rank's sink termini
     in it), (c) tiered spill (every rank's segment index records carry
     the ledger's digests), (d) incremental checkpoints, each on one NCCL
     rank and two gloo ranks against an unsharded control.
 19. rebuilding and re-cutting a job on a mesh (``[mesh-rebuild]``), each
     on one NCCL rank and two gloo ranks against an unsharded control:
     (a) ``bootstrap_standby`` from the checkpoint directory and the
     mirror rows (its wall and phases), (b) ``restore_rescaled`` 8 -> 16
     from a 2-rank mesh's checkpoint, (c) ``rescale_live`` 8 -> 16 -> 8 by
     the autoscaler (each re-cut's fence stall), (d) phase 11's socket
     wordcount with rank 0's one reader for every rank (records/s beside
     phase 11's): sealed ledgers, state digests and committed offsets
     equal to the control's, every keyed_hist launch of (a)'s epoch after
     the rebuild and of (b) equal to its plain version.
 20. the protocol model checker (``[verify]``): the six models at a big
     bound, clean and with each seeded bug; a model counterexample (an
     unlogged write) replayed by the soak fails the audit while its
     empty-schedule control passes; the scale-policy counterexample's
     load spike with the real autoscaler; conformance traces against the
     port's components.
 21. the static analysis on the card's machine (``[analysis]``): (a) the
     ``lint`` and ``analyze`` verbs exit 0 with fingerprints equal to the
     port's pins; (b) the no-FT ablation twin against the executor on the
     headline job at full width (512-step epochs, one warm-up and three
     timed epochs each): outputs bit-identical, the twin's logs empty,
     nine stripped sites, the measured and static ft-fractions (readings,
     not a claim); (c) phase 20's soak verdicts carry the port's census
     fingerprint.
 22. the kernel build cache and the warm standby (``[compile-cache]``) at
     the headline's widths: (a) two fresh interpreters rebuild the job
     with ``bootstrap_standby(..., compile_cache_dir=D)`` on one new
     directory: the first builds the kernel with ``nvcc`` into D, the
     second builds nothing and adds no file, both carries equal the dead
     runner's at the fence (``finalize.first-step-recompile`` and its
     blocked part, the ``recovery.aot-lower`` span, the ``nvcc``
     seconds); (b) ``prewarm_recovery()`` on the headline runner leaves
     its carry bit-identical, ``aot_lower_first_step`` succeeds, the
     warm's launches equal ``keyed_hist_plain``, and two kills of one
     window subtask recover bit-identical to a control with no build or
     load inside either recovery. Phases 16 and 20 prewarm inside the
     soak driver and print its seconds.

The last three lines are the kernels JSON line, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

PAR = 8
BATCH = 128
VOCAB = 997
NUM_KEY_GROUPS = 64
EDGE_CAPACITY = 1024
STEPS_PER_EPOCH = 1024
BLOCK_STEPS = 512
WINDOW_SIZE = 256
EXTRA_STEPS = 256
DETS_PER_STEP = 4
LOG_CAPACITY = 1 << (2 * STEPS_PER_EPOCH * DETS_PER_STEP).bit_length()
RING_STEPS = 1 << (2 * STEPS_PER_EPOCH - 1).bit_length()
SEED = 5

#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and the
#: non-tensor-core 32-bit rate that bounds scalar int32 adds.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

REDUCTIONS = (
    "reductions from bench.py's bench-allround job: logical_time=True; "
    f"window_size={WINDOW_SIZE} (bench: 1<<30, never fires); "
    f"steps_per_epoch={STEPS_PER_EPOCH} (bench: 4096); "
    f"block_steps={BLOCK_STEPS}; log_capacity={LOG_CAPACITY}; "
    f"inflight_ring_steps={RING_STEPS}; max_epochs=16; seed={SEED}")


def log(msg: str) -> None:
    print(msg, flush=True)


def build_job():
    from clonos_tpu_torch.api.environment import StreamEnvironment
    env = StreamEnvironment(name="bench-allround",
                            num_key_groups=NUM_KEY_GROUPS,
                            default_edge_capacity=EDGE_CAPACITY)
    (env.synthetic_source(vocab=VOCAB, batch_size=BATCH, parallelism=PAR)
        .key_by()
        .window_count(num_keys=VOCAB, window_size=WINDOW_SIZE, name="window")
        .key_by()
        .reduce(num_keys=VOCAB, name="reduce")
        .sink())
    return env.build()


def runner_kw():
    return dict(steps_per_epoch=STEPS_PER_EPOCH, log_capacity=LOG_CAPACITY,
                max_epochs=16, inflight_ring_steps=RING_STEPS,
                block_steps=BLOCK_STEPS, logical_time=True, seed=SEED)


#: the device phases 3-7 drive (the card; a CPU rehearsal may reset it)
DEVICE = "cuda"
#: phase 7's checkpoint directories go here (listed in .gitignore)
SCRATCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def sync():
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


# --- phase 1 ----------------------------------------------------------------

def device_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_build() -> float:
    from clonos_tpu_torch.ops import cuda_build
    from clonos_tpu_torch.ops import histogram as hist
    t0 = time.monotonic()
    hist._lib()
    build_s = time.monotonic() - t0
    info = cuda_build.BUILD_INFO.get(hist._SOURCE, {})
    log(f"[build] {hist._SOURCE}: {build_s:.3f} s "
        f"(nvcc {info.get('seconds', 0.0):.3f} s) -> "
        f"{cuda_build.library_path(hist._SOURCE)}")
    # ptxas -v: registers, shared memory and spills of every instantiation
    for line in str(info.get("log", "")).splitlines():
        log(f"[build] {line}")
    log(f"[build] shared-memory budget per block: "
        f"{hist.smem_budget(torch.device('cuda'))} bytes")
    from clonos_tpu_torch.ops import keyrank
    t0 = time.monotonic()
    keyrank._lib()
    info = cuda_build.BUILD_INFO.get(keyrank._SOURCE, {})
    log(f"[build] {keyrank._SOURCE}: {time.monotonic() - t0:.3f} s "
        f"(nvcc {info.get('seconds', 0.0):.3f} s)")
    for line in str(info.get("log", "")).splitlines():
        log(f"[build] {line}")
    return build_s


# --- phase 2 ----------------------------------------------------------------

#: (label, R, B, nk, counts): the main path's shapes
MAIN_SHAPES = (
    ("route", 512, PAR * BATCH, PAR * EDGE_CAPACITY, True),
    ("route", 512, PAR * BATCH, PAR * EDGE_CAPACITY, False),
    ("window", 512 * PAR, EDGE_CAPACITY, VOCAB, False),
    ("lane", 512, PAR * BATCH, EDGE_CAPACITY, True),
    ("lane", 512, PAR * BATCH, EDGE_CAPACITY, False),
)
#: the exchange shapes of BASELINE configs #4 and #5 (phase 9): their
#: hash exchanges route 512 records a step (16 x 32 and 32 x 16) into
#: 8,192 slots (16 x 512 and 32 x 256); #4's window; the lanes a replay
#: routes
C45_SHAPES = (
    ("c4c5-route", 512, 512, 8192, True),
    ("c4c5-route", 512, 512, 8192, False),
    ("c4-window", 512 * 16, 512, 499, False),
    ("c4-lane", 512, 512, 512, True),
    ("c5-lane", 512, 512, 256, True),
)
#: config #4 split over two ranks (phase 18): a rank routes its 8 of 16
#: destination lanes (8 x 512 slots) of the gathered source block (16 x
#: 32 records a step) and counts its 8 window lanes (512 steps x 8)
MESH_C4_SHAPES = (
    ("c4-route-8", 512, 512, 4096, True),
    ("c4-route-8", 512, 512, 4096, False),
    ("c4-window-8", 512 * 8, 512, 499, False),
)
#: the rescale job split over two ranks (phase 19): a rank routes its 4
#: of 8 sink lanes (4 x 1,024 slots) of the gathered reduce block, the
#: reduce's 8 x 1,152 static-route slots at 8 keyed lanes and its 16 x
#: 1,280 at 16
MESH_RESCALE_SHAPES = tuple(
    (label, 512, b, 4 * EDGE_CAPACITY, counts)
    for label, b in (("sink-route-8-r4", PAR * 1152),
                     ("sink-route-16-r4", 16 * 1280))
    for counts in (True, False))
#: the wordcount job's shapes (phase 11: 4 x 64 records a step, edge
#: capacity 256, 1,000 keys): a 16-step block's exchange routes 256
#: records a step into 1,024 slots, its window counts 64 rows (16 steps x
#: 4 subtasks) of 256; a window replay routes into 256 slots
WC_SHAPES = (
    ("wc-route", 16, 256, 1024, True),
    ("wc-route", 16, 256, 1024, False),
    ("wc-window", 64, 256, 1000, False),
    ("wc-lane", 16, 256, 256, True),
)
#: the socket wordcount's shapes (phase 19 (d)'s first epoch, checked
#: against the plain version: 1 x 64 records a step, edge capacity 256,
#: 1,000 keys): a 16-step block's exchange routes 64 records a step into
#: 256 slots, its window counts 16 rows of 256
WC_SOCKET_SHAPES = (
    ("socket-route", 16, 64, 256, True),
    ("socket-route", 16, 64, 256, False),
    ("socket-window", 16, 256, 1000, False),
)
#: one launch's least device time (R=1 B=16 nk=16, sums only): the
#: yardstick for rows whose bound is below it; the headline window shape
#: with skewed keys (Zipf(1.2) over the keys; 90% of records on one key)
FLOOR_SHAPES = (("floor", 1, 16, 16, False),)
SKEW_SHAPES = (
    ("skew-zipf", 512 * PAR, EDGE_CAPACITY, VOCAB, False),
    ("skew-hot", 512 * PAR, EDGE_CAPACITY, VOCAB, False),
)
#: phase 15's shapes. A re-cut routes one block (R=1) of each hash edge's
#: buffer at the new parallelism: the source edge's 8 x 1,024 slots into
#: 16 or 4 x 1,024 (8 -> 16, 8 -> 4) and its 16 x 1,024 into 8 x 1,024
#: (16 -> 8); the sink edge's 8 x 1,024 into 8 x 1,024. The window ->
#: reduce edge's buffer is placed by its new static plan, no kernel; the
#: rows for its slots through the hash exchange (8 x 1,152 into 4 x
#: 1,152; 16 x 1,280 into 8 x 1,152) stay as readings. In steady state at 16 and 4
#: keyed lanes: the source exchange (512 steps of 8 x 128 records into 16
#: or 4 x 1,024 slots), the reduce -> sink exchange (the reduce's 16 x
#: 1,280, 8 x 1,152 or 4 x 1,152 slots into 8 x 1,024) and the window's
#: rows (512 steps x 16 or 4 lanes)
RESCALE_SHAPES = tuple(
    (label, r, b, nk, counts)
    for label, r, b, nk in (
        ("recut-8to16", 1, PAR * EDGE_CAPACITY, 16 * EDGE_CAPACITY),
        ("recut-8to4", 1, PAR * EDGE_CAPACITY, 4 * EDGE_CAPACITY),
        ("recut-8to4", 1, PAR * 1152, 4 * 1152),
        ("recut-16to8", 1, 16 * EDGE_CAPACITY, PAR * EDGE_CAPACITY),
        ("recut-16to8", 1, 16 * 1280, PAR * 1152),
        ("recut-sink", 1, PAR * EDGE_CAPACITY, PAR * EDGE_CAPACITY),
        ("route-16", 512, PAR * BATCH, 16 * EDGE_CAPACITY),
        ("route-4", 512, PAR * BATCH, 4 * EDGE_CAPACITY),
        ("sink-route-16", 512, 16 * 1280, PAR * EDGE_CAPACITY),
        ("sink-route-8", 512, PAR * 1152, PAR * EDGE_CAPACITY),
        ("sink-route-4", 512, 4 * 1152, PAR * EDGE_CAPACITY))
    for counts in (True, False)) + (
    ("window-16", 512 * 16, EDGE_CAPACITY, VOCAB, False),
    ("window-4", 512 * 4, EDGE_CAPACITY, VOCAB, False))
RESCALE_LABELS = {s[0] for s in RESCALE_SHAPES}
#: phase 16's shapes: the paced loop's ``step()`` is a K=1 block, so each
#: hash exchange routes one step (R=1) — the source edge's 8 x 128 records
#: into 8 x 1,024 slots, the reduce -> sink edge's 8 x 1,152 static-route
#: slots into 8 x 1,024 — and the window counts one step's 8 lanes
SOAK_SHAPES = (
    ("soak-route", 1, PAR * BATCH, PAR * EDGE_CAPACITY, True),
    ("soak-route", 1, PAR * BATCH, PAR * EDGE_CAPACITY, False),
    ("soak-window", PAR, EDGE_CAPACITY, VOCAB, False),
    ("soak-sink-route", 1, PAR * 1152, PAR * EDGE_CAPACITY, True),
    ("soak-sink-route", 1, PAR * 1152, PAR * EDGE_CAPACITY, False),
)
#: phase 20's widths: the soak's keyed lanes before and after its
#: autoscaler's re-cut
VERIFY_LANES = (PAR, 16)


def _verify_shapes():
    """Phase 20's shapes at each of ``VERIFY_LANES``: its paced chunks step
    one step at a time (R=1 routes, one step's window rows, as
    SOAK_SHAPES), each run opens with a whole-epoch block, the control twin
    runs whole epochs, and each run closes with what is left of its last
    epoch, a multiple of the chunk: every block of 8 .. ``SOAK_SPE`` steps
    in chunks. The reduce -> sink exchange routes the window -> reduce
    edge's slots (its capacity as the compiled job widens it at that
    parallelism). The soak driver's ``prewarm_recovery()`` routes one
    lane of a whole-epoch replay window on each exchange. Checked bit for
    bit in phase 2, not timed."""
    from clonos_tpu_torch.runtime.executor import CompiledJob
    out = []
    for lanes in VERIFY_LANES:
        static = CompiledJob(build_rescale_job(lanes), log_capacity=16,
                             max_epochs=2).job.edges[1].capacity
        for steps in (1,) + tuple(range(SOAK_CHUNK, SOAK_SPE + 1,
                                        SOAK_CHUNK)):
            for counts in (True, False):
                out.append((f"verify-route-{lanes}", steps, PAR * BATCH,
                            lanes * EDGE_CAPACITY, counts))
                out.append((f"verify-sink-route-{lanes}", steps,
                            lanes * static, PAR * EDGE_CAPACITY, counts))
            out.append((f"verify-window-{lanes}", steps * lanes,
                        EDGE_CAPACITY, VOCAB, False))
        for counts in (True, False):
            out.append((f"verify-warm-route-{lanes}", SOAK_SPE, PAR * BATCH,
                        EDGE_CAPACITY, counts))
            out.append((f"verify-warm-sink-route-{lanes}", SOAK_SPE,
                        lanes * static, EDGE_CAPACITY, counts))
    return tuple(out)


#: shapes timed against their bound and the library call
TIMED_LABELS = ("route", "window", "lane") + tuple(
    {s[0] for s in C45_SHAPES + WC_SHAPES + WC_SOCKET_SHAPES
     + FLOOR_SHAPES + SKEW_SHAPES
     + RESCALE_SHAPES + SOAK_SHAPES + MESH_C4_SHAPES
     + MESH_RESCALE_SHAPES})
#: the route shape as views one element into their buffers (the kernel's
#: unaligned branch): checked bit for bit, not timed
ALIGN_SHAPES = (("align", 512, PAR * BATCH, PAR * EDGE_CAPACITY, True),)
#: ragged and out-of-range cases, the last past the shared-memory budget
EDGE_SHAPES = (
    ("ragged", 37, 100, VOCAB, True),
    ("ragged", 37, 300, VOCAB, False),
    ("global", 37, 100, 70000, True),
    ("global", 37, 300, 70000, False),
)


def _inputs(r, b, nk, seed, dev, label=""):
    rng = np.random.RandomState(seed)
    if label == "skew-zipf":
        p = np.arange(1, nk + 1, dtype=np.float64) ** -1.2
        keys = rng.choice(nk, (r, b), p=p / p.sum()).astype(np.int32)
    elif label == "skew-hot":
        keys = np.where(rng.rand(r, b) < 0.9, rng.randint(nk),
                        rng.randint(0, nk, (r, b))).astype(np.int32)
    else:
        keys = rng.randint(-3, nk + 4, (r, b)).astype(np.int32)
    vals = rng.randint(-1000, 1000, (r, b)).astype(np.int32)
    valid = rng.rand(r, b) < 0.7
    out = tuple(torch.from_numpy(a).to(dev) for a in (keys, vals, valid))
    if label == "align":
        # Each input a view one element into a buffer of r * b + 1.
        out = tuple(torch.cat([a.reshape(-1)[:1], a.reshape(-1)])[1:]
                    .view(r, b) for a in out)
    return out


def _events_ms(fn, iters) -> float:
    """CUDA events around ``iters`` back-to-back calls, per call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def _time_ms(fn, iters=20, reps=5) -> float:
    """``_events_ms`` after a warm-up: the median of ``reps`` runs (the
    host is shared, and one run can stall)."""
    fn()
    sync()
    return float(np.median([_events_ms(fn, iters) for _ in range(reps)]))


def _device_ms(fn, name_part="hist_", iters=50):
    """Device time per call of the kernels ``fn`` launches whose name holds
    ``name_part`` (every kernel for None), from torch.profiler's CUPTI
    trace; None when the trace shows no device time twice running (a
    session's trace now and then comes back empty)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            sync()
        total_us = 0.0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and (
                    name_part is None or name_part in ev.key):
                total_us += float(getattr(ev, "device_time_total", 0.0)
                                  or getattr(ev, "cuda_time_total", 0.0))
        if total_us > 0:
            return total_us / 1e3 / iters
    return None


def _time_pair_ms(fn_a, fn_b, iters=20, reps=9):
    """``_time_ms`` of two calls, their runs in turns (a b b a a b ...),
    so that both meet the same moments of a shared host."""
    fn_a()
    fn_b()
    sync()
    runs = ([], [])
    for i in range(2 * reps):
        which = (i + i // 2) % 2
        runs[which].append(_events_ms((fn_a, fn_b)[which], iters))
    return float(np.median(runs[0])), float(np.median(runs[1]))


def _host_us(fn, iters=200, reps=5) -> float:
    """Host wall time per call over ``iters`` back-to-back calls (no
    synchronisation inside the timed loop; one after it): the median of
    ``reps`` such runs."""
    fn()
    sync()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        sync()
        runs.append((t1 - t0) / iters * 1e6)
    return float(np.median(runs))


def _bound(r, b, nk, counts, kept):
    """Least time on the card: inputs read once (keys, vals int32, valid
    bool), outputs written once; one int32 add per kept record per
    output. Returns (ms, "bytes" | "operations")."""
    nbytes = r * b * 9 + r * nk * 4 * (2 if counts else 1)
    ops = kept * (2 if counts else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels():
    """Every shape: the kernel against its plain version, bit for bit. The
    timed shapes: CUDA events, host time and the plain and library calls
    first, for every shape, then the profiler's device times, so no event
    or host timing follows a profiler session."""
    from clonos_tpu_torch.ops import histogram as hist
    dev = torch.device("cuda")
    rows = []
    profiled = []
    for i, (label, r, b, nk, counts) in enumerate(
            MAIN_SHAPES + C45_SHAPES + WC_SHAPES + EDGE_SHAPES
            + FLOOR_SHAPES + SKEW_SHAPES + ALIGN_SHAPES + RESCALE_SHAPES
            + SOAK_SHAPES + MESH_C4_SHAPES + MESH_RESCALE_SHAPES
            + WC_SOCKET_SHAPES):
        keys, vals, valid = _inputs(r, b, nk, 100 + i, dev, label)
        aligned = all(a.data_ptr() % 16 == 0 for a in (keys, vals, valid))
        smem_optin, sms = hist._device_info(keys.get_device())
        plan = hist._plan(r, b, nk, counts, aligned, smem_optin, sms)
        s_k, c_k = hist.keyed_hist_cuda(keys, vals, valid, nk, counts)
        s_p, c_p = hist.keyed_hist_plain(keys, vals, valid, nk, counts)
        sync()
        same = torch.equal(s_k, s_p) and (
            (c_k is None and c_p is None) or torch.equal(c_k, c_p))
        err = int((s_k.to(torch.int64) - s_p.to(torch.int64)).abs().max())
        if counts:
            err = max(err, int((c_k.to(torch.int64)
                                - c_p.to(torch.int64)).abs().max()))
        if not same:
            raise AssertionError(
                f"keyed_hist kernel != plain at {label} R={r} B={b} nk={nk} "
                f"counts={counts}: max abs err {err}")
        row = dict(label=label, R=r, B=b, nk=nk, counts=counts,
                   bit_identical=True, max_abs_err=err,
                   branch=("bulk", "direct", "global")[plan.branch],
                   grid=plan.grid, threads=plan.threads, smem=plan.smem,
                   resident=plan.resident)
        rows.append(row)
        if label not in TIMED_LABELS:
            continue
        kept_mask = valid & (keys >= 0) & (keys < nk)
        kept = int(kept_mask.sum())
        # Library yardstick: torch's scatter_add_ on the same inputs,
        # dropped records pointed at a spare slot (index prep untimed).
        idx = torch.where(
            kept_mask, torch.arange(r, device=dev)[:, None] * nk
            + keys.to(torch.int64), r * nk).reshape(-1)
        v = vals.reshape(-1)
        one = kept_mask.to(torch.int32).reshape(-1)
        out_s = torch.zeros(r * nk + 1, dtype=torch.int32, device=dev)
        out_c = torch.zeros(r * nk + 1, dtype=torch.int32, device=dev)

        def library(out_s=out_s, out_c=out_c, idx=idx, v=v, one=one,
                    counts=counts):
            out_s.zero_().scatter_add_(0, idx, v)
            if counts:
                out_c.zero_().scatter_add_(0, idx, one)

        def kernel(keys=keys, vals=vals, valid=valid, nk=nk, counts=counts):
            return hist.keyed_hist_cuda(keys, vals, valid, nk, counts)

        other = _other_branch(hist, keys, vals, valid, nk, counts, plan)

        # CUDA events over back-to-back calls include the host's launch
        # cost where it exceeds the kernel's; the profiler's device time
        # is the kernel alone; host_us is the host's cost of a call.
        row["ms"], row["library_ms"] = _time_pair_ms(kernel, library)
        row["host_us"] = _host_us(kernel)
        row["plain_ms"] = _time_ms(
            lambda: hist.keyed_hist_plain(keys, vals, valid, nk, counts))
        row["bound_ms"], row["bound_by"] = _bound(r, b, nk, counts, kept)
        profiled.append((row, kernel, library, other))
    rows += _check_verify_shapes(hist, dev)
    _host_split(hist)
    for row, kernel, library, other in profiled:
        row["device_ms"] = _device_ms(kernel)
        if other is not None:
            row["other_branch_device_ms"] = _device_ms(other)
        # Every kernel the library call launches (fill + scatter).
        row["library_device_ms"] = _device_ms(library, None)
    del profiled
    for row in rows:
        if not row["label"].startswith("verify-"):
            log(f"[kernel] {json.dumps(row)}")
    _judge(rows)
    return rows


#: (label, P, G, B, nk): config #5's join at its replay and fill shapes
RANK_SHAPES = (("join-replay", 1, 64, 256, 211),
               ("join-fill", 32, 4, 256, 211))


def phase_keyed_rank():
    """The join's keyed-rank kernel at config #5's shapes: bit for bit
    against the plain version, then CUDA events paired with the library
    yardstick (``torch.cumsum`` over the one-hot, built outside the
    timing; the port never calls it), host time, the plain version's
    time, the bound (bytes once at 3.35 TB/s) and the profiler's device
    times. One ``[keyed-rank]`` line a shape."""
    from clonos_tpu_torch.ops import keyrank
    dev = torch.device("cuda")
    rows = []
    for i, (label, p, g, b, nk) in enumerate(RANK_SHAPES):
        rng = np.random.RandomState(300 + i)
        keys = torch.from_numpy(
            rng.randint(0, nk, (p, g * b)).astype(np.int32)).to(dev)
        valid = torch.from_numpy(rng.rand(p, g * b) < 0.7).to(dev)
        rank, through = keyrank.keyed_rank_cuda(keys, valid, g, b, nk)
        want = keyrank.keyed_rank_plain(keys, valid, g, b, nk)
        sync()
        if not (torch.equal(rank, want[0]) and torch.equal(through, want[1])):
            raise AssertionError(f"keyed_rank kernel != plain at {label}")
        onehot = (valid[..., None] & (keys.to(torch.int64)[..., None]
                                      == torch.arange(nk, device=dev))
                  ).to(torch.int32)

        def kernel(keys=keys, valid=valid, g=g, b=b, nk=nk):
            return keyrank.keyed_rank_cuda(keys, valid, g, b, nk)

        def library(onehot=onehot):
            return torch.cumsum(onehot, dim=1, dtype=torch.int32)

        nbytes = p * g * b * (4 + 1 + 8) + p * g * nk * 4
        row = dict(label=label, P=p, G=g, B=b, nk=nk, bit_identical=True,
                   plan=keyrank.plan(b, nk), bytes=nbytes,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        row["ms"], row["library_ms"] = _time_pair_ms(kernel, library)
        row["host_us"] = _host_us(kernel)
        row["plain_ms"] = _time_ms(
            lambda: keyrank.keyed_rank_plain(keys, valid, g, b, nk))
        rows.append((row, kernel, library))
    out = []
    for row, kernel, library in rows:
        row["device_ms"] = _device_ms(kernel, "rank_")
        row["library_device_ms"] = _device_ms(library, None)
        log(f"[keyed-rank] {json.dumps(row)}")
        out.append(row)
    return out


def _check_verify_shapes(hist, dev):
    """``_verify_shapes()`` against the plain version, bit for bit, on
    seeded inputs drawn on the card (there are hundreds); one summary
    line. Returns their rows."""
    rows = []
    gen = torch.Generator(device=dev)
    for i, (label, r, b, nk, counts) in enumerate(_verify_shapes()):
        gen.manual_seed(7000 + i)
        keys = torch.randint(-3, nk + 4, (r, b), generator=gen, device=dev,
                             dtype=torch.int32)
        vals = torch.randint(-1000, 1000, (r, b), generator=gen,
                             device=dev, dtype=torch.int32)
        valid = torch.rand((r, b), generator=gen, device=dev) < 0.7
        smem_optin, sms = hist._device_info(keys.get_device())
        plan = hist._plan(r, b, nk, counts, True, smem_optin, sms)
        s_k, c_k = hist.keyed_hist_cuda(keys, vals, valid, nk, counts)
        s_p, c_p = hist.keyed_hist_plain(keys, vals, valid, nk, counts)
        err = int((s_k.to(torch.int64) - s_p.to(torch.int64)).abs().max())
        if counts:
            err = max(err, int((c_k.to(torch.int64)
                                - c_p.to(torch.int64)).abs().max()))
        if err:
            raise AssertionError(
                f"keyed_hist kernel != plain at {label} R={r} B={b} nk={nk} "
                f"counts={counts}: max abs err {err}")
        rows.append(dict(label=label, R=r, B=b, nk=nk, counts=counts,
                         bit_identical=True, max_abs_err=err,
                         branch=("bulk", "direct", "global")[plan.branch]))
        del keys, vals, valid, s_k, c_k, s_p, c_p
    branches = {}
    for row in rows:
        branches[row["branch"]] = branches.get(row["branch"], 0) + 1
    log(f"[kernel] phase 20's shapes: {len(rows)} checked bit for bit "
        f"(lanes {list(VERIFY_LANES)}, 1 and 8 .. {SOAK_SPE} steps), max "
        f"abs err {max(r['max_abs_err'] for r in rows)}, branches "
        f"{json.dumps(branches)}")
    return rows


def _other_branch(hist, keys, vals, valid, nk, counts, plan):
    """A call that launches the shared-memory branch the plan did not pick
    (bulk for direct, direct for bulk) on these aligned rows, after
    checking it against the plain version: the evidence for the plan's
    choice. Its launches are not counted. None where only one branch
    can run."""
    import ctypes
    r, b = keys.shape
    index = keys.get_device()
    smem_optin, sms = hist._device_info(index)
    if plan.branch == hist.GLOBAL or b % 16 or hist._table_bytes(
            nk, counts) + hist._ring_bytes(b) > smem_optin:
        return None
    other = hist._branch_plan(
        hist.DIRECT if plan.branch == hist.BULK else hist.BULK, r, b, nk,
        counts, smem_optin, sms)
    args = (ctypes.c_int * 10)(r, b, nk, int(counts), other.branch,
                               other.grid, other.threads, other.smem,
                               other.chunk, index)
    out = torch.empty((2, r, nk), dtype=torch.int32, device=keys.device)
    ptrs = (keys.data_ptr(), vals.data_ptr(), valid.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr() if counts else None,
            ctypes.addressof(args))

    def launch(args=args, out=out):  # both must outlive the launches
        err = hist._launch(*ptrs, hist._current_stream(index))
        if err != 0:
            raise RuntimeError(f"launch of branch {other.branch} failed: "
                               f"cuda error {err}")

    launch()
    s_p, c_p = hist.keyed_hist_plain(keys, vals, valid, nk, counts)
    if not (torch.equal(out[0], s_p) and (not counts
                                          or torch.equal(out[1], c_p))):
        raise AssertionError(f"branch {other.branch} != plain at R={r} "
                             f"B={b} nk={nk} counts={counts}")
    return launch


def _host_split(hist):
    """Where a wrapper call's host time goes, at the wordcount route's
    sums-only shape (host us per call, as ``_host_us``): the whole call,
    its output allocation (and the counts form's: one buffer, two views),
    the bound C launcher alone (ctypes, device check, kernel launch) and
    one plain torch op for scale."""
    label, r, b, nk, _ = WC_SHAPES[1]
    keys, vals, valid = _inputs(r, b, nk, 7, torch.device("cuda"))
    out = hist.keyed_hist_cuda(keys, vals, valid, nk, False)[0]
    index = keys.get_device()
    _, _, args = hist._launch_args(r, b, nk, False, True, index)
    ptrs = (keys.data_ptr(), vals.data_ptr(), valid.data_ptr(),
            out.data_ptr())
    stream = hist._current_stream(index)
    launch = hist._launch
    split = {
        "call": _host_us(
            lambda: hist.keyed_hist_cuda(keys, vals, valid, nk, False)),
        "alloc": _host_us(lambda: keys.new_empty((r, nk))),
        "alloc_counts": _host_us(
            lambda: keys.new_empty((2, r, nk)).unbind(0)),
        "launcher": _host_us(lambda: launch(*ptrs, None, args, stream)),
        "torch_zero_": _host_us(out.zero_),
    }
    log(f"[kernel-host] {label} R={r} B={b} nk={nk} sums only, host us per "
        f"call: " + json.dumps({k: round(v, 3) for k, v in split.items()}))


def _judge(rows):
    """Log each timed row against the floor and its bound: a row whose
    bound exceeds the floor's device time should reach half of its bound,
    any other row at most the floor plus its bound; and the wrapper's
    events time should not exceed the library call's. A reading: nothing
    here fails the run."""
    timed = [r for r in rows if "ms" in r]
    floor = next(r["device_ms"] for r in timed if r["label"] == "floor")
    skew = {r["label"]: r["device_ms"] for r in timed
            if r["label"] in ("window", "skew-zipf", "skew-hot")}
    word = {True: "held", False: "failed"}
    for r in timed:
        dev_ms, bound = r["device_ms"], r["bound_ms"]
        if dev_ms is None or floor is None:
            verdict = "not measured"
        elif bound > floor:
            verdict = (f"bound share {bound / dev_ms:.3f} "
                       f"({word[dev_ms <= 2 * bound]}: >= 0.5)")
        else:
            verdict = (f"floor + bound {floor + bound:.5f} ms "
                       f"({word[dev_ms <= floor + bound]})")
        lib = word[r["ms"] <= r["library_ms"]]
        log(f"[kernel-judge] {r['label']} R={r['R']} B={r['B']} nk={r['nk']} "
            f"counts={r['counts']}: device {dev_ms} ms ({r['branch']}; "
            f"the other branch {r.get('other_branch_device_ms')}), "
            f"{verdict}; events "
            f"{r['ms']:.5f} <= library {r['library_ms']:.5f} ms: {lib}; "
            f"host {r['host_us']:.2f} us")
    if all(skew.get(k) for k in ("window", "skew-zipf", "skew-hot")):
        log(f"[kernel-judge] skew: zipf / uniform "
            f"{skew['skew-zipf'] / skew['window']:.3f}, hot / uniform "
            f"{skew['skew-hot'] / skew['window']:.3f} (device time)")


def kernels_line(rows, by_path, rank_rows):
    """The kernels JSON line; ``launches`` is the count of the path the
    kernel serves (``path``: the main path for the histogram, config #5's
    join recovery for the keyed rank) and ``launches_by_path`` holds every
    path's that counted it, each counted from 0 just before its path
    ran."""
    src = "clonos_tpu_torch/ops/csrc/keyed_hist.cu"
    out = []
    for name, counts, replaces, head in (
            ("keyed_hist", True,
             "clonos_tpu/ops/histogram.py:34 (_hist_kernel, launched at :112)",
             "route"),
            ("keyed_hist_sums", False,
             "clonos_tpu/ops/histogram.py:56 (_hist_kernel_sums, launched "
             "at :103)", "window")):
        mine = [r for r in rows if r["counts"] == counts and "ms" in r]
        top = next(r for r in mine if r["label"] == head)
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "path": "main",
            "launches": by_path["main"][name],
            "launches_by_path": {k: p[name] for k, p in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["counts"] == counts),
            "ms": top["ms"], "kernel_ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "shape": {k: top[k] for k in ("R", "B", "nk")},
            "bit_identical": all(r["bit_identical"] for r in rows
                                 if r["counts"] == counts),
            "device_ms": top["device_ms"],
            "shapes": [{k: r[k] for k in ("label", "R", "B", "nk", "ms",
                                          "host_us", "device_ms", "plain_ms",
                                          "library_ms", "library_device_ms",
                                          "bound_ms", "bound_by")}
                       for r in mine]})
    out.append(rank_kernel_entry(rank_rows, by_path))
    return {"kernels": out}


def rank_kernel_entry(rank_rows, by_path):
    """The keyed-rank kernel's entry of the kernels line, from
    :func:`phase_keyed_rank`'s rows (the replay shape first) and the
    paths' counts."""
    top = rank_rows[0]
    return {
        "name": "keyed_rank", "route": "cuda",
        "source": "clonos_tpu_torch/ops/csrc/keyed_rank.cu",
        "replaces": None, "path": "join_recovery",
        "launches": by_path["join_recovery"]["keyed_rank"],
        "launches_by_path": {k: p["keyed_rank"] for k, p in by_path.items()
                             if "keyed_rank" in p},
        "ms": top["ms"], "kernel_ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": "bytes",
        "library_ms": top["library_ms"],
        "shape": {k: top[k] for k in ("P", "G", "B", "nk")},
        "bit_identical": all(r["bit_identical"] for r in rank_rows),
        "device_ms": top["device_ms"],
        "shapes": [{k: r[k] for k in ("label", "P", "G", "B", "nk", "ms",
                                      "host_us", "device_ms", "plain_ms",
                                      "library_ms", "library_device_ms",
                                      "bound_ms")}
                   for r in rank_rows]}


# --- phase 3 ----------------------------------------------------------------

def phase_card_vs_cpu():
    from clonos_tpu_torch.runtime import executor as ex
    from clonos_tpu_torch.utils.tree import tree_leaves
    rng = np.random.RandomState(SEED)
    kw = dict(log_capacity=LOG_CAPACITY, max_epochs=16,
              inflight_ring_steps=RING_STEPS)
    devs = {"card": DEVICE, "cpu": "cpu"}
    jobs = {k: ex.CompiledJob(build_job(), **kw) for k in devs}
    carries = {k: jobs[k].init_carry(devs[k]) for k in devs}
    t0 = time.monotonic()
    for blk in range(2):
        times = np.arange(blk * BLOCK_STEPS, (blk + 1) * BLOCK_STEPS,
                          dtype=np.int32)
        rngs = rng.randint(0, 2 ** 31, BLOCK_STEPS).astype(np.int32)
        outs = {}
        for k, d in devs.items():
            t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=d)
            bi = ex.BlockInputs(t(times), t(rngs), t(0),
                                t(blk * BLOCK_STEPS))
            carries[k], outs[k] = jobs[k].run_block(carries[k], bi)
        for vid in outs["cpu"].sinks:
            for a, b in zip(outs["card"].sinks[vid], outs["cpu"].sinks[vid]):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(
                        f"sink {vid} of block {blk}: card != CPU")
        for e in outs["cpu"].dropped:
            if not torch.equal(outs["card"].dropped[e].cpu(),
                               outs["cpu"].dropped[e]):
                raise AssertionError(f"edge {e} drops: card != CPU")
    la = tree_leaves(ex.canonical_carry(carries["card"]))
    lb = tree_leaves(ex.canonical_carry(carries["cpu"]))
    if len(la) != len(lb):
        raise AssertionError("carry structures differ")
    for i, (a, b) in enumerate(zip(la, lb)):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            raise AssertionError(f"carry leaf {i}: card != CPU")
    records = int(carries["cpu"].record_counts.sum())
    log(f"[card-vs-cpu] 2 blocks x {BLOCK_STEPS} steps: {len(la)} carry "
        f"leaves and every sink batch bit-identical "
        f"({records} records consumed; {time.monotonic() - t0:.1f} s)")
    if torch.device(DEVICE).type == "cuda":
        t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=DEVICE)
        bi = ex.BlockInputs(
            t(np.arange(2 * BLOCK_STEPS, 3 * BLOCK_STEPS)),
            t(rng.randint(0, 2 ** 31, BLOCK_STEPS)), t(0),
            t(2 * BLOCK_STEPS))
        profile_block(jobs["card"], carries["card"], bi)


def profile_block(job, carry, binputs):
    """One steady block on the card under torch.profiler: the block's wall
    time, the device's busy and idle share over it, device time by layer
    (the executor's record_function ranges) and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    layers = ("op", "route", "inflight-ring", "causal-log", "replicas")
    is_layer = lambda name: name.split(":")[0] in layers
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        job.run_block(carry, binputs)
        sync()
        wall_ms = (time.monotonic() - t0) * 1e3
    events = prof.events()
    # Device-side events are kernels, memsets/copies and the device spans
    # of the record_function ranges (user annotations), which are not
    # work of their own.
    work = [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not is_layer(e.name)]
    busy_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3
    by_layer = {}
    for e in events:
        if e.device_type == DeviceType.CPU and is_layer(e.name):
            by_layer[e.name] = round(by_layer.get(e.name, 0.0)
                                     + e.device_time_total / 1e3, 4)
    spans = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and is_layer(e.name):
            spans[e.name] = round(spans.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3, 4)
    by_kernel = {}
    for e in work:
        ms, n = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    hist_ms = sum(ms for name, (ms, _) in by_kernel.items()
                  if "hist_" in name)
    hist_n = sum(n for name, (_, n) in by_kernel.items() if "hist_" in name)
    log(f"[profile] one {BLOCK_STEPS}-step block on the card: wall "
        f"{wall_ms:.3f} ms (profiler on), device busy {busy_ms:.3f} ms, "
        f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}, {len(work)} "
        f"device operations")
    log(f"[profile] device ms by layer (kernels launched by torch ops "
        f"inside the range): {json.dumps(by_layer)}")
    log(f"[profile] device span by layer (first to last device event, "
        f"gaps included): {json.dumps(spans)}")
    log(f"[profile] keyed histogram: {hist_ms:.4f} ms of device time in "
        f"{hist_n} launches, {hist_ms / busy_ms:.4f} of the block's busy "
        f"time")
    log("[profile] top device operations (ms, count): " + json.dumps(
        [[name[:70], round(ms, 4), n] for name, (ms, n) in top]))


# --- phases 4 and 5 ---------------------------------------------------------

def _source_records(runner) -> int:
    rc = runner.executor.carry.record_counts
    return int(rc[:PAR].sum())


def _assert_same(golden, faulted, what):
    from clonos_tpu_torch.runtime.executor import canonical_carry
    from clonos_tpu_torch.utils.tree import tree_leaves
    la = tree_leaves(canonical_carry(golden.executor.carry))
    lb = tree_leaves(canonical_carry(faulted.executor.carry))
    if len(la) != len(lb):
        raise AssertionError(f"{what}: carry structures differ")
    for i, (a, b) in enumerate(zip(la, lb)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(
                f"{what}: recovered carry leaf {i} != golden")


def phase_main_path(dev_line):
    from clonos_tpu_torch.ops.histogram import keyed_hist
    from clonos_tpu_torch.ops.keyrank import keyed_rank
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    golden = ClusterRunner(build_job(), device=DEVICE, **runner_kw())
    sync()
    keyed_hist.launches = 0
    keyed_hist.launches_counts = 0
    keyed_rank.launches = 0
    epoch_s = []
    epoch_records = []
    for _ in range(3):
        r0 = _source_records(golden)
        t0 = time.monotonic()
        golden.run_epoch()
        sync()
        epoch_s.append(time.monotonic() - t0)
        epoch_records.append(_source_records(golden) - r0)
    for _ in range(EXTRA_STEPS):
        golden.step()
    sync()
    launches = {"keyed_hist": keyed_hist.launches_counts,
                "keyed_hist_sums": (keyed_hist.launches
                                    - keyed_hist.launches_counts),
                "keyed_rank": keyed_rank.launches}
    if keyed_hist.launches == 0 or _hist_silent(launches):
        raise AssertionError(f"main path launched no kernel: {launches}")
    violations = golden.executor.check_overflow()
    if violations:
        raise AssertionError(f"overflow on the main path: {violations}")
    fired = int(golden.executor.carry.record_counts[3 * PAR:].sum())
    if fired == 0:
        raise AssertionError("no window fired into the sinks")
    rates = [n / s for n, s in zip(epoch_records, epoch_s)]
    log(f"[main-path] launches {json.dumps(launches)}; epoch seconds "
        f"{[round(s, 4) for s in epoch_s]}; source records per epoch "
        f"{epoch_records}; steady epochs (2, 3): "
        f"{sum(epoch_records[1:]) / sum(epoch_s[1:]):.1f} records/s "
        f"(reading, not a claim; {dev_line}); all epochs "
        f"{[round(x, 1) for x in rates]}; sink records {fired}")
    return golden, launches


#: one kill per vertex class, then two connected pairs, each ``(label,
#: [(vertex, subtask), ...])``, killed EXTRA_STEPS past a completed fence
KILLS = (
    ("source", [(0, 2)]),
    ("window", [(1, 1)]),
    ("reduce", [(2, 3)]),
    ("sink", [(3, 5)]),
    ("window+reduce", [(1, 4), (2, 6)]),
    ("window+sink", [(1, 2), (3, 1)]),
)
#: killed EXTRA_STEPS into the epoch after a pending checkpoint
PENDING_KILL = ("window, checkpoint pending", [(1, 5)])


def _advance(runners, complete=True):
    for r in runners:
        r.run_epoch(complete_checkpoint=complete)
        for _ in range(EXTRA_STEPS):
            r.step()


def _mirror_ignore(golden, flats):
    """The decision recovery takes for a pending checkpoint, applied to
    the run that never failed: its healthy logs record the same
    IGNORE_CHECKPOINT rows at the same stamp, so the two stay comparable
    leaf for leaf."""
    from clonos_tpu_torch.causal import determinant as det
    healthy = [f for f in range(golden.job.total_subtasks())
               if f not in flats]
    for cid in golden.coordinator.ignore_unacked_for(set(flats)):
        golden.executor.append_async_many(
            healthy, det.IgnoreCheckpointDeterminant(
                record_count=golden.executor.global_record_stamp(),
                checkpoint_id=cid))


#: "file:line" of every synchronising call _sync_count has caught
SYNC_SITES = []


def _sync_count(fn, this_thread=False):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``;
    returns (result, synchronising calls) — (result, None) off the card.
    The mode is process-wide: with ``this_thread`` only the calls made
    on the calling thread count (another thread may queue work on the
    card meanwhile, as the serve dispatch thread does). Where each
    counted call came from is appended to ``SYNC_SITES``."""
    if torch.device(DEVICE).type != "cuda":
        return fn(), None
    import threading
    me = threading.get_ident()
    caught = []

    def record(message, category, filename, lineno, file=None, line=None):
        caught.append((threading.get_ident(), str(message), filename,
                       lineno))
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # (The mode's one-time "prototype feature" notice is not a sync.)
    sites = [f"{os.path.relpath(f)}:{n}" for tid, m, f, n in caught
             if "called a synchronizing" in m
             and (not this_thread or tid == me)]
    SYNC_SITES.extend(sites)
    return out, len(sites)


#: the histogram kernel's two forms, which every path of the headline
#: jobs launches (the keyed-rank kernel runs only in the interval join)
HIST_KERNELS = ("keyed_hist", "keyed_hist_sums")


def _hist_silent(launches) -> bool:
    """Whether a path left one of the histogram's forms unlaunched."""
    return min(launches[k] for k in HIST_KERNELS) == 0


def _counted(fn, count_syncs=False):
    """Run ``fn`` with the kernels' launch counts at 0 just before it;
    returns (result, {kernel: launches}, synchronising calls or None)."""
    from clonos_tpu_torch.ops.histogram import keyed_hist
    from clonos_tpu_torch.ops.keyrank import keyed_rank
    sync()
    keyed_hist.launches = 0
    keyed_hist.launches_counts = 0
    keyed_rank.launches = 0
    out, syncs = _sync_count(fn) if count_syncs else (fn(), None)
    sync()
    counts = {"keyed_hist": keyed_hist.launches_counts,
              "keyed_hist_sums": (keyed_hist.launches
                                  - keyed_hist.launches_counts),
              "keyed_rank": keyed_rank.launches}
    return out, counts, syncs


def _recover(golden, faulted, label, kills, dev_line, count_syncs=False,
             mirror=False):
    flats = [faulted.job.subtask_base(v) + s for v, s in kills]
    faulted.inject_failure(flats)
    report, launches, syncs = _counted(faulted.recover, count_syncs)
    if mirror:
        _mirror_ignore(golden, flats)
    _assert_same(golden, faulted, label)
    if report.records_replayed <= 0 or report.steps_replayed <= 0:
        raise AssertionError(f"{label}: recovery replayed nothing")
    reading = dict(
        vertex_class=label, flats=flats,
        from_epoch=report.from_epoch,
        steps_replayed=report.steps_replayed,
        records_replayed=report.records_replayed,
        determinants_replayed=report.determinants_replayed,
        ignored_checkpoints=list(report.ignored_checkpoints),
        recovery_ms=round(report.recovery_ms, 3),
        phase_ms={k: round(v, 3) for k, v in report.phase_ms.items()},
        kernel_launches=launches, device=dev_line)
    if syncs is not None:
        reading["synchronising_calls"] = syncs
    log(f"[recovery] bit-identical to golden: {json.dumps(reading)}")
    return report, reading, launches


def phase_recovery(golden, dev_line):
    """Every vertex class, two connected failures, a recovery across an
    open epoch whose checkpoint is pending, and a failover drill — each
    against the golden run, which follows the same schedule."""
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    from clonos_tpu_torch.runtime.executor import canonical_carry
    from clonos_tpu_torch.utils.tree import tree_leaves
    faulted = ClusterRunner(build_job(), device=DEVICE, **runner_kw())
    for _ in range(3):
        faulted.run_epoch()
    for _ in range(EXTRA_STEPS):
        faulted.step()
    readings = []
    total = {"keyed_hist": 0, "keyed_hist_sums": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    for n, (label, kills) in enumerate(KILLS):
        if n:
            _advance((golden, faulted))
        report, reading, launches = _recover(
            golden, faulted, label, kills, dev_line,
            count_syncs=label == "window")
        add(launches)
        readings.append(reading)
        if report.steps_replayed != EXTRA_STEPS:
            raise AssertionError(f"{label}: replayed "
                                 f"{report.steps_replayed} steps")
        if label == "window":
            mgr = report.managers[0]
            if mgr.plan.det_device is None or mgr.plan.det_rows.shape[0]:
                raise AssertionError(
                    "window recovery did not take the device-resident "
                    "determinant stream")
            if _hist_silent(launches):
                raise AssertionError(
                    f"window recovery launched no kernel: {launches}")
    # A checkpoint left pending: the kill lands EXTRA_STEPS into the next
    # epoch, recovery ignores it and replays from the older fence.
    for r in (golden, faulted):
        r.run_epoch()
    older = faulted.standbys.latest.checkpoint_id + 1
    _advance((golden, faulted), complete=False)
    label, kills = PENDING_KILL
    report, reading, launches = _recover(golden, faulted, label, kills,
                                         dev_line, mirror=True)
    add(launches)
    readings.append(reading)
    if report.from_epoch != older or report.ignored_checkpoints != (
            older,) or report.steps_replayed != STEPS_PER_EPOCH + \
            EXTRA_STEPS:
        raise AssertionError(f"pending-checkpoint recovery: {reading}")
    # The failover drill: one subtask of every class, failed together.
    _advance((golden, faulted))
    before = [x.clone() for x in
              tree_leaves(canonical_carry(faulted.executor.carry))]
    secs, launches, _ = _counted(faulted.failover_drill)
    add(launches)
    after = tree_leaves(canonical_carry(faulted.executor.carry))
    if any(not torch.equal(a, b) for a, b in zip(before, after)):
        raise AssertionError("failover drill changed the canonical carry")
    _assert_same(golden, faulted, "after the drill")
    drill = dict(vertex_class="drill (one subtask of every class)",
                 flats=[faulted.job.subtask_base(v.vertex_id)
                        for v in faulted.job.vertices],
                 drill_ms=round(secs * 1e3, 3), kernel_launches=launches,
                 device=dev_line)
    log(f"[recovery] drill left the carry unchanged: {json.dumps(drill)}")
    readings.append(drill)
    if _hist_silent(total):
        raise AssertionError(f"recovery paths launched no kernel: {total}")
    return readings, total


# --- phase 6 ----------------------------------------------------------------

def phase_audit(dev_line):
    """Phase 3's job and step count (2 x BLOCK_STEPS) with the audit on,
    on the card and on the CPU: the two sealed ledgers are equal. Then a
    kill and recovery on the card, validated against its ledger."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    kw = dict(runner_kw(), steps_per_epoch=BLOCK_STEPS)
    card = ClusterRunner(build_job(), device=DEVICE, audit=True, **kw)
    cpu = ClusterRunner(build_job(), device="cpu", audit=True, **kw)
    seal_ms = {}
    for complete in (True, False):
        for name, r in (("card", card), ("cpu", cpu)):
            r.run_epoch(complete_checkpoint=complete)
            seal_ms.setdefault(name, []).append(round(
                r.last_fence_phases["fence.digest-seal"], 3))
    lc = card.coordinator.read_ledger()
    lp = cpu.coordinator.read_ledger()
    problems = diff_ledgers(lp, lc)
    if problems or len(lc) != 2:
        raise AssertionError(f"card ledger != CPU ledger: {problems}")
    for _ in range(EXTRA_STEPS):
        card.step()
    flat = card.job.subtask_base(1) + 1
    card.inject_failure([flat])
    report, launches, _ = _counted(card.recover)
    stats = card.last_audit.stats
    if stats != {"match": 1, "divergence": 0, "missing": 0}:
        raise AssertionError(f"audit after recovery: {stats}")
    if _hist_silent(launches):
        raise AssertionError(
            f"audited window recovery launched no kernel: {launches}")
    log(f"[audit] card ledger == CPU ledger over epochs "
        f"{[e['epoch'] for e in lc]} ({sum(e['records'] for e in lc)} "
        f"records); seal ms per epoch {json.dumps(seal_ms)}; recovery of "
        f"flat {flat} from epoch {report.from_epoch}: validator {stats}, "
        f"audit {report.phase_ms.get('audit', 0.0):.3f} ms, kernel "
        f"launches {json.dumps(launches)}; {dev_line}")
    return launches


# --- phase 7 ----------------------------------------------------------------

#: finalize.* keys of the reference's recover(), per finalize mode
FINALIZE_KEYS = {
    True: {"finalize", "finalize.barrier-read", "finalize.state-verify",
           "finalize.overlap-saved"},
    False: {"finalize", "finalize.barrier-read", "finalize.state-verify"}}
#: phase 7's kills: a window subtask while a fence tail is in flight; a
#: window with the reduce it feeds across a pending checkpoint; two
#: window subtasks together (they share routed windows)
TAIL_KILL = [(1, 3)]
FINALIZE_KILL = [(1, 6), (2, 0)]
PAIR_KILL = [(1, 2), (1, 5)]


def _flats(runner, kills):
    return [runner.job.subtask_base(v) + s for v, s in kills]


def _runner7(root, tag, overlap, audit=True):
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    return ClusterRunner(build_job(), device=DEVICE, audit=audit,
                         latency_marker_every=64, overlap_epoch=overlap,
                         checkpoint_dir=os.path.join(root, tag),
                         **runner_kw())


def _fence_schedule(r):
    """3 completed epochs, 1 pending, drained: source records/s over it."""
    r0 = _source_records(r)
    t0 = time.monotonic()
    for complete in (True, True, True, False):
        r.run_epoch(complete_checkpoint=complete)
    r.drain_fence()
    sync()
    return (_source_records(r) - r0) / (time.monotonic() - t0)


def phase_headline_fence(dev_line, root):
    """The headline's fence (audit off): fresh pipelined and sequential
    runners in turns (pipelined, sequential, sequential, pipelined), each
    through :func:`_fence_schedule`; each pair ends leaf-equal."""
    rates = {True: [], False: []}
    first = last = None
    for i, overlap in enumerate((True, False, False, True)):
        r = _runner7(root, f"headline{i}", overlap, audit=False)
        rates[overlap].append(_fence_schedule(r))
        r.coordinator.storage._close_ledger()
        if first is None:
            first = r
        else:
            _assert_same(first, r, f"headline fence, run {i}")
        last = r
    log("[overlap] headline fence (audit off), pipelined == sequential: "
        + json.dumps(dict(
            source_records_per_s={
                "pipelined": [round(x, 1) for x in rates[True]],
                "sequential": [round(x, 1) for x in rates[False]]},
            fence_phases_pipelined={k: round(v, 3) for k, v in
                                    last.last_fence_phases.items()},
            fence_overlap_saved_total_ms=round(
                last.fence_overlap_saved_total_ms, 3),
            device=dev_line)))


def phase_overlap(dev_line, root):
    """The overlapped runtime at phase 4's widths, each piece against its
    sequential control: (a) the pipelined fence, (b) a kill while a fence
    tail is in flight, (c) the overlapped finalize against
    ``overlap_finalize=False``, (d) two window subtasks failed together
    (the route cache), (e) ``bootstrap_standby`` of the whole job."""
    from clonos_tpu_torch.causal.recovery import AuditValidator
    from clonos_tpu_torch.obs.digest import diff_ledgers
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    ovl = _runner7(root, "ovl", True)     # pipelined, killed
    seq = _runner7(root, "seq", False)    # sequential control, never killed
    fin = _runner7(root, "fin", False)    # killed, sequential finalize
    by_path = {}
    t_part = time.monotonic()

    def seconds():
        nonlocal t_part
        now = time.monotonic()
        out, t_part = round(now - t_part, 3), now
        return out

    # (a) the pipelined fence, 3 completed epochs then 1 pending; every
    # capture window runs under the sync-debug mode.
    syncs = []
    begin = ovl._begin_fence_tail
    ovl._begin_fence_tail = lambda *a: syncs.append(
        _sync_count(lambda: begin(*a))[1])
    rates = {}
    ovl_phases = []
    join = ovl._join_fence_tail

    def joined():
        join()
        if ovl.last_fence_phases:
            ovl_phases.append(dict(ovl.last_fence_phases))
    ovl._join_fence_tail = joined
    rates["pipelined"], by_path["pipelined"], _ = _counted(
        lambda: _fence_schedule(ovl))
    ovl._begin_fence_tail = begin
    ovl._join_fence_tail = join
    rates["sequential"] = _fence_schedule(seq)
    _fence_schedule(fin)
    _assert_same(seq, ovl, "(a) pipelined fence vs sequential")
    problems = diff_ledgers(seq.coordinator.read_ledger(),
                            ovl.coordinator.read_ledger())
    if problems or len(ovl.coordinator.read_ledger()) != 4:
        raise AssertionError(f"(a) ledger diff: {problems}")
    if torch.device(DEVICE).type == "cuda" and any(syncs):
        raise AssertionError(f"(a) capture windows synchronised: {syncs} "
                             f"at {SYNC_SITES}")
    if _hist_silent(by_path["pipelined"]):
        raise AssertionError(f"(a) no kernel launch: {by_path}")
    snap = ovl.metrics.snapshot()
    lat = snap[f"job.{ovl.job.name}.latency-ms"]
    rnd = lambda d: {k: round(v, 3) for k, v in d.items()}
    log("[overlap] (a) pipelined fence == sequential control (canonical "
        "carry, ledger diff []): " + json.dumps(dict(
            capture_window_syncs=syncs,
            fence_phases_pipelined=[rnd(p) for p in ovl_phases],
            fence_phases_sequential=rnd(seq.last_fence_phases),
            fence_overlap_saved_total_ms=round(
                ovl.fence_overlap_saved_total_ms, 3),
            source_records_per_s={k: round(v, 1)
                                  for k, v in rates.items()},
            latency_markers=dict(count=lat["count"], p50_ms=lat["p50"],
                                 p99_ms=lat["p99"]),
            kernel_launches=by_path["pipelined"], seconds=seconds(),
            device=dev_line)))

    # (b) a kill while the fence tail is in flight: the kill joins the
    # tail (its checkpoint completes) and ignores (a)'s pending one.
    pending = ovl.executor.epoch_id - 1
    for r in (ovl, seq, fin):
        r.run_epoch(complete_checkpoint=True)
        for _ in range(EXTRA_STEPS):
            r.step()
    if not ovl.fence_tail_in_flight():
        raise AssertionError("(b) no fence tail in flight at the kill")
    flats = _flats(ovl, TAIL_KILL)
    ovl.inject_failure(flats)
    rep = ovl.recover()
    for r in (seq, fin):
        _mirror_ignore(r, flats)
    _assert_same(seq, ovl, "(b) kill mid fence tail")
    if rep.steps_replayed != EXTRA_STEPS \
            or rep.ignored_checkpoints != (pending,):
        raise AssertionError(f"(b) replayed {rep.steps_replayed} steps, "
                             f"ignored {rep.ignored_checkpoints}")
    log("[overlap] (b) kill mid fence tail == control: " + json.dumps(dict(
        flats=flats, steps_replayed=rep.steps_replayed,
        ignored_checkpoints=list(rep.ignored_checkpoints),
        recovery_ms=round(rep.recovery_ms, 3), phase_ms=rnd(rep.phase_ms),
        seconds=seconds(), device=dev_line)))

    # (c) overlapped finalize vs the sequential finalize, same failure,
    # across a pending checkpoint (the audit validator replays an epoch).
    for r in (ovl, seq, fin):
        r.run_epoch(complete_checkpoint=False)
        for _ in range(EXTRA_STEPS):
            r.step()
    flats = _flats(ovl, FINALIZE_KILL)
    ovl.inject_failure(flats)
    fin.inject_failure(flats)
    rep_o, by_path["overlap_recovery"], _ = _counted(ovl.recover)
    rep_s = fin.recover(overlap_finalize=False)
    _mirror_ignore(seq, flats)
    _assert_same(seq, ovl, "(c) overlapped finalize")
    _assert_same(seq, fin, "(c) sequential finalize")
    epochs = range(rep_o.from_epoch, ovl.executor.epoch_id)
    entries = [AuditValidator(r.executor, []).recompute_entries(epochs)
               for r in (ovl, fin)]
    problems = diff_ledgers(entries[1], entries[0])
    if problems or not entries[0]:
        raise AssertionError(f"(c) recomputed entries diff: {problems}")
    for r, rep, overlap in ((ovl, rep_o, True), (fin, rep_s, False)):
        keys = {k for k in rep.phase_ms if k.startswith("finalize")}
        if keys != FINALIZE_KEYS[overlap]:
            raise AssertionError(f"(c) finalize keys {sorted(keys)}")
        if r.last_audit.stats != {"match": 1, "divergence": 0,
                                  "missing": 0}:
            raise AssertionError(f"(c) audit {r.last_audit.stats}")
    if _hist_silent(by_path["overlap_recovery"]):
        raise AssertionError(f"(c) no kernel launch: {by_path}")

    def residual(pm):
        subs = sum(v for k, v in pm.items() if k.startswith("finalize.")
                   and k != "finalize.overlap-saved")
        return round(subs - pm.get("finalize.overlap-saved", 0.0)
                     - pm["finalize"], 3)
    log("[overlap] (c) overlapped finalize == sequential finalize == "
        "control (recomputed entries diff []): " + json.dumps(dict(
            flats=flats, steps_replayed=rep_o.steps_replayed,
            ignored_checkpoints=list(rep_o.ignored_checkpoints),
            overlapped=dict(recovery_ms=round(rep_o.recovery_ms, 3),
                            phase_ms=rnd(rep_o.phase_ms),
                            attribution_residual_ms=residual(
                                rep_o.phase_ms)),
            sequential=dict(recovery_ms=round(rep_s.recovery_ms, 3),
                            phase_ms=rnd(rep_s.phase_ms),
                            attribution_residual_ms=residual(
                                rep_s.phase_ms)),
            kernel_launches=by_path["overlap_recovery"],
            seconds=seconds(), device=dev_line)))

    # (d) two window subtasks failed together share routed windows.
    for r in (ovl, seq, fin):
        r.run_epoch(complete_checkpoint=True)
        for _ in range(EXTRA_STEPS):
            r.step()
    flats = _flats(ovl, PAIR_KILL)
    ovl.inject_failure(flats)
    fin.inject_failure(flats)
    rep_o, by_path["route_cache"], _ = _counted(ovl.recover)
    fin.recover(overlap_finalize=False)
    _assert_same(seq, ovl, "(d) window pair")
    _assert_same(seq, fin, "(d) window pair, sequential finalize")
    hits = (ovl._route_cache_hits, fin._route_cache_hits)
    if min(hits) <= 0:
        raise AssertionError(f"(d) route cache hits {hits}")
    if _hist_silent(by_path["route_cache"]):
        raise AssertionError(f"(d) no kernel launch: {by_path}")
    ovl.drain_fence()
    problems = diff_ledgers(seq.coordinator.read_ledger(),
                            ovl.coordinator.read_ledger())
    if problems:
        raise AssertionError(f"(b)-(d) ledger diff: {problems}")
    log("[overlap] (d) window pair == control: " + json.dumps(dict(
        flats=flats, route_cache_hits=hits[0],
        recovery_ms=round(rep_o.recovery_ms, 3),
        phase_ms=rnd(rep_o.phase_ms),
        kernel_launches=by_path["route_cache"], seconds=seconds(),
        device=dev_line)))
    for r in (ovl, seq, fin):
        r.coordinator.storage._close_ledger()
    del ovl, fin

    # (e) bootstrap_standby of the whole job from the durable checkpoint
    # and mirror rows read from the control's logs at a fence.
    seq.run_epoch(complete_checkpoint=False)
    logs = seq.executor.carry.logs
    rows, heads, tails = (x.cpu().numpy() for x in (logs.rows, logs.head,
                                                      logs.tail))
    cap = rows.shape[1]
    mirror = {f: (rows[f][np.arange(int(tails[f]), int(heads[f]))
                          & (cap - 1)], int(tails[f]))
              for f in range(rows.shape[0])}
    standby_dir = os.path.join(root, "standby")
    shutil.copytree(os.path.join(root, "seq"), standby_dir)
    (rebuilt, rep_b), by_path["bootstrap"], _ = _counted(
        lambda: ClusterRunner.bootstrap_standby(
            build_job(), standby_dir, mirror, device=DEVICE, **runner_kw()))
    _assert_same(seq, rebuilt, "(e) bootstrap at the mirrored fence")
    if rep_b.steps_replayed != STEPS_PER_EPOCH:
        raise AssertionError(f"(e) replayed {rep_b.steps_replayed}")
    if _hist_silent(by_path["bootstrap"]):
        raise AssertionError(f"(e) no kernel launch: {by_path}")
    for r in (seq, rebuilt):
        r.run_epoch(complete_checkpoint=True)
    _assert_same(seq, rebuilt, "(e) one epoch after the bootstrap")
    for r in (seq, rebuilt):
        r.coordinator.storage._close_ledger()
    log("[overlap] (e) bootstrap_standby == dead runner at its fence and "
        "one epoch on: " + json.dumps(dict(
            subtasks=len(mirror), from_epoch=rep_b.from_epoch,
            steps_replayed=rep_b.steps_replayed,
            records_replayed=rep_b.records_replayed,
            recovery_ms=round(rep_b.recovery_ms, 3),
            phase_ms=rnd(rep_b.phase_ms),
            kernel_launches=by_path["bootstrap"], seconds=seconds(),
            device=dev_line)))
    return by_path


# --- phase 8 ----------------------------------------------------------------

#: bench.py spill_probe's settings (BENCH_SPILL_SPE, _EPOCHS, _FILL_EPOCHS
#: defaults and its seed): 512-step epochs, 3 timed steady epochs after
#: one warm-up, a backlog of 4 pending epochs behind one completed one
SPILL_SPE = 512
SPILL_EPOCHS = 3
SPILL_FILL = 4
SPILL_SEED = 7
#: (a)'s runs in turns, so host drift shows as a spread within each mode
SPILL_TURNS = ("off", "availability", "eager", "eager", "availability",
               "off")
#: the steady runs' ring holds 4 epochs (the availability policy's
#: headroom); the backlog run's holds one, its control's the whole span
SPILL_STEADY_RING = 1 << (4 * SPILL_SPE - 1).bit_length()
SPILL_BACKLOG_RING = 1 << (SPILL_SPE - 1).bit_length()
SPILL_CONTROL_RING = 1 << (SPILL_FILL * SPILL_SPE).bit_length()
#: (b)'s kill: window subtask 1 (flat PAR + 1, as bench.py kills)
BACKLOG_KILL = [(1, 1)]
#: (d): a full snapshot every third checkpoint; its kill is a window and
#: a reduce subtask
INC_BASE_EVERY = 3
INC_KILL = [(1, 4), (2, 1)]

SPILL_REDUCTIONS = (
    f"bench.py spill_probe at the headline's widths: steps_per_epoch="
    f"{SPILL_SPE}, block_steps={min(BLOCK_STEPS, SPILL_SPE)}, seed="
    f"{SPILL_SEED}; steady ring {SPILL_STEADY_RING}, 1 warm-up + "
    f"{SPILL_EPOCHS} epochs; backlog ring {SPILL_BACKLOG_RING}, host budget "
    f"1 epoch, 1 completed + {SPILL_FILL} pending epochs, control ring "
    f"{SPILL_CONTROL_RING}; differences: window_size={WINDOW_SIZE} (bench: "
    f"1<<30), logical_time=True in the steady runs too (bench: only in "
    f"the backlog); (d) incremental_base_every={INC_BASE_EVERY}")


def _spill_kw(ring_steps, epochs):
    need = (epochs + 2) * SPILL_SPE * DETS_PER_STEP
    return dict(steps_per_epoch=SPILL_SPE,
                log_capacity=1 << need.bit_length(), max_epochs=16,
                inflight_ring_steps=ring_steps,
                block_steps=min(BLOCK_STEPS, SPILL_SPE), logical_time=True,
                seed=SPILL_SEED)


def _assert_same_cut_rings(control, faulted, what):
    """Equal canonical carries where the two runs' rings differ in size:
    every other leaf bit for bit, the rings on their bounds and on the
    steps the smaller ring retains."""
    from clonos_tpu_torch.inflight import log as ifl
    from clonos_tpu_torch.runtime.executor import canonical_carry
    from clonos_tpu_torch.utils.tree import tree_leaves
    ca = canonical_carry(control.executor.carry)
    cb = canonical_carry(faulted.executor.carry)
    la = tree_leaves(ca._replace(out_rings=()))
    lb = tree_leaves(cb._replace(out_rings=()))
    if len(la) != len(lb):
        raise AssertionError(f"{what}: carry structures differ")
    for i, (a, b) in enumerate(zip(la, lb)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{what}: carry leaf {i} != control")
    for i, (ra, rb) in enumerate(zip(ca.out_rings, cb.out_rings)):
        head, tail = int(ra.head), int(ra.tail)
        if (head, tail) != (int(rb.head), int(rb.tail)):
            raise AssertionError(f"{what}: ring {i} bounds differ")
        n = min(ra.ring_steps, rb.ring_steps, head - tail)
        for a, b in zip(ifl.slice_steps_at(ra, head - n, n),
                        ifl.slice_steps_at(rb, head - n, n)):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: ring {i} steps != control")


def _steady(root, policy, hook):
    """bench.py's steady(): one warm-up epoch, then SPILL_EPOCHS epochs
    with every checkpoint completing; returns (runner, records/s, stats,
    launches). A spilled run's spill hook runs under the sync-debug mode;
    its synchronising calls and host ms per call go to ``hook``."""
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    kw = _spill_kw(SPILL_STEADY_RING, SPILL_EPOCHS)
    if policy is not None:
        kw.update(spool_dir=os.path.join(root, policy), spill_policy=policy)
    r = ClusterRunner(build_job(), device=DEVICE, **kw)
    ex = r.executor
    if policy is not None:
        spill = ex._spill_epoch

        def counted(*a):
            t = time.monotonic()
            hook["syncs"].append(_sync_count(lambda: spill(*a))[1])
            hook["ms"].append(round((time.monotonic() - t) * 1e3, 3))
        ex._spill_epoch = counted
    r.run_epoch(complete_checkpoint=True)
    sync()
    r0 = _source_records(r)

    def timed():
        t0 = time.monotonic()
        for _ in range(SPILL_EPOCHS):
            r.run_epoch(complete_checkpoint=True)
        sync()
        return time.monotonic() - t0
    wall, launches, _ = _counted(timed)
    rate = (_source_records(r) - r0) / wall
    stats = {"timed_wall_ms": round(wall * 1e3, 3)}
    if policy is not None:
        t1 = time.monotonic()
        ex.drain_spill()
        stats.update(ex.spill_stats())
        stats["drain_residue_ms"] = round((time.monotonic() - t1) * 1e3, 3)
        ex.close_spill()
    return r, rate, stats, launches


def _backlog(spool_dir, ring_steps):
    """bench.py's backlog_run(): one completed epoch (the restore point),
    then SPILL_FILL epochs whose checkpoints stay pending; audit on."""
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    kw = _spill_kw(ring_steps, SPILL_FILL)
    if spool_dir is not None:
        kw.update(spool_dir=spool_dir, spill_host_budget_epochs=1)
    r = ClusterRunner(build_job(), device=DEVICE, audit=True, **kw)
    r.run_epoch(complete_checkpoint=True)
    for _ in range(SPILL_FILL):
        r.run_epoch(complete_checkpoint=False)
    sync()
    return r


def phase_spill(dev_line, root):
    """Tiered storage at the headline's widths (bench.py --spill): (a) the
    steady state with spill off, ``availability`` and ``eager``; (b) a
    deep-backlog recovery whose replay span is SPILL_FILL rings long,
    against a no-spill control; (c) a torn segment of that span refused
    with its label; (d) recovery from an incremental checkpoint chain."""
    import glob

    from clonos_tpu_torch.causal.recovery import RecoveryError
    from clonos_tpu_torch.obs.digest import diff_ledgers
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    by_path = {}
    rnd = lambda d: {k: round(v, 3) for k, v in d.items()}

    # (a) the steady state three ways, in turns: every spilled carry
    # equals spill off's and the spill hook never synchronises.
    t0 = time.monotonic()
    hooks = {p: {"syncs": [], "ms": []} for p in ("availability", "eager")}
    rates = {"off": [], "availability": [], "eager": []}
    stats = {k: [] for k in rates}
    off = None
    for mode in SPILL_TURNS:
        policy = None if mode == "off" else mode
        r, rate, st, launches = _steady(root, policy, hooks.get(mode))
        rates[mode].append(rate)
        stats[mode].append(st)
        if off is None:
            off = r
        else:
            _assert_same(off, r, f"(a) spill {mode} vs spill off")
        if policy is not None:
            if _hist_silent(launches):
                raise AssertionError(f"(a) {policy}: no kernel launch")
            by_path.setdefault(f"spill_{policy}", launches)
            shutil.rmtree(os.path.join(root, policy), ignore_errors=True)
        del r
    del off
    if torch.device(DEVICE).type == "cuda" and any(
            sum(h["syncs"]) for h in hooks.values()):
        raise AssertionError(f"(a) the spill hook synchronised: "
                             f"{hooks} at {SYNC_SITES}")
    mean = {k: sum(v) / len(v) for k, v in rates.items()}
    log("[spill] (a) steady state, availability == eager == off (canonical "
        "carry): " + json.dumps(dict(
            turns=list(SPILL_TURNS),
            records_per_s={k: [round(x, 1) for x in v]
                           for k, v in rates.items()},
            spill_throughput_overhead_fraction=round(
                1 - mean["availability"] / mean["off"], 6),
            eager_overhead_fraction=round(1 - mean["eager"] / mean["off"],
                                          6),
            spill_stats=stats,
            spill_hook_syncs={k: h["syncs"] for k, h in hooks.items()},
            spill_hook_host_ms={k: h["ms"] for k, h in hooks.items()},
            kernel_launches={k: by_path[f"spill_{k}"]
                             for k in ("availability", "eager")},
            ring_steps=SPILL_STEADY_RING,
            seconds=round(time.monotonic() - t0, 3), device=dev_line)))

    # (b) the deep backlog: the ring holds one epoch, the replay span is
    # SPILL_FILL of them; a host budget of 1 leaves the rest on disk.
    t0 = time.monotonic()
    spool = os.path.join(root, "backlog")
    r = _backlog(spool, SPILL_BACKLOG_RING)
    r.executor.drain_spill()
    occupancy = r.executor.spill_occupancy()
    flats = _flats(r, BACKLOG_KILL)
    r.inject_failure(flats)
    t1 = time.monotonic()
    report, by_path["spill_recovery"], _ = _counted(r.recover)
    wall_ms = (time.monotonic() - t1) * 1e3
    moved = r.executor.spill_stats()
    control = _backlog(None, SPILL_CONTROL_RING)
    hi = r.auditor.last_epoch
    ledger = [e for e in r.auditor.ledger() if e["epoch"] <= hi]
    expected = [e for e in control.auditor.ledger() if e["epoch"] <= hi]
    problems = diff_ledgers(expected, ledger)
    if problems or len(ledger) != SPILL_FILL + 1:
        raise AssertionError(f"(b) ledger diff against the control: "
                             f"{problems[:8]} ({len(ledger)} entries)")
    _mirror_ignore(control, flats)
    _assert_same_cut_rings(control, r, "(b) deep backlog")
    if not report.steps_replayed > SPILL_BACKLOG_RING:
        raise AssertionError(f"(b) replayed {report.steps_replayed} steps, "
                             f"not past the {SPILL_BACKLOG_RING}-step ring")
    if moved.get("disk_hits", 0) <= 0 or moved.get("write_errors"):
        raise AssertionError(f"(b) refill movement {moved}")
    if _hist_silent(by_path["spill_recovery"]):
        raise AssertionError(f"(b) no kernel launch: {by_path}")
    del control
    log("[spill] (b) deep-backlog recovery == no-spill control (ledger "
        "diff [], canonical carry): " + json.dumps(dict(
            flats=flats, from_epoch=report.from_epoch,
            steps_replayed=report.steps_replayed,
            ring_steps=SPILL_BACKLOG_RING,
            control_ring_steps=SPILL_CONTROL_RING,
            records_replayed=report.records_replayed,
            ignored_checkpoints=list(report.ignored_checkpoints),
            recovery_ms=round(report.recovery_ms, 3),
            recovery_wall_ms=round(wall_ms, 3),
            phase_ms=rnd(report.phase_ms),
            tier_occupancy_at_kill=occupancy, spill_movement=moved,
            kernel_launches=by_path["spill_recovery"],
            seconds=round(time.monotonic() - t0, 3), device=dev_line)))

    # (c) a torn segment: the source ring's epoch that outran the ring,
    # cut in half on disk. Recovery must refuse it with its label.
    t0 = time.monotonic()
    first = min(e for e in r.executor.spill_logs[0].retained_epochs())
    torn = glob.glob(os.path.join(spool, f"edge0_epoch{first}.seg"))
    if len(torn) != 1:
        raise AssertionError(f"(c) no spilled segment of epoch {first}")
    with open(torn[0], "rb") as f:
        data = f.read()
    with open(torn[0], "wb") as f:
        f.write(data[:len(data) // 2])
    r.inject_failure(flats)
    try:
        r.recover()
    except RecoveryError as err:
        if "tiered refill failed" not in str(err) \
                or f"epoch{first}" not in str(err):
            raise AssertionError(f"(c) unlabelled refusal: {err}") from err
        refusal = str(err)
    else:
        raise AssertionError("(c) recovery replayed a torn segment")
    r.executor.close_spill()
    del r
    shutil.rmtree(spool, ignore_errors=True)
    log("[spill] (c) torn segment refused: " + json.dumps(dict(
        segment=os.path.basename(torn[0]), bytes_kept=len(data) // 2,
        bytes_written=len(data), error=refusal[:300],
        seconds=round(time.monotonic() - t0, 3))))

    # (d) incremental checkpoints: the pipelined fence stages each
    # snapshot's device diff in its capture window (0 synchronising calls)
    # and finishes it at the join; the restore point is a delta with a
    # chain behind it; a window and a reduce subtask recover from it.
    t0 = time.monotonic()
    kw = _spill_kw(SPILL_STEADY_RING, INC_BASE_EVERY)
    inc = ClusterRunner(build_job(), device=DEVICE, overlap_epoch=True,
                        checkpoint_dir=os.path.join(root, "inc"),
                        incremental_checkpoints=True,
                        incremental_base_every=INC_BASE_EVERY, **kw)
    golden = ClusterRunner(build_job(), device=DEVICE, **kw)
    capture, join_syncs = [], []
    begin, join = inc._begin_fence_tail, inc._join_fence_tail
    inc._begin_fence_tail = lambda *a: capture.append(
        _sync_count(lambda: begin(*a))[1])
    inc._join_fence_tail = lambda *a: join_syncs.append(
        _sync_count(lambda: join(*a))[1])
    for _ in range(INC_BASE_EVERY):
        for x in (golden, inc):
            x.run_epoch(complete_checkpoint=True)
    inc.drain_fence()
    inc._begin_fence_tail, inc._join_fence_tail = begin, join
    st = inc.coordinator.storage
    restore = inc.standbys.latest.checkpoint_id
    chain = st._chain(restore)
    kinds = [st._index[c][0] for c in chain]
    if len(chain) != INC_BASE_EVERY or kinds[0] != "full" \
            or set(kinds[1:]) != {"delta"}:
        raise AssertionError(f"(d) restore point {restore}: chain {chain} "
                             f"kinds {kinds}")
    for _ in range(EXTRA_STEPS):
        for x in (golden, inc):
            x.step()
    flats = _flats(inc, INC_KILL)
    inc.inject_failure(flats)
    rep, by_path["incremental_recovery"], _ = _counted(inc.recover)
    _assert_same(golden, inc, "(d) recovery from the incremental chain")
    if torch.device(DEVICE).type == "cuda" and any(capture):
        raise AssertionError(f"(d) capture windows synchronised: {capture} "
                             f"at {SYNC_SITES}")
    if _hist_silent(by_path["incremental_recovery"]):
        raise AssertionError(f"(d) no kernel launch: {by_path}")
    sizes = st.delta_bytes_on_disk()
    triggers = len(chain)
    # What a delta holds, leaf by leaf: unchanged, changed chunks, or the
    # whole leaf (more chunks changed than the budget).
    from clonos_tpu_torch.runtime.incremental import LeafDelta
    composition = {}
    for c in chain[1:]:
        kinds_n = {"unchanged": 0, "chunks": 0, "whole": 0}
        nbytes = {"chunks": 0, "whole": 0}
        for e in st._load(c)["payload"]:
            if e is None:
                kinds_n["unchanged"] += 1
            elif isinstance(e, LeafDelta):
                kinds_n["chunks"] += 1
                nbytes["chunks"] += e.chunks.nbytes + e.chunk_ids.nbytes
            else:
                kinds_n["whole"] += 1
                nbytes["whole"] += np.asarray(e).nbytes
        composition[str(c)] = dict(leaves=kinds_n, payload_bytes=nbytes)
    log("[spill] (d) recovery from an incremental chain == golden: "
        + json.dumps(dict(
            flats=flats, restore_checkpoint=restore, chain=chain,
            kinds=kinds, bytes_on_disk={str(c): sizes[c] for c in chain},
            delta_over_full=[round(sizes[c] / sizes[chain[0]], 6)
                             for c in chain[1:]],
            delta_composition=composition,
            capture_window_syncs=capture, join_syncs=join_syncs,
            packed_count_reads=st.packed_reads,
            packed_count_reads_per_trigger=round(
                st.packed_reads / triggers, 3),
            steps_replayed=rep.steps_replayed,
            recovery_ms=round(rep.recovery_ms, 3),
            phase_ms=rnd(rep.phase_ms),
            kernel_launches=by_path["incremental_recovery"],
            seconds=round(time.monotonic() - t0, 3), device=dev_line)))
    return by_path


# --- phase 9 ----------------------------------------------------------------

#: BASELINE config #4 (bench.py:66-126): a Kafka-like feed source ->
#: keyBy -> window -> keyBy -> reduce -> sink, 16 subtasks each
C4_PAR = 16
C4_BATCH = 32
C4_VOCAB = 499
C4_EDGE = 512
C4_KEY_GROUPS = 64
C4_SPE = 1024
C4_SEED = 5
#: the failover drill runs this many steps into the pending epoch
C4_DRILL_AT = 256
#: the window subtask's timers, as multiples of the epoch length: three
#: fire inside the replayed span (the pending epoch), the last stays
#: pending
C4_TIMERS = (1.07, 1.66, 1.95, 2.9)
#: BASELINE config #5 (bench.py:129-200): two synthetic sources -> keyBy
#: -> interval join -> sink, 32 subtasks each
C5_PAR = 32
C5_BATCH = 16
C5_VOCAB = 211
C5_EDGE = 256
C5_SPE = 4096
C5_FILL = 5
C5_SEED = 9
#: the configuration's own figure of buffered determinants
C5_MIN_DETS = 10_000_000
#: (c): event-time windows of 64 (slide 16, session gap 16), bounded
#: disorder 16, the sliding and session runs at this epoch length
EGRESS_WINDOW = 64
EGRESS_SLIDE = 16
EGRESS_OOO = 16
EGRESS_SHORT_SPE = 256
#: the session run's feeds deliver this many records a pull (of a batch
#: of 32), so a key goes quiet for a gap often enough to close sessions
EGRESS_SESSION_PULL = 2

PHASE9_REDUCTIONS = (
    f"(a) bench.py config #4 at full width and depth (16 subtasks a "
    f"vertex, batch {C4_BATCH}, {C4_VOCAB} keys, edge capacity {C4_EDGE}, "
    f"steps_per_epoch={C4_SPE}, ring {C4_SPE}, seed {C4_SEED}); cuts: "
    f"logical_time=True, window_size={WINDOW_SIZE} (bench: 1<<30, never "
    f"fires); the drill runs {C4_DRILL_AT} steps into the pending epoch "
    f"(bench: at its end). (b) config #5 at full width and depth (32 "
    f"subtasks a vertex, batch {C5_BATCH}, {C5_VOCAB} keys, edge capacity "
    f"{C5_EDGE}, {C5_FILL} x {C5_SPE}-step pending epochs, "
    f"replication_factor=2, seed {C5_SEED}); cut: logical_time=True. "
    f"(c) (a)'s widths, two feeds -> union -> event-time window -> "
    f"transactional sink, pipelined fence, ring 4 epochs; the sliding "
    f"and session runs at {EGRESS_SHORT_SPE}-step epochs, the session "
    f"run's feeds at {EGRESS_SESSION_PULL} records a pull")


def _feed_reader(seed, n, records_per_pull=1 << 30):
    """A ListFeedReader of RandomState(seed) keys in [0, C4_VOCAB), value
    1, ``n`` records per partition (bench.py config #4's feed)."""
    from clonos_tpu_torch.api.feeds import ListFeedReader
    rng = np.random.RandomState(seed)
    return ListFeedReader([
        np.stack([rng.randint(0, C4_VOCAB, n), np.ones(n, np.int64)], 1)
        for _ in range(C4_PAR)], records_per_pull=records_per_pull)


def _wrap_syncs(obj, name, counts):
    """Count the synchronising calls of every call of ``obj.name`` into
    ``counts``; undo with ``delattr(obj, name)``."""
    fn = getattr(obj, name)

    def wrapped(*a, **k):
        out, n = _sync_count(lambda: fn(*a, **k))
        counts.append(n)
        return out
    setattr(obj, name, wrapped)


def _reading(report, launches, syncs, dev_line, **extra):
    return dict(
        flats=list(report.failed_subtasks), from_epoch=report.from_epoch,
        steps_replayed=report.steps_replayed,
        records_replayed=report.records_replayed,
        determinants_replayed=report.determinants_replayed,
        ignored_checkpoints=list(report.ignored_checkpoints),
        recovery_ms=round(report.recovery_ms, 3),
        phase_ms={k: round(v, 3) for k, v in report.phase_ms.items()},
        kernel_launches=launches, synchronising_calls=syncs, **extra,
        device=dev_line)


def build_c4_job(transactional=False):
    """BASELINE config #4; phase 18 (b) asks for a transactional sink."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    env = StreamEnvironment(name="bench-c4", num_key_groups=C4_KEY_GROUPS,
                            default_edge_capacity=C4_EDGE)
    (env.host_source(batch_size=C4_BATCH, parallelism=C4_PAR)
        .key_by().window_count(num_keys=C4_VOCAB, window_size=WINDOW_SIZE,
                               parallelism=C4_PAR)
        .key_by().reduce(num_keys=C4_VOCAB, parallelism=C4_PAR)
        .sink(parallelism=C4_PAR, transactional=transactional))
    return env.build()


def _c4_kw():
    """Config #4's runner settings (phase 9): the ring holds one epoch."""
    return dict(steps_per_epoch=C4_SPE,
                log_capacity=1 << (C4_SPE * 8 - 1).bit_length(),
                max_epochs=16, inflight_ring_steps=1 << (C4_SPE - 1)
                .bit_length(), logical_time=True, seed=C4_SEED)


def phase_feeds(dev_line):
    """(a) config #4: one completed epoch, a failover drill of a feed
    source, a window and a reduce subtask, one pending epoch (its block
    window under the sync-debug mode), then a cascading kill of another
    such triple, against a golden run; timers on window subtask 3 fire
    inside the replayed span and re-fire once each; the committed feed
    offsets, floors and cursors agree."""
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    kw = _c4_kw()
    runs = {k: ClusterRunner(build_c4_job(), device=DEVICE, **kw)
            for k in ("golden", "faulted")}
    golden, faulted = runs["golden"], runs["faulted"]
    wbase, rbase = (faulted.job.subtask_base(v) for v in (1, 2))
    timers = [int(x * C4_SPE) for x in C4_TIMERS]
    fired = {}
    for name, r in runs.items():
        r.executor.register_feed(0, _feed_reader(C4_SEED, 4 * C4_SPE
                                                 * C4_BATCH))
        fired[name] = []
        svc = r.timer_service(wbase + 3)
        svc.register_callback(fired[name].append, callback_id=1)
        for t in timers:
            svc.register_timer(t, 1)
        r.run_epoch(complete_checkpoint=True)
        for _ in range(C4_DRILL_AT):
            r.step()
    drill = [1, wbase + 2, rbase + 6]
    drill_s, drill_launches, _ = _counted(
        lambda: faulted.failover_drill(drill))
    _assert_same(golden, faulted, "(a) after the drill")
    block_syncs = []
    _wrap_syncs(faulted.executor, "run_epoch", block_syncs)
    r0 = _source_records(faulted)
    t0 = time.monotonic()
    _, steady_launches, _ = _counted(
        lambda: faulted.run_epoch(complete_checkpoint=False))
    rate = (int(faulted.executor.carry.record_counts[:C4_PAR].sum()) - r0
            ) / (time.monotonic() - t0)
    delattr(faulted.executor, "run_epoch")
    golden.run_epoch(complete_checkpoint=False)
    if torch.device(DEVICE).type == "cuda" and any(block_syncs):
        raise AssertionError(f"(a) the block window synchronised: "
                             f"{block_syncs} at {SYNC_SITES}")
    flats = [2, wbase + 3, rbase + 7]
    faulted.inject_failure(flats)
    report, launches, syncs = _counted(faulted.recover, count_syncs=True)
    _mirror_ignore(golden, flats)
    _assert_same(golden, faulted, "(a) cascading feed/window/reduce kill")
    if report.steps_replayed != C4_SPE or report.records_replayed <= 0:
        raise AssertionError(f"(a) replayed {report.steps_replayed} steps")
    live = [t for t in timers if t < 2 * C4_SPE]
    if fired["golden"] != live or fired["faulted"] != live + live \
            or faulted.timer_services[wbase + 3].pending != 1:
        raise AssertionError(f"(a) timers: golden {fired['golden']}, "
                             f"faulted {fired['faulted']}")
    if _hist_silent(launches):
        raise AssertionError(f"(a) no kernel launch: {launches}")
    # The ring holds one epoch and the pending checkpoint was ignored, so
    # the run ends here (as bench.py's does): checkpoint 0's offsets, the
    # readers' floors they were committed to, and the live cursors agree.
    offsets = {}
    for k, r in runs.items():
        ck = r.standbys.latest
        off = torch.as_tensor(ck.carry.op_states[0]["offset"]).cpu()
        offsets[k] = (ck.checkpoint_id, off.tolist(),
                      list(r.executor.feed_readers[0]._base),
                      list(r.executor.feed_readers[0]._cursor))
    g = offsets["golden"]
    if offsets["faulted"] != g or g[0] != 0 or g[1] != g[2] \
            or min(g[1]) <= 0:
        raise AssertionError(f"(a) committed feed offsets {offsets}")
    log("[feeds] config #4 cascade == golden (carry, committed offsets, "
        "timers): " + json.dumps(_reading(
            report, launches, syncs, dev_line,
            block_window_syncs=block_syncs,
            steady_records_per_s=round(rate, 1),
            steady_epoch_launches=steady_launches,
            drill=dict(flats=drill, ms=round(drill_s * 1e3, 3),
                       kernel_launches=drill_launches),
            timers_refired=len(fired["faulted"]) - len(live),
            committed_offsets_total=int(sum(offsets["golden"][1])))))
    return launches


def build_c5_job():
    from clonos_tpu_torch.api.environment import StreamEnvironment
    env = StreamEnvironment(name="bench-c5", num_key_groups=C4_KEY_GROUPS,
                            default_edge_capacity=C5_EDGE)
    left = env.synthetic_source(vocab=C5_VOCAB, batch_size=C5_BATCH,
                                parallelism=C5_PAR).key_by()
    right = env.synthetic_source(vocab=C5_VOCAB, batch_size=C5_BATCH,
                                 parallelism=C5_PAR,
                                 name="source-r").key_by()
    (left.join(right, num_keys=C5_VOCAB, window=4, interval=1 << 30,
               parallelism=C5_PAR)
         .sink(parallelism=C5_PAR))
    return env.build()


def phase_join(dev_line):
    """(b) config #5: one completed epoch, three external calls, a time
    read and a random draw on join subtask 1 through its causal
    services, C5_FILL pending epochs (>= 10M buffered determinants), a
    join-class drill, then a kill of that subtask, against a golden run:
    the recovered log serves the recorded bytes without a second
    external call."""
    from clonos_tpu_torch.causal import determinant as det
    from clonos_tpu_torch.causal import services as svc
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    span = C5_FILL * C5_SPE
    kw = dict(steps_per_epoch=C5_SPE,
              log_capacity=1 << (span * DETS_PER_STEP - 1).bit_length(),
              max_epochs=16, inflight_ring_steps=1 << (span - 1)
              .bit_length(), replication_factor=2, logical_time=True,
              seed=C5_SEED)
    runs = {k: ClusterRunner(build_c5_job(), device=DEVICE, **kw)
            for k in ("golden", "faulted")}
    golden, faulted = runs["golden"], runs["faulted"]
    jbase = faulted.job.subtask_base(2)
    calls = {k: [] for k in runs}
    answers = {}
    sidecars = {}
    t0 = time.monotonic()
    for name, r in runs.items():
        sidecars[name] = det.SidecarStore(owner=jbase + 1)
        fac = r.executor.service_factory(
            jbase + 1, sidecars[name], seed=C5_SEED,
            clock=r.executor.time_source.now)
        ext = fac.serializable_service(
            lambda q, c=calls[name]: c.append(q) or b"answer:" + q)
        r.run_epoch(complete_checkpoint=True)
        answers[name] = [ext.apply(b"q%d" % i) for i in range(3)]
        fac.time_service().current_time_millis()
        fac.random_service().next_int()
        for _ in range(C5_FILL):
            r.run_epoch(complete_checkpoint=False)
    sync()
    fill_s = time.monotonic() - t0
    drill_s, drill_launches, _ = _counted(
        lambda: faulted.failover_drill([jbase]))
    _assert_same(golden, faulted, "(b) after the join drill")
    dets = int(faulted.executor.log_sizes().sum())
    if dets < C5_MIN_DETS:
        raise AssertionError(f"(b) {dets} buffered determinants < "
                             f"{C5_MIN_DETS}")
    faulted.inject_failure([jbase + 1])
    report, launches, syncs = _counted(faulted.recover, count_syncs=True)
    _mirror_ignore(golden, [jbase + 1])
    _assert_same(golden, faulted, "(b) join recovery")
    events = [d for _s, d in report.managers[0].result.async_events]
    serial = [d for d in events
              if isinstance(d, det.SerializableDeterminant)]
    replayed = []
    fac = svc.CausalServiceFactory(
        replayed.append, sidecars["faulted"], epoch_of=lambda: 0,
        replay_feed=svc.ReplayFeed(events))
    ext = fac.serializable_service(
        lambda q: calls["faulted"].append(q) or b"")
    again = [ext.apply(b"q%d" % i) for i in range(3)]
    if len(serial) != 3 or again != answers["faulted"] \
            or answers["faulted"] != answers["golden"] \
            or len(calls["faulted"]) != 3:
        raise AssertionError(f"(b) services: {len(serial)} SERIALIZABLE "
                             f"rows, replayed {again}, external calls "
                             f"{len(calls['faulted'])}")
    # The replay ranks its left records once a group of 64 steps
    # (``IntervalJoinOperator.group_size``'s cap, which one lane admits).
    if report.steps_replayed != span or _hist_silent(launches) \
            or launches["keyed_rank"] != span // 64:
        raise AssertionError(f"(b) replayed {report.steps_replayed} steps, "
                             f"launches {launches}")
    for r in runs.values():
        r.step()
    _assert_same(golden, faulted, "(b) one step after the recovery")
    log("[join] config #5 join recovery == golden (before and after one "
        "more step): " + json.dumps(_reading(
            report, launches, syncs, dev_line,
            buffered_determinants=dets,
            async_events=[type(d).__name__ for d in events],
            external_calls=len(calls["faulted"]),
            fill_seconds=round(fill_s, 3),
            drill=dict(flats=[jbase], ms=round(drill_s * 1e3, 3),
                       kernel_launches=drill_launches))))
    return launches


def build_egress_job(kind):
    from clonos_tpu_torch.api.environment import StreamEnvironment
    env = StreamEnvironment(name=f"egress-{kind}",
                            num_key_groups=C4_KEY_GROUPS,
                            default_edge_capacity=C4_EDGE)
    a = env.host_source(batch_size=C4_BATCH, parallelism=C4_PAR,
                        name="feed-a")
    b = env.host_source(batch_size=C4_BATCH, parallelism=C4_PAR,
                        name="feed-b")
    s = a.union(b, capacity=2 * C4_BATCH).key_by()
    if kind == "tumbling":
        s = s.window_event_time(num_keys=C4_VOCAB, window_size=EGRESS_WINDOW,
                                out_of_orderness=EGRESS_OOO)
    elif kind == "sliding":
        s = s.window_slide_event_time(num_keys=C4_VOCAB,
                                      window_size=EGRESS_WINDOW,
                                      slide=EGRESS_SLIDE,
                                      out_of_orderness=EGRESS_OOO)
    else:
        s = s.window_session(num_keys=C4_VOCAB, gap=EGRESS_SLIDE,
                             out_of_orderness=EGRESS_OOO)
    s.key_by().sink(transactional=True)
    return env.build()


def _files(root):
    out = {}
    for fn in sorted(os.listdir(root)):
        with open(os.path.join(root, fn), "rb") as f:
            out[fn] = f.read()
    return out


def _window_block_ms(runner, spe):
    """Wall ms of one block of the event-time window's step loop on the
    card (the vertex's own operator and state, a block of uniformly
    keyed records at the live edge capacity), against its step count."""
    from clonos_tpu_torch.api.operators import BlockContext
    from clonos_tpu_torch.api.records import RecordBatch
    v = runner.job.vertices[3]
    k = min(BLOCK_STEPS, spe)
    cap = runner.job.edges[runner.job.in_edges(3)[0]].capacity
    dev = runner.device
    rng = np.random.RandomState(C4_SEED)
    up = lambda a: torch.from_numpy(a).to(dev)
    keys = up(rng.randint(0, C4_VOCAB, (k, C4_PAR, cap)).astype(np.int32))
    ts = torch.arange(k, dtype=torch.int32, device=dev)[:, None, None] \
        .expand(k, C4_PAR, cap).contiguous()
    batch = RecordBatch(keys, torch.ones_like(keys), ts,
                        torch.ones_like(keys, dtype=torch.bool))
    bctx = BlockContext(ts[:, 0, 0], ts[:, 0, 0], ts[0, 0, 0], ts[0, 0, 0],
                        torch.arange(C4_PAR, dtype=torch.int32, device=dev))
    state = runner.executor.carry.op_states[3]
    sync()
    t0 = time.monotonic()
    v.operator.process_block(state, batch, bctx)
    sync()
    return round((time.monotonic() - t0) * 1e3, 3), k


def phase_egress(dev_line, root):
    """(c) two feeds -> union -> event-time window -> transactional sink
    with durable part files, the pipelined fence (capture and block
    windows under the sync-debug mode): one completed and two pending
    epochs, a kill of a union, a window and a sink subtask, one more
    completed epoch; the committed files equal the golden run's byte for
    byte with no pending part left. Then the sliding and the session
    window at shorter epochs, one window subtask killed each."""
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    launches_all = {"keyed_hist": 0, "keyed_hist_sums": 0}
    for kind in ("tumbling", "sliding", "session"):
        spe = C4_SPE if kind == "tumbling" else EGRESS_SHORT_SPE
        kw = dict(steps_per_epoch=spe,
                  log_capacity=1 << (5 * spe * DETS_PER_STEP - 1)
                  .bit_length(), max_epochs=16,
                  inflight_ring_steps=1 << (4 * spe - 1).bit_length(),
                  overlap_epoch=True, logical_time=True, seed=C4_SEED)
        runs = {k: ClusterRunner(build_egress_job(kind), device=DEVICE,
                                 **kw) for k in ("golden", "faulted")}
        golden, faulted = runs["golden"], runs["faulted"]
        sinks = {}
        for name, r in runs.items():
            for vid in (0, 1):
                r.executor.register_feed(vid, _feed_reader(
                    C4_SEED + vid, 4 * spe * C4_BATCH,
                    EGRESS_SESSION_PULL if kind == "session" else 1 << 30))
            sinks[name] = r.attach_file_sink(
                4, os.path.join(root, f"{kind}-{name}"))
        capture, blocks = [], []
        _wrap_syncs(faulted, "_begin_fence_tail", capture)
        _wrap_syncs(faulted.executor, "run_epoch", blocks)
        t0 = time.monotonic()
        for complete in (True, False, False):
            for r in runs.values():
                r.run_epoch(complete_checkpoint=complete)
        sync()
        epochs_s = time.monotonic() - t0
        ubase, wbase, sbase = (faulted.job.subtask_base(v) for v in (2, 3, 4))
        flats = ([ubase + 1, wbase + 2, sbase + 3] if kind == "tumbling"
                 else [wbase + 2])
        faulted.inject_failure(flats)
        report, launches, syncs = _counted(faulted.recover,
                                           count_syncs=True)
        golden.drain_fence()
        _mirror_ignore(golden, flats)
        _assert_same(golden, faulted, f"(c) {kind} recovery")
        for r in runs.values():
            r.run_epoch(complete_checkpoint=True)
            r.drain_fence()
        delattr(faulted, "_begin_fence_tail")
        delattr(faulted.executor, "run_epoch")
        _assert_same(golden, faulted, f"(c) {kind} one epoch on")
        files = {k: _files(os.path.join(root, f"{kind}-{k}")) for k in runs}
        committed = sinks["faulted"].read_committed()
        if files["golden"] != files["faulted"] or any(
                f.endswith(".pending") for f in files["faulted"]) \
                or sinks["faulted"].committed_epochs() != [0, 1, 2, 3] \
                or committed.shape[0] == 0:
            raise AssertionError(
                f"(c) {kind}: committed files differ or a pending part is "
                f"left: {sorted(files['faulted'])}")
        if torch.device(DEVICE).type == "cuda" and (any(capture)
                                                    or any(blocks)):
            raise AssertionError(f"(c) {kind}: capture {capture} / block "
                                 f"{blocks} windows synchronised at "
                                 f"{SYNC_SITES}")
        if _hist_silent(launches) and kind == "tumbling":
            raise AssertionError(f"(c) no kernel launch: {launches}")
        for k in launches_all:
            launches_all[k] += launches[k]
        block_ms, k = _window_block_ms(golden, spe)
        log(f"[egress] {kind} event-time window, transactional file sink "
            f"== golden byte for byte: " + json.dumps(_reading(
                report, launches, syncs, dev_line,
                capture_window_syncs=capture, block_window_syncs=blocks,
                committed_records=int(committed.shape[0]),
                committed_files=len(files["faulted"]),
                steps_per_epoch=spe, three_epochs_s=round(epochs_s, 3),
                window_block=dict(steps=k, wall_ms=block_ms))))
        del runs, golden, faulted
    return launches_all


# --- phase 10 ---------------------------------------------------------------

#: bench.py overhead_probe's epoch length (BENCH_PROFILE_SPE default) and
#: seed; its ring is one epoch (1 << (SPE - 1).bit_length())
PROBE_SPE = STEPS_PER_EPOCH
PROBE_SEED = 7
#: sections every profiled epoch of the headline job reports, and those
#: a spilled one adds per policy (``refill`` is a recovery's): with
#: every checkpoint completing, ``availability`` defers its ring epochs
#: until truncation drops them and its determinant segment usually
#: loses the race with truncation too, so ``spill-write`` may not occur
PROBE_SECTIONS = {"compute", "roll", "truncate", "snapshot",
                  "source-append", "health-read", "async-append"}
SPILL_SECTIONS = {
    "off": (PROBE_SECTIONS,) * 2,
    "availability": (PROBE_SECTIONS | {"spill"},
                     PROBE_SECTIONS | {"spill", "spill-write"}),
    "eager": (PROBE_SECTIONS | {"spill", "spill-write"},) * 2}
#: (b)'s kill: a window subtask EXTRA_STEPS past the second fence
TRACE_KILL = [(1, 4)]
#: recovery phase_ms keys that are credits or waits, not spans
UNTRACED_PHASES = {"finalize.overlap-saved", "finalize.listener-reattach"}

PHASE10_REDUCTIONS = (
    f"(a) bench.py overhead_probe at the headline's widths: steps_per_epoch="
    f"{PROBE_SPE}, ring {1 << (PROBE_SPE - 1).bit_length()}, seed "
    f"{PROBE_SEED}, 1 warm-up + 2 profiled epochs; cuts: logical_time=True, "
    f"window_size={WINDOW_SIZE} (bench: 1<<30), block_steps={BLOCK_STEPS}, "
    f"the lineage probe bench.py appends is not ported; spill split at "
    f"phase 8 (a)'s settings, 1 warm-up + 2 profiled epochs. (b)-(c) phase "
    f"7's runner (pipelined fence, audit, checkpoints on disk), 2 epochs + "
    f"{EXTRA_STEPS} steps, one window kill")


def _sections_ms(before, after):
    return {k: round((after.get(k, 0.0) - before.get(k, 0.0)) * 1e3, 3)
            for k in sorted(after)}


def _profiled(make, epochs=2, spill=False):
    """One warm-up epoch, then ``epochs`` profiled ones under a fresh
    process profiler; returns (runner, profiler, sections ms of the
    profiled epochs, profiler fences in them)."""
    from clonos_tpu_torch.obs import profile as prof_mod
    from clonos_tpu_torch.utils import devsync
    prof = prof_mod.configure_profile()
    r = make()
    r.run_epoch(complete_checkpoint=True)
    if spill:
        r.executor.drain_spill()
    sync()
    before = prof.lifetime()
    real, fences = devsync.device_sync, [0]

    def counting(tree):
        fences[0] += 1
        real(tree)
    devsync.device_sync = counting
    try:
        for _ in range(epochs):
            r.run_epoch(complete_checkpoint=True)
        if spill:
            r.executor.drain_spill()
        sync()
    finally:
        devsync.device_sync = real
    return r, prof, _sections_ms(before, prof.lifetime()), fences[0]


def _traced_pair(root, tag, path=None):
    """Phase 7's pipelined runner through 2 completed epochs and
    EXTRA_STEPS steps, the tracer on (to ``path``) or off; returns
    (runner, source records/s over the epochs, capture-window syncs)."""
    from clonos_tpu_torch import obs
    if path is not None:
        obs.configure("runner", path=path)
    else:
        obs.reset()
    r = _runner7(root, tag, True)
    syncs = []
    _wrap_syncs(r, "_begin_fence_tail", syncs)
    sync()
    r0 = _source_records(r)
    t0 = time.monotonic()
    for _ in range(2):
        r.run_epoch(complete_checkpoint=True)
    sync()
    rate = (_source_records(r) - r0) / (time.monotonic() - t0)
    delattr(r, "_begin_fence_tail")
    for _ in range(EXTRA_STEPS):
        r.step()
    return r, rate, syncs


def phase_observability(dev_line, root):
    """In-process observability on the headline job at full width: (a) the
    overhead probe and the spill section split, (b) a traced pipelined run
    with a window recovery, its Chrome export and its recovery spans
    against ``phase_ms``, (c) 0 syncs in the traced capture windows and
    records/s with the tracer on and off, (d) the metrics endpoint's four
    routes. Returns the path's kernel launches."""
    import urllib.request
    from clonos_tpu_torch import obs
    from clonos_tpu_torch.obs import chrome
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    from clonos_tpu_torch.utils import metrics as met
    out = {}
    t_phase = time.monotonic()

    def drive():
        # (a) bench.py overhead_probe: sequential fence, no audit.
        kw = dict(runner_kw(), seed=PROBE_SEED,
                  inflight_ring_steps=1 << (PROBE_SPE - 1).bit_length())
        r, prof, sections, fences = _profiled(
            lambda: ClusterRunner(build_job(), device=DEVICE, **kw))
        frac, life = prof.ft_fraction(), prof.lifetime_ft_fraction()
        if not (0.0 <= frac <= 1.0 and 0.0 <= life <= 1.0):
            raise AssertionError(f"(a) ft-fraction {frac}, lifetime {life}")
        if set(prof.lifetime()) != PROBE_SECTIONS or fences == 0:
            raise AssertionError(f"(a) sections {sorted(prof.lifetime())}, "
                                 f"{fences} profiler fences")
        out["registry"] = r.metrics
        log("[observability] (a) overhead probe: " + json.dumps(dict(
            overhead_ft_fraction=frac,
            overhead_ft_fraction_lifetime=round(life, 6),
            sections_ms_lifetime={k: round(v * 1e3, 3) for k, v in
                                  sorted(prof.lifetime().items())},
            sections_ms_profiled_epochs=sections,
            profiler_fences=fences, steps_per_epoch=PROBE_SPE,
            lineage_probe="not ported", device=dev_line)))
        del r
        # (a) the spill split at phase 8 (a)'s settings, against the
        # same epochs with spill off.
        split = {}
        for policy in ("off", "availability", "eager"):
            skw = _spill_kw(SPILL_STEADY_RING, SPILL_EPOCHS)
            spill = policy != "off"
            if spill:
                skw.update(spool_dir=os.path.join(root, f"spool-{policy}"),
                           spill_policy=policy)
            r, prof, sections, fences = _profiled(
                lambda: ClusterRunner(build_job(), device=DEVICE, **skw),
                spill=spill)
            least, most = SPILL_SECTIONS[policy]
            if not least <= set(prof.lifetime()) <= most:
                raise AssertionError(f"(a) {policy} sections "
                                     f"{sorted(prof.lifetime())}")
            stats = {}
            if spill:
                r.executor.close_spill()
                stats = r.executor.spill_stats()
            split[policy] = dict(
                sections_ms=sections, profiler_fences=fences,
                overhead_ft_fraction=prof.ft_fraction(),
                segments_written=stats.get("segments_written"),
                bytes_spilled=stats.get("bytes_spilled"))
            del r
        obs.reset_profile()
        log("[observability] (a) spill split (spill = the hook's host time, "
            "spill-write = the writer thread, compute = the blocks, each "
            "over 2 profiled epochs): " + json.dumps(dict(
                split, steps_per_epoch=SPILL_SPE, device=dev_line)))

        # (b)-(c) off, on (killed and recovered), on, off.
        path = os.path.join(root, "trace-runner.jsonl")
        golden, rate_off, _ = _traced_pair(root, "t-golden")
        golden.drain_fence()
        traced, rate_on, syncs = _traced_pair(root, "t-traced", path)
        rates = {"off": [rate_off], "on": [rate_on]}
        flats = _flats(traced, TRACE_KILL)
        traced.inject_failure(flats)
        report = traced.recover()
        _assert_same(golden, traced, "(b) traced window recovery")
        out["tracer"] = obs.get_tracer()
        for r in (golden, traced):
            r.drain_fence()
            r.coordinator.storage._close_ledger()
        del golden, traced
        for tag, p in (("on", path + ".2"), ("off", None)):
            r, rate, more = _traced_pair(root, f"t-{tag}2", p)
            rates[tag].append(rate)
            syncs += more if tag == "on" else []
            r.drain_fence()
            r.coordinator.storage._close_ledger()
            del r
        out["report"], out["rates"], out["syncs"] = report, rates, syncs
        out["path"] = path

    _, launches, _ = _counted(drive)
    report, rates, syncs = out["report"], out["rates"], out["syncs"]
    tracer = out["tracer"]
    obs.reset()
    records = chrome.load_jsonl(out["path"])
    n_events = chrome.validate_chrome(chrome.to_chrome(records))
    names = {r["name"] for r in records}
    want = {"epoch.steps", "epoch.fence", "checkpoint.trigger",
            "checkpoint", "recovery.finalize", "recovery"}
    phases = {k: v for k, v in report.phase_ms.items()
              if k not in UNTRACED_PHASES}
    span_ms = {k: sum(r["dur"] for r in records
                      if r["name"] == f"recovery.{k}") * 1e3 for k in phases}
    if n_events <= 0 or not want <= names or not all(
            f"recovery.{k}" in names for k in phases):
        raise AssertionError(f"(b) trace names {sorted(names)}")
    off_by = {k: abs(span_ms[k] - v) for k, v in phases.items()}
    if max(off_by.values()) > 0.01:
        raise AssertionError(f"(b) recovery spans vs phase_ms: {off_by}")
    if torch.device(DEVICE).type == "cuda" and any(syncs):
        raise AssertionError(f"(c) traced capture windows synchronised: "
                             f"{syncs} at {SYNC_SITES}")
    if _hist_silent(launches):
        raise AssertionError(f"observability path launched no kernel: "
                             f"{launches}")
    summary = chrome.summarize(records)
    log("[observability] (b) traced pipelined run, window recovery == "
        "golden; Chrome trace valid: " + json.dumps(dict(
            chrome_events=n_events, records=summary["records"],
            traces=len(summary["traces"]),
            names={k: dict(count=v["count"],
                           total_ms=round(v["total_s"] * 1e3, 3))
                   for k, v in sorted(summary["names"].items())},
            recovery_ms=round(report.recovery_ms, 3),
            phase_ms={k: round(v, 3) for k, v in report.phase_ms.items()},
            span_minus_phase_ms_max=max(off_by.values()),
            device=dev_line)))
    log("[observability] (c) tracer on, pipelined fence: " + json.dumps(dict(
        capture_window_syncs=syncs,
        source_records_per_s_off_on_on_off=[
            round(x, 1) for x in (rates["off"][0], rates["on"][0],
                                  rates["on"][1], rates["off"][1])],
        note="reading, not a claim", device=dev_line)))

    # (d) the endpoint over (a)'s registry, (b)'s flight recorder.
    hist = obs.MetricsHistory(interval_s=3600.0, window=8)
    ep = met.MetricsEndpoint(out["registry"], host="127.0.0.1", port=0,
                             tracer=tracer, history=hist)
    try:
        base = "http://%s:%d" % ep.address
        for _ in range(2):
            hist.sample_once()
        bodies = {route: urllib.request.urlopen(base + route,
                                                timeout=60).read()
                  for route in ("/metrics", "/metrics.json",
                                "/metrics/history.json", "/trace")}
    finally:
        ep.close()
    gauge = "job.bench-allround.overhead.ft-fraction"
    js = json.loads(bodies["/metrics.json"])
    samples = json.loads(bodies["/metrics/history.json"])["samples"]
    trace_events = chrome.validate_chrome(json.loads(bodies["/trace"]))
    if gauge not in js or met._prom_name(gauge).encode() + b" " \
            not in bodies["/metrics"] or len(samples) != 2 \
            or gauge not in samples[-1]["metrics"] or trace_events <= 0:
        raise AssertionError("(d) endpoint: overhead.ft-fraction missing "
                             "or a route is malformed")
    log("[observability] (d) endpoint on 127.0.0.1: " + json.dumps(dict(
        routes={k: len(v) for k, v in bodies.items()},
        ft_fraction=js[gauge], history_samples=len(samples),
        trace_events=trace_events, kernel_launches=launches,
        phase_seconds=round(time.monotonic() - t_phase, 3),
        device=dev_line)))
    return launches



# --- phase 11 ---------------------------------------------------------------

#: the worker CLI's own depth: 16-step epochs (its default), every third
#: checkpoint completed (at most 48 un-truncated steps in the default
#: 64-step ring and 1<<14-row logs), killed after the status line of run
#: 26 (27 epochs, 9 completed checkpoints, 20 epochs after the third).
#: Line i is printed after the refresh of fence i - 1, so a kill after
#: line i with i % 3 == 2 leaves the mirror one fence or more past the
#: last completed checkpoint (run i - 2) and lands before the next one
#: (run i + 1) completes, an epoch and a sleep later.
WC_SPE = 16
WC_COMPLETE_EVERY = 3
WC_KILL_AT = 26
WC_SEED = 5
WC_EPOCH_SLEEP = 0.3
HB_TIMEOUT_S = 3.0
HB_INTERVAL_S = 0.2
#: (a): seeded key:value lines sent over TCP (40 blocks of the socket
#: source's batch of 64), a window kill this many steps past a fence
SOCKET_LINES = 40 * 64
#: phase 11 (a)'s source records/s (lines read over its drive's wall),
#: which phase 19 (d) prints its own beside
PHASE11_RECORDS_PER_S = None
SOCKET_SEED = 11
SOCKET_KILL_AT = 5
#: in-process refresh timing: fences of the same job
REFRESH_EPOCHS = 6

PHASE11_REDUCTIONS = (
    f"(a) examples/wordcount.py build_socket_job at its published widths "
    f"(1 socket source x 64 records a step -> keyBy -> window over 1,000 "
    f"keys, window 500 -> sink, 64 key groups), {SOCKET_LINES} seeded "
    f"lines, steps_per_epoch={WC_SPE}; no cut. (b) build_job at its "
    f"published widths (4 sources x 64 -> keyBy -> 4 windows over 1,000 "
    f"keys -> 4 sinks, 64 key groups) through `python -m clonos_tpu_torch "
    f"worker` with the CLI's defaults (log capacity 1<<14, ring 64 steps, "
    f"steps_per_epoch={WC_SPE}) and --complete-every {WC_COMPLETE_EVERY} "
    f"--seed {WC_SEED} --epoch-sleep {WC_EPOCH_SLEEP} --heartbeat-interval "
    f"{HB_INTERVAL_S}; JobMaster heartbeat timeout {HB_TIMEOUT_S} s; cut: "
    f"depth, killed after {WC_KILL_AT + 1} epochs (the reference test: 8)")


def _pump(stream, q):
    for line in iter(stream.readline, ""):
        q.put(line)
    q.put(None)


def _serve_lines(payload: bytes):
    """A one-connection TCP server on 127.0.0.1 that sends ``payload``
    and closes; returns (port, thread)."""
    import socket
    import threading
    srv = socket.create_server(("127.0.0.1", 0))

    def serve():
        with srv:
            conn, _ = srv.accept()
            with conn:
                conn.sendall(payload)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return srv.getsockname()[1], t


def phase_socket_wordcount(dev_line):
    """(a) BASELINE config #1: the socket wordcount job fed seeded
    ``key:value`` lines over TCP, run to drain, its window subtask killed
    mid-epoch and recovered; the digest after recovery equals the one
    before the kill and the source read every line sent."""
    from clonos_tpu_torch.api.feeds import SocketFeedReader
    from clonos_tpu_torch.examples import wordcount as wc
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    rng = np.random.RandomState(SOCKET_SEED)
    keys = rng.randint(0, wc.VOCAB, SOCKET_LINES)
    vals = rng.randint(1, 10, SOCKET_LINES)
    port, server = _serve_lines("".join(
        f"{k}:{v}\n" for k, v in zip(keys, vals)).encode())
    reader = SocketFeedReader("127.0.0.1", port)
    try:
        reader._thread.join(timeout=120)
        server.join(timeout=120)
        if reader._thread.is_alive() or server.is_alive():
            raise AssertionError("(a) the socket feed did not drain")
        runner = ClusterRunner(wc.build_socket_job(), steps_per_epoch=WC_SPE,
                               seed=WC_SEED, device=DEVICE)
        runner.executor.register_feed(0, reader)
        window = runner.job.subtask_base(1)

        def drive():
            runner.run_epoch(complete_checkpoint=True)
            for _ in range(SOCKET_KILL_AT):
                runner.step()
            before = runner.state_digest()
            runner.inject_failure([window])
            report = runner.recover()
            after = runner.state_digest()
            epochs = 1
            while int(runner.executor.carry.record_counts[0]) \
                    < SOCKET_LINES and epochs < 2 * SOCKET_LINES // (
                        64 * WC_SPE):
                runner.run_epoch(complete_checkpoint=True)
                epochs += 1
            return before, after, report, epochs

        t0 = time.monotonic()
        (before, after, report, epochs), launches, _ = _counted(drive)
        wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        reader.close()
    source = int(runner.executor.carry.record_counts[0])
    global PHASE11_RECORDS_PER_S
    PHASE11_RECORDS_PER_S = source / (wall_ms / 1e3)
    if after != before:
        raise AssertionError(f"(a) digest after recovery {after} != before "
                             f"the kill {before}")
    if source != SOCKET_LINES:
        raise AssertionError(f"(a) source records {source} != lines sent "
                             f"{SOCKET_LINES}")
    if report.steps_replayed != SOCKET_KILL_AT or \
            _hist_silent(launches):
        raise AssertionError(f"(a) replayed {report.steps_replayed} steps, "
                             f"launches {launches}")
    log("[socket] config #1 drained and recovered, digest equal: "
        + json.dumps(_reading(
            report, launches, None, dev_line, lines_sent=SOCKET_LINES,
            source_records=source, epochs=epochs, digest=after,
            records_lost=reader.records_lost,
            phase_wall_ms=round(wall_ms, 3))))
    return launches


def _refresh_ms():
    """Wall ms of ``HostLogEndpoint.refresh`` at each fence of an
    in-process runner of the worker's job on this device (the queue is
    drained first, so the time is the copy and the slicing alone)."""
    from clonos_tpu_torch.examples import wordcount as wc
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    from clonos_tpu_torch.runtime.remote import HostLogEndpoint
    r = ClusterRunner(wc.build_job(), steps_per_epoch=WC_SPE, seed=WC_SEED,
                      device=DEVICE)
    ep = HostLogEndpoint(r.executor)
    out = []
    try:
        for i in range(REFRESH_EPOCHS):
            r.run_epoch(complete_checkpoint=(i % WC_COMPLETE_EVERY == 0))
            sync()
            t0 = time.monotonic()
            ep.refresh()
            out.append(round((time.monotonic() - t0) * 1e3, 3))
    finally:
        ep.close()
    return out


def phase_host_loss(dev_line, root):
    """(b) Host-loss failover across two processes on one card: a worker
    process (``python -m clonos_tpu_torch worker``) runs the wordcount job
    under this process's JobMaster; this process mirrors its logs; the
    worker is SIGKILLed; heartbeat expiry flags it; the controller
    rebuilds the whole job here on the card with the digest the worker
    reported at that global step; the rebuilt job runs on and survives
    two ordinary window kills. Returns the rebuild's and run-on's kernel
    launches."""
    import queue
    import signal
    import threading
    from clonos_tpu_torch.examples import wordcount as wc
    from clonos_tpu_torch.ops import native
    from clonos_tpu_torch.runtime import remote
    repo = os.path.dirname(os.path.abspath(__file__))
    jm = remote.JobMasterServer(heartbeat_timeout_s=HB_TIMEOUT_S)
    ctl = remote.JobMasterController(jm, device=DEVICE)
    cmd = [sys.executable, "-m", "clonos_tpu_torch", "worker",
           "clonos_tpu_torch.examples.wordcount:build_job",
           "--jm", f"127.0.0.1:{jm.address[1]}",
           "--checkpoint-dir", os.path.join(root, "ck"),
           "--executor-id", "worker-0", "--epochs", "64",
           "--steps-per-epoch", str(WC_SPE),
           "--complete-every", str(WC_COMPLETE_EVERY),
           "--seed", str(WC_SEED), "--heartbeat-interval", str(HB_INTERVAL_S),
           "--epoch-sleep", str(WC_EPOCH_SLEEP)]
    if torch.device(DEVICE).type != "cuda":
        cmd += ["--device", DEVICE]          # a CPU rehearsal
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t_phase = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                            text=True)
    lines = queue.Queue()
    threading.Thread(target=_pump, args=(proc.stdout, lines),
                     daemon=True).start()

    def next_line(timeout=300):
        line = lines.get(timeout=timeout)
        if line is None:
            raise AssertionError(f"(b) the worker exited early "
                                 f"(rc {proc.wait(timeout=60)})")
        return json.loads(line)

    digests, syncs = {}, []
    try:
        first = next_line()
        if first.get("registered") != "worker-0" \
                or ctl.attach() != ["worker-0"]:
            raise AssertionError(f"(b) registration: {first}")
        info = jm.info("worker-0")
        if info["device"].split(":")[0] != torch.device(DEVICE).type \
                or info["codec"] != "native" or not native.available():
            raise AssertionError(f"(b) the worker runs on {info['device']} "
                                 f"with the {info['codec']} codec")
        mirror = ctl.mirrors["worker-0"]
        i = 0
        t_worker = time.monotonic()
        while True:
            st = next_line(timeout=120)
            digests[st["global_step"]] = st["digest"]
            t0 = time.monotonic()
            if ctl.sync()["worker-0"] < 0:
                raise AssertionError("(b) the mirror lost the worker")
            syncs.append((mirror.last_rows, mirror.last_frame_bytes,
                           (time.monotonic() - t0) * 1e3))
            if i >= WC_KILL_AT and i % WC_COMPLETE_EVERY == 2 \
                    and lines.empty():
                break
            i += 1
        worker_s = time.monotonic() - t_worker
        proc.send_signal(signal.SIGKILL)
        t_kill = time.monotonic()
        proc.wait(timeout=60)
        while (line := lines.get(timeout=60)) is not None:
            st = json.loads(line)
            digests[st["global_step"]] = st["digest"]
        deadline = t_kill + 4 * HB_TIMEOUT_S + 10
        while "worker-0" not in ctl.failed():
            if time.monotonic() > deadline:
                raise AssertionError("(b) heartbeat expiry not seen")
            time.sleep(0.05)
        detect_ms = (time.monotonic() - t_kill) * 1e3
        t0 = time.monotonic()
        (runner, report), rebuild_launches, _ = _counted(
            lambda: ctl.rebuild("worker-0", wc.build_job(),
                                steps_per_epoch=WC_SPE, seed=WC_SEED))
        rebuild_ms = (time.monotonic() - t0) * 1e3
        rebuilt_step = runner.global_step
        digest = runner.state_digest()
        if runner.device.type != torch.device(DEVICE).type \
                or runner.global_step not in digests \
                or digest != digests[runner.global_step]:
            raise AssertionError(
                f"(b) the rebuild on {runner.device} at global step "
                f"{runner.global_step} has digest {digest}; the worker "
                f"reported {digests.get(runner.global_step)}")
        if report.steps_replayed != runner.global_step \
                - runner._fence_step[report.from_epoch] \
                or report.determinants_replayed <= 0 \
                or _hist_silent(rebuild_launches):
            raise AssertionError(f"(b) rebuild replayed "
                                 f"{report.steps_replayed} steps, launches "
                                 f"{rebuild_launches}")
        window = runner.job.subtask_base(1) + 1

        def run_on():
            runner.run_epoch(complete_checkpoint=True)
            runner.run_epoch(complete_checkpoint=False)
            runner.inject_failure([window])
            runner.recover()
            runner.run_epoch(complete_checkpoint=True)
            for _ in range(SOCKET_KILL_AT):
                runner.step()
            before = runner.state_digest()
            runner.inject_failure([window])
            rep = runner.recover()
            return before, rep
        (before, rep), run_on_launches, _ = _counted(run_on)
        if runner.state_digest() != before \
                or rep.steps_replayed != SOCKET_KILL_AT:
            raise AssertionError("(b) the rebuilt job's window recovery "
                                 "diverged")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        ctl.close()
        jm.close()
    refresh = _refresh_ms()
    launches = {k: rebuild_launches[k] + run_on_launches[k]
                for k in rebuild_launches}
    rows = [s[0] for s in syncs]
    nbytes = [s[1] for s in syncs]
    sync_ms = [s[2] for s in syncs]
    log("[failover] host loss rebuilt on the card, digest equal: "
        + json.dumps(_reading(
            report, rebuild_launches, None, dev_line,
            rebuild_ms=round(rebuild_ms, 3), global_step=rebuilt_step,
            epochs_seen=len(digests), worker_seconds=round(worker_s, 3),
            detect_ms=round(detect_ms, 3),
            mirror_syncs=len(syncs),
            mirror_rows_per_sync={"mean": round(float(np.mean(rows)), 3),
                                  "max": int(max(rows))},
            frame_bytes_per_sync={"mean": round(float(np.mean(nbytes)), 3),
                                  "max": int(max(nbytes))},
            sync_ms={"median": round(float(np.median(sync_ms)), 3),
                     "max": round(float(max(sync_ms)), 3)},
            codec=info["codec"], worker_device=info["device"],
            refresh_ms_per_fence=refresh,
            run_on_launches=run_on_launches,
            phase_seconds=round(time.monotonic() - t_phase, 3))))
    return launches


# --- phase 12 ---------------------------------------------------------------

#: bench.py serve_probe's parts 1-2 (bench.py:766-779): 256-step epochs,
#: log and ring sized from them, seed 7, keys from RandomState(13)
SERVE_SPE = 256
SERVE_SEED = 7
SERVE_EPOCHS = 3
SERVE_SEQ_READS = 256
SERVE_BATCH_READS = 4096
SERVE_CHUNK = 256
SERVE_KEY_SEED = 13
SERVE_LOG = 1 << (2 * SERVE_SPE * DETS_PER_STEP).bit_length()
SERVE_RING = 1 << (2 * SERVE_SPE - 1).bit_length()
#: (b): epochs of the pipelined, audited runner under reads, the epoch
#: after which replica 0 is killed, and the keys of one routed read
SERVE_INGEST_EPOCHS = 12
SERVE_KILL_AT = 4
SERVE_READ_KEYS = 32
SERVE_READ_SEED = 17
#: the reader's pause between reads (it yields the GIL to the driving thread)
SERVE_READ_GAP_S = 0.001

PHASE12_REDUCTIONS = (
    f"bench.py serve_probe parts 1-2 at the headline's widths (8 sources "
    f"x {BATCH} -> keyBy -> 8 windows over {VOCAB} keys -> keyBy(static) -> "
    f"8 reduces -> 8 sinks, 32 subtasks; steps_per_epoch={SERVE_SPE}, "
    f"block_steps={SERVE_SPE}, log_capacity={SERVE_LOG}, "
    f"inflight_ring_steps={SERVE_RING}, seed {SERVE_SEED}; a tier of 2 "
    f"replicas on the reduce, {SERVE_EPOCHS} completed epochs; "
    f"{SERVE_SEQ_READS} point reads then {SERVE_BATCH_READS} batched reads "
    f"in chunks of {SERVE_CHUNK}, keys from RandomState({SERVE_KEY_SEED})); "
    f"cuts: logical_time=True, window_size={WINDOW_SIZE} (bench: 1<<30, "
    f"never fires, so its reduce tables stay 0). (b) in place of part 3's "
    f"soak driver (not ported): the same runner pipelined with the audit on "
    f"for {SERVE_INGEST_EPOCHS} epochs, a reader thread issuing routed "
    f"reads of {SERVE_READ_KEYS} keys {SERVE_READ_GAP_S * 1e3:g} ms apart, "
    f"replica 0 killed after epoch "
    f"{SERVE_KILL_AT}, against the same runner without a tier")


def _serve_runner(dev, **kw):
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    return ClusterRunner(
        build_job(), device=dev, steps_per_epoch=SERVE_SPE,
        log_capacity=SERVE_LOG, max_epochs=16,
        inflight_ring_steps=SERVE_RING, block_steps=SERVE_SPE,
        logical_time=True, seed=SERVE_SEED, **kw)


def _reduce_vid(job):
    return next(v.vertex_id for v in job.vertices
                if getattr(v.operator, "emits_running_value", False))


def _timed_refresh(tier, out):
    """Time every owner refresh (the fence hook's wait) into ``out``."""
    refresh = tier.owner_endpoint.refresh

    def timed(*a, **k):
        t0 = time.monotonic()
        refresh(*a, **k)
        out.append(round((time.monotonic() - t0) * 1e3, 3))
    tier.owner_endpoint.refresh = timed


def phase_serve_reads(dev_line):
    """(a) The read tier at full width: point vs batched reads through
    replica 0, replica values == owner values at the same stamp, point ==
    batched, the replicas' tables == the reduce's ``vertex_state`` == a
    CPU run's table, dispatches <= batches, 0 synchronising calls in the
    serve window (counted on the dispatch thread). Returns the epochs'
    kernel launches."""
    from clonos_tpu_torch.runtime import serve
    runner = _serve_runner(DEVICE)
    vid = _reduce_vid(runner.job)
    tier = serve.build_serve_tier(runner, vid, n_replicas=2)
    refresh_ms, feed_ms = [], []
    _timed_refresh(tier, refresh_ms)
    try:
        def epochs():
            for _ in range(SERVE_EPOCHS):
                runner.run_epoch(complete_checkpoint=True)
                feed_ms.append(round(
                    runner.last_fence_phases["fence.serve-feed"], 3))
            runner.drain_fence()
        _, launches, _ = _counted(epochs)
        rng = np.random.RandomState(SERVE_KEY_SEED)
        rep = tier.clients[0]
        ep = tier.endpoints[0]
        rep.query_batch(vid, [0])             # the first upload and gather
        rep.query(vid, 0)
        keys_seq = rng.randint(0, VOCAB, SERVE_SEQ_READS)
        t0 = time.monotonic()
        seq_out = [rep.query(vid, int(k)) for k in keys_seq]
        seq_s = time.monotonic() - t0
        keys_b = rng.randint(0, VOCAB, SERVE_BATCH_READS)
        d0 = ep.dispatches
        batch_epochs, batch_vals = [], {}
        t0 = time.monotonic()
        for i in range(0, SERVE_BATCH_READS, SERVE_CHUNK):
            chunk = [int(k) for k in keys_b[i:i + SERVE_CHUNK]]
            out = rep.query_batch(vid, chunk)
            batch_epochs.append(out["epoch"])
            batch_vals.update(zip(chunk, out["values"]))
        batch_s = time.monotonic() - t0
        n_batches = SERVE_BATCH_READS // SERVE_CHUNK
        batch_dispatches = ep.dispatches - d0
        # The serve window's syncs, counted on the dispatch thread over
        # one more pass of the same batches (outside the timed ones).
        fn = serve._gather_fn(runner.job.vertices[vid].parallelism,
                              runner.job.num_key_groups)
        window_syncs = []

        def counted_gather(acc, keys):
            out, n = _sync_count(lambda: fn(acc, keys), this_thread=True)
            window_syncs.append(n)
            return out
        gather_fn = serve._gather_fn
        serve._gather_fn = lambda *_: counted_gather
        try:
            for i in range(0, SERVE_BATCH_READS, SERVE_CHUNK):
                rep.query_batch(vid, [int(k) for k in
                                      keys_b[i:i + SERVE_CHUNK]])
        finally:
            serve._gather_fn = gather_fn
        probe_keys = sorted(batch_vals)
        own = tier.owner_client.query_batch(vid, probe_keys)
        mismatched = [k for k, v in zip(probe_keys, own["values"])
                      if batch_vals[k] != v]
        point_bad = [int(k) for k, o in zip(keys_seq, seq_out)
                     if int(k) in batch_vals
                     and o["value"] != batch_vals[int(k)]]
        card = runner.executor.vertex_state(vid)["acc"]
        tables = [r.host_view() for r in tier.replicas]
        # The gather's time per dispatch at a chunk's bucket, on a copy
        # of the replica's table (the endpoint's stream is its own).
        acc = torch.from_numpy(tables[0][0]).to(DEVICE)
        gkeys = torch.from_numpy(np.resize(
            keys_b[:SERVE_CHUNK], serve._bucket(SERVE_CHUNK)).astype(
                np.int32)).to(DEVICE)
        gather_ms = gather_device_ms = None
        if torch.device(DEVICE).type == "cuda":
            gather_ms = _time_ms(lambda: fn(acc, gkeys))
            gather_device_ms = _device_ms(lambda: fn(acc, gkeys), None)
        statuses = [r.status() for r in tier.replicas]
        epoch = own["epoch"]
    finally:
        tier.close()
    cpu = _serve_runner("cpu")
    for _ in range(SERVE_EPOCHS):
        cpu.run_epoch(complete_checkpoint=True)
    cpu_table = cpu.executor.vertex_state(vid)["acc"]
    problems = []
    if not (all(e == epoch for e in batch_epochs)
            and epoch == SERVE_EPOCHS - 1):
        problems.append(f"epoch stamps {batch_epochs} vs owner {epoch}")
    if mismatched:
        problems.append(f"replica != owner at keys {mismatched[:8]}")
    if point_bad:
        problems.append(f"point != batched at keys {point_bad[:8]}")
    for i, (table, stamp) in enumerate(tables):
        if stamp != epoch or not np.array_equal(table, card):
            problems.append(f"replica {i} table (epoch {stamp}) != the "
                            f"reduce's vertex_state")
    if not np.array_equal(card, cpu_table) or not card.any():
        problems.append("the card's reduce table != the CPU run's (or "
                        "all zero)")
    if batch_dispatches > n_batches:
        problems.append(f"{batch_dispatches} dispatches > {n_batches} "
                        f"batches")
    if torch.device(DEVICE).type == "cuda" and (
            any(window_syncs) or len(window_syncs) != n_batches):
        problems.append(f"serve windows synchronised: {window_syncs} at "
                        f"{SYNC_SITES}")
    if _hist_silent(launches):
        problems.append(f"no kernel launch: {launches}")
    if problems:
        raise AssertionError("(a) " + "; ".join(problems))
    qps_seq = SERVE_SEQ_READS / seq_s
    qps_batch = SERVE_BATCH_READS / batch_s
    log("[serve] (a) batched vs point reads, replica == owner == vertex_state "
        "== CPU: " + json.dumps(dict(
            epoch=epoch, reads_per_s_point=round(qps_seq, 1),
            reads_per_s_batched=round(qps_batch, 1),
            batched_over_point=round(qps_batch / qps_seq, 2),
            reference_bar=5.0, batch_dispatches=batch_dispatches,
            batches=n_batches, serve_window_syncs=window_syncs,
            gather_ms_per_dispatch={
                "events": gather_ms and round(gather_ms, 4),
                "device": gather_device_ms and round(gather_device_ms, 4)},
            fence_serve_feed_ms=feed_ms, owner_refresh_ms=refresh_ms,
            replica_status=statuses, kernel_launches=launches,
            device=dev_line)))
    return launches


def _ingest(runner, tier, kill_at):
    """Run ``SERVE_INGEST_EPOCHS`` pipelined epochs; with a tier, a reader
    thread issues routed reads from the first fence on and replica 0 dies
    after epoch
    ``kill_at`` (the driving thread waits, outside the timed wall, until a read
    was rerouted). Returns (source records/s, capture-window syncs,
    fence.serve-feed ms, reader stats)."""
    import threading
    stats = {"reads": 0, "errors": [], "staleness": []}
    stop = threading.Event()

    def reader():
        rng = np.random.RandomState(SERVE_READ_SEED)
        vid = tier.vertex_id
        while not stop.is_set():
            keys = rng.randint(0, VOCAB, SERVE_READ_KEYS)
            try:
                out = tier.router.query_batch(vid, [int(k) for k in keys])
                if len(out["values"]) != SERVE_READ_KEYS:
                    raise AssertionError(f"{len(out['values'])} values")
                stats["reads"] += 1
                tier.mark_reads(SERVE_READ_KEYS)
            except Exception as e:       # a client-visible error
                stats["errors"].append(repr(e))
            stats["staleness"].append(max(tier.staleness()))
            stop.wait(SERVE_READ_GAP_S)

    syncs, feed = [], []
    begin = runner._begin_fence_tail

    def counted_begin(*a):
        out, n = _sync_count(lambda: begin(*a), this_thread=True)
        syncs.append(n)
        return out
    runner._begin_fence_tail = counted_begin
    th = None
    if tier is not None:
        th = threading.Thread(target=reader, name="serve-reader",
                              daemon=True)
    r0 = _source_records(runner)
    paused = 0.0
    t0 = time.monotonic()
    try:
        for e in range(SERVE_INGEST_EPOCHS):
            runner.run_epoch(complete_checkpoint=True)
            feed.append(runner.last_fence_phases.get("fence.serve-feed"))
            if th is not None and e == 0:
                th.start()          # the owner serves from the first fence
            if tier is not None and e == kill_at:
                tp = time.monotonic()
                before = tier.router.reroutes
                tier.kill_replica(0)
                stats["staleness"].append(max(tier.staleness()))
                deadline = tp + 30.0
                while tier.router.reroutes == before and \
                        time.monotonic() < deadline and th.is_alive():
                    time.sleep(0.001)
                paused += time.monotonic() - tp
        runner.drain_fence()
        feed.append(runner.last_fence_phases.get("fence.serve-feed"))
        sync()
        wall = time.monotonic() - t0 - paused
    finally:
        stop.set()
        if th is not None:
            th.join(timeout=30.0)
        runner._begin_fence_tail = begin
    rate = (_source_records(runner) - r0) / wall
    return rate, syncs, [round(x, 3) for x in feed if x is not None], stats


def phase_serve_ingest(dev_line):
    """(b) Reads under ingest: the pipelined, audited runner with a tier
    and a reader thread, replica 0 killed after epoch ``SERVE_KILL_AT``;
    0 client-visible errors, reroutes > 0, a staleness peak above the
    final staleness of 0, a revival, a sealed ledger equal to the same
    runner's without a tier, 0 syncs in each capture window. Returns the
    tiered run's kernel launches."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    from clonos_tpu_torch.runtime import serve
    from clonos_tpu_torch.soak.slo import quantile
    control = _serve_runner(DEVICE, overlap_epoch=True, audit=True)
    rate_off, syncs_off, _, _ = _ingest(control, None, -1)
    runner = _serve_runner(DEVICE, overlap_epoch=True, audit=True)
    tier = serve.build_serve_tier(runner, _reduce_vid(runner.job),
                                  n_replicas=2, staleness_bound=2)
    try:
        (rate_on, syncs_on, feed, stats), launches, _ = _counted(
            lambda: _ingest(runner, tier, SERVE_KILL_AT))
        final = tier.staleness()
        router = tier.router
        lat = sorted(router.recent_ms)
        p50 = quantile(lat, 0.5)
        p99 = quantile(lat, 0.99)
        reroutes, reads = router.reroutes, router.reads
        revivals = [r.revivals for r in tier.replicas]
        snap = runner.metrics.snapshot()
    finally:
        tier.close()
    problems = []
    if stats["errors"] or not stats["reads"]:
        problems.append(f"{len(stats['errors'])} client-visible errors "
                        f"{stats['errors'][:3]}, {stats['reads']} reads")
    if reroutes <= 0:
        problems.append("no read was rerouted")
    peak = max(stats["staleness"])
    if not (peak > max(final) == 0):
        problems.append(f"staleness peak {peak}, final {final}")
    if revivals[0] < 1:
        problems.append(f"revivals {revivals}")
    led, led_off = (runner.coordinator.read_ledger(),
                    control.coordinator.read_ledger())
    diff = diff_ledgers(led_off, led)
    if diff or len(led) != SERVE_INGEST_EPOCHS:
        problems.append(f"ledger with the tier != without: {diff[:4]} "
                        f"({len(led)} entries)")
    if torch.device(DEVICE).type == "cuda" and (any(syncs_on)
                                                or any(syncs_off)):
        problems.append(f"capture windows synchronised: {syncs_on} / "
                        f"{syncs_off} at {SYNC_SITES}")
    if _hist_silent(launches):
        problems.append(f"no kernel launch: {launches}")
    if problems:
        raise AssertionError("(b) " + "; ".join(problems))
    log("[serve] (b) reads under ingest with a replica kill, ledger == "
        "without a tier: " + json.dumps(dict(
            epochs=SERVE_INGEST_EPOCHS, reader_batches=stats["reads"],
            routed_reads=reads, client_errors=0, reroutes=reroutes,
            staleness_peak=peak, staleness_final=final, revivals=revivals,
            read_ms={"p50": round(p50, 3), "p99": round(p99, 3)},
            source_records_per_s={"with_tier": round(rate_on, 1),
                                  "without": round(rate_off, 1)},
            fence_serve_feed_ms={"mean": round(float(np.mean(feed)), 3),
                                 "per_fence": feed},
            capture_window_syncs={"with_tier": syncs_on,
                                  "without": syncs_off},
            serve_gauges={k: v for k, v in snap.items()
                          if k.startswith("serve.")},
            kernel_launches=launches, device=dev_line)))
    return launches


# --- phase 13 ---------------------------------------------------------------

#: (a) the headline job across two slot-worker processes: its spec (the
#: workers import it with the repo on PYTHONPATH), cut on window -> reduce
SPAN_SPEC = "chip_smoke:build_job"
SPAN_EPOCHS = 8
SPAN_COMPLETE_EVERY = 2
#: b's status line "epoch": 6 follows the fence of epoch 5, whose
#: checkpoint stays pending (5 % 2 == 1): the mirror then holds one epoch
#: past the last completed checkpoint (epoch 4), so the rebuild replays
#: an epoch. b is stopped and checked before the kill
#: (``_kill_covered``): a later line is taken if the mirror missed this one
SPAN_KILL_AT = 6
#: records the downstream pulls a step: at most half of what the window
#: exports a step (a CPU rehearsal of the upstream slice: 2,991 records
#: in epoch 0 and 3,988 in epoch 1, 2.9-3.9 a step; checked on the card)
SPAN_FEED_BATCH = 1
SPAN_EPOCH_SLEEP = 0.5
SLOT_HB_TIMEOUT_S = 2.0
SLOT_HB_INTERVAL_S = 0.3
#: (b) three tenants of the wordcount job over one pool (the reference
#: test's runner settings, targets and pacing)
MT_SPEC = "clonos_tpu_torch.examples.wordcount:build_job"
MT_RUNNER_KW = dict(steps_per_epoch=4, log_capacity=512, max_epochs=64,
                    inflight_ring_steps=64, seed=7, logical_time=True)
MT_TARGETS = {"red-001": 20, "blue-002": 20, "green-003": 30}
MT_EPOCH_SLEEP = 0.25

PHASE13_REDUCTIONS = (
    f"(a) the headline job at full width across two `python -m "
    f"clonos_tpu_torch slotworker` processes ([source, window] | [reduce, "
    f"sink], cut on the window -> reduce HASH edge) with the headline's "
    f"cuts (logical_time=True, window_size={WINDOW_SIZE}, "
    f"steps_per_epoch={STEPS_PER_EPOCH}, block_steps={BLOCK_STEPS}); "
    f"feed_batch={SPAN_FEED_BATCH} (the downstream pulls at most half the "
    f"window's exports a step); {SPAN_EPOCHS} epochs, complete_every="
    f"{SPAN_COMPLETE_EVERY}, the downstream worker killed after its "
    f"epoch-{SPAN_KILL_AT} line; epoch sleep {SPAN_EPOCH_SLEEP} s, "
    f"heartbeat {SLOT_HB_INTERVAL_S} s / timeout {SLOT_HB_TIMEOUT_S} s. "
    f"(b) tests/test_multitenant.py on the card: the wordcount job at its "
    f"published widths (4 sources x 64 -> keyBy -> 4 windows over 1,000 "
    f"keys -> 4 sinks) for three tenants, steps_per_epoch=4, targets "
    f"20/20/30 epochs, epoch sleep {MT_EPOCH_SLEEP} s; cut: depth")


def _slotworker(jm_address, eid, slots, lease, epoch_sleep, trace_dir=None,
                timeline_dir=None):
    """Start ``python -m clonos_tpu_torch slotworker`` on this script's
    device; returns (process, queue of its stdout lines). Its standard
    error goes to ``<lease>.<eid>.stderr`` (``_worker_errors`` prints its
    tail when a phase fails)."""
    import queue
    import threading
    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-X", "faulthandler", "-m", "clonos_tpu_torch",
           "slotworker", "--jm", f"127.0.0.1:{jm_address[1]}",
           "--executor-id", eid,
           "--slots", str(slots), "--lease", lease,
           "--heartbeat-interval", str(SLOT_HB_INTERVAL_S),
           "--max-seconds", "400", "--epoch-sleep", str(epoch_sleep),
           "--device", DEVICE]
    if trace_dir is not None:
        cmd += ["--trace-dir", trace_dir]
    if timeline_dir is not None:
        cmd += ["--timeline-dir", timeline_dir]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with open(f"{lease}.{eid}.stderr", "w") as err:
        proc = subprocess.Popen(cmd, cwd=repo, env=env,
                                stdout=subprocess.PIPE, stderr=err,
                                text=True)
    lines = queue.Queue()
    threading.Thread(target=_pump, args=(proc.stdout, lines),
                     daemon=True).start()
    return proc, lines


def _worker_errors(lease, procs):
    """Print each worker's exit code and the tail of its standard error
    (called when a phase-13 part fails). A worker still running is sent
    SIGABRT first, so its fault handler dumps every thread's stack."""
    import signal
    for p in procs.values():
        if p.poll() is None:
            p.send_signal(signal.SIGABRT)
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
    for eid, p in procs.items():
        path = f"{lease}.{eid}.stderr"
        tail = ""
        if os.path.exists(path):
            with open(path) as f:
                tail = f.read()[-6000:]
        log(f"[slots] worker {eid} exit {p.poll()}; stderr tail:\n{tail}")


def _status(lines, timeout=240):
    """The next JSON status line of a worker (None once it has exited)."""
    while True:
        line = lines.get(timeout=timeout)
        if line is None:
            return None
        try:
            return json.loads(line)
        except ValueError:
            continue


def _until(lines, want, what, timeout=240, seen=None):
    """Read a worker's status lines until ``want(st)``; every fence line
    read on the way is appended to ``seen``."""
    deadline = time.monotonic() + timeout
    while True:
        st = _status(lines, max(1.0, deadline - time.monotonic()))
        if st is None:
            raise AssertionError(f"{what}: the worker exited")
        if seen is not None and "group" in st and "digest" in st:
            seen.append(st)
        if want(st):
            return st
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: timed out")


def _registered(jm, eids, timeout=120):
    deadline = time.monotonic() + timeout
    while set(eids) - set(jm.registered()):
        if time.monotonic() > deadline:
            raise AssertionError(f"workers {eids} never registered")
        time.sleep(0.05)
    for eid in eids:
        dev = jm.info(eid).get("device", "")
        if dev.split(":")[0] != torch.device(DEVICE).type:
            raise AssertionError(f"worker {eid} registered device {dev!r}")


def _span_ms(trace_path, name):
    """Durations (ms) of the spans called ``name`` in a worker's trace,
    with their args."""
    out = []
    with open(trace_path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("name") == name and rec.get("ph") == "X":
                out.append((rec["dur"] * 1e3, rec.get("args", {})))
    return out


def _mirror_covers(mirror, ckdir, step, spe):
    """Do the mirror's rows run from the newest completed checkpoint's
    fence (its log head) in ``ckdir`` to global step ``step``? Phase 13
    kills only then, as it did before ``bootstrap_standby`` chose the
    checkpoint the rows start at (phase 14 (b) kills on sight)."""
    from clonos_tpu_torch.causal import determinant as det
    from clonos_tpu_torch.runtime.checkpoint import FileCheckpointStorage
    storage = FileCheckpointStorage(ckdir)
    done = storage.completed_ids()
    if not done:
        return False
    heads = np.asarray(storage.read(max(done)).carry.log_heads)
    rows, start = mirror.rows_with_start(0)
    fence = (max(done) + 1) * spe
    return (start == int(heads[0]) and fence + len(
        det.sync_anchors(np.asarray(rows, np.int32))) == step)


def _kill_covered(proc, sync, seen_lines, covered):
    """SIGKILL a worker at a moment its rebuild can reproduce: sync the
    mirrors (after the endpoint refresh that follows a status line),
    SIGSTOP the worker, let the lines it printed arrive
    (``seen_lines()``), and kill only if ``covered(lines)`` holds; else
    SIGCONT it and return None, to be tried again at a later line.
    Returns the lines seen."""
    import signal
    time.sleep(0.05)
    sync()
    proc.send_signal(signal.SIGSTOP)
    time.sleep(0.2)
    lines = seen_lines()
    if covered(lines):
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
        return lines
    proc.send_signal(signal.SIGCONT)
    return None


def _edge_records(address):
    from clonos_tpu_torch.parallel import transport as tp
    cl = tp.ControlClient(address)
    try:
        rt, resp = cl.call(tp.FETCH_EDGE, tp.pack_json(
            {"edge": 1, "start": 0, "count": 1 << 30}))
    finally:
        cl.close()
    if rt != tp.EDGE_DATA:
        raise AssertionError(f"FETCH_EDGE answered {rt}")
    hlen = int.from_bytes(resp[:4], "little")
    hdr = tp.unpack_json(resp[4: 4 + hlen])
    return hdr, np.frombuffer(resp[4 + hlen:], np.int32).reshape(-1, 2)


def _epochs_of(runner, n, complete_every):
    out = {}
    for _ in range(n):
        closed = runner.executor.epoch_id
        runner.run_epoch(complete_checkpoint=(closed % complete_every == 0))
        out[runner.global_step] = runner.state_digest()
    return out


def _upstream_probe(job, kw):
    """The upstream slice ([source, window] + its export) in this process
    on the card for the whole run: each fence's publish timed, with its
    synchronising calls counted on this thread, and the stream it
    exports (the one worker a must export too)."""
    from clonos_tpu_torch.runtime import scheduler as sch
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    sub, _vmap, _feeds, exports = job.subgraph([0, 1],
                                               feed_batch_size=SPAN_FEED_BATCH)
    runner = ClusterRunner(sub, device=DEVICE, **kw)
    export = sch.EdgeExportServer(runner, exports)
    publish = export.publish
    fences = []

    def timed():
        t0 = time.monotonic()
        _, syncs = _sync_count(publish, this_thread=True)
        fences.append(((time.monotonic() - t0) * 1e3, syncs))
    export.publish = timed
    per_epoch = []
    try:
        for _ in range(SPAN_EPOCHS):
            before = export.exported()[1]
            closed = runner.executor.epoch_id
            runner.run_epoch(
                complete_checkpoint=(closed % SPAN_COMPLETE_EVERY == 0))
            per_epoch.append(export.exported()[1] - before)
        export.mark_final()
        _hdr, recs = _edge_records(export.address)
    finally:
        export.close()
    return {"records_per_epoch": per_epoch, "records": recs,
            "publish_ms": [round(f[0], 3) for f in fences],
            "publish_syncs": [f[1] for f in fences]}


def phase_spanning(dev_line, root):
    """(a) One job across two slot-worker processes on the card: the
    headline job cut on its window -> reduce edge, deployed by a
    ``SlotPoolScheduler`` in this process onto workers ``a`` and ``b``;
    ``b`` is SIGKILLed after its epoch-6 fence (or the first later one
    its mirror covers) and only its group is rebuilt, on ``a``. Every
    fence digest of ``b`` before the kill and of ``a`` after the rebuild
    equals an in-process control on the card (the same slice over the
    exported records through ``ListFeedReader``). Returns the control's
    kernel launches."""
    from clonos_tpu_torch.api.feeds import ListFeedReader
    from clonos_tpu_torch.runtime import scheduler as sch
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    from clonos_tpu_torch.runtime.leader import FileLeaderElection
    from clonos_tpu_torch.runtime.remote import JobMasterServer
    t_phase = time.monotonic()
    job = sch._load_job(SPAN_SPEC)
    kw = runner_kw()
    spe = kw["steps_per_epoch"]
    parts = sch.partition_vertices(job, 2)
    if parts != [[0, 1], [2, 3]] or sch.cut_edges(job, parts[1])[0] != [1]:
        raise AssertionError(f"(a) the two-worker cut is {parts}")
    probe = _upstream_probe(job, kw)
    steady = min(probe["records_per_epoch"])
    if 2 * SPAN_FEED_BATCH * spe > steady:
        raise AssertionError(
            f"(a) feed_batch {SPAN_FEED_BATCH} pulls more than half of the "
            f"window's {probe['records_per_epoch']} records an epoch")
    if torch.device(DEVICE).type == "cuda" \
            and set(probe["publish_syncs"]) != {0}:
        raise AssertionError(f"(a) publish made {probe['publish_syncs']} "
                             f"synchronising calls")
    lease = os.path.join(root, "span.lease")
    trace_dir = os.path.join(root, "span-traces")
    jm = JobMasterServer(heartbeat_timeout_s=SLOT_HB_TIMEOUT_S)
    election = FileLeaderElection(lease, "jm-0", lease_ttl_s=600.0)
    if not election.try_acquire():
        raise AssertionError("(a) the lease was not granted")
    sched = sch.SlotPoolScheduler(
        jm, election, SPAN_SPEC, runner_kw=kw, feed_batch=SPAN_FEED_BATCH,
        target_epochs=SPAN_EPOCHS, complete_every=SPAN_COMPLETE_EVERY,
        checkpoint_root=os.path.join(root, "span-ck"),
        deploy_timeout_s=240.0, device=DEVICE)
    (pa, qa) = _slotworker(jm.address, "a", 2, lease, SPAN_EPOCH_SLEEP,
                           trace_dir=trace_dir)
    (pb, qb) = _slotworker(jm.address, "b", 2, lease, SPAN_EPOCH_SLEEP)
    seen_a, seen_b = [], []
    try:
        _registered(jm, ["a", "b"])
        t0 = time.monotonic()
        placements = sched.deploy()
        deploy_s = time.monotonic() - t0
        if placements != {0: "a", 1: "b"} \
                or sched.standby != {0: "b", 1: "a"}:
            raise AssertionError(f"(a) placements {placements}, standby "
                                 f"{sched.standby}")
        da = _until(qa, lambda st: st.get("deployed") == 0, "(a) deploy a")
        db = _until(qb, lambda st: st.get("deployed") == 1, "(a) deploy b")
        if da["vertices"] != [0, 1] or db["vertices"] != [2, 3]:
            raise AssertionError(f"(a) slices {da}, {db}")

        def at_fence(st):
            if "group" in st:
                sched.sync()
            return st.get("epoch", -1) >= SPAN_KILL_AT or "finished" in st

        def drained():
            while not qb.empty():
                st = _status(qb, 1)
                if st is not None and "group" in st and "digest" in st:
                    seen_b.append(st)
            return seen_b
        ckdir = os.path.join(root, "span-ck", "g1")
        while True:
            last = _until(qb, at_fence, "(a) b's fences", seen=seen_b)
            if "finished" in last:
                raise AssertionError("(a) b finished before the kill")
            if _kill_covered(pb, sched.sync, drained, lambda ls: _mirror_covers(
                    sched.mirrors[1], ckdir, ls[-1]["global_step"], spe)):
                break
        t_kill = time.monotonic()
        kill_step = seen_b[-1]["global_step"]
        while (st := _status(qb, 60)) is not None:
            if "group" in st and "digest" in st:
                seen_b.append(st)
        while "b" not in sched.failed_workers():
            if time.monotonic() > t_kill + 4 * SLOT_HB_TIMEOUT_S + 10:
                raise AssertionError("(a) heartbeat expiry not seen")
            time.sleep(0.02)
        detect_ms = (time.monotonic() - t_kill) * 1e3
        try:
            sched._send_deploy("a", {"group": 1,
                                     "fencing_epoch": election.epoch - 1})
            raise AssertionError("(a) a deposed token's DEPLOY was accepted")
        except RuntimeError as e:
            if "stale fencing" not in str(e) and "lease claim" not in str(e):
                raise
        t0 = time.monotonic()
        moved = sched.recover_worker("b")
        redeploy_ms = (time.monotonic() - t0) * 1e3
        if moved != {1: "a"} or sched.placements != {0: "a", 1: "a"}:
            raise AssertionError(f"(a) recovery moved {moved}")
        digests_b = {s["global_step"]: s["digest"] for s in seen_b}
        dep = _until(qa, lambda st: st.get("deployed") == 1, "(a) rebuild",
                     seen=seen_a)
        if not dep["recovered"] or dep["vertices"] != [2, 3] \
                or dep["global_step"] != kill_step \
                or dep["digest"] != digests_b[dep["global_step"]]:
            raise AssertionError(f"(a) the rebuild {dep} differs from the "
                                 f"dead worker's fence")
        fin = _until(qa, lambda st: st.get("finished") == 1,
                     "(a) rebuilt slice", seen=seen_a)
        if fin["global_step"] != SPAN_EPOCHS * spe:
            raise AssertionError(f"(a) the rebuilt slice ended at {fin}")
        hdr, recs = _edge_records(sched._export_addr[1])
        if not hdr["final"] or not np.array_equal(recs, probe["records"]):
            raise AssertionError(
                f"(a) worker a exported {recs.shape[0]} records, this "
                f"process {probe['records'].shape[0]}: the streams differ")
        sub, _v, feeds, _e = job.subgraph(parts[1],
                                          feed_batch_size=SPAN_FEED_BATCH)

        def control():
            ctrl = ClusterRunner(sub, device=DEVICE, **kw)
            ctrl.executor.register_feed(feeds[1],
                                        ListFeedReader([recs.tolist()]))
            return _epochs_of(ctrl, SPAN_EPOCHS, SPAN_COMPLETE_EVERY)
        ctrl_digests, launches, _ = _counted(control)
        if _hist_silent(launches):
            raise AssertionError(f"(a) control launches {launches}")
        fences_a = [s for s in seen_a if s.get("group") == 1]
        for s in seen_b + fences_a + [dep]:
            if s["digest"] != ctrl_digests.get(s["global_step"]):
                raise AssertionError(
                    f"(a) fence {s['global_step']} diverges from the "
                    f"no-failure control")
        rebuild = _span_ms(os.path.join(trace_dir, "trace-a.jsonl"),
                           "recovery.rebuild")
    except BaseException:
        _worker_errors(lease, {"a": pa, "b": pb})
        raise
    finally:
        for p in (pa, pb):
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
        sched.close()
        jm.close()
    up_lines = [s for s in seen_a if s.get("group") == 0] or [
        {"publish_ms": 0.0, "publishes": 0}]
    blocked = [s["blocked_ms"] for s in seen_b]
    fence_gs = sorted(digests_b)
    kill_epoch = kill_step // spe
    completed = max(e for e in range(kill_epoch)
                    if e % SPAN_COMPLETE_EVERY == 0)
    log("[spanning] headline job on two slot workers, b killed, group 1 "
        "rebuilt on a, every digest equal: " + json.dumps({
            "device": dev_line,
            "deploy_ms_per_group": [round(v, 3) for v in
                                    list(sched._m_deploy_ms._buf)[:2]],
            "deploy_s": round(deploy_s, 3),
            "feed_batch": SPAN_FEED_BATCH,
            "edge_records_per_epoch": probe["records_per_epoch"],
            "edge_bytes_per_epoch": [8 * n for n in
                                     probe["records_per_epoch"]],
            "publish_ms_per_fence": probe["publish_ms"],
            "publish_syncs_per_fence": probe["publish_syncs"],
            "worker_publish_ms_per_fence": round(
                up_lines[-1]["publish_ms"]
                / max(1, up_lines[-1]["publishes"]), 3),
            "blocked_read_ms_per_epoch": [
                round(b - a, 3) for a, b in zip([0.0] + blocked, blocked)],
            "fences_before_kill": fence_gs,
            "detect_ms": round(detect_ms, 3),
            "determinant_fetch_ms": round(sched._m_fetch_ms.mean, 3),
            "redeploy_ms": round(redeploy_ms, 3),
            "rebuild_ms": [round(r[0], 3) for r in rebuild],
            "killed_after_epoch": kill_epoch,
            "rebuilt_at_step": dep["global_step"],
            "steps_replayed": dep["global_step"] - (completed + 1) * spe,
            "control_launches": launches,
            "phase_seconds": round(time.monotonic() - t_phase, 3)}))
    return launches


def phase_multitenant(dev_line, root):
    """(b) Three tenants over one slot pool on the card
    (tests/test_multitenant.py): an embedded ``Dispatcher``, slot workers
    ``a`` (4 slots) and ``b`` (2 slots); red submitted by ``python -m
    clonos_tpu_torch submit``, blue and green through the API, listed by
    ``jobs --json``; ``b`` SIGKILLed once red and blue pass epoch 5; red
    and blue rebuilt on ``a`` independently, green untouched and fencing
    through the storm within its gap bound; every digest equal to one
    in-process control on the card. Returns the control's launches."""
    import threading
    from clonos_tpu_torch.obs import configure_audit, reset_audit
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    from clonos_tpu_torch.runtime.dispatcher import Dispatcher
    from clonos_tpu_torch.runtime.scheduler import _load_job
    t_phase = time.monotonic()
    repo = os.path.dirname(os.path.abspath(__file__))
    lease = os.path.join(root, "mt.lease")
    ckroot = os.path.join(root, "mt-ck")
    tracedir = os.path.join(root, "mt-traces")
    wtrace = os.path.join(root, "mt-worker-traces")
    configure_audit(on_divergence="warn")
    disp = Dispatcher(lease_path=lease, checkpoint_root=ckroot,
                      runner_kw=MT_RUNNER_KW, target_epochs=8,
                      complete_every=2, deploy_timeout_s=240.0,
                      trace_dir=tracedir,
                      heartbeat_timeout_s=SLOT_HB_TIMEOUT_S, device=DEVICE)
    pa, qa = _slotworker(disp.jm.address, "a", 4, lease, MT_EPOCH_SLEEP,
                         trace_dir=wtrace)
    pb, qb = _slotworker(disp.jm.address, "b", 2, lease, MT_EPOCH_SLEEP)
    lk = threading.Lock()
    ev_a, ev_b = [], []

    def collect(q, out):
        while (line := q.get()) is not None:
            try:
                st = json.loads(line)
            except ValueError:
                continue
            with lk:
                out.append((time.monotonic(), st))
    ta = threading.Thread(target=collect, args=(qa, ev_a), daemon=True)
    tb = threading.Thread(target=collect, args=(qb, ev_b), daemon=True)
    ta.start()
    tb.start()

    def pump(pred, deadline_s, what):
        deadline = time.monotonic() + deadline_s
        while True:
            disp.step()
            with lk:
                ea, eb = list(ev_a), list(ev_b)
            got = pred(ea, eb)
            if got:
                return got
            if time.monotonic() > deadline:
                raise AssertionError(f"(b) timeout: {what}")
            time.sleep(0.02)

    def fences(events, jid):
        return [(t, s) for t, s in events
                if s.get("job") == jid and "group" in s and "digest" in s]

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cli = [sys.executable, "-m", "clonos_tpu_torch"]
    daddr = f"127.0.0.1:{disp.address[1]}"
    jobs_proc = None
    try:
        _registered(disp.jm, ["a", "b"])
        sub = subprocess.run(
            cli + ["submit", MT_SPEC, "--dispatcher", daddr, "--tenant",
                   "red", "--slots", "1", "--workers", "b",
                   "--target-epochs", str(MT_TARGETS["red-001"])],
            cwd=repo, env=env, capture_output=True, text=True, timeout=120)
        if sub.returncode != 0 or json.loads(sub.stdout) != {
                "job_id": "red-001", "state": "ADMITTED"}:
            raise AssertionError(f"(b) submit: {sub.stdout} {sub.stderr}")
        ry = disp.submit_job(MT_SPEC, {"tenant": "blue", "slots": 1,
                                       "workers": ["b"]},
                             target_epochs=MT_TARGETS["blue-002"])
        rz = disp.submit_job(MT_SPEC, {"tenant": "green", "slots": 1,
                                       "workers": ["a"]},
                             target_epochs=MT_TARGETS["green-003"])
        if (ry["job_id"], rz["job_id"]) != ("blue-002", "green-003"):
            raise AssertionError(f"(b) job ids {ry} {rz}")
        jobs_proc = subprocess.Popen(
            cli + ["jobs", "--dispatcher", daddr, "--json"], cwd=repo,
            env=env, stdout=subprocess.PIPE, text=True)

        def deployed(ea, eb):
            got = {s.get("job"): s for _, s in ea + eb
                   if s.get("deployed") == 0}
            return got if set(MT_TARGETS) <= set(got) else None
        dep0 = pump(deployed, 240, "initial deploys")
        if any(d["vertices"] != [0, 1, 2] or d["recovered"]
               for d in dep0.values()) \
                or disp.pool.placements() != {
                    ("red-001", 0): "b", ("blue-002", 0): "b",
                    ("green-003", 0): "a"}:
            raise AssertionError(f"(b) placements {disp.pool.placements()}")

        def ripe(ea, eb):
            ex, ey = fences(eb, "red-001"), fences(eb, "blue-002")
            return (ex and ey and len(fences(ea, "green-003")) >= 4
                    and max(s["epoch"] for _, s in ex) >= 5
                    and max(s["epoch"] for _, s in ey) >= 5)

        def seen_b():
            with lk:
                return list(ev_b)

        def covered(eb):
            return all(_mirror_covers(
                disp._jobs[jid].scheduler.mirrors[0],
                os.path.join(ckroot, jid, "g0"),
                max(s["global_step"] for _, s in fences(eb, jid)),
                MT_RUNNER_KW["steps_per_epoch"])
                for jid in ("red-001", "blue-002"))
        while True:
            pump(ripe, 240, "pre-kill epochs")
            killed = _kill_covered(pb, disp.step, seen_b, covered)
            if killed is not None:
                break
        t_kill = time.monotonic()
        tb.join(timeout=60)
        with lk:
            eb = list(ev_b)
        if len(eb) != len(killed) or any("finished" in s for _, s in eb):
            raise AssertionError("(b) b went on past the moment it was "
                                 "killed at")
        digests_b = {jid: {s["global_step"]: s["digest"]
                           for _, s in fences(eb, jid)}
                     for jid in ("red-001", "blue-002")}

        def recovered(ea, eb):
            out = {s.get("job"): s for _, s in ea
                   if s.get("deployed") == 0 and s.get("recovered")}
            return out if {"red-001", "blue-002"} <= set(out) else None
        rec = pump(recovered, 240, "independent recoveries")
        t_rec = time.monotonic()
        for jid in ("red-001", "blue-002"):
            d = rec[jid]
            if d["global_step"] not in digests_b[jid] \
                    or d["digest"] != digests_b[jid][d["global_step"]]:
                raise AssertionError(f"(b) {jid} rebuilt to {d}; b reported "
                                     f"{sorted(digests_b[jid])}")
        with lk:
            ea = list(ev_a)
        dz = [s for _, s in ea if s.get("deployed") == 0
              and s.get("job") == "green-003"]
        idx = sorted(i for i, (_, s) in enumerate(ea)
                     if s.get("deployed") == 0 and s.get("recovered"))
        if len(dz) != 1 or dz[0]["recovered"] or len(idx) != 2 \
                or not any(s.get("job") == "green-003" and "group" in s
                           for _, s in ea[idx[0] + 1:idx[1]]):
            raise AssertionError("(b) green was redeployed, or no green "
                                 "fence fell between the two rebuilds")
        tz = [t for t, _ in fences(ea, "green-003")]
        pre = [t for t in tz if t <= t_kill]
        gaps = sorted(b - a for a, b in zip(pre, pre[1:]))
        median = gaps[len(gaps) // 2]
        storm = [pre[-1]] + [t for t in tz if t_kill < t <= t_rec]
        max_gap = max(b - a for a, b in zip(storm, storm[1:]))
        bound = max(30.0, 25 * median)
        if len(storm) < 2 or max_gap > bound:
            raise AssertionError(f"(b) green's fence gap {max_gap:.3f} s "
                                 f"against its bound {bound:.3f} s")

        def all_done(ea, eb):
            states = {j["job_id"]: j["state"] for j in disp.jobs()}
            return states if set(states.values()) == {"FINISHED"} else None
        pump(all_done, 300, "jobs running to completion")

        def finished(ea, eb):   # a worker reports FINISHED, then prints
            fins = {s["job"]: s for _, s in ea if "finished" in s}
            return fins if set(MT_TARGETS) <= set(fins) else None
        pump(finished, 60, "the finished lines")
        # The listing was taken while the jobs ran (never waited on
        # before the kill: the tenants on b would run on meanwhile).
        listed = json.loads(jobs_proc.communicate(timeout=120)[0])
        if sorted(j["job_id"] for j in listed["jobs"]) != sorted(MT_TARGETS):
            raise AssertionError(f"(b) jobs --json listed {listed}")
        with lk:
            ea = list(ev_a)
        fins = {s["job"]: s for _, s in ea if "finished" in s}
        spe = MT_RUNNER_KW["steps_per_epoch"]
        if any(fins[j]["global_step"] != n * spe
               for j, n in MT_TARGETS.items()):
            raise AssertionError(f"(b) targets: {fins}")
        job = _load_job(MT_SPEC)
        sub, _v, _f, _e = job.subgraph([0, 1, 2], feed_batch_size=8)

        def control():
            ctrl = ClusterRunner(sub, device=DEVICE, **MT_RUNNER_KW)
            return _epochs_of(ctrl, max(MT_TARGETS.values()), 2)
        ctrl_digests, launches, _ = _counted(control)
        if _hist_silent(launches):
            raise AssertionError(f"(b) control launches {launches}")
        for jid in MT_TARGETS:
            for events in (ea, eb):
                for _, s in fences(events, jid):
                    if s["digest"] != ctrl_digests[s["global_step"]]:
                        raise AssertionError(
                            f"(b) {jid} fence {s['global_step']} diverges")
            if not os.path.exists(os.path.join(ckroot, jid, "g0",
                                               "ledger.jsonl")):
                raise AssertionError(f"(b) no ledger under {jid}/g0")
            path = os.path.join(tracedir, f"trace-jm.{jid}.jsonl")
            with open(path) as f:
                recs = [json.loads(ln) for ln in f if ln.strip()]
            stormy = jid != "green-003"
            if not recs or any(not r["trace"].startswith(f"{jid}:")
                               for r in recs) \
                    or ("recovery.redeploy" in {r["name"] for r in recs}) \
                    != stormy:
                raise AssertionError(f"(b) {jid}'s trace file")
        m = disp.metrics_extra()
        for jid in MT_TARGETS:
            if m.get(f"cluster.job.{jid}.audit.exactly-once-ok") != 1:
                raise AssertionError(f"(b) {jid} exactly-once: {m}")
        for tenant in ("red", "blue", "green"):
            if m[f"tenant.{tenant}.slots-held"] != 0:
                raise AssertionError(f"(b) {tenant} still holds slots")
        if m["dispatcher.queue-depth"] != 0 \
                or m["dispatcher.jobs-total"] != 3:
            raise AssertionError(f"(b) dispatcher gauges {m}")
        rebuilds = [(a.get("job"), round(ms, 3)) for ms, a in _span_ms(
            os.path.join(wtrace, "trace-a.jsonl"), "recovery.rebuild")]
    except BaseException:
        log(f"[slots] (b) jobs: {json.dumps(disp.jobs())}")
        _worker_errors(lease, {"a": pa, "b": pb})
        raise
    finally:
        if jobs_proc is not None and jobs_proc.poll() is None:
            jobs_proc.kill()
        for p in (pa, pb):
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
        disp.close()
        reset_audit()
    log("[multitenant] three tenants, b killed, red and blue rebuilt on a, "
        "green untouched, every digest equal: " + json.dumps({
            "device": dev_line,
            "green_gap_median_s": round(median, 3),
            "green_gap_max_s": round(max_gap, 3),
            "green_gap_bound_s": round(bound, 3),
            "green_gap_ratio": round(max_gap / median, 3),
            "rebuild_ms": rebuilds,
            "detect_to_rebuilt_s": round(t_rec - t_kill, 3),
            "control_launches": launches,
            "phase_seconds": round(time.monotonic() - t_phase, 3)}))
    return launches


# --- phase 14 ---------------------------------------------------------------

#: (a) the planes' cost: phase 7's pipelined runner at the headline's
#: widths, a warm-up epoch and PLANES_EPOCHS timed ones per turn, the
#: round of turns PLANES_ROUNDS times over. The audit is on except in
#: the "bare" and "lineage" turns: lineage's window is then captured for
#: the lineage scan alone, and "bare" (every plane and the audit off) is
#: its baseline; "timeline" and "all" read against "off"
PLANES_EPOCHS = 8
PLANES_TURNS = ("off", "timeline", "bare", "lineage", "all")
PLANES_ROUNDS = 3
PLANES_BASELINE = {"timeline": "off", "lineage": "bare", "all": "off"}
PLANES_DYE_K = 4
#: (b) phase 11's worker with the planes on, killed on sight after this
#: status line (phase 11 kills after line 26, where its mirror covers)
PLANES_KILL_AT = 8
PLANES_RUN_ON = 3
#: (b) a beat this far behind the freshest peer's is suspect; two
#: scores in a row make a suspect (five heartbeat intervals)
PLANES_HB_HIGH_MS = 5 * HB_INTERVAL_S * 1e3
#: (c) the spanned job's depth (phase 13: 8 epochs and a kill)
PLANES_SPAN_EPOCHS = 3
PLANES_SPAN_SLEEP = 0.1

PHASE14_REDUCTIONS = (
    f"(a) phase 7's pipelined runner at the headline's widths (phase 4's "
    f"cuts), 1 warm-up + {PLANES_EPOCHS} timed epochs a turn, turns "
    f"{'/'.join(PLANES_TURNS)} x {PLANES_ROUNDS} rounds, dye "
    f"k={PLANES_DYE_K}. (b) phase 11 (b)'s "
    f"worker (steps_per_epoch={WC_SPE}, --complete-every "
    f"{WC_COMPLETE_EVERY}, --seed {WC_SEED}) on examples/wordcount.py "
    f"build_txn_job (build_job with a transactional sink backed by part "
    f"files) with --timeline-dir, --lineage-dir, --sink-dir and "
    f"--logical-time (phase 11: wall time), and a never-failed control "
    f"over the same epochs; cut: "
    f"depth, killed on sight after status line {PLANES_KILL_AT} (phase "
    f"11: line {WC_KILL_AT}, at a fence its mirror covers), "
    f"{PLANES_RUN_ON} epochs run on after the rebuild. (c) phase 13 (a)'s "
    f"spanned headline job with the HLC plane on; cut: depth, "
    f"{PLANES_SPAN_EPOCHS} epochs (phase 13: {SPAN_EPOCHS}), no kill, "
    f"epoch sleep {PLANES_SPAN_SLEEP} s")


def _reset_planes():
    from clonos_tpu_torch import obs
    obs.reset_timeline()
    obs.reset_hlc()
    obs.reset_incidents()
    obs.reset_detector()
    obs.reset_lineage()


def _planes_turn(root, i, turn):
    """One turn of (a): a fresh pipelined runner with the turn's planes,
    dropped before returning. Returns the source records/s over the timed
    epochs, the capture-window syncs, ``fence.lineage-observe`` ms a
    fence, the lineage plane's counts, the state digest and the ledger
    (None with the audit off)."""
    from clonos_tpu_torch import obs
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    _reset_planes()
    plane = None
    if turn in ("timeline", "all"):
        obs.configure_timeline("runner", path=os.path.join(
            root, f"timeline-{i}.jsonl"))
    if turn == "all":
        obs.configure_incidents(os.path.join(root, f"incidents-{i}"),
                                service="runner")
    if turn in ("lineage", "all"):
        plane = obs.LineagePlane(os.path.join(root, f"lineage-{i}"),
                                 service="runner", k=PLANES_DYE_K)
    r = ClusterRunner(build_job(), device=DEVICE,
                      audit=turn not in ("bare", "lineage"),
                      latency_marker_every=64, overlap_epoch=True,
                      checkpoint_dir=os.path.join(root, f"planes-{i}"),
                      lineage=plane, **runner_kw())
    r.run_epoch(complete_checkpoint=True)
    syncs, observe = [], []
    _wrap_syncs(r, "_begin_fence_tail", syncs)
    sync()
    r0 = _source_records(r)
    t0 = time.monotonic()
    for _ in range(PLANES_EPOCHS):
        r.run_epoch(complete_checkpoint=True)
        observe.append(r.last_fence_phases.get("fence.lineage-observe"))
    r.drain_fence()
    sync()
    rate = (_source_records(r) - r0) / (time.monotonic() - t0)
    observe.append(r.last_fence_phases.get("fence.lineage-observe"))
    delattr(r, "_begin_fence_tail")
    out = dict(turn=turn, rate=rate, syncs=syncs,
               observe=[round(x, 3) for x in observe if x is not None],
               lineage=None, digest=r.state_digest(),
               ledger=(r.coordinator.storage.read_ledger()
                       if r.auditor.enabled else None))
    r.coordinator.storage._close_ledger()
    if plane is not None:
        plane.close()
        out["lineage"] = (plane.dyed, plane.observations)
    _reset_planes()
    del r
    return out


def _spread(xs):
    return dict(min=round(min(xs), 4),
                median=round(statistics.median(xs), 4),
                max=round(max(xs), 4))


def phase_planes_cost(dev_line, root):
    """(a) The planes' cost in-process: source records/s of the pipelined
    runner with every plane off (audit on, and the "bare" turn with the
    audit off too), the HLC and timeline on, lineage on (audit off) and
    all of them on, in PLANES_ROUNDS alternating rounds; each plane's
    ratio to its baseline turn of the same round, with the spread over
    rounds; 0 synchronising calls in every capture window; the state
    digests equal across turns and the ledgers of the audited turns
    equal. Returns the turns' kernel launches."""
    turns = []

    def drive():
        for rnd in range(PLANES_ROUNDS):
            for turn in PLANES_TURNS:
                turns.append(_planes_turn(root, len(turns), turn))
    _, launches, _ = _counted(drive)
    base = turns[0]
    for i, t in enumerate(turns):
        turn = t["turn"]
        if t["digest"] != base["digest"]:
            raise AssertionError(f"(a) turn {i} ({turn}): state differs")
        if t["ledger"] is not None and t["ledger"] != base["ledger"]:
            raise AssertionError(f"(a) turn {i} ({turn}): ledger differs")
        if torch.device(DEVICE).type == "cuda" and any(t["syncs"]):
            raise AssertionError(f"(a) turn {i} ({turn}): capture windows "
                                 f"synchronised: {t['syncs']} at "
                                 f"{SYNC_SITES}")
        if turn in ("lineage", "all") and (
                t["lineage"][0] == 0 or len(t["observe"])
                != PLANES_EPOCHS + 1):
            raise AssertionError(f"(a) turn {i} ({turn}): lineage "
                                 f"{t['lineage']}, observe ms "
                                 f"{t['observe']}")
    if _hist_silent(launches):
        raise AssertionError(f"(a) no kernel launch: {launches}")
    n = len(PLANES_TURNS)
    rounds = [{t["turn"]: t for t in turns[r * n:(r + 1) * n]}
              for r in range(PLANES_ROUNDS)]
    rates = {turn: [rd[turn]["rate"] for rd in rounds]
             for turn in PLANES_TURNS}
    ratios = {turn: [rd[turn]["rate"] / rd[b]["rate"] for rd in rounds]
              for turn, b in PLANES_BASELINE.items()}
    observe = {turn: [x for rd in rounds for x in rd[turn]["observe"]]
               for turn in ("lineage", "all")}
    log("[planes] (a) cost at the headline's widths, pipelined fence, "
        "digests and ledgers equal across turns: " + json.dumps(dict(
            turns=list(PLANES_TURNS), rounds=PLANES_ROUNDS,
            timed_epochs=PLANES_EPOCHS,
            source_records_per_s={k: [round(x, 1) for x in v]
                                   for k, v in rates.items()},
            ratio_to_baseline={k: dict(baseline=PLANES_BASELINE[k],
                                       per_round=[round(x, 4) for x in v],
                                       **_spread(v))
                               for k, v in ratios.items()},
            off_over_bare=_spread([a / b for a, b in
                                   zip(rates["off"], rates["bare"])]),
            capture_window_syncs=sorted({s for t in turns
                                         for s in t["syncs"]}),
            fence_lineage_observe_ms={k: dict(n=len(v), **_spread(v))
                                      for k, v in observe.items()},
            lineage_dyed_observations={
                t["turn"]: list(t["lineage"]) for t in turns[:n]
                if t["lineage"] is not None},
            ledger_epochs=len(base["ledger"]), kernel_launches=launches,
            note="reading, not a claim", device=dev_line)))
    return launches


def _cli_json(args):
    """Run ``python -m clonos_tpu_torch ARGS`` from the repo root;
    returns (exit code, the JSON object of its last output line)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run([sys.executable, "-m", "clonos_tpu_torch", *args],
                         cwd=repo, env=env, capture_output=True, text=True,
                         timeout=300)
    lines = res.stdout.strip().splitlines()
    if not lines:
        raise AssertionError(f"{args[0]}: no output (rc {res.returncode}): "
                             f"{res.stderr[-2000:]}")
    return res.returncode, json.loads(lines[-1])


def phase_planes_failover(dev_line, root):
    """(b) Phase 11's two-process host-loss failover with the timeline,
    incidents and lineage on: the merged timeline has no causality
    inversion and a send and a receive for every verb; the gray-failure
    detector, scored at every status line and every 100 ms after the
    last, calls the killed worker a suspect and an incident bundle lands
    whose ``incident explain`` names it; the rebuild equals the worker's
    reported digest; each dyed key's path joins across the two
    processes' files, and every sink part a path reaches is committed;
    each (epoch, subtask) part is final once, and the committed records
    equal a never-failed control's (worker and standby on logical time).
    Returns the rebuild's and run-on's kernel launches."""
    import queue
    import signal
    import threading
    from clonos_tpu_torch import obs
    from clonos_tpu_torch.examples import wordcount as wc
    from clonos_tpu_torch.runtime import remote
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    from clonos_tpu_torch.runtime.filesink import FileSystemSink
    repo = os.path.dirname(os.path.abspath(__file__))
    tl_dir, lin_dir, sink_dir = (os.path.join(root, d) for d in
                                 ("timelines", "lineage", "sink"))
    os.makedirs(tl_dir)
    _reset_planes()
    obs.configure_timeline("standby", path=os.path.join(
        tl_dir, "timeline-standby.jsonl"))
    mgr = obs.configure_incidents(root, service="standby")
    mgr.attach(config=lambda: {"job": "wordcount:build_txn_job",
                               "kill_at": PLANES_KILL_AT})
    det = obs.configure_detector(obs.DetectorConfig(
        hb_age_high_ms=PLANES_HB_HIGH_MS, sustain_fences=2))
    jm = remote.JobMasterServer(heartbeat_timeout_s=HB_TIMEOUT_S)
    ctl = remote.JobMasterController(jm, device=DEVICE)
    cmd = [sys.executable, "-m", "clonos_tpu_torch", "worker",
           "clonos_tpu_torch.examples.wordcount:build_txn_job",
           "--jm", f"127.0.0.1:{jm.address[1]}",
           "--checkpoint-dir", os.path.join(root, "ck"),
           "--executor-id", "worker-0", "--epochs", "64",
           "--steps-per-epoch", str(WC_SPE),
           "--complete-every", str(WC_COMPLETE_EVERY),
           "--seed", str(WC_SEED), "--heartbeat-interval", str(HB_INTERVAL_S),
           "--epoch-sleep", str(WC_EPOCH_SLEEP), "--timeline-dir", tl_dir,
           "--lineage-dir", lin_dir, "--sink-dir", sink_dir,
           "--logical-time"]
    if torch.device(DEVICE).type != "cuda":
        cmd += ["--device", DEVICE]          # a CPU rehearsal
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t_phase = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                            text=True)
    lines = queue.Queue()
    threading.Thread(target=_pump, args=(proc.stdout, lines),
                     daemon=True).start()
    scores = [0]

    def score(epoch):
        # The standby host (this process) is the freshest peer.
        ages = dict(jm.heartbeat_ages_ms(), standby=0.0)
        det.on_fence(obs.GraySnapshot.build(epoch=epoch, hb_age_ms=ages))
        scores[0] += 1

    digests, last_epoch = {}, 0
    try:
        first = json.loads(lines.get(timeout=300))
        if first.get("registered") != "worker-0" \
                or ctl.attach() != ["worker-0"]:
            raise AssertionError(f"(b) registration: {first}")
        i = 0
        while True:
            line = lines.get(timeout=120)
            if line is None:
                raise AssertionError("(b) the worker exited early")
            st = json.loads(line)
            digests[st["global_step"]] = st["digest"]
            last_epoch = st["epoch"]
            if ctl.sync()["worker-0"] < 0:
                raise AssertionError("(b) the mirror lost the worker")
            score(last_epoch)
            if det.suspects():
                raise AssertionError(f"(b) a live worker was called a "
                                     f"suspect: {det.log[-1]}")
            if i >= PLANES_KILL_AT:
                break
            i += 1
        proc.send_signal(signal.SIGKILL)
        t_kill = time.monotonic()
        proc.wait(timeout=60)
        while (line := lines.get(timeout=60)) is not None:
            st = json.loads(line)
            digests[st["global_step"]] = st["digest"]
        suspect_ms = None
        while "worker-0" not in ctl.failed() or suspect_ms is None:
            if time.monotonic() > t_kill + 4 * HB_TIMEOUT_S + 10:
                raise AssertionError(f"(b) expiry {ctl.failed()}, suspects "
                                     f"{det.suspects()}")
            time.sleep(0.1)
            score(last_epoch)
            if suspect_ms is None and "worker-0" in det.suspects():
                suspect_ms = (time.monotonic() - t_kill) * 1e3
        detect_ms = (time.monotonic() - t_kill) * 1e3
        plane = obs.LineagePlane(lin_dir, service="standby")
        (runner, report), launches, _ = _counted(
            lambda: ctl.rebuild("worker-0", wc.build_txn_job(),
                                steps_per_epoch=WC_SPE, seed=WC_SEED,
                                logical_time=True, lineage=plane))
        rebuilt_step, digest = runner.global_step, runner.state_digest()
        newest = max(set(runner.coordinator.storage.completed_ids())
                     - set(ctl.ignored_checkpoints()))
        if digests.get(rebuilt_step) != digest:
            raise AssertionError(f"(b) the rebuild at step {rebuilt_step} "
                                 f"has digest {digest}; the worker "
                                 f"reported {digests.get(rebuilt_step)}")
        (sink_vid,) = sorted(runner.txn_logs)
        part_dir = os.path.join(sink_dir, f"v{sink_vid}")
        runner.attach_file_sink(sink_vid, part_dir, token=1)

        def run_on():
            for _ in range(PLANES_RUN_ON):
                runner.run_epoch(complete_checkpoint=True)
        _, run_on_launches, _ = _counted(run_on)
        runner.coordinator.storage._close_ledger()
        plane.close()
        # A never-failed control over the same epochs: with logical time
        # the committed egress is a function of the seed.
        n_epochs = runner.executor.epoch_id
        control_dir = os.path.join(root, "sink-control")
        control = ClusterRunner(wc.build_txn_job(), steps_per_epoch=WC_SPE,
                                seed=WC_SEED, logical_time=True,
                                checkpoint_dir=os.path.join(root, "ck-ctl"),
                                device=DEVICE)
        control.attach_file_sink(sink_vid, control_dir)
        for i in range(n_epochs):
            control.run_epoch(complete_checkpoint=(
                i % WC_COMPLETE_EVERY == 0 or i == n_epochs - 1))
        control.coordinator.storage._close_ledger()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        ctl.close()
        jm.close()
        bundles = mgr.bundles()
        _reset_planes()
    launches = {k: launches[k] + run_on_launches[k] for k in launches}
    if _hist_silent(launches):
        raise AssertionError(f"(b) no kernel launch: {launches}")

    # The merged timeline, through the CLI as an operator reads it.
    files = sorted(os.path.join(tl_dir, f) for f in os.listdir(tl_dir))
    rc, rep = _cli_json(["timeline", *files, "--report", "json"])
    recs = obs.read_timeline(files)
    verbs = {}
    for r in recs:
        if r["kind"] in ("msg.send", "msg.recv"):
            verbs.setdefault(r["verb"], set()).add(r["kind"])
    if rc != 0 or not rep["ok"] or rep["inversions"] or len(files) != 2 \
            or set(verbs) != {"HEARTBEAT", "DETERMINANT_REQUEST"} \
            or any(v != {"msg.send", "msg.recv"} for v in verbs.values()):
        raise AssertionError(f"(b) merged timeline: rc {rc}, {rep}, "
                             f"verbs {verbs}")
    # The incident: one bundle, its analysis naming the killed worker.
    if len(bundles) != 1:
        raise AssertionError(f"(b) incident bundles {bundles}")
    _rc, expl = _cli_json(["incident", "explain", "--dir", root,
                           "--report", "json"])
    trig = expl["trigger"]
    named = [e for e in expl["causal_chain"]
             if e.get("kind") == "health.gray-suspect"]
    if trig.get("kind") != "health.gray-suspect" \
            or trig.get("worker") != "worker-0" \
            or [e.get("worker") for e in named] != ["worker-0"]:
        raise AssertionError(f"(b) incident explain: {expl}")
    # Lineage across the failover, against the committed part files.
    lin_files = sorted(os.path.join(lin_dir, f) for f in os.listdir(lin_dir))
    observations = obs.read_observations(lin_files)
    lrep = obs.reconstruct(observations)
    dyes = {}
    for o in observations:
        if o["kind"] == "dye":
            dyes[o["service"]] = dyes.get(o["service"], 0) + 1
    fs = FileSystemSink(part_dir)
    committed = fs.committed_epochs()
    finals = {"-".join(f.split("-")[:3]) for f in os.listdir(part_dir)
              if f.endswith(".final")}
    # Exactly once: each (epoch, subtask) part is final under one token,
    # and the committed records equal the never-failed control's.
    per_part, control_parts = {}, set()
    for f in os.listdir(part_dir):
        if f.endswith(".final"):
            key = FileSystemSink._parse(f)[:2]
            per_part[key] = per_part.get(key, 0) + 1
    for f in os.listdir(control_dir):
        if f.endswith(".final"):
            control_parts.add(FileSystemSink._parse(f)[:2])
    twice = sorted(k for k, c in per_part.items() if c > 1)
    got_recs = fs.read_committed()
    want_recs = FileSystemSink(control_dir).read_committed()
    if twice or set(per_part) != control_parts \
            or not np.array_equal(got_recs, want_recs):
        raise AssertionError(
            f"(b) exactly-once egress: parts final twice {twice}; parts "
            f"{sorted(per_part)} vs the control's {sorted(control_parts)}; "
            f"{got_recs.shape[0]} committed records vs the control's "
            f"{want_recs.shape[0]}")
    fence_epoch = report.from_epoch + report.steps_replayed // WC_SPE
    sinks = [s for p in lrep["keys"].values() for s in p["sinks"]]
    by_token = {}
    for f in os.listdir(part_dir):
        if f.endswith(".final"):
            by_token["-".join(f.split("-")[:3])] = f.split("-")[3][:2]
    sides = {"sealed_by_worker": sum(s["epoch"] < fence_epoch for s in sinks),
             "sealed_by_standby": sum(s["epoch"] >= fence_epoch
                                      for s in sinks),
             "committed_by_standby": sum(by_token.get(s["part"]) == "t1"
                                         for s in sinks)}
    no_dye = [k for k, p in lrep["keys"].items() if "no-dye" in p["broken"]]
    uncommitted = sorted({s["part"] for s in sinks} - finals)
    if len(lin_files) != 2 or set(dyes) != {"worker-0", "standby"} \
            or no_dye or uncommitted or not sinks \
            or committed != list(range(len(committed))) or not committed:
        raise AssertionError(
            f"(b) lineage: files {lin_files}, dye records {dyes}, no-dye "
            f"{no_dye}, uncommitted parts {uncommitted}, sinks {sides}, "
            f"committed epochs {committed}")
    log("[planes] (b) two-process failover with the planes on: " + json.dumps(
        dict(timeline=dict(records=rep["records"], by_kind=rep["by_kind"],
                           inversions=len(rep["inversions"]),
                           files=len(files)),
             incident=dict(bundles=len(bundles), trigger=trig,
                           verdict=expl["verdict"],
                           chain=[e["kind"] for e in expl["causal_chain"]]),
             detector=dict(scores=scores[0], suspect_ms=round(suspect_ms, 3),
                           expiry_ms=round(detect_ms, 3),
                           threshold_ms=PLANES_HB_HIGH_MS),
             rebuild=dict(global_step=rebuilt_step, digest=digest,
                          from_epoch=report.from_epoch,
                          newest_completed_checkpoint=newest,
                          steps_replayed=report.steps_replayed,
                          recovery_ms=round(report.recovery_ms, 3)),
             lineage=dict(keys=len(lrep["keys"]), dye_records=dyes,
                          sinks=sides,
                          no_terminus=len(lrep["broken_keys"]),
                          observations=lrep["observations"]),
             committed_epochs=len(committed),
             egress=dict(parts=len(per_part), records=int(got_recs.shape[0]),
                         equal_to_control=True, parts_final_twice=0),
             kernel_launches=launches,
             phase_seconds=round(time.monotonic() - t_phase, 3),
             device=dev_line)))
    return launches


def phase_planes_spanning(dev_line, root):
    """(c) Phase 13 (a)'s spanned job with the HLC plane on in this
    process (the JobMaster) and both slot workers (``--timeline-dir``):
    the merged timeline has no causality inversion, and every DEPLOY and
    FETCH_EDGE receive orders after its send."""
    from clonos_tpu_torch import obs
    from clonos_tpu_torch.runtime import scheduler as sch
    from clonos_tpu_torch.runtime.leader import FileLeaderElection
    from clonos_tpu_torch.runtime.remote import JobMasterServer
    t_phase = time.monotonic()
    tl_dir = os.path.join(root, "span-timelines")
    os.makedirs(tl_dir)
    _reset_planes()
    obs.configure_timeline("jm", path=os.path.join(tl_dir,
                                                   "timeline-jm.jsonl"))
    lease = os.path.join(root, "planes.lease")
    jm = JobMasterServer(heartbeat_timeout_s=SLOT_HB_TIMEOUT_S)
    election = FileLeaderElection(lease, "jm-0", lease_ttl_s=600.0)
    if not election.try_acquire():
        raise AssertionError("(c) the lease was not granted")
    sched = sch.SlotPoolScheduler(
        jm, election, SPAN_SPEC, runner_kw=runner_kw(),
        feed_batch=SPAN_FEED_BATCH, target_epochs=PLANES_SPAN_EPOCHS,
        complete_every=SPAN_COMPLETE_EVERY,
        checkpoint_root=os.path.join(root, "planes-ck"),
        deploy_timeout_s=240.0, device=DEVICE)
    procs = {}
    try:
        for eid in ("a", "b"):
            procs[eid] = _slotworker(jm.address, eid, 2, lease,
                                     PLANES_SPAN_SLEEP, timeline_dir=tl_dir)
        _registered(jm, ["a", "b"])
        if sched.deploy() != {0: "a", 1: "b"}:
            raise AssertionError(f"(c) placements {sched.placements}")
        for eid, g in (("a", 0), ("b", 1)):
            _until(procs[eid][1], lambda st, g=g: st.get("finished") == g,
                   f"(c) {eid} finished")
    except BaseException:
        _worker_errors(lease, {e: p for e, (p, _) in procs.items()})
        raise
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        sched.close()
        jm.close()
        _reset_planes()
    files = sorted(os.path.join(tl_dir, f) for f in os.listdir(tl_dir))
    merged = obs.merge_records(obs.read_timeline(files))
    inversions = obs.causality_inversions(merged)
    streamed = obs.causality_inversions_stream(obs.iter_merged(files))
    sends = {tuple(r["hlc"]): i for i, r in enumerate(merged)
             if r["kind"] == "msg.send"}
    counts, unordered = {}, []
    for i, r in enumerate(merged):
        if r["kind"] == "msg.recv" and r["verb"] in ("DEPLOY", "FETCH_EDGE"):
            counts[r["verb"]] = counts.get(r["verb"], 0) + 1
            if sends.get(tuple(r["sent"]), len(merged)) >= i:
                unordered.append(r)
    if inversions or streamed or unordered or len(files) != 3 \
            or counts.get("DEPLOY") != 2 or not counts.get("FETCH_EDGE"):
        raise AssertionError(f"(c) merged timeline: {len(files)} files, "
                             f"inversions {inversions or streamed}, "
                             f"receives {counts}, unordered {unordered[:3]}")
    log("[planes] (c) spanned job with the HLC on, DEPLOY and FETCH_EDGE "
        "ordered: " + json.dumps(dict(
            records=len(merged), receives=counts, inversions=0,
            seals=sum(r["kind"] == "epoch.seal" for r in merged),
            phase_seconds=round(time.monotonic() - t_phase, 3),
            device=dev_line)))


# --- phase 15 ---------------------------------------------------------------

#: the re-cut job: the headline's widths with its keyed stages at 8, 16 or
#: 4 lanes and one more hash exchange (reduce -> keyBy -> 8 sinks), so only
#: keyed vertices change parallelism (restore_rescaled refuses a FORWARD
#: edge into a rescaled vertex, and a non-keyed vertex that moves)
RESCALE_UP = 16
RESCALE_DOWN = 4
#: (b): epochs timed a side; the first epoch after the 8 -> 16 re-cut is
#: the kill epoch of the faulted twin, killed this many steps in
RESCALE_TIMED = 2
RESCALE_KILL_STEPS = 300
RESCALE_KILL = (1, 11)          # window subtask 11 of 16
RESCALE_READ_KEYS = 32
RESCALE_READ_SEED = 29
RESCALE_STALENESS_BOUND = 2
#: (d): the seeded load trace, per fence: L(ow) or H(igh); the controller
#: decides 16 -> 8 at the fifth fence, the next two hold in cooldown (the
#: high load would scale up), the eighth holds on a killed subtask
AUTOSCALE_SEED = 23
AUTOSCALE_TRACE = "LHHLLHHHL"
AUTOSCALE_KILL_AT = 7
AUTOSCALE_KILL = (2, 3)          # reduce subtask 3 of 8

PHASE15_REDUCTIONS = (
    f"the headline's widths ({PAR} sources x {BATCH} records a step -> "
    f"keyBy -> windows over {VOCAB} keys, window_size={WINDOW_SIZE} -> "
    f"keyBy(static) -> reduces -> keyBy -> {PAR} sinks; {NUM_KEY_GROUPS} "
    f"key groups, edge capacity {EDGE_CAPACITY}) with the keyed stages at "
    f"{PAR}, {RESCALE_UP} and {RESCALE_DOWN} lanes; cuts: phase 4's "
    f"(logical_time=True, steps_per_epoch={STEPS_PER_EPOCH}, "
    f"block_steps={BLOCK_STEPS}), and the reduce -> sink edge a hash "
    f"exchange at {PAR} sinks (bench: forward) so that only keyed vertices "
    f"change parallelism, as the reference's own re-cut jobs "
    f"(soak/driver.py:1214-1234, tests/test_rescale.py:33-45); "
    f"(b)-(d) on phase 7's runner (pipelined fence, audit on, checkpoints "
    f"on disk), {RESCALE_TIMED} timed epochs a side; (d) load from a "
    f"seeded trace ({AUTOSCALE_TRACE}, RandomState({AUTOSCALE_SEED})) in "
    f"place of the load-spike chaos event (not ported)")


def build_rescale_job(keyed_par):
    from clonos_tpu_torch.api.environment import StreamEnvironment
    env = StreamEnvironment(name="bench-allround-rescale",
                            num_key_groups=NUM_KEY_GROUPS,
                            default_edge_capacity=EDGE_CAPACITY)
    (env.synthetic_source(vocab=VOCAB, batch_size=BATCH, parallelism=PAR)
        .key_by()
        .window_count(num_keys=VOCAB, window_size=WINDOW_SIZE,
                      parallelism=keyed_par, name="window")
        .key_by()
        .reduce(num_keys=VOCAB, parallelism=keyed_par, name="reduce")
        .key_by()
        .sink(parallelism=PAR))
    return env.build()


def _sink_multiset(runner, epochs):
    """Run ``epochs`` completed epochs; the sink's valid records as a
    sorted ``[3, n]`` (key, value, timestamp) array."""
    vid = next(v.vertex_id for v in runner.job.vertices
               if not runner.job.out_edges(v.vertex_id))
    got = []

    def absorb(outs, _epoch):
        b = outs.sinks[vid]
        m = b.valid
        got.append(torch.stack([b.keys[m], b.values[m], b.timestamps[m]]))
    runner.executor.on_block_outputs = absorb
    try:
        for _ in range(epochs):
            runner.run_epoch(complete_checkpoint=True)
        runner.drain_fence()
    finally:
        runner.executor.on_block_outputs = None
    cat = torch.cat(got, dim=1).cpu().numpy()
    return cat[:, np.lexsort(cat[::-1])]


def _checked_hist(shapes):
    """A context that routes ``routing.keyed_hist`` through a wrapper:
    each call launches the kernel (counted as always), then its plain
    version on the same inputs (not counted), which must agree bit for
    bit; ``shapes`` collects (R, B, nk, counts, max abs err)."""
    import contextlib

    from clonos_tpu_torch.ops import histogram as hist
    from clonos_tpu_torch.parallel import routing

    @contextlib.contextmanager
    def ctx():
        real = routing.keyed_hist

        def checked(keys, vals, valid, nk, want_counts=True):
            out = real(keys, vals, valid, nk, want_counts)
            plain = hist.keyed_hist_plain(keys, vals, valid, nk, want_counts)
            err = int((out[0].to(torch.int64)
                       - plain[0].to(torch.int64)).abs().max())
            if want_counts:
                err = max(err, int((out[1].to(torch.int64)
                                    - plain[1].to(torch.int64)).abs().max()))
            shapes.append((*keys.shape, nk, want_counts, err))
            return out
        routing.keyed_hist = checked
        try:
            yield
        finally:
            routing.keyed_hist = real
    return ctx()


def _owned_only(runner, what):
    """Each keyed table of the runner holds only the keys its lane owns."""
    from clonos_tpu_torch.parallel import routing
    for v in runner.job.vertices:
        st = runner.executor.carry.op_states[v.vertex_id]
        if not isinstance(st, dict) or "acc" not in st:
            continue
        acc = st["acc"]
        kg = routing.key_group(torch.arange(acc.shape[-1], dtype=torch.int32,
                                            device=acc.device),
                               NUM_KEY_GROUPS)
        owner = routing.subtask_for_key_group(kg, v.parallelism,
                                              NUM_KEY_GROUPS)
        lane = torch.arange(v.parallelism, device=acc.device)[:, None]
        if bool(((acc != 0) & (owner[None, :] != lane)).any()):
            raise AssertionError(f"{what}: {v.name} holds keys its lanes "
                                 f"do not own")


def phase_rescale_restore(dev_line, rows):
    """(a) ``restore_rescaled`` 8 -> 16 and 8 -> 4 from a completed
    checkpoint on the card: the sink multiset over the next 2 epochs
    equals a never-rescaled control's, each table holds only its owner's
    keys, and every ``keyed_hist`` launch of the re-cut equals its plain
    version. Returns the re-cuts' kernel launches (the unchecked calls)."""
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    t0 = time.monotonic()
    kw = dict(device=DEVICE, **runner_kw())
    ctl = ClusterRunner(build_rescale_job(PAR), **kw)
    ctl.run_epoch(complete_checkpoint=True)
    ckpt = ctl.standbys.latest
    want = _sink_multiset(ctl, 2)
    del ctl
    launches = {"keyed_hist": 0, "keyed_hist_sums": 0}
    out = {}
    for p_new in (RESCALE_UP, RESCALE_DOWN):
        jobs = lambda: (build_rescale_job(p_new), build_rescale_job(PAR))
        t_m = time.monotonic()
        res, counts, syncs = _counted(
            lambda: ClusterRunner.restore_rescaled(*jobs(), ckpt, **kw),
            count_syncs=True)
        sync()
        migrate_ms = (time.monotonic() - t_m) * 1e3
        for k in launches:
            launches[k] += counts[k]
        shapes = []
        with _checked_hist(shapes):
            ClusterRunner.restore_rescaled(*jobs(), ckpt, **kw)
        bad = [s for s in shapes if s[-1] != 0]
        if bad or not shapes:
            raise AssertionError(f"(a) 8->{p_new}: re-cut kernel != plain "
                                 f"at {bad} (of {len(shapes)} launches)")
        _owned_only(res, f"(a) 8->{p_new}")
        # A planned restart starts a fresh epoch 0; the caller resumes
        # causal time at the fence (logical time reads the step count),
        # as the reference's own test resumes its clock.
        res.executor.step_input_history = [(0, 0)] * STEPS_PER_EPOCH
        got = _sink_multiset(res, 2)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(
                f"(a) 8->{p_new}: sink multiset {got.shape[1]} records != "
                f"the never-rescaled control's {want.shape[1]}")
        del res
        if torch.device(DEVICE).type == "cuda":
            torch.cuda.empty_cache()
        out[f"8->{p_new}"] = dict(
            migrate_ms=round(migrate_ms, 3), syncs=syncs,
            kernel_launches=counts,
            launch_shapes=sorted({f"R={r} B={b} nk={nk} counts={c}"
                                  for r, b, nk, c, _ in shapes}),
            sink_records=int(got.shape[1]))
    timed = {f"{r['label']} R={r['R']} B={r['B']} nk={r['nk']} "
             f"counts={r['counts']}": dict(
                 device_us=(None if r.get("device_ms") is None
                            else round(r["device_ms"] * 1e3, 3)),
                 bound_us=round(r["bound_ms"] * 1e3, 3),
                 scatter_add_events_us=round(r["library_ms"] * 1e3, 3),
                 plain_ms=round(r["plain_ms"], 4), branch=r["branch"],
                 grid=r["grid"])
             for r in (rows or []) if r["label"] in RESCALE_LABELS
             and "ms" in r}
    if _hist_silent(launches):
        raise AssertionError(f"(a) no kernel launch in the re-cuts: "
                             f"{launches}")
    log("[rescale] (a) restore_rescaled from a completed checkpoint, sink "
        "multiset over 2 epochs == never-rescaled control, tables "
        "owner-only, re-cut launches == plain: " + json.dumps(dict(
            recuts=out, kernel_shapes=timed,
            seconds=round(time.monotonic() - t0, 1), device=dev_line)))
    return launches


def _rescale_runner(root, tag, keyed_par):
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    return ClusterRunner(build_rescale_job(keyed_par),
                         **_rescale_runner_kw(root, tag))


def _rescale_runner_kw(root, tag):
    return dict(device=DEVICE, audit=True, latency_marker_every=64,
                overlap_epoch=True, checkpoint_dir=os.path.join(root, tag),
                **runner_kw())


def _timed_epochs(runner, n):
    """Source records/s over ``n`` completed epochs, drained."""
    sync()
    r0 = _source_records(runner)
    t0 = time.monotonic()
    for _ in range(n):
        runner.run_epoch(complete_checkpoint=True)
    runner.drain_fence()
    sync()
    return (_source_records(runner) - r0) / (time.monotonic() - t0)


def _recut(runner, keyed_par, root, tag):
    """``rescale_live`` to ``keyed_par`` lanes, timed (the fence stall:
    drain, migrate and the new-shape restore point) with its
    synchronising calls on this thread; the fenced-off runner must
    refuse to run."""
    from clonos_tpu_torch.causal.recovery import RecoveryError
    seen = []
    sync()
    t0 = time.monotonic()
    (new, stats), syncs = _sync_count(
        lambda: runner.rescale_live(
            build_rescale_job(keyed_par),
            observers=[lambda kind, **f: seen.append(kind)],
            **_rescale_runner_kw(root, tag)), this_thread=True)
    sync()
    stall_ms = (time.monotonic() - t0) * 1e3
    kinds = [k for k, _ in stats["transitions"]]
    order = {"fence": 0, "drain": 1, "migrate": 1, "redirect": 2}
    problems = []
    if kinds != seen or kinds[0] != "fence" or kinds[-1] != "redirect" \
            or [order[k] for k in kinds] != sorted(order[k] for k in kinds):
        problems.append(f"transitions out of protocol order: {kinds}")
    if kinds.count("migrate") != stats["groups"]:
        problems.append(f"{kinds.count('migrate')} migrates for "
                        f"{stats['groups']} groups")
    if stats["drained_records"] <= 0:
        problems.append("no in-flight record drained")
    if not stats["moved_key_groups"] or min(
            stats["moved_key_groups"].values()) <= 0:
        problems.append(f"moved key groups {stats['moved_key_groups']}")
    try:
        runner.run_epoch()
        problems.append("the fenced-off runner ran an epoch")
    except RecoveryError:
        pass
    if problems:
        raise AssertionError(f"re-cut to {keyed_par}: " + "; ".join(problems))
    reading = dict(
        stall_ms=round(stall_ms, 3), migrate_ms=round(stats["migrate_ms"], 3),
        syncs=syncs, fence_checkpoint=stats["fence_checkpoint"],
        groups=stats["groups"], drained_records=stats["drained_records"],
        moved_key_groups=stats["moved_key_groups"],
        transitions={k: kinds.count(k) for k in order})
    return new, reading


def _read_tier_reader(tier, stats, stop):
    rng = np.random.RandomState(RESCALE_READ_SEED)
    while not stop.is_set():
        keys = [int(k) for k in rng.randint(0, VOCAB, RESCALE_READ_KEYS)]
        try:
            out = tier.router.query_batch(tier.vertex_id, keys)
            if len(out["values"]) != RESCALE_READ_KEYS:
                raise AssertionError(f"{len(out['values'])} values")
            stats["reads"] += 1
            stats["staleness"].append(max(out["staleness_epochs"]))
        except Exception as e:       # a client-visible error
            stats["errors"].append(repr(e))
        stop.wait(SERVE_READ_GAP_S)


def _replica_equals_owner(tier, what):
    """After a drained fence every replica answers the owner's values,
    subtasks and epoch, fence-fresh."""
    keys = list(range(VOCAB))
    owner = tier.owner_client.query_batch(tier.vertex_id, keys)
    for i, c in enumerate(tier.clients):
        rep = c.query_batch(tier.vertex_id, keys)
        if (rep["values"], rep["subtasks"], rep["epoch"]) != (
                owner["values"], owner["subtasks"], owner["epoch"]) \
                or rep["staleness_epochs"] != 0:
            raise AssertionError(f"(c) {what}: replica {i} != owner at "
                                 f"epoch {owner['epoch']}")
    return owner


def phase_rescale_live(dev_line, root):
    """(b) ``rescale_live`` 8 -> 16 on phase 7's runner under a read tier
    (c), a faulted twin killed in the first epoch after the re-cut, then
    (d) the autoscaler deciding and executing 16 -> 8; every epoch's
    ledger equal, through the group directory, to a never-rescaled
    control's. Returns the live path's kernel launches."""
    import dataclasses
    import threading

    from clonos_tpu_torch import obs
    from clonos_tpu_torch.autoscale import (AutoscaleController, DecisionLog,
                                            PolicyConfig, ScalePolicy,
                                            SignalAggregator)
    from clonos_tpu_torch.obs import audit as audit_mod
    from clonos_tpu_torch.obs.detect import GrayFailureDetector, GraySnapshot
    from clonos_tpu_torch.obs.digest import diff_ledgers
    from clonos_tpu_torch.runtime import serve
    t_phase = time.monotonic()
    keyed = lambda r: r.job.vertices[1].parallelism
    state = {"live": _rescale_runner(root, "live", PAR)}
    ctl = _rescale_runner(root, "control", PAR)
    twin = _rescale_runner(root, "twin", PAR)
    readings = {}

    def body():
        live = state["live"]
        live.run_epoch(complete_checkpoint=True)
        readings["records_per_s_8"] = _timed_epochs(live, RESCALE_TIMED)
        for _ in range(1 + RESCALE_TIMED):
            twin.run_epoch(complete_checkpoint=True)
        # (c) the tier and its reader, through the re-cut
        tier = serve.build_serve_tier(live, _reduce_vid(live.job),
                                      n_replicas=2,
                                      staleness_bound=RESCALE_STALENESS_BOUND)
        stats = {"reads": 0, "errors": [], "staleness": []}
        stop = threading.Event()
        reader = threading.Thread(target=_read_tier_reader,
                                  args=(tier, stats, stop),
                                  name="rescale-reader", daemon=True)
        live.run_epoch(complete_checkpoint=True)
        live.drain_fence()
        reader.start()
        twin.run_epoch(complete_checkpoint=True)
        try:
            live16, readings["recut_8_to_16"] = _recut(
                live, RESCALE_UP, root, "live")
            state["live"] = live16
            reads_mid = stats["reads"]
            tier.rehome(live16)
            sync()
            t0 = time.monotonic()
            live16.run_epoch(complete_checkpoint=True)
            live16.drain_fence()
            sync()
            readings["first_epoch_after_recut_ms"] = (
                (time.monotonic() - t0) * 1e3)
        finally:
            stop.set()
            reader.join(timeout=30.0)
        # The faulted twin: re-cut at the same fence, a window subtask
        # killed RESCALE_KILL_STEPS into the first epoch at 16 lanes,
        # recovered, equal to the re-cut run that never failed.
        twin16, _ = _recut(twin, RESCALE_UP, root, "twin")
        for _ in range(RESCALE_KILL_STEPS):
            twin16.step()
        flats = [twin16.job.subtask_base(RESCALE_KILL[0]) + RESCALE_KILL[1]]
        twin16.inject_failure(flats)
        rep = twin16.recover()
        twin16.run_epoch(complete_checkpoint=True)
        twin16.drain_fence()
        _assert_same(live16, twin16, "(b) recovery at 16 lanes")
        if twin16.auditor.ledger() != live16.auditor.ledger():
            raise AssertionError("(b) the recovered twin's ledger != the "
                                 "re-cut run's")
        readings["twin_recovery"] = dict(
            flats=flats, steps_replayed=rep.steps_replayed,
            recovery_ms=round(rep.recovery_ms, 3))
        del twin16
        _replica_equals_owner(tier, "after the re-home")
        if stats["errors"] or stats["reads"] <= reads_mid:
            raise AssertionError(
                f"(c) {len(stats['errors'])} client-visible errors "
                f"{stats['errors'][:3]}, {stats['reads']} reads "
                f"({reads_mid} before the re-home)")
        if max(stats["staleness"]) > RESCALE_STALENESS_BOUND:
            raise AssertionError(f"(c) staleness {max(stats['staleness'])} "
                                 f"past the bound")
        i = tier.add_replica()
        live16.run_epoch(complete_checkpoint=True)
        live16.drain_fence()
        _replica_equals_owner(tier, f"added replica {i}")
        dropped = tier.drop_replica()
        _replica_equals_owner(tier, f"replica {dropped} dropped")
        routed = tier.router.query_batch(tier.vertex_id, list(range(VOCAB)))
        if tier.router.errors or len(routed["values"]) != VOCAB:
            raise AssertionError(f"(c) {tier.router.errors} router errors")
        readings["read_tier"] = dict(
            reader_batches=stats["reads"], client_errors=0,
            staleness_peak=max(stats["staleness"]),
            reroutes=tier.router.reroutes, replica_reads=tier.router
            .replica_reads, owner_reads=tier.router.owner_reads,
            added=i, dropped=dropped)
        readings["records_per_s_16"] = _timed_epochs(live16, RESCALE_TIMED)
        return tier

    def autoscale(tier):
        """(d) The controller at each drained fence, on the live runner and
        the tier; its worker re-cut is ``rescale_live``."""
        rng = np.random.RandomState(AUTOSCALE_SEED)
        loads = [round(float(rng.uniform(0.2, 0.5) if c == "L"
                             else rng.uniform(1.5, 2.5)), 2)
                 for c in AUTOSCALE_TRACE]
        log_path = os.path.join(root, "scale.det")
        policy = lambda: ScalePolicy(PolicyConfig(
            sustain_fences=2, cooldown_fences=3, max_step=PAR,
            min_workers=PAR, max_workers=RESCALE_UP, min_replicas=2,
            max_replicas=2))
        executed = []

        def execute(target):
            new, reading = _recut(state["live"], target, root, "live")
            state["live"] = new
            tier.rehome(new)
            executed.append(dict(target=target, **reading))
        ctl_as = AutoscaleController(
            policy(), log=DecisionLog(log_path), execute_workers=execute,
            healthy=lambda: not state["live"].failed)
        detector = GrayFailureDetector()
        agg = SignalAggregator()
        decisions, signals = [], []
        for i, load in enumerate(loads):
            live = state["live"]
            live.run_epoch(complete_checkpoint=True)
            live.drain_fence()
            epoch = live.executor.epoch_id - 1
            if i == AUTOSCALE_KILL_AT:
                live.inject_failure(
                    [live.job.subtask_base(AUTOSCALE_KILL[0])
                     + AUTOSCALE_KILL[1]])
            detector.on_fence(GraySnapshot.build(
                epoch=epoch,
                hb_age_ms={f"subtask-{s}": a
                           for s, a in live.heartbeats.ages_ms().items()},
                staleness={r.name: r.staleness_epochs()
                           for r in tier.replicas}))
            s = dataclasses.replace(agg.sample_from(
                live.metrics.snapshot(), epoch=epoch, workers=keyed(live),
                failed_subtasks=len(live.failed),
                unfenced=live.fence_tail_in_flight(),
                gray_suspects=len(detector.suspects())), load=load)
            signals.append(s)
            d, _ = ctl_as.on_fence(epoch, s)
            decisions.append(d)
            if live.failed:
                live.recover()
        return ctl_as, decisions, signals, executed, log_path, policy, loads

    def run():
        tier = body()
        try:
            obs.reset_timeline()
            tl = obs.configure_timeline("autoscale")
            try:
                out = autoscale(tier)
                marks = [r for r in tl.records()
                         if r["kind"] == "scale.decision"]
            finally:
                obs.reset_timeline()
                obs.reset_hlc()
            _replica_equals_owner(tier, "after the autoscaler's re-cut")
        finally:
            tier.close()
        return out, marks

    (out, marks), launches, _ = _counted(run)
    ctl_as, decisions, signals, executed, log_path, policy, loads = out
    live = state["live"]
    n_epochs = live.executor.epoch_id
    for _ in range(n_epochs):
        ctl.run_epoch(complete_checkpoint=True)
    ctl.drain_fence()

    problems = []
    # (b) exactly once across both re-cuts, through the group directory
    led, led_ctl = live.auditor.ledger(), ctl.auditor.ledger()
    cross = audit_mod.diff_ledgers_cross(led_ctl, led)
    if cross or len(led) != n_epochs:
        problems.append(f"(b) cross diff {cross[:3]} ({len(led)} of "
                        f"{n_epochs} epochs)")
    if not diff_ledgers(led_ctl, led):
        problems.append("(b) the exact diff is empty: the mapped path "
                        "never engaged")
    # (d) decisions
    acts = [d.action for d in decisions]
    reasons = [d.reason for d in decisions]
    scaled = [d for d in decisions if d.scales]
    if len(scaled) != 1 or len(executed) != 1 or ctl_as.rescales_executed \
            != 1 or executed[0]["target"] != PAR:
        problems.append(f"(d) decisions {acts}, executed {executed}")
    k = decisions.index(scaled[0]) if scaled else 0
    if reasons[k + 1:k + 3] != ["cooldown", "cooldown"]:
        problems.append(f"(d) no cooldown after the re-cut: {reasons}")
    if reasons[AUTOSCALE_KILL_AT] != "unhealthy":
        problems.append(f"(d) the fence with a failed subtask decided "
                        f"{reasons[AUTOSCALE_KILL_AT]}")
    if len(marks) != len(decisions):
        problems.append(f"(d) {len(marks)} scale.decision records for "
                        f"{len(decisions)} decisions")
    digest = ctl_as.log.digest()
    replayed = []
    c2 = AutoscaleController(policy(), log=DecisionLog(log_path),
                             execute_workers=replayed.append)
    for s in signals:
        c2.on_fence(s.epoch, s)
    if replayed or c2.rescales_executed or c2.log.digest() != digest \
            or c2.replayed_decisions != len(decisions):
        problems.append(f"(d) replay executed {replayed}, digest "
                        f"{c2.log.digest()} != {digest}")
    twice = []
    for _ in range(2):
        c3 = AutoscaleController(policy(), execute_workers=lambda t: None)
        for s in signals:
            c3.on_fence(s.epoch, s)
        twice.append(c3.log.to_bytes())
    if twice[0] != twice[1] or twice[0] != ctl_as.log.to_bytes():
        problems.append("(d) the same trace logged different bytes")
    if _hist_silent(launches):
        problems.append(f"no kernel launch: {launches}")
    if problems:
        raise AssertionError("; ".join(problems))
    log("[rescale] (b) rescale_live 8->16 on the pipelined audited runner, "
        "then (d) 16->8 by the autoscaler: transitions in protocol order, "
        "the stale runner refused, diff_ledgers_cross == [] against a "
        "never-rescaled control, the exact diff non-empty: " + json.dumps(
            dict(recut_8_to_16=readings["recut_8_to_16"],
                 first_epoch_after_recut_ms=round(
                     readings["first_epoch_after_recut_ms"], 3),
                 twin_recovery=readings["twin_recovery"],
                 source_records_per_s={
                     "8": round(readings["records_per_s_8"], 1),
                     "16": round(readings["records_per_s_16"], 1)},
                 epochs=n_epochs, kernel_launches=launches,
                 device=dev_line)))
    log("[rescale] (c) the read tier through the re-cut, 0 client errors, "
        "replicas == owner after the re-home, add/drop: "
        + json.dumps(dict(readings["read_tier"], device=dev_line)))
    log("[rescale] (d) the autoscaler: " + json.dumps(dict(
        loads=loads, actions=acts, reasons=reasons,
        executed=executed, replay_executed=0,
        log_digest=digest, log_rows=len(ctl_as.log),
        timeline_records=len(marks), device=dev_line)))
    log(f"[rescale] phase 15 (b)-(d): {time.monotonic() - t_phase:.1f} s "
        f"({dev_line})")
    return launches

# --- phase 16 ---------------------------------------------------------------

#: the soak's epochs (the bench's are 4,096 steps), 8-step chunks, every
#: second checkpoint completed; the ring and the log hold 8 epochs
SOAK_SPE = 256
SOAK_CHUNK = 8
SOAK_COMPLETE_EVERY = 2
SOAK_RING = 1 << (8 * SOAK_SPE - 1).bit_length()
SOAK_LOG = 1 << (2 * 8 * SOAK_SPE * DETS_PER_STEP).bit_length()
SOAK_MAX_EPOCHS = 1024
#: logical time runs this many steps ahead, so the 256-step window fires
#: on each epoch's last step and every fence follows a firing: each re-cut
#: then drains a window -> reduce buffer that holds records
SOAK_TIME_SHIFT = 1
#: (a) back-to-back chunks for this long; (b) the offered rate as a share
#: of (a)'s records/s, the soak clock's length and its SLO windows; (c)
#: and (d) their lengths
SOAK_CAPACITY_S = 5.0
SOAK_RATE_SHARE = 0.5
SOAK_DURATION_S = 45.0
SOAK_WINDOW_S = 5.0
SOAK_BAIT_S = 10.0
SOAK_LOOP_S = 20.0
SOAK_READS = 32
SOAK_RECUT = 16
SOAK_LEASE_TTL_S = 2.0
#: (b)'s schedule, each event at this share of the soak clock
SOAK_EVENTS = (
    (0.10, "kill {kill}"),
    (0.18, "gray {gray} delay=20ms for 3s"),
    (0.27, "leader-loss hold=500ms"),
    (0.33, "stall delay=100ms for 9s"),
    (0.56, "backlog for 5s"),
    (0.68, "replica-kill 0"),
    (0.74, "rescale {recut}"),
)
#: (c)'s bait and (d)'s spike, at these shares of their soak clocks
SOAK_BAIT_AT = 0.5
SOAK_SPIKE = (0.3, 4.0, 0.4)        # at, factor, for (shares, x, share)

PHASE16_REDUCTIONS = (
    f"the headline's widths as phase 15 cuts them ({PAR} sources x {BATCH} "
    f"records a step -> keyBy -> windows over {VOCAB} keys, window_size="
    f"{WINDOW_SIZE} -> keyBy(static) -> reduces -> keyBy -> {PAR} sinks; "
    f"{NUM_KEY_GROUPS} key groups, edge capacity {EDGE_CAPACITY}), keyed "
    f"stages at {PAR} lanes ({SOAK_RECUT} after (b)'s re-cut); a pipelined "
    f"audited runner, a sequential control twin and a FileLeaderElection "
    f"(ttl {SOAK_LEASE_TTL_S:g} s) built here (build_soak_fixture fixes 16 "
    f"key groups, a window that never fires and toy widths), re-cuts armed "
    f"as arm_rescaler arms them; cuts: steps_per_epoch={SOAK_SPE} (bench "
    f"4096), chunk_steps={SOAK_CHUNK}, complete_every={SOAK_COMPLETE_EVERY}, "
    f"inflight_ring_steps={SOAK_RING}, log_capacity={SOAK_LOG}, "
    f"logical_time=True shifted {SOAK_TIME_SHIFT} step so the window fires "
    f"on each epoch's last step, the sink edge a hash exchange; (a) "
    f"{SOAK_CAPACITY_S:g} s of back-to-back chunks; (b) "
    f"{SOAK_RATE_SHARE:g} of (a)'s records/s for {SOAK_DURATION_S:g} s "
    f"({SOAK_WINDOW_S:g} s SLO windows), a 2-replica read tier on the "
    f"reduce with {SOAK_READS} reads a pump; (c) {SOAK_BAIT_S:g} s with one "
    f"nondet; (d) {SOAK_LOOP_S:g} s with a load-spike")


class _ShiftedLogicalTime:
    """Logical time ``SOAK_TIME_SHIFT`` steps ahead of the executor's step
    count (both twins run it, so their ledgers stay comparable)."""

    def __init__(self, executor):
        self._ex = executor

    def now(self) -> int:
        return (len(self._ex.step_input_history)
                + SOAK_TIME_SHIFT) & 0x7FFFFFFF


def _soak_runner(root, tag, keyed_par, overlap):
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    r = ClusterRunner(build_rescale_job(keyed_par), **_soak_kw(root, tag,
                                                              overlap))
    r.executor.time_source = _ShiftedLogicalTime(r.executor)
    return r


def _soak_kw(root, tag, overlap):
    return dict(device=DEVICE, steps_per_epoch=SOAK_SPE,
                log_capacity=SOAK_LOG, max_epochs=SOAK_MAX_EPOCHS,
                inflight_ring_steps=SOAK_RING, block_steps=SOAK_SPE,
                logical_time=True, seed=SEED, audit=True,
                checkpoint_dir=os.path.join(root, tag),
                overlap_epoch=overlap)


def _arm_soak_rescaler(r, root, tag, overlap, drained):
    """``build_soak_fixture``'s ``arm_rescaler`` at these widths: a closure
    that re-cuts ``r`` at its completed fence through ``rescale_live`` and
    re-arms the new incarnation. It also counts the records the window ->
    reduce (static) buffer holds at the fence into ``drained`` (one read,
    at the re-cut only) and re-binds the shifted time to the new executor."""
    edge = next(e for e in r.executor.compiled.static_route)

    def rescale(target):
        held = int(r.executor.carry.edge_bufs[edge].valid.sum())
        nr, stats = r.rescale_live(build_rescale_job(int(target)),
                                   **_soak_kw(root, tag, overlap))
        nr.executor.time_source = _ShiftedLogicalTime(nr.executor)
        drained.append(dict(tag=tag, target=int(target),
                            static_buffer_records=held))
        _arm_soak_rescaler(nr, root, tag, overlap, drained)
        return nr, stats
    r._soak_rescaler = rescale
    return r


def _soak_trio(root, sub, drained):
    from clonos_tpu_torch.runtime.leader import FileLeaderElection
    d = os.path.join(root, sub)
    runner = _arm_soak_rescaler(_soak_runner(d, "run", PAR, True), d, "run",
                                True, drained)
    control = _arm_soak_rescaler(_soak_runner(d, "control", PAR, False), d,
                                 "control", False, drained)
    election = FileLeaderElection(os.path.join(d, "lease"), "soak-driver",
                                  lease_ttl_s=SOAK_LEASE_TTL_S)
    election.try_acquire()
    return runner, control, election


def _launch_shapes(fn):
    """Run ``fn`` logging the (R, B, nk, counts) of every keyed_hist call
    (kernel or plain version); returns (result, sorted distinct shapes)."""
    from clonos_tpu_torch.ops import histogram as hist
    seen = set()
    originals = hist.keyed_hist_cuda, hist.keyed_hist_plain

    def logged(orig):
        def call(keys, vals, valid, nk, want_counts=True):
            seen.add((keys.shape[0], keys.shape[1], nk, bool(want_counts)))
            return orig(keys, vals, valid, nk, want_counts)
        return call
    hist.keyed_hist_cuda, hist.keyed_hist_plain = map(logged, originals)
    try:
        out = fn()
    finally:
        hist.keyed_hist_cuda, hist.keyed_hist_plain = originals
    return out, sorted(seen)


def _soak_capacity(r):
    """(a) The paced loop's chunk (``SOAK_CHUNK`` x ``step()``) back to back
    for ``SOAK_CAPACITY_S``, with the loop's fences (every
    ``SOAK_COMPLETE_EVERY``-th completed, drained, older pendings
    discarded): records/s over the whole wall, chunk host ms, keyed_hist
    launches and synchronising calls (this thread) per chunk."""
    from clonos_tpu_torch.ops.histogram import keyed_hist
    ex = r.executor
    fences = [0]

    def fence_if_due():
        if ex.step_in_epoch >= SOAK_SPE:
            complete = fences[0] % SOAK_COMPLETE_EVERY == 0
            r.run_epoch(complete_checkpoint=complete)
            fences[0] += 1
            if complete:
                r.drain_fence()
                r.coordinator.discard_pending_through(ex.epoch_id - 1)

    chunk = lambda: [r.step() for _ in range(SOAK_CHUNK)]
    r.run_epoch(complete_checkpoint=True)
    r.drain_fence()
    chunk()
    fence_if_due()
    _, shapes = _launch_shapes(chunk)
    fence_if_due()
    ms, syncs, launches = [], [], []
    fences[0] = 0
    sync()
    t0 = time.monotonic()
    while time.monotonic() - t0 < SOAK_CAPACITY_S or ex.step_in_epoch:
        n0 = keyed_hist.launches
        t = time.monotonic()
        _, n = _sync_count(chunk, this_thread=True)
        ms.append((time.monotonic() - t) * 1e3)
        syncs.append(n)
        launches.append(keyed_hist.launches - n0)
        fence_if_due()
    sync()
    wall = time.monotonic() - t0
    records = len(ms) * SOAK_CHUNK * PAR * BATCH
    return dict(
        records_per_s=records / wall, chunks=len(ms), fences=fences[0],
        wall_s=round(wall, 3),
        chunk_ms_p50=round(float(np.percentile(ms, 50)), 3),
        chunk_ms_p99=round(float(np.percentile(ms, 99)), 3),
        keyed_hist_launches_per_chunk=sorted(set(launches)),
        syncs_per_chunk=(None if syncs[0] is None
                         else sorted(set(syncs))),
        launch_shapes=[list(x) for x in shapes])


def _watch_fences(runner, harness, rows):
    """Append to ``rows``, at each fence of ``runner``, the fence tail it
    joined last (``fence-tail`` and ``fence.snapshot`` ms, each tail
    once), tagged with whether the soak's ``stall`` is active."""
    last = [None]

    def note(_closed):
        ph = runner.last_fence_phases
        if ph and ph is not last[0]:
            last[0] = ph
            rows.append((harness._stall_orig is not None,
                         ph.get("fence-tail", 0.0),
                         ph.get("fence.snapshot", 0.0)))
    runner.fence_hooks.append(note)


def _fence_reading(rows):
    out = {}
    for stalled, key in ((True, "stalled"), (False, "unstalled")):
        mine = [r for r in rows if r[0] == stalled]
        out[key] = dict(
            fences=len(mine),
            fence_tail_ms_max=round(max((r[1] for r in mine),
                                        default=0.0), 3),
            snapshot_ms_max=round(max((r[2] for r in mine), default=0.0),
                                  3))
    return out


def _soak_verdict_line(v):
    lat = v["latency"]
    return dict(
        pass_=v["pass"], rate_target=v["rate_target"],
        rate_achieved=v["rate_achieved"], records=v["records"],
        duration_s=v["duration_s"],
        corrected_p50_ms=lat["p50_ms"], corrected_p99_ms=lat["p99_ms"],
        actual_p99_ms=lat["actual_send_p99_ms"],
        windows_breached=v["windows_breached"],
        faults=v["faults"]["by_kind"],
        recoveries_ms=v["faults"]["recoveries_ms"],
        exactly_once=v["audit"]["exactly_once"],
        epochs_checked=v["audit"]["epochs_checked"],
        divergences=v["audit"]["divergences"], truncated=v["truncated"])


def phase_soak(dev_line, root, rows=None):
    """(a) closed-loop capacity, (b) the open-loop soak with every operator
    fault under a read tier, (c) the audit bait, (d) the closed loop with
    the autoscaler. Every keyed_hist shape of a steady chunk must be one
    that phase 2 held against the plain version (``rows``; None skips the
    check). Returns the phase's kernel launches and (b)'s offered rate."""
    from clonos_tpu_torch.autoscale import (AutoscaleController,
                                            DecisionLog, PolicyConfig,
                                            ScalePolicy)
    from clonos_tpu_torch.obs import audit as audit_mod
    from clonos_tpu_torch.runtime import serve
    from clonos_tpu_torch.soak import (ServeLoad, SLOSpec, SoakConfig,
                                       SoakDriver, default_kill_targets,
                                       parse_schedule)
    t_phase = time.monotonic()
    problems = []
    readings = {}
    drained = []
    rps = PAR * BATCH

    def cfg(rate, duration):
        return SoakConfig(rate=rate, duration_s=duration,
                          window_s=SOAK_WINDOW_S, chunk_steps=SOAK_CHUNK,
                          complete_every=SOAK_COMPLETE_EVERY)

    def run():
        # (a) and (b) on one runner pair: (b)'s audit covers (a)'s epochs
        runner, control, election = _soak_trio(root, "b", drained)
        cap = _soak_capacity(runner)
        readings["a"] = cap
        held = {(r["R"], r["B"], r["nk"], r["counts"]) for r in rows or ()}
        if rows is not None and not set(
                map(tuple, cap["launch_shapes"])) <= held:
            problems.append(f"(a) chunk shapes {cap['launch_shapes']} not "
                            f"all checked in phase 2")
        if cap["syncs_per_chunk"] not in (None, [0]):
            problems.append(f"(a) synchronising calls in a steady chunk: "
                            f"{cap['syncs_per_chunk']} "
                            f"({SYNC_SITES[-3:]})")
        rate = readings["rate"] = SOAK_RATE_SHARE * cap["records_per_s"]
        targets = default_kill_targets(runner.job)
        text = "\n".join(
            f"at {share * SOAK_DURATION_S:.3f}s " + ev.format(
                kill=",".join(map(str, targets[:3])), gray=targets[1],
                recut=SOAK_RECUT)
            for share, ev in SOAK_EVENTS)
        vid = _reduce_vid(runner.job)
        tier = serve.build_serve_tier(runner, vid, n_replicas=2)
        fences = []
        try:
            load = ServeLoad(tier, vid, num_keys=VOCAB,
                             reads_per_pump=SOAK_READS,
                             window_s=SOAK_WINDOW_S)
            driver = SoakDriver(runner, cfg(rate, SOAK_DURATION_S),
                                schedule=parse_schedule(text),
                                spec=SLOSpec(exactly_once=True),
                                control=control, election=election,
                                records_per_step=rps, read_load=load)
            _watch_fences(runner, driver.harness, fences)
            v = driver.run()
            readings.setdefault("prewarm_s", []).append(driver.prewarm_s)
        finally:
            tier.close()
        h = driver.harness
        recut = [d for d in drained if d["tag"] == "run"]
        cross = audit_mod.diff_ledgers_cross(
            h.control.auditor.ledger(), h.runner.auditor.ledger())
        s = v["serve"]
        if not (v["pass"] and v["audit"]["exactly_once"] is True
                and not v["audit"]["divergences"]):
            problems.append(f"(b) verdict {_soak_verdict_line(v)}")
        kinds = {ev.split()[0] for _, ev in SOAK_EVENTS}
        if set(v["faults"]["by_kind"]) != kinds:
            problems.append(f"(b) faults fired {v['faults']['by_kind']}")
        if s["errors"] or s["reroutes"] <= 0 \
                or s["staleness_peak"] <= s["staleness_final"]:
            problems.append(f"(b) serve errors {s['errors']} "
                            f"({s['last_error']}), reroutes {s['reroutes']}, "
                            f"staleness peak {s['staleness_peak']} final "
                            f"{s['staleness_final']}")
        if len(recut) != 1 or recut[0]["static_buffer_records"] <= 0:
            problems.append(f"(b) re-cuts {recut}: none over a static "
                            f"buffer that holds records")
        if cross:
            problems.append(f"(b) cross diff {cross[:3]}")
        # One entry each, in the schedule's order: the kill's recovery, the
        # leader-loss pause, the re-cut's fence stall.
        rec_ms = v["faults"]["recoveries_ms"]
        named = (dict(zip(("kill_recovery_ms", "leader_pause_ms",
                           "recut_stall_ms"), rec_ms))
                 if len(rec_ms) == 3 else {})
        readings["b"] = dict(
            _soak_verdict_line(v), schedule=v["schedule"], **named,
            recut=dict(v["faults"]["rescale_stats"][0]
                       if v["faults"]["rescale_stats"] else {},
                       static_buffer_records=(
                           recut[0]["static_buffer_records"]
                           if recut else None)),
            stall=_fence_reading(fences),
            serve={k: s[k] for k in (
                "reads", "errors", "reroutes", "replica_reads",
                "owner_reads", "p50_read_ms", "p99_read_ms",
                "staleness_peak", "staleness_final", "replica_kills")},
            kills_mid_fence_tail=v["faults"]["kills_mid_fence_tail"],
            kill_rediff_problems=v["faults"]["kill_rediff_problems"],
            cross_diff=cross, rate=round(rate, 1))
        del driver, h, runner, control, tier, load
        torch.cuda.empty_cache()

        # (c) the audit bait: one unlogged perturbation must fail the run
        runner, control, election = _soak_trio(root, "c", [])
        driver = SoakDriver(
            runner, cfg(rate, SOAK_BAIT_S),
            schedule=parse_schedule(
                f"at {SOAK_BAIT_AT * SOAK_BAIT_S:.3f}s nondet"),
            spec=SLOSpec(exactly_once=True), control=control,
            election=election, records_per_step=rps)
        v = driver.run()
        readings.setdefault("prewarm_s", []).append(driver.prewarm_s)
        div = v["audit"]["divergences"]
        if v["pass"] or not any("ring" in d for d in div):
            problems.append(f"(c) the bait passed: {_soak_verdict_line(v)}")
        readings["c"] = dict(pass_=v["pass"], divergences=div[:2],
                             epochs_checked=v["audit"]["epochs_checked"],
                             faults=v["faults"]["by_kind"])
        del driver, runner, control
        torch.cuda.empty_cache()

        # (d) the closed loop: the autoscaler re-cuts the job itself
        runner, control, election = _soak_trio(root, "d", drained)
        log_path = os.path.join(root, "d", "scale.det")
        policy = lambda: ScalePolicy(PolicyConfig(
            sustain_fences=2, cooldown_fences=3, min_workers=4,
            max_workers=16))
        ctl = AutoscaleController(policy(), log=DecisionLog(log_path))
        at, factor, dur = SOAK_SPIKE
        driver = SoakDriver(
            runner, cfg(rate, SOAK_LOOP_S),
            schedule=parse_schedule(
                f"at {at * SOAK_LOOP_S:.3f}s load-spike {factor:g}x for "
                f"{dur * SOAK_LOOP_S:.3f}s"),
            spec=SLOSpec(exactly_once=True), control=control,
            election=election, records_per_step=rps, autoscaler=ctl)
        v = driver.run()
        readings.setdefault("prewarm_s", []).append(driver.prewarm_s)
        a = v["autoscale"]
        c2 = AutoscaleController(policy(), log=DecisionLog(log_path))
        if not (v["pass"] and v["audit"]["exactly_once"] is True
                and a["autoscale_rescales"] >= 1
                and a["operator_rescale_events"] == 0
                and a["max_actions_per_cooldown"] <= 1
                and c2.log.digest() == ctl.log.digest()
                and len(c2.log) == len(ctl.log)):
            problems.append(f"(d) {_soak_verdict_line(v)}, autoscale "
                            f"{a}, replayed digest {c2.log.digest()}")
        cross = audit_mod.diff_ledgers_cross(
            driver.harness.control.auditor.ledger(),
            driver.runner.auditor.ledger())
        if cross:
            problems.append(f"(d) cross diff {cross[:3]}")
        readings["d"] = dict(
            _soak_verdict_line(v), decisions=a["decisions"],
            by_action=a["by_action"],
            autoscale_rescales=a["autoscale_rescales"],
            operator_rescale_events=a["operator_rescale_events"],
            max_actions_per_cooldown=a["max_actions_per_cooldown"],
            rescale_stats=a["rescale_stats"], log_digest=a["log_digest"],
            replayed_digest=c2.log.digest(),
            recuts_over_static_buffers=[
                d for d in drained if d["tag"] == "run"][1:])
        del driver, runner, control
        torch.cuda.empty_cache()

    _, launches, _ = _counted(run)
    if _hist_silent(launches):
        problems.append(f"no kernel launch: {launches}")
    for part in ("a", "b", "c", "d"):
        if part in readings:
            log(f"[soak] ({part}) " + json.dumps(dict(
                readings[part], device=dev_line)))
    log(f"[soak] prewarm_recovery() in the soak driver, (b) (c) (d): "
        f"{readings.get('prewarm_s')} s ({dev_line})")
    if problems:
        raise AssertionError("phase 16: " + "; ".join(problems))
    log(f"[soak] phase 16: {time.monotonic() - t_phase:.1f} s, kernel "
        f"launches {json.dumps(launches)} ({dev_line})")
    return launches, readings["rate"]


# --- phase 17 ---------------------------------------------------------------

#: phases 17 and 19's epochs: one 512-step block each (phase 7: 1,024
#: steps, two blocks)
MESH_SPE = 512

PHASE17_REDUCTIONS = (
    f"the headline job at phase 7's widths and settings ({MESH_SPE}-step "
    f"epochs of one {BLOCK_STEPS}-step block (phase 7: 1,024-step epochs), "
    "audit on, checkpoints on disk, the sequential fence) "
    "on a torch.distributed task mesh: one rank over NCCL, and two ranks "
    "sharing the one card over gloo, every collective staged through "
    "pinned host memory (a reading of that protocol, not of a link "
    "between cards), with the sequential fence and then the pipelined "
    "one; schedule: 2 completed epochs, 1 pending, the window "
    "subtask on rank 1 killed and recovered, 1 completed epoch")
#: the killed subtask: window lane 6, in rank 1's vertex block (4-7) of
#: two; its log row and record count sit in rank 0's log block (0-15)
MESH_KILL = (1, 6)
#: timers on the killed window subtask, in logical ms (steps): three fire
#: inside the replayed span (epoch 2, left pending), the last stays
#: pending; the owning rank's callback log must read them twice
MESH_TIMERS = tuple(int(f * MESH_SPE) for f in (2.1, 2.6, 2.95, 5))
#: seconds each rank of phase 17 may run
MESH_RANK_TIMEOUT_S = 300


def _checked_everywhere(shapes):
    """:func:`_checked_hist` over both call sites of ``keyed_hist`` (the
    exchange's and the operators'): each call launches the kernel
    (counted) and then its plain version on the same inputs (not
    counted), which must agree bit for bit."""
    import contextlib

    from clonos_tpu_torch.api import operators
    from clonos_tpu_torch.ops import histogram as hist
    from clonos_tpu_torch.parallel import routing

    @contextlib.contextmanager
    def ctx():
        real = hist.keyed_hist

        def checked(keys, vals, valid, nk, want_counts=True):
            out = real(keys, vals, valid, nk, want_counts)
            plain = hist.keyed_hist_plain(
                keys.reshape(-1, keys.shape[-1]),
                vals.reshape(-1, keys.shape[-1]),
                valid.reshape(-1, keys.shape[-1]), nk, want_counts)
            err = int((out[0].reshape(plain[0].shape).to(torch.int64)
                       - plain[0].to(torch.int64)).abs().max())
            if want_counts:
                err = max(err, int((out[1].reshape(plain[1].shape)
                                    .to(torch.int64)
                                    - plain[1].to(torch.int64)).abs().max()))
            shapes.append((*plain[0].shape[:1], keys.shape[-1], nk,
                           bool(want_counts), err))
            return out
        routing.keyed_hist = operators.keyed_hist = checked
        try:
            yield
        finally:
            routing.keyed_hist = operators.keyed_hist = real
    return ctx()


def _mesh_counts(r):
    """The whole record-count vector of a sharded runner (one all-gather
    of that leaf alone)."""
    from clonos_tpu_torch.parallel import distributed as dist_
    ex = r.executor
    return dist_.all_gather_tree(
        ex.carry.record_counts, ex.compiled.placements().record_counts,
        ex.mesh).cpu().numpy()


def _mesh_schedule(r, kill_flat, checked=None):
    """Phase 17's schedule on runner ``r`` (sharded or not): epoch 0 (under
    ``checked`` when given), epochs 1-2 timed (the second left pending),
    the kill and its recovery, one completed epoch. Returns readings."""
    from clonos_tpu_torch.parallel import distributed as dist_
    sharded = r.mesh is not None
    counts = (lambda: _mesh_counts(r)) if sharded else (
        lambda: r.executor.carry.record_counts.cpu().numpy())
    fired = []
    svc = r.timer_service(kill_flat)
    svc.register_callback(fired.append, callback_id=7)
    for t in MESH_TIMERS:
        svc.register_timer(t, 7)
    if checked is not None:
        with checked:
            r.run_epoch(complete_checkpoint=True)
    else:
        r.run_epoch(complete_checkpoint=True)
    rc0 = counts()
    sync()
    dist_.reset_stats()
    t0 = time.monotonic()

    def two():
        for complete in (True, False):
            r.run_epoch(complete_checkpoint=complete)
        r.drain_fence()
    _, syncs = _sync_count(two)
    sync()
    wall = time.monotonic() - t0
    stats = dict(dist_.STATS)
    rc1 = counts()
    lo, hi = r.executor.compiled.vblock[0]
    blocks = 2 * (MESH_SPE // BLOCK_STEPS)
    out = dict(
        source_records_per_s=float((rc1[:PAR] - rc0[:PAR]).sum()) / wall,
        own_source_records_per_s=float(
            (rc1[lo:hi] - rc0[lo:hi]).sum()) / wall,
        epochs_wall_s=wall, blocks=blocks,
        synchronising_calls_per_block=(syncs / blocks
                                       if syncs is not None else None),
        collectives_per_block=stats["collectives"] / blocks,
        collective_ms_per_block=stats["seconds"] * 1e3 / blocks,
        collective_mb_per_block=stats["bytes"] / blocks / 1e6,
        per_shard_health=(r.per_shard_health().tolist() if sharded
                          else None))
    from clonos_tpu_torch.runtime.executor import canonical_carry
    from clonos_tpu_torch.utils.tree import (tree_flatten_with_path,
                                             tree_leaves)
    before = [x.clone() for x in
              tree_leaves(canonical_carry(r.executor.carry))]
    r.inject_failure([kill_flat])
    sync()
    t = time.monotonic()
    report = r.recover()
    sync()
    out["recovery_ms"] = (time.monotonic() - t) * 1e3
    after = tree_leaves(canonical_carry(r.executor.carry))
    out["report"] = dict(
        restore_bytes=report.restore_bytes,
        checkpoint_bytes=report.checkpoint_bytes,
        steps_replayed=report.steps_replayed,
        records_replayed=report.records_replayed,
        managers=len(report.managers),
        phase_ms={k: round(v, 3) for k, v in report.phase_ms.items()})
    # Every live shard of this rank but its logs (which took the healthy
    # tasks' IGNORE_CHECKPOINT rows) equal to before the kill, dead
    # storage aside: the rebuilt rows of the killed subtask included.
    paths = [p for p, _ in tree_flatten_with_path(r.executor.carry)]
    out["unchanged"] = all(
        torch.equal(a, b) for p, a, b in zip(paths, before, after)
        if p[0] not in ("logs", "replicas"))
    r.run_epoch(complete_checkpoint=True)
    r.drain_fence()
    out["pipelined"] = "fence.overlap-saved" in r.last_fence_phases
    out["timers"] = fired
    out["timer_rank"] = (r._vertex_ranks(*r._vertex_of(kill_flat))[0]
                         if sharded else 0)
    return out


def _mesh_kw():
    """Phases 17 and 19's runner settings: the headline's at
    MESH_SPE-step epochs; ring and log hold two epochs."""
    return dict(runner_kw(), steps_per_epoch=MESH_SPE,
                log_capacity=1 << (2 * MESH_SPE * DETS_PER_STEP).bit_length(),
                inflight_ring_steps=1 << (2 * MESH_SPE - 1).bit_length())


def _mesh_runner(root, tag, mesh, device, overlap=False):
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    return ClusterRunner(build_job(), device=device, audit=True,
                         checkpoint_dir=os.path.join(root, tag), mesh=mesh,
                         overlap_epoch=overlap, **_mesh_kw())


def _mesh_rank(ctx, root, tag, overlap=False):
    """One rank of a phase 17 mesh: the headline through
    :func:`_mesh_schedule`, every keyed_hist launch of its first epoch
    held against the plain version. Returns its readings, launches (from
    0 at its start), ledger (rank 0) and state digest."""
    from clonos_tpu_torch.ops.histogram import keyed_hist
    from clonos_tpu_torch.parallel import distributed as dist_
    mesh = dist_.task_mesh(device=ctx.device)
    r = _mesh_runner(root, tag, mesh, ctx.device, overlap)
    flat = r.job.subtask_base(MESH_KILL[0]) + MESH_KILL[1]
    shapes = []
    sync()
    keyed_hist.launches = keyed_hist.launches_counts = 0
    out = _mesh_schedule(r, flat, _checked_everywhere(shapes))
    sync()
    out["launches"] = {"keyed_hist": keyed_hist.launches_counts,
                       "keyed_hist_sums": (keyed_hist.launches
                                           - keyed_hist.launches_counts)}
    out["shapes"] = sorted({s[:4] for s in shapes})
    out["max_abs_err"] = max((s[4] for s in shapes), default=None)
    out["checked_launches"] = len(shapes)
    out["ledger"] = r.coordinator.read_ledger() if ctx.process_id == 0 \
        else None
    out["digest"] = r.state_digest()
    out["backend"] = ctx.backend
    out["rank"] = ctx.process_id
    return out


_NCCL_PROBE = r"""
import sys, torch, torch.distributed as dist
rank = int(sys.argv[2])
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=sys.argv[1], world_size=2,
                        rank=rank)
x = torch.ones(1, device="cuda")
dist.all_reduce(x)
torch.cuda.synchronize()
print("all_reduce returned", x.item())
dist.destroy_process_group()
"""


def _nccl_two_ranks_one_card(root):
    """Two NCCL ranks on the one card: what NCCL says, returned verbatim
    (its error lines), each rank under a 120 s limit."""
    rdv = "file://" + os.path.join(root, "nccl_rdv")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _NCCL_PROBE, rdv, str(r)],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    lines = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n(killed at its 120 s limit)"
        said = [ln.strip() for ln in out.splitlines() if any(
            w in ln for w in ("Error", "error", "Duplicate", "returned",
                              "limit"))]
        lines.append((p.returncode, said[-6:] or out.splitlines()[-6:]))
    return lines


def phase_mesh(dev_line, root, rows):
    """(a) the headline on a one-rank NCCL mesh, (b) two ranks sharing the
    card over gloo, (c) the window kill on rank 1 recovered there, (e)
    (b)-(c) with the pipelined fence, each ledger and digest equal to an
    unsharded runner's on the same schedule; (d) the ``dryrun`` verb on
    2 ranks; and what NCCL says of two ranks on one device. Every keyed_hist launch of each mesh run's
    first epoch equals its plain version, and each launched shape has a
    phase 2 row. Returns {path: launches}."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    from clonos_tpu_torch.ops.histogram import keyed_hist
    from clonos_tpu_torch.parallel import distributed as dist_
    t_phase = time.monotonic()
    row_of = {}
    for r in rows:               # the first timed row of each shape
        if "ms" in r:
            row_of.setdefault((r["R"], r["B"], r["nk"], r["counts"]), r)
    launches = {}

    control = _mesh_runner(root, "control", None, DEVICE)
    flat = control.job.subtask_base(MESH_KILL[0]) + MESH_KILL[1]
    sync()
    keyed_hist.launches = keyed_hist.launches_counts = 0
    ctl = _mesh_schedule(control, flat)
    sync()
    launches["mesh_control"] = {
        "keyed_hist": keyed_hist.launches_counts,
        "keyed_hist_sums": keyed_hist.launches - keyed_hist.launches_counts}
    if ctl["timers"] != list(MESH_TIMERS[:3]) * 2:
        raise AssertionError(f"phase 17: the control's timer log "
                             f"{ctl['timers']}")
    ctl_ledger = control.coordinator.read_ledger()
    ctl_digest = control.state_digest()
    control.coordinator.storage._close_ledger()
    del control
    torch.cuda.empty_cache()
    log("[mesh] unsharded control: " + json.dumps(dict(
        {k: v for k, v in ctl.items() if k != "per_shard_health"},
        device=dev_line), default=float))

    # (a) one rank over NCCL, in this process (its group is this process).
    ctx = dist_.initialize("file://" + os.path.join(root, "nccl1_rdv"), 1,
                           0, device="cuda", backend="nccl")
    try:
        one = _mesh_rank(ctx, root, "nccl1")
    finally:
        dist_.shutdown()
    torch.cuda.empty_cache()
    # (b, c) two ranks sharing the card over gloo, each its own process;
    # (e) the same with the pipelined fence (its worker's gathers on the
    # fence group).
    def gloo_pair(tag, overlap):
        return dist_.spawn(
            "chip_smoke:_mesh_rank", 2,
            {"root": root, "tag": tag, "overlap": overlap}, device="cuda",
            backend="gloo", share_device=True,
            timeout_s=MESH_RANK_TIMEOUT_S,
            workdir=os.path.join(root, f"ranks-{tag}"))
    two = gloo_pair("gloo2", False)
    piped = gloo_pair("gloo2-pipelined", True)
    problems = []
    for name, res in (("nccl-1rank", [one]), ("gloo-2rank", two),
                      ("gloo-2rank-pipelined", piped)):
        n = len(res)
        d = diff_ledgers(ctl_ledger, res[0]["ledger"])
        if d:
            problems.append(f"{name}: ledger differs from the control's: "
                            f"{d[:3]}")
        if len(res[0]["ledger"]) != len(ctl_ledger):
            problems.append(f"{name}: {len(res[0]['ledger'])} ledger "
                            f"entries, control {len(ctl_ledger)}")
        for r in res:
            if r["digest"] != ctl_digest:
                problems.append(f"{name} rank {r['rank']}: state digest "
                                f"differs from the control's")
            if r["max_abs_err"] != 0 or not r["checked_launches"]:
                problems.append(f"{name} rank {r['rank']}: kernel vs plain "
                                f"max abs err {r['max_abs_err']} over "
                                f"{r['checked_launches']} launches")
            if not all(r["launches"].values()):
                problems.append(f"{name} rank {r['rank']}: a kernel was "
                                f"not launched: {r['launches']}")
            if not r["unchanged"]:
                problems.append(f"{name} rank {r['rank']}: a live shard "
                                f"changed through the recovery")
            for s in r["shapes"]:
                if s not in row_of:
                    problems.append(f"{name}: launched shape {s} has no "
                                    f"phase 2 row")
            if np.asarray(r["per_shard_health"]).shape != (n, 3):
                problems.append(f"{name}: per_shard_health shape "
                                f"{np.asarray(r['per_shard_health']).shape}")
        modes = [r["pipelined"] for r in res]
        if modes != [name.endswith("pipelined")] * n:
            problems.append(f"{name}: pipelined fence per rank {modes}")
        # The recovered timers re-fire once, on the rank that runs the
        # killed subtask (nothing on the others).
        for r in res:
            want = ctl["timers"] if r["rank"] == r["timer_rank"] else []
            if r["timers"] != want:
                problems.append(f"{name} rank {r['rank']}: timer log "
                                f"{r['timers']} != {want}")
        owners = [r["report"]["managers"] for r in res]
        if owners != ([1] if n == 1 else [0, 1]):
            problems.append(f"{name}: managers per rank {owners} (the "
                            f"kill must replay on rank {n - 1} alone)")
        for r in res:
            launches[f"mesh_{name}_rank{r['rank']}"] = r["launches"]
            log(f"[mesh] {name} rank {r['rank']}: " + json.dumps(dict(
                {k: v for k, v in r.items()
                 if k not in ("ledger", "digest", "shapes")},
                shapes=[dict(R=s[0], B=s[1], nk=s[2], counts=s[3],
                             phase2_label=row_of.get(s, {}).get("label"),
                             device_ms=row_of.get(s, {}).get("device_ms"),
                             bound_ms=row_of.get(s, {}).get("bound_ms"),
                             library_ms=row_of.get(s, {}).get("library_ms"))
                        for s in r["shapes"]],
                ledger_equal_control=not diff_ledgers(ctl_ledger,
                                                      res[0]["ledger"]),
                device=dev_line), default=float))
    # (d) the dryrun verb on 2 ranks sharing the card.
    t = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "clonos_tpu_torch", "dryrun", "--devices",
         "2", "--backend", "gloo", "--device", "cuda", "--timeout",
         str(MESH_RANK_TIMEOUT_S)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=MESH_RANK_TIMEOUT_S + 60)
    if proc.returncode != 0:
        problems.append(f"dryrun exited {proc.returncode}: "
                        f"{proc.stderr[-1500:]}")
    else:
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        if not (line["ok"] and line["n_devices"] == 2
                and len(line["per_shard_records_per_sec"]) == 2):
            problems.append(f"dryrun line: {line}")
        log(f"[mesh] dryrun --devices 2 --backend gloo --device cuda "
            f"({time.monotonic() - t:.1f} s): {json.dumps(line)} | "
            f"{dev_line}")
    # What NCCL says of two ranks on one card (printed, not hidden).
    for rank, (rc, said) in enumerate(_nccl_two_ranks_one_card(root)):
        log(f"[mesh] NCCL, two ranks on one card, rank {rank}: exit {rc}; "
            + " | ".join(said))
    log(f"[mesh] phase 17: {time.monotonic() - t_phase:.1f} s "
        f"({dev_line}); no reading across two cards exists (one card)")
    if problems:
        raise AssertionError("phase 17: " + "; ".join(problems))
    return launches


# --- phase 18 ---------------------------------------------------------------

PHASE18_REDUCTIONS = (
    "the sharded deployment's host boundaries and storage, each sub-phase "
    "on one NCCL rank, on two gloo ranks sharing the card (collectives "
    "staged through pinned host memory) and unsharded as its control: "
    f"(a) bench.py config #4 at full width (16 subtasks a vertex, batch "
    f"{C4_BATCH}, {C4_VOCAB} keys, edge capacity {C4_EDGE}, 64 key groups, "
    f"seed {C4_SEED}, phase 9's settings and cuts), audit on; schedule: "
    f"one completed epoch, {C4_DRILL_AT} steps, a failover drill, the "
    f"rest of the epoch pending, a connected kill on both ranks recovered; "
    f"(b) (a)'s job with a transactional file sink, ring and log 2 "
    f"epochs; one "
    f"completed and one pending epoch, a sink subtask on rank 1 and a "
    f"reduce subtask on rank 0 killed and recovered, one completed epoch, "
    f"against a never-failed run's part files; (c) phase 8 (b)'s "
    f"deep backlog (spill_probe's settings: {SPILL_SPE}-step epochs, ring "
    f"{SPILL_BACKLOG_RING}, host budget 1 epoch, {SPILL_FILL} pending "
    f"epochs) with a window subtask of rank 1 killed; (d) phase 8 (d)'s "
    f"incremental chain (base every {INC_BASE_EVERY}, pipelined fence) "
    f"killed after {INC_BASE_EVERY} completed epochs and one pending")
#: (a): phase 9's drill; the connected kill is phase 9's (a feed source,
#: a window and a reduce subtask, lanes 2, 3, 7: rank 0's vertex blocks)
#: with window subtask 11 added, so the kill spans both ranks
P18_DRILL = [(0, 1), (1, 2), (2, 6)]
P18_KILL = [(0, 2), (1, 3), (2, 7), (1, 11)]
#: (b): a reduce subtask of rank 0 and a sink subtask of rank 1
P18_EGRESS_KILL = [(2, 2), (3, 12)]
#: (c): window subtask 5, in rank 1's block (4-7) of the headline's 8
P18_SPILL_KILL = [(1, 5)]
#: seconds each rank of phase 18 may run
P18_RANK_TIMEOUT_S = 420
#: the rank function the two gloo ranks run (a rehearsal names its own)
P18_RANK_TARGET = "chip_smoke:_p18_rank"


def _p18_records(r, lanes):
    """Source records so far, over every source lane and over this rank's
    (``lanes``): the mesh's whole count vector, else the carry's."""
    rc = (_mesh_counts(r) if r.mesh is not None
          else r.executor.carry.record_counts.cpu().numpy())
    lo, hi = lanes
    return float(rc[:C4_PAR].sum()), float(rc[lo:hi].sum())


def _p18_launches():
    from clonos_tpu_torch.ops.histogram import keyed_hist
    return {"keyed_hist": keyed_hist.launches_counts,
            "keyed_hist_sums": keyed_hist.launches
            - keyed_hist.launches_counts}


def _p18_zero():
    from clonos_tpu_torch.ops.histogram import keyed_hist
    sync()
    keyed_hist.launches = keyed_hist.launches_counts = 0


def _p18_report(rep):
    return dict(flats=list(rep.failed_subtasks),
                steps_replayed=rep.steps_replayed,
                records_replayed=rep.records_replayed,
                managers=len(rep.managers),
                restore_bytes=rep.restore_bytes,
                checkpoint_bytes=rep.checkpoint_bytes,
                recovery_ms=round(rep.recovery_ms, 3),
                phase_ms={k: round(v, 3) for k, v in rep.phase_ms.items()})


def _p18_feeds(mesh, device, checked=None):
    """(a) config #4 with its feed: epoch 0 (under ``checked``), the drill
    mid-epoch, the rest of the epoch pending (timed), the connected kill
    and its recovery. Returns readings."""
    import contextlib

    from clonos_tpu_torch.parallel import distributed as dist_
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    r = ClusterRunner(build_c4_job(), device=device, mesh=mesh, audit=True,
                      **_c4_kw())
    reader = _feed_reader(C4_SEED, 4 * C4_SPE * C4_BATCH)
    r.executor.register_feed(0, reader)
    with checked or contextlib.nullcontext():
        r.run_epoch(complete_checkpoint=True)
    for _ in range(C4_DRILL_AT):
        r.step()
    drill_s = r.failover_drill(_flats(r, P18_DRILL))
    lanes = r.executor.compiled.vblock[0]
    all0, own0 = _p18_records(r, lanes)
    steps = C4_SPE - C4_DRILL_AT
    blocks = -(-steps // r.executor.block_steps)
    sync()
    dist_.reset_stats()
    t0 = time.monotonic()
    _, syncs = _sync_count(lambda: r.run_epoch(complete_checkpoint=False))
    sync()
    wall = time.monotonic() - t0
    stats = dict(dist_.STATS)
    all1, own1 = _p18_records(r, lanes)
    r.inject_failure(_flats(r, P18_KILL))
    sync()
    t = time.monotonic()
    rep = r.recover()
    sync()
    out = dict(
        records_per_s=(all1 - all0) / wall,
        own_records_per_s=(own1 - own0) / wall, timed_steps=steps,
        blocks=blocks, synchronising_calls_per_block=(
            syncs / blocks if syncs is not None else None),
        collectives_per_block=stats["collectives"] / blocks,
        collective_ms_per_block=stats["seconds"] * 1e3 / blocks,
        collective_mb_per_block=stats["bytes"] / blocks / 1e6,
        drill_ms=drill_s * 1e3, recovery_wall_ms=(time.monotonic() - t)
        * 1e3, report=_p18_report(rep), lanes=list(lanes),
        bases=list(reader._base), cursors=list(reader._cursor),
        checkpoint=r.standbys.latest.checkpoint_id,
        ledger=r.coordinator.read_ledger() if r.rank == 0 else None,
        digest=r.state_digest())
    return out


def _p18_hashes(root):
    """sha1 of every committed part file, by name."""
    import hashlib
    return {fn: hashlib.sha1(data).hexdigest()
            for fn, data in _files(root).items() if fn.endswith(".final")}


def _p18_egress(mesh, device, root, kill=True, lineage_root=None):
    """(b) config #4 with a transactional file sink under ``root``: one
    completed epoch, one pending, the kill (unless ``kill`` is False: the
    never-failed run) recovered, one completed epoch; with
    ``lineage_root``, under a ``LineagePlane(k=3)`` there (rank 0's file
    holds every rank's sink termini). Returns readings."""
    import hashlib

    from clonos_tpu_torch.obs.lineage import LineagePlane
    from clonos_tpu_torch.parallel import distributed as dist_
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    kw = dict(_c4_kw(), inflight_ring_steps=2 * C4_SPE,
              log_capacity=1 << (2 * C4_SPE * 8 - 1).bit_length())
    plane = None
    if lineage_root is not None:
        # Each rank's plane under its own directory.
        lineage_root = os.path.join(lineage_root, "r0" if mesh is None
                                    else f"r{dist_.mesh_rank(mesh)}")
        plane = LineagePlane(lineage_root, service="run", k=3)
        kw["lineage"] = plane
    r = ClusterRunner(build_c4_job(transactional=True), device=device,
                      mesh=mesh, audit=True, **kw)
    r.executor.register_feed(0, _feed_reader(C4_SEED, 4 * C4_SPE
                                             * C4_BATCH))
    fs = r.attach_file_sink(3, root)
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    out = {}
    if kill:
        r.inject_failure(_flats(r, P18_EGRESS_KILL))
        sync()
        rep = r.recover()
        sync()
        out["report"] = _p18_report(rep)
    r.run_epoch(complete_checkpoint=True)
    if mesh is not None:
        dist_.barrier(mesh)
    if plane is not None:
        plane.close()
        path = os.path.join(lineage_root, "lineage-run.jsonl")
        if r.rank == 0:
            with open(path, "rb") as f:
                raw = f.read()
            out["lineage"] = dict(
                sha1=hashlib.sha1(raw).hexdigest(), bytes=len(raw),
                sink_rows=raw.count(b'"kind": "sink"'))
        else:
            out["lineage"] = dict(bytes=(os.path.getsize(path)
                                         if os.path.exists(path) else 0))
    out.update(committed=fs.committed_epochs(),
               pending=sorted(f for f in os.listdir(root)
                              if f.endswith(".pending")),
               files=_p18_hashes(root) if r.rank == 0 else None,
               ledger=r.coordinator.read_ledger() if r.rank == 0 else None,
               digest=r.state_digest())
    return out


def _p18_spill(mesh, device, root):
    """(c) phase 8 (b)'s deep backlog on ``mesh``: each rank spills its own
    ring lanes and log block under ``root/rank<r>``; the kill's replay
    span is SPILL_FILL rings long, refilled from the lane holders' disk
    tiers. Returns readings."""
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    kw = _spill_kw(SPILL_BACKLOG_RING, SPILL_FILL)
    r = ClusterRunner(build_job(), device=device, mesh=mesh, audit=True,
                      spool_dir=root, spill_host_budget_epochs=1, **kw)
    r.run_epoch(complete_checkpoint=True)
    for _ in range(SPILL_FILL):
        r.run_epoch(complete_checkpoint=False)
    r.executor.drain_spill()
    occupancy = r.executor.spill_occupancy()
    r.inject_failure(_flats(r, P18_SPILL_KILL))
    sync()
    rep = r.recover()
    sync()
    out = dict(report=_p18_report(rep), occupancy_at_kill=occupancy,
               movement=r.executor.spill_stats(),
               gauges={k.split(f"job.{r.job.name}.", 1)[1]: v
                       for k, v in r.metrics.snapshot().items()
                       if ".spill." in k},
               by_rank=r.spill_by_rank(),
               ledger=r.coordinator.read_ledger() if r.rank == 0 else None,
               digest=r.state_digest())
    r.executor.close_spill()
    out["index_digests"] = _index_digests(
        root if mesh is None else os.path.join(root, f"rank{r.rank}"))
    # This rank's spool (up to ~1 GB at these widths) goes now.
    shutil.rmtree(root if mesh is None else os.path.join(
        root, f"rank{r.rank}"), ignore_errors=True)
    return out


def _index_digests(spool):
    """Every segment index under ``spool``: store name -> epoch (truncated
    or live) -> the digest its last index record carries (None: never
    stamped)."""
    out = {}
    for fn in sorted(os.listdir(spool)):
        if not fn.endswith(".index.jsonl"):
            continue
        eps = {}
        with open(os.path.join(spool, fn)) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("kind") in ("segment", "digest"):
                    eps[rec["epoch"]] = rec.get("digest")
        out[fn[:-len(".index.jsonl")]] = {str(e): d for e, d in eps.items()}
    return out


def _p18_incremental(mesh, device, root):
    """(d) phase 8 (d)'s incremental chain on ``mesh`` (rank 0 writes it
    from the gathered snapshot): INC_BASE_EVERY completed epochs, one
    pending, the kill recovered from a delta with a chain of
    INC_BASE_EVERY - 1 deltas behind it. Returns readings."""
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    kw = _spill_kw(SPILL_STEADY_RING, INC_BASE_EVERY)
    r = ClusterRunner(build_job(), device=device, mesh=mesh, audit=True,
                      overlap_epoch=True, checkpoint_dir=root,
                      incremental_checkpoints=True,
                      incremental_base_every=INC_BASE_EVERY, **kw)
    for _ in range(INC_BASE_EVERY):
        r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    r.drain_fence()
    out = {}
    if r.rank == 0:
        st = r.coordinator.storage
        restore = r.standbys.latest.checkpoint_id
        chain = st._chain(restore)
        sizes = st.delta_bytes_on_disk()
        out.update(restore=restore, chain=chain,
                   kinds=[st._index[c][0] for c in chain],
                   bytes_on_disk={str(c): sizes[c] for c in chain},
                   delta_over_full=[round(sizes[c] / sizes[chain[0]], 6)
                                    for c in chain[1:]])
    r.inject_failure(_flats(r, INC_KILL))
    sync()
    rep = r.recover()
    sync()
    r.run_epoch(complete_checkpoint=True)
    r.drain_fence()
    out.update(report=_p18_report(rep),
               ledger=r.coordinator.read_ledger() if r.rank == 0 else None,
               digest=r.state_digest())
    return out


def _p18_all(mesh, device, root, checked=None):
    """(a)-(d) on ``mesh`` (None: the unsharded control), each with the
    kernel's launch counts at 0 just before it and read just after.
    Returns {sub-phase: readings}."""
    out = {}
    for name, fn in (
            ("a", lambda: _p18_feeds(mesh, device, checked)),
            ("b", lambda: _p18_egress(mesh, device,
                                      os.path.join(root, "sink"),
                                      lineage_root=os.path.join(
                                          root, "lineage"))),
            ("c", lambda: _p18_spill(mesh, device,
                                     os.path.join(root, "spill"))),
            ("d", lambda: _p18_incremental(mesh, device,
                                           os.path.join(root, "inc")))):
        _p18_zero()
        t = time.monotonic()
        out[name] = fn()
        sync()
        out[name]["launches"] = _p18_launches()
        out[name]["seconds"] = time.monotonic() - t
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def _p18_rank(ctx, root, tag):
    """One rank of a phase 18 mesh: (a)-(d), every keyed_hist launch of
    (a)'s first epoch held against the plain version."""
    from clonos_tpu_torch.parallel import distributed as dist_
    mesh = dist_.task_mesh(device=ctx.device)
    shapes = []
    out = _p18_all(mesh, ctx.device, os.path.join(root, tag),
                   _checked_everywhere(shapes))
    out["shapes"] = sorted({s[:4] for s in shapes})
    out["max_abs_err"] = max((s[4] for s in shapes), default=None)
    out["checked_launches"] = len(shapes)
    out["rank"] = ctx.process_id
    out["backend"] = ctx.backend
    return out


def _p18_check(name, res, ctl, golden_b, row_of):
    """Every equality of phase 18 for one mesh run (``res``: its ranks'
    readings); returns the problems found."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    problems = []
    n = len(res)
    lead = res[0]
    for sub in "abcd":
        d = diff_ledgers(ctl[sub]["ledger"], lead[sub]["ledger"])
        if d or len(lead[sub]["ledger"]) != len(ctl[sub]["ledger"]):
            problems.append(f"{name} ({sub}): ledger differs from the "
                            f"control's: {d[:3]}")
        for r in res:
            if r[sub]["digest"] != ctl[sub]["digest"]:
                problems.append(f"{name} rank {r['rank']} ({sub}): state "
                                f"digest differs from the control's")
            if _hist_silent(r[sub]["launches"]):
                problems.append(f"{name} rank {r['rank']} ({sub}): a kernel "
                                f"was not launched: {r[sub]['launches']}")
    # (a) committed feed offsets: each lane's from the rank that pulls it.
    own = [None] * C4_PAR
    for r in res:
        lo, hi = r["a"]["lanes"]
        own[lo:hi] = r["a"]["bases"][lo:hi]
    if own != ctl["a"]["bases"] or min(own) <= 0:
        problems.append(f"{name} (a): committed offsets {own} != the "
                        f"control's {ctl['a']['bases']}")
    mgrs = [r["a"]["report"]["managers"] for r in res]
    if n > 1 and not all(mgrs):
        problems.append(f"{name} (a): managers per rank {mgrs} (the kill "
                        f"spans both ranks)")
    # (b) the part files: a never-failed unsharded run's, byte for byte.
    if lead["b"]["files"] != golden_b["files"] or not golden_b["files"]:
        problems.append(f"{name} (b): committed part files differ from "
                        f"the never-failed run's")
    if any(r["b"]["pending"] for r in res):
        problems.append(f"{name} (b): pendings left "
                        f"{[r['b']['pending'] for r in res]}")
    # (b) rank 0's lineage file holds every rank's sink termini: the
    # control's, byte for byte; the other ranks write none.
    if lead["b"]["lineage"] != ctl["b"]["lineage"] \
            or not ctl["b"]["lineage"]["sink_rows"] \
            or any(r["b"]["lineage"]["bytes"] for r in res[1:]):
        problems.append(f"{name} (b): lineage files "
                        f"{[r['b']['lineage'] for r in res]} != the "
                        f"control's {ctl['b']['lineage']}")
    # (c) every rank's segment indexes carry the ledger's digests: none
    # left null, truncated epochs included, each the control's for that
    # store and epoch (where a truncate overtook the control's write of
    # an epoch, its index has no record of it).
    for r in res:
        if not any(r["c"]["index_digests"].values()):
            problems.append(f"{name} rank {r['rank']} (c): no spilled "
                            f"epoch in its indexes")
        for store, eps in r["c"]["index_digests"].items():
            want = ctl["c"]["index_digests"].get(store, {})
            for e, d in eps.items():
                if d is None or d != want.get(e, d):
                    problems.append(f"{name} rank {r['rank']} (c): "
                                    f"{store} epoch {e} digest {d}")
    # (c) the refill came from the lane holders' disk tiers.
    for r in res:
        if r["c"]["movement"].get("disk_hits", 0) <= 0:
            problems.append(f"{name} rank {r['rank']} (c): no disk hit: "
                            f"{r['c']['movement']}")
        if not r["c"]["report"]["steps_replayed"] > SPILL_BACKLOG_RING:
            problems.append(f"{name} (c): replayed "
                            f"{r['c']['report']['steps_replayed']} steps")
    # (d) a chain of at least two deltas behind the restore point.
    kinds = lead["d"]["kinds"]
    if kinds[0] != "full" or kinds[1:].count("delta") < 2:
        problems.append(f"{name} (d): restore chain {kinds}")
    for r in res:
        if r["max_abs_err"] != 0 or not r["checked_launches"]:
            problems.append(f"{name} rank {r['rank']}: kernel vs plain max "
                            f"abs err {r['max_abs_err']} over "
                            f"{r['checked_launches']} launches")
        for s in r["shapes"]:
            if s not in row_of:
                problems.append(f"{name}: launched shape {s} has no phase "
                                f"2 row")
    return problems


def _p18_line(reading):
    """A sub-phase's readings as printed: no ledger, digest, files or
    index digests."""
    return {k: v for k, v in reading.items()
            if k not in ("ledger", "digest", "files", "index_digests")}


def phase_mesh_storage(dev_line, root, rows):
    """(a) config #4's host-fed source, (b) its transactional file sink,
    (c) tiered spill and (d) incremental checkpoints, each on one NCCL
    rank and on two gloo ranks sharing the card, against an unsharded
    control (for (b)'s files, a never-failed run): sealed ledgers, state
    digests, committed feed offsets and part files equal. Every
    keyed_hist launch of (a)'s first epoch on each rank equals its plain
    version, and each launched shape has a phase 2 row. Returns {path:
    launches}."""
    from clonos_tpu_torch.parallel import distributed as dist_
    t_phase = time.monotonic()
    row_of = {}
    for r in rows:               # the first timed row of each shape
        if "ms" in r:
            row_of.setdefault((r["R"], r["B"], r["nk"], r["counts"]), r)
    launches = {}
    ctl = _p18_all(None, DEVICE, os.path.join(root, "control"))
    _p18_zero()
    golden_b = _p18_egress(None, DEVICE, os.path.join(root, "golden"),
                           kill=False)
    if ctl["b"]["files"] != golden_b["files"]:
        raise AssertionError("phase 18 (b): the unsharded control's part "
                             "files differ from the never-failed run's")
    unstamped = [(store, e) for store, eps in
                 ctl["c"]["index_digests"].items()
                 for e, d in eps.items() if d is None]
    if unstamped:
        raise AssertionError(f"phase 18 (c): the control's index leaves "
                             f"{unstamped} unstamped")
    for sub in "abcd":
        launches[f"mesh_storage_control_{sub}"] = ctl[sub]["launches"]
        log(f"[mesh-storage] control ({sub}): " + json.dumps(dict(
            _p18_line(ctl[sub]), device=dev_line), default=float))
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.empty_cache()
    ctx = dist_.initialize("file://" + os.path.join(root, "nccl1_rdv"), 1,
                           0, device=DEVICE,
                           backend="nccl" if torch.device(DEVICE).type
                           == "cuda" else "gloo")
    try:
        one = _p18_rank(ctx, root, "nccl1")
    finally:
        dist_.shutdown()
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.empty_cache()
    two = dist_.spawn(
        P18_RANK_TARGET, 2, {"root": root, "tag": "gloo2"}, device=DEVICE,
        backend="gloo", share_device=torch.device(DEVICE).type == "cuda",
        timeout_s=P18_RANK_TIMEOUT_S,
        workdir=os.path.join(root, "ranks-gloo2"))
    problems = []
    for name, res in (("nccl-1rank", [one]), ("gloo-2rank", two)):
        problems += _p18_check(name, res, ctl, golden_b, row_of)
        for r in res:
            for sub in "abcd":
                launches[f"mesh_storage_{name}_rank{r['rank']}_{sub}"] = \
                    r[sub]["launches"]
                log(f"[mesh-storage] {name} rank {r['rank']} ({sub}): "
                    + json.dumps(dict(_p18_line(r[sub]), device=dev_line),
                                 default=float))
            log(f"[mesh-storage] {name} rank {r['rank']} checked launches: "
                + json.dumps(dict(
                    max_abs_err=r["max_abs_err"],
                    checked_launches=r["checked_launches"],
                    shapes=[dict(R=s[0], B=s[1], nk=s[2], counts=s[3],
                                 phase2_label=row_of.get(s, {}).get("label"),
                                 device_ms=row_of.get(s, {}).get("device_ms"),
                                 bound_ms=row_of.get(s, {}).get("bound_ms"),
                                 library_ms=row_of.get(s, {})
                                 .get("library_ms"))
                            for s in r["shapes"]], device=dev_line),
                    default=float))
    log(f"[mesh-storage] phase 18: {time.monotonic() - t_phase:.1f} s "
        f"({dev_line})")
    if problems:
        raise AssertionError("phase 18: " + "; ".join(problems))
    return launches


# --- phase 19 ---------------------------------------------------------------

#: (c): the autoscaler's load at each drained fence: 8 -> 16, a hold in
#: its cooldown, 16 -> 8
P19_LOADS = (2.0, 2.0, 0.3)
#: seconds each rank of phase 19 may run
P19_RANK_TIMEOUT_S = 420
#: the rank function the two gloo ranks run (a rehearsal names its own)
P19_RANK_TARGET = "chip_smoke:_p19_rank"

PHASE19_REDUCTIONS = (
    "rebuilding and re-cutting a job on a mesh, each sub-phase on one NCCL "
    "rank, on two gloo ranks sharing the card and unsharded as its "
    f"control: the headline's and phase 15's widths ({PAR} sources x "
    f"{BATCH} records a step, {VOCAB} keys, {NUM_KEY_GROUPS} key groups, "
    f"edge capacity {EDGE_CAPACITY}, audit on) at phase 17's {MESH_SPE}-"
    f"step epochs of one {BLOCK_STEPS}-step block; (a) the "
    f"headline: one completed epoch and one pending, then the whole job "
    f"rebuilt by bootstrap_standby from the checkpoint directory and the "
    f"mirror rows, one epoch more; (b) restore_rescaled {PAR} -> "
    f"{RESCALE_UP} from the checkpoint the 2-rank mesh wrote after one "
    f"epoch, onto each run's ranks, two epochs; (c) rescale_live "
    f"{PAR} -> {RESCALE_UP} -> {PAR} by the autoscaler (loads "
    f"{list(P19_LOADS)}, sustain 1, cooldown 1), one epoch a fence, one "
    f"more; (d) phase 11's socket wordcount ({SOCKET_LINES} lines, one "
    f"connection, rank 0's reader for every rank), audit on, "
    f"logical_time=True (phase 11: the wall clock), so that each run's "
    f"ledger can equal its control's")


def _p19_rank_of(mesh):
    from clonos_tpu_torch.parallel import distributed as dist_
    return 0 if mesh is None else dist_.mesh_rank(mesh)


def _p19_mirror(logs):
    """Every log's live rows ``[tail, head)`` and its tail: a standby
    host's mirror at the dead runner's last fence (one host copy)."""
    from clonos_tpu_torch import device as _device
    rows, heads, tails = _device.HostCopy(
        (logs.rows, logs.head, logs.tail)).wait()
    cap = rows.shape[1]
    return {f: (rows[f][np.arange(int(tails[f]), int(heads[f])) & (cap - 1)],
                int(tails[f])) for f in range(rows.shape[0])}


def _p19_boot(mesh, device, root, checked):
    """(a) the headline, one completed epoch and one pending, its
    checkpoint directory and mirror rows; the whole job rebuilt by
    ``bootstrap_standby`` on the same ranks (timed), one more epoch
    (under ``checked``). Returns readings."""
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    ck = os.path.join(root, "ck")
    kw = dict(device=device, mesh=mesh, audit=True, **_mesh_kw())
    dead = ClusterRunner(build_job(), checkpoint_dir=ck, **kw)
    dead.run_epoch(complete_checkpoint=True)
    dead.run_epoch(complete_checkpoint=False)
    mirror = _p19_mirror(dead.executor.full_carry().logs)
    dead_digest = dead.state_digest()
    getattr(dead.coordinator.storage, "_close_ledger", lambda: None)()
    del dead
    sync()
    t0 = time.monotonic()
    boot, rep = ClusterRunner.bootstrap_standby(build_job(), ck, mirror,
                                                **kw)
    sync()
    wall = (time.monotonic() - t0) * 1e3
    rebuilt = boot.state_digest()
    with checked():
        boot.run_epoch(complete_checkpoint=True)
    out = dict(bootstrap_wall_ms=wall, recovery_ms=rep.recovery_ms,
               steps_replayed=rep.steps_replayed,
               managers=len(rep.managers),
               phase_ms={k: round(v, 3) for k, v in rep.phase_ms.items()},
               dead_digest=dead_digest, rebuilt_digest=rebuilt,
               ledger=(boot.coordinator.read_ledger() if boot.rank == 0
                       else None),
               digest=boot.state_digest())
    getattr(boot.coordinator.storage, "_close_ledger", lambda: None)()
    return out


def _p19_restore(mesh, device, ck, write, checked):
    """(b) with ``write``, the 2-rank mesh's one completed epoch at PAR
    keyed lanes into ``ck`` (rank 0 writes); then ``restore_rescaled``
    PAR -> RESCALE_UP from it onto ``mesh`` (rank 0 reads), timed, and
    two epochs, all under ``checked``. Returns readings."""
    from clonos_tpu_torch.parallel import distributed as dist_
    from clonos_tpu_torch.runtime.checkpoint import FileCheckpointStorage
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    kw = dict(device=device, audit=True, **_mesh_kw())
    me = _p19_rank_of(mesh)
    if write:
        w = ClusterRunner(build_rescale_job(PAR), mesh=mesh,
                          checkpoint_dir=ck, **kw)
        with checked():
            w.run_epoch(complete_checkpoint=True)
        getattr(w.coordinator.storage, "_close_ledger", lambda: None)()
        del w
        dist_.barrier(mesh)
    ckpt = None
    if me == 0:
        st = FileCheckpointStorage(ck)
        ckpt = st.read(max(st.completed_ids()))
    with checked():
        sync()
        t0 = time.monotonic()
        res = ClusterRunner.restore_rescaled(
            build_rescale_job(RESCALE_UP), build_rescale_job(PAR), ckpt,
            mesh=mesh, **kw)
        sync()
        restore_ms = (time.monotonic() - t0) * 1e3
        # A planned restart starts a fresh epoch 0; logical time resumes
        # at the fence (phase 15 (a)).
        res.executor.step_input_history = [(0, 0)] * MESH_SPE
        for _ in range(2):
            res.run_epoch(complete_checkpoint=True)
    return dict(restore_ms=restore_ms, ranks=1 if mesh is None
                else dist_.mesh_size(mesh),
                ledger=res.auditor.ledger() if me == 0 else None,
                digest=res.state_digest())


def _p19_live(mesh, device, root, checked):
    """(c) the rescale job at PAR keyed lanes, one completed epoch a
    drained fence, the autoscaler deciding on rank 0 at each on
    P19_LOADS (every rank executing its re-cut at the same fence: the
    fence stall timed), one more epoch; the first epoch after each
    re-cut under ``checked``. Returns readings."""
    from clonos_tpu_torch.autoscale import (AutoscaleController,
                                            PolicyConfig, ScalePolicy,
                                            ScaleSignals)
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    kw = dict(device=device, audit=True,
              checkpoint_dir=os.path.join(root, "ck"), **_mesh_kw())
    state = {"r": ClusterRunner(build_rescale_job(PAR), mesh=mesh, **kw)}
    recuts = []

    def execute(target):
        sync()
        t0 = time.monotonic()
        new, stats = state["r"].rescale_live(build_rescale_job(target),
                                             **kw)
        sync()
        recuts.append(dict(target=target,
                           stall_ms=(time.monotonic() - t0) * 1e3,
                           migrate_ms=stats["migrate_ms"],
                           drained_records=stats["drained_records"],
                           groups=stats["groups"]))
        state["r"] = new
    ctl = AutoscaleController(
        ScalePolicy(PolicyConfig(sustain_fences=1, cooldown_fences=1,
                                 max_step=PAR, min_workers=PAR,
                                 max_workers=RESCALE_UP)),
        execute_workers=execute, healthy=lambda: not state["r"].failed,
        mesh=mesh)
    seen = 0
    for load in P19_LOADS + (None,):
        # The first epoch after a re-cut: every launch against the plain
        # version.
        with (checked() if len(recuts) > seen else
              contextlib.nullcontext()):
            state["r"].run_epoch(complete_checkpoint=True)
        seen = len(recuts)
        live = state["r"]
        live.drain_fence()
        if load is not None:
            e = live.executor.epoch_id - 1
            ctl.on_fence(e, ScaleSignals(
                epoch=e, load=load,
                workers=live.job.vertices[1].parallelism))
    ctl.close()
    out = dict(recuts=recuts, decisions=len(ctl.log),
               ledger=(live.coordinator.read_ledger() if live.rank == 0
                       else None),
               digest=live.state_digest())
    getattr(live.coordinator.storage, "_close_ledger", lambda: None)()
    return out


def _p19_socket(mesh, device, port, checked):
    """(d) phase 11's socket wordcount on ``mesh``: rank 0 alone opens
    the connection (drained first) and its reader serves every rank; the
    first epoch under ``checked``, the window subtask killed mid-epoch
    and recovered (its re-read from rank 0's retention), then epochs
    until every line is read. Returns readings, with the source
    records/s over the drive's wall."""
    from clonos_tpu_torch.api.feeds import SocketFeedReader
    from clonos_tpu_torch.examples import wordcount as wc
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    me = _p19_rank_of(mesh)
    reader = None
    if me == 0:
        reader = SocketFeedReader("127.0.0.1", port)
        reader._thread.join(timeout=120)
        if reader._thread.is_alive():
            raise AssertionError("(d) the socket feed did not drain")
    r = ClusterRunner(wc.build_socket_job(), steps_per_epoch=WC_SPE,
                      seed=WC_SEED, device=device, mesh=mesh, audit=True,
                      logical_time=True)
    r.executor.register_feed(0, reader)
    window = r.job.subtask_base(1)
    source = ((lambda: int(_mesh_counts(r)[0])) if mesh is not None
              else (lambda: int(r.executor.carry.record_counts[0])))
    sync()
    t0 = time.monotonic()
    with checked():
        r.run_epoch(complete_checkpoint=True)
    for _ in range(SOCKET_KILL_AT):
        r.step()
    before = r.state_digest()
    r.inject_failure([window])
    rep = r.recover()
    after = r.state_digest()
    epochs = 1
    while source() < SOCKET_LINES and epochs < 2 * SOCKET_LINES // (
            64 * WC_SPE):
        r.run_epoch(complete_checkpoint=True)
        epochs += 1
    sync()
    wall = time.monotonic() - t0
    n = source()
    out = dict(source_records=n, records_per_s=n / wall, epochs=epochs,
               steps_replayed=rep.steps_replayed,
               recovery_ms=rep.recovery_ms, before=before, after=after,
               bases=(list(reader._r._base) if reader is not None
                      else None),
               ledger=r.auditor.ledger() if me == 0 else None,
               digest=r.state_digest())
    if reader is not None:
        reader.close()
    return out


def _p19_all(mesh, device, root, ck_b, write_b, port, checked):
    """(a)-(d) on ``mesh`` (None: the unsharded control), each with the
    kernel's launch counts at 0 just before it and read just after.
    Returns {sub-phase: readings}."""
    out = {}
    for name, fn in (
            ("a", lambda: _p19_boot(mesh, device, os.path.join(root, "a"),
                                    checked)),
            ("b", lambda: _p19_restore(mesh, device, ck_b, write_b,
                                       checked)),
            ("c", lambda: _p19_live(mesh, device, os.path.join(root, "c"),
                                    checked)),
            ("d", lambda: _p19_socket(mesh, device, port, checked))):
        _p18_zero()
        t = time.monotonic()
        out[name] = fn()
        sync()
        out[name]["launches"] = _p18_launches()
        out[name]["seconds"] = time.monotonic() - t
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def _p19_rank(ctx, root, tag, ck_b, port):
    """One rank of a phase 19 mesh: (a)-(d), every keyed_hist launch of
    (a)'s epoch after the rebuild, of (b), of (c)'s first epoch after
    each re-cut and of (d)'s first epoch held against the plain version;
    a 2-rank mesh writes (b)'s checkpoint."""
    from clonos_tpu_torch.parallel import distributed as dist_
    mesh = dist_.task_mesh(device=ctx.device)
    shapes = []
    out = _p19_all(mesh, ctx.device, os.path.join(root, tag), ck_b,
                   ctx.num_processes > 1, port,
                   lambda: _checked_everywhere(shapes))
    out["shapes"] = sorted({s[:4] for s in shapes})
    out["max_abs_err"] = max((s[4] for s in shapes), default=None)
    out["checked_launches"] = len(shapes)
    out["rank"] = ctx.process_id
    out["backend"] = ctx.backend
    return out


def _p19_check(name, res, ctl, row_of):
    """Every equality of phase 19 for one mesh run; returns the problems
    found."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    problems = []
    lead = res[0]
    for sub in "abcd":
        d = diff_ledgers(ctl[sub]["ledger"], lead[sub]["ledger"])
        if d or len(lead[sub]["ledger"]) != len(ctl[sub]["ledger"]):
            problems.append(f"{name} ({sub}): ledger differs from the "
                            f"control's: {d[:3]}")
        for r in res:
            if r[sub]["digest"] != ctl[sub]["digest"]:
                problems.append(f"{name} rank {r['rank']} ({sub}): state "
                                f"digest differs from the control's")
            if _hist_silent(r[sub]["launches"]):
                problems.append(f"{name} rank {r['rank']} ({sub}): a kernel "
                                f"was not launched: {r[sub]['launches']}")
    for r in res:
        a, c, d = r["a"], r["c"], r["d"]
        if a["rebuilt_digest"] != a["dead_digest"] \
                or a["rebuilt_digest"] != ctl["a"]["rebuilt_digest"] \
                or a["steps_replayed"] != MESH_SPE:
            problems.append(f"{name} rank {r['rank']} (a): the rebuild "
                            f"(replayed {a['steps_replayed']}) != the dead "
                            f"runner's state")
        if [x["target"] for x in c["recuts"]] != [RESCALE_UP, PAR]:
            problems.append(f"{name} rank {r['rank']} (c): re-cuts "
                            f"{c['recuts']}")
        if d["source_records"] != SOCKET_LINES or d["before"] != d["after"]:
            problems.append(f"{name} rank {r['rank']} (d): {d['source_records']}"
                            f" records, digest kept {d['before'] == d['after']}")
        if r["max_abs_err"] != 0 or not r["checked_launches"]:
            problems.append(f"{name} rank {r['rank']}: kernel vs plain max "
                            f"abs err {r['max_abs_err']} over "
                            f"{r['checked_launches']} launches")
        for s in r["shapes"]:
            if s not in row_of:
                problems.append(f"{name}: launched shape {s} has no phase "
                                f"2 row")
    if lead["c"]["decisions"] != ctl["c"]["decisions"] \
            or any(r["c"]["decisions"] for r in res[1:]):
        problems.append(f"{name} (c): decisions logged "
                        f"{[r['c']['decisions'] for r in res]}")
    if lead["d"]["bases"] != ctl["d"]["bases"] or any(
            r["d"]["bases"] is not None for r in res[1:]):
        problems.append(f"{name} (d): committed offsets "
                        f"{[r['d']['bases'] for r in res]} != the control's "
                        f"{ctl['d']['bases']}")
    return problems


def _p19_line(reading):
    """A sub-phase's readings as printed: no ledger or digests."""
    return {k: v for k, v in reading.items()
            if k not in ("ledger", "digest", "dead_digest",
                         "rebuilt_digest", "before", "after")}


def _p19_lines():
    rng = np.random.RandomState(SOCKET_SEED)
    from clonos_tpu_torch.examples import wordcount as wc
    keys = rng.randint(0, wc.VOCAB, SOCKET_LINES)
    vals = rng.randint(1, 10, SOCKET_LINES)
    return "".join(f"{k}:{v}\n" for k, v in zip(keys, vals)).encode()


def phase_mesh_rebuild(dev_line, root, rows):
    """(a) a standby bootstrap, (b) a re-cut restore 8 -> 16 from a 2-rank
    mesh's checkpoint, (c) a live 8 -> 16 -> 8 round trip by the
    autoscaler, (d) the socket wordcount with one reader, each on one
    NCCL rank and on two gloo ranks sharing the card, against an
    unsharded control: sealed ledgers, state digests, committed offsets
    equal. Every keyed_hist launch of (a)'s epoch after the rebuild, of
    (b), of (c)'s first epoch after each re-cut and of (d)'s first epoch
    on each rank equals its plain version, and each launched shape has a
    phase 2 row. Returns {path: launches}."""
    from clonos_tpu_torch.parallel import distributed as dist_
    t_phase = time.monotonic()
    row_of = {}
    for r in rows:               # the first timed row of each shape
        if "ms" in r:
            row_of.setdefault((r["R"], r["B"], r["nk"], r["counts"]), r)
    launches = {}
    ck_b = os.path.join(root, "b-ck")
    payload = _p19_lines()
    cuda = torch.device(DEVICE).type == "cuda"
    # The two gloo ranks first: their (b) writes the checkpoint the
    # control and the NCCL rank restore too.
    two = dist_.spawn(
        P19_RANK_TARGET, 2, {"root": root, "tag": "gloo2", "ck_b": ck_b,
                             "port": _serve_lines(payload)[0]},
        device=DEVICE, backend="gloo", share_device=cuda,
        timeout_s=P19_RANK_TIMEOUT_S,
        workdir=os.path.join(root, "ranks-gloo2"))
    ctl = _p19_all(None, DEVICE, os.path.join(root, "control"), ck_b, False,
                   _serve_lines(payload)[0], contextlib.nullcontext)
    for sub in "abcd":
        launches[f"mesh_rebuild_control_{sub}"] = ctl[sub]["launches"]
        log(f"[mesh-rebuild] control ({sub}): " + json.dumps(dict(
            _p19_line(ctl[sub]), device=dev_line), default=float))
    if ctl["a"]["rebuilt_digest"] != ctl["a"]["dead_digest"]:
        raise AssertionError("phase 19 (a): the control's rebuild != its "
                             "dead runner's state")
    if cuda:
        torch.cuda.empty_cache()
    ctx = dist_.initialize("file://" + os.path.join(root, "nccl1_rdv"), 1,
                           0, device=DEVICE,
                           backend="nccl" if cuda else "gloo")
    try:
        one = _p19_rank(ctx, root, "nccl1", ck_b, _serve_lines(payload)[0])
    finally:
        dist_.shutdown()
    if cuda:
        torch.cuda.empty_cache()
    problems = []
    for name, res in (("nccl-1rank", [one]), ("gloo-2rank", two)):
        problems += _p19_check(name, res, ctl, row_of)
        for r in res:
            for sub in "abcd":
                launches[f"mesh_rebuild_{name}_rank{r['rank']}_{sub}"] = \
                    r[sub]["launches"]
                log(f"[mesh-rebuild] {name} rank {r['rank']} ({sub}): "
                    + json.dumps(dict(_p19_line(r[sub]), device=dev_line),
                                 default=float))
            log(f"[mesh-rebuild] {name} rank {r['rank']} checked launches: "
                + json.dumps(dict(
                    max_abs_err=r["max_abs_err"],
                    checked_launches=r["checked_launches"],
                    shapes=[dict(R=s[0], B=s[1], nk=s[2], counts=s[3],
                                 phase2_label=row_of.get(s, {}).get("label"),
                                 device_ms=row_of.get(s, {}).get("device_ms"),
                                 bound_ms=row_of.get(s, {}).get("bound_ms"),
                                 library_ms=row_of.get(s, {})
                                 .get("library_ms"))
                            for s in r["shapes"]], device=dev_line),
                    default=float))
    log("[mesh-rebuild] readings: " + json.dumps(dict(
        bootstrap={n: dict(wall_ms=x[0]["a"]["bootstrap_wall_ms"],
                           phase_ms=x[0]["a"]["phase_ms"])
                   for n, x in (("control", [ctl]), ("nccl-1rank", [one]),
                                ("gloo-2rank", two))},
        recut_stall_ms={n: [[c["stall_ms"] for c in r["c"]["recuts"]]
                            for r in x]
                        for n, x in (("control", [ctl]), ("nccl-1rank", [one]),
                                     ("gloo-2rank", two))},
        socket_records_per_s={n: x[0]["d"]["records_per_s"]
                              for n, x in (("control", [ctl]),
                                           ("nccl-1rank", [one]),
                                           ("gloo-2rank", two))},
        phase11_socket_records_per_s=PHASE11_RECORDS_PER_S,
        device=dev_line), default=float))
    log(f"[mesh-rebuild] phase 19: {time.monotonic() - t_phase:.1f} s "
        f"({dev_line})")
    if problems:
        raise AssertionError("phase 19: " + "; ".join(problems))
    return launches


# --- phase 20 ---------------------------------------------------------------

#: (a)'s bound: the reference's slow full-depth sweep
VERIFY_BIG_BOUND = dict(workers=3, epochs=3, faults=2, depth=64,
                        max_states=500_000)
#: (b)'s soak clock and the bait's fire time (``write_counterexample``'s
#: ``start_s``, the reference's live test's), inside the first soak epoch
VERIFY_BAIT_S = 6.0
VERIFY_BAIT_START_S = 1.5
#: (c)'s soak clock (two completed fences after the first), and how long
#: before the first soak epoch would close at the offered rate the 2 s
#: spike starts: the loop then runs at about its capacity, twice that
#: rate, and the epoch closes (the autoscaler's first completed fence)
#: about 1 s into the spike (no earlier than 0.5 s, the bridge's default)
VERIFY_LOOP_S = 18.0
VERIFY_SPIKE_LEAD_S = 2.0
#: (c)'s policy: the scale-policy model's sustain (1) and cooldown (2)
#: fences, workers between 4 and 16, one step 8 -> 16
VERIFY_POLICY = dict(sustain_fences=1, cooldown_fences=2, min_workers=4,
                     max_workers=16, max_step=8)
VERIFY_TRACES = 20

PHASE20_REDUCTIONS = (
    f"(a) the six protocol models at workers={VERIFY_BIG_BOUND['workers']} "
    f"epochs={VERIFY_BIG_BOUND['epochs']} faults="
    f"{VERIFY_BIG_BOUND['faults']} depth={VERIFY_BIG_BOUND['depth']} "
    f"max_states={VERIFY_BIG_BOUND['max_states']}, clean and with each "
    f"seeded bug; (b) checkpoint:unlogged-write's counterexample "
    f"(write_counterexample start_s={VERIFY_BAIT_START_S:g}) through "
    f"phase 16's runner trio and widths for {VERIFY_BAIT_S:g} s at phase "
    f"16's rate, and the same with an empty schedule; (c) "
    f"scalepolicy:no-cooldown's load-spike schedule (start_s "
    f"{VERIFY_SPIKE_LEAD_S:g} s before the first soak epoch would close "
    f"at that rate) for {VERIFY_LOOP_S:g} s with the "
    f"autoscaler at the model's sustain and cooldown ({VERIFY_POLICY}); "
    f"(d) conformance, {VERIFY_TRACES} model traces a component")


def _capture_first_chunk(runner, calls):
    """Record, as (kernel?, keys, vals, valid, nk, counts, sums, counts
    out), every keyed_hist call ``runner``'s first paced chunk makes: the
    soak driver's warmup steps one epoch (``SOAK_SPE`` calls of
    ``step()``) before its clock starts, so calls ``SOAK_SPE`` ..
    ``SOAK_SPE + SOAK_CHUNK - 1`` are the first chunk."""
    inner = runner.step
    n = [0]

    def step(*a, **k):
        i = n[0]
        n[0] += 1
        if not SOAK_SPE <= i < SOAK_SPE + SOAK_CHUNK:
            return inner(*a, **k)
        return _recorded(lambda: inner(*a, **k), calls)
    runner.step = step


def _recorded(fn, calls):
    """Run ``fn`` recording, as (kernel?, keys, vals, valid, nk, counts,
    sums, counts out), every keyed_hist call it makes."""
    from clonos_tpu_torch.ops import histogram as hist

    def recording(orig, kernel):
        def call(keys, vals, valid, nk, want_counts=True):
            out = orig(keys, vals, valid, nk, want_counts)
            calls.append((kernel, keys.clone(), vals.clone(), valid.clone(),
                          nk, want_counts, out[0].clone(),
                          None if out[1] is None else out[1].clone()))
            return out
        return call

    saved = hist.keyed_hist_cuda, hist.keyed_hist_plain
    hist.keyed_hist_cuda = recording(saved[0], True)
    hist.keyed_hist_plain = recording(saved[1], False)
    try:
        return fn()
    finally:
        hist.keyed_hist_cuda, hist.keyed_hist_plain = saved


def _first_chunk_reading(calls):
    """The recorded calls against ``keyed_hist_plain`` on their inputs."""
    from clonos_tpu_torch.ops.histogram import keyed_hist_plain
    err = 0
    for _kernel, keys, vals, valid, nk, counts, s_k, c_k in calls:
        s_p, c_p = keyed_hist_plain(keys, vals, valid, nk, counts)
        err = max(err, int((s_k.to(torch.int64)
                            - s_p.to(torch.int64)).abs().max()))
        if counts:
            err = max(err, int((c_k.to(torch.int64)
                                - c_p.to(torch.int64)).abs().max()))
    return dict(calls=len(calls),
                kernel_calls=sum(1 for c in calls if c[0]),
                shapes=sorted({(c[1].shape[0], c[1].shape[1], c[4], c[5])
                               for c in calls}),
                max_abs_err=err)


def _thrash(executed, cooldown):
    """The model's no-thrash on executed worker re-cuts (in order):
    opposite directions at least ``cooldown`` decisions apart; returns the
    offending pairs."""
    out = []
    for a, b in zip(executed, executed[1:]):
        if (a["delta"] > 0) != (b["delta"] > 0) \
                and b["seq"] - a["seq"] < cooldown:
            out.append((a, b))
    return out


def phase_verify(dev_line, root, rows, rate):
    """(a) the model checker's big bound, clean and with every seeded bug;
    (b) a model counterexample (an unlogged write) replayed by the soak at
    phase 16's widths must fail the audit, and the same run with an empty
    schedule must pass exactly once; (c) the scale-policy counterexample's
    load spike replayed with the real autoscaler: it re-cuts, with no
    thrash, every executed decision in the SCALE log, exactly-once output;
    (d) the six components against the models. Every keyed_hist shape of
    (b) and (c) must have a phase 2 row (``rows``; None skips the check),
    and the first chunk of (b)'s empty-schedule run must equal the plain
    version.
    ``rate`` is phase 16's offered rate. Returns the phase's kernel
    launches and each soak verdict's ``census_fingerprint`` (phase 21
    (c) holds them to the port's pin)."""
    from clonos_tpu_torch import verify as v
    from clonos_tpu_torch.autoscale import (AutoscaleController,
                                            DecisionLog, PolicyConfig,
                                            ScalePolicy)
    from clonos_tpu_torch.obs import audit as audit_mod
    from clonos_tpu_torch.soak import (ChaosSchedule, SLOSpec, SoakConfig,
                                       SoakDriver)
    from clonos_tpu_torch.soak.chaos import (parse_schedule,
                                             read_trace_schedule)
    from clonos_tpu_torch.verify.conformance import run_conformance
    t_phase = time.monotonic()
    problems = []
    readings = {}

    # (a) the big bound: every model clean, every seeded bug caught
    t = time.monotonic()
    models = {}
    for name in sorted(v.MODELS):
        t0 = time.monotonic()
        (rep,) = v.run_verify(models=[name], **VERIFY_BIG_BOUND).reports
        models[name] = dict(states=rep.states, transitions=rep.transitions,
                            depth=rep.depth, truncated=rep.truncated,
                            violations=len(rep.violations),
                            s=round(time.monotonic() - t0, 3))
        if not rep.ok or rep.truncated:
            problems.append(f"(a) {name}: {models[name]} "
                            f"{[x.to_dict() for x in rep.violations][:1]}")
    if models["checkpoint"]["states"] <= 5000:
        problems.append(f"(a) checkpoint explored only "
                        f"{models['checkpoint']['states']} states")
    bugs = {}
    for model in sorted(v.BUGS):
        for bug in sorted(v.BUGS[model]):
            t0 = time.monotonic()
            rb = v.run_verify(models=[model], bugs={model: bug},
                              **VERIFY_BIG_BOUND)
            first = rb.violations[0] if rb.violations else None
            bugs[f"{model}:{bug}"] = dict(
                caught=not rb.ok,
                invariant=first.invariant if first else None,
                trace_steps=len(first.trace) if first else None,
                s=round(time.monotonic() - t0, 3))
            if rb.ok:
                problems.append(f"(a) {model}:{bug} escaped the big bound")
    readings["a"] = dict(bound=VERIFY_BIG_BOUND, models=models, bugs=bugs,
                         s=round(time.monotonic() - t, 3))

    # the two counterexamples, through the bridge's files
    ce_dir = os.path.join(root, "counterexamples")
    bait = v.run_verify(models=["checkpoint"], quick=True,
                        bugs={"checkpoint": "unlogged-write"}).violations[0]
    spike = v.run_verify(models=["scalepolicy"], quick=True,
                         bugs={"scalepolicy": "no-cooldown"}).violations[0]
    epoch_s = SOAK_SPE * PAR * BATCH / rate
    schedules = {}
    for key, viol, start_s, kinds in (
            ("b", bait, VERIFY_BAIT_START_S, ["nondet"]),
            ("c", spike, max(0.5, round(epoch_s - VERIFY_SPIKE_LEAD_S, 3)),
             ["load-spike"])):
        out = v.write_counterexample(ce_dir, viol, start_s=start_s)
        sched = read_trace_schedule(out["trace"])
        with open(out["chaos"]) as f:
            from_chaos = parse_schedule(f.read())
        if sched.kinds() != kinds or from_chaos != sched:
            problems.append(f"({key}) {viol.model}:{viol.invariant} "
                            f"compiled to {sched.to_text()!r}, its .chaos "
                            f"file to {from_chaos.to_text()!r}")
        schedules[key] = sched
    if bait.invariant != "exactly-once-logged" \
            or spike.invariant != "no-thrash":
        problems.append(f"counterexamples {bait.invariant}, "
                        f"{spike.invariant}")

    first_chunk = []
    prewarms = []

    def soak(sub, schedule, duration, autoscaler=None, capture=False):
        runner, control, election = _soak_trio(root, sub, [])
        if capture:
            _capture_first_chunk(runner, first_chunk)
        driver = SoakDriver(
            runner, SoakConfig(rate=rate, duration_s=duration,
                               window_s=SOAK_WINDOW_S,
                               chunk_steps=SOAK_CHUNK,
                               complete_every=SOAK_COMPLETE_EVERY),
            schedule=schedule, spec=SLOSpec(exactly_once=True),
            control=control, election=election,
            records_per_step=PAR * BATCH, autoscaler=autoscaler)
        verdict = driver.run()
        prewarms.append(driver.prewarm_s)
        cross = audit_mod.diff_ledgers_cross(
            driver.harness.control.auditor.ledger(),
            driver.runner.auditor.ledger())
        del driver, runner, control
        torch.cuda.empty_cache()
        return verdict, cross

    executed = []
    ctl = AutoscaleController(
        ScalePolicy(PolicyConfig(**VERIFY_POLICY)),
        log=DecisionLog(os.path.join(root, "c-scale.det")))
    on_fence = ctl.on_fence

    def logged_on_fence(epoch, signals):
        decision, done = on_fence(epoch, signals)
        if done is not None:
            executed.append(done.to_dict())
        return decision, done
    ctl.on_fence = logged_on_fence

    def run():
        bait_v, bait_cross = soak("b-bait", schedules["b"], VERIFY_BAIT_S)
        ctl_v, ctl_cross = soak("b-control", ChaosSchedule([]),
                                VERIFY_BAIT_S, capture=True)
        loop_v, loop_cross = soak("c", schedules["c"], VERIFY_LOOP_S,
                                  autoscaler=ctl)
        return bait_v, bait_cross, ctl_v, ctl_cross, loop_v, loop_cross

    t = time.monotonic()
    (out, shapes), launches, _ = _counted(lambda: _launch_shapes(run))
    bait_v, bait_cross, ctl_v, ctl_cross, loop_v, loop_cross = out
    soak_s = time.monotonic() - t

    # (b) the bait fails the audit; the empty schedule passes exactly once
    if not (bait_v["pass"] is False
            and bait_v["audit"]["exactly_once"] is False
            and bait_v["audit"]["divergences"]):
        problems.append(f"(b) the counterexample passed the audit: "
                        f"{_soak_verdict_line(bait_v)}")
    if not (ctl_v["pass"] and ctl_v["audit"]["exactly_once"] is True
            and not ctl_v["audit"]["divergences"]
            and ctl_v["audit"]["epochs_checked"] > 0 and not ctl_cross):
        problems.append(f"(b) the empty schedule failed: "
                        f"{_soak_verdict_line(ctl_v)}, cross diff "
                        f"{ctl_cross[:3]}")
    chunk = _first_chunk_reading(first_chunk)
    cuda = torch.device(DEVICE).type == "cuda"
    if chunk["max_abs_err"] != 0 or not chunk["calls"] \
            or (cuda and chunk["kernel_calls"] != chunk["calls"]):
        problems.append(f"(e) the control's first chunk against "
                        f"keyed_hist_plain: {chunk}")
    del first_chunk[:]
    readings["b"] = dict(
        schedule=schedules["b"].to_text(),
        bait=dict(_soak_verdict_line(bait_v),
                  divergences=bait_v["audit"]["divergences"][:2],
                  cross_diff=len(bait_cross)),
        control=dict(_soak_verdict_line(ctl_v), cross_diff=ctl_cross),
        rate=round(rate, 1), first_chunk=chunk)

    # (c) the real controller holds the cooldown the model's bug drops
    a = loop_v["autoscale"]
    records = ctl.log.records
    logged = [r["decision"] for r in records]
    unlogged = [d for d in executed if d not in logged]
    workers = [d for d in executed if d["action"] == "scale-workers"]
    thrash = _thrash(workers, VERIFY_POLICY["cooldown_fences"])
    if thrash or unlogged or a["max_actions_per_cooldown"] > 1 \
            or not workers:
        problems.append(f"(c) thrash {thrash}, executed but not logged "
                        f"{unlogged}, no re-cut {not workers}, autoscale "
                        f"{a}")
    if not (loop_v["audit"]["exactly_once"] is True
            and not loop_v["audit"]["divergences"] and not loop_cross):
        problems.append(f"(c) {_soak_verdict_line(loop_v)}, cross diff "
                        f"{loop_cross[:3]}")
    readings["c"] = dict(
        _soak_verdict_line(loop_v), schedule=schedules["c"].to_text(),
        epoch_s=round(epoch_s, 3), decisions=a["decisions"],
        by_action=a["by_action"],
        reasons=[r["decision"]["reason"] for r in records],
        executed=[dict(seq=d["seq"], epoch=d["epoch"], delta=d["delta"],
                       target_workers=d["target_workers"])
                  for d in executed],
        loads=[r["signals"]["load"] for r in records],
        autoscale_rescales=a["autoscale_rescales"],
        max_actions_per_cooldown=a["max_actions_per_cooldown"],
        rescale_stats=a["rescale_stats"], log_digest=a["log_digest"],
        cross_diff=loop_cross)
    readings["soak_s"] = round(soak_s, 3)

    # (d) the port's six components against the models
    t = time.monotonic()
    lease_dir = os.path.join(root, "lease")
    os.makedirs(lease_dir, exist_ok=True)
    conf = run_conformance(n_traces=VERIFY_TRACES, workdir=lease_dir)
    readings["d"] = dict(
        {c: dict(traces=r.traces, steps=r.steps, ok=r.ok)
         for c, r in sorted(conf.items())},
        s=round(time.monotonic() - t, 3))
    for c, r in sorted(conf.items()):
        if not r.ok or r.traces == 0:
            problems.append(f"(d) {c}: "
                            f"{[d.to_dict() for d in r.divergences][:1]}")

    # (e) every launched shape was held against the plain version
    held = {(r["R"], r["B"], r["nk"], r["counts"]) for r in rows or ()}
    missing = [s for s in shapes if s not in held]
    if rows is not None and missing:
        problems.append(f"(e) launch shapes without a phase 2 row: "
                        f"{missing}")
    if _hist_silent(launches):
        problems.append(f"no kernel launch: {launches}")
    readings["e"] = dict(launch_shapes=[list(x) for x in shapes],
                         launches=launches)
    for part in ("a", "b", "c", "d", "e"):
        log(f"[verify] ({part}) " + json.dumps(dict(
            readings[part], device=dev_line), default=float))
    log(f"[verify] prewarm_recovery() in the soak driver, each soak run: "
        f"{prewarms} s ({dev_line})")
    log(f"[verify] phase 20: {time.monotonic() - t_phase:.1f} s (soak "
        f"{readings['soak_s']} s), kernel launches {json.dumps(launches)} "
        f"({dev_line})")
    if problems:
        raise AssertionError("phase 20: " + "; ".join(problems))
    return launches, {"b-bait": bait_v["census_fingerprint"],
                      "b-control": ctl_v["census_fingerprint"],
                      "c": loop_v["census_fingerprint"]}


# --- phase 21 ---------------------------------------------------------------

#: (b) bench.py's ablation probe on the headline job: 512-step epochs,
#: 256-step blocks, seed 7, logical time, one warm-up epoch then 3 timed
ABLATE_SPE = 512
ABLATE_BLOCK = 256
ABLATE_SEED = 7
ABLATE_EPOCHS = 3
#: the FT call sites the transform must strip from the port's executor
ABLATE_SITES = 9

PHASE21_REDUCTIONS = (
    f"(a) `lint --report json` and `analyze --report json --no-census "
    f"--expect-census/--expect-threads` on the port's sources; (b) the "
    f"headline job at full width, {ABLATE_SPE}-step epochs, "
    f"{ABLATE_BLOCK}-step blocks, seed {ABLATE_SEED}, logical time, one "
    f"warm-up epoch and {ABLATE_EPOCHS} timed epochs for the executor "
    f"and for its no-FT twin in turn; (c) phase 20's three soak "
    f"verdicts")


def _verb_json(args):
    """``python -m clonos_tpu_torch <args>`` from the repo root: (exit
    code, seconds, its last stdout line parsed, stderr tail)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "clonos_tpu_torch", *args],
                          cwd=repo, env=env, capture_output=True, text=True,
                          timeout=600)
    seconds = time.monotonic() - t
    lines = proc.stdout.strip().splitlines()
    try:
        doc = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        doc = None
    return proc.returncode, seconds, doc, proc.stderr[-2000:]


def _ablation_drive(ex_mod, check_plain):
    """The headline job on ``ex_mod.LocalExecutor``: one warm-up epoch
    (with ``check_plain``, every keyed_hist launch in it held against
    ``keyed_hist_plain`` on its inputs), then ``ABLATE_EPOCHS`` timed
    epochs, each ended by a device sync. Returns (timed seconds, the
    leaves of states, edge buffers, record counts and the last epoch's
    sinks, log head, ring heads, subtasks, rings, plain check)."""
    from clonos_tpu_torch.ops import histogram as hist
    from clonos_tpu_torch.utils.tree import tree_leaves
    job = build_job()
    need = (ABLATE_EPOCHS + 1) * ABLATE_SPE * DETS_PER_STEP
    ex = ex_mod.LocalExecutor(
        job, steps_per_epoch=ABLATE_SPE,
        log_capacity=1 << need.bit_length(), max_epochs=16,
        inflight_ring_steps=1 << (ABLATE_SPE - 1).bit_length(),
        block_steps=ABLATE_BLOCK, seed=ABLATE_SEED, logical_time=True,
        device=DEVICE)
    check = dict(calls=0, kernel_calls=0, max_abs_err=0, shapes=set())
    saved = hist.keyed_hist_cuda, hist.keyed_hist_plain

    def held(orig, kernel):
        def call(keys, vals, valid, nk, want_counts=True):
            out = orig(keys, vals, valid, nk, want_counts)
            s_p, c_p = saved[1](keys, vals, valid, nk, want_counts)
            err = int((out[0].to(torch.int64)
                       - s_p.to(torch.int64)).abs().max())
            if want_counts:
                err = max(err, int((out[1].to(torch.int64)
                                    - c_p.to(torch.int64)).abs().max()))
            check["calls"] += 1
            check["kernel_calls"] += kernel
            check["max_abs_err"] = max(check["max_abs_err"], err)
            check["shapes"].add((keys.shape[0], keys.shape[1], nk,
                                 bool(want_counts)))
            return out
        return call

    if check_plain:
        hist.keyed_hist_cuda = held(saved[0], True)
        hist.keyed_hist_plain = held(saved[1], False)
    try:
        ex.run_epoch()
    finally:
        hist.keyed_hist_cuda, hist.keyed_hist_plain = saved
    sync()
    t0 = time.monotonic()
    outs = None
    for _ in range(ABLATE_EPOCHS):
        outs = ex.run_epoch()
        sync()
    seconds = time.monotonic() - t0
    leaves = [x.detach().clone() for x in tree_leaves(
        (ex.carry.op_states, ex.carry.edge_bufs, ex.carry.record_counts,
         outs.sinks))]
    log_head = int(ex.carry.logs.head.max())
    ring_heads = [int(r.head.max()) for r in ex.carry.out_rings]
    subtasks, rings = job.total_subtasks(), len(ex.carry.out_rings)
    check["shapes"] = sorted(check["shapes"])
    del ex, job
    return seconds, leaves, log_head, ring_heads, subtasks, rings, check


def phase_analysis(dev_line, verdict_census):
    """(a) the ``lint`` and ``analyze`` verbs on this machine: both exit
    0 and both fingerprints equal the port's pins; (b) the no-FT twin
    (``analysis/ablate.py``) against the executor at the headline's full
    width, ``bench.py``'s ablation probe: outputs bit-identical, the
    twin's log head 0 while the real one advances, 9 stripped sites, the
    twin's warm-up launches equal to the plain version, and the measured
    and static ft-fractions printed (readings, not a claim); (c) phase
    20's soak verdicts carry the port's census fingerprint. Returns the
    kernel launches of (b)'s two runs together."""
    from clonos_tpu_torch.analysis import (ablated_executor, build_census,
                                           static_cost_model)
    from clonos_tpu_torch.analysis.census import (CENSUS_PIN, THREADS_PIN,
                                                  _repo_contexts,
                                                  fingerprint, read_pin)
    from clonos_tpu_torch.runtime import executor as real_ex
    t_phase = time.monotonic()
    problems = []
    pins = {"census": read_pin(CENSUS_PIN), "threads": read_pin(THREADS_PIN)}

    # (a) the verbs
    verbs = {}
    for name, args in (
            ("lint", ["lint", "--report", "json"]),
            ("analyze", ["analyze", "--report", "json", "--no-census",
                         "--expect-census", "clonos_tpu_torch/.clonos-census",
                         "--expect-threads",
                         "clonos_tpu_torch/.clonos-threads"])):
        rc, seconds, doc, err = _verb_json(args)
        verbs[name] = dict(rc=rc, s=round(seconds, 3),
                           errors=doc and doc.get("errors"),
                           waived=doc and doc.get("waived"),
                           files=doc and doc.get("files"))
        if rc != 0 or not doc or doc.get("ok") is not True:
            problems.append(f"(a) {name}: exit {rc}, {verbs[name]}, "
                            f"stderr {err!r}")
        if name == "analyze" and doc:
            verbs[name].update(census=doc.get("census_fingerprint"),
                               threads=doc.get("threads_fingerprint"))
            if (doc.get("census_fingerprint"),
                    doc.get("threads_fingerprint")) != (pins["census"],
                                                        pins["threads"]):
                problems.append(f"(a) fingerprints {verbs[name]} != pins "
                                f"{pins}")
    log("[analysis] (a) " + json.dumps(dict(verbs, pins=pins,
                                            device=dev_line)))

    # (b) the no-FT twin at the headline's full width
    twin_mod, report = ablated_executor()
    if len(report.stripped) != ABLATE_SITES:
        problems.append(f"(b) the transform stripped "
                        f"{len(report.stripped)} sites, not "
                        f"{ABLATE_SITES}: {report.to_dict()}")
    torch.cuda.empty_cache()
    real, launches_real, _ = _counted(
        lambda: _ablation_drive(real_ex, check_plain=False))
    t_real, leaves_real, head_real, rings_real, subtasks, rings, _ = real
    torch.cuda.empty_cache()
    twin, launches_twin, _ = _counted(
        lambda: _ablation_drive(twin_mod, check_plain=True))
    t_twin, leaves_twin, head_twin, rings_twin, _s, _r, plain = twin
    identical = len(leaves_real) == len(leaves_twin) > 0 and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        for a, b in zip(leaves_real, leaves_twin))
    if not identical:
        problems.append("(b) the twin's states, edge buffers, record "
                        "counts or sinks differ from the executor's")
    if not (head_real > 0 and head_twin == 0 and max(rings_real) > 0
            and max(rings_twin) == 0):
        problems.append(f"(b) log heads real {head_real} twin {head_twin}, "
                        f"ring heads real {rings_real} twin {rings_twin}")
    cuda = torch.device(DEVICE).type == "cuda"
    if plain["max_abs_err"] != 0 or not plain["calls"] \
            or (cuda and plain["kernel_calls"] != plain["calls"]):
        problems.append(f"(b) the twin's warm-up epoch against "
                        f"keyed_hist_plain: {plain}")
    for tag, launches in (("real", launches_real), ("twin", launches_twin)):
        if _hist_silent(launches):
            problems.append(f"(b) {tag}: no kernel launch: {launches}")
    measured = max(0.0, (t_real - t_twin) / t_real) if t_real else 0.0
    census = build_census(_repo_contexts(("clonos_tpu_torch",)))
    model = static_cost_model(
        census, steps_per_epoch=ABLATE_SPE, subtasks=subtasks,
        records_per_step=BATCH * PAR, ring_vertices=rings,
        record_touches=4)
    static = model["ft_fraction_static"]
    rel_err = abs(static - measured) / max(abs(measured), 1e-9)
    if fingerprint(census) != pins["census"]:
        problems.append(f"(b) census {fingerprint(census)} != pin "
                        f"{pins['census']}")
    reading = dict(
        t_real_s=t_real, t_twin_s=t_twin, epochs=ABLATE_EPOCHS,
        steps_per_epoch=ABLATE_SPE, block_steps=ABLATE_BLOCK,
        subtasks=subtasks, records_per_step=BATCH * PAR,
        ft_fraction_measured=measured, ft_fraction_static=static,
        model_rel_error=rel_err, stripped_sites=len(report.stripped),
        outputs_bit_identical=identical, log_rows_real=head_real,
        log_rows_twin=head_twin, launches_real=launches_real,
        launches_twin=launches_twin,
        twin_warmup_vs_plain=dict(plain, shapes=[list(x) for x in
                                                 plain["shapes"]]),
        static_model=model)
    del leaves_real, leaves_twin
    torch.cuda.empty_cache()
    log("[analysis] (b) " + json.dumps(dict(reading, device=dev_line),
                                       default=float))
    log(f"[analysis] (b) real {t_real:.4f} s, twin {t_twin:.4f} s for "
        f"{ABLATE_EPOCHS} x {ABLATE_SPE} steps; ft-fraction measured "
        f"{measured:.6f}, static {static:.6f}, relative error "
        f"{rel_err:.6f}; keyed_hist launches real "
        f"{json.dumps(launches_real)} twin {json.dumps(launches_twin)} "
        f"({dev_line})")

    # (c) the soak verdicts name the port's census
    if not verdict_census or any(fp != pins["census"]
                                 for fp in verdict_census.values()):
        problems.append(f"(c) soak verdicts' census_fingerprint "
                        f"{verdict_census} != pin {pins['census']}")
    log("[analysis] (c) " + json.dumps(dict(verdicts=verdict_census,
                                            pin=pins["census"],
                                            device=dev_line)))
    launches = {k: launches_real[k] + launches_twin[k]
                for k in launches_real}
    log(f"[analysis] phase 21: {time.monotonic() - t_phase:.1f} s, kernel "
        f"launches {json.dumps(launches)} ({dev_line})")
    if problems:
        raise AssertionError("phase 21: " + "; ".join(problems))
    return launches


# --- phase 22 ---------------------------------------------------------------

#: (b)'s kill, twice: window subtask 3 (flat PAR + 3)
P22_KILL = [(1, 3)]
#: "module:function" each fresh standby interpreter of (a) calls (a CPU
#: rehearsal names a module that shrinks this one's constants)
P22_STANDBY_TARGET = "chip_smoke:_p22_standby"

PHASE22_REDUCTIONS = (
    "phase 4's headline cuts; (a) two fresh interpreters each rebuild the "
    "job with bootstrap_standby from a checkpoint and mirror rows at the "
    f"fence after 2 completed and 1 pending {STEPS_PER_EPOCH}-step epochs, "
    "on one new build-cache directory; (b) a runner prewarmed after 2 "
    f"epochs and {EXTRA_STEPS} steps, then window subtask 3 killed twice "
    "against a never-failed control")


def _carry_sha1(runner) -> str:
    """sha1 over the canonical carry's leaves (dtype, shape, bytes), on
    the host: equal digests are equal carries, across processes."""
    import hashlib
    from clonos_tpu_torch.runtime.executor import canonical_carry
    from clonos_tpu_torch.utils.tree import tree_leaves
    h = hashlib.sha1()
    for x in tree_leaves(canonical_carry(runner.executor.carry)):
        h.update(f"{x.dtype}{tuple(x.shape)}".encode())
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def _p22_standby(ck_dir, mirror_path, cache, out_path):
    """(a)'s standby, in a fresh interpreter: rebuild the job from
    ``ck_dir`` and the mirror rows on the build cache ``cache``, and write
    what it saw to ``out_path``."""
    from clonos_tpu_torch.obs import trace as obs
    from clonos_tpu_torch.ops import cuda_build
    from clonos_tpu_torch.ops.histogram import keyed_hist
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    tr = obs.configure("standby")
    data = np.load(mirror_path)
    mirror = {f: (data[f"rows{f}"], int(data["starts"][f]))
              for f in range(len(data["starts"]))}
    before = sorted(os.listdir(cache))
    t0 = time.monotonic()
    runner, rep = ClusterRunner.bootstrap_standby(
        build_job(), ck_dir, mirror, compile_cache_dir=cache,
        device=DEVICE, **runner_kw())
    sync()
    wall = time.monotonic() - t0
    spans = [dict(name=x["name"], ms=x.get("dur", 0.0) * 1e3,
                  error=x.get("args", {}).get("error"))
             for x in tr.records() if x["name"].startswith("recovery.aot")]
    out = dict(
        digest=_carry_sha1(runner), wall_s=wall,
        steps_replayed=rep.steps_replayed, phase_ms=rep.phase_ms,
        blocked_ms=rep.blocked_ms, aot=spans, before=before,
        after=sorted(os.listdir(cache)),
        cache=runner._compile_cache_dir,
        build={k: {f: v[f] for f in ("seconds", "path")} | {
            "cached": v["log"] == "(cached)"}
            for k, v in cuda_build.BUILD_INFO.items()},
        launches=keyed_hist.launches,
        warm_launches=keyed_hist.warm_launches,
        failed_counter=runner._mgroup.counter(
            "recovery.aot-lower-failed").value)
    with open(out_path, "w") as f:
        json.dump(out, f, default=float)


def _p22_restart(root, dev_line):
    """(a): the restart cycle. Returns the two standbys' readings."""
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    problems = []
    ck = os.path.join(root, "ck")
    control = ClusterRunner(build_job(), checkpoint_dir=ck, device=DEVICE,
                            **runner_kw())
    for complete in (True, True, False):
        control.run_epoch(complete_checkpoint=complete)
    logs = control.executor.carry.logs
    rows, heads, tails = (x.cpu().numpy() for x in (logs.rows, logs.head,
                                                      logs.tail))
    cap = rows.shape[1]
    mirror_path = os.path.join(root, "mirror.npz")
    np.savez(mirror_path, starts=tails.astype(np.int64), **{
        f"rows{f}": rows[f][np.arange(int(tails[f]), int(heads[f]))
                            & (cap - 1)] for f in range(rows.shape[0])})
    want = _carry_sha1(control)
    control.coordinator.storage._close_ledger()
    del control
    torch.cuda.empty_cache()
    cache = os.path.join(root, "build-cache")
    os.makedirs(cache)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    got = []
    for i in (1, 2):
        ck_i = os.path.join(root, f"ck{i}")
        shutil.copytree(ck, ck_i)
        out = os.path.join(root, f"standby{i}.json")
        t0 = time.monotonic()
        mod, fn = P22_STANDBY_TARGET.split(":")
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import sys, {mod}; {mod}.{fn}(*sys.argv[1:])",
             ck_i, mirror_path, cache, out],
            cwd=here, env=env, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"phase 22 (a): standby {i} exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        with open(out) as f:
            r = json.load(f)
        r["process_s"] = time.monotonic() - t0
        got.append(r)
    first, second = got
    lib = first["build"].get("keyed_hist.cu", {})
    if first["before"] or lib.get("cached", True) \
            or os.path.dirname(lib.get("path", "")) != cache:
        problems.append(f"(a) the first standby did not build into the "
                        f"empty cache: before {first['before']}, {lib}")
    if not second["build"].get("keyed_hist.cu", {}).get("cached"):
        problems.append(f"(a) the second standby built: {second['build']}")
    if not (second["before"] == second["after"] == first["after"]):
        problems.append(f"(a) the cache changed: {first['after']} -> "
                        f"{second['before']} -> {second['after']}")
    if any(".tmp" in e for e in second["after"]):
        problems.append(f"(a) temp files left: {second['after']}")
    for i, r in enumerate(got, 1):
        if r["digest"] != want:
            problems.append(f"(a) standby {i}'s carry {r['digest']} != the "
                            f"control's {want} at the fence")
        if r["steps_replayed"] != STEPS_PER_EPOCH:
            problems.append(f"(a) standby {i} replayed "
                            f"{r['steps_replayed']}")
        if [x["name"] for x in r["aot"]] != ["recovery.aot-lower"] \
                or r["failed_counter"] != 0:
            problems.append(f"(a) standby {i}'s first-step warm: "
                            f"{r['aot']}, failed {r['failed_counter']}")
        if r["cache"] != cache:
            problems.append(f"(a) standby {i} used {r['cache']}")
        log("[compile-cache] (a) " + json.dumps(dict(
            standby=i, first_step_recompile_ms=r["phase_ms"].get(
                "finalize.first-step-recompile"),
            first_step_recompile_blocked_ms=r["blocked_ms"].get(
                "finalize.first-step-recompile"),
            aot_lower_ms=[x["ms"] for x in r["aot"]],
            nvcc_s=r["build"].get("keyed_hist.cu", {}).get("seconds"),
            built=not r["build"].get("keyed_hist.cu", {}).get("cached"),
            cache_entries=r["after"], bootstrap_wall_s=r["wall_s"],
            process_s=r["process_s"], steps_replayed=r["steps_replayed"],
            finalize_ms=r["phase_ms"].get("finalize"),
            recovery_launches=r["launches"],
            warm_launches=r["warm_launches"], carry_sha1=r["digest"],
            control_sha1=want, device=dev_line), default=float))
    return problems


def phase_compile_cache(dev_line, root):
    """(a) the restart cycle of the build cache: two fresh standbys on one
    cache directory, the second building nothing; (b) the in-process
    prewarm on the headline runner: the live carry untouched, the first
    step warmed, two recoveries bit-identical to a control with no build
    or load inside them, and the warm's launches held to the plain
    version. Returns the paths' kernel launches."""
    from clonos_tpu_torch.ops import cuda_build, native
    from clonos_tpu_torch.ops.histogram import keyed_hist
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    from clonos_tpu_torch.utils.compile_cache import aot_lower_first_step
    from clonos_tpu_torch.utils.tree import tree_leaves
    t_phase = time.monotonic()
    problems = _p22_restart(root, dev_line)

    # (b) the in-process prewarm
    control = ClusterRunner(build_job(), device=DEVICE, **runner_kw())
    warm = ClusterRunner(build_job(), device=DEVICE, **runner_kw())
    for r in (control, warm):
        r.run_epoch()
        r.run_epoch()
        for _ in range(EXTRA_STEPS):
            r.step()
    sync()
    before = [x.clone() for x in tree_leaves(warm.executor.carry)]
    keyed_hist.warm_launches = keyed_hist.warm_launches_counts = 0
    prewarm_s = warm.prewarm_recovery()
    warm_launches = {
        "keyed_hist": keyed_hist.warm_launches_counts,
        "keyed_hist_sums": (keyed_hist.warm_launches
                            - keyed_hist.warm_launches_counts)}
    calls = []
    prewarm2_s = _recorded(warm.prewarm_recovery, calls)
    plain = _first_chunk_reading(calls)
    del calls
    t0 = time.monotonic()
    handle = aot_lower_first_step(warm.executor, warm._mgroup)
    aot_s = time.monotonic() - t0
    failed = warm._mgroup.counter("recovery.aot-lower-failed").value
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(before, tree_leaves(warm.executor.carry)))
    del before
    if handle is None or failed != 0:
        problems.append(f"(b) aot_lower_first_step {handle}, failed "
                        f"counter {failed}")
    if not same:
        problems.append("(b) the live carry moved across the prewarm")
    cuda = torch.device(DEVICE).type == "cuda"
    if plain["max_abs_err"] != 0 or not plain["calls"] or (cuda and (
            plain["kernel_calls"] != plain["calls"]
            or _hist_silent(warm_launches))):
        problems.append(f"(b) the warm's launches against keyed_hist_plain "
                        f"{plain}, counted {warm_launches}")
    # No build and no load inside a recovery.
    loads = []
    saved = cuda_build.build, cuda_build.load, native._build
    cuda_build.build = lambda *a, **k: loads.append("build") or saved[0](
        *a, **k)
    cuda_build.load = lambda *a, **k: loads.append("load") or saved[1](
        *a, **k)
    native._build = lambda *a, **k: loads.append("codec") or saved[2](
        *a, **k)
    recoveries = []
    by_path = {"prewarm": warm_launches}
    try:
        for i in (1, 2):
            reserved = torch.cuda.memory_reserved() if cuda else 0
            rep, _reading, launches = _recover(
                control, warm, f"(b) recovery {i} after the prewarm",
                P22_KILL, dev_line)
            by_path[f"prewarmed_recovery_{i}"] = launches
            recoveries.append(dict(
                recovery_ms=rep.recovery_ms,
                reserved_growth_bytes=((torch.cuda.memory_reserved()
                                        if cuda else 0) - reserved)))
    finally:
        cuda_build.build, cuda_build.load, native._build = saved
    if loads:
        problems.append(f"(b) a recovery built or loaded: {loads}")
    for r in (control, warm):
        r.run_epoch()
    _assert_same(control, warm, "(b) one epoch after the recoveries")
    log("[compile-cache] (b) " + json.dumps(dict(
        prewarm_s=prewarm_s, prewarm_recorded_s=prewarm2_s,
        aot_lower_s=aot_s, aot_handle=None if handle is None
        else handle._asdict(), aot_failed_counter=failed,
        carry_unchanged=same, warm_launches=warm_launches,
        warm_vs_plain=dict(plain, shapes=[list(x) for x in
                                          plain["shapes"]]),
        recoveries=recoveries, builds_or_loads_in_recovery=loads,
        device=dev_line), default=float))
    del control, warm
    torch.cuda.empty_cache()
    log(f"[compile-cache] phase 22: {time.monotonic() - t_phase:.1f} s, "
        f"kernel launches {json.dumps(by_path)} ({dev_line})")
    if problems:
        raise AssertionError("phase 22: " + "; ".join(problems))
    return by_path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    import clonos_tpu_torch  # noqa: F401  (fails outside the repo)
    t_all = time.monotonic()
    dev_line = device_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {dev_line} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")
    log(f"[config] 8 sources -> keyBy -> 8 windows -> keyBy(static) -> 8 "
        f"reduces -> 8 sinks; batch {BATCH}, vocab {VOCAB}, key groups "
        f"{NUM_KEY_GROUPS}, edge capacity {EDGE_CAPACITY}")
    log(f"[config] {REDUCTIONS}")
    phase_build()
    rows = phase_kernels()
    rank_rows = phase_keyed_rank()
    phase_card_vs_cpu()
    golden, launches = phase_main_path(dev_line)
    _, recovery_launches = phase_recovery(golden, dev_line)
    audit_launches = phase_audit(dev_line)
    del golden
    root = tempfile.mkdtemp(prefix="chip_smoke_", dir=SCRATCH)
    try:
        phase_headline_fence(dev_line, root)
        overlap_launches = phase_overlap(dev_line, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[config] phase 8: {SPILL_REDUCTIONS}")
    root = tempfile.mkdtemp(prefix="chip_smoke_spill_", dir=SCRATCH)
    try:
        spill_launches = phase_spill(dev_line, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[config] phase 9: {PHASE9_REDUCTIONS}")
    feed_launches = phase_feeds(dev_line)
    join_launches = phase_join(dev_line)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_egress_", dir=SCRATCH)
    try:
        egress_launches = phase_egress(dev_line, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[config] phase 10: {PHASE10_REDUCTIONS}")
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_", dir=SCRATCH)
    try:
        obs_launches = phase_observability(dev_line, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[config] phase 11: {PHASE11_REDUCTIONS}")
    socket_launches = phase_socket_wordcount(dev_line)
    root = tempfile.mkdtemp(prefix="chip_smoke_remote_", dir=SCRATCH)
    try:
        host_loss_launches = phase_host_loss(dev_line, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[config] phase 12: {PHASE12_REDUCTIONS}")
    t12 = time.monotonic()
    read_launches = phase_serve_reads(dev_line)
    torch.cuda.empty_cache()
    ingest_launches = phase_serve_ingest(dev_line)
    read_tier = {k: read_launches[k] + ingest_launches[k]
                 for k in read_launches}
    log(f"[serve] phase 12: {time.monotonic() - t12:.1f} s")
    torch.cuda.empty_cache()
    log(f"[config] phase 13: {PHASE13_REDUCTIONS}")
    t13 = time.monotonic()
    root = tempfile.mkdtemp(prefix="chip_smoke_slots_", dir=SCRATCH)
    try:
        spanning_launches = phase_spanning(dev_line, root)
        multitenant_launches = phase_multitenant(dev_line, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[slots] phase 13: {time.monotonic() - t13:.1f} s")
    torch.cuda.empty_cache()
    log(f"[config] phase 14: {PHASE14_REDUCTIONS}")
    t14 = time.monotonic()
    root = tempfile.mkdtemp(prefix="chip_smoke_planes_", dir=SCRATCH)
    try:
        cost_launches = phase_planes_cost(dev_line, root)
        failover_launches = phase_planes_failover(dev_line, root)
        phase_planes_spanning(dev_line, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[planes] phase 14: {time.monotonic() - t14:.1f} s")
    torch.cuda.empty_cache()
    log(f"[config] phase 15: {PHASE15_REDUCTIONS}")
    t15 = time.monotonic()
    recut_launches = phase_rescale_restore(dev_line, rows)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_rescale_", dir=SCRATCH)
    try:
        live_launches = phase_rescale_live(dev_line, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[rescale] phase 15: {time.monotonic() - t15:.1f} s ({dev_line})")
    torch.cuda.empty_cache()
    log(f"[config] phase 16: {PHASE16_REDUCTIONS}")
    root = tempfile.mkdtemp(prefix="chip_smoke_soak_", dir=SCRATCH)
    try:
        soak_launches, soak_rate = phase_soak(dev_line, root, rows)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[config] phase 17: {PHASE17_REDUCTIONS}")
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=SCRATCH)
    try:
        mesh_launches = phase_mesh(dev_line, root, rows)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[config] phase 18: {PHASE18_REDUCTIONS}")
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_storage_", dir=SCRATCH)
    try:
        mesh_storage_launches = phase_mesh_storage(dev_line, root, rows)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[config] phase 19: {PHASE19_REDUCTIONS}")
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_rebuild_", dir=SCRATCH)
    try:
        mesh_rebuild_launches = phase_mesh_rebuild(dev_line, root, rows)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[config] phase 20: {PHASE20_REDUCTIONS}")
    root = tempfile.mkdtemp(prefix="chip_smoke_verify_", dir=SCRATCH)
    try:
        verify_launches, verdict_census = phase_verify(
            dev_line, root, rows, soak_rate)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[config] phase 21: {PHASE21_REDUCTIONS}")
    analysis_launches = phase_analysis(dev_line, verdict_census)
    torch.cuda.empty_cache()
    log(f"[config] phase 22: {PHASE22_REDUCTIONS}")
    root = tempfile.mkdtemp(prefix="chip_smoke_cache_", dir=SCRATCH)
    try:
        cache_launches = phase_compile_cache(dev_line, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[done] {time.monotonic() - t_all:.1f} s")
    print(json.dumps(kernels_line(rows, {
        "main": launches, "recovery": recovery_launches,
        "audit_recovery": audit_launches, **overlap_launches,
        **spill_launches, "feed_cascade": feed_launches,
        "join_recovery": join_launches,
        "event_time_egress": egress_launches,
        "observability": obs_launches,
        "socket_wordcount": socket_launches,
        "host_loss": host_loss_launches, "read_tier": read_tier,
        "spanning": spanning_launches,
        "multitenant": multitenant_launches,
        "planes_cost": cost_launches,
        "planes_failover": failover_launches,
        "rescale_restore": recut_launches,
        "rescale_live": live_launches, "soak": soak_launches,
        **mesh_launches, **mesh_storage_launches,
        **mesh_rebuild_launches, "verify": verify_launches,
        "ablation": analysis_launches, **cache_launches}, rank_rows)))
    print(dev_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
