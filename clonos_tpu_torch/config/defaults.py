"""The framework's configuration surface (port of
``clonos_tpu/config/defaults.py``: every key, default, type and validator
is the reference's).

Covers the reference's Clonos-specific keys (SURVEY §2.3 config row:
flink-runtime .../configuration/JobManagerOptions.java:111-135, NettyConfig
.java:82-98, ExecutionConfig.java:297-310, InFlightLogConfig.java:42-71) plus
the device-native knobs this framework adds (log capacities, batch shapes, mesh
axes).
"""

from __future__ import annotations

from clonos_tpu_torch.config.options import ConfigOption

# --- failover / standby (reference: JobManagerOptions.java:111-135) ---------

FAILOVER_STRATEGY = ConfigOption(
    "jobmanager.execution.failover-strategy", "standbytask",
    description="Failover strategy: 'standbytask' (Clonos local recovery) or "
                "'full' (global restart).")

NUM_STANDBY_TASKS = ConfigOption(
    "jobmanager.execution.num-standby-tasks", 1,
    description="Passive standby replicas per subtask, state-synced via "
                "checkpoint pushes.")

CHECKPOINT_BACKOFF_BASE_MS = ConfigOption(
    "jobmanager.execution.checkpoint-backoff-base", 1000,
    description="Base backoff (ms) applied to the checkpoint interval while "
                "a recovery is in progress.")

CHECKPOINT_BACKOFF_MULTIPLIER = ConfigOption(
    "jobmanager.execution.checkpoint-backoff-multiplier", 2.0,
    description="Multiplier on the checkpoint interval during recovery.")

# --- determinant sharing (reference: ExecutionConfig.java:297-310) ----------

DETERMINANT_SHARING_DEPTH = ConfigOption(
    "causal.determinant-sharing-depth", -1,
    description="How many hops downstream determinants are replicated. "
                "-1 = full sharing (survive any number of connected "
                "failures); k = survive up to k connected failures.")

DELTA_ENCODING_STRATEGY = ConfigOption(
    "causal.delta-encoding-strategy", "grouped",
    validator=lambda v: v in ("flat", "grouped"),
    description="Piggyback delta layout: 'flat' (one entry per thread log) "
                "or 'grouped' (vertex->partition->subpartition hierarchy).")

# --- determinant log memory (reference: NettyConfig.java:82-98) -------------

DETERMINANT_LOG_CAPACITY = ConfigOption(
    "causal.log.capacity", 1 << 16,
    description="Slots per thread causal log ring buffer (device HBM). "
                "Must be a power of two.",
    validator=lambda v: v > 0 and (v & (v - 1)) == 0)

DETERMINANT_MAX_EPOCHS = ConfigOption(
    "causal.log.max-epochs", 64,
    description="Maximum concurrently-retained (un-truncated) epochs per log.",
    validator=lambda v: v > 0)

DETERMINANT_MAX_DELTA = ConfigOption(
    "causal.log.max-delta", 4096,
    description="Static upper bound on determinants shipped per piggyback "
                "delta (one superstep's worth).")

# --- in-flight log (reference: InFlightLogConfig.java:42-71) ----------------

INFLIGHT_TYPE = ConfigOption(
    "taskmanager.inflight.type", "inmemory",
    validator=lambda v: v in ("spillable", "inmemory", "disabled"),
    description="In-flight log implementation.")

INFLIGHT_SPILL_POLICY = ConfigOption(
    "taskmanager.inflight.spill.policy", "eager",
    validator=lambda v: v in ("eager", "availability", "epoch"),
    description="When to spill epochs from HBM to host memory/disk.")

INFLIGHT_PREFETCH_BUFFERS = ConfigOption(
    "taskmanager.inflight.spill.num-prefetch-buffers", 50,
    description="Replay prefetch depth for spilled epochs.")

INFLIGHT_AVAILABILITY_TRIGGER = ConfigOption(
    "taskmanager.inflight.spill.availability-trigger", 0.3,
    description="Pool availability fraction below which 'availability' "
                "policy spills.")

INFLIGHT_HOST_BUDGET_EPOCHS = ConfigOption(
    "taskmanager.inflight.spill.host-budget-epochs", 2,
    description="Sealed epochs each spill owner keeps resident in the host "
                "staging tier once their segments are durable; older "
                "epochs demote to disk-only (storage/tiered.py).")

INFLIGHT_CAPACITY_BATCHES = ConfigOption(
    "taskmanager.inflight.capacity-batches", 256,
    description="Batches retained per edge in the device-resident in-flight "
                "ring.")

# --- checkpointing ----------------------------------------------------------

CHECKPOINT_INTERVAL_STEPS = ConfigOption(
    "checkpoint.interval-steps", 16,
    description="Supersteps per epoch (checkpoint barrier cadence).")

CHECKPOINT_DIR = ConfigOption(
    "checkpoint.dir", "/tmp/clonos_tpu/checkpoints",
    description="Durable storage root for snapshots and spilled epochs.")

# --- execution / batching (device-native) -----------------------------------

BATCH_SIZE = ConfigOption(
    "execution.batch-size", 256,
    description="Records per batch flowing along each edge per superstep. "
                "The device analog of the reference's network buffer.")

RECORD_WIDTH = ConfigOption(
    "execution.record-width", 8,
    description="int32 lanes per record in the packed record layout.")

MESH_TASK_AXIS = ConfigOption(
    "parallel.mesh-task-axis", "tasks",
    description="Mesh axis name over which parallel subtasks are sharded.")

HEARTBEAT_INTERVAL_MS = ConfigOption(
    "heartbeat.interval", 1000,
    description="Heartbeat cadence between control plane and task plane.")

HEARTBEAT_TIMEOUT_MS = ConfigOption(
    "heartbeat.timeout", 5000,
    description="Missed-heartbeat window before a task executor is declared "
                "failed.")

# --- observability (clonos_tpu_torch/obs) -----------------------------------

TRACING_ENABLED = ConfigOption(
    "observability.tracing.enabled", False,
    description="Record distributed trace spans (epoch/checkpoint/recovery "
                "lifecycles) and propagate trace context on control-wire "
                "headers. Off = the NullTracer: no wire fields, no "
                "per-record work.")

TRACE_DIR = ConfigOption(
    "observability.tracing.dir", "/tmp/clonos_tpu/traces",
    description="Directory for per-process trace-<service>.jsonl files "
                "(convert with obs.load_jsonl + obs.to_chrome).")

TRACE_BUFFER_EVENTS = ConfigOption(
    "observability.tracing.buffer-events", 8192,
    validator=lambda v: v > 0,
    description="Flight-recorder ring size: most recent trace records kept "
                "in memory and served on the metrics endpoint's /trace.")

AUDIT_ENABLED = ConfigOption(
    "observability.audit.enabled", False,
    description="Seal a per-epoch audit digest at every checkpoint barrier, "
                "persist the epoch ledger next to the checkpoints, and "
                "validate replayed epochs against it during recovery. Off = "
                "the NullAuditor: no digest reads, no ledger writes, no "
                "wire fields.")

AUDIT_ON_DIVERGENCE = ConfigOption(
    "observability.audit.on-divergence", "warn",
    validator=lambda v: v in ("warn", "abort"),
    description="What a replay-divergence audit finding does: 'warn' emits "
                "the recovery.audit.divergence instant and counts it; "
                "'abort' additionally fails the recovery "
                "(AuditDivergenceError) before the job resumes on "
                "non-reproduced state.")

PROFILE_ENABLED = ConfigOption(
    "observability.profile.enabled", False,
    description="Attribute per-section fault-tolerance overhead "
                "(overhead.<section>-ms histograms + the "
                "overhead.ft-fraction gauge) with device-fenced section "
                "timers in the hot paths. Off = the NullProfiler: no "
                "fencing, no per-step host work.")

METRICS_HISTORY_INTERVAL_S = ConfigOption(
    "observability.metrics-history.interval-s", 2.0,
    validator=lambda v: v > 0,
    description="Seconds between metrics-history samples taken by the "
                "metrics endpoint's sampler thread (served at "
                "/metrics/history.json).")

METRICS_HISTORY_WINDOW = ConfigOption(
    "observability.metrics-history.window", 512,
    validator=lambda v: v > 0,
    description="Samples retained in the metrics-history ring (memory and "
                "the bounded history JSONL file alike).")
