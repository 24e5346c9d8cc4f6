"""Incident forensics plane (port of ``clonos_tpu/obs/incident.py``):
durable flight-recorder bundles.

Every detector in the repo can now *raise an alarm* — audit ledger
divergence (obs/audit.py), SLO breach windows (soak/slo.py), HLC
causality inversions (obs/timeline.py), sustained gray suspects
(obs/detect.py), conformance/replay mismatches (autoscale, verify),
recovery failures (causal/recovery.py) — but an alarm is only a
pointer. Diagnosis needs the *evidence* those planes held at the
moment of the alarm, and in a crashing or flapping process that
evidence is gone by the time a human asks for it. This module is the
flight recorder:

- :class:`IncidentManager` — on any failure ``signal()``, snapshots
  one **incident bundle**: the HLC timeline slice around the trigger,
  the suspect ledger epochs ±k (with their partition-invariant
  ``ringsum`` channels), the determinant-window rows for those epochs
  pulled from whichever tier still holds them (live executor window or
  TieredEpochStore), the metrics-history window, the decision-log
  slice, the active chaos schedule, and the config + census
  fingerprint. Bundles are size-bounded (per-section caps), landed
  atomically (tmp + fsync + ``os.replace`` — a crash never leaves a
  half bundle), deduplicated by trigger fingerprint and rate-limited
  per kind, so a flapping fault cannot fill the disk.
- :mod:`clonos_tpu_torch.obs.rootcause` — the deterministic analyzer that
  turns a bundle into a byte-identical explanation (first divergent
  epoch/channel, first divergent determinant row, ranked causal
  chain). ``python -m clonos_tpu_torch incident`` is the CLI over both.

Zero overhead off: :class:`NullIncidentManager` is the process default
(``signal()`` a constant no-op, no gauges, no wire fields), the
NullTracer convention. Enabling is the explicit
:func:`configure_incidents` opt-in.

The bundle format itself is pinned: :data:`BUNDLE_SCHEMA` has one
canonical fingerprint (:func:`bundle_schema_fingerprint`) checked
against ``.clonos-incident-schema`` in conftest, so silent
bundle-format drift fails the session like census drift does.
"""

from __future__ import annotations

import json
import hashlib
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

#: Failure-signal kinds the manager accepts (anything else raises —
#: a typo'd kind is a silent dead trigger otherwise).
TRIGGER_KINDS = (
    "audit.divergence",        # ledger diff found content divergence
    "slo.breach",              # a closed SLO window breached
    "timeline.inversion",      # merged HLC order causally unsound
    "health.gray-suspect",     # sustained gray-failure suspect
    "conformance.mismatch",    # replay disagreed with the decision log
    "recovery.failure",        # a recovery attempt itself failed
    "job.failure",             # dispatcher saw a job die
)

#: The pinned bundle format. PURE data — version, section names, and
#: the per-section shape notes. Any change here changes
#: :func:`bundle_schema_fingerprint` and must be re-pinned in
#: ``.clonos-incident-schema`` (conftest enforces).
BUNDLE_SCHEMA = {
    "format": "clonos-incident-bundle",
    "version": 1,
    "sections": {
        "bundle": "schema/fingerprint/kind/seq/service/ts",
        "trigger": "kind + caller fields, the dedup identity",
        "timeline": "HLC timeline slice around the trigger",
        "ledgers": "audit ledger entries, trigger epoch +/- k, per side",
        "determinants": "per-epoch determinant window summaries per side",
        "metrics": "metrics-history window (last N samples)",
        "decisions": "decision-log slice (last N records)",
        "chaos": "active chaos schedule text",
        "config": "caller-provided run config",
        "census": "pinned FT call-site census fingerprint",
    },
}


def canonical_json(obj: Any) -> str:
    """The one bundle/report encoding: sorted keys, tight separators,
    ``default=str`` for stray numpy scalars. Equal content must encode
    to equal bytes — both the dedup fingerprint and the byte-identical
    report guarantee hang off this."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)


def bundle_schema_fingerprint() -> str:
    """Fingerprint of :data:`BUNDLE_SCHEMA` (the ``.clonos-incident-
    schema`` pin)."""
    return hashlib.blake2b(canonical_json(BUNDLE_SCHEMA).encode(),
                           digest_size=8).hexdigest()


def bundle_fingerprint(trigger: Dict[str, Any]) -> str:
    """Dedup identity of one trigger: kind + caller fields. Two signals
    describing the same fault (same divergence line, same breach
    window) fingerprint equal and capture once."""
    return hashlib.blake2b(canonical_json(trigger).encode(),
                           digest_size=8).hexdigest()


# --- determinant-window summarization ---------------------------------------


def _digest8(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=8).hexdigest()


def summarize_window(window: Dict[str, Any], *,
                     max_rows: int = 256) -> Dict[str, Any]:
    """Bound one ``LocalExecutor.epoch_window`` snapshot to bundle
    size: ``log/<flat>`` rows verbatim up to ``max_rows`` (they are the
    rows rootcause descends into), ring steps as per-step
    (count, key/value/timestamp digest) summaries — enough to name the
    first divergent step without shipping the records."""
    import numpy as np

    logs: Dict[str, Any] = {}
    for flat, rows in sorted(window.get("logs", {}).items(),
                             key=lambda kv: int(kv[0])):
        arr = np.ascontiguousarray(np.asarray(rows), np.int32)
        n = int(arr.shape[0]) if arr.ndim else 0
        logs[str(flat)] = {
            "count": n,
            "rows": arr[:max_rows].tolist(),
            "truncated": bool(n > max_rows),
        }
    rings: Dict[str, Any] = {}
    for vid, steps in sorted(window.get("rings", {}).items(),
                             key=lambda kv: int(kv[0])):
        out = []
        for keys, values, timestamps in steps:
            k = np.ascontiguousarray(np.asarray(keys), np.int32)
            v = np.ascontiguousarray(np.asarray(values), np.int32)
            t = np.ascontiguousarray(np.asarray(timestamps), np.int32)
            out.append({"n": int(k.shape[0]),
                        "kdig": _digest8(k.tobytes()),
                        "vdig": _digest8(v.tobytes()),
                        "tdig": _digest8(t.tobytes())})
        rings[str(vid)] = out
    return {"logs": logs, "rings": rings}


def capture_epoch_window(executor, epoch: int, *,
                         max_rows: int = 256) -> Dict[str, Any]:
    """One epoch's determinant window from whichever tier holds it:
    the live executor window when the epoch is still retained,
    otherwise the spill/determinant tiers (TieredEpochStore — array
    digests only; the segments themselves stay on disk), otherwise an
    explicit unavailable marker. Never raises — a bundle must land
    even when the evidence is partial."""
    try:
        win = executor.epoch_window(int(epoch))
        out = summarize_window(win, max_rows=max_rows)
        out["source"] = "live"
        return out
    except Exception as live_err:
        note = repr(live_err)
    try:
        for store in executor._tier_stores():
            if int(epoch) not in store.retained_epochs():
                continue
            start, arrays = store.load_epoch(int(epoch))
            return {"source": "tier", "start": int(start),
                    "arrays": {str(k): {"shape": list(v.shape),
                                        "dig": _digest8(v.tobytes())}
                               for k, v in sorted(arrays.items())}}
    except Exception as tier_err:
        note = f"{note}; tier: {tier_err!r}"
    return {"source": "unavailable", "note": note}


# --- the manager -------------------------------------------------------------


class NullIncidentManager:
    """The disabled plane: ``signal()`` is a constant no-op — zero
    wire fields, zero per-record work (the NullTracer convention)."""

    enabled = False
    captured = 0
    deduped = 0
    suppressed = 0
    signals = 0

    def signal(self, kind: str, **fields) -> Optional[str]:
        return None

    def attach(self, **providers) -> None:
        pass

    def bundles(self) -> List[str]:
        return []

    def register_gauges(self, registry) -> None:
        pass


#: provider slots ``attach()`` accepts; anything else is a typo'd
#: dead provider and raises.
_PROVIDER_SLOTS = ("ledgers", "det_window", "metrics", "decisions",
                   "chaos", "config", "census")


class IncidentManager:
    """The flight recorder: one durable bundle per novel failure
    signal.

    Context arrives through named **providers** (:meth:`attach`):
    zero-arg callables for ``ledgers`` (``{"expected": [...entries],
    "actual": [...]}``), ``metrics``, ``decisions``, ``chaos``,
    ``config``, ``census``, and a one-arg ``det_window(epoch)``
    returning per-side ``epoch_window`` snapshots. Every provider call
    is fenced with try/except — a broken provider degrades its section
    to an error marker, it never loses the bundle.
    """

    enabled = True

    def __init__(self, root: str, *, service: Optional[str] = None,
                 epoch_radius: int = 2, timeline_window: int = 256,
                 metrics_window: int = 64, decisions_window: int = 32,
                 max_rows: int = 256, max_bundles: int = 32,
                 min_interval_s: float = 5.0,
                 # clonos: allow(wallclock): rate-limit pacing and
                 # bundle timestamps are observability metadata, never
                 # operator state.
                 clock=time.time):
        self.dir = os.path.join(root, "incidents")
        os.makedirs(self.dir, exist_ok=True)
        self.service = service
        self.epoch_radius = int(epoch_radius)
        self.timeline_window = int(timeline_window)
        self.metrics_window = int(metrics_window)
        self.decisions_window = int(decisions_window)
        self.max_rows = int(max_rows)
        self.max_bundles = int(max_bundles)
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._providers: Dict[str, Callable] = {}
        self._last_capture: Dict[str, float] = {}
        self.captured = 0
        self.deduped = 0
        self.suppressed = 0
        self.signals = 0
        # A restarted process resumes dedup + numbering from the
        # bundles that survived on disk.
        self._seen: set = set()
        self._seq = 0
        for path in self.bundles():
            base = os.path.basename(path)
            try:
                self._seq = max(self._seq,
                                int(base.split("-")[1].split(".")[0]))
            except (IndexError, ValueError):
                pass
            try:
                with open(path) as f:
                    self._seen.add(
                        json.load(f)["bundle"]["fingerprint"])
            except Exception:
                continue          # a foreign file dedups nothing

    # --- context providers ---------------------------------------------------

    def attach(self, **providers) -> None:
        """Register context providers (later wins per slot)."""
        for name, fn in providers.items():
            if name not in _PROVIDER_SLOTS:
                raise ValueError(
                    f"unknown incident provider {name!r} "
                    f"(slots: {', '.join(_PROVIDER_SLOTS)})")
            if fn is None:
                self._providers.pop(name, None)
            else:
                self._providers[name] = fn

    def _call(self, name: str, *args):
        fn = self._providers.get(name)
        if fn is None:
            return None
        try:
            return fn(*args)
        except Exception as e:   # a broken provider must not lose the bundle
            return {"provider-error": repr(e)}

    # --- capture -------------------------------------------------------------

    def signal(self, kind: str, *, epoch: Optional[int] = None,
               **fields) -> Optional[str]:
        """One failure signal. Returns the landed bundle path, or None
        when the signal was deduplicated, rate-limited, or over the
        bundle cap."""
        if kind not in TRIGGER_KINDS:
            raise ValueError(f"unknown incident kind {kind!r} "
                             f"(kinds: {', '.join(TRIGGER_KINDS)})")
        trigger: Dict[str, Any] = {"kind": kind}
        if epoch is not None:
            trigger["epoch"] = int(epoch)
        trigger.update(fields)
        fp = bundle_fingerprint(trigger)
        now = self._clock()
        with self._lock:
            self.signals += 1
            if fp in self._seen:
                self.deduped += 1
                return None
            last = self._last_capture.get(kind)
            if last is not None and now - last < self.min_interval_s:
                self.suppressed += 1
                return None
            if self._seq >= self.max_bundles:
                self.suppressed += 1
                return None
            # Claim the slot under the lock; build outside it.
            self._seen.add(fp)
            self._last_capture[kind] = now
            self._seq += 1
            seq = self._seq
        path = self._capture(seq, fp, trigger, now)
        with self._lock:
            self.captured += 1
        from clonos_tpu_torch.obs.timeline import get_timeline
        tl = get_timeline()
        if tl.enabled:
            tl.record("incident.captured", trigger_kind=kind,
                      fingerprint=fp, bundle=os.path.basename(path))
        return path

    def _epoch_span(self, epoch: Optional[int]) -> Optional[range]:
        if epoch is None:
            return None
        k = self.epoch_radius
        return range(max(0, int(epoch) - k), int(epoch) + k + 1)

    def _capture(self, seq: int, fp: str, trigger: Dict[str, Any],
                 now: float) -> str:
        from clonos_tpu_torch.obs.timeline import get_timeline
        epoch = trigger.get("epoch")
        span = self._epoch_span(epoch)

        ledgers = self._call("ledgers")
        if isinstance(ledgers, dict) and span is not None:
            ledgers = {
                side: ([e for e in entries
                        if int(e.get("epoch", -1)) in span]
                       if isinstance(entries, list) else entries)
                for side, entries in ledgers.items()}
        elif isinstance(ledgers, dict):
            width = 2 * self.epoch_radius + 1
            ledgers = {side: (entries[-width:]
                              if isinstance(entries, list) else entries)
                       for side, entries in ledgers.items()}

        determinants: Dict[str, Any] = {}
        if span is not None and "det_window" in self._providers:
            for ep in span:
                win = self._call("det_window", ep)
                if win is not None:
                    determinants[str(ep)] = win

        metrics = self._call("metrics")
        if isinstance(metrics, list):
            metrics = metrics[-self.metrics_window:]
        decisions = self._call("decisions")
        if isinstance(decisions, list):
            decisions = decisions[-self.decisions_window:]

        bundle = {
            "bundle": {"schema": (f"{BUNDLE_SCHEMA['format']}"
                                  f"/v{BUNDLE_SCHEMA['version']}"),
                       "schema_fingerprint": bundle_schema_fingerprint(),
                       "fingerprint": fp, "kind": trigger["kind"],
                       "seq": seq, "service": self.service,
                       "ts": now},
            "trigger": trigger,
            "timeline": get_timeline().records()[-self.timeline_window:],
            "ledgers": ledgers,
            "determinants": determinants,
            "metrics": metrics,
            "decisions": decisions,
            "chaos": self._call("chaos"),
            "config": self._call("config"),
            "census": self._call("census") or _pinned_census(),
        }
        slug = trigger["kind"].replace("/", "_")
        path = os.path.join(self.dir, f"incident-{seq:04d}-{slug}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(canonical_json(bundle) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    # --- reading -------------------------------------------------------------

    def bundles(self) -> List[str]:
        """Landed bundle paths, capture order."""
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.startswith("incident-")
                           and n.endswith(".json"))
        except OSError:
            return []
        return [os.path.join(self.dir, n) for n in names]

    def register_gauges(self, registry) -> None:
        """``incident.*`` gauges — registered into the runner's
        MetricRegistry they ride the HEARTBEAT piggyback like every
        other plane; ``python -m clonos_tpu_torch top`` renders the incidents: row
        from them."""
        g = registry.group("incident")
        g.gauge("captured", lambda: self.captured)
        g.gauge("deduped", lambda: self.deduped)
        g.gauge("suppressed", lambda: self.suppressed)
        g.gauge("signals", lambda: self.signals)


def _pinned_census() -> str:
    """The port's pinned FT call-site census fingerprint
    (``clonos_tpu_torch/.clonos-census``), empty when unpinned — config
    drift context for the bundle."""
    from clonos_tpu_torch.analysis.census import CENSUS_PIN, read_pin
    return read_pin(CENSUS_PIN)


def load_bundle(path: str) -> dict:
    """Read one landed bundle back."""
    with open(path) as f:
        return json.load(f)


# --- process-global manager --------------------------------------------------

_global_incidents = NullIncidentManager()
_global_lock = threading.Lock()


def get_incidents():
    """The process incident manager (Null unless configured)."""
    return _global_incidents


def configure_incidents(root: str, **kw) -> IncidentManager:
    """Install a real incident manager (the opt-in gate)."""
    global _global_incidents
    with _global_lock:
        _global_incidents = IncidentManager(root, **kw)
        return _global_incidents


def reset_incidents() -> None:
    """Back to the disabled NullIncidentManager (tests)."""
    global _global_incidents
    with _global_lock:
        _global_incidents = NullIncidentManager()


# --- self-check --------------------------------------------------------------


def _entry(epoch: int, channels: Dict[str, tuple]) -> dict:
    """Hand-built ledger entry (obs/digest.EpochDigest.to_entry shape)
    for the synthetic self-check bundles."""
    return {"epoch": int(epoch),
            "channels": {name: {"count": int(c), "fp": fp}
                         for name, (c, fp) in sorted(channels.items())},
            "det_counts": {}}


def _synthetic_bundles() -> Dict[str, dict]:
    """Two in-memory bundles covering both localization regimes:

    - ``unlogged-ring``: determinant log rows identical, ring VALUES
      salted from epoch 2 step 1 on — the examples/audit_nondet.py
      fault class; the analyzer must name ``ring/v1`` step 1 and the
      injecting worker from the chaos record.
    - ``log-row``: a determinant log row itself diverges at epoch 1
      row 1 — the analyzer must name the lane tag / subtask / seq.
    """
    fp_same, fp_a, fp_b = "11" * 8, "aa" * 8, "bb" * 8
    rows_same = [[3, 1, 7, 0, 0, 0, 0, 0], [4, 1, 9, 0, 0, 0, 0, 0]]
    timeline = [
        {"kind": "chaos", "ts": 1.0, "hlc": [10, 0, "soak"],
         "service": "soak", "pid": 1, "chaos_kind": "nondet",
         "targets": ["w0"]},
        {"kind": "scale.decision", "ts": 1.5, "hlc": [15, 0, "soak"],
         "service": "soak", "pid": 1, "action": "hold", "epoch": 2},
        {"kind": "epoch.seal", "ts": 2.0, "hlc": [20, 0, "soak"],
         "service": "soak", "pid": 1, "epoch": 2, "audited": True},
        {"kind": "slo.breach", "ts": 3.0, "hlc": [30, 0, "soak"],
         "service": "soak", "pid": 1, "window": 1},
    ]
    ring_bundle = {
        "bundle": {"fingerprint": "f" * 16, "kind": "audit.divergence",
                   "schema_fingerprint": bundle_schema_fingerprint()},
        "trigger": {"kind": "audit.divergence", "epoch": 2},
        "timeline": timeline,
        "ledgers": {
            "expected": [
                _entry(1, {"log/0": (2, fp_same),
                           "ring/v1": (4, fp_same),
                           "ringsum/v1": (4, fp_same)}),
                _entry(2, {"log/0": (2, fp_same),
                           "ring/v1": (4, fp_a),
                           "ringsum/v1": (4, fp_a)}),
            ],
            "actual": [
                _entry(1, {"log/0": (2, fp_same),
                           "ring/v1": (4, fp_same),
                           "ringsum/v1": (4, fp_same)}),
                _entry(2, {"log/0": (2, fp_same),
                           "ring/v1": (4, fp_b),
                           "ringsum/v1": (4, fp_b)}),
            ],
        },
        "determinants": {
            "2": {"expected": {
                      "logs": {"0": {"count": 2, "rows": rows_same,
                                     "truncated": False}},
                      "rings": {"1": [
                          {"n": 2, "kdig": fp_same, "vdig": fp_same,
                           "tdig": fp_same},
                          {"n": 2, "kdig": fp_same, "vdig": fp_a,
                           "tdig": fp_same}]}},
                  "actual": {
                      "logs": {"0": {"count": 2, "rows": rows_same,
                                     "truncated": False}},
                      "rings": {"1": [
                          {"n": 2, "kdig": fp_same, "vdig": fp_same,
                           "tdig": fp_same},
                          {"n": 2, "kdig": fp_same, "vdig": fp_b,
                           "tdig": fp_same}]}}},
        },
        "metrics": [], "decisions": [], "chaos": None,
        "config": None, "census": "",
    }
    rows_b = [rows_same[0], [5, 1, 9, 0, 0, 0, 0, 0]]
    log_bundle = {
        "bundle": {"fingerprint": "e" * 16, "kind": "recovery.failure",
                   "schema_fingerprint": bundle_schema_fingerprint()},
        "trigger": {"kind": "recovery.failure", "epoch": 1},
        "timeline": [
            {"kind": "recovery.fsm", "ts": 0.5, "hlc": [5, 0, "jm"],
             "service": "jm", "pid": 2, "state": "REDEPLOYING"},
            {"kind": "epoch.seal", "ts": 1.0, "hlc": [9, 0, "jm"],
             "service": "jm", "pid": 2, "epoch": 1, "audited": True},
        ],
        "ledgers": {
            "expected": [_entry(1, {"log/0": (2, fp_a)})],
            "actual": [_entry(1, {"log/0": (2, fp_b)})],
        },
        "determinants": {
            "1": {"expected": {"logs": {"0": {"count": 2,
                                              "rows": rows_same,
                                              "truncated": False}},
                               "rings": {}},
                  "actual": {"logs": {"0": {"count": 2,
                                            "rows": rows_b,
                                            "truncated": False}},
                             "rings": {}}},
        },
        "metrics": [], "decisions": [], "chaos": None,
        "config": None, "census": "",
    }
    return {"unlogged-ring": ring_bundle, "log-row": log_bundle}


def incident_self_check() -> List[dict]:
    """Deterministic in-memory forensics self-check (the conftest /
    ``python -m clonos_tpu_torch incident --self-check`` gate): analyze each synthetic
    bundle twice — once as-built, once through a JSON round-trip (the
    two-fresh-process equivalence) — and demand byte-identical reports
    that localize the planted fault exactly. Pure: no files, no wall
    clock, no device. Returns findings (empty == sound)."""
    from clonos_tpu_torch.obs.rootcause import analyze_bundle, render_report

    findings: List[dict] = []

    def check(rule: str, ok: bool, detail: str) -> None:
        if not ok:
            findings.append({"rule": rule, "detail": detail})

    bundles = _synthetic_bundles()

    rep = analyze_bundle(bundles["unlogged-ring"])
    text = render_report(rep)
    roundtrip = json.loads(canonical_json(bundles["unlogged-ring"]))
    text2 = render_report(analyze_bundle(roundtrip))
    check("deterministic", text == text2,
          "unlogged-ring report not byte-identical across a JSON "
          "round-trip")
    check("epoch", rep.get("first_divergent_epoch") == 2,
          f"expected first divergent epoch 2, got "
          f"{rep.get('first_divergent_epoch')}")
    check("channel", rep.get("first_divergent_channel") == "ring/v1",
          f"expected channel ring/v1, got "
          f"{rep.get('first_divergent_channel')}")
    d = rep.get("determinant") or {}
    check("determinant", d.get("kind") == "ring-step"
          and d.get("seq") == 1 and d.get("field") == "values",
          f"expected ring-step seq 1 values divergence, got {d}")
    check("injector", rep.get("injected_by") == "w0",
          f"expected injector w0, got {rep.get('injected_by')}")
    check("chain", bool(rep.get("causal_chain"))
          and rep["causal_chain"][0].get("kind") == "chaos",
          "causal chain must lead with the chaos record")

    rep = analyze_bundle(bundles["log-row"])
    text = render_report(rep)
    roundtrip = json.loads(canonical_json(bundles["log-row"]))
    text2 = render_report(analyze_bundle(roundtrip))
    check("deterministic", text == text2,
          "log-row report not byte-identical across a JSON round-trip")
    check("epoch", rep.get("first_divergent_epoch") == 1,
          f"expected first divergent epoch 1, got "
          f"{rep.get('first_divergent_epoch')}")
    check("channel", rep.get("first_divergent_channel") == "log/0",
          f"expected channel log/0, got "
          f"{rep.get('first_divergent_channel')}")
    d = rep.get("determinant") or {}
    check("determinant", d.get("kind") == "log-row"
          and d.get("seq") == 1 and d.get("subtask") == "0",
          f"expected log-row subtask 0 seq 1, got {d}")

    # The schema fingerprint must be stable across processes too — it
    # is a pure function of BUNDLE_SCHEMA.
    check("schema", bundle_schema_fingerprint()
          == bundle_schema_fingerprint(),
          "schema fingerprint not stable")
    return findings
