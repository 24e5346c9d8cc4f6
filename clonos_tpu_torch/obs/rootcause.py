"""Deterministic root-cause localization over an incident bundle (port
of ``clonos_tpu/obs/rootcause.py``).

The paper's premise (PAPER.md core idea 2) is that every
nondeterministic decision is a *recorded determinant* — which means
"what diverged first, and what caused it" is a pure computation over
the recorded evidence, not on-call archaeology. This module is that
computation, with the same discipline as the rest of the repo's
decision machinery (ScalePolicy, detect_gray): a **pure function of
the bundle**, no clocks, no filesystem, no ambient state — the same
bundle in any process produces a byte-identical report
(:func:`render_report`), so the explanation itself is auditable.

Three descents, coarse to fine:

1. **Epoch bisection** — walk the bundle's ledger pair epoch by epoch
   through ``diff_ledgers_cross`` (obs/audit.py — exact diff under one
   layout, group-directory mapped across a re-cut) to the FIRST
   divergent epoch, then sort its divergent channels into natural
   order to name the first divergent channel.
2. **Determinant descent** — inside that epoch's determinant-window
   summaries, name the first divergent row: a ``log/<flat>`` channel
   names (lane tag, subtask, seq) from the verbatim rows; a ``ring``
   channel names the first step whose key/value/timestamp digest
   flipped — identical log rows with salted ring values is the
   *unlogged nondeterminism* signature (examples/audit_nondet.py).
3. **Causal chain** — walk the HLC timeline backward from the seal of
   the divergent epoch, ranking what preceded it (chaos injections,
   recovery transitions, scale decisions, gray suspicions, SLO
   breaches, message receives) into the ordered chain the report
   emits; the nearest chaos record names the injecting worker.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

#: causal-chain kind priorities: lower ranks closer to "cause".
_CHAIN_RANK = {"chaos": 0, "recovery.fsm": 1, "scale.decision": 2,
               "health.gray-suspect": 3, "slo.breach": 4,
               "msg.recv": 5}
#: payload fields worth carrying into a chain entry (bounded: a chain
#: is a pointer into the bundle, not a second copy of it)
_CHAIN_FIELDS = ("epoch", "chaos_kind", "targets", "worker", "state",
                 "action", "verb", "window", "reasons", "audited")
_CHAIN_LIMIT = 16


def _channel_key(name: str) -> Tuple[str, int]:
    """Natural channel order: ``ring/v2`` before ``ring/v10`` (string
    sort would not), prefix first — deterministic and human-sane."""
    m = re.match(r"^(.*?)(\d+)$", str(name))
    if m:
        return (m.group(1), int(m.group(2)))
    return (str(name), -1)


def _ledger_sides(bundle: dict) -> Optional[Tuple[List[dict],
                                                  List[dict]]]:
    """The (expected, actual) entry lists, or None when the bundle
    holds fewer than two comparable ledgers."""
    ledgers = bundle.get("ledgers")
    if not isinstance(ledgers, dict):
        return None
    sides = {k: v for k, v in ledgers.items() if isinstance(v, list)}
    if "expected" in sides and "actual" in sides:
        return sides["expected"], sides["actual"]
    if len(sides) == 2:
        a, b = sorted(sides)
        return sides[a], sides[b]
    return None


def _first_divergent_epoch(expected: List[dict], actual: List[dict]
                           ) -> Tuple[Optional[int], List[str]]:
    """Bisect to the first epoch whose single-entry cross-diff is
    non-empty; evidence is that epoch's findings verbatim."""
    from clonos_tpu_torch.obs.audit import diff_ledgers_cross
    ea = {int(e["epoch"]): e for e in expected if "epoch" in e}
    aa = {int(e["epoch"]): e for e in actual if "epoch" in e}
    for ep in sorted(set(ea) | set(aa)):
        pair_e = [ea[ep]] if ep in ea else []
        pair_a = [aa[ep]] if ep in aa else []
        findings = diff_ledgers_cross(pair_e, pair_a)
        if findings:
            return ep, list(findings)
    return None, []


def _divergent_channels(expected: List[dict], actual: List[dict],
                        epoch: int) -> List[str]:
    """Every channel whose (count, fp) differs at ``epoch``, natural
    order. Exact comparison — cross-layout epochs fall back to the
    channel named in the diff findings instead."""
    ea = {int(e["epoch"]): e for e in expected if "epoch" in e}
    aa = {int(e["epoch"]): e for e in actual if "epoch" in e}
    ce = (ea.get(epoch) or {}).get("channels") or {}
    ca = (aa.get(epoch) or {}).get("channels") or {}
    if (ea.get(epoch) or {}).get("layout") \
            != (aa.get(epoch) or {}).get("layout"):
        return []
    out = [name for name in set(ce) | set(ca)
           if ce.get(name) != ca.get(name)]
    return sorted(out, key=_channel_key)


_CHANNEL_IN_FINDING = re.compile(r"channel (\S+?):")


def _channel_from_findings(findings: List[str]) -> Optional[str]:
    for line in findings:
        m = _CHANNEL_IN_FINDING.search(line)
        if m:
            return m.group(1)
    return None


# --- determinant descent -----------------------------------------------------


def _det_sides(bundle: dict, epoch: int
               ) -> Optional[Tuple[dict, dict]]:
    dets = bundle.get("determinants")
    if not isinstance(dets, dict):
        return None
    entry = dets.get(str(epoch))
    if not isinstance(entry, dict):
        return None
    e, a = entry.get("expected"), entry.get("actual")
    if isinstance(e, dict) and isinstance(a, dict) \
            and "logs" in e and "logs" in a:
        return e, a
    return None


def _first_divergent_log_row(e: dict, a: dict, flat: str
                             ) -> Optional[dict]:
    """First differing verbatim determinant row of one subtask's log
    window — named as (lane tag, subtask, seq)."""
    from clonos_tpu_torch.causal import determinant as det
    rows_e = ((e.get("logs") or {}).get(flat) or {}).get("rows")
    rows_a = ((a.get("logs") or {}).get(flat) or {}).get("rows")
    if rows_e is None or rows_a is None:
        return None
    n = max(len(rows_e), len(rows_a))
    for i in range(n):
        re_i = rows_e[i] if i < len(rows_e) else None
        ra_i = rows_a[i] if i < len(rows_a) else None
        if re_i != ra_i:
            row = ra_i if ra_i is not None else re_i
            tag = int(row[det.LANE_TAG]) if row else -1
            return {"kind": "log-row", "subtask": str(flat),
                    "seq": i, "lane_tag": tag,
                    "tag": (det.TAG_NAMES[tag]
                            if 0 <= tag < det.NUM_TAGS else "?"),
                    "missing_side": ("actual" if ra_i is None else
                                     "expected" if re_i is None
                                     else None)}
    return None


def _first_divergent_ring_step(e: dict, a: dict, vid: str
                               ) -> Optional[dict]:
    """First ring step whose per-step summary flipped, and WHICH field
    flipped — values-only with keys/timestamps/counts intact is the
    unlogged-salt signature."""
    steps_e = (e.get("rings") or {}).get(vid)
    steps_a = (a.get("rings") or {}).get(vid)
    if steps_e is None or steps_a is None:
        return None
    n = max(len(steps_e), len(steps_a))
    for i in range(n):
        se = steps_e[i] if i < len(steps_e) else None
        sa = steps_a[i] if i < len(steps_a) else None
        if se == sa:
            continue
        if se is None or sa is None:
            field = "missing-step"
        elif se.get("n") != sa.get("n"):
            field = "count"
        elif se.get("kdig") != sa.get("kdig"):
            field = "keys"
        elif se.get("vdig") != sa.get("vdig"):
            field = "values"
        else:
            field = "timestamps"
        return {"kind": "ring-step", "vertex": str(vid), "seq": i,
                "field": field}
    return None


def _logs_identical(e: dict, a: dict) -> bool:
    return (e.get("logs") or {}) == (a.get("logs") or {})


def _descend_determinants(bundle: dict, epoch: int,
                          channel: Optional[str]) -> Optional[dict]:
    sides = _det_sides(bundle, epoch)
    if sides is None or channel is None:
        return None
    e, a = sides
    if channel.startswith("log/"):
        return _first_divergent_log_row(e, a, channel[len("log/"):])
    m = re.match(r"^ring(?:sum)?/v(\d+)$", channel)
    if m:
        hit = _first_divergent_ring_step(e, a, m.group(1))
        if hit is not None and _logs_identical(e, a):
            hit["note"] = ("determinant log rows identical — "
                           "unlogged nondeterminism "
                           "(the examples/audit_nondet.py class)")
        return hit
    return None


# --- causal chain ------------------------------------------------------------


def _timeline_merged(bundle: dict) -> List[dict]:
    from clonos_tpu_torch.obs.timeline import merge_records
    tl = bundle.get("timeline")
    return merge_records([r for r in tl if isinstance(r, dict)]) \
        if isinstance(tl, list) else []


def _seal_position(merged: List[dict], epoch: Optional[int]) -> int:
    """Index just past the divergent epoch's seal record (the walk-back
    anchor); the whole timeline when no seal matches."""
    if epoch is not None:
        for i, rec in enumerate(merged):
            if rec.get("kind") == "epoch.seal" \
                    and rec.get("epoch") == epoch:
                return i + 1
    return len(merged)


def _causal_chain(merged: List[dict], anchor: int) -> List[dict]:
    """Walk backward from the anchor collecting rankable records; emit
    them ordered by (kind priority, proximity to the seal)."""
    hits: List[Tuple[int, int, dict]] = []
    for back, rec in enumerate(reversed(merged[:anchor])):
        kind = rec.get("kind")
        if kind not in _CHAIN_RANK:
            continue
        entry = {"kind": kind, "hlc": rec.get("hlc"),
                 "service": rec.get("service")}
        for field in _CHAIN_FIELDS:
            if field in rec:
                entry[field] = rec[field]
        hits.append((_CHAIN_RANK[kind], back, entry))
        if len(hits) >= 4 * _CHAIN_LIMIT:
            break
    hits.sort(key=lambda t: (t[0], t[1]))
    out = []
    for rank, (_, _, entry) in enumerate(hits[:_CHAIN_LIMIT]):
        entry["rank"] = rank
        out.append(entry)
    return out


def _injector(chain: List[dict]) -> Optional[str]:
    """The injecting worker: the highest-ranked chaos record's targets
    (or service when untargeted)."""
    for entry in chain:
        if entry.get("kind") != "chaos":
            continue
        targets = entry.get("targets")
        if isinstance(targets, list) and targets:
            return ",".join(str(t) for t in targets)
        return entry.get("service")
    return None


# --- the analyzer ------------------------------------------------------------


def analyze_bundle(bundle: dict) -> dict:
    """The pure localization: bundle in, report dict out. Every field
    derives only from bundle content — re-running in a fresh process
    reproduces the report byte for byte."""
    trigger = bundle.get("trigger") or {}
    info = bundle.get("bundle") or {}
    report: Dict[str, Any] = {
        "report": "clonos-incident-rootcause/v1",
        "bundle_fingerprint": info.get("fingerprint"),
        "schema_fingerprint": info.get("schema_fingerprint"),
        "trigger": trigger,
        "first_divergent_epoch": None,
        "first_divergent_channel": None,
        "divergent_channels": [],
        "evidence": [],
        "determinant": None,
        "injected_by": None,
        "causal_chain": [],
        "verdict": "insufficient-evidence",
    }

    sides = _ledger_sides(bundle)
    epoch: Optional[int] = None
    channel: Optional[str] = None
    if sides is not None:
        expected, actual = sides
        epoch, evidence = _first_divergent_epoch(expected, actual)
        report["evidence"] = evidence
        if epoch is None:
            report["verdict"] = "no-divergence"
        else:
            report["first_divergent_epoch"] = epoch
            chans = _divergent_channels(expected, actual, epoch)
            report["divergent_channels"] = chans
            channel = (chans[0] if chans
                       else _channel_from_findings(evidence))
            report["first_divergent_channel"] = channel

    if epoch is None and trigger.get("epoch") is not None:
        # No ledger pair (or none divergent): anchor the chain on the
        # trigger's epoch so the walk-back still explains *something*.
        epoch = int(trigger["epoch"])

    report["determinant"] = _descend_determinants(
        bundle, epoch, channel) if epoch is not None else None

    merged = _timeline_merged(bundle)
    chain = _causal_chain(merged, _seal_position(merged, epoch))
    report["causal_chain"] = chain
    report["injected_by"] = _injector(chain)

    if report["first_divergent_channel"] is not None:
        report["verdict"] = ("localized"
                             if report["determinant"] is not None
                             else "localized-channel")
    return report


def render_report(report: dict) -> str:
    """The one byte encoding of a report (canonical JSON + newline) —
    what ``incident explain --report json`` prints and what the
    byte-identity acceptance check compares."""
    from clonos_tpu_torch.obs.incident import canonical_json
    return canonical_json(report) + "\n"


def format_report(report: dict) -> str:
    """Human-readable rendering of a report (the default ``incident
    explain`` output). Derived from the same report dict — the JSON
    form stays the auditable artifact."""
    lines = [f"verdict: {report.get('verdict')}",
             f"trigger: {(report.get('trigger') or {}).get('kind')}"
             f" (bundle {report.get('bundle_fingerprint')})"]
    ep = report.get("first_divergent_epoch")
    if ep is not None:
        lines.append(f"first divergent epoch: {ep}")
    ch = report.get("first_divergent_channel")
    if ch is not None:
        others = [c for c in report.get("divergent_channels", [])
                  if c != ch]
        suffix = f" (+{len(others)} more)" if others else ""
        lines.append(f"first divergent channel: {ch}{suffix}")
    det = report.get("determinant")
    if det:
        if det.get("kind") == "log-row":
            lines.append(
                f"first divergent determinant row: subtask "
                f"{det.get('subtask')} seq {det.get('seq')} "
                f"tag {det.get('tag')} (lane {det.get('lane_tag')})")
        else:
            lines.append(
                f"first divergent determinant row: ring v"
                f"{det.get('vertex')} step {det.get('seq')} "
                f"[{det.get('field')}]")
        if det.get("note"):
            lines.append(f"  note: {det['note']}")
    inj = report.get("injected_by")
    if inj is not None:
        lines.append(f"injected by: {inj}")
    for e in report.get("evidence", [])[:4]:
        lines.append(f"evidence: {e}")
    chain = report.get("causal_chain", [])
    if chain:
        lines.append("causal chain (ranked):")
        for entry in chain[:8]:
            extra = {k: v for k, v in entry.items()
                     if k not in ("rank", "kind", "hlc", "service")}
            lines.append(f"  #{entry.get('rank')} {entry.get('kind')}"
                         f" @{entry.get('service')} {extra}")
    return "\n".join(lines)


class RootCauseAnalyzer:
    """Thin object facade over :func:`analyze_bundle` (symmetry with
    Auditor/GrayFailureDetector; the function is the substance)."""

    def analyze(self, bundle: dict) -> dict:
        return analyze_bundle(bundle)

    def explain(self, path: str) -> dict:
        from clonos_tpu_torch.obs.incident import load_bundle
        return analyze_bundle(load_bundle(path))
