"""Observability planes of the port (``clonos_tpu/obs``): tracing and
the recovery flight recorder (``obs/trace.py``, with its Chrome export in
``obs/chrome.py``), the overhead attribution profiler
(``obs/profile.py``), the metrics history ring (``obs/history.py``), the
exactly-once audit (per-epoch digests sealed into a ledger, re-validated
after recovery; ``obs/audit.py``, ``obs/digest.py``), and the
cross-process planes: hybrid logical clocks and the causal timeline
(``obs/hlc.py``, ``obs/timeline.py``), gray-failure detection
(``obs/detect.py``), incident bundles and their root-cause analysis
(``obs/incident.py``, ``obs/rootcause.py``) and record lineage
(``obs/lineage.py``). Every plane is off until configured. Typical use::

    from clonos_tpu_torch import obs

    obs.configure("runner", path="traces/trace-runner.jsonl")
    obs.configure_profile()
    with obs.get_tracer().span("my.phase"):
        ...
"""

from .trace import (NullTracer, Tracer, configure, get_tracer,  # noqa: F401
                    reset)
from .chrome import (load_jsonl, summarize, to_chrome,  # noqa: F401
                     validate_chrome)
from .digest import EpochDigest, diff, diff_ledgers  # noqa: F401
from .audit import (Auditor, NullAuditor, configure_audit,  # noqa: F401
                    digest_epoch_window, get_auditor, reset_audit)
from .profile import (NullProfiler, Profiler, configure_profile,  # noqa: F401
                      get_profiler, reset_profile)
from .history import MetricsHistory, read_history_file  # noqa: F401
from .hlc import (HybridLogicalClock, NullHLC, configure_hlc,  # noqa: F401
                  get_hlc, reset_hlc, stamp_key)
from .timeline import (NullTimeline, TimelineStore,  # noqa: F401
                       causality_inversions,
                       causality_inversions_stream, configure_timeline,
                       diff_timelines, from_trace_records, get_timeline,
                       iter_merged, merge_records, read_timeline,
                       reset_timeline, timeline_self_check,
                       to_trace_records)
from .detect import (DetectorConfig, DetectorState,  # noqa: F401
                     GrayFailureDetector, GraySnapshot, GrayVerdict,
                     NullDetector, configure_detector, detect_gray,
                     get_detector, reset_detector, score_gray)
from .incident import (IncidentManager, NullIncidentManager,  # noqa: F401
                       bundle_fingerprint, bundle_schema_fingerprint,
                       capture_epoch_window, configure_incidents,
                       get_incidents, incident_self_check, load_bundle,
                       reset_incidents, summarize_window)
from .rootcause import (RootCauseAnalyzer, analyze_bundle,  # noqa: F401
                        format_report, render_report)
from .lineage import (LineagePlane, NullLineage,  # noqa: F401
                      configure_lineage, dye_hash, format_trace,
                      get_lineage, lineage_schema_fingerprint,
                      lineage_self_check, read_observations,
                      reconstruct, render_trace, reset_lineage,
                      select_dyed, trace_key)

__all__ = ["Tracer", "NullTracer", "get_tracer", "configure", "reset",
           "load_jsonl", "to_chrome", "validate_chrome", "summarize",
           "EpochDigest", "diff", "diff_ledgers",
           "Auditor", "NullAuditor", "get_auditor", "configure_audit",
           "reset_audit", "digest_epoch_window",
           "Profiler", "NullProfiler", "get_profiler",
           "configure_profile", "reset_profile",
           "MetricsHistory", "read_history_file",
           "HybridLogicalClock", "NullHLC", "get_hlc", "configure_hlc",
           "reset_hlc", "stamp_key",
           "TimelineStore", "NullTimeline", "get_timeline",
           "configure_timeline", "reset_timeline", "read_timeline",
           "merge_records", "causality_inversions", "diff_timelines",
           "from_trace_records", "to_trace_records",
           "timeline_self_check",
           "GraySnapshot", "GrayVerdict", "DetectorConfig",
           "DetectorState", "GrayFailureDetector", "NullDetector",
           "detect_gray", "score_gray", "get_detector",
           "configure_detector", "reset_detector",
           "iter_merged", "causality_inversions_stream",
           "IncidentManager", "NullIncidentManager", "get_incidents",
           "configure_incidents", "reset_incidents", "load_bundle",
           "bundle_fingerprint", "bundle_schema_fingerprint",
           "capture_epoch_window", "summarize_window",
           "incident_self_check",
           "RootCauseAnalyzer", "analyze_bundle", "render_report",
           "format_report",
           "LineagePlane", "NullLineage", "get_lineage",
           "configure_lineage", "reset_lineage", "select_dyed",
           "dye_hash", "read_observations", "reconstruct",
           "trace_key", "render_trace", "format_trace",
           "lineage_schema_fingerprint", "lineage_self_check"]
