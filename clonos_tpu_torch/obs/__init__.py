"""Observability planes of the port (``clonos_tpu/obs``): tracing and
the recovery flight recorder (``obs/trace.py``, with its Chrome export in
``obs/chrome.py``), the overhead attribution profiler
(``obs/profile.py``), the metrics history ring (``obs/history.py``) and
the exactly-once audit (per-epoch digests sealed into a ledger,
re-validated after recovery; ``obs/audit.py``, ``obs/digest.py``).
Typical use::

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

__all__ = ["Tracer", "NullTracer", "get_tracer", "configure", "reset",
           "load_jsonl", "to_chrome", "validate_chrome", "summarize",
           "EpochDigest", "diff", "diff_ledgers",
           "Auditor", "NullAuditor", "get_auditor", "configure_audit",
           "reset_audit", "digest_epoch_window",
           "Profiler", "NullProfiler", "get_profiler",
           "configure_profile", "reset_profile",
           "MetricsHistory", "read_history_file"]
