"""The program's span records of a traced window (``ctx.spans``, kept by
a driver that installed the program's tracer), for the metric readers."""

from typing import Dict, List


def phase_spans(ctx, name: str, counter: str) -> List[Dict]:
    """Records of span ``name`` that carry ``counter``; empty where the
    run kept no records, or the tracer's ring dropped some (a partial
    sum would read as a real one)."""
    spans = getattr(ctx, "spans", None)
    if not spans or getattr(ctx, "spans_dropped", 0):
        return []
    return [s for s in spans if s["name"] == name
            and counter in s.get("args", {})]
