"""Determinant rows replayed a second, in millions: the summed ``rows``
over the summed duration of the program's ``recovery.replay`` spans
(``causal/recovery.py`` ``LogReplayer.replay``, counted in
``runtime/cluster.py`` ``recover``), from the tracer the traced window
ran with. None where no such span was recorded, or records were
dropped."""

from portbench.spans import phase_spans


def read(ctx):
    spans = phase_spans(ctx, "recovery.replay", "rows")
    if not spans:
        return None
    dur = sum(s["dur"] for s in spans)
    rows = sum(s["args"]["rows"] for s in spans)
    return rows / dur / 1e6 if dur > 0 else None
