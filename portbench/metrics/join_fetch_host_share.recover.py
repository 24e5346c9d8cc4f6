"""Share, in percent, of the determinant rows a recovery obtained that
were fetched to the host and parsed there: the summed ``host_rows`` over
the summed ``rows`` of the program's ``recovery.fetch_determinants``
spans (``runtime/cluster.py`` ``recover``). None where no such span was
recorded, or records were dropped."""

from portbench.spans import phase_spans


def read(ctx):
    spans = phase_spans(ctx, "recovery.fetch_determinants", "rows")
    rows = sum(s["args"]["rows"] for s in spans)
    if not rows:
        return None
    return 100.0 * sum(s["args"]["host_rows"] for s in spans) / rows
