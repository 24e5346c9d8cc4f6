"""Share of its roofline the keyed-histogram kernel reaches
(``ops/csrc/keyed_hist.cu`` via ``ops/histogram.py``): the summed least
times of the stretch's launches over the summed device time of the
``hist_`` kernels in the trace. Each launch's shape is the one the
program handed the launcher (``TraceStretch.hist_shapes``); their number
has to agree with the kernels in the trace and with
``keyed_hist.launches``, or the metric is left out."""

import sys

from portbench.roofline import hist_bound_s


def read(ctx):
    s = ctx.tracer.summary if ctx.tracer is not None else None
    if not s or not s["hist_kernels"]:
        return None
    shapes = ctx.tracer.hist_shapes
    if not (s["hist_kernels"] == s["hist_launches"] == len(shapes)):
        print(f"[keyed_hist_roofline] {s['hist_kernels']} kernels traced, "
              f"{s['hist_launches']} launches counted, {len(shapes)} "
              f"shapes recorded: left out", file=sys.stderr)
        return None
    bound = sum(hist_bound_s(x)[0] for x in shapes)
    return 100.0 * bound / s["hist_s"]
