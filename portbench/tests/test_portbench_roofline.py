"""The keyed histogram's byte count and bound against PERF.md's kernel
table, where chip_smoke's phase 2 timed the same shapes."""

import pytest

from portbench import harness
from portbench.roofline import HistLaunch, hist_bound_s, hist_bytes


@pytest.mark.parametrize("rows,width,keys,counts,bound_us", [
    (512, 1024, 8192, True, 11.42),     # route R=512 B=1024 nk=8192
    (512, 1024, 1024, True, 2.66),      # lane
    (512, 512, 8192, True, 10.72),      # configs #4/#5 route
    (4096, 1024, 997, False, 16.14),    # window
    (512, 1024, 8192, False, 6.42),     # route, sums
    (8192, 512, 499, False, 16.15),     # config #4 window
])
def test_bound_matches_the_kernel_table(rows, width, keys, counts,
                                        bound_us):
    launch = HistLaunch(rows, width, keys, counts, kept=rows * width)
    t, kind = hist_bound_s(launch)
    assert kind == "bytes"
    assert t * 1e6 == pytest.approx(bound_us, abs=0.006)


def test_bytes_count_inputs_once_and_outputs_once():
    assert hist_bytes(HistLaunch(2, 3, 5, False, 6)) == 2 * 3 * 9 + 2 * 5 * 4
    assert hist_bytes(HistLaunch(2, 3, 5, True, 6)) == 2 * 3 * 9 + 2 * 5 * 8


def test_a_tiny_launch_is_bound_by_operations():
    _, kind = hist_bound_s(HistLaunch(1, 1, 1, True, kept=10 ** 9))
    assert kind == "operations"


def test_launch_shapes_are_recorded_as_launched(monkeypatch):
    """The traced stretch records each launch's shape as the program hands
    it to the launcher, and puts the launcher back when it closes."""
    import torch
    from clonos_tpu_torch.ops import histogram
    from portbench.trace import TraceStretch
    calls = []
    monkeypatch.setattr(histogram, "keyed_hist_cuda",
                        lambda k, v, m, nk, want_counts=True:
                        calls.append((k.shape, nk, want_counts)))
    launcher = histogram.keyed_hist_cuda
    tr = TraceStretch(None, 0.0, 1)
    tr._record_hist_shapes()
    keys = torch.zeros((6, 40), dtype=torch.int32)
    histogram.keyed_hist_cuda(keys, keys, keys != 0, 997, False)
    histogram.keyed_hist_cuda(keys[:2], keys[:2], keys[:2] != 0, 5)
    tr._restore()
    assert histogram.keyed_hist_cuda is launcher and len(calls) == 2
    assert tr.hist_shapes == [HistLaunch(6, 40, 997, False, 240),
                              HistLaunch(2, 40, 5, True, 80)]


class _Tracer:
    def __init__(self, kernels, launches, shapes, hist_s):
        self.summary = {"hist_kernels": kernels, "hist_launches": launches,
                        "hist_s": hist_s}
        self.hist_shapes = shapes


class _Ctx:
    def __init__(self, tracer):
        self.tracer = tracer


def test_roofline_reads_the_recorded_shapes():
    read = harness.metric_reader("keyed_hist_roofline.steady").read
    shape = HistLaunch(4096, 16384, 997, False, 4096 * 16384)
    t = hist_bound_s(shape)[0]
    assert read(_Ctx(_Tracer(2, 2, [shape, shape], 4 * t))) == \
        pytest.approx(50.0)
    # A compacted edge is charged at the width it is launched with.
    half = shape._replace(width=8192, kept=4096 * 8192)
    assert read(_Ctx(_Tracer(1, 1, [half], t))) == pytest.approx(
        100.0 * hist_bound_s(half)[0] / t)
    assert read(_Ctx(_Tracer(1, 1, [half], t))) < 60.0
    # Counts that disagree leave the metric out, as does a silent kernel.
    assert read(_Ctx(_Tracer(2, 1, [shape], t))) is None
    assert read(_Ctx(_Tracer(0, 0, [], 0.0))) is None
