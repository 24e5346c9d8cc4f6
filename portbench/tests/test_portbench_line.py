"""The result line's keys, with and without ``--trace 1``, and the
compared numbers last."""

import json

import pytest

from portbench import harness
from portbench.tests.conftest import tiny


@pytest.mark.parametrize("trace", [False, True])
def test_line_keys(trace):
    cell = "allround.steady"
    out = harness.run_cell(cell, 9, 0.8, trace, "cpu", overrides=tiny(cell))
    line = out["line"]
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "compared"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    m = harness.manifest()
    if not trace:
        want = {e["name"] for e in m["end_to_end"]
                if cell in e.get("workloads", [cell])}
        assert set(line["metrics"]) == want
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        allowed = {e["name"] for e in m["per_layer"]
                   if cell in e["workloads"]}
        # Host-clock and span readings exist on the CPU too; device
        # readings of a CPU run are not the card's and carry no weight.
        assert {"fence_wait_ms.steady", "block_host_ms.steady"} <= set(
            line["metrics"]) <= allowed
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    for c in line["compared"].values():
        assert c == {"value": 0, "limit": 0}
    json.dumps(line)


def test_idle_share_is_not_clamped():
    from portbench.trace import idle_share
    base = {"window_s": 2.0, "device_operations": 10}
    assert idle_share(dict(base, busy_s=0.5)) == pytest.approx(0.75)
    # A busy union longer than the window reads below 0: a fault shows.
    assert idle_share(dict(base, busy_s=2.2)) == pytest.approx(-0.1)
    assert idle_share(dict(base, busy_s=0.5, device_operations=0)) is None
