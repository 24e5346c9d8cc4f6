"""Each driver at a tiny size on the CPU, held to the plain reference:
every compared number 0, and each run does its cell's work."""

import pytest

from portbench import harness
from portbench.tests.conftest import CELLS, tiny


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_cpu(cell):
    out = harness.run_cell(cell, 2 ** 31 + 11, 0.6, False, "cpu",
                           overrides=tiny(cell))
    line = out["line"]
    assert line["correct"], out["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(v == 0 for v in out["compared"].values())
    ctx = out["ctx"]
    if cell == "allround.recover":
        # Recoveries ran and each one's state was compared.
        assert len(ctx.results["recovered"]) == line["attempted"]
        assert "recovered" in out["compared"]
        assert set(ctx.results["recovery_kinds"]) <= {
            "+".join(k) for k in ctx.cell["kills"]}
    if cell == "kafka_window.paced":
        # A fixed amount of work: the epochs the rate fills.
        per_epoch = ctx.records_per_epoch
        assert line["attempted"] == int(
            0.6 * ctx.cell["rate_records_per_s"] // per_epoch)


def test_samples_hold_work_to_compare():
    out = harness.run_cell("allround.steady", 5, 0.6, False, "cpu",
                           overrides=tiny("allround.steady"))
    cap = out["captured"]
    # Sampled sink steps carry fired windows' totals, and the logged draws
    # and the routed edge are full.
    assert cap["sink"] and all(m.any() for _, (_, _, _, m) in cap["sink"])
    assert cap["ring_steps"] and cap["ring"][3].all()
    assert cap["edge0"][3].sum() == 4 * 16


def test_same_seed_same_inputs():
    a = harness.Ctx("kafka_window.paced", 77, 1, False, "cpu")
    b = harness.Ctx("kafka_window.paced", 77, 1, False, "cpu")
    assert a.rng("inputs").integers(1 << 30) == b.rng("inputs").integers(
        1 << 30)
    assert a.rng("inputs").integers(1 << 30) != a.rng("kills").integers(
        1 << 30)
