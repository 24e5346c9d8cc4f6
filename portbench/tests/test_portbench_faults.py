"""The comparison fails when it should: each fault planted under the
timed path, and each control that breaks a guarantee the configuration
states, turns ``correct`` false at a tiny size on the CPU (the same
readings at the cells' own sizes come from ``portbench.controls`` on
the card)."""

import pytest

from portbench import controls
from portbench.tests.conftest import CELLS, tiny

#: what each fault or control can break, per cell
CASES = [(c, f) for c in CELLS
         for f in ("state_unchanged", "half_batch", "answer_altered",
                   "drop_overflow")] + [("allround.recover", "rollback")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails_the_comparison(cell, fault):
    r = controls.read(cell, 424242, 0.5, fault, "cpu", tiny(cell))
    assert not r["correct"], r["compared"]
    assert any(v > 0 for v in r["compared"].values())


def test_sound_run_passes():
    r = controls.read("allround.recover", 424242, 0.5, "none", "cpu",
                      tiny("allround.recover"))
    assert r["correct"] and not any(r["compared"].values())


def test_rollback_fails_the_recovered_number():
    r = controls.read("allround.recover", 7, 0.5, "rollback", "cpu",
                      tiny("allround.recover"))
    assert r["compared"]["recovered"] > 0
    assert all(v == 0 for k, v in r["compared"].items() if k != "recovered")
