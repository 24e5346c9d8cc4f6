"""An untraced run, the one compared between commits, runs with the
program's tracer off: every block of the window sees the NullTracer."""

import pytest

from clonos_tpu_torch import obs
from clonos_tpu_torch.runtime.executor import LocalExecutor
from portbench import harness
from portbench.tests.conftest import CELLS, tiny


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_installs_no_program_tracer(cell, monkeypatch):
    seen = []
    inner = LocalExecutor._run_block

    def recorded(self, k):
        seen.append(obs.get_tracer())
        return inner(self, k)
    monkeypatch.setattr(LocalExecutor, "_run_block", recorded)
    out = harness.run_cell(cell, 11, 0.5, False, "cpu",
                           overrides=tiny(cell))
    assert out["line"]["correct"]
    assert seen and all(isinstance(t, obs.NullTracer) for t in seen)
    assert isinstance(obs.get_tracer(), obs.NullTracer)
