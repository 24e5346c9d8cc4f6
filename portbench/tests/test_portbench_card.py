"""On a card: the benchmark's command runs a cell and prints a correct
result line. Skips without one."""

import json
import subprocess
import sys

import pytest

from portbench import harness


@pytest.mark.cuda
def test_command_on_the_card(cuda_card):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "allround.steady", "--seed", "2147483659", "--seconds", "3",
         "--trace", "0"],
        capture_output=True, text=True, cwd=harness.CHECKOUT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
