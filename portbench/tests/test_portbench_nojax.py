"""No module the benchmark runs has the top-level name jax, jaxlib, flax
or clonos_tpu: checked in a fresh interpreter after a whole tiny run, and
the check compares whole top-level names (the port's own name begins
with the JAX package's)."""

import json
import subprocess
import sys

from portbench import harness

PROBE = """
import json, sys
from portbench import harness
from portbench.tests.conftest import tiny
for cell in ("allround.recover", "kafka_window.paced"):
    harness.run_cell(cell, 3, 0.4, True, "cpu", overrides=tiny(cell))
import portbench.run, portbench.controls, portbench.sweep
print(json.dumps({"bad": harness.forbidden_modules(),
                  "port": "clonos_tpu_torch" in sys.modules}))
"""


def test_a_run_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          text=True, cwd=harness.CHECKOUT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "port": True}


def test_names_are_compared_whole():
    probe = ("import sys, types\n"
             "from portbench import harness\n"
             "sys.modules['clonos_tpu_torch_extra'] = types.ModuleType('x')\n"
             "assert harness.forbidden_modules() == []\n"
             "sys.modules['clonos_tpu.ops'] = types.ModuleType('y')\n"
             "sys.modules['jaxlib'] = types.ModuleType('z')\n"
             "print(harness.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, cwd=harness.CHECKOUT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "['clonos_tpu.ops', 'jaxlib']"


def test_the_command_refuses_to_run_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "allround.steady", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=harness.CHECKOUT, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
