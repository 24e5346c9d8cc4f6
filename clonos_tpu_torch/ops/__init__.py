"""Hand-written kernels and their plain versions.

A kernel wrapper that a span should count registers its launch counter
in :data:`LAUNCH_COUNTERS`; the recovery's replay span
(``runtime/cluster.py``) records each one's launches under its name.
"""

from __future__ import annotations

from typing import Callable, Dict

#: span counter name -> a reader of a kernel's launch count
LAUNCH_COUNTERS: Dict[str, Callable[[], int]] = {}


def launch_counts() -> Dict[str, int]:
    """Every registered kernel's launch count, by counter name."""
    return {name: read() for name, read in LAUNCH_COUNTERS.items()}
