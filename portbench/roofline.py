"""The card's peaks and the least time a kernel launch could take.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit: HBM
at 3.35 TB/s and 67 TFLOP/s of float32 (here: int32) outside the tensor
cores. A launch's bound counts each input byte read once and each output
byte written once, and one add per record it keeps per output table.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


class HistLaunch(NamedTuple):
    """One keyed-histogram launch: ``rows`` rows of ``width`` records
    (int32 key and value, bool valid) into ``keys`` int32 sums (and counts
    with ``counts``), examining ``kept`` records. A row is charged at the
    width it is launched with: the kernel reads every slot of it, live or
    padding, so a dense edge's bound is the dense layout's."""

    rows: int
    width: int
    keys: int
    counts: bool
    kept: int


def hist_bytes(launch: HistLaunch) -> int:
    r, b, nk = launch.rows, launch.width, launch.keys
    return r * b * 9 + r * nk * 4 * (2 if launch.counts else 1)


def hist_bound_s(launch: HistLaunch) -> Tuple[float, str]:
    """The least seconds the launch takes, and which peak bounds it."""
    t_bytes = hist_bytes(launch) / HBM_BYTES_PER_S
    t_ops = launch.kept * (2 if launch.counts else 1) / SCALAR_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
