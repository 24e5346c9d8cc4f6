"""Hybrid logical clocks (port of ``clonos_tpu/obs/hlc.py``): a
causally-consistent order for cross-process events without trusting
wall clocks.

The repo now emits evidence from several processes (trace JSONL per
service, audit ledgers, decision logs) and joining them by wall clock
breaks the moment a second host is involved — two hosts' clocks can
disagree by more than a control round-trip, so a DEPLOY can appear to
be *received* before it was *sent*. The paper's causal-logging core is
exactly about ordering cross-worker events without that trust; the HLC
(Kulkarni et al., "Logical Physical Clocks") is the standard fix:

- a timestamp is ``(l, c, node)`` — ``l`` tracks the largest physical
  time witnessed (µs), ``c`` breaks ties among events sharing one
  ``l``, ``node`` breaks ties among processes;
- every *send* ticks the local clock and stamps the outgoing header;
- every *receive* folds the sender's stamp in (``l' >= l_sender``, and
  ``c' > c_sender`` when the physical components tie), so a receive
  ALWAYS orders after its send regardless of clock skew;
- ``l`` stays within one clock-uncertainty bound of real time, so
  HLC order is still human-readable as "roughly wall order".

Convention (matching NullTracer / NullAuditor / NullProfiler): the
process-global clock starts as :class:`NullHLC` — ``wire_stamp()`` is
None so senders add NO wire field and the wire bytes stay identical to
a pre-HLC build. :func:`configure_hlc` is the explicit opt-in;
``parallel/transport.py``'s ``attach_hlc`` / ``adopt_hlc`` ride the
same header path as ``attach_trace`` (DEPLOY / HEARTBEAT / FETCH_EDGE /
DETERMINANT_REQUEST / serve verbs).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Tuple

#: one HLC timestamp: (l: µs physical witness, c: logical tiebreak,
#: node: process tiebreak). Tuple compare IS the total order.
Stamp = Tuple[int, int, str]


def stamp_key(stamp) -> Stamp:
    """Normalize a wire/JSONL-shaped stamp (list or tuple) into the
    comparable (l, c, node) tuple."""
    return (int(stamp[0]), int(stamp[1]), str(stamp[2]))


class NullHLC:
    """The disabled clock: no state, no wire field, zero overhead."""

    enabled = False
    node = None

    def tick(self) -> None:
        return None

    def observe(self, remote) -> None:
        return None

    def wire_stamp(self) -> None:
        return None


class HybridLogicalClock:
    """One process's hybrid logical clock. Thread-safe: ticks happen on
    the main loop, server threads and heartbeat threads alike."""

    enabled = True

    def __init__(self, node: Optional[str] = None,
                 # clonos: allow(wallclock): the physical component of
                 # the HLC — correlation metadata, never operator state.
                 clock=time.time):
        # clonos: allow(entropy): pid is a per-process tiebreaker in
        # ordering metadata, never replayed data.
        self.node = str(node) if node is not None else f"pid{os.getpid()}"
        self._clock = clock
        self._l = 0
        self._c = 0
        self._lock = threading.Lock()

    def _pt(self) -> int:
        return int(self._clock() * 1e6)

    def tick(self) -> Stamp:
        """Advance for a local or send event; returns the new stamp."""
        with self._lock:
            pt = self._pt()
            if pt > self._l:
                self._l, self._c = pt, 0
            else:
                self._c += 1
            return (self._l, self._c, self.node)

    def observe(self, remote) -> Stamp:
        """Fold a received stamp in (the receive rule): the result is
        strictly greater than BOTH the sender's stamp and this clock's
        previous stamp, whatever the wall clocks said."""
        l_m, c_m, _ = stamp_key(remote)
        with self._lock:
            pt = self._pt()
            l = max(self._l, l_m, pt)
            if l == self._l and l == l_m:
                c = max(self._c, c_m) + 1
            elif l == self._l:
                c = self._c + 1
            elif l == l_m:
                c = c_m + 1
            else:
                c = 0
            self._l, self._c = l, c
            return (l, c, self.node)

    def wire_stamp(self) -> Stamp:
        """Tick and return the stamp a control-wire header carries."""
        return self.tick()


# --- process-global clock ----------------------------------------------------

_global_hlc = NullHLC()
_global_lock = threading.Lock()


def get_hlc():
    """The process clock (NullHLC unless :func:`configure_hlc` ran)."""
    return _global_hlc


def configure_hlc(node: Optional[str] = None,
                  **kw) -> HybridLogicalClock:
    """Install a real process clock (the opt-in gate, like
    ``obs.configure`` for tracing)."""
    global _global_hlc
    with _global_lock:
        _global_hlc = HybridLogicalClock(node, **kw)
        return _global_hlc


def reset_hlc() -> None:
    """Back to the disabled NullHLC (tests)."""
    global _global_hlc
    with _global_lock:
        _global_hlc = NullHLC()
