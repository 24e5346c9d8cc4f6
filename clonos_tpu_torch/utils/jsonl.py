"""Durable JSONL, the reading half (port of the part of
``clonos_tpu/utils/jsonl.py`` the tiered store uses).

Every append-only log shares one crash model: a killed writer leaves at
most one torn final record. The reader rule:

- blank lines are skipped;
- a decode failure on the LAST non-empty line is the expected kill
  artifact and is dropped silently;
- a decode failure on any earlier line is real corruption and raises —
  ``json.JSONDecodeError`` by default, or ``ValueError`` naming
  ``<label>:<lineno>`` when the caller passes ``label``.

The writing half is one flushed ``json.dumps`` line per append
(``storage/tiered.py``'s segment index does its own).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence


def parse_jsonl_lines(lines: Sequence[str],
                      label: Optional[str] = None) -> List[dict]:
    """Decode JSONL lines under the torn-tail rule above."""
    nonempty = [(i, ln) for i, ln in enumerate(lines) if ln.strip()]
    out: List[dict] = []
    for pos, (i, ln) in enumerate(nonempty):
        try:
            out.append(json.loads(ln))
        except json.JSONDecodeError:
            if pos == len(nonempty) - 1:
                break        # torn final append
            if label is not None:
                raise ValueError(
                    f"{label}:{i + 1}: undecodable record "
                    f"(not a truncated tail)")
            raise
    return out


def read_jsonl(path: str, label: Optional[str] = None) -> List[dict]:
    """Read a JSONL file tail-tolerantly; a missing file is an empty log
    (the first append creates it)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        lines = f.read().splitlines()
    return parse_jsonl_lines(lines, label=label)
