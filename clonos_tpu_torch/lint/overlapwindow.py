"""Rule family 5: host synchronization inside marked dispatch-only
windows.

Two window families share the machinery:

- The pipelined fence (runtime/cluster.py ``_begin_fence_tail``)
  promises that everything between its ``# clonos:
  overlap-window-begin`` / ``# clonos: overlap-window-end`` markers is
  DISPATCH-ONLY: kernel launches and non-blocking device-to-host copy
  starts, never a host wait. One stray ``.item()`` or
  ``torch.cuda.synchronize()`` there silently re-serializes the exact
  tail the pipeline exists to hide.

- The batched read path (runtime/serve.py ``_dispatch``) makes the
  twin promise for serving: the region between ``# clonos:
  serve-window-begin`` / ``# clonos: serve-window-end`` holds ONE fused
  gather dispatch for the whole coalesced key batch. A blocking host
  sync inside it re-serializes the batch back into the N round-trips
  the coalescing queue exists to avoid — the read-path headline
  regresses with no functional symptom, which is why both are lint
  rules and not tests.

Blocking: ``numpy.asarray``/``array``/``copy`` (of a tensor, a copy
that waits), ``torch.cuda.synchronize``, ``torch.tensor(...,
device=...)`` (its host-to-device copy waits for the queue, see
device.py ``scalar``), and the methods ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``.synchronize()`` and ``.wait()`` (a
``device.HostCopy``'s or an event's). Allowed: ``device.HostCopy(...)``
— the non-blocking start of a device-to-host copy — and
``copy_(..., non_blocking=True)``; neither is in the blocking set.
"""

from __future__ import annotations

import ast
from typing import List

from clonos_tpu_torch.lint.core import (FileContext, Finding, Rule,
                                        register_rule)

BEGIN = "clonos: overlap-window-begin"
END = "clonos: overlap-window-end"
SERVE_BEGIN = "clonos: serve-window-begin"
SERVE_END = "clonos: serve-window-end"

#: canonical dotted names that force a host synchronization.
SYNC_CALLS = {
    "numpy.asarray", "numpy.array", "numpy.copy",
    "torch.cuda.synchronize",
}

#: a constructor that blocks when it is given a device: it copies from
#: the host behind every queued kernel.
DEVICE_COPY_CTORS = {"torch.tensor"}

#: method names that block regardless of receiver resolution
#: (``t.item()``, ``copy.wait()``); ``HostCopy(...)`` is the allowed
#: non-blocking start and deliberately absent.
SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize", "wait"}


def _windows(ctx: FileContext, begin: str = BEGIN,
             end: str = END) -> List[tuple]:
    """(begin_line, end_line) pairs of every marked window."""
    out, start = [], None
    for i, ln in enumerate(ctx.lines, start=1):
        if begin in ln:
            start = i
        elif end in ln and start is not None:
            out.append((start, i))
            start = None
    return out


class _DispatchOnlyWindowRule(Rule):
    """Shared checker: flag blocking host syncs between a marker pair,
    plus unbalanced markers (an unclosed begin leaves its window
    silently unchecked)."""

    begin: str
    end: str
    window_desc: str

    def check(self, ctx: FileContext) -> List[Finding]:
        wins = _windows(ctx, self.begin, self.end)
        out: List[Finding] = []
        opens = sum(self.begin in ln for ln in ctx.lines)
        if opens != len(wins):
            out.append(self.finding(
                ctx, 1, f"unbalanced {self.name} markers "
                        f"({opens} begin / {len(wins)} closed)"))
        if not wins:
            return out
        seen = set()
        for node in ast.walk(ctx.tree):
            line = getattr(node, "lineno", None)
            if line is None or not any(b < line < e for b, e in wins):
                continue
            dotted = None
            if isinstance(node, (ast.Attribute, ast.Name)):
                dotted = ctx.resolve(node)
            hit = None
            if dotted in SYNC_CALLS:
                hit = dotted
            elif (isinstance(node, ast.Attribute)
                  and node.attr in SYNC_ATTRS):
                hit = f"<expr>.{node.attr}"
            elif (isinstance(node, ast.Call)
                  and ctx.resolve(node.func) in DEVICE_COPY_CTORS
                  and any(k.arg == "device" for k in node.keywords)):
                hit = f"{ctx.resolve(node.func)}(..., device=)"
            if hit is None or (line, hit) in seen:
                continue
            seen.add((line, hit))
            out.append(self.finding(
                ctx, line,
                f"`{hit}` blocks on device results inside "
                f"{self.window_desc} — keep the window dispatch-only "
                f"(device.HostCopy is the async primitive), or move "
                f"the read outside the markers"))
        return out


@register_rule
class OverlapWindowSyncRule(_DispatchOnlyWindowRule):
    name = "overlap-window"
    description = ("host synchronization (np.asarray / .item() / "
                   "torch.cuda.synchronize / .wait()) inside a pipelined-"
                   "fence overlap window — re-serializes the hidden tail")
    begin = BEGIN
    end = END
    window_desc = ("the pipelined-fence overlap window")


@register_rule
class ServeWindowSyncRule(_DispatchOnlyWindowRule):
    name = "serve-window"
    description = ("host synchronization inside a batched-read serve "
                   "window — re-serializes the coalesced gather back "
                   "into per-key round-trips")
    begin = SERVE_BEGIN
    end = SERVE_END
    window_desc = ("a batched-read serve window (one fused gather per "
                   "device dispatch)")
