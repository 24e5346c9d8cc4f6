"""Leader election for the JobMaster with fencing tokens (port of
``clonos_tpu/runtime/leader.py``; host only, no torch).

Exactly one contender leads at a time; a standby takes over when the
leader's lease lapses; every grant carries a monotonically increasing
fencing token that a deposed leader's actions are rejected by.

The lease lives in claim files on a filesystem the contenders share:

- every fencing epoch is one file, ``<path>.epoch<N>.claim``, created
  with ``O_CREAT|O_EXCL``: the filesystem arbitrates, so an epoch has
  exactly one owner, ever;
- the claim file is the lease: ``{"leader_id", "deadline_wall"}`` (a
  wall-clock deadline, comparable across hosts and boots), rewritten
  (temp file + replace) only by its owner on renewal;
- the current leader is the owner of the highest epoch whose deadline
  has not lapsed; a deposed leader renewing its old epoch's file changes
  nothing a reader looks at, and ``fencing_valid`` accepts the highest
  claimed epoch only;
- acquisition claims ``highest + 1`` and deletes claims more than one
  epoch behind.

The claim files' names and JSON are the reference's, byte for byte, so a
port contender and a reference contender arbitrate one lease path.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional


def job_lease_path(base: str, job_id: Optional[str]) -> str:
    """Job-scoped lease path under one cluster lease ``base``:
    ``<base>.<job_id>``, so the claim families of jobs sharing a lease
    directory stay disjoint. An empty job id is the single-job cluster:
    ``base`` as it is."""
    if not job_id:
        return base
    if "/" in job_id:
        raise ValueError(f"job id {job_id!r} must not contain '/'")
    return f"{base}.{job_id}"


class FileLeaderElection:
    """One contender's handle on a claim-file election."""

    def __init__(self, path: str, contender_id: str,
                 lease_ttl_s: float = 2.0, clock=None):
        self.path = path
        self.contender_id = contender_id
        self.ttl = lease_ttl_s
        #: deadlines are wall-clock time: claim files are read by
        #: contenders on other hosts and across restarts. The injected
        #: clock is for tests.
        # clonos: allow(wallclock): lease deadlines are cross-host wall
        # time by design (see note above); leases are never replayed.
        self._clock = time.time if clock is None else clock
        #: fencing token of our current leadership (None = not leader)
        self.epoch: Optional[int] = None
        #: ``fn(kind, **fields)`` on every leadership transition
        #: ("claim", "renew", "deposed", "lost-race")
        self.transition_observers: List = []

    def _observe(self, kind: str, **fields) -> None:
        for fn in self.transition_observers:
            fn(kind, **fields)

    # --- claim files ---------------------------------------------------------

    def _claim_path(self, epoch: int) -> str:
        return f"{self.path}.epoch{epoch}.claim"

    def _claims(self) -> List[int]:
        d = os.path.dirname(self.path) or "."
        base = os.path.basename(self.path) + ".epoch"
        out = []
        try:
            for fn in os.listdir(d):
                if fn.startswith(base) and fn.endswith(".claim"):
                    out.append(int(fn[len(base):-len(".claim")]))
        except OSError:
            pass
        return sorted(out)

    def _read_claim(self, epoch: int) -> Optional[dict]:
        """The claim's content, or a placeholder that counts as live until
        the creation-time grace lapses while its owner is between the
        ``O_EXCL`` create and the content write."""
        p = self._claim_path(epoch)
        try:
            with open(p) as f:
                rec = json.load(f)
            rec["epoch"] = epoch
            return rec
        except ValueError:
            try:
                return {"leader_id": None, "epoch": epoch,
                        "deadline_wall": os.path.getmtime(p) + self.ttl,
                        "pending": True}
            except OSError:
                return None
        except OSError:
            return None

    def _write_own(self, epoch: int, deadline: float) -> None:
        # Only the O_EXCL winner of ``epoch`` writes this file.
        tmp = f"{self._claim_path(epoch)}.{self.contender_id}.tmp"
        with open(tmp, "w") as f:
            json.dump({"leader_id": self.contender_id,
                       "deadline_wall": deadline}, f)
        os.replace(tmp, self._claim_path(epoch))

    def _current(self) -> Optional[dict]:
        """The highest-epoch claim (the lease that counts)."""
        claims = self._claims()
        return self._read_claim(claims[-1]) if claims else None

    def _expired(self, rec: dict) -> bool:
        if rec.get("pending"):
            # A foreign writer mid-create: its grace runs on wall time
            # (the file's mtime), whatever clock was injected.
            # clonos: allow(wallclock): expiry of a foreign lease file
            return time.time() > rec["deadline_wall"]
        return self._clock() > rec["deadline_wall"]

    # --- contender API -------------------------------------------------------

    def try_acquire(self) -> bool:
        """Lead iff no live higher claim exists; ``epoch`` is then the
        fencing token."""
        cur = self._current()
        if cur is not None and not self._expired(cur):
            if cur.get("leader_id") == self.contender_id:
                self.epoch = cur["epoch"]
                self._write_own(self.epoch, self._clock() + self.ttl)
                self._observe("renew", epoch=self.epoch)
                return True
            return False
        new_epoch = (cur["epoch"] + 1) if cur is not None else 1
        try:
            fd = os.open(self._claim_path(new_epoch),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            self.epoch = None
            self._observe("lost-race", epoch=new_epoch)
            return False
        os.close(fd)
        self._write_own(new_epoch, self._clock() + self.ttl)
        self.epoch = new_epoch
        self._observe("claim", epoch=new_epoch)
        for e in self._claims():
            if e < new_epoch - 1:
                try:
                    os.remove(self._claim_path(e))
                except OSError:
                    pass
        return True

    def renew(self) -> bool:
        """Extend our lease by rewriting our own epoch's claim. Returns
        False, and drops leadership, once a higher epoch was claimed."""
        if self.epoch is None:
            return False
        claims = self._claims()
        if not claims or claims[-1] != self.epoch:
            deposed = self.epoch
            self.epoch = None
            self._observe("deposed", epoch=deposed)
            return False
        self._write_own(self.epoch, self._clock() + self.ttl)
        self._observe("renew", epoch=self.epoch)
        return True

    def is_leader(self) -> bool:
        return self.epoch is not None

    def leader(self) -> Optional[str]:
        """The current lease holder (None when absent or expired)."""
        cur = self._current()
        if cur is None or self._expired(cur):
            return None
        return cur.get("leader_id")

    def fencing_valid(self, epoch: int) -> bool:
        """Would an action stamped with ``epoch`` be accepted now? Only
        the highest existing claim is: a lower token is a deposed
        leader's, a higher one was never won."""
        claims = self._claims()
        return bool(claims) and epoch == claims[-1]
