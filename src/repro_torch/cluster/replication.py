"""Frame journaling + buddy replication — bounded-loss failover.

Copy of ``repro.cluster.replication`` (pure Python over the port's
types).  Checkpoint-only failure recovery restores a dead member's
sessions from the last *periodic* checkpoint, so everything submitted
since ``snapshot_every`` is counted into ``lost_in_flight``.  This
module shrinks that bound to "frames admitted but not yet
journal-acked": every frame a member accepts is appended to a
per-session write-ahead ``FrameJournal`` that lives on a deterministic
BUDDY member (the next live node past the owner on the ``HashRing``
walk), and recovery becomes

    import the last checkpoint  +  replay the journal's open entries

through the existing ``import_session`` seam — the replayed frames
re-enter the new owner's queues with their ORIGINAL arrival times and
deadlines, exactly like a migration implant.

The journal's lifecycle mirrors a real replicated log, in-process:

- ``record`` appends a PENDING entry at submit time (the owner accepted
  the frame; the append has not reached the buddy yet);
- ``flush`` ships pending entries to the buddy — from then on they are
  ACKED (durable: they survive the owner's death).  The cluster
  flushes every ``journal_flush_every`` steps, so the replication lag —
  and with it the loss bound — is at most one flush window;
- ``settle`` marks an entry whose frame was served or visibly shed (it
  left the system through the normal books; replaying it would
  double-serve);
- ``checkpointed`` truncates entries that are both acked and settled:
  a fresh checkpoint reflects every served frame, so only the OPEN
  entries (accepted, not yet served/shed) still matter for replay;
- ``replayable`` returns exactly those open acked entries, oldest
  first — the frames a failover re-queues on the new owner.

At the owner's death, PENDING entries die with it (the append never
reached the buddy) — the cluster counts them into ``lost_in_flight``.
At the BUDDY's death the journal's data dies instead: the log is
cleared and re-homed, and the session is exposed until its next
checkpoint — honest, like a real single-replica log.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.api.types import FrameRequest, QueuedFrameSnapshot

__all__ = ["FrameJournal", "JournalEntry", "ReplicationLog",
           "entry_nbytes"]

# per-entry transport overhead estimate on top of the mel payload
# (frame metadata + timestamps); the metric is a meter, not a codec
_ENTRY_OVERHEAD_B = 64


def entry_nbytes(entry: "JournalEntry") -> int:
    """Shipped size of one entry (``ClusterStats.journal_bytes``)."""
    return int(entry.frame.mel.nbytes) + _ENTRY_OVERHEAD_B


@dataclass
class JournalEntry:
    """One write-ahead record: the frame plus the admission ledger it
    needs to re-enter a queue unchanged (original arrival time and
    deadline — replay must not grant a fresh deadline budget)."""

    t: int
    frame: FrameRequest
    enq_s: float
    deadline_s: float
    weight: float = 1.0
    acked: bool = False        # shipped to the buddy (survives the owner)
    settled: bool = False      # served or shed — never replayed

    def snapshot(self) -> QueuedFrameSnapshot:
        """The implant form ``import_session`` consumes."""
        return QueuedFrameSnapshot(frame=self.frame, enq_s=self.enq_s,
                                   deadline_s=self.deadline_s,
                                   weight=self.weight)


class FrameJournal:
    """Per-session write-ahead journal, homed on a buddy member."""

    def __init__(self, gsid, buddy):
        self.gsid = gsid
        self.buddy = buddy         # member name holding the data (or None)
        self.entries: list[JournalEntry] = []

    def append(self, entry: JournalEntry) -> None:
        self.entries.append(entry)

    def flush(self) -> int:
        """Ack every pending entry (the ship to the buddy); returns the
        bytes that crossed the transport.  A journal without a buddy
        has nowhere to ship — entries stay pending (and are therefore
        lost with the owner, counted)."""
        if self.buddy is None:
            return 0
        shipped = 0
        for e in self.entries:
            if not e.acked:
                e.acked = True
                shipped += entry_nbytes(e)
        return shipped

    def settle(self, t) -> bool:
        """Mark the oldest open entry for frame ``t`` served/shed."""
        for e in self.entries:
            if not e.settled and e.t == t:
                e.settled = True
                return True
        return False

    def truncate_settled(self) -> int:
        """Drop entries that are acked AND settled — called right after
        a checkpoint, which is the durable record of those frames."""
        before = len(self.entries)
        self.entries = [e for e in self.entries
                        if not (e.acked and e.settled)]
        return before - len(self.entries)

    def replayable(self) -> list[JournalEntry]:
        """Open acked entries, append order (== enqueue order) — what a
        failover re-queues on the new owner."""
        return [e for e in self.entries if e.acked and not e.settled]

    def pending(self) -> list[JournalEntry]:
        """Entries not yet shipped — the loss bound at owner death."""
        return [e for e in self.entries if not e.acked]

    @property
    def nbytes(self) -> int:
        """Current journal payload size (what a re-home re-ships)."""
        return sum(entry_nbytes(e) for e in self.entries)


class ReplicationLog:
    """All sessions' journals plus the transport accounting.

    Owned by ``GatewayCluster`` and mutated only under the cluster
    lock; every byte that crosses the (in-process) owner→buddy seam is
    metered into ``bytes_shipped`` → ``ClusterStats.journal_bytes``
    (a ``cluster_journal_bytes`` counter when a ``MetricsRegistry`` is
    attached, so the exporters see it too).
    """

    def __init__(self, registry=None):
        self._journals: dict = {}      # gsid -> FrameJournal
        if registry is not None:
            self._bytes = registry.counter("cluster_journal_bytes")
        else:
            from repro_torch.obs import Counter
            self._bytes = Counter("cluster_journal_bytes", ())
        self.resets = 0                # journals cleared by buddy death

    @property
    def bytes_shipped(self) -> int:
        return self._bytes.value

    def open(self, gsid, buddy) -> FrameJournal:
        j = FrameJournal(gsid, buddy)
        self._journals[gsid] = j
        return j

    def close(self, gsid) -> None:
        self._journals.pop(gsid, None)

    def journal(self, gsid) -> FrameJournal | None:
        return self._journals.get(gsid)

    def record(self, gsid, *, t, frame, enq_s, deadline_s,
               weight=1.0) -> None:
        j = self._journals.get(gsid)
        if j is not None:
            j.append(JournalEntry(t=t, frame=frame, enq_s=enq_s,
                                  deadline_s=deadline_s, weight=weight))

    def flush_all(self) -> int:
        shipped = sum(j.flush() for j in self._journals.values())
        self._bytes.inc(shipped)
        return shipped

    def settle(self, gsid, t) -> None:
        j = self._journals.get(gsid)
        if j is not None:
            j.settle(t)

    def checkpointed(self, gsid) -> None:
        j = self._journals.get(gsid)
        if j is not None:
            j.truncate_settled()

    def rehome(self, gsid, buddy) -> None:
        """Move the journal to a new buddy — the old one still holds
        the data (it is alive: a drain, or the owner moved onto the
        buddy), so the entries survive and re-ship, metered."""
        j = self._journals.get(gsid)
        if j is None or j.buddy == buddy:
            return
        j.buddy = buddy
        if buddy is not None:
            self._bytes.inc(sum(entry_nbytes(e) for e in j.entries
                                if e.acked))

    def drop_member(self, name) -> list:
        """The member died: journals HOMED on it lose their ACKED data
        (those entries lived there) — pending entries survive, they
        never left the owner's side of the transport.  The journal is
        left buddy-less until the cluster re-homes it.  Returns the
        affected gsids; their sessions are exposed (checkpoint-only
        recovery for the cleared span) until their next checkpoint."""
        hit = []
        for gsid, j in self._journals.items():
            if j.buddy == name:
                j.entries = [e for e in j.entries if not e.acked]
                j.buddy = None
                self.resets += 1
                hit.append(gsid)
        return hit

    def pending_total(self) -> int:
        return sum(len(j.pending()) for j in self._journals.values())
