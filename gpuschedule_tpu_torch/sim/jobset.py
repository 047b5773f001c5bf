"""Insertion-ordered job set with O(1) membership, append, and remove.

The port's own copy of ``gpuschedule_tpu/sim/jobset.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

The engine's ``pending``/``running`` collections were plain lists in the
first cut; ``list.remove`` made every start/preempt/finish O(n), which turns
Philly-scale replays (10^5 jobs) into O(n^2) hot loops (SURVEY.md §3.1 "hot
spot": placement search + queue re-sort per step).  This dict-backed set
keeps the list API the policies already use (iteration in insertion order,
``len``, truthiness, ``in``, indexing, ``+``) while making the engine's
mutations constant-time.

Insertion order is a real invariant, not an accident: arrivals enter
``pending`` in (submit_time, arrival_seq) order because the event heap pops
them that way, so a non-preemptive policy (FIFO) can consume ``pending`` in
arrival order with no per-event sort.  Preemptive policies re-append
preempted jobs at the tail and impose their own priority order anyway.

The backing store is an ``OrderedDict`` — a real doubly-linked list —
not a plain dict.  A plain dict keeps deleted entries as
tombstones until an insert-triggered resize compacts them, so the
front-heavy churn these sets live under (FIFO consumes the head, the
engine removes finished jobs constantly) makes "first element" and
iteration scan an ever-growing tombstone run: at million-job scale the
end-of-trace drain — all deletions, no inserts, so no compaction ever —
went quadratic in the backlog and dominated the whole replay.  The
linked list makes head access and iteration O(live entries), always.
"""

from __future__ import annotations

from collections import OrderedDict
from itertools import islice
from typing import Iterable, Iterator, List

from gpuschedule_tpu_torch.sim.job import Job


class JobSet:
    """Ordered set of jobs keyed by identity."""

    __slots__ = ("_jobs",)

    def __init__(self, jobs: Iterable[Job] = ()):
        self._jobs: "OrderedDict[int, Job]" = OrderedDict(
            (id(j), j) for j in jobs
        )

    def append(self, job: Job) -> None:
        # re-append moves nothing: OrderedDict keeps the first position
        # for an existing key (same contract the plain dict had)
        self._jobs[id(job)] = job

    def remove(self, job: Job) -> None:
        try:
            del self._jobs[id(job)]
        except KeyError:
            raise ValueError(f"{job!r} not in JobSet") from None

    def discard(self, job: Job) -> None:
        """Remove ``job`` if present (one dict op — the engine's start
        path replaces its contains-then-remove pair with this)."""
        self._jobs.pop(id(job), None)

    def __contains__(self, job: Job) -> bool:
        return id(job) in self._jobs

    def __iter__(self) -> Iterator[Job]:
        return iter(self._jobs.values())

    def __len__(self) -> int:
        return len(self._jobs)

    def __bool__(self) -> bool:
        return bool(self._jobs)

    def __getitem__(self, index: int) -> Job:
        """Positional access in insertion order.  Index 0 is O(1) — FIFO's
        head-of-line peek reads it once per start attempt; other indices
        are O(index) (tests and debugging only)."""
        if index == 0 and self._jobs:
            return next(iter(self._jobs.values()))
        n = len(self._jobs)
        if index < 0:
            index += n
        if not 0 <= index < n:
            raise IndexError(index)
        return next(islice(iter(self._jobs.values()), index, None))

    def __add__(self, other: Iterable[Job]) -> List[Job]:
        """``pending + running`` — the policies' idiom for the active set."""
        return [*self, *other]

    def __radd__(self, other: Iterable[Job]) -> List[Job]:
        return [*other, *self]

    def __reduce__(self):
        """Pickle as the ordered job list (engine snapshots):
        the backing store is keyed by ``id(job)``, which is meaningless in
        another process — reconstruction re-keys the same jobs (identity
        preserved by the enclosing pickle graph) in the same order."""
        return (JobSet, (list(self),))

    def __repr__(self) -> str:
        return f"JobSet({[j.job_id for j in self]})"
