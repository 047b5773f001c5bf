"""Launch counters of the port's CUDA kernels, and their accounting under
CUDA graphs.

Each op module holds one dict of counts (:func:`counter`), and each of its
wrappers adds one to its kernel's count where it launches the kernel.  A
captured CUDA graph replays its launches without running any Python, so
code that captures a graph records what the capture counted
(:func:`recording`) and adds that on each replay (:func:`replayed`): a
graph replays exactly what it captured.  Every counter made here is
covered, so no captured kernel goes uncounted.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, List, Tuple

_COUNTERS: List[Dict[str, int]] = []

# What a capture launched: (counter, kernel name, launches).
Recorded = List[Tuple[Dict[str, int], str, int]]


def counter(*names: str) -> Dict[str, int]:
    """A new dict of launch counts, 0 for each of ``names``."""
    counts = dict.fromkeys(names, 0)
    _COUNTERS.append(counts)
    return counts


@contextmanager
def recording() -> Iterator[Recorded]:
    """Record the launches counted inside the block, and take them back from
    the counters: while a graph is captured nothing runs, so they are the
    graph's own, counted on its replays."""
    before = [dict(counts) for counts in _COUNTERS]
    recorded: Recorded = []
    try:
        yield recorded
    finally:
        for counts, old in zip(_COUNTERS, before):
            recorded.extend((counts, name, counts[name] - n)
                            for name, n in old.items() if counts[name] != n)
            counts.update(old)


def replayed(recorded: Recorded) -> None:
    """Count one replay of a graph whose capture recorded ``recorded``."""
    for counts, name, n in recorded:
        counts[name] += n
