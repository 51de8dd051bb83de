"""Minimal interval collection (counterpart of ``medaka_tpu/utils/intervals.py``).

Supports the operations the framework needs: overlap queries, envelop
queries, point queries and complement within contig bounds.
"""
from __future__ import annotations

import bisect
from typing import Any, Iterable, List, Tuple


class IntervalSet:
    """A set of (start, end, data) intervals with bounded-scan queries."""

    def __init__(self, intervals: Iterable[Tuple[int, int, Any]] = ()):
        self._pending = list(intervals)
        self._items: List[Tuple[int, int, Any]] = []
        self._starts: List[int] = []
        self._max_end: List[float] = []
        self._dirty = True

    def _rebuild(self):
        if not self._dirty:
            return
        self._items = sorted(
            self._pending, key=lambda x: (x[0], x[1]))
        self._starts = [i[0] for i in self._items]
        self._max_end = []
        m = float("-inf")
        for _s, e, _d in self._items:
            m = max(m, e)
            self._max_end.append(m)
        self._dirty = False

    def __len__(self):
        return len(self._pending)

    def __iter__(self):
        self._rebuild()
        return iter(self._items)

    def add(self, start: int, end: int, data: Any = None):
        """Insert an interval."""
        self._pending.append((start, end, data))
        self._dirty = True

    def overlap(self, start: int, end: int) -> List[Tuple[int, int, Any]]:
        """Intervals with any overlap with [start, end)."""
        self._rebuild()
        hi = bisect.bisect_left(self._starts, end)
        out = []
        for i in range(hi - 1, -1, -1):
            if self._max_end[i] <= start:
                break
            if self._items[i][1] > start:
                out.append(self._items[i])
        out.reverse()
        return out

    def envelop(self, start: int, end: int) -> List[Tuple[int, int, Any]]:
        """Intervals fully contained within [start, end)."""
        return [
            iv for iv in self.overlap(start, end)
            if iv[0] >= start and iv[1] <= end]

    def at(self, point: int) -> List[Tuple[int, int, Any]]:
        """Intervals containing a point."""
        return self.overlap(point, point + 1)

    def complement(self, start: int, end: int) -> List[Tuple[int, int]]:
        """Gaps within [start, end) not covered by any interval."""
        out = []
        cursor = start
        for s, e, _ in self.overlap(start, end):
            if s > cursor:
                out.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < end:
            out.append((cursor, end))
        return out
