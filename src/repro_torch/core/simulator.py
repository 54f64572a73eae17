"""Discrete-event engine with a virtual clock.

The paper's benchmark burns 93.7 processor-hours per task set on real sleep
jobs; what it measures is pure control-plane latency. We run the same control
plane (queues, policies, dispatch accounting) against a virtual clock so the
full Table-9 grid executes in seconds at 1408+ slots, and scales to >=100k
slots for the large-scale runnability experiments.

A copy of the reference's ``repro/core/simulator.py``; test files named
below are the reference's, and ``tests/test_torch_scheduler.py`` holds this
copy equal to the reference.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, List, Optional, Tuple


class EventLoop:
    """Priority-queue event loop over virtual time.

    Arrival sources: a workload source streaming millions of arrivals cannot
    pre-push them all (the heap would materialize the whole trace).  A source
    registered with :meth:`add_source` is polled whenever the heap drains; it
    may push the next batch of events lazily (returning True) or report
    exhaustion (False).  ``run`` only stops once the heap is empty *and* every
    source declines to refill it, so O(1)-lookahead injectors keep the loop
    alive without owning the run loop.

    Coalesced-callback protocol (the scheduler's wave path): a producer that
    knows a whole sorted batch of future callbacks up front pushes ONE event
    for the batch (reserving its tie-break sequence number with
    :meth:`reserve_seq`) instead of one per callback.  When the batch event
    fires, the callback drains every member that would have fired before the
    current heap head — comparing ``(member_time, batch_seq)`` against the
    head (:meth:`peek`), advancing the clock monotonically (:meth:`advance`)
    — then re-pushes the remainder at the next member's time with
    :meth:`at_seq`, *keeping the original seq* so every future tie against
    events pushed in between resolves exactly as the per-event schedule
    would have.  ``run``'s ``until`` horizon is exposed as :attr:`until` so
    a draining batch stops at the same boundary the event loop itself
    would.  :meth:`at_many` is the bulk counterpart of :meth:`at` for
    producers that do pre-push many discrete events at once.
    """

    __slots__ = ("_heap", "_seq", "now", "until", "_running", "_sources")

    def __init__(self):
        self._heap: List[Tuple[float, int, Callable, tuple]] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.until = float("inf")
        self._running = False
        self._sources: List[Callable[[], bool]] = []

    def at(self, time: float, fn: Callable, *args) -> None:
        if time < self.now:
            time = self.now
        heapq.heappush(self._heap, (time, next(self._seq), fn, args))

    def at_many(self, events) -> None:
        """Batched insertion of ``(time, fn, args)`` triples.

        Equivalent to calling :meth:`at` in order (sequence numbers are
        assigned in iteration order), but pays one heapify instead of
        O(n log n) pushes once the batch outgrows the live heap.  For
        external event producers that pre-push many discrete events at
        once — failure/heartbeat schedules, materialized arrival bursts;
        the scheduler's wave path instead pushes a single *coalesced*
        event per wave via :meth:`reserve_seq`/:meth:`at_seq`.
        """
        heap = self._heap
        seq = self._seq
        now = self.now
        batch = [(t if t >= now else now, next(seq), fn, args)
                 for t, fn, args in events]
        if len(batch) > len(heap):
            heap.extend(batch)
            heapq.heapify(heap)
        else:
            for e in batch:
                heapq.heappush(heap, e)

    def at_seq(self, time: float, seq: int, fn: Callable, *args) -> None:
        """Push with an explicit (previously reserved) sequence number.

        Used by coalesced batches re-pushing their remainder: keeping the
        original seq preserves every tie-break against events that were
        pushed after the batch was first scheduled.
        """
        if time < self.now:
            time = self.now
        heapq.heappush(self._heap, (time, seq, fn, args))

    def reserve_seq(self) -> int:
        """Claim the next tie-break sequence number (see class docstring)."""
        return next(self._seq)

    def peek(self) -> Optional[Tuple[float, int]]:
        """(time, seq) of the next event, or None if the heap is empty."""
        if not self._heap:
            return None
        head = self._heap[0]
        return (head[0], head[1])

    def advance(self, time: float) -> None:
        """Advance the clock from inside a coalesced callback (monotonic)."""
        if time > self.now:
            self.now = time

    def after(self, delay: float, fn: Callable, *args) -> None:
        self.at(self.now + delay, fn, *args)

    def add_source(self, refill: Callable[[], bool]) -> None:
        """Register a lazy arrival source, polled when the heap drains."""
        self._sources.append(refill)

    def remove_source(self, refill: Callable[[], bool]) -> None:
        try:
            self._sources.remove(refill)
        except ValueError:
            pass

    def _refill(self) -> bool:
        """Give every source a chance to push events; True if any did."""
        added = False
        for src in list(self._sources):
            if src():
                added = True
        return added and bool(self._heap)

    def run(self, until: float = float("inf"), max_events: int = 0) -> int:
        """Process events; returns number processed.

        A coalesced batch (see class docstring) counts as one event however
        many members it drains.
        """
        n = 0
        self.until = until
        self._running = True
        while self._running:
            if not self._heap and not (self._sources and self._refill()):
                break
            time, _, fn, args = self._heap[0]
            if time > until:
                break
            heapq.heappop(self._heap)
            self.now = time
            fn(*args)
            n += 1
            if max_events and n >= max_events:
                break
        self._running = False
        return n

    def stop(self) -> None:
        self._running = False

    def empty(self) -> bool:
        return not self._heap
