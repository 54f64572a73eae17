"""Scheduling policies (paper §3.2.3/§3.2.5): FIFO, backfill, bin-packing,
gang co-scheduling, preemption, speculative re-execution (straggler
mitigation).

A policy maps (eligible jobs, cluster state, now) to task→node assignments.
Gang-parallel jobs are all-or-nothing in every policy: on an SPMD accelerator
mesh a parallel job cannot partially start.

Hot-path design (policy-path scalability): the seed implementations rebuilt
an O(nodes) free-capacity map every cycle and rescanned it per task, which
collapses throughput in the many-jobs / heterogeneous regimes the paper
benchmarks (Table 9 / Figure 4).  These versions run every placement query
against the ResourceManager's incrementally-maintained ``CapacityIndex``
(segment-tree first-fit, capacity-bucket best-fit) through a per-cycle
trial-allocation overlay (``_CycleView``), so a cycle costs
O(placements · log nodes) instead of O(jobs · tasks · nodes).  They are
*semantically identical* to the seed policies — ``tests/reference_policies.py``
keeps the originals and ``tests/test_policy_equivalence.py`` pins the
``(task, node)`` assignment sequences bit-for-bit against them.

A copy of the reference's ``repro/core/policies.py``; test files named
below are the reference's, and ``tests/test_torch_scheduler.py`` holds this
copy equal to the reference.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.job import Job, ResourceRequest, Task
from repro_torch.core.resources import NodeState, ResourceManager

Assignment = Tuple[Task, int]  # (task, node_id)


def _simple(req: ResourceRequest) -> bool:
    """True when ``Node.fits`` reduces to the slot/state check the index
    already guarantees (no memory, accelerator, or attribute constraints)."""
    return req.mem_mb <= 0 and req.accelerators <= 0 and not req.node_attrs


class _CycleView:
    """One cycle's trial-allocation overlay on the capacity index.

    Policies must not mutate cluster state (the engine commits assignments
    after ``assign`` returns), but they must account for what they placed
    earlier in the same cycle.  The seed rebuilt an O(nodes) free map per
    cycle for this; the view instead writes trial capacities straight into
    the shared ``CapacityIndex`` and restores the real values in ``close()``
    — O(touched nodes) total — so every index query during the cycle sees
    trial-accurate values.  Stale bucket entries this creates are covered by
    the index's lazy-deletion contract (restore re-pushes fresh entries).
    """

    def __init__(self, rm: ResourceManager):
        self.rm = rm
        self.idx = rm.index
        self.touched: Dict[int, int] = {}   # nid -> real free at cycle start
        self.taken = 0                      # net trial slots taken
        self._zero_fit: Dict[int, Optional[int]] = {}  # id(request) -> node

    def free(self, nid: int) -> int:
        return self.idx.free[nid]

    def take(self, nid: int, slots: int) -> None:
        if slots:
            if nid not in self.touched:
                self.touched[nid] = self.rm.nodes[nid].free_slots
            self.idx.set_free(nid, self.idx.free[nid] - slots)
            self.taken += slots

    def give(self, nid: int, slots: int) -> None:
        """Roll back a trial placement (gang all-or-nothing failure)."""
        if slots:
            self.idx.set_free(nid, self.idx.free[nid] + slots)
            self.taken -= slots

    def available(self) -> int:
        """Trial-adjusted total free slots (the seed's ``sum(free.values())``)."""
        return self.rm.free_slots() - self.taken

    def first_fit(self, req: ResourceRequest) -> Optional[int]:
        """First node in id order with trial free >= slots that fits —
        the seed's free-map scan, as O(log nodes) tree descents."""
        if req.slots <= 0:
            return self.zero_slot_fit(req)
        start = 0
        simple = _simple(req)
        while True:
            nid = self.idx.first_at_least(req.slots, start)
            if nid is None:
                return None
            if simple or self.rm.nodes[nid].fits(req):
                return nid
            start = nid + 1

    def zero_slot_fit(self, req: ResourceRequest) -> Optional[int]:
        """Slot-free requests (license/memory-only) can land on fully-slot-
        occupied nodes, which the capacity index excludes — they first-fit
        over the UP list instead.  Memoized per request object for the
        cycle: the cluster cannot change mid-assign, so the scan result is
        a constant (the seed rescanned all UP nodes on every call)."""
        key = id(req)
        if key not in self._zero_fit:
            self._zero_fit[key] = next(
                (n.node_id for n in self.rm.up_nodes() if n.fits(req)), None)
        return self._zero_fit[key]

    def close(self) -> None:
        """Restore real capacities (O(touched), never O(nodes))."""
        for nid in self.touched:
            node = self.rm.nodes[nid]
            self.idx.set_free(
                nid, node.free_slots if node.state is NodeState.UP else 0)
        self.touched.clear()
        self.taken = 0


class Policy:
    name = "base"

    # Scheduler-provided hint: number of pending zero-slot tasks across the
    # eligible jobs this cycle.  A placement needs either a free slot or a
    # zero-slot request, so once trial capacity hits 0 and every zero-slot
    # task in the walk is behind us, the rest of the job list is provably a
    # no-op and the cycle breaks out — O(placements) instead of O(jobs).
    # None (the default) disables the early exit (seed-exact full walk).
    zero_slot_backlog: Optional[int] = None

    def assign(self, jobs: Iterable[Job], rm: ResourceManager,
               now: float) -> List[Assignment]:
        """``jobs`` is a single-pass iterable in dispatch order (the
        scheduler feeds a lazy generator so early-exiting policies only
        consume a prefix); implementations must iterate it at most once."""
        raise NotImplementedError

    # helpers ---------------------------------------------------------
    @staticmethod
    def _gang_assign(job: Job, rm: ResourceManager) -> Optional[List[Assignment]]:
        """All-or-nothing placement for a parallel job: trial allocation
        through the indexed ``first_fit`` with O(tasks) rollback."""
        picked: List[Assignment] = []
        try:
            for t in job.pending_tasks():
                node = rm.first_fit(t.request)
                if node is None:
                    return None
                rm.allocate(t, node.node_id)
                picked.append((t, node.node_id))
            return picked
        finally:
            # roll back trial allocations; the engine re-allocates for real
            for t, _ in picked:
                rm.release(t)
                t.node_id = None


class FIFOPolicy(Policy):
    """First-in-first-out; head-of-line blocking on gang jobs."""

    name = "fifo"

    def assign(self, jobs, rm, now):
        out: List[Assignment] = []
        for job in jobs:
            if job.parallel:
                gang = self._gang_assign(job, rm)
                if gang is None:
                    break  # strict FIFO: do not overtake the head job
                for t, nid in gang:
                    rm.allocate(t, nid)
                out.extend(gang)
                continue
            blocked = False
            for t in job.pending_tasks():
                node = rm.first_fit(t.request)
                if node is None:
                    blocked = True
                    break
                rm.allocate(t, node.node_id)
                out.append((t, node.node_id))
            if blocked:
                break
        for t, _ in out:
            rm.release(t)   # engine commits; this was trial bookkeeping
            t.node_id = None
        return out


class BackfillPolicy(Policy):
    """EASY backfill: reserve for the head job; backfill jobs that finish
    before the reservation (requires task duration estimates).

    The head reservation is an *earliest-completion shadow timeline*: when
    the head gang cannot start, its shadow start is "as soon as capacity
    drains" and its shadow completion ``now + max(task durations)`` closes
    the backfill window.  Capacity bookkeeping rides the trial overlay
    (``available()`` is an O(1) counter), so a cycle never sums or rebuilds
    per-node free maps."""

    name = "backfill"

    def assign(self, jobs, rm, now):
        out: List[Assignment] = []
        view = _CycleView(rm)
        zeros = self.zero_slot_backlog
        try:
            lic = dict(rm.licenses)
            reservation_time: Optional[float] = None
            head_blocked = False
            for job in jobs:
                if zeros == 0 and view.available() <= 0:
                    break       # nothing left that could possibly place
                tasks = job.pending_tasks()
                if job.parallel:
                    need = sum(t.request.slots for t in tasks)
                    if need > view.available():
                        if not head_blocked:
                            head_blocked = True
                            # shadow completion of the blocked head job
                            reservation_time = now + max(
                                (t.duration for t in tasks), default=0.0)
                        continue
                placed: List[Assignment] = []
                ok = True
                for t in tasks:
                    if zeros is not None and t.request.slots <= 0:
                        zeros -= 1
                    if head_blocked and reservation_time is not None:
                        # only backfill tasks that end before the reservation
                        if now + t.duration > reservation_time:
                            ok = False
                            break
                    if any(lic.get(l, 0) <= 0 for l in t.request.licenses):
                        ok = False
                        break
                    nid = view.first_fit(t.request)
                    if nid is None:
                        ok = False
                        break
                    view.take(nid, t.request.slots)
                    for l in t.request.licenses:
                        lic[l] -= 1
                    placed.append((t, nid))
                if job.parallel and not ok:
                    for t, nid in placed:
                        view.give(nid, t.request.slots)
                    continue
                out.extend(placed)
            return out
        finally:
            view.close()


class BinPackingPolicy(Policy):
    """Best-fit-decreasing: pack tasks onto the fullest node that fits,
    minimizing fragmentation (and enabling power-aware node shutdown).

    Best-fit is answered by the capacity buckets: the winner for a request
    of ``s`` slots is the min-rank node in the lowest non-empty bucket
    ``c >= s``, where rank is the seed's snapshot order — (free at cycle
    start, node id).  Un-moved nodes in bucket ``c`` all have snapshot free
    ``c``, so the bucket's min-id pop is their min rank; nodes the cycle
    already placed on live in a side heap keyed by snapshot rank and always
    order *after* un-moved nodes of the same trial capacity."""

    name = "binpack"

    def assign(self, jobs, rm, now):
        out: List[Assignment] = []
        view = _CycleView(rm)
        # trial-moved nodes keyed by trial capacity -> heap of (snapshot, id)
        local: Dict[int, List[Tuple[int, int]]] = {}
        lic = dict(rm.licenses)
        zeros = self.zero_slot_backlog
        try:
            for job in jobs:
                if zeros == 0 and view.available() <= 0:
                    break       # nothing left that could possibly place
                for t in job.pending_tasks():
                    req = t.request
                    if zeros is not None and req.slots <= 0:
                        zeros -= 1
                    if any(lic.get(l, 0) <= 0 for l in req.licenses):
                        continue
                    if req.slots <= 0:
                        best = view.zero_slot_fit(req)
                    else:
                        best = self._best_fit(view, local, req)
                    if best is None:
                        continue
                    self._place(view, local, best, req.slots)
                    for l in req.licenses:
                        lic[l] -= 1
                    out.append((t, best))
            return out
        finally:
            view.close()

    @staticmethod
    def _best_fit(view: _CycleView, local, req) -> Optional[int]:
        idx = view.idx
        cap = idx.max_free()        # no trial capacity exceeds the tree max
        simple = _simple(req)
        touched = view.touched
        for c in range(req.slots, cap + 1):
            # un-moved nodes first (rank (c, id)); trial-moved ids are
            # skipped here — they rank later and are found in `local`
            restore: List[int] = []
            win = None
            while True:
                nid = idx.pop_min_id_at(c, skip=touched)
                if nid is None:
                    break
                if simple or view.rm.nodes[nid].fits(req):
                    win = nid
                    break
                restore.append(nid)    # stays a candidate for later tasks
            for nid in restore:
                idx.push_at(c, nid)
            if win is not None:
                return win
            heap = local.get(c)
            if heap:
                restore2: List[Tuple[int, int]] = []
                while heap:
                    snap, nid = heap[0]
                    if idx.free[nid] != c:
                        heapq.heappop(heap)     # stale: moved again
                        continue
                    if simple or view.rm.nodes[nid].fits(req):
                        win = nid
                        break
                    restore2.append(heapq.heappop(heap))
                for e in restore2:
                    heapq.heappush(heap, e)
                if win is not None:
                    return win
        return None

    @staticmethod
    def _place(view: _CycleView, local, nid: int, slots: int) -> None:
        if not slots:
            return
        view.take(nid, slots)
        c = view.idx.free[nid]
        if c > 0:
            heapq.heappush(local.setdefault(c, []),
                           (view.touched[nid], nid))


@dataclass
class LocalityHint:
    """Data/checkpoint-locality scores: node_id -> score (higher = closer)."""

    scores: Dict[int, float] = field(default_factory=dict)


class LocalityPolicy(Policy):
    """Data-related placement (§3.2.5): prefer nodes holding the task's
    data/checkpoint shards (YARN/HDFS locality ↦ checkpoint-shard locality).

    The seed picked ``max(candidates, key=score)`` over a per-task rebuild
    of the full candidate list.  Hints are sparse, so the indexed version
    checks the hinted nodes directly (O(hints)) and only consults the tree
    for the "no positively-hinted candidate" case, where the winner is the
    first score-0 candidate in node-id order — a first-fit descent that
    skips at most the negatively-hinted nodes."""

    name = "locality"

    def __init__(self, hints: Optional[Dict[int, LocalityHint]] = None):
        self.hints = hints or {}

    def assign(self, jobs, rm, now):
        out: List[Assignment] = []
        view = _CycleView(rm)
        zeros = self.zero_slot_backlog
        try:
            # licenses placed earlier in the cycle count, as in backfill
            # and bin-packing (the reference's locality policy omits this
            # and over-assigns licensed tasks; ROADMAP Queue 3)
            lic = dict(rm.licenses)
            for job in jobs:
                if zeros == 0 and view.available() <= 0:
                    break       # nothing left that could possibly place
                hint = self.hints.get(job.job_id)
                scores = hint.scores if hint is not None else {}
                for t in job.pending_tasks():
                    if zeros is not None and t.request.slots <= 0:
                        zeros -= 1
                    if any(lic.get(l, 0) <= 0 for l in t.request.licenses):
                        continue
                    nid = self._pick(view, scores, t.request)
                    if nid is None:
                        continue
                    view.take(nid, t.request.slots)
                    for l in t.request.licenses:
                        lic[l] -= 1
                    out.append((t, nid))
            return out
        finally:
            view.close()

    @staticmethod
    def _is_candidate(view: _CycleView, nid: int, req) -> bool:
        node = view.rm.nodes.get(nid)
        if node is None:
            return False
        if req.slots > 0:
            return (view.free(nid) >= req.slots
                    and (_simple(req) or node.fits(req)))
        return node.fits(req)   # zero-slot: any fitting UP node

    @classmethod
    def _pick(cls, view: _CycleView, scores, req) -> Optional[int]:
        # best hinted candidate: max score, min node id within ties — the
        # seed's `max(cands, key=score)` can only leave the hinted set when
        # every hinted candidate scores <= 0 (unhinted nodes score 0.0)
        best_sc = best_nid = None
        for nid, sc in scores.items():
            if not cls._is_candidate(view, nid, req):
                continue
            if (best_sc is None or sc > best_sc
                    or (sc == best_sc and nid < best_nid)):
                best_sc, best_nid = sc, nid
        if best_sc is not None and best_sc > 0:
            return best_nid
        # the winner is the first candidate in id order scoring 0.0 (first
        # to attain the max); failing that, the best (<= 0) hinted one
        if req.slots > 0:
            start = 0
            simple = _simple(req)
            while True:
                nid = view.idx.first_at_least(req.slots, start)
                if nid is None:
                    return best_nid
                if simple or view.rm.nodes[nid].fits(req):
                    sc = scores.get(nid)
                    if sc is None or sc == 0.0:
                        return nid
                start = nid + 1     # negatively-hinted: ranked via best_nid
        n0 = view.zero_slot_fit(req)
        if n0 is None:
            return best_nid
        if scores.get(n0, 0.0) == 0.0:
            return n0
        for n in view.rm.up_nodes():    # rare: negative hint on the head
            if n.node_id > n0 and scores.get(n.node_id, 0.0) == 0.0 \
                    and n.fits(req):
                return n.node_id
        return best_nid


POLICIES = {
    p.name: p for p in (FIFOPolicy, BackfillPolicy, BinPackingPolicy)
}


def make_policy(name: str, **kw) -> Policy:
    if name == "locality":
        return LocalityPolicy(**kw)
    return POLICIES[name]()
