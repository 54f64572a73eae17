"""Resource management function (paper §1, §3.2.4).

Tracks node availability/state from heartbeats, aggregates it for the
scheduling function, and accounts static (slots, accelerators) and dynamic
(memory, licenses, load) resources. Supports heterogeneous nodes via
attribute constraints and administrator-defined resources.

Aggregate queries are incremental: ``free_slots()``/``total_slots()`` are
O(1) counters maintained at allocate/release/state-change time, ``up_nodes()``
is a cached list invalidated only by membership changes (rare: failures,
drains, rejoins), and a free-capacity index (`_free_ids`) lets
``candidates()``/``free_nodes()`` consider only nodes with spare slots
instead of rebuilding O(nodes) lists per scheduling cycle.

The capacity-bucketed node index (``CapacityIndex``) goes further: it keeps
a dense free-slot mirror, a max segment tree over node ids (leftmost
node-with-``free >= s`` in O(log nodes) — the first-fit query every policy
and ``_gang_assign`` trial allocation needs), and per-capacity buckets
backed by lazy-deletion min-id heaps (the best-fit query bin-packing
needs).  It is updated incrementally on allocate/release/heartbeat-lapse/
node-failure/drain/rejoin, so no scheduling cycle ever rebuilds an
O(nodes) free map (Byun et al. 2021's node-indexed placement).

A copy of the reference's ``repro/core/resources.py``; test files named
below are the reference's, and ``tests/test_torch_scheduler.py`` holds this
copy equal to the reference.
"""
from __future__ import annotations

import enum
import heapq
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core.job import ResourceRequest, Task


class CapacityIndex:
    """Free-slot index over node ids: segment tree + capacity buckets.

    * ``free`` — dense per-node free-slot mirror (0 for DOWN/DRAINED nodes);
    * a max segment tree over node ids answering ``first_at_least(s, start)``
      (leftmost node id >= start with free >= s) in O(log nodes);
    * ``_buckets[c]`` — a lazy-deletion min-heap of node ids whose mirror
      value is ``c``.  Every transition *into* capacity ``c`` pushes a fresh
      entry; entries whose node has since moved on (``free[id] != c``) are
      stale and may be discarded whenever they surface at the top of the
      heap.  That discard contract is what lets policy-cycle overlays
      temporarily retarget mirror values (trial allocation) and restore them
      with plain ``set_free`` calls — restoring pushes fresh entries, so
      nothing is ever lost with the stale ones.

    All updates are O(log nodes); nothing here is ever rebuilt per cycle.
    """

    def __init__(self) -> None:
        self._size = 1                  # segment-tree leaf count (power of 2)
        self._tree: List[int] = [0, 0]
        self.free: List[int] = []       # dense mirror, indexed by node id
        self._buckets: Dict[int, List[int]] = {}
        self._pushes = 0                # bucket entries since last compaction

    # ------------------------------------------------------------ sizing
    def ensure(self, n: int) -> None:
        """Track node ids [0, n); grows the tree (rare: topology changes)."""
        if n <= len(self.free):
            return
        self.free.extend([0] * (n - len(self.free)))
        if n > self._size:
            size = self._size
            while size < n:
                size <<= 1
            tree = [0] * (2 * size)
            tree[size:size + len(self.free)] = self.free
            for i in range(size - 1, 0, -1):
                tree[i] = max(tree[2 * i], tree[2 * i + 1])
            self._size, self._tree = size, tree

    # ----------------------------------------------------------- updates
    def set_free(self, nid: int, c: int) -> None:
        """Point-update a node's free-slot count (mirror + tree + bucket)."""
        self.free[nid] = c
        i = nid + self._size
        tree = self._tree
        tree[i] = c
        i >>= 1
        while i:
            v = max(tree[2 * i], tree[2 * i + 1])
            if tree[i] == v:
                break
            tree[i] = v
            i >>= 1
        if c > 0:
            heapq.heappush(self._buckets.setdefault(c, []), nid)
            self._pushes += 1
            # workloads that never best-fit (FIFO, backfill) push entries
            # that nothing pops; periodically rebuild the buckets from the
            # mirror so stale entries cannot accumulate beyond O(nodes) —
            # amortized O(1) per update
            if self._pushes > max(4 * len(self.free), 256):
                self._compact()

    def _compact(self) -> None:
        buckets: Dict[int, List[int]] = {}
        for nid, c in enumerate(self.free):
            if c > 0:
                buckets.setdefault(c, []).append(nid)   # ascending = a heap
        self._buckets = buckets
        self._pushes = 0

    # ----------------------------------------------------------- queries
    def max_free(self) -> int:
        return self._tree[1]

    def first_at_least(self, s: int, start: int = 0) -> Optional[int]:
        """Leftmost node id >= ``start`` with ``free >= s`` (s >= 1)."""
        tree, size = self._tree, self._size
        if start >= size or tree[1] < s:
            return None
        i = start + size
        if tree[i] < s:
            while True:
                while i & 1:
                    i >>= 1
                if i == 0:
                    return None
                i += 1
                if tree[i] >= s:
                    break
        while i < size:
            i <<= 1
            if tree[i] < s:
                i += 1
        return i - size

    def pop_min_id_at(self, c: int, skip=frozenset()) -> Optional[int]:
        """Pop and return the smallest valid node id at capacity ``c``.

        Stale entries (``free[id] != c``) are discarded.  Ids in ``skip``
        are also discarded — callers use this for overlay-patched nodes they
        track elsewhere and re-push on restore (see the class docstring).
        Returns None when the bucket has no valid non-skipped id.
        """
        heap = self._buckets.get(c)
        while heap:
            nid = heap[0]
            if self.free[nid] != c or nid in skip:
                heapq.heappop(heap)
                continue
            return heapq.heappop(heap)
        return None

    def push_at(self, c: int, nid: int) -> None:
        """Return a popped-but-unconsumed id to its bucket."""
        if c > 0:
            heapq.heappush(self._buckets.setdefault(c, []), nid)

    def ids_at(self, c: int) -> Set[int]:
        """Valid node ids at capacity ``c`` (non-destructive; for tests)."""
        return {i for i in self._buckets.get(c, ()) if self.free[i] == c}


class NodeState(enum.Enum):
    UP = "up"
    DOWN = "down"
    DRAINED = "drained"    # no new work (maintenance / elastic shrink)


@dataclass(slots=True)
class Node:
    node_id: int
    slots: int = 1
    mem_mb: int = 1 << 20
    accelerators: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)
    state: NodeState = NodeState.UP
    # dynamic
    free_slots: int = 0
    free_mem: int = 0
    free_accel: int = 0
    load: float = 0.0
    last_heartbeat: float = 0.0
    running: Set[Tuple[int, int]] = field(default_factory=set)
    # fault-plane dynamics (core/faults.py).  ``alive`` distinguishes a
    # *silently* dead node from its scheduler-visible state: the node stays
    # UP (the scheduler keeps dispatching to it — lost work) until a
    # heartbeat sweep notices the lapse.  ``muted`` models heartbeat loss
    # without death: the node stops responding to sweeps but its tasks keep
    # completing, so detection is a false positive that requeues live work.
    # ``slow`` is a duration multiplier for degraded nodes (>= 1.0).
    alive: bool = True
    muted: bool = False
    slow: float = 1.0

    def __post_init__(self):
        self.free_slots = self.slots
        self.free_mem = self.mem_mb
        self.free_accel = self.accelerators

    def fits(self, req: ResourceRequest) -> bool:
        if self.state is not NodeState.UP:
            return False
        if req.slots > self.free_slots or req.mem_mb > self.free_mem:
            return False
        if req.accelerators > self.free_accel:
            return False
        return all(self.attrs.get(k) == v for k, v in req.node_attrs.items())

    def allocate(self, task: Task) -> None:
        r = task.request
        if not self.fits(r):
            raise RuntimeError(
                f"node {self.node_id} ({self.state.value}) has "
                f"{self.free_slots} free slots; task {task.key} needs "
                f"{r.slots}")
        self.free_slots -= r.slots
        self.free_mem -= r.mem_mb
        self.free_accel -= r.accelerators
        self.running.add(task.key)

    def release(self, task: Task) -> None:
        r = task.request
        if task.key not in self.running:
            return
        self.running.discard(task.key)
        self.free_slots += r.slots
        self.free_mem += r.mem_mb
        self.free_accel += r.accelerators


class ResourceManager:
    """Aggregates node state; the single source of truth for the scheduler."""

    def __init__(self, heartbeat_timeout: float = 30.0):
        self.nodes: Dict[int, Node] = {}
        self.licenses: Dict[str, int] = {}
        self.heartbeat_timeout = heartbeat_timeout
        # wall-clock runtimes (the reference's repro/rt/) set this:
        # liveness then comes ONLY from real ``heartbeat()`` calls carried
        # by worker messages — ``sweep_heartbeats`` stops auto-stamping
        # "responsive" nodes, so a worker that went quiet is detected within
        # timeout + interval
        self.external_heartbeats = False
        self._down_callbacks = []
        self._up_callbacks = []
        self._mute_callbacks = []
        # fired BEFORE any node-state mutation (death, drain, rejoin, slow,
        # mute, growth).  The scheduler's arena span keeps the free-slot
        # stack in numpy and leaves Node counters stale; ``_leave_up`` reads
        # ``node.free_slots`` before the down callbacks run, so the span
        # must be flushed strictly before the mutation starts — an ordinary
        # down callback fires too late.
        self._pre_change_cbs = []
        # incremental aggregates over UP nodes
        self._up_ids: Set[int] = set()
        self._up_cache: Optional[List[Node]] = None
        self._free_ids: Set[int] = set()   # UP nodes with free_slots > 0
        self._free_cache: Optional[List[Node]] = None
        self._free_slots = 0
        self._total_slots = 0
        self.index = CapacityIndex()       # capacity-bucketed node index
        # wave-path lazy index upkeep: unit-slot bulk allocate/release only
        # touch Node counters and enqueue the node id here; sync_index()
        # reconciles the capacity index / free-id set before any index
        # consumer (free_nodes, first_fit, candidates, the policy cycle)
        # reads it — O(nodes touched since last sync), not O(nodes)
        self._index_dirty: Set[int] = set()
        # fault-plane aggregates, kept as counters so the scheduler's
        # completion hot path pays one int truthiness check when no fault
        # machinery is active: UP-but-silently-dead nodes (completions on
        # them must be suppressed) and degraded (slow != 1.0) nodes
        self._hidden_dead = 0
        self._slow_nodes = 0
        # license holds by task key: makes ``release`` idempotent for
        # consumables.  Without it a second release for the same hold (e.g.
        # a node-death requeue racing a direct release call) silently
        # double-credits the license pool — the node-side release is guarded
        # by ``node.running`` but the license return was unconditional.
        self._lic_holds: Set[Tuple[int, int]] = set()

    # ---------------------------------------------------- aggregate upkeep
    def _join_up(self, node: Node) -> None:
        self._up_ids.add(node.node_id)
        self._total_slots += node.slots
        self._free_slots += node.free_slots
        if node.free_slots > 0:
            self._free_ids.add(node.node_id)
        self.index.set_free(node.node_id, node.free_slots)
        self._up_cache = None
        self._free_cache = None

    def _leave_up(self, node: Node) -> None:
        """Drop a node from the UP aggregates (free counts as of *now*)."""
        self._up_ids.discard(node.node_id)
        self._free_ids.discard(node.node_id)
        self._total_slots -= node.slots
        self._free_slots -= node.free_slots
        self.index.set_free(node.node_id, 0)
        self._up_cache = None
        self._free_cache = None

    def on_pre_change(self, callback) -> None:
        """Register a hook fired before any node-state mutation (see
        ``_pre_change_cbs``); ``callback()`` takes no arguments."""
        self._pre_change_cbs.append(callback)

    def _pre_change(self) -> None:
        for cb in self._pre_change_cbs:
            cb()

    # -------------------------------------------------------- topology
    def add_nodes(self, count: int, slots: int = 1, mem_mb: int = 1 << 20,
                  accelerators: int = 0, attrs: Optional[Dict] = None) -> List[int]:
        if self._pre_change_cbs:
            self._pre_change()
        start = len(self.nodes)
        self.index.ensure(start + count)
        ids = []
        for i in range(start, start + count):
            node = Node(i, slots=slots, mem_mb=mem_mb,
                        accelerators=accelerators, attrs=dict(attrs or {}))
            self.nodes[i] = node
            self._join_up(node)
            ids.append(i)
        return ids

    def add_license(self, name: str, count: int) -> None:
        self.licenses[name] = self.licenses.get(name, 0) + count

    # -------------------------------------------------------- dynamics
    def heartbeat(self, node_id: int, now: float, load: float = 0.0) -> None:
        node = self.nodes[node_id]
        if (self._pre_change_cbs
                and (not node.alive or node.state is NodeState.DOWN)):
            self._pre_change()
        node.last_heartbeat = now
        node.load = load
        if not node.alive:              # a received beat proves life
            node.alive = True
            if node.state is NodeState.UP:
                self._hidden_dead -= 1  # recovered before detection
        node.muted = False
        if node.state is NodeState.DOWN:
            node.state = NodeState.UP   # node rejoined (elastic growth)
            self._join_up(node)
            for cb in self._up_callbacks:
                cb(node_id)             # wake the scheduler: new capacity

    def check_heartbeats(self, now: float) -> List[int]:
        """Mark nodes DOWN whose heartbeat lapsed; returns newly-down ids."""
        if self._pre_change_cbs:
            self._pre_change()
        newly_down = []
        for node in self.nodes.values():
            if (node.state is NodeState.UP
                    and now - node.last_heartbeat > self.heartbeat_timeout):
                node.state = NodeState.DOWN
                if not node.alive:
                    self._hidden_dead -= 1   # silent death now detected
                self._leave_up(node)
                # forget the node's workload (as mark_down does): its tasks
                # are requeued with node_id=None, so nothing will ever
                # release these slots — without the reset a later rejoin
                # would restore the node with phantom tasks pinning capacity
                node.running.clear()
                node.free_slots = node.slots
                node.free_mem = node.mem_mb
                node.free_accel = node.accelerators
                newly_down.append(node.node_id)
        for nid in newly_down:
            for cb in self._down_callbacks:
                cb(nid)
        return newly_down

    def on_node_down(self, callback) -> None:
        self._down_callbacks.append(callback)

    def on_node_up(self, callback) -> None:
        self._up_callbacks.append(callback)

    def on_node_mute(self, callback) -> None:
        """Observe mute transitions: ``callback(node_id, muted)`` fires on
        every actual state change (``set_muted`` no-ops are not reported)."""
        self._mute_callbacks.append(callback)

    def sweep_heartbeats(self, now: float) -> List[int]:
        """One heartbeat-sweep round (scheduler-driven when
        ``SchedulerConfig.heartbeat_interval > 0``): responsive nodes are
        stamped as of ``now`` — a live, unmuted node always answers the
        poll — then lapsed ones are marked DOWN.  Detection latency for a
        silent death is therefore a virtual-time quantity in
        ``[heartbeat_timeout, heartbeat_timeout + heartbeat_interval]``,
        not an oracle.

        With ``external_heartbeats`` set (wall-clock runtimes) the
        auto-stamp is skipped entirely: only real ``heartbeat()`` calls —
        worker messages, task completions — count as liveness."""
        if not self.external_heartbeats:
            UP = NodeState.UP
            for node in self.nodes.values():
                if node.state is UP and node.alive and not node.muted:
                    node.last_heartbeat = now
        return self.check_heartbeats(now)

    def fail_silent(self, node_id: int, now: float) -> None:
        """Kill a node without telling anyone: state stays UP (the scheduler
        keeps dispatching to it), completions on it stop, and its heartbeat
        freezes at ``now`` — only a sweep (or an announced ``mark_down``)
        turns the death into requeues."""
        node = self.nodes[node_id]
        if node.state is not NodeState.UP or not node.alive:
            return
        if self._pre_change_cbs:
            self._pre_change()
        node.alive = False
        node.last_heartbeat = now
        self._hidden_dead += 1

    def set_muted(self, node_id: int, muted: bool, now: float = 0.0) -> None:
        """Start/stop heartbeat loss on a live node (false-positive fault)."""
        node = self.nodes[node_id]
        if node.muted == muted:
            return
        if self._pre_change_cbs:
            self._pre_change()
        node.muted = muted
        for cb in self._mute_callbacks:
            cb(node_id, muted)
        if not muted:
            # beats resume: rejoin if the lapse was already "detected"
            self.heartbeat(node_id, now)

    def set_slow(self, node_id: int, factor: float) -> None:
        """Degrade (factor > 1) or restore (factor = 1) a node's speed."""
        node = self.nodes[node_id]
        if self._pre_change_cbs and node.slow != factor:
            self._pre_change()
        if node.slow == 1.0 and factor != 1.0:
            self._slow_nodes += 1
        elif node.slow != 1.0 and factor == 1.0:
            self._slow_nodes -= 1
        node.slow = factor

    def mark_down(self, node_id: int) -> List[Tuple[int, int]]:
        """Fail a node; returns the task keys that were running on it."""
        if self._pre_change_cbs:
            self._pre_change()
        node = self.nodes[node_id]
        if node.state is NodeState.UP:
            if not node.alive:
                self._hidden_dead -= 1   # silent death now detected
            self._leave_up(node)
        node.state = NodeState.DOWN
        orphans = list(node.running)
        node.running.clear()
        node.free_slots = node.slots
        node.free_mem = node.mem_mb
        node.free_accel = node.accelerators
        for cb in self._down_callbacks:
            cb(node_id)
        return orphans

    def drain(self, node_id: int) -> None:
        if self._pre_change_cbs:
            self._pre_change()
        node = self.nodes[node_id]
        if node.state is NodeState.UP:
            self._leave_up(node)
        node.state = NodeState.DRAINED

    # ------------------------------------------------------ allocation
    def allocate(self, task: Task, node_id: int) -> None:
        if task.request.licenses:
            for lic in task.request.licenses:
                assert self.licenses.get(lic, 0) > 0, lic
                self.licenses[lic] -= 1
            self._lic_holds.add(task.key)
        node = self.nodes[node_id]
        node.allocate(task)
        task.node_id = node_id
        if node.state is NodeState.UP:
            self._free_slots -= task.request.slots
            self.index.set_free(node_id, node.free_slots)
            if node.free_slots <= 0:
                self._free_ids.discard(node_id)
                self._free_cache = None

    def release(self, task: Task) -> None:
        # consumables come back exactly once per hold: the hold set (not the
        # node-side ``running`` membership, which mark_down clears) is what
        # guards the credit, so a node dying mid-hold returns the licenses
        # on requeue and a duplicate release is a no-op instead of a silent
        # double-free (tests/test_faultplane.py pins both)
        if task.request.licenses and task.key in self._lic_holds:
            self._lic_holds.discard(task.key)
            for lic in task.request.licenses:
                self.licenses[lic] = self.licenses.get(lic, 0) + 1
        if task.node_id is not None and task.node_id in self.nodes:
            node = self.nodes[task.node_id]
            held = task.key in node.running
            node.release(task)
            if held and node.state is NodeState.UP:
                self._free_slots += task.request.slots
                self.index.set_free(node.node_id, node.free_slots)
                if node.free_slots > 0 and node.node_id not in self._free_ids:
                    self._free_ids.add(node.node_id)
                    self._free_cache = None

    # ------------------------------------------ wave-path bulk allocation
    def allocate_unit_wave(self, tasks: List[Task], node_ids: List[int],
                           wnodes: Optional[List[Node]] = None
                           ) -> List[Tuple[int, int]]:
        """Bulk unit-slot allocation (the scheduler's dispatch wave).

        The caller guarantees every task requests exactly one slot with no
        constraints/consumables; when ``wnodes`` (the per-slot Node objects,
        from the scheduler's validation scan) is given, the slots were
        already claimed (``free_slots`` decremented) during validation.
        Capacity-index / free-node-cache upkeep is deferred to
        :meth:`sync_index`.  Returns the per-task ``(job_id, index)`` keys
        so the wave's later phases (running-task index, coalesced
        completion) reuse them instead of rebuilding.
        """
        nodes = self.nodes
        claimed = wnodes is not None
        if not claimed:
            wnodes = [nodes[nid] for nid in node_ids]
        keys: List[Tuple[int, int]] = []
        kapp = keys.append
        for task, nid, node in zip(tasks, node_ids, wnodes):
            if not claimed:
                node.free_slots -= 1
            k = (task.job_id, task.index)
            node.running.add(k)
            task.node_id = nid
            kapp(k)
        self._index_dirty.update(node_ids)
        self._free_slots -= len(tasks)
        return keys

    def release_unit(self, task: Task) -> None:
        """Unit-slot release (wave completion fast path); lazy index upkeep.

        Exactly :meth:`release` for a one-slot, no-consumables task: a task
        whose node already forgot it (node failure reset) is a no-op.
        This is the tested reference form of the release that
        ``Scheduler._finish_wave`` inlines per drained member — change the
        two together (tests/test_wavepath.py pins this one).
        """
        node = self.nodes.get(task.node_id)
        if node is None:
            return
        key = (task.job_id, task.index)
        running = node.running
        if key not in running:
            return
        running.discard(key)
        node.free_slots += 1
        if node.state is NodeState.UP:
            self._free_slots += 1
            self._index_dirty.add(node.node_id)

    def sync_index(self) -> None:
        """Reconcile deferred wave-path updates into the capacity index.

        Every index consumer calls this first; between consumers the wave
        hot path pays one ``set.add`` per event instead of a segment-tree
        walk per allocate and per release.
        """
        dirty = self._index_dirty
        if not dirty:
            return
        nodes = self.nodes
        index = self.index
        free_ids = self._free_ids
        for nid in dirty:
            node = nodes[nid]
            c = node.free_slots if node.state is NodeState.UP else 0
            index.set_free(nid, c)
            if c > 0 and node.state is NodeState.UP:
                free_ids.add(nid)
            else:
                free_ids.discard(nid)
        dirty.clear()
        self._free_cache = None

    # --------------------------------------------------------- queries
    def up_nodes(self) -> List[Node]:
        if self._up_cache is None:
            self._up_cache = [self.nodes[i] for i in sorted(self._up_ids)]
        return self._up_cache

    def free_nodes(self) -> List[Node]:
        """UP nodes with spare slots, in node-id order (free-capacity index).

        Cached between membership changes, like ``up_nodes()``.
        """
        if self._index_dirty:
            self.sync_index()
        if self._free_cache is None:
            self._free_cache = [self.nodes[i] for i in sorted(self._free_ids)]
        return self._free_cache

    def free_slots(self) -> int:
        return self._free_slots

    def total_slots(self) -> int:
        return self._total_slots

    def candidates(self, req: ResourceRequest) -> List[Node]:
        if self._index_dirty:
            self.sync_index()
        if any(self.licenses.get(l, 0) <= 0 for l in req.licenses):
            return []
        if req.slots > 0:    # index only tracks nodes with spare slots
            return [n for n in self.free_nodes() if n.fits(req)]
        return [n for n in self.up_nodes() if n.fits(req)]

    def first_fit(self, req: ResourceRequest) -> Optional[Node]:
        """First fitting node in node-id order, via the capacity index:
        O(log nodes) tree descents instead of a free-list scan (and no
        ``free_nodes()`` cache rebuild churn when allocations saturate
        nodes mid-walk, as gang trial allocation does)."""
        if self._index_dirty:
            self.sync_index()
        if any(self.licenses.get(l, 0) <= 0 for l in req.licenses):
            return None
        if req.slots <= 0:
            for n in self.up_nodes():   # zero-slot: full nodes qualify
                if n.fits(req):
                    return n
            return None
        start = 0
        while True:
            nid = self.index.first_at_least(req.slots, start)
            if nid is None:
                return None
            node = self.nodes[nid]
            if node.fits(req):
                return node
            start = nid + 1
