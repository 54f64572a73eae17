"""Nodes: the parts of the scheduler's resource manager the port uses.

A trimmed copy of the reference's ``ResourceManager``. Serving uses nodes
with job slots, allocation that refuses a task the node cannot fit, and an
idempotent release (a second release of the same task changes nothing).
Fault-tolerant training uses liveness: heartbeats, a sweep that marks a
node DOWN when its heartbeat lapsed, ``mark_down`` for a failure seen
directly, and rejoin of a DOWN node on its next heartbeat.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from repro_torch.core.job import Task


class NodeState(enum.Enum):
    UP = "up"
    DOWN = "down"


@dataclass
class Node:
    node_id: int
    slots: int = 1
    state: NodeState = NodeState.UP
    free_slots: int = 0
    last_heartbeat: float = 0.0
    running: Set[Tuple[int, int]] = field(default_factory=set)

    def __post_init__(self):
        self.free_slots = self.slots

    def fits(self, task: Task) -> bool:
        return (self.state is NodeState.UP
                and task.request.slots <= self.free_slots)


class ResourceManager:
    def __init__(self, heartbeat_timeout: float = 30.0):
        self.nodes: Dict[int, Node] = {}
        self.heartbeat_timeout = heartbeat_timeout

    def add_nodes(self, count: int, slots: int = 1) -> List[int]:
        start = len(self.nodes)
        ids = list(range(start, start + count))
        for i in ids:
            self.nodes[i] = Node(i, slots=slots)
        return ids

    def allocate(self, task: Task, node_id: int) -> None:
        node = self.nodes[node_id]
        if not node.fits(task):
            raise RuntimeError(f"node {node_id} ({node.state.value}) has "
                               f"{node.free_slots} free slots; task "
                               f"{task.key} needs {task.request.slots}")
        node.free_slots -= task.request.slots
        node.running.add(task.key)
        task.node_id = node_id

    def release(self, task: Task) -> None:
        node = self.nodes.get(task.node_id)
        if node is None or task.key not in node.running:
            return
        node.running.discard(task.key)
        node.free_slots += task.request.slots

    # ------------------------------------------------------------ liveness
    def heartbeat(self, node_id: int, now: float) -> None:
        """Record a beat at ``now``; a DOWN node rejoins as UP."""
        node = self.nodes[node_id]
        node.last_heartbeat = now
        node.state = NodeState.UP

    def check_heartbeats(self, now: float) -> List[int]:
        """Mark DOWN every UP node whose last beat is more than the timeout
        before ``now``; returns the ids newly marked, in id order."""
        lapsed = [n.node_id for n in self.nodes.values()
                  if n.state is NodeState.UP
                  and now - n.last_heartbeat > self.heartbeat_timeout]
        for node_id in lapsed:
            self.mark_down(node_id)
        return lapsed

    def mark_down(self, node_id: int) -> List[Tuple[int, int]]:
        """Fail a node; returns the keys of the tasks that were running on
        it. The node forgets them and its slots are free when it rejoins."""
        node = self.nodes[node_id]
        node.state = NodeState.DOWN
        orphans = list(node.running)
        node.running.clear()
        node.free_slots = node.slots
        return orphans

    def up_nodes(self) -> List[Node]:
        return [self.nodes[i] for i in sorted(self.nodes)
                if self.nodes[i].state is NodeState.UP]
