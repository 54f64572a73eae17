"""Node slots: the part of the scheduler's resource manager serving uses.

A trimmed copy of the reference's ``ResourceManager``: nodes with job slots,
allocation that refuses a task the node cannot fit, and an idempotent
release (a second release of the same task changes nothing).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from repro_torch.core.job import Task


@dataclass
class Node:
    node_id: int
    slots: int = 1
    free_slots: int = 0
    running: Set[Tuple[int, int]] = field(default_factory=set)

    def __post_init__(self):
        self.free_slots = self.slots

    def fits(self, task: Task) -> bool:
        return task.request.slots <= self.free_slots


class ResourceManager:
    def __init__(self):
        self.nodes: Dict[int, Node] = {}

    def add_nodes(self, count: int, slots: int = 1) -> List[int]:
        start = len(self.nodes)
        ids = list(range(start, start + count))
        for i in ids:
            self.nodes[i] = Node(i, slots=slots)
        return ids

    def allocate(self, task: Task, node_id: int) -> None:
        node = self.nodes[node_id]
        if not node.fits(task):
            raise RuntimeError(f"node {node_id} has {node.free_slots} free "
                               f"slots; task {task.key} needs "
                               f"{task.request.slots}")
        node.free_slots -= task.request.slots
        node.running.add(task.key)
        task.node_id = node_id

    def release(self, task: Task) -> None:
        node = self.nodes.get(task.node_id)
        if node is None or task.key not in node.running:
            return
        node.running.discard(task.key)
        node.free_slots += task.request.slots
