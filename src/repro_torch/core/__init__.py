from repro_torch.core.job import Job, ResourceRequest, Task
from repro_torch.core.resources import Node, NodeState, ResourceManager

__all__ = ["Job", "Node", "NodeState", "ResourceManager", "ResourceRequest",
           "Task"]
