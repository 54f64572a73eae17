from repro_torch.core.job import Job, ResourceRequest, Task
from repro_torch.core.resources import Node, ResourceManager

__all__ = ["Job", "Node", "ResourceManager", "ResourceRequest", "Task"]
