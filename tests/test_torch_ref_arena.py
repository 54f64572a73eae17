"""The reference's tests/test_arena.py, run against repro_torch.core's arena
with repro_torch.obs's flight recorder and repro_torch.workloads."""
from torch_ref_suite import export

export("test_arena", globals())
