"""The reference's tests/test_workloads.py, run against
repro_torch.workloads."""
from torch_ref_suite import export

export("test_workloads", globals())
