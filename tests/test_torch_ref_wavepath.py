"""The reference's tests/test_wavepath.py, run against the wave path of
repro_torch.core with repro_torch.workloads."""
from torch_ref_suite import export

export("test_wavepath", globals())
