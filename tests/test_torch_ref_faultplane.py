"""The reference's tests/test_faultplane.py, run against repro_torch.core's
fault plane and repro_torch.workloads."""
from torch_ref_suite import export

export("test_faultplane", globals())
