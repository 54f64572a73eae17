"""The reference's tests/test_scheduler.py, run against repro_torch.core's
scheduler."""
from torch_ref_suite import export

export("test_scheduler", globals())
