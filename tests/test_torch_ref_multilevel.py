"""The reference's tests/test_multilevel.py, run against repro_torch.core's
multilevel aggregation."""
from torch_ref_suite import export

export("test_multilevel", globals())
