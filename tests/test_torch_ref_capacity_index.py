"""The reference's tests/test_capacity_index.py, run against the capacity index
of repro_torch.core.resources."""
from torch_ref_suite import export

export("test_capacity_index", globals())
