"""The reference's tests/test_properties.py, run against repro_torch.core's
property tests (all but one model test, see torch_ref_suite.LEFT_OUT)."""
from torch_ref_suite import export

export("test_properties", globals())
