"""The reference's tests/test_policy_equivalence.py, run against
repro_torch.core's indexed policies, against the seed policies with license
counting in locality (torch_reference_policies.py)."""
from torch_ref_suite import export

export("test_policy_equivalence", globals())
