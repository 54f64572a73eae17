"""The reference's tests/test_policy_failures.py, run against the placement
policies of repro_torch.core under node failures."""
from torch_ref_suite import export

export("test_policy_failures", globals())
