"""The reference's tests/test_obs.py, run against repro_torch.obs (flight
recorder, registry, self-profiler, dashboard) over repro_torch.core and
repro_torch.workloads, with test_faultplane's and test_wavepath's port
copies and repro_torch.bench.common."""
from torch_ref_suite import export

export("test_obs", globals())
