"""The reference's tests/test_rt.py, run against repro_torch.rt over
repro_torch.core, with repro_torch.obs's flight recorder and registry."""
from torch_ref_suite import export

export("test_rt", globals())
