"""The reference's tests/test_hotpath.py, run against the scheduler's hot path
(queues, fair share, wave dispatch) in repro_torch.core."""
from torch_ref_suite import export

export("test_hotpath", globals())
