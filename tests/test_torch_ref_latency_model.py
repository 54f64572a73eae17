"""The reference's tests/test_latency_model.py, run against repro_torch.core's
latency model and Table-10 fit."""
from torch_ref_suite import export

export("test_latency_model", globals())
