"""Measurement scripts of the port: ``python -m repro_torch.bench.<name>``."""
