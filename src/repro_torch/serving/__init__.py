from repro_torch.serving.engine import ServeRequest, ServingEngine

__all__ = ["ServeRequest", "ServingEngine"]
