from repro_torch.data.pipeline import SyntheticTokens, TokenPipeline

__all__ = ["SyntheticTokens", "TokenPipeline"]
