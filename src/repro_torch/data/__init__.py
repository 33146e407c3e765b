from repro_torch.data.synthetic import SyntheticTokens, VaryingSyntheticTokens

__all__ = ["SyntheticTokens", "VaryingSyntheticTokens"]
