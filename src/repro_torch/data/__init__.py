from repro_torch.data.synthetic import SyntheticTokens

__all__ = ["SyntheticTokens"]
