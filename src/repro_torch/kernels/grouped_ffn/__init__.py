from repro_torch.kernels.grouped_ffn.ops import grouped_ffn
from repro_torch.kernels.grouped_ffn.ref import grouped_ffn_ref

__all__ = ["grouped_ffn", "grouped_ffn_ref"]
