from repro_torch.kernels.paged_attention.ops import (paged_decode_attention,
                                                     paged_mla_decode)
from repro_torch.kernels.paged_attention.ref import (
    paged_decode_attention_ref, paged_mla_decode_ref)

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "paged_mla_decode", "paged_mla_decode_ref"]
