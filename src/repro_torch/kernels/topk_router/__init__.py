from repro_torch.kernels.topk_router.ops import topk_router
from repro_torch.kernels.topk_router.ref import topk_router_ref

__all__ = ["topk_router", "topk_router_ref"]
