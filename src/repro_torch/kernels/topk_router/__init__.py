from repro_torch.kernels.topk_router.ops import route_plan, topk_router
from repro_torch.kernels.topk_router.ref import route_plan_ref, topk_router_ref

__all__ = ["route_plan", "route_plan_ref", "topk_router", "topk_router_ref"]
