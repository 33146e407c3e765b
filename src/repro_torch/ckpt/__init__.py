from repro_torch.ckpt.checkpoint import Checkpointer

__all__ = ["Checkpointer"]
