from repro_torch.ckpt.checkpoint import Checkpointer, Layout

__all__ = ["Checkpointer", "Layout"]
