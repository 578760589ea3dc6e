from repro_torch.kernels.pointer_jump.ops import pointer_jump

__all__ = ["pointer_jump"]
