from repro_torch.kernels.edge_hook.ops import edge_hook

__all__ = ["edge_hook"]
