from repro_torch.kernels.segment_sum.ops import segment_sum_sorted

__all__ = ["segment_sum_sorted"]
