from repro_torch.kernels.splitter_aggregate.ops import splitter_aggregate

__all__ = ["splitter_aggregate"]
