from repro_torch.kernels.ordered_fold.ops import (
    FoldPlan,
    fold_plan,
    ordered_fold_gathered,
    ordered_fold_sorted,
)

__all__ = ["FoldPlan", "fold_plan", "ordered_fold_gathered", "ordered_fold_sorted"]
