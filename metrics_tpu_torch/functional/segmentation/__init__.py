"""Functional segmentation metrics.

The names are those of ``metrics_tpu.functional.segmentation.__all__``, in its
order.
"""

from metrics_tpu_torch.functional.segmentation.metrics import (
    dice_score,
    generalized_dice_score,
    hausdorff_distance,
    mean_iou,
)

__all__ = ["dice_score", "generalized_dice_score", "hausdorff_distance", "mean_iou"]
