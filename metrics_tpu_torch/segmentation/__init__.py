"""Segmentation metrics.

The names are those of ``metrics_tpu.segmentation.__all__``, in its order.
"""

from metrics_tpu_torch.segmentation.metrics import DiceScore, GeneralizedDiceScore, HausdorffDistance, MeanIoU

__all__ = ["DiceScore", "GeneralizedDiceScore", "HausdorffDistance", "MeanIoU"]
