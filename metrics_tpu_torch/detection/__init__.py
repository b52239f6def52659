"""Detection metrics (counterpart of ``metrics_tpu/detection``).

Ported: the four box-IoU metrics and ``MeanAveragePrecision`` for boxes.
Mask IoU (``iou_type="segm"``) and panoptic quality are not ported yet.
"""

from metrics_tpu_torch.detection.iou_metrics import (
    CompleteIntersectionOverUnion,
    DistanceIntersectionOverUnion,
    GeneralizedIntersectionOverUnion,
    IntersectionOverUnion,
)
from metrics_tpu_torch.detection.mean_ap import MeanAveragePrecision

__all__ = [
    "CompleteIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "IntersectionOverUnion",
    "MeanAveragePrecision",
]
