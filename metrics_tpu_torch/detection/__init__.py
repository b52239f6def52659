"""Detection metrics (counterpart of ``metrics_tpu/detection``).

The names are those of ``metrics_tpu.detection.__all__``, in its order: the
four box-IoU metrics, ``MeanAveragePrecision`` (boxes and masks) and
panoptic quality.
"""

from metrics_tpu_torch.detection.iou_metrics import (
    CompleteIntersectionOverUnion,
    DistanceIntersectionOverUnion,
    GeneralizedIntersectionOverUnion,
    IntersectionOverUnion,
)
from metrics_tpu_torch.detection.mean_ap import MeanAveragePrecision
from metrics_tpu_torch.detection.panoptic_quality import ModifiedPanopticQuality, PanopticQuality

__all__ = [
    "CompleteIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "IntersectionOverUnion",
    "MeanAveragePrecision",
    "ModifiedPanopticQuality",
    "PanopticQuality",
]
