"""Functional detection metrics (counterpart of ``metrics_tpu/functional/detection``).

Panoptic quality is not ported yet.
"""

from metrics_tpu_torch.functional.detection.iou import (
    complete_intersection_over_union,
    distance_intersection_over_union,
    generalized_intersection_over_union,
    intersection_over_union,
)

__all__ = [
    "complete_intersection_over_union",
    "distance_intersection_over_union",
    "generalized_intersection_over_union",
    "intersection_over_union",
]
