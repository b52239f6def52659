"""Pairwise box IoU, GIoU, DIoU and CIoU (counterpart of ``metrics_tpu/functional/detection/iou.py``).

Boxes are xyxy and are computed in float32, as the JAX package computes them; every
function returns the ``(N, M)`` matrix, or with ``aggregate`` the mean of its diagonal (paired boxes).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

Tensor = torch.Tensor

__all__ = [
    "complete_intersection_over_union",
    "distance_intersection_over_union",
    "generalized_intersection_over_union",
    "intersection_over_union",
]


def _box_area(boxes: Tensor) -> Tensor:
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (boxes[..., 3] - boxes[..., 1]).clamp(min=0)


def _box_inter_union(preds: Tensor, target: Tensor):
    lt = torch.maximum(preds[:, None, :2], target[None, :, :2])
    rb = torch.minimum(preds[:, None, 2:], target[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = _box_area(preds)[:, None] + _box_area(target)[None, :] - inter
    return inter, union


def _iou(preds: Tensor, target: Tensor):
    inter, union = _box_inter_union(preds, target)
    return inter / union.clamp(min=1e-9), union


def _enclosing(preds: Tensor, target: Tensor):
    lt = torch.minimum(preds[:, None, :2], target[None, :, :2])
    rb = torch.maximum(preds[:, None, 2:], target[None, :, 2:])
    return lt, rb


def _center_terms(preds: Tensor, target: Tensor):
    """(squared distance of the centers, squared diagonal of the enclosing box)."""
    cp = (preds[:, :2] + preds[:, 2:]) / 2
    ct = (target[:, :2] + target[:, 2:]) / 2
    center_dist = ((cp[:, None, :] - ct[None, :, :]) ** 2).sum(dim=-1)
    lt, rb = _enclosing(preds, target)
    return center_dist, ((rb - lt) ** 2).sum(dim=-1)


def _finish(value: Tensor, iou_threshold: Optional[float], replacement_val: float, aggregate: bool) -> Tensor:
    # the threshold applies to the metric's own value, which can be negative for GIoU, DIoU and CIoU
    if iou_threshold is not None:
        value = torch.where(value >= iou_threshold, value, float(replacement_val))
    if aggregate:
        return torch.diagonal(value).mean()
    return value


def intersection_over_union(
    preds: Tensor, target: Tensor, iou_threshold: Optional[float] = None, replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    """Pairwise IoU of xyxy boxes.

    >>> preds = torch.tensor([[100.0, 100.0, 200.0, 200.0]])
    >>> target = torch.tensor([[110.0, 110.0, 210.0, 210.0]])
    >>> intersection_over_union(preds, target)
    tensor(0.6807)
    """
    iou, _ = _iou(preds.to(torch.float32), target.to(torch.float32))
    return _finish(iou, iou_threshold, replacement_val, aggregate)


def generalized_intersection_over_union(
    preds: Tensor, target: Tensor, iou_threshold: Optional[float] = None, replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    """Pairwise GIoU: IoU less the share of the enclosing box that neither box covers.

    >>> preds = torch.tensor([[100.0, 100.0, 200.0, 200.0]])
    >>> target = torch.tensor([[110.0, 110.0, 210.0, 210.0]])
    >>> generalized_intersection_over_union(preds, target)
    tensor(0.6641)
    """
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    iou, union = _iou(preds, target)
    lt, rb = _enclosing(preds, target)
    wh = (rb - lt).clamp(min=0)
    area_c = wh[..., 0] * wh[..., 1]
    giou = iou - (area_c - union) / area_c.clamp(min=1e-9)
    return _finish(giou, iou_threshold, replacement_val, aggregate)


def distance_intersection_over_union(
    preds: Tensor, target: Tensor, iou_threshold: Optional[float] = None, replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    """Pairwise DIoU: IoU less the squared center distance over the enclosing box's squared diagonal."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    iou, _ = _iou(preds, target)
    center_dist, diag = _center_terms(preds, target)
    diou = iou - center_dist / diag.clamp(min=1e-9)
    return _finish(diou, iou_threshold, replacement_val, aggregate)


def complete_intersection_over_union(
    preds: Tensor, target: Tensor, iou_threshold: Optional[float] = None, replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    """Pairwise CIoU: DIoU less a term for the difference of the aspect ratios."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    iou, _ = _iou(preds, target)
    center_dist, diag = _center_terms(preds, target)
    wp = (preds[:, 2] - preds[:, 0]).clamp(min=1e-9)
    hp = (preds[:, 3] - preds[:, 1]).clamp(min=1e-9)
    wt = (target[:, 2] - target[:, 0]).clamp(min=1e-9)
    ht = (target[:, 3] - target[:, 1]).clamp(min=1e-9)
    v = (4 / math.pi**2) * (torch.atan(wt / ht)[None, :] - torch.atan(wp / hp)[:, None]) ** 2
    alpha = v / (1 - iou + v).clamp(min=1e-9)
    ciou = iou - center_dist / diag.clamp(min=1e-9) - alpha * v
    return _finish(ciou, iou_threshold, replacement_val, aggregate)
