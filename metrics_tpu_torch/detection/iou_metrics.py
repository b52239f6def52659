"""Box IoU, GIoU, DIoU and CIoU as metrics (counterpart of ``metrics_tpu/detection/iou_metrics.py``)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from metrics_tpu_torch.functional.detection.iou import (
    complete_intersection_over_union,
    distance_intersection_over_union,
    generalized_intersection_over_union,
    intersection_over_union,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import count_dtype

Tensor = torch.Tensor

__all__ = [
    "CompleteIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "IntersectionOverUnion",
]


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class IntersectionOverUnion(Metric):
    """Mean IoU of the (prediction, ground truth) box pairs of each image that share a label (unless
    ``respect_labels=False``) and clear ``iou_threshold``; per class too with ``class_metrics``.

    >>> preds = [{"boxes": torch.tensor([[296.55, 93.96, 314.97, 152.79]]),
    ...           "scores": torch.tensor([0.236]), "labels": torch.tensor([4])}]
    >>> target = [{"boxes": torch.tensor([[300.00, 100.0, 315.0, 150.0]]), "labels": torch.tensor([4])}]
    >>> metric = IntersectionOverUnion(device="cpu")
    >>> metric.update(preds, target)
    >>> round(float(metric.compute()["iou"]), 4)
    0.6898
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = True
    _iou_fn = staticmethod(intersection_over_union)
    _iou_type: str = "iou"
    _invalid_val: float = -1.0
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if box_format not in ("xyxy", "xywh", "cxcywh"):
            raise ValueError(f"Expected argument `box_format` to be one of ('xyxy', 'xywh', 'cxcywh') but got {box_format}")
        self.box_format = box_format
        self.iou_threshold = iou_threshold
        self.class_metrics = class_metrics
        self.respect_labels = respect_labels
        self.add_state("iou_sum", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")
        self._class_sums: Dict[int, List[float]] = {}

    def _to_xyxy(self, boxes: Tensor) -> Tensor:
        if self.box_format == "xyxy" or boxes.numel() == 0:
            return boxes
        if self.box_format == "xywh":
            return torch.cat([boxes[:, :2], boxes[:, :2] + boxes[:, 2:]], dim=1)
        return torch.cat([boxes[:, :2] - boxes[:, 2:] / 2, boxes[:, :2] + boxes[:, 2:] / 2], dim=1)

    def _boxes(self, boxes: Any) -> Tensor:
        return self._to_xyxy(torch.as_tensor(boxes).to(self.device, torch.float32).reshape(-1, 4))

    def update(self, preds: Sequence[Dict[str, Any]], target: Sequence[Dict[str, Any]]) -> None:
        """Add each image's box pairs."""
        for p, t in zip(preds, target):
            p_boxes, t_boxes = self._boxes(p["boxes"]), self._boxes(t["boxes"])
            if p_boxes.shape[0] == 0 or t_boxes.shape[0] == 0:
                continue
            matrix = type(self)._iou_fn(p_boxes, t_boxes, None, self._invalid_val, aggregate=False)
            p_lab = _host(p["labels"]).reshape(-1)
            if self.respect_labels:
                mask = p_lab[:, None] == _host(t["labels"]).reshape(-1)[None, :]
                matrix = torch.where(torch.from_numpy(mask).to(self.device), matrix, self._invalid_val)
            if self.iou_threshold is not None:
                matrix = torch.where(matrix >= self.iou_threshold, matrix, self._invalid_val)
            valid = matrix > self._invalid_val
            self.iou_sum = self.iou_sum + torch.where(valid, matrix, 0.0).sum()
            self.total = self.total + valid.sum()
            if self.class_metrics:
                for cls in np.unique(p_lab):
                    sel = torch.from_numpy(p_lab == cls).to(self.device)
                    vals = matrix[valid & sel[:, None]].cpu().tolist()
                    self._class_sums.setdefault(int(cls), []).extend(vals)

    def compute(self) -> Dict[str, Tensor]:
        key = self._iou_type
        out = {key: torch.where(self.total > 0, self.iou_sum / self.total.clamp(min=1), 0.0).to(torch.float32)}
        if self.class_metrics:
            for cls, vals in sorted(self._class_sums.items()):
                out[f"{key}/cl_{cls}"] = torch.tensor(float(np.mean(vals)) if vals else 0.0, device=self.device)
        return out

    def reset(self) -> None:
        super().reset()
        self._class_sums = {}


class GeneralizedIntersectionOverUnion(IntersectionOverUnion):
    """GIoU for object detection."""

    _iou_fn = staticmethod(generalized_intersection_over_union)
    _iou_type = "giou"
    plot_lower_bound = -1.0


class DistanceIntersectionOverUnion(IntersectionOverUnion):
    """DIoU for object detection."""

    _iou_fn = staticmethod(distance_intersection_over_union)
    _iou_type = "diou"
    plot_lower_bound = -1.0


class CompleteIntersectionOverUnion(IntersectionOverUnion):
    """CIoU for object detection."""

    _iou_fn = staticmethod(complete_intersection_over_union)
    _iou_type = "ciou"
    plot_lower_bound = -1.0
