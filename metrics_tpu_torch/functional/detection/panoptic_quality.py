"""Panoptic quality as functions (counterpart of ``metrics_tpu/functional/detection/panoptic_quality.py``)."""

from __future__ import annotations

from typing import Collection

import torch

__all__ = ["modified_panoptic_quality", "panoptic_quality"]


def _run(cls_name: str, preds, target, things, stuffs, allow_unknown_preds_category, return_sq_and_rq,
         return_per_class) -> torch.Tensor:
    from metrics_tpu_torch.detection import panoptic_quality as modular

    metric = getattr(modular, cls_name)(
        things=set(things),
        stuffs=set(stuffs),
        allow_unknown_preds_category=allow_unknown_preds_category,
        return_sq_and_rq=return_sq_and_rq,
        return_per_class=return_per_class,
        device=preds.device if isinstance(preds, torch.Tensor) else None,
    )
    metric.update(preds, target)
    return metric.compute()


def panoptic_quality(
    preds: torch.Tensor,
    target: torch.Tensor,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
    return_sq_and_rq: bool = False,
    return_per_class: bool = False,
) -> torch.Tensor:
    """Panoptic quality of ``(..., H, W, 2)`` (category id, instance id) maps, computed on their device.

    >>> preds = torch.tensor([[[[6, 0], [0, 0], [6, 0], [6, 0]],
    ...                        [[0, 0], [0, 0], [6, 0], [0, 1]],
    ...                        [[0, 0], [0, 0], [6, 0], [0, 1]],
    ...                        [[0, 0], [7, 0], [6, 0], [1, 0]],
    ...                        [[0, 0], [7, 0], [7, 0], [7, 0]]]])
    >>> target = torch.tensor([[[[6, 0], [0, 1], [6, 0], [0, 1]],
    ...                         [[0, 1], [0, 1], [6, 0], [0, 1]],
    ...                         [[0, 1], [0, 1], [6, 0], [1, 0]],
    ...                         [[0, 1], [7, 0], [1, 0], [1, 0]],
    ...                         [[0, 1], [7, 0], [7, 0], [7, 0]]]])
    >>> panoptic_quality(preds, target, things={0, 1}, stuffs={6, 7})
    tensor(0.5463)
    """
    return _run("PanopticQuality", preds, target, things, stuffs, allow_unknown_preds_category, return_sq_and_rq,
                return_per_class)


def modified_panoptic_quality(
    preds: torch.Tensor,
    target: torch.Tensor,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
    return_sq_and_rq: bool = False,
    return_per_class: bool = False,
) -> torch.Tensor:
    """Modified panoptic quality (a stuff segment scores its IoU without the 0.5 matching rule), computed on
    the maps' device."""
    return _run("ModifiedPanopticQuality", preds, target, things, stuffs, allow_unknown_preds_category,
                return_sq_and_rq, return_per_class)
