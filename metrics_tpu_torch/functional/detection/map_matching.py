"""COCO matching on the card, the core of ``MeanAveragePrecision`` (counterpart of
``metrics_tpu/functional/detection/map_matching.py``).

Evaluation units are (image, class) pairs, padded to common capacities
``(U, D, 4)`` and ``(U, G, 4)``. Their IoU matrices come from one broadcast,
``(U, D, G)``, and the greedy matching in score order is one loop over the D
detection slots, each step vectorised over units, area ranges, IoU
thresholds and ground truths. The JAX package runs that loop as one
``lax.scan``.

COCOeval's rules, reproduced exactly:

* non-ignored ground truths come first: an ignored one is matched only when
  no non-ignored one clears the threshold;
* equal IoUs go to the LAST ground truth (:func:`_last_argmax`);
* a matched ground truth is out, unless it is a crowd region;
* a detection matched to an ignored ground truth is ignored itself, and an
  unmatched detection outside the area range is ignored, not a false positive.

IoUs and thresholds are float32, as the JAX package has them (it builds them
in float64 and hands them to the device without x64), so a match at an IoU
within an ulp of a threshold goes the same way in both; ``1 - 1e-10`` rounds
to 1 in float32, so a threshold of 1 needs an IoU of exactly 1.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

__all__ = ["batched_box_iou", "batched_mask_iou", "match_units"]


def batched_box_iou(det_boxes: Tensor, gt_boxes: Tensor, gt_crowd: Tensor) -> Tensor:
    """The IoU matrix of every unit: ``(U, D, 4) x (U, G, 4) -> (U, D, G)``, in float32.

    For a crowd ground truth the denominator is the detection's own area, as COCO has it.
    """
    det_boxes = det_boxes.to(torch.float32)
    gt_boxes = gt_boxes.to(torch.float32)
    lt = torch.maximum(det_boxes[:, :, None, :2], gt_boxes[:, None, :, :2])
    rb = torch.minimum(det_boxes[:, :, None, 2:], gt_boxes[:, None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    det_area = (det_boxes[..., 2] - det_boxes[..., 0]).clamp(min=0) * (det_boxes[..., 3] - det_boxes[..., 1]).clamp(min=0)
    gt_area = (gt_boxes[..., 2] - gt_boxes[..., 0]).clamp(min=0) * (gt_boxes[..., 3] - gt_boxes[..., 1]).clamp(min=0)
    union = det_area[:, :, None] + gt_area[:, None, :] - inter
    union = torch.where(gt_crowd[:, None, :], det_area[:, :, None], union)
    return inter / union.clamp(min=1e-9)


def batched_mask_iou(det_masks: Tensor, gt_masks: Tensor, gt_crowd: Tensor,
                     dtype: torch.dtype = torch.float32) -> Tensor:
    """The mask IoU matrix of every unit: ``(U, D, P) x (U, G, P) -> (U, D, G)``; P is the flattened pixel
    count, in any order both sides share.

    The intersections are one batched matrix product of float32 operands. The masks are 0 and 1, so every
    product is exact (in TF32 too) and every sum is an integer, exact in float32 below 2^24 pixels. The IoUs
    are then the correctly rounded quotients in ``dtype``: float32 as the JAX package's einsum gives them,
    float64 as its host ``rle_iou`` does. fp16 or bf16 operands would not do: an intersection of a 640 x 480
    mask overflows fp16's range, and bf16 rounds integers above 256. A crowd ground truth's denominator is
    the detection's own area.
    """
    det_masks = det_masks.to(torch.float32)
    gt_masks = gt_masks.to(torch.float32)
    inter = torch.bmm(det_masks, gt_masks.transpose(1, 2)).to(dtype)
    det_area = det_masks.sum(-1).to(dtype)
    gt_area = gt_masks.sum(-1).to(dtype)
    union = det_area[:, :, None] + gt_area[:, None, :] - inter
    union = torch.where(gt_crowd[:, None, :], det_area[:, :, None], union)
    return inter / union.clamp(min=1e-9)


def _last_argmax(values: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Argmax over the last axis where ``mask`` holds, equal maxima going to the LAST index; and whether
    any entry holds. ``torch.argmax`` returns the first maximum, so it runs on the reversed axis."""
    rev = torch.where(mask, values, -torch.inf).flip(-1)
    idx = values.shape[-1] - 1 - torch.argmax(rev, dim=-1)
    return idx, mask.any(dim=-1)


def match_units(
    ious: Tensor,
    gt_valid: Tensor,
    gt_crowd: Tensor,
    gt_ignore: Tensor,
    det_valid: Tensor,
    det_out_of_range: Tensor,
    iou_thresholds: Tensor,
) -> Tuple[Tensor, Tensor]:
    """Greedy COCO matching of every unit, area range and threshold.

    Args:
        ious: ``(U, D, G)`` float32 IoUs, detections sorted by descending score (stable), ground truths in
            their order in the image.
        gt_valid: ``(U, G)`` padding mask.
        gt_crowd: ``(U, G)`` COCO ``iscrowd`` flags.
        gt_ignore: ``(U, A, G)`` ignored per area range (crowd, or area outside the range).
        det_valid: ``(U, D)`` padding mask.
        det_out_of_range: ``(U, A, D)`` detection area outside the range.
        iou_thresholds: ``(T,)``, compared in float32.

    Returns:
        ``(dtm, dtig)``, each ``(U, A, T, D)`` bool: matched, and ignored, per detection slot.
    """
    u, d_cap, g_cap = ious.shape
    a_n = gt_ignore.shape[1]
    thr = iou_thresholds.to(device=ious.device, dtype=torch.float32)
    thr = torch.minimum(thr, torch.tensor(1 - 1e-10, dtype=torch.float32, device=ious.device))
    thr = thr[None, None, :, None]  # (1, 1, T, 1)
    t_n = thr.shape[2]
    avail = gt_valid[:, None, None, :]  # (U, 1, 1, G)
    gt_ig = gt_ignore[:, :, None, :]  # (U, A, 1, G)
    gt_cr = gt_crowd[:, None, None, :]
    gtm = torch.zeros((u, a_n, t_n, g_cap), dtype=torch.bool, device=ious.device)
    dtm = torch.zeros((u, a_n, t_n, d_cap), dtype=torch.bool, device=ious.device)
    dtig = torch.zeros_like(dtm)
    for d in range(d_cap):
        iou_d = ious[:, d, :][:, None, None, :]  # (U, 1, 1, G)
        cand = avail & (~gtm | gt_cr) & (iou_d >= thr) & det_valid[:, d][:, None, None, None]
        iou_b = iou_d.expand(cand.shape)
        idx_non, has_non = _last_argmax(iou_b, cand & ~gt_ig)
        idx_ign, has_ign = _last_argmax(iou_b, cand & gt_ig)
        matched = has_non | has_ign
        m_idx = torch.where(has_non, idx_non, idx_ign)
        gtm = gtm | (F.one_hot(m_idx, g_cap).bool() & matched[..., None])
        dtm[..., d] = matched
        dtig[..., d] = matched & ~has_non  # matched to an ignored ground truth
    oor = det_out_of_range[:, :, None, :]  # (U, A, 1, D)
    dtig = dtig | (~dtm & oor & det_valid[:, None, None, :])
    return dtm, dtig
