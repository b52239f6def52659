"""Panoptic quality (counterpart of ``metrics_tpu/detection/panoptic_quality.py``).

Inputs are ``(..., H, W, 2)`` label maps of (category id, instance id). The
heavy part, counting the pixels of every (predicted segment, target segment)
pair of every image, runs on the metric's device: one ``torch.unique`` with
``return_inverse`` over each side's 64-bit segment ids, then one over the
paired indices with their counts, for the whole batch at once. Only the
non-empty pairs come back to the host, where the matching walks each image's
small segment table in the JAX package's order: predicted segments, then
target segments, in ascending id. IoUs are float64 there, summed per image
and per update in float64 as the JAX package sums them, and added to the
float32 ``iou_sum`` state once per update.
"""

from __future__ import annotations

from typing import Any, Collection, Dict, Iterator, List, Tuple

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import acc_dtype

Tensor = torch.Tensor

__all__ = ["ModifiedPanopticQuality", "PanopticQuality"]


def _segment_ids(x: Tensor, stuffs: Tensor) -> Tensor:
    """``(N, H, W, 2)`` label maps to ``(N, H * W)`` int64 segment ids ``category << 32 | instance``; a stuff
    category is one segment, whatever its instance ids."""
    cat, inst = x[..., 0].long(), x[..., 1].long()
    inst = torch.where(torch.isin(cat, stuffs), torch.zeros_like(inst), inst)
    return ((cat << 32) | inst).reshape(x.shape[0], -1)


def _segment_pairs(preds: Tensor, target: Tensor, stuffs: Tensor) -> Tuple[np.ndarray, ...]:
    """Every non-empty (predicted segment, target segment) pair of every image of the batch, on the host.

    Returns ``(image, pred id, target id, pixels)`` per pair, sorted by image, then predicted id, then target
    id; the ids are the 64-bit segment ids.
    """
    p_ids, p_inv = torch.unique(_segment_ids(preds, stuffs), return_inverse=True)
    t_ids, t_inv = torch.unique(_segment_ids(target, stuffs), return_inverse=True)
    n_p, n_t = len(p_ids), len(t_ids)
    image = torch.arange(preds.shape[0], device=preds.device)[:, None]
    keys, pixels = torch.unique((image * n_p + p_inv) * n_t + t_inv, return_counts=True)
    keys, pixels = keys.cpu().numpy(), pixels.cpu().numpy()
    p_ids, t_ids = p_ids.cpu().numpy(), t_ids.cpu().numpy()
    return keys // (n_p * n_t), p_ids[(keys // n_t) % n_p], t_ids[keys % n_t], pixels


def _image_stats(
    pred_ids: np.ndarray, target_ids: np.ndarray, pixels: np.ndarray, things: set, stuffs: set, modified: bool
) -> Dict[int, List[Any]]:
    """Per-category [iou sum, tp, fp, fn] of one image from its non-empty segment pairs (sorted by predicted
    id, then target id)."""
    cats = things | stuffs
    stats: Dict[int, List[Any]] = {c: [0.0, 0, 0, 0] for c in cats}
    p_area: Dict[int, int] = {}
    t_area: Dict[int, int] = {}
    for p, t, n in zip(pred_ids.tolist(), target_ids.tolist(), pixels.tolist()):
        p_area[p] = p_area.get(p, 0) + n
        t_area[t] = t_area.get(t, 0) + n
    matched_p, matched_t = set(), set()
    for p, t, inter in zip(pred_ids.tolist(), target_ids.tolist(), pixels.tolist()):
        c = p >> 32
        if c not in cats or t >> 32 != c:
            continue
        iou = inter / (p_area[p] + t_area[t] - inter)
        # modified PQ: a stuff segment scores its IoU without the 0.5 matching rule
        if iou > 0.5 or (modified and c in stuffs and iou > 0):
            stats[c][0] += iou
            stats[c][1] += 1
            matched_p.add(p)
            matched_t.add(t)
    for p in p_area:
        if p >> 32 in cats and p not in matched_p:
            stats[p >> 32][2] += 1
    for t in t_area:
        if t >> 32 in cats and t not in matched_t:
            stats[t >> 32][3] += 1
    return stats


def _images(image: np.ndarray, *columns: np.ndarray) -> Iterator[Tuple[np.ndarray, ...]]:
    """The rows of each image in turn, from columns sorted by image."""
    bounds = np.flatnonzero(np.diff(image)) + 1
    for part in zip(*(np.split(col, bounds) for col in columns)):
        yield part


class PanopticQuality(Metric):
    __jit_ineligible__ = True  # host-side segment matching, as in the JAX package
    """Panoptic quality over every batch of ``(..., H, W, 2)`` (category id, instance id) maps seen so far.

    ``compute`` returns PQ averaged over the categories seen; with ``return_sq_and_rq`` also SQ and RQ; with
    ``return_per_class`` the values of each category (sorted by id), shaped ``(1, n)`` or ``(1, 3, n)``.

    >>> preds = torch.tensor([[[[6, 0], [0, 0]], [[6, 0], [6, 0]]]])
    >>> target = torch.tensor([[[[6, 0], [0, 1]], [[6, 0], [6, 0]]]])
    >>> pq = PanopticQuality(things={0, 6}, stuffs=set(), device="cpu")
    >>> pq.update(preds, target)
    >>> float(pq.compute()) > 0
    True
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _modified = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        return_sq_and_rq: bool = False,
        return_per_class: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        things, stuffs = set(int(t) for t in things), set(int(s) for s in stuffs)
        if things & stuffs:
            raise ValueError(
                f"Expected arguments `things` and `stuffs` to have distinct keys, but got {things & stuffs}")
        self.things = things
        self.stuffs = stuffs
        self.allow_unknown_preds_category = allow_unknown_preds_category
        self.return_sq_and_rq = return_sq_and_rq
        self.return_per_class = return_per_class
        cats = sorted(things | stuffs)
        self._cat_index = {c: i for i, c in enumerate(cats)}
        n = len(cats)
        self.add_state("iou_sum", torch.zeros(n, dtype=acc_dtype()), dist_reduce_fx="sum")
        self.add_state("true_positives", torch.zeros(n, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_positives", torch.zeros(n, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_negatives", torch.zeros(n, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Count each image's segment pairs on the metric's device, then match them on the host."""
        p = torch.as_tensor(preds).to(self.device)
        t = torch.as_tensor(target).to(self.device)
        if p.shape != t.shape or p.shape[-1] != 2:
            raise ValueError(
                "Expected argument `preds` and `target` to have shape (..., H, W, 2) but got"
                f" {tuple(p.shape)} and {tuple(t.shape)}"
            )
        if not self.allow_unknown_preds_category:
            unknown = set(torch.unique(p[..., 0]).tolist()) - self.things - self.stuffs
            if unknown:
                raise ValueError(f"Unknown categories found in `preds`: {unknown}")
        p = p.reshape(-1, *p.shape[-3:]) if p.ndim > 3 else p[None]
        t = t.reshape(-1, *t.shape[-3:]) if t.ndim > 3 else t[None]
        n = len(self._cat_index)
        iou_sum = np.zeros(n)
        counts = np.zeros((3, n), dtype=np.int64)
        stuffs = torch.tensor(sorted(self.stuffs), dtype=torch.int64, device=self.device)
        for pred_ids, target_ids, pixels in _images(*_segment_pairs(p, t, stuffs)):
            stats = _image_stats(pred_ids, target_ids, pixels, self.things, self.stuffs, self._modified)
            for c, (isum, tp, fp, fn) in stats.items():
                i = self._cat_index[c]
                iou_sum[i] += isum
                counts[:, i] += (tp, fp, fn)
        counts = torch.from_numpy(counts.astype(np.int32)).to(self.device)
        # the update's float64 sum meets the float32 state once, as in the JAX package
        self.iou_sum = self.iou_sum + torch.from_numpy(iou_sum.astype(np.float32)).to(self.device)
        self.true_positives = self.true_positives + counts[0]
        self.false_positives = self.false_positives + counts[1]
        self.false_negatives = self.false_negatives + counts[2]

    def compute(self) -> Tensor:
        """PQ = sum of IoUs / (TP + FP / 2 + FN / 2) per category, averaged over the categories seen."""
        tp = self.true_positives
        denom = tp + 0.5 * self.false_positives + 0.5 * self.false_negatives
        valid = denom > 0
        sq = torch.where(tp > 0, self.iou_sum / tp.clamp(min=1), 0.0)
        rq = torch.where(valid, tp / torch.where(valid, denom, 1.0), 0.0)
        pq = sq * rq
        n_valid = valid.sum().clamp(min=1)
        pq_avg = torch.where(valid, pq, 0.0).sum() / n_valid
        if self.return_per_class:
            return pq[None] if not self.return_sq_and_rq else torch.stack([pq, sq, rq])[None]
        if self.return_sq_and_rq:
            sq_avg = torch.where(valid, sq, 0.0).sum() / n_valid
            rq_avg = torch.where(valid, rq, 0.0).sum() / n_valid
            return torch.stack([pq_avg, sq_avg, rq_avg])
        return pq_avg


class ModifiedPanopticQuality(PanopticQuality):
    """Modified panoptic quality: a stuff segment scores its IoU without the 0.5 matching rule."""

    _modified = True
