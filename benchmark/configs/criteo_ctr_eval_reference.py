"""Plain reference of the Criteo evaluation: AUROC, AP and ECE of a pass, and the binned (T, 2, 2) counts.

Written from the metrics' definitions in plain PyTorch, in the precision asked for (float64 for the
reference, bfloat16 for the control), over the benchmark's own inputs. It imports nothing of the
program. Counts are integers in every precision; scores, rates, areas and sums take ``dtype``.

* Binned path, ``thresholds`` T: the grid ``i * fl32(1 / (T - 1))`` with the last point exactly 1
  (``jnp.linspace``'s float32 values); a score meets a threshold when ``score >= threshold``;
  ``counts[t] = [[tn, fp], [fn, tp]]``. ROC points are taken from the highest threshold down and
  AUROC is their trapezoid; AP is ``-sum((r[i+1] - r[i]) * p[i])`` over the thresholds in ascending
  order with (recall 0, precision 1) appended, a rate over an empty denominator being 0.
* Exact path: the same areas over every distinct score (scores descending, ties grouped), the ROC
  starting at (0, 0).
* ECE, ``n_bins`` B, l1: the score is the confidence and the click the accuracy; bin ``b`` holds
  ``edge[b] <= score < edge[b + 1]`` over the grid above with B + 1 points (a score of 1 in the last
  bin); the error is the sum over bins of ``|mean click - mean score| * share of rows``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def linspace_grid(num: int) -> np.ndarray:
    """``i * fl32(1 / (num - 1))`` for i < num - 1, then exactly 1, in float32."""
    step = np.float32(1) / np.float32(num - 1)
    return np.append(np.arange(num - 1, dtype=np.float32) * step, np.float32(1))


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(b == 0, torch.zeros_like(a), a / torch.where(b == 0, torch.ones_like(b), b))


def binned_counts(scores: torch.Tensor, clicks: torch.Tensor, num: int, dtype: torch.dtype) -> torch.Tensor:
    """(T, 2, 2) int64 ``[[tn, fp], [fn, tp]]`` with scores and thresholds compared in ``dtype``."""
    thr = torch.from_numpy(linspace_grid(num)).to(device=scores.device, dtype=dtype)
    s = scores.to(dtype).contiguous()
    met = torch.searchsorted(thr, s, right=True)  # thresholds <= score: score meets thresholds[:met]
    pos = clicks == 1
    hist_pos = torch.bincount(met[pos], minlength=num + 1)
    hist_neg = torch.bincount(met[~pos], minlength=num + 1)
    # tp[t] = positives meeting threshold t = positives with met > t
    tp = hist_pos.flip(0).cumsum(0).flip(0)[1:]
    fp = hist_neg.flip(0).cumsum(0).flip(0)[1:]
    fn = hist_pos.sum() - tp
    tn = hist_neg.sum() - fp
    return torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2)


def _trapezoid(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum((x[1:] - x[:-1]) * (y[1:] + y[:-1]) / 2)


def _ap(precision: torch.Tensor, recall: torch.Tensor) -> torch.Tensor:
    return -torch.sum((recall[1:] - recall[:-1]) * precision[:-1])


def binned_auroc_ap(counts: torch.Tensor, dtype: torch.dtype):
    tp, fp = counts[:, 1, 1].to(dtype), counts[:, 0, 1].to(dtype)
    fn, tn = counts[:, 1, 0].to(dtype), counts[:, 0, 0].to(dtype)
    tpr, fpr = _div(tp, tp + fn).flip(0), _div(fp, fp + tn).flip(0)
    precision = torch.cat([_div(tp, tp + fp), torch.ones(1, dtype=dtype, device=tp.device)])
    recall = torch.cat([_div(tp, tp + fn), torch.zeros(1, dtype=dtype, device=tp.device)])
    return _trapezoid(fpr, tpr), _ap(precision, recall)


def exact_auroc_ap(scores: torch.Tensor, clicks: torch.Tensor, dtype: torch.dtype):
    s = scores.to(dtype)
    s_sorted, order = torch.sort(s, descending=True, stable=True)
    y = (clicks[order] == 1).to(torch.int64)
    last = torch.nonzero(s_sorted[1:] != s_sorted[:-1])[:, 0]
    last = torch.cat([last, torch.tensor([s.numel() - 1], device=s.device)])
    tps = y.cumsum(0)[last]
    fps = 1 + last - tps
    tps_f, fps_f = tps.to(dtype), fps.to(dtype)
    zero = torch.zeros(1, dtype=dtype, device=s.device)
    tpr = torch.cat([zero, tps_f / tps_f[-1]])
    fpr = torch.cat([zero, fps_f / fps_f[-1]])
    precision = torch.cat([(tps_f / (tps_f + fps_f)).flip(0), torch.ones(1, dtype=dtype, device=s.device)])
    recall = torch.cat([(tps_f / tps_f[-1]).flip(0), zero])
    return _trapezoid(fpr, tpr), _ap(precision, recall)


def calibration_error(scores: torch.Tensor, clicks: torch.Tensor, n_bins: int, dtype: torch.dtype) -> torch.Tensor:
    edges = torch.from_numpy(linspace_grid(n_bins + 1)).to(device=scores.device, dtype=dtype)
    conf = scores.to(dtype).contiguous()
    idx = (torch.searchsorted(edges, conf, right=True) - 1).clamp(0, n_bins - 1)
    count = torch.bincount(idx, minlength=n_bins).to(dtype)
    conf_sum = torch.zeros(n_bins, dtype=dtype, device=conf.device).index_add_(0, idx, conf)
    acc_sum = torch.zeros(n_bins, dtype=dtype, device=conf.device).index_add_(0, idx, (clicks == 1).to(dtype))
    return torch.sum((_div(acc_sum, count) - _div(conf_sum, count)).abs() * count / count.sum())


def evaluate(scores: torch.Tensor, clicks: torch.Tensor, thresholds: Optional[int], n_bins: int,
             dtype: torch.dtype = torch.float64) -> Dict[str, object]:
    """``{"values": {"auroc", "ap", "ece"}, "counts": (T, 2, 2) or None}`` of one pass."""
    counts = None
    if thresholds is None:
        auroc, ap = exact_auroc_ap(scores, clicks, dtype)
    else:
        counts = binned_counts(scores, clicks, thresholds, dtype)
        auroc, ap = binned_auroc_ap(counts, dtype)
    ece = calibration_error(scores, clicks, n_bins, dtype)
    return {"values": {"auroc": float(auroc), "ap": float(ap), "ece": float(ece)}, "counts": counts}
