"""Stat-score to score reductions (counterpart of ``metrics_tpu/functional/classification/_reduce.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from metrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide


def _micro_sum(x: torch.Tensor, multidim_average: str) -> torch.Tensor:
    if x.ndim == 0:  # the micro path's stats are already scalars
        return x
    return x.sum(dim=0 if multidim_average == "global" else 1)


def _accuracy_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
) -> torch.Tensor:
    """Reduce tp/fp/tn/fn into the accuracy score."""
    if average == "binary":
        return _safe_divide(tp + tn, tp + tn + fp + fn)
    if average == "micro":
        tp, fn = _micro_sum(tp, multidim_average), _micro_sum(fn, multidim_average)
        if multilabel:
            fp, tn = _micro_sum(fp, multidim_average), _micro_sum(tn, multidim_average)
            return _safe_divide(tp + tn, tp + tn + fp + fn)
        return _safe_divide(tp, tp + fn)
    score = _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)
