"""Stat-score to score reductions (counterpart of ``metrics_tpu/functional/classification/_reduce.py``).

Each takes the tp/fp/tn/fn counters (int64) and returns float32 scores, or
``torch.get_default_dtype()`` ones where an int64 counter is divided (see
``utils/compute.py::_safe_divide``), as the JAX package's do under x32 and x64.
"""

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


def _precision_recall_reduce(
    stat: str,
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
    zero_division: float = 0,
) -> torch.Tensor:
    """Reduce tp/fp/tn/fn into precision (``stat="precision"``) or recall."""
    different_stat = fp if stat == "precision" else fn
    if average == "binary":
        return _safe_divide(tp, tp + different_stat, zero_division)
    if average == "micro":
        tp = _micro_sum(tp, multidim_average)
        different_stat = _micro_sum(different_stat, multidim_average)
        return _safe_divide(tp, tp + different_stat, zero_division)
    score = _safe_divide(tp, tp + different_stat, zero_division)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k=top_k)


def _fbeta_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    beta: float,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    zero_division: float = 0,
) -> torch.Tensor:
    """Reduce tp/fp/tn/fn into the F-beta score."""
    beta2 = beta**2
    if average == "binary":
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    if average == "micro":
        tp, fn, fp = (_micro_sum(x, multidim_average) for x in (tp, fn, fp))
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    score = _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)


def _specificity_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
) -> torch.Tensor:
    """Reduce tp/fp/tn/fn into specificity."""
    if average == "binary":
        return _safe_divide(tn, tn + fp)
    if average == "micro":
        tn, fp = _micro_sum(tn, multidim_average), _micro_sum(fp, multidim_average)
        return _safe_divide(tn, tn + fp)
    score = _safe_divide(tn, tn + fp)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)


def _negative_predictive_value_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
    zero_division: float = 0,
) -> torch.Tensor:
    """Reduce tp/fp/tn/fn into the negative predictive value."""
    if average == "binary":
        return _safe_divide(tn, tn + fn, zero_division)
    if average == "micro":
        tn, fn_ = _micro_sum(tn, multidim_average), _micro_sum(fn, multidim_average)
        return _safe_divide(tn, tn + fn_, zero_division)
    score = _safe_divide(tn, tn + fn, zero_division)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k=top_k)


def _hamming_distance_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
) -> torch.Tensor:
    """Reduce tp/fp/tn/fn into the Hamming distance."""
    if average == "binary":
        return 1 - _safe_divide(tp + tn, tp + fp + tn + fn)
    if average == "micro":
        tp, fn_s = _micro_sum(tp, multidim_average), _micro_sum(fn, multidim_average)
        if multilabel:
            fp_s, tn_s = _micro_sum(fp, multidim_average), _micro_sum(tn, multidim_average)
            return 1 - _safe_divide(tp + tn_s, tp + tn_s + fp_s + fn_s)
        return 1 - _safe_divide(tp, tp + fn_s)
    score = 1 - _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else 1 - _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)
