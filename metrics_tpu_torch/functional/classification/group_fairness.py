"""Group fairness (counterpart of ``metrics_tpu/functional/classification/group_fairness.py``).

Each group's tp/fp/tn/fn are counted exactly, in one ``bincount`` over
``4 * group + outcome``, as int64. The JAX package counts them through a
float32 weighted bincount, exact only up to 2^24 per group; below that the two
agree exactly. Rates and ratios come in float32, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
)
from metrics_tpu_torch.utils.compute import _safe_divide
from metrics_tpu_torch.utils.data import bincount

Tensor = torch.Tensor

__all__ = ["binary_fairness", "binary_groups_stat_rates", "demographic_parity", "equal_opportunity"]


def _groups_validation(groups: Tensor, num_groups: int) -> None:
    """Group ids must be integers below ``num_groups`` (one host read of their largest)."""
    if groups.is_floating_point() or groups.is_complex() or groups.dtype == torch.bool:
        raise ValueError(f"Expected dtype of argument groups to be int, but got {groups.dtype}.")
    largest = int(groups.max())
    if largest > num_groups - 1:
        raise ValueError(
            f"The largest number in the groups tensor is {largest}, which is larger"
            f" than the specified number of groups {num_groups}."
        )


def _groups_format(groups: Tensor) -> Tensor:
    """Group ids as (N, -1)."""
    return groups.reshape(groups.shape[0], -1)


def _binary_groups_stat_scores_tensor(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-group (tp, fp, tn, fn), each int64 of shape (num_groups,); ignored targets count nowhere."""
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
        _groups_validation(groups, num_groups)
    preds, target = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    groups = _groups_format(groups).reshape(-1).long()
    p, t = preds.reshape(-1), target.reshape(-1)
    if groups.numel() != p.numel():
        raise ValueError(
            f"Incompatible shapes: {groups.numel()} group ids for {p.numel()} predictions; give one group id per"
            " prediction"
        )
    hit = t == p
    # outcome 0 tp, 1 fp, 2 tn, 3 fn; a target outside {0, 1} or a negative group id goes to the dead bin
    # past every group, as the JAX package drops both
    outcome = torch.where(t == 1, torch.where(hit, 0, 3), torch.where(hit, 2, 1))
    bins = torch.where(((t == 0) | (t == 1)) & (groups >= 0), 4 * groups + outcome, 4 * num_groups)
    counts = bincount(bins, 4 * num_groups).reshape(num_groups, 4)
    return counts[:, 0], counts[:, 1], counts[:, 2], counts[:, 3]


def _rates(num: Tensor, denom: Tensor) -> Tensor:
    """``num / denom`` of counts, 0 where ``denom`` is 0, rounded once to float32."""
    return _safe_divide(num, denom).to(torch.float32)


def binary_groups_stat_rates(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Each group's tp, fp, tn and fn rates; a group with no samples gets zeros.

    >>> preds = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
    >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> groups = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> binary_groups_stat_rates(preds, target, groups, 2)
    {'group_0': tensor([0., 0., 1., 0.]), 'group_1': tensor([1., 0., 0., 0.])}
    """
    tp, fp, tn, fn = _binary_groups_stat_scores_tensor(
        preds, target, groups, num_groups, threshold, ignore_index, validate_args
    )
    stacked = torch.stack([tp, fp, tn, fn])
    rates = _rates(stacked, stacked.sum(dim=0, keepdim=True))
    return {f"group_{g}": rates[:, g] for g in range(num_groups)}


def _compute_binary_demographic_parity(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    """The lowest group positive rate over the highest, keyed by the two groups."""
    pos_rates = _rates(tp + fp, tp + fp + tn + fn)
    min_id = int(torch.argmin(pos_rates))
    max_id = int(torch.argmax(pos_rates))
    return {f"DP_{min_id}_{max_id}": _safe_divide(pos_rates[min_id], pos_rates[max_id])}


def _compute_binary_equal_opportunity(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    """The lowest group true positive rate over the highest, keyed by the two groups."""
    tpr = _rates(tp, tp + fn)
    min_id = int(torch.argmin(tpr))
    max_id = int(torch.argmax(tpr))
    return {f"EO_{min_id}_{max_id}": _safe_divide(tpr[min_id], tpr[max_id])}


def demographic_parity(
    preds: Tensor,
    groups: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Demographic parity between all groups (``max(groups) + 1`` of them).

    >>> preds = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
    >>> groups = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> demographic_parity(preds, groups)
    {'DP_0_1': tensor(0.)}
    """
    num_groups = int(groups.max()) + 1
    target = torch.zeros(preds.shape, dtype=torch.int64, device=preds.device)
    tp, fp, tn, fn = _binary_groups_stat_scores_tensor(
        preds, target, groups, num_groups, threshold, ignore_index, validate_args
    )
    return _compute_binary_demographic_parity(tp, fp, tn, fn)


def equal_opportunity(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Equal opportunity between all groups (``max(groups) + 1`` of them)."""
    num_groups = int(groups.max()) + 1
    tp, fp, tn, fn = _binary_groups_stat_scores_tensor(
        preds, target, groups, num_groups, threshold, ignore_index, validate_args
    )
    return _compute_binary_equal_opportunity(tp, fp, tn, fn)


def binary_fairness(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    task: str = "all",
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Demographic parity, equal opportunity, or both (``task="all"``)."""
    if task not in ("demographic_parity", "equal_opportunity", "all"):
        raise ValueError(
            f"Expected argument `task` to either be ``demographic_parity``,"
            f"``equal_opportunity`` or ``all`` but got {task}."
        )
    num_groups = int(groups.max()) + 1
    if task == "demographic_parity":
        target = torch.zeros(preds.shape, dtype=torch.int64, device=preds.device)
    tp, fp, tn, fn = _binary_groups_stat_scores_tensor(
        preds, target, groups, num_groups, threshold, ignore_index, validate_args
    )
    out: Dict[str, Tensor] = {}
    if task in ("demographic_parity", "all"):
        out.update(_compute_binary_demographic_parity(tp, fp, tn, fn))
    if task in ("equal_opportunity", "all"):
        out.update(_compute_binary_equal_opportunity(tp, fp, tn, fn))
    return out
