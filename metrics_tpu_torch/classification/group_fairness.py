"""Group-fairness metrics (counterpart of ``metrics_tpu/classification/group_fairness.py``).

The per-group tp/fp/tn/fn are int64 sum states, counted exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from metrics_tpu_torch.functional.classification.group_fairness import (
    _binary_groups_stat_scores_tensor,
    _compute_binary_demographic_parity,
    _compute_binary_equal_opportunity,
)
from metrics_tpu_torch.functional.classification.stat_scores import _binary_stat_scores_arg_validation
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

__all__ = ["BinaryFairness", "BinaryGroupStatRates"]


def _check_num_groups(num_groups: Any) -> None:
    if not isinstance(num_groups, int) or num_groups < 2:
        raise ValueError(f"Expected argument `num_groups` to be an int larger than 1, but got {num_groups}")


class _AbstractGroupStatScores(Metric):
    """Per-group tp/fp/tn/fn states."""

    def _create_states(self, num_groups: int) -> None:
        for name in ("tp", "fp", "tn", "fn"):
            self.add_state(name, torch.zeros(num_groups, dtype=torch.int64), dist_reduce_fx="sum")

    def _update_states(self, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> None:
        self.tp = self.tp + tp
        self.fp = self.fp + fp
        self.tn = self.tn + tn
        self.fn = self.fn + fn


class BinaryGroupStatRates(_AbstractGroupStatScores):
    """True/false positive and negative rates by group.

    >>> preds = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
    >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> groups = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> metric = BinaryGroupStatRates(num_groups=2, device="cpu")
    >>> metric.update(preds, target, groups)
    >>> metric.compute()
    {'group_0': tensor([0., 0., 1., 0.]), 'group_1': tensor([1., 0., 0., 0.])}
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        num_groups: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _check_num_groups(num_groups)
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_states(num_groups)

    def update(self, preds: Tensor, target: Tensor, groups: Tensor) -> None:
        """Update state with predictions, targets and group identifiers."""
        tp, fp, tn, fn = _binary_groups_stat_scores_tensor(
            preds, target, groups, self.num_groups, self.threshold, self.ignore_index, self.validate_args
        )
        self._update_states(tp, fp, tn, fn)

    def compute(self) -> Dict[str, Tensor]:
        """Per-group rates (float32; an empty group divides 0 by 0, as in the JAX package)."""
        stacked = torch.stack([self.tp, self.fp, self.tn, self.fn]).to(torch.float32)
        rates = stacked / stacked.sum(dim=0, keepdim=True)
        return {f"group_{g}": rates[:, g] for g in range(self.num_groups)}


class BinaryFairness(_AbstractGroupStatScores):
    """Demographic parity and equal opportunity ratios.

    >>> preds = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
    >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> groups = torch.tensor([0, 1, 0, 1, 0, 1])
    >>> metric = BinaryFairness(num_groups=2, device="cpu")
    >>> metric.update(preds, target, groups)
    >>> metric.compute()
    {'DP_0_1': tensor(0.), 'EO_0_1': tensor(0.)}
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        num_groups: int,
        task: str = "all",
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if task not in ("demographic_parity", "equal_opportunity", "all"):
            raise ValueError(
                f"Expected argument `task` to either be ``demographic_parity``,"
                f"``equal_opportunity`` or ``all`` but got {task}."
            )
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _check_num_groups(num_groups)
        self.num_groups = num_groups
        self.task = task
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_states(num_groups)

    def update(self, preds: Tensor, target: Optional[Tensor], groups: Tensor) -> None:
        """Update state with predictions, targets and group identifiers."""
        if self.task == "demographic_parity":
            if target is not None:
                rank_zero_warn("The task demographic_parity does not require a target.", UserWarning)
            target = torch.zeros(preds.shape, dtype=torch.int64, device=preds.device)
        tp, fp, tn, fn = _binary_groups_stat_scores_tensor(
            preds, target, groups, self.num_groups, self.threshold, self.ignore_index, self.validate_args
        )
        self._update_states(tp, fp, tn, fn)

    def compute(self) -> Dict[str, Tensor]:
        """The fairness ratios of ``task``."""
        out: Dict[str, Tensor] = {}
        if self.task in ("demographic_parity", "all"):
            out.update(_compute_binary_demographic_parity(self.tp, self.fp, self.tn, self.fn))
        if self.task in ("equal_opportunity", "all"):
            out.update(_compute_binary_equal_opportunity(self.tp, self.fp, self.tn, self.fn))
        return out
