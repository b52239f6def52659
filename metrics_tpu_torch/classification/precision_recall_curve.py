"""Precision-recall curve metrics (counterpart of ``metrics_tpu/classification/precision_recall_curve.py``).

``thresholds=None`` keeps the samples in "cat" list states and computes the
exact curve; an int, list or tensor keeps one int64 ``confmat`` sum state of
shape (T, ..., 2, 2), filled by the binned-counts kernel.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _adjust_threshold_arg,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def _curve_family_plot(self, curve=None, score=None, ax=None, *, swap_xy, label_names, auc_direction):
    """Draw the curve (``compute()`` when ``curve`` is None); with ``score=True`` a single computed curve is
    annotated with the trapezoidal area under it; needs matplotlib."""
    from metrics_tpu_torch.utils.compute import _auc_compute_without_check
    from metrics_tpu_torch.utils.plot import plot_curve

    computed = curve if curve is not None else self.compute()
    if swap_xy:  # recall along x, precision along y
        computed = (computed[1], computed[0]) + tuple(computed[2:])
    auc_score = None
    if curve is None and score is True:
        x, y = computed[0], computed[1]
        if not isinstance(x, (list, tuple)) and x.ndim == 1:
            auc_score = _auc_compute_without_check(x, y, auc_direction)
    return plot_curve(computed, score=auc_score, ax=ax, label_names=label_names, name=self.__class__.__name__)


def _precision_recall_curve_plot(self, curve=None, score=None, ax=None):
    """Draw the precision-recall curve; see :func:`_curve_family_plot`."""
    return _curve_family_plot(
        self, curve, score, ax, swap_xy=True, label_names=("Recall", "Precision"), auc_direction=-1.0
    )


class _CurveStates(Metric):
    """The two state layouts of the curve metrics."""

    def _create_curve_state(self, thresholds: Thresholds, confmat_shape: Tuple[int, ...]) -> None:
        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        if self.thresholds is None:
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")
        else:
            shape = (len(self.thresholds),) + confmat_shape
            self.add_state("confmat", torch.zeros(shape, dtype=torch.int64), dist_reduce_fx="sum")

    def _add_to_state(self, state: Union[Tensor, Tuple[Tensor, Tensor]]) -> None:
        if isinstance(state, tuple):
            self.preds.append(state[0])
            self.target.append(state[1])
        else:
            self.confmat = self.confmat + state

    def _final_state(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        if self.thresholds is None:
            return dim_zero_cat(self.preds), dim_zero_cat(self.target)
        return self.confmat


class BinaryPrecisionRecallCurve(_CurveStates):
    """Precision-recall curve for binary tasks.

    >>> metric = BinaryPrecisionRecallCurve(thresholds=5, device="cpu")
    >>> metric.update(torch.tensor([0.0, 0.5, 0.7, 0.8]), torch.tensor([0, 1, 1, 0]))
    >>> precision, recall, thresholds = metric.compute()
    >>> recall
    tensor([1., 1., 1., 0., 0., 0.])
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_curve_state(thresholds, (2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        preds, target, _ = _binary_precision_recall_curve_format(preds, target, self.thresholds, self.ignore_index)
        self._add_to_state(_binary_precision_recall_curve_update(preds, target, self.thresholds))

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        """Precision, recall and thresholds."""
        return _binary_precision_recall_curve_compute(self._final_state(), self.thresholds)

    plot = _precision_recall_curve_plot


class MulticlassPrecisionRecallCurve(_CurveStates):
    """Precision-recall curve for multiclass tasks (one-vs-rest per class)."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        thresholds: Thresholds = None,
        average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        self.num_classes = num_classes
        self.average = average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_curve_state(thresholds, (2, 2) if average == "micro" else (num_classes, 2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, _ = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, self.thresholds, self.ignore_index, self.average
        )
        self._add_to_state(
            _multiclass_precision_recall_curve_update(preds, target, self.num_classes, self.thresholds, self.average)
        )

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        """Per-class precision, recall and thresholds (or their average)."""
        return _multiclass_precision_recall_curve_compute(
            self._final_state(), self.num_classes, self.thresholds, self.average
        )

    plot = _precision_recall_curve_plot


class MultilabelPrecisionRecallCurve(_CurveStates):
    """Precision-recall curve for multilabel tasks (one curve per label).

    On the binned path every update is one launch of the binned-counts kernel
    over the (N, L) scores, with targets above 1 counted as positives.

    >>> metric = MultilabelPrecisionRecallCurve(num_labels=2, thresholds=3, device="cpu")
    >>> metric.update(torch.tensor([[0.75, 0.05], [0.45, 0.75], [0.05, 0.55]]), torch.tensor([[1, 0], [0, 1], [0, 1]]))
    >>> precision, recall, thresholds = metric.compute()
    >>> precision
    tensor([[0.3333, 1.0000, 0.0000, 1.0000],
            [0.6667, 1.0000, 0.0000, 1.0000]])
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_curve_state(thresholds, (num_labels, 2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        if self.validate_args:
            _multilabel_precision_recall_curve_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target, _ = _multilabel_precision_recall_curve_format(
            preds, target, self.num_labels, self.thresholds, self.ignore_index
        )
        self._add_to_state(_multilabel_precision_recall_curve_update(preds, target, self.num_labels, self.thresholds))

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        """Per-label precision, recall and thresholds."""
        return _multilabel_precision_recall_curve_compute(
            self._final_state(), self.num_labels, self.thresholds, self.ignore_index
        )

    plot = _precision_recall_curve_plot


class PrecisionRecallCurve(_ClassificationTaskWrapper):
    """Task-dispatching precision-recall curve: returns the binary, multiclass or multilabel metric."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryPrecisionRecallCurve(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassPrecisionRecallCurve(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
            return MultilabelPrecisionRecallCurve(num_labels, **kwargs)
        raise ValueError(f"Not handled value: {task}")
