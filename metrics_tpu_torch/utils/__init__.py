"""Utility layer: reductions, numeric and data helpers, checks, enums and exceptions.

The names are those of ``metrics_tpu.utils.__all__``, in its order.
"""

from metrics_tpu_torch.utils import enums, imports, plot  # noqa: F401 (the submodules, as in the JAX package)
from metrics_tpu_torch.utils.checks import _check_same_shape, check_forward_full_state_property
from metrics_tpu_torch.utils.compute import _safe_divide, _safe_xlogy, auc, interp
from metrics_tpu_torch.utils.data import (
    bincount,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    select_topk,
    to_categorical,
    to_onehot,
)
from metrics_tpu_torch.utils.distributed import class_reduce, reduce
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError, TPUMetricsUserWarning
from metrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_info, rank_zero_warn

__all__ = [
    "reduce",
    "class_reduce",
    "TPUMetricsUserError",
    "TPUMetricsUserWarning",
    "_check_same_shape",
    "_safe_divide",
    "_safe_xlogy",
    "auc",
    "bincount",
    "check_forward_full_state_property",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "enums",
    "imports",
    "interp",
    "plot",
    "rank_zero_debug",
    "rank_zero_info",
    "rank_zero_warn",
    "select_topk",
    "to_categorical",
    "to_onehot",
]
