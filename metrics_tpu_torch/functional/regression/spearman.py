"""Spearman rank correlation (counterpart of ``metrics_tpu/functional/regression/spearman.py``).

Ranks come from a stable sort, and tied values share their mean rank through
one segment sum over the runs of equal sorted values.
"""

from __future__ import annotations

from typing import Tuple

import torch

from metrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import bincount_fixed

Tensor = torch.Tensor


def _rank_data(data: Tensor) -> Tensor:
    """Ranks 1..n of 1-d data; tied values get their mean rank."""
    n = data.shape[0]
    order = torch.argsort(data, stable=True)
    rank = torch.empty_like(data)
    rank[order] = torch.arange(1, n + 1, dtype=data.dtype, device=data.device)
    sorted_data = data[order]
    is_new = torch.cat([torch.ones(1, dtype=torch.int64, device=data.device),
                        (sorted_data[1:] != sorted_data[:-1]).long()])
    group_id_sorted = torch.cumsum(is_new, 0) - 1
    group_id = torch.empty_like(group_id_sorted)
    group_id[order] = group_id_sorted
    group_sum = torch.zeros(n, dtype=data.dtype, device=data.device).index_add_(0, group_id, rank)
    # every group id lies in [0, n): a fixed-length count, which never reads the data back to size its output
    group_cnt = bincount_fixed(group_id, n).to(data.dtype)
    return group_sum[group_id] / group_cnt[group_id]


def _spearman_corrcoef_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, Tensor]:
    """Validate a batch, which is kept whole for the compute."""
    if not (preds.is_floating_point() and target.is_floating_point()):
        raise TypeError(
            "Expected `preds` and `target` both to be floating point tensors, but got"
            f" {preds.dtype} and {target.dtype}"
        )
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    return preds, target


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1e-6) -> Tensor:
    """Pearson's correlation of the ranks."""
    if preds.ndim == 1:
        preds = _rank_data(preds)
        target = _rank_data(target)
    else:
        preds = torch.stack([_rank_data(preds[:, i]) for i in range(preds.shape[1])], dim=-1)
        target = torch.stack([_rank_data(target[:, i]) for i in range(target.shape[1])], dim=-1)
    preds_diff = preds - preds.mean(0)
    target_diff = target - target.mean(0)
    cov = (preds_diff * target_diff).mean(0)
    preds_std = torch.sqrt((preds_diff * preds_diff).mean(0))
    target_std = torch.sqrt((target_diff * target_diff).mean(0))
    corrcoef = cov / (preds_std * target_std + eps)
    return torch.squeeze(torch.clamp(corrcoef, -1.0, 1.0))


def _canonical_float(x: Tensor) -> Tensor:
    """float64 in the default float type, as the JAX package's inputs arrive (float32 unless the caller chose
    float64); float16 and bfloat16 stay, so that the ranks are taken in the input's own type."""
    return x.to(torch.get_default_dtype()) if x.dtype == torch.float64 else x


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Spearman rank correlation coefficient.

    >>> target = torch.tensor([3., -0.5, 2., 7.])
    >>> preds = torch.tensor([2.5, 0.0, 2., 8.])
    >>> spearman_corrcoef(preds, target)
    tensor(1.0000)
    """
    preds, target = _canonical_float(preds), _canonical_float(target)
    d = preds.shape[1] if preds.ndim == 2 else 1
    preds, target = _spearman_corrcoef_update(preds, target, num_outputs=d)
    return _spearman_corrcoef_compute(preds, target)
