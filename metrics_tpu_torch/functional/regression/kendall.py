"""Kendall rank correlation (counterpart of ``metrics_tpu/functional/regression/kendall.py``).

The pairs are counted by blocked comparison, as in the JAX package: the rows
``[s, e)`` are compared with the columns ``[s, n)`` only, so each unordered
pair is seen once (in the block's own square, above the diagonal). The counts
are exact int64 sums on the device, where the JAX package sums float32 block
sums, exact only below 2^24 pairs; from the counts on, tau takes the JAX
package's float operations in the default float type. The block's rows are
chosen from the free device memory (:func:`_pair_block_rows`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from metrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor

# the CPU's block: the JAX package's rows per block
_CPU_PAIR_BLOCK = 2048
# bytes a compared pair takes while its block is live: two bool comparisons and an int8 sign per input, their
# product, the tie flags, with room to spare
_BYTES_PER_PAIR = 16


def _pair_block_rows(n: int, device: torch.device) -> int:
    """Rows per block: on a CUDA device, as many as keep a block within a quarter of the free memory (at
    ``_BYTES_PER_PAIR`` a compared pair); on the CPU, 2048."""
    if device.type != "cuda":
        return _CPU_PAIR_BLOCK
    free, _ = torch.cuda.mem_get_info(device)
    return int(max(1, min(n, free // 4 // (_BYTES_PER_PAIR * max(n, 1)))))


def _sign(x: Tensor, rows: slice, start: int) -> Tensor:
    """``sign(x[i] - x[j])`` for the block's rows ``i`` and the columns ``j >= start``, as int8."""
    a, b = x[rows, None], x[None, start:]
    return (a > b).to(torch.int8) - (a < b).to(torch.int8)


def _upper_sum(flags: Tensor, width: int) -> Tensor:
    """Sum over a block's pairs above the diagonal: the first ``width`` columns are the block's own square."""
    return torch.triu(flags[:, :width], diagonal=1).sum() + flags[:, width:].sum()


def _pair_counts(preds: Tensor, target: Tensor, variant: str) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Exact int64 counts over the pairs: concordant minus discordant, untied (tau-a only), tied in ``preds``,
    tied in ``target``."""
    n = preds.shape[0]
    zero = torch.zeros((), dtype=torch.int64, device=preds.device)
    con_min_dis, con_plus_dis, tx, ty = zero, zero, zero, zero
    block = _pair_block_rows(n, preds.device)
    for start in range(0, n, block):
        rows = slice(start, min(start + block, n))
        width = rows.stop - start
        sx, sy = _sign(preds, rows, start), _sign(target, rows, start)
        product = sx * sy
        con_min_dis = con_min_dis + _upper_sum(product, width)
        if variant == "a":
            con_plus_dis = con_plus_dis + _upper_sum(product != 0, width)
        tx = tx + _upper_sum(sx == 0, width)
        ty = ty + _upper_sum(sy == 0, width)
    return con_min_dis, con_plus_dis, tx, ty


def _kendall_tau_1d(preds: Tensor, target: Tensor, variant: str) -> Tensor:
    """Tau of one output column."""
    n = preds.shape[0]
    con_min_dis, con_plus_dis, tx, ty = (c.to(torch.get_default_dtype()) for c in _pair_counts(preds, target,
                                                                                                variant))
    if variant == "a":
        return con_min_dis / con_plus_dis
    if variant == "b":
        n0 = n * (n - 1) / 2.0
        return con_min_dis / torch.sqrt((n0 - tx) * (n0 - ty))
    m = max(min(torch.unique(preds).numel(), torch.unique(target).numel()), 2)
    return 2 * con_min_dis / (n**2 * (m - 1) / m)


def _kendall_corrcoef_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, Tensor]:
    """Validate a batch, which is kept whole for the compute."""
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    return preds, target


def _kendall_corrcoef_compute(preds: Tensor, target: Tensor, variant: str = "b") -> Tensor:
    """Tau per output, squeezed."""
    if preds.ndim == 1:
        return _kendall_tau_1d(preds, target, variant)
    return torch.squeeze(torch.stack([_kendall_tau_1d(preds[:, i], target[:, i], variant)
                                      for i in range(preds.shape[1])]))


def _kendall_p_value(tau: Tensor, n: int, alternative: str) -> Tensor:
    """The p-value of tau under the normal approximation without a correction for ties, on the host in float64
    as in the JAX package (``sf(z) = erfc(z / sqrt 2) / 2``), returned as float32 on tau's device."""
    z = 3 * tau.detach().cpu().double().numpy() * math.sqrt(n * (n - 1)) / math.sqrt(2 * (2 * n + 5))
    sf = np.vectorize(lambda v: 0.5 * math.erfc(v / math.sqrt(2.0)))
    if alternative == "two-sided":
        p = 2 * sf(np.abs(z))
    elif alternative == "greater":
        p = sf(z)
    else:
        p = 1.0 - sf(z)
    return torch.as_tensor(np.asarray(p), dtype=torch.float32, device=tau.device)


def kendall_rank_corrcoef(
    preds: Tensor,
    target: Tensor,
    variant: str = "b",
    t_test: bool = False,
    alternative: Optional[str] = "two-sided",
):
    """Kendall's tau of variant ``"a"``, ``"b"`` or ``"c"``; with ``t_test``, also its p-value.

    >>> kendall_rank_corrcoef(torch.tensor([2.5, 1.0, 4.0, 7.0]), torch.tensor([3.0, -0.5, 2.0, 1.0]))
    tensor(0.)
    """
    if variant not in ("a", "b", "c"):
        raise ValueError(f"Argument `variant` is expected to be one of 'a', 'b', 'c' but got {variant!r}")
    if t_test and alternative not in ("two-sided", "less", "greater"):
        raise ValueError(
            f"Argument `alternative` is expected to be one of 'two-sided', 'less', 'greater' but got {alternative!r}"
        )
    d = preds.shape[1] if preds.ndim == 2 else 1
    preds, target = _kendall_corrcoef_update(preds.to(torch.float32), target.to(torch.float32), num_outputs=d)
    tau = _kendall_corrcoef_compute(preds, target, variant)
    if not t_test:
        return tau
    return tau, _kendall_p_value(tau, preds.shape[0], alternative)
