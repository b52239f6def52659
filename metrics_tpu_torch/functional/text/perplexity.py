"""Perplexity (counterpart of ``metrics_tpu/functional/text/perplexity.py``): the exponent of the mean negative
log-probability of the target tokens, ``preds`` always read as logits.

The picked log-probability is ``(x[t] - max x) - log Σ exp(x - max x)``, the
JAX package's ``log_softmax`` read at the target only, so no second tensor of
the logits' size is kept: one temporary of ``exp(x - max x)`` is summed away.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.compute import count_dtype


def _perplexity_update(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Σ -log p(target) (float32) and the count of scored tokens (``count_dtype()``), ``ignore_index`` masked."""
    if preds.ndim != 3:
        raise ValueError(f"Input tensor `preds` is expected to have 3 dimensions, [batch_size, seq_len, vocab_size],"
                         f" but got {preds.ndim}.")
    if target.ndim != 2:
        raise ValueError(f"Input tensor `target` is expected to have 2 dimensions, [batch_size, seq_len],"
                         f" but got {target.ndim}.")
    if preds.shape[:2] != target.shape:
        raise ValueError(
            f"Input tensors `preds` and `target` are expected to have equaling first two dimensions,"
            f" [batch_size, seq_len], but got {tuple(preds.shape[:2])} and {tuple(target.shape)}."
        )
    preds = preds.reshape(-1, preds.shape[-1]).to(torch.float32)
    target = target.reshape(-1)
    if ignore_index is not None:
        valid = target != ignore_index
        safe_target = torch.where(valid, target, torch.zeros_like(target))
    else:
        valid = torch.ones_like(target, dtype=torch.bool)
        safe_target = target
    peak = preds.amax(dim=-1, keepdim=True)
    log_norm = torch.sub(preds, peak).exp_().sum(dim=-1, keepdim=True).log_()
    picked = (preds.gather(1, safe_target.long()[:, None]) - peak - log_norm)[:, 0]
    total_log_probs = -torch.where(valid, picked, torch.zeros_like(picked)).sum()
    count = valid.sum(dtype=count_dtype())
    return total_log_probs, count


def _perplexity_compute(total: Tensor, count: Tensor) -> Tensor:
    """``exp(total / count)``."""
    return torch.exp(total / count)


def perplexity(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    """Perplexity of ``target`` (batch, seq) under the logits ``preds`` (batch, seq, vocab), on their device.

    >>> import numpy as np
    >>> rng = np.random.RandomState(22)
    >>> preds = torch.from_numpy(rng.rand(2, 8, 5).astype(np.float32) * 10)
    >>> target = torch.from_numpy(rng.randint(5, size=(2, 8)))
    >>> float(perplexity(preds, target)) > 1
    True
    """
    total, count = _perplexity_update(preds, target, ignore_index)
    return _perplexity_compute(total, count)
