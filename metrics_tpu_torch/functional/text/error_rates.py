"""Word and character error rates and the edit distance (counterpart of
``metrics_tpu/functional/text/error_rates.py``).

The dynamic programs run on the host (``helper.py``) and give exact integer
counts; each function rounds them once to float32, as the JAX package does,
and returns a float32 tensor on ``device``. The inputs are strings, so the
device is the caller's to name: ``"cuda"`` when omitted, and without a CUDA
device the caller must pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _edit_distance, _edit_distance_counts, _tokenize_words
from metrics_tpu_torch.metric import resolve_device

_Device = Optional[Union[str, torch.device]]


def _as_list(x: Union[str, List[str]]) -> List[str]:
    return [x] if isinstance(x, str) else list(x)


def _f32(values, device: torch.device) -> Tensor:
    """Host numbers rounded once to float32, in one copy to ``device``."""
    return torch.from_numpy(np.asarray(values, dtype=np.float32)).to(device)


def _wer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[int, int]:
    """Σ word edit distance and Σ target words."""
    preds, target = _as_list(preds), _as_list(target)
    errors = 0
    total = 0
    for p, t in zip(preds, target):
        pt, tt = _tokenize_words(p), _tokenize_words(t)
        errors += _edit_distance(pt, tt)
        total += len(tt)
    return errors, total


def word_error_rate(preds: Union[str, List[str]], target: Union[str, List[str]], *, device: _Device = None) -> Tensor:
    """Word error rate.

    >>> preds = ["this is the prediction", "there is an other sample"]
    >>> target = ["this is the reference", "there is another one"]
    >>> word_error_rate(preds, target, device="cpu")
    tensor(0.5000)
    """
    errors, total = _wer_update(preds, target)
    e, t = _f32([errors, total], resolve_device(device))
    return e / t


def _cer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[int, int]:
    """Σ character edit distance and Σ target characters."""
    preds, target = _as_list(preds), _as_list(target)
    errors = 0
    total = 0
    for p, t in zip(preds, target):
        errors += _edit_distance(list(p), list(t))
        total += len(t)
    return errors, total


def char_error_rate(preds: Union[str, List[str]], target: Union[str, List[str]], *, device: _Device = None) -> Tensor:
    """Character error rate.

    >>> char_error_rate(["this is the prediction"], ["this is the reference"], device="cpu")
    tensor(0.3810)
    """
    errors, total = _cer_update(preds, target)
    e, t = _f32([errors, total], resolve_device(device))
    return e / t


def _mer_wil_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[int, int, int, int, int]:
    """(errors, total for MER, hits, target words, predicted words) for MER, WIL and WIP."""
    preds, target = _as_list(preds), _as_list(target)
    errors = total_mer = total_hits = target_total = preds_total = 0
    for p, t in zip(preds, target):
        pt, tt = _tokenize_words(p), _tokenize_words(t)
        s, d, i, h = _edit_distance_counts(pt, tt)
        errors += s + d + i
        total_mer += s + d + h + i
        total_hits += h
        target_total += len(tt)
        preds_total += len(pt)
    return errors, total_mer, total_hits, target_total, preds_total


def match_error_rate(preds: Union[str, List[str]], target: Union[str, List[str]], *, device: _Device = None) -> Tensor:
    """Match error rate.

    >>> preds = ["this is the prediction", "there is an other sample"]
    >>> target = ["this is the reference", "there is another one"]
    >>> match_error_rate(preds, target, device="cpu")
    tensor(0.4444)
    """
    errors, total, _, _, _ = _mer_wil_update(preds, target)
    e, t = _f32([errors, total], resolve_device(device))
    return e / t


def _wip(hits: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    return hits / target_total * hits / preds_total


def word_information_preserved(
    preds: Union[str, List[str]], target: Union[str, List[str]], *, device: _Device = None
) -> Tensor:
    """Word information preserved.

    >>> preds = ["this is the prediction", "there is an other sample"]
    >>> target = ["this is the reference", "there is another one"]
    >>> word_information_preserved(preds, target, device="cpu")
    tensor(0.3472)
    """
    _, _, hits, target_total, preds_total = _mer_wil_update(preds, target)
    return _wip(*_f32([hits, target_total, preds_total], resolve_device(device)))


def word_information_lost(
    preds: Union[str, List[str]], target: Union[str, List[str]], *, device: _Device = None
) -> Tensor:
    """Word information lost.

    >>> preds = ["this is the prediction", "there is an other sample"]
    >>> target = ["this is the reference", "there is another one"]
    >>> word_information_lost(preds, target, device="cpu")
    tensor(0.6528)
    """
    return 1 - word_information_preserved(preds, target, device=device)


def _edit_distances(preds: List[str], target: List[str], substitution_cost: int) -> List[int]:
    """The character edit distance of each pair, with substitutions costing ``substitution_cost``."""
    if substitution_cost == 1:
        return [_edit_distance(list(p), list(t)) for p, t in zip(preds, target)]
    dists = []
    for p, t in zip(preds, target):
        m, n = len(p), len(t)
        dp = np.zeros((m + 1, n + 1), dtype=np.int64)
        dp[:, 0] = np.arange(m + 1)
        dp[0, :] = np.arange(n + 1)
        for i in range(1, m + 1):
            for j in range(1, n + 1):
                cost = 0 if p[i - 1] == t[j - 1] else substitution_cost
                dp[i, j] = min(dp[i - 1, j] + 1, dp[i, j - 1] + 1, dp[i - 1, j - 1] + cost)
        dists.append(int(dp[m, n]))
    return dists


def edit_distance(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    substitution_cost: int = 1,
    reduction: Optional[str] = "mean",
    *,
    device: _Device = None,
) -> Tensor:
    """Character edit distance of each pair, reduced by ``reduction`` ("mean", "sum", "none" or None).

    >>> edit_distance(["rain"], ["shine"], device="cpu")
    tensor(3.)
    """
    arr = _f32(_edit_distances(_as_list(preds), _as_list(target), substitution_cost), resolve_device(device))
    if reduction == "mean":
        return arr.mean()
    if reduction == "sum":
        return arr.sum()
    if reduction is None or reduction == "none":
        return arr
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
