"""Binned per-threshold counts: the CUDA kernel behind the binned PR-curve family.

Counterpart of ``metrics_tpu/ops/binned_hist.py``. :func:`binned_counts` takes
(N, C) scores, 0/1 targets and a validity mask, and (T,) ascending thresholds,
and returns ``(tp, fp, pos_tot, neg_tot)`` as int32: ``tp[c, t]`` counts valid
positives of class ``c`` whose score is ``>= thresholds[t]``, ``fp`` the same
over negatives (target 0), and the totals count each class's valid positives
and negatives. A NaN score meets no threshold; so does a NaN threshold.
:func:`binned_counts_labels` is the same kernel's labels mode: (N,) int32
labels stand for the targets ``label == c`` and the mask ``label >= 0``.
Scores and thresholds are both float32 or both float64, and are compared in
that type; any other pairing raises.

On a CUDA tensor each launches the kernel of ``csrc/binned_hist.cu``; on a CPU
tensor it runs its plain version, which is also the kernel's oracle: the
labels mode's plain version builds the one-hot and calls
:func:`binned_counts_plain`, so both modes share one oracle.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from metrics_tpu_torch.ops import _native
from metrics_tpu_torch.utils.data import bincount, bincount_fixed

__all__ = [
    "binned_counts",
    "binned_counts_labels",
    "binned_counts_labels_plain",
    "binned_counts_plain",
    "histogram_counts",
]

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def binned_counts_plain(
    preds: torch.Tensor, target01: torch.Tensor, valid: torch.Tensor, thresholds: torch.Tensor
) -> Counts:
    """The plain PyTorch version: bucketize, one histogram per class, suffix sums.

    Bucket ``b`` = #thresholds ``<= score`` (compared in the scores' own type),
    so ``score >= thr[t]`` exactly when ``t < b``; a histogram over (C, T + 1)
    buckets and a suffix sum give every count. Positives and negatives outside
    the mask go to a dead bin.
    """
    num_c = preds.shape[1]
    len_t = thresholds.shape[0]
    thr_nan = torch.isnan(thresholds)
    # NaN thresholds sort last; as +inf they keep the search monotone, and the
    # clamp to the count of real thresholds keeps +inf scores from meeting them
    thr = torch.where(thr_nan, torch.inf, thresholds)
    bucket = torch.searchsorted(thr, preds.contiguous(), right=True)
    bucket = torch.minimum(bucket, (~thr_nan).sum())
    bucket = torch.where(torch.isnan(preds), 0, bucket)
    flat = bucket + (len_t + 1) * torch.arange(num_c, device=preds.device)
    dead = num_c * (len_t + 1)

    def hist(mask: torch.Tensor) -> torch.Tensor:
        return bincount(torch.where(mask, flat, dead), dead + 1)[:dead].reshape(num_c, len_t + 1)

    pos_hist = hist(valid & (target01 == 1))
    neg_hist = hist(valid & (target01 == 0))
    pos_tot = pos_hist.sum(-1, keepdim=True)
    neg_tot = neg_hist.sum(-1, keepdim=True)
    tp = (pos_tot - pos_hist.cumsum(-1))[:, :len_t]
    fp = (neg_tot - neg_hist.cumsum(-1))[:, :len_t]
    return tp.int(), fp.int(), pos_tot[:, 0].int(), neg_tot[:, 0].int()


def binned_counts_labels_plain(preds: torch.Tensor, labels: torch.Tensor, thresholds: torch.Tensor) -> Counts:
    """The labels mode's plain version: the one-hot and the mask, then :func:`binned_counts_plain`.

    ``target01 = (label == c)`` and ``valid = (label >= 0)``, so a label ``>= C``
    counts as a negative of every class, as its one-hot row does.
    """
    num_c = preds.shape[1]
    target01 = (labels[:, None] == torch.arange(num_c, device=labels.device)).int()
    valid = (labels >= 0)[:, None].expand(preds.shape)
    return binned_counts_plain(preds, target01, valid, thresholds)


_SCORE_TYPES = (torch.float32, torch.float64)


def _library() -> ctypes.CDLL:
    lib = _native.load("binned_hist")
    p = ctypes.c_void_p
    ll = ctypes.c_longlong
    i = ctypes.c_int
    for suffix in ("", "_f64"):
        getattr(lib, "binned_counts_workspace" + suffix).argtypes = [ll, i, i]
        getattr(lib, "binned_counts_workspace" + suffix).restype = ll
        getattr(lib, "binned_counts_launch" + suffix).argtypes = [p, p, p, p, ll, i, i, i, p, ll, p, p, p, p, p]
        getattr(lib, "binned_counts_launch" + suffix).restype = i
    return lib


def _check_score_types(preds: torch.Tensor, thresholds: torch.Tensor, what: str) -> None:
    """Raise unless scores and thresholds are both float32 or both float64 (checked on every device)."""
    if preds.dtype not in _SCORE_TYPES or thresholds.dtype != preds.dtype:
        raise TypeError(
            f"{what} expects float32 preds with float32 thresholds or float64 with float64,"
            f" got {preds.dtype} and {thresholds.dtype}"
        )


def _check(tensors, preds: torch.Tensor, thresholds: torch.Tensor, what: str) -> None:
    for tensor, dtype, name in tensors:
        if tensor.dtype != dtype:
            raise TypeError(f"{what} expects {name} as {dtype}, got {tensor.dtype}")
        if tensor.device != preds.device:
            raise ValueError(f"{what} expects every input on {preds.device}, got {name} on {tensor.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{what} expects contiguous inputs; {name} is not")
    if preds.shape[1] < 1 or thresholds.shape[0] < 1:
        raise ValueError(f"{what} needs at least one class and one threshold")
    if preds.shape[0] >= 2**31:
        raise ValueError(f"{what} counts in int32: at most 2^31 - 1 rows per call")


def _launch(preds: torch.Tensor, target: torch.Tensor, valid, thresholds: torch.Tensor, labels: bool,
            what: str) -> Counts:
    """One kernel launch (after a memset of the tickets); outputs and workspace from ``torch.empty``."""
    lib = _library()
    suffix = "_f64" if preds.dtype == torch.float64 else ""
    n, num_c = preds.shape
    len_t = thresholds.shape[0]
    device = preds.device
    with torch.cuda.device(device):
        ws_ints = getattr(lib, "binned_counts_workspace" + suffix)(n, num_c, len_t)
        if ws_ints < 0:
            _native.check(lib, int(-ws_ints), f"{what} plan")
        workspace = torch.empty((ws_ints,), dtype=torch.int32, device=device)
        tp = torch.empty((num_c, len_t), dtype=torch.int32, device=device)
        fp = torch.empty_like(tp)
        pos_tot = torch.empty((num_c,), dtype=torch.int32, device=device)
        neg_tot = torch.empty_like(pos_tot)
        rc = getattr(lib, "binned_counts_launch" + suffix)(
            preds.data_ptr(), target.data_ptr(), None if valid is None else valid.data_ptr(), thresholds.data_ptr(),
            n, num_c, len_t, int(labels), workspace.data_ptr(), ws_ints, tp.data_ptr(), fp.data_ptr(),
            pos_tot.data_ptr(), neg_tot.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    _native.check(lib, rc, f"{what} kernel")
    return tp, fp, pos_tot, neg_tot


def binned_counts(preds: torch.Tensor, target01: torch.Tensor, valid: torch.Tensor, thresholds: torch.Tensor) -> Counts:
    """``(tp, fp, pos_tot, neg_tot)``: the kernel on a CUDA tensor, the plain version on a CPU tensor.

    ``preds`` (N, C) float32 or float64, ``target01`` (N, C) int32, ``valid``
    (N, C) bool and ``thresholds`` (T,) ascending in the type of ``preds``, all
    contiguous on one device. A float64 call counts under this wrapper's
    ``launches`` too.
    """
    _check_score_types(preds, thresholds, "binned_counts")
    if preds.device.type == "cpu":
        return binned_counts_plain(preds, target01, valid, thresholds)
    if preds.device.type != "cuda":
        raise ValueError(f"binned_counts runs on CUDA or CPU tensors, got {preds.device}")
    if preds.ndim != 2 or target01.shape != preds.shape or valid.shape != preds.shape or thresholds.ndim != 1:
        raise ValueError(
            "binned_counts expects preds, target01 and valid of one (N, C) shape and (T,) thresholds, got"
            f" {tuple(preds.shape)}, {tuple(target01.shape)}, {tuple(valid.shape)} and {tuple(thresholds.shape)}"
        )
    _check(((preds, preds.dtype, "preds"), (target01, torch.int32, "target01"), (valid, torch.bool, "valid"),
            (thresholds, preds.dtype, "thresholds")), preds, thresholds, "binned_counts")
    out = _launch(preds, target01, valid, thresholds, False, "binned_counts")
    binned_counts.launches += 1
    return out


binned_counts.launches = 0


def binned_counts_labels(preds: torch.Tensor, labels: torch.Tensor, thresholds: torch.Tensor) -> Counts:
    """The labels mode: :func:`binned_counts` of ``(label == c)`` targets and ``(label >= 0)`` validity.

    ``preds`` (N, C) float32 or float64, ``labels`` (N,) int32 and
    ``thresholds`` (T,) ascending in the type of ``preds``, all contiguous on
    one device. The kernel reads the labels in place of an (N, C) one-hot and
    mask; the counts are the same.
    """
    _check_score_types(preds, thresholds, "binned_counts_labels")
    if preds.device.type == "cpu":
        return binned_counts_labels_plain(preds, labels, thresholds)
    if preds.device.type != "cuda":
        raise ValueError(f"binned_counts_labels runs on CUDA or CPU tensors, got {preds.device}")
    if preds.ndim != 2 or labels.shape != preds.shape[:1] or thresholds.ndim != 1:
        raise ValueError(
            "binned_counts_labels expects (N, C) preds, (N,) labels and (T,) thresholds, got"
            f" {tuple(preds.shape)}, {tuple(labels.shape)} and {tuple(thresholds.shape)}"
        )
    _check(((preds, preds.dtype, "preds"), (labels, torch.int32, "labels"),
            (thresholds, preds.dtype, "thresholds")), preds, thresholds, "binned_counts_labels")
    out = _launch(preds, labels, None, thresholds, True, "binned_counts_labels")
    binned_counts_labels.launches += 1
    return out


binned_counts_labels.launches = 0


def _bucket_index(values: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """The bin ``[edges[i], edges[i+1])`` of each value, those below the first edge in the first bin and those at
    or above the last in the last; ``values`` and ``edges`` of one float type on one device."""
    return torch.clamp(torch.searchsorted(edges, values, right=True) - 1, 0, edges.shape[0] - 2)


def histogram_counts(values: torch.Tensor, valid: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Masked counts of ``values`` in the bins ``[edges[i], edges[i+1])``; (len(edges) - 1,) int64.

    The counterpart of the JAX package's ``histogram_counts``, plain tensor
    operations and no kernel. Values below the first edge count in the first
    bin and values at or above the last edge in the last; NaNs and masked rows
    go to a discarded overflow bin. The compare runs in float32 against
    float32 edges whatever the default float type, as in the JAX package; the
    counts are ``count_dtype()`` (int64) where the JAX package's are int32,
    and are added into a tensor of the known size, so the card is never read.
    """
    num_bins = edges.shape[0] - 1
    v = values.to(torch.float32).reshape(-1)
    ok = valid.to(torch.bool).reshape(-1) & ~torch.isnan(v)
    idx = _bucket_index(v, edges.to(device=v.device, dtype=torch.float32))
    return bincount_fixed(torch.where(ok, idx, num_bins), num_bins + 1)[:num_bins]
