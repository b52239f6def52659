"""Segmentation functions (counterpart of ``metrics_tpu/functional/segmentation/metrics.py``).

Dice, generalized Dice and mean IoU rest on three sums per image and class: the
intersection, the predicted and the target pixel counts. One-hot inputs are
summed in float32, as the JAX package sums them. Index inputs are counted
instead of expanded to one-hots: one ``scatter_add_`` of int64 ones into each
image's bins of (predicted, target) label, labels outside ``[0, num_classes)``
in bins of their own, which equals the JAX package's float32 sums of its
one-hots while a count stays below 2^24 (a Cityscapes image has 2^21 pixels),
without the (N, C, H, W) float32 masks and without a host sync. The Hausdorff distance takes each mask's edge points on
its device and their distances on the device too, in float64, in blocks of
rows of the first edge set; only the two maxima come back.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from metrics_tpu_torch.utils.compute import _safe_divide

Tensor = torch.Tensor

# the CPU's block of squared distances: 2^22 float64 values
_CPU_DISTANCE_BLOCK = 1 << 22
# bytes a pair of edge points takes while its block is live: its distance and one axis' difference, in float64
_BYTES_PER_DISTANCE = 16


def _format_inputs(preds: Tensor, target: Tensor, num_classes: int, input_format: str, include_background: bool):
    """To one-hot (N, C, ...) float32 masks, without the background class unless ``include_background``: the
    one-hot route, and for index inputs the plain version that the tests hold :func:`_index_class_sums` to."""
    if input_format == "index":
        classes = torch.arange(num_classes, device=preds.device).reshape(1, num_classes, *([1] * (preds.ndim - 1)))
        preds = (preds[:, None] == classes).float()
        target = (target[:, None] == classes).float()
    elif input_format == "one-hot":
        preds = preds.float()
        target = target.float()
    else:
        raise ValueError(f"Expected argument `input_format` to be one of 'one-hot', 'index', but got {input_format}")
    if not include_background:
        preds = preds[:, 1:]
        target = target[:, 1:]
    return preds, target


def _index_class_sums(preds: Tensor, target: Tensor, num_classes: int) -> Tuple[Tensor, Tensor, Tensor]:
    """(intersection, predicted count, target count), int64 (N, num_classes), of index maps.

    One ``scatter_add_`` of int64 ones into each image's (C + 1) x (C + 1) bins of (predicted, target) label,
    the last row and column taking the labels outside ``[0, num_classes)``: the diagonal is the intersection,
    the row sums the predicted counts, the column sums the target counts.
    """
    n, c1 = preds.shape[0], num_classes + 1

    def labels(x: Tensor) -> Tensor:
        x = x.reshape(n, -1)
        valid = (x >= 0) & (x < num_classes)
        if x.is_floating_point():
            valid &= x == x.trunc()
        return torch.where(valid, x.long(), num_classes)

    images = torch.arange(n, device=preds.device)[:, None]
    bins = ((images * c1 + labels(preds)) * c1 + labels(target)).reshape(-1)
    counts = torch.zeros(n * c1 * c1, dtype=torch.int64, device=preds.device)
    counts = counts.scatter_add_(0, bins, torch.ones_like(bins)).reshape(n, c1, c1)
    c = num_classes
    return counts.diagonal(dim1=1, dim2=2)[:, :c], counts.sum(2)[:, :c], counts.sum(1)[:, :c]


def _class_sums(
    preds: Tensor, target: Tensor, num_classes: int, input_format: str, include_background: bool
) -> Tuple[Tensor, Tensor, Tensor]:
    """(intersection, predicted count, target count), float32 (N, C) per image and class."""
    if input_format == "index":
        start = 0 if include_background else 1
        return tuple(s[:, start:].float() for s in _index_class_sums(preds, target, num_classes))
    preds, target = _format_inputs(preds, target, num_classes, input_format, include_background)
    reduce_axes = tuple(range(2, preds.ndim))
    return preds.mul(target).sum(reduce_axes), preds.sum(reduce_axes), target.sum(reduce_axes)


def _dice_update(
    preds: Tensor, target: Tensor, num_classes: int, input_format: str, include_background: bool
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per image and class: the numerator ``2 * intersection``, the denominator ``pred + target``, the support
    (target count) and the predicted count."""
    intersection, pred_sum, target_sum = _class_sums(preds, target, num_classes, input_format, include_background)
    return 2 * intersection, pred_sum + target_sum, target_sum, pred_sum


def _dice_score_compute(
    numerator: Tensor, denominator: Tensor, average: Optional[str], support: Optional[Tensor] = None
) -> Tensor:
    """Per-sample Dice from the per-sample sums; a class empty in both scores 1."""
    if average == "micro":
        numerator = numerator.sum(-1)
        denominator = denominator.sum(-1)
    dice = _safe_divide(numerator, denominator, zero_division=1.0)
    if average == "macro":
        dice = dice.mean(-1)
    elif average == "weighted" and support is not None:
        weights = _safe_divide(support, support.sum(-1, keepdim=True), zero_division=1.0)
        dice = (dice * weights).sum(-1)
    return dice


def _check_index_num_classes(input_format: str, num_classes: Optional[int]) -> None:
    if input_format == "index" and num_classes is None:
        raise ValueError("Argument `num_classes` must be provided when `input_format='index'`")


def dice_score(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    include_background: bool = True,
    average: Optional[str] = "micro",
    input_format: str = "one-hot",
    aggregation_level: str = "samplewise",
) -> Tensor:
    """Per-sample Dice scores, (N,) or (N, C) for ``average="none"``; with ``aggregation_level="global"`` the
    sums are pooled over the batch first, giving one row.

    >>> import numpy as np
    >>> rng = np.random.RandomState(0)
    >>> preds = torch.from_numpy(rng.randint(0, 2, (4, 3, 16, 16)))
    >>> target = torch.from_numpy(rng.randint(0, 2, (4, 3, 16, 16)))
    >>> round(float(dice_score(preds, target, num_classes=3).mean()), 3)
    0.494
    """
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(f"Expected argument `average` to be one of ('micro','macro','weighted','none'), got {average}")
    _check_index_num_classes(input_format, num_classes)
    num_classes = num_classes if num_classes is not None else preds.shape[1]
    numerator, denominator, support, _ = _dice_update(preds, target, num_classes, input_format, include_background)
    if aggregation_level == "global":
        numerator = numerator.sum(0, keepdim=True)
        denominator = denominator.sum(0, keepdim=True)
        support = support.sum(0, keepdim=True)
    elif aggregation_level != "samplewise":
        raise ValueError(
            f"Expected argument `aggregation_level` to be one of 'samplewise', 'global', but got {aggregation_level}"
        )
    return _dice_score_compute(numerator, denominator, average, support=support if average == "weighted" else None)


def generalized_dice_score(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool = True,
    per_class: bool = False,
    weight_type: str = "square",
    input_format: str = "one-hot",
) -> Tensor:
    """Per-sample generalized Dice scores, (N,) or (N, C) with ``per_class``.

    A class empty in an image's target has an infinite weight; the weight put in its place is the JAX
    package's: cell (i, j) of the (N, C) weights takes the batch maximum of class ``(i * C + j) // N``, not of
    class j (its ``repeat().T.flatten()`` indexing), kept as it is.

    >>> import numpy as np
    >>> rng = np.random.RandomState(0)
    >>> preds = torch.from_numpy(rng.randint(0, 3, (4, 16, 16)))
    >>> target = torch.from_numpy(rng.randint(0, 3, (4, 16, 16)))
    >>> round(float(generalized_dice_score(preds, target, 3, input_format="index").mean()), 3)
    0.329
    """
    if weight_type not in ("square", "simple", "linear"):
        raise ValueError(
            f"Expected argument `weight_type` to be one of 'square', 'simple', 'linear', got {weight_type}"
        )
    intersection, pred_sum, target_sum = _class_sums(preds, target, num_classes, input_format, include_background)
    if weight_type == "square":
        weights = 1.0 / target_sum**2
    elif weight_type == "simple":
        weights = 1.0 / target_sum
    else:
        weights = torch.ones_like(target_sum)
    infs = torch.isinf(weights)
    weights = torch.where(infs, torch.zeros_like(weights), weights)
    n_s, n_c = weights.shape
    w_max = weights.max(0).values
    repl = w_max[torch.arange(n_s * n_c, device=weights.device) // n_s].reshape(n_s, n_c)
    weights = torch.where(infs, repl, weights)
    numerator = 2 * weights * intersection
    denominator = weights * (pred_sum + target_sum)
    if per_class:
        return _safe_divide(numerator, denominator)
    return _safe_divide(numerator.sum(-1), denominator.sum(-1))


def mean_iou(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    include_background: bool = True,
    per_class: bool = False,
    input_format: str = "one-hot",
) -> Tensor:
    """Per-sample mean IoU, (N,) or (N, C) with ``per_class``; a class absent from both counts 0.

    >>> import numpy as np
    >>> rng = np.random.RandomState(0)
    >>> preds = torch.from_numpy(rng.randint(0, 3, (4, 16, 16)))
    >>> target = torch.from_numpy(rng.randint(0, 3, (4, 16, 16)))
    >>> round(float(mean_iou(preds, target, num_classes=3, input_format="index").mean()), 3)
    0.198
    """
    _check_index_num_classes(input_format, num_classes)
    num_classes = num_classes if num_classes is not None else preds.shape[1]
    intersection, pred_sum, target_sum = _class_sums(preds, target, num_classes, input_format, include_background)
    iou = _safe_divide(intersection, pred_sum + target_sum - intersection)
    return iou if per_class else iou.mean(-1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _edges(mask: Tensor) -> Tensor:
    """The boundary of a binary mask of 1 to 3 dims: set pixels whose 3 x 3 (x 3) neighbourhood, the padding
    left out, holds an unset one."""
    m = mask.float()
    eroded = -_MAX_POOL[m.ndim](-m[None, None], 3, stride=1, padding=1)[0, 0]  # max_pool pads with -inf
    return (m > 0) & (eroded <= 0)


def _distance_block_rows(e1: int, e2: int, device: torch.device) -> int:
    """Rows of the first edge set per block: on a CUDA device, as many as keep a block within a quarter of the
    free memory; on the CPU, ``_CPU_DISTANCE_BLOCK`` distances."""
    if device.type != "cuda":
        return max(1, _CPU_DISTANCE_BLOCK // e2)
    free, _ = torch.cuda.mem_get_info(device)
    return int(max(1, min(e1, free // 4 // (_BYTES_PER_DISTANCE * e2))))


def _hausdorff_pair(e1: Tensor, e2: Tensor, spacing: Tensor, distance_metric: str, directed: bool) -> Tensor:
    """The (directed) Hausdorff distance between two non-empty (E, ndim) point sets, float64 on their device.

    Each axis' scaled difference ``|a - b| * spacing`` and their combination run in the JAX package's order
    (axis 0, then 1, then 2), so the values equal numpy's. The euclidean distance is compared squared and its
    root taken of the maximum, which is the same value: the root is correctly rounded and monotonic.
    """
    a, b = e1.double(), e2.double()
    rows = _distance_block_rows(len(a), len(b), a.device)
    fwd = torch.zeros((), dtype=torch.float64, device=a.device)
    col_min = torch.full((len(b),), float("inf"), dtype=torch.float64, device=a.device)
    for start in range(0, len(a), rows):
        d = None
        for k in range(a.shape[1]):
            # in place: a block holds only its distances and one axis' differences
            diff = (a[start:start + rows, k, None] - b[None, :, k]).abs_().mul_(spacing[k])
            if distance_metric == "euclidean":
                diff.mul_(diff)
            if d is None:
                d = diff
            elif distance_metric == "chessboard":
                torch.maximum(d, diff, out=d)
            else:
                d.add_(diff)
        fwd = torch.maximum(fwd, d.min(1).values.max())
        if not directed:
            col_min = torch.minimum(col_min, d.min(0).values)
    out = fwd if directed else torch.maximum(fwd, col_min.max())
    return out.sqrt() if distance_metric == "euclidean" else out


def hausdorff_distance(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool = False,
    distance_metric: str = "euclidean",
    spacing: Optional[Tuple[float, ...]] = None,
    directed: bool = False,
    input_format: str = "one-hot",
) -> Tensor:
    """Hausdorff distance between the edges of each image's predicted and target mask of each class, (N, C)
    float32: 0 where both edge sets are empty, inf where one is.

    >>> preds = torch.zeros(1, 8, 8, dtype=torch.long)
    >>> target = torch.zeros(1, 8, 8, dtype=torch.long)
    >>> preds[0, 2:5, 2:5] = 1
    >>> target[0, 3:7, 3:7] = 1
    >>> hausdorff_distance(preds, target, num_classes=2, input_format="index")
    tensor([[2.8284]])
    """
    if distance_metric not in ("euclidean", "chessboard", "taxicab"):
        raise ValueError(
            f"Arg `distance_metric` must be one of 'euclidean', 'chessboard', 'taxicab', but got {distance_metric}"
        )
    if input_format == "index":
        classes = range(0 if include_background else 1, num_classes)
        spatial = preds.shape[1:]
    elif input_format == "one-hot":
        classes = range(0 if include_background else 1, preds.shape[1])
        spatial = preds.shape[2:]
    else:
        raise ValueError(f"Expected argument `input_format` to be one of 'one-hot', 'index', but got {input_format}")

    def mask(x: Tensor, i: int, cls: int) -> Tensor:
        return x[i] == cls if input_format == "index" else x[i, cls].float()

    sp = torch.tensor(spacing if spacing is not None else (1.0,) * len(spatial), dtype=torch.float64,
                      device=preds.device)
    out: List[Tensor] = []
    for i in range(preds.shape[0]):
        for cls in classes:
            e1 = torch.nonzero(_edges(mask(preds, i, cls)))
            e2 = torch.nonzero(_edges(mask(target, i, cls)))
            if len(e1) == 0 or len(e2) == 0:
                # both empty: 0; one empty: an infinite surface distance
                value = 0.0 if len(e1) == len(e2) else float("inf")
                out.append(torch.tensor(value, dtype=torch.float64, device=preds.device))
            else:
                out.append(_hausdorff_pair(e1, e2, sp, distance_metric, directed))
    if not out:
        return torch.zeros((preds.shape[0], 0), dtype=torch.float32, device=preds.device)
    return torch.stack(out).reshape(preds.shape[0], len(classes)).float()
