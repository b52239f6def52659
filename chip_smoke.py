#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is skipped:

1. print the card's name and power limit (``nvidia-smi``); no CUDA device -> exit 1;
2. build the kernel libraries from ``metrics_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print what ``ptxas`` reports for each kernel
   (registers, spills, shared memory);
3. hold each kernel against its plain PyTorch version on the card: the binned
   counts in both input modes ((N, C) targets and mask; (N,) labels)
   integer-equal, in float32 and in float64 (scores on the float64 grid and
   within half a float32 ulp of it), the SSIM window within
   ``SSIM_RTOL``/``SSIM_ATOL``;
4. the main path through the public classes on ``device="cuda"``, each result
   checked against the same inputs run through the port on the CPU; every
   kernel's launch count is set to 0 just before each metric's run and read
   just after, so the run shows which kernel each metric went through (the
   multiclass curve through the labels mode). Its metrics: accuracy, the
   binary and multiclass PR curves, SSIM, then the binned curve family:
   multilabel mAP over the 80 MS-COCO labels, binary and multiclass AUROC,
   the exact binary AUROC below a ``max_fpr``, and every curve class through
   its task wrapper for each task; then the stat-score and confusion-matrix
   family, which launches no kernel: an ImageNet-1k evaluation (1000 classes,
   the 50,000 validation images in 5 updates of 10,000: precision, recall,
   F1, the confusion matrix, Matthews, Jaccard, top-5 precision and the
   15-bin ECE), F1, Hamming, exact match and the three ranking metrics on the
   COCO-80 multilabel inputs, quadratic-weighted kappa over 5 grades, a
   float64 binary AUROC under torch's float64 default (the float64 binned
   counts), and every new class through its task wrapper for each task;
5. time each kernel, its plain version and (for the window) one library call
   with CUDA events at the main path's shapes, beside the least time the card
   could take (``bound_ms``). With ``--baseline DIR`` (an unpacked older tree of
   this repository) the older kernels are timed in turns with these, old, new,
   new, old, each old run in a process of its own started in ``DIR``;
6. print the kernels' JSON line and, last, the device JSON line.

Inputs come from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SSIM_RTOL, SSIM_ATOL = 1e-5, 1e-6  # window sums of values in [0, 1]; the kernel keeps the plain order of roundings
ACC_BATCH, ACC_CLASSES, ACC_STEPS = 1 << 20, 10, 50
PRC_THRESHOLDS, BIN_N, MC_N, PRC_STEPS = 200, 1 << 22, 1 << 20, 3
SSIM_SHAPE, SSIM_STEPS = (20, 3, 256, 256), 3
# multilabel mAP over the 80 MS-COCO labels (the usual score of multilabel image classifiers); 2^18 images per
# update, about 6.5 COCO val2014 sets; about 2.9 of the 80 labels are present per image (3.6 %)
ML_N, ML_LABELS, ML_POSITIVE = 1 << 18, 80, 0.036
EXACT_N, WRAPPED_N = 1 << 20, 1 << 16
CURVE_RTOL, CURVE_ATOL = 1e-5, 1e-6  # float32 sums of up to T + 1 trapezoids or steps, in another order
# ImageNet-1k evaluation: the 50,000 validation images in 5 updates of 10,000 x 1000 float32 logits, about
# 75 % of them right at top-1
IN_CLASSES, IN_BATCH, IN_STEPS, IN_TOP1 = 1000, 10_000, 5, 0.75
KAPPA_N, KAPPA_GRADES = 1 << 16, 5  # quadratic-weighted kappa over 5 grades (diabetic-retinopathy grading)
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6  # scores from equal counters, reduced on the card in another order
SUM_RTOL, SUM_ATOL = 1e-4, 1e-6  # ECE and hinge: float sums over 10^4-10^5 samples in another order


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------------- phase 3
def check_kernels(rng: np.random.Generator) -> dict:
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
    from metrics_tpu_torch.functional.image.ssim import _gaussian_taps_np
    from metrics_tpu_torch.ops.binned_hist import (
        binned_counts,
        binned_counts_labels,
        binned_counts_labels_plain,
        binned_counts_plain,
    )
    from metrics_tpu_torch.ops.ssim_window import ssim_window, ssim_window_plain

    def binned_args(n, c, t):
        return [
            torch.from_numpy(rng.random((n, c), dtype=np.float32)).cuda(),
            torch.from_numpy(rng.integers(0, 2, (n, c), dtype=np.int32)).cuda(),
            torch.from_numpy(rng.random((n, c)) > 0.1).cuda(),
            _adjust_threshold_arg(t, torch.device("cuda")),
        ]

    def labels_args(n, c, t):
        preds = rng.random((n, c), dtype=np.float32)
        preds[rng.random((n, c)) < 0.01] = np.nan
        labels = rng.integers(-1, c + 1, n, dtype=np.int32)  # -1 ignored, c out of range: a negative of every class
        return [torch.from_numpy(preds).cuda(), torch.from_numpy(labels).cuda(),
                _adjust_threshold_arg(t, torch.device("cuda"))]

    def compare(name, got, want, shape):
        err = 0
        for g, w in zip(got, want):
            err = max(err, int((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):
                fail(f"{name} differs from its plain version at shape {shape}")
        return err

    nan, inf = float("nan"), float("inf")
    edge = [
        torch.tensor([[0.0], [0.25], [0.5], [0.5], [1.0], [nan], [0.75], [inf], [-inf]]).cuda(),
        torch.tensor([[0], [1], [1], [0], [1], [1], [1], [1], [0]], dtype=torch.int32).cuda(),
        torch.tensor([[True]] * 6 + [[False]] + [[True]] * 2).cuda(),
        torch.tensor([0.0, 0.25, 0.5, 0.5, 1.0, nan]).cuda(),
    ]
    # the shapes of tests/test_binned_hist_kernel.py, the edge cases, one whose classes are tiled over
    # blocks (too wide for one block's shared memory), the three full sizes (the multilabel one tiles its
    # 80 labels over two blocks too)
    shapes = [(100, 1, 5), (257, 3, 17), (1000, 4, 100), (50, 2, 129), (8, 1, 1), (4096, 300, 200),
              (BIN_N, 1, PRC_THRESHOLDS), (MC_N, 10, PRC_THRESHOLDS), (ML_N, ML_LABELS, PRC_THRESHOLDS)]
    binned_err = 0
    for args in [binned_args(*sh) for sh in shapes] + [edge]:
        binned_err = max(binned_err, compare("binned_counts", binned_counts(*args), binned_counts_plain(*args),
                                             tuple(args[0].shape)))
    labels_err = 0
    for sh in [sh for sh in shapes if sh[1] > 1]:
        args = labels_args(*sh)
        labels_err = max(labels_err, compare("binned_counts_labels", binned_counts_labels(*args),
                                             binned_counts_labels_plain(*args), sh))
    torch.cuda.synchronize()
    log(f"binned_counts: integer-equal to the plain version on {len(shapes) + 1} cases; labels mode on"
        f" {len([sh for sh in shapes if sh[1] > 1])}")

    # the float64 instantiation: scores on the float64 grid or within half a float32 ulp of it, compared in
    # float64 by the kernel and by its plain version (float64 searchsorted)
    f64_err = 0
    f64_shapes = [(100, 1, 5), (257, 3, 17), (50, 2, 129), (4096, 300, 200), (3000, 2, 20000),
                  (BIN_N, 1, PRC_THRESHOLDS), (MC_N, 10, PRC_THRESHOLDS), (ML_N, ML_LABELS, PRC_THRESHOLDS)]
    for n, c, t in f64_shapes:
        preds, grid = float64_near_grid(rng, (n, c), t)
        preds, grid = torch.from_numpy(preds).cuda(), torch.from_numpy(grid).cuda()
        target01 = torch.from_numpy(rng.integers(0, 2, (n, c), dtype=np.int32)).cuda()
        valid = torch.from_numpy(rng.random((n, c)) > 0.1).cuda()
        f64_err = max(f64_err, compare("binned_counts[float64]", binned_counts(preds, target01, valid, grid),
                                       binned_counts_plain(preds, target01, valid, grid), (n, c, t)))
        if c > 1:
            labels = torch.from_numpy(rng.integers(-1, c + 1, n, dtype=np.int32)).cuda()
            f64_err = max(f64_err, compare("binned_counts_labels[float64]", binned_counts_labels(preds, labels, grid),
                                           binned_counts_labels_plain(preds, labels, grid), (n, c, t)))
    torch.cuda.synchronize()
    log(f"binned_counts float64: integer-equal to the plain version in both modes on {len(f64_shapes)} shapes")

    taps = _gaussian_taps_np(11, 1.5)
    ssim_err = 0.0
    for shape, kh, kw in [((12, 42, 74), taps, taps), ((6, 20, 40), taps, _gaussian_taps_np(5, 0.8)),
                          ((5, 150, 203), taps, taps), ((70_000, 18, 18), taps, taps),
                          ((5 * SSIM_SHAPE[0] * SSIM_SHAPE[1], SSIM_SHAPE[2] + 10, SSIM_SHAPE[3] + 10), taps, taps)]:
        x = torch.from_numpy(rng.random(shape, dtype=np.float32)).cuda()
        got, want = ssim_window(x, kh, kw), ssim_window_plain(x, kh, kw)
        if not torch.allclose(got, want, rtol=SSIM_RTOL, atol=SSIM_ATOL):
            fail(f"ssim_window differs from its plain version at shape {shape}")
        ssim_err = max(ssim_err, float((got - want).abs().max()))
    torch.cuda.synchronize()
    log(f"ssim_window: allclose (rtol {SSIM_RTOL}, atol {SSIM_ATOL}); max |err| {ssim_err}")
    return {"binned_counts": float(binned_err), "binned_counts_labels": float(labels_err), "ssim_window": ssim_err,
            "binned_counts_f64": float(f64_err)}


def float64_near_grid(rng: np.random.Generator, shape, t: int):
    """float64 scores: a third uniform, a third on the float64 grid of ``t`` thresholds, a third within half a
    float32 ulp of it (above and below), and 1 % NaN; with that grid."""
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _linspace_thresholds

    grid = _linspace_thresholds(t, torch.float64)
    on = grid[rng.integers(0, t, shape)]
    near = on + rng.choice([-1.0, 1.0], shape) * np.spacing(on.astype(np.float32)).astype(np.float64) / 2 \
        * rng.uniform(0.1, 0.9, shape)
    which = rng.integers(0, 3, shape)
    preds = np.where(which == 0, rng.random(shape), np.where(which == 1, on, near))
    preds[rng.random(shape) < 0.01] = np.nan
    return preds, grid


# ----------------------------------------------------------------------------- phase 4
def _same_states(name, gpu, cpu, rtol=0.0, atol=0.0):
    """Counters integer-equal; the exact path's kept samples equal; float states (sums over samples, the
    calibration confidences after a softmax) within ``rtol``/``atol``."""
    for key in gpu.metric_state:
        a, b = getattr(gpu, key), getattr(cpu, key)
        a, b = (torch.cat([torch.atleast_1d(x) for x in a]), torch.cat([torch.atleast_1d(x) for x in b])) \
            if isinstance(a, list) else (a, b)
        a = a.cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{name}: state {key} is {a.dtype} {tuple(a.shape)} on the card, {b.dtype} {tuple(b.shape)} on"
                 " the CPU")
        same = torch.equal(a, b) if not a.is_floating_point() or (rtol == 0 and atol == 0) \
            else torch.allclose(a, b, rtol=rtol, atol=atol)
        if not same:
            fail(f"{name}: state {key} on the card differs from the CPU run")


def main_path(seed: int, wrappers: dict) -> dict:
    """Each metric's run, with every wrapper's launch count set to 0 just before it and read just after."""
    from metrics_tpu_torch.classification import (
        BinaryPrecisionRecallCurve,
        MulticlassAccuracy,
        MulticlassPrecisionRecallCurve,
    )
    from metrics_tpu_torch.image import StructuralSimilarityIndexMeasure

    out = {}
    rng = np.random.default_rng(seed)

    def run(name, make, batches, expect=None):
        """``expect``: the launches per wrapper this run must show (absent wrappers: none)."""
        gpu, cpu = make("cuda"), make("cpu")
        update_ms = []
        for wrapper in wrappers.values():
            wrapper.launches = 0
        for a, b in batches():
            a_gpu, b_gpu = a.cuda(), b.cuda()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gpu.update(a_gpu, b_gpu)
            torch.cuda.synchronize()
            update_ms.append(1000 * (time.perf_counter() - t0))
            cpu.update(a, b)
        got, want = gpu.compute(), cpu.compute()
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        # the first update also pays one-time costs (e.g. the first use of an operator), so it is kept apart
        out[name] = {"updates": gpu.update_count, "first_update_ms": update_ms[0],
                     "later_update_ms_median": float(np.median(update_ms[1:])) if len(update_ms) > 1 else None,
                     "launches": launches}
        if expect is not None:
            out[name]["expected_launches"] = expect
        return gpu, cpu, got, want

    def acc_batches():
        for _ in range(ACC_STEPS):
            yield (torch.from_numpy(rng.random((ACC_BATCH, ACC_CLASSES), dtype=np.float32)),
                   torch.from_numpy(rng.integers(0, ACC_CLASSES, ACC_BATCH)))

    gpu, cpu, got, want = run("MulticlassAccuracy", lambda d: MulticlassAccuracy(
        num_classes=ACC_CLASSES, average="micro", device=d), acc_batches)
    _same_states("MulticlassAccuracy", gpu, cpu)
    if not (torch.isfinite(got) and float(got) == float(want)):
        fail(f"MulticlassAccuracy {float(got)} on the card, {float(want)} on the CPU")
    out["MulticlassAccuracy"]["value"] = float(got)

    def prc_batches(n, c):
        def gen():
            for _ in range(PRC_STEPS):
                shape = (n,) if c == 1 else (n, c)
                yield (torch.from_numpy(rng.random(shape, dtype=np.float32)),
                       torch.from_numpy(rng.integers(0, 2 if c == 1 else c, n)))
        return gen

    for name, make, n, c in [
        ("BinaryPrecisionRecallCurve", lambda d: BinaryPrecisionRecallCurve(thresholds=PRC_THRESHOLDS, device=d),
         BIN_N, 1),
        ("MulticlassPrecisionRecallCurve", lambda d: MulticlassPrecisionRecallCurve(
            num_classes=10, thresholds=PRC_THRESHOLDS, device=d), MC_N, 10),
    ]:
        gpu, cpu, got, want = run(name, make, prc_batches(n, c))
        _same_states(name, gpu, cpu)
        for g, w in zip(got, want):
            if g.shape != w.shape or not bool(torch.isfinite(g).all()) or not torch.allclose(g.cpu(), w, rtol=1e-6):
                fail(f"{name}: curve on the card differs from the CPU run")
        out[name]["curve_shape"] = list(got[0].shape)

    def ssim_batches():
        for _ in range(SSIM_STEPS):
            a = rng.random(SSIM_SHAPE, dtype=np.float32)
            b = (0.75 * a + 0.25 * rng.random(SSIM_SHAPE, dtype=np.float32)).astype(np.float32)
            yield torch.from_numpy(a), torch.from_numpy(b)

    gpu, cpu, got, want = run("StructuralSimilarityIndexMeasure",
                              lambda d: StructuralSimilarityIndexMeasure(data_range=1.0, device=d), ssim_batches)
    if not (bool(torch.isfinite(got)) and abs(float(got) - float(want)) <= 1e-5):
        fail(f"SSIM {float(got)} on the card, {float(want)} on the CPU")
    out["StructuralSimilarityIndexMeasure"]["value"] = float(got)
    out["StructuralSimilarityIndexMeasure"]["abs_diff_vs_cpu"] = abs(float(got) - float(want))
    curve_family(rng, run, out)
    stat_family(rng, run, out)
    return out


def _agree(name, got, want, exact, rtol=CURVE_RTOL, atol=CURVE_ATOL):
    """Finite values of the CPU run's shapes and dtypes; equal, or within ``rtol``/``atol``. Returns the largest
    absolute difference."""
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            fail(f"{name}: the card returned another structure than the CPU run")
        return max([_agree(name, g, w, exact, rtol, atol) for g, w in zip(got, want)] + [0.0])
    got = got.cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {got.dtype} {tuple(got.shape)} on the card, {want.dtype} {tuple(want.shape)} on the CPU")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values on the card")
    if exact and not torch.equal(got, want):
        fail(f"{name}: the card's values differ from the CPU run's")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{name}: the card's values differ from the CPU run's beyond rtol {rtol}, atol {atol}")
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def curve_family(rng: np.random.Generator, run, out: dict) -> None:
    """The binned curve family on the main path: multilabel mAP at the 80 COCO labels, AUROC in each mode of
    the binned-counts kernel and on the exact path, and every curve class through its task wrapper."""
    from metrics_tpu_torch import classification as tc

    def multilabel(n, labels):
        target = (rng.random((n, labels)) < ML_POSITIVE).astype(np.int64)
        # informative scores: positives lean high
        preds = ((rng.random((n, labels), dtype=np.float32) + 0.5 * target) / 1.5).astype(np.float32)
        return torch.from_numpy(preds), torch.from_numpy(target)

    def binary(n):
        target = rng.integers(0, 2, n)
        preds = ((rng.random(n, dtype=np.float32) + 0.5 * target) / 1.5).astype(np.float32)
        return torch.from_numpy(preds), torch.from_numpy(target)

    def multiclass(n, classes):
        return (torch.from_numpy(rng.random((n, classes), dtype=np.float32)),
                torch.from_numpy(rng.integers(0, classes, n)))

    def batches(make, steps):
        return lambda: (make() for _ in range(steps))

    runs = [
        ("MultilabelAveragePrecision", lambda d: tc.MultilabelAveragePrecision(
            num_labels=ML_LABELS, thresholds=PRC_THRESHOLDS, average="macro", device=d),
         batches(lambda: multilabel(ML_N, ML_LABELS), PRC_STEPS), False),
        ("BinaryAUROC", lambda d: tc.BinaryAUROC(thresholds=PRC_THRESHOLDS, device=d),
         batches(lambda: binary(BIN_N), PRC_STEPS), False),
        ("MulticlassAUROC", lambda d: tc.MulticlassAUROC(num_classes=10, thresholds=PRC_THRESHOLDS, device=d),
         batches(lambda: multiclass(MC_N, 10), PRC_STEPS), False),
        ("BinaryAUROC[exact,max_fpr=0.5]", lambda d: tc.BinaryAUROC(thresholds=None, max_fpr=0.5, device=d),
         batches(lambda: binary(EXACT_N), 1), False),
    ]
    # every curve class through its task wrapper, for each task: (class, extra arguments, exact agreement)
    wrapped = [(tc.PrecisionRecallCurve, {}, True), (tc.ROC, {}, True), (tc.AveragePrecision, {}, False),
               (tc.LogAUC, {}, False), (tc.SensitivityAtSpecificity, {"min_specificity": 0.5}, True),
               (tc.SpecificityAtSensitivity, {"min_sensitivity": 0.5}, True),
               (tc.PrecisionAtFixedRecall, {"min_recall": 0.5}, True),
               (tc.RecallAtFixedPrecision, {"min_precision": 0.5}, True)]
    tasks = {"binary": ({}, lambda: binary(WRAPPED_N)),
             "multiclass": ({"num_classes": 10}, lambda: multiclass(WRAPPED_N, 10)),
             "multilabel": ({"num_labels": ML_LABELS}, lambda: multilabel(WRAPPED_N, ML_LABELS))}
    for cls, extra, exact in wrapped:
        for task, (size, make) in tasks.items():
            def factory(d, cls=cls, task=task, size=size, extra=extra):
                return cls(task=task, thresholds=PRC_THRESHOLDS, device=d, **size, **extra)
            runs.append((f"{cls.__name__}[{task}]", factory, batches(make, 1), exact))

    for name, make, feed, exact in runs:
        gpu, cpu, got, want = run(name, make, feed)
        _same_states(name, gpu, cpu)
        out[name]["max_abs_diff_vs_cpu"] = _agree(name, got, want, exact)
        if isinstance(got, torch.Tensor) and got.numel() == 1:
            out[name]["value"] = float(got)


def stat_family(rng: np.random.Generator, run, out: dict) -> None:
    """The stat-score and confusion-matrix family on the main path. None of it launches a kernel: counters and
    confusion matrices are plain tensor ops, so each run must show no launch; the float64 AUROC goes through
    the float64 binned counts, one ``binned_counts`` launch per update."""
    from metrics_tpu_torch import classification as tc

    def imagenet_batch():
        """10,000 x 1000 float32 logits whose top-1 is the target for about 75 % of the rows."""
        target = rng.integers(0, IN_CLASSES, IN_BATCH)
        guess = np.where(rng.random(IN_BATCH) < IN_TOP1, target, rng.integers(0, IN_CLASSES, IN_BATCH))
        logits = rng.standard_normal((IN_BATCH, IN_CLASSES), dtype=np.float32)
        logits[np.arange(IN_BATCH), guess] += 6.0  # above the row's other 999 normal draws
        return torch.from_numpy(logits), torch.from_numpy(target)

    imagenet = [imagenet_batch() for _ in range(IN_STEPS)]
    top1 = float(np.mean([float((p.argmax(1) == t).float().mean()) for p, t in imagenet]))
    log(f"ImageNet-1k inputs: {IN_STEPS} x {IN_BATCH} x {IN_CLASSES}, top-1 {top1:.4f}")

    def coco_batch():
        target = (rng.random((ML_N, ML_LABELS)) < ML_POSITIVE).astype(np.int64)
        preds = ((rng.random((ML_N, ML_LABELS), dtype=np.float32) + 0.5 * target) / 1.5).astype(np.float32)
        return torch.from_numpy(preds), torch.from_numpy(target)

    coco = [coco_batch() for _ in range(PRC_STEPS)]

    def grades():
        target = rng.integers(0, KAPPA_GRADES, KAPPA_N)
        preds = np.clip(target + rng.integers(-1, 2, KAPPA_N) * (rng.random(KAPPA_N) < 0.4), 0, KAPPA_GRADES - 1)
        return torch.from_numpy(preds), torch.from_numpy(target)

    def binary64():
        target = rng.integers(0, 2, BIN_N)
        preds = (rng.random(BIN_N) + 0.5 * target) / 1.5  # float64
        return torch.from_numpy(preds), torch.from_numpy(target)

    def shared(batches):
        return lambda: iter(batches)

    def batches(make, steps):
        return lambda: (make() for _ in range(steps))

    # (name, factory, batches, exact, rtol, atol, expected launches)
    runs = [
        ("ImageNet MulticlassPrecision", lambda d: tc.MulticlassPrecision(num_classes=IN_CLASSES, device=d),
         shared(imagenet), False, STAT_RTOL, STAT_ATOL, {}),
        ("ImageNet MulticlassRecall", lambda d: tc.MulticlassRecall(num_classes=IN_CLASSES, device=d),
         shared(imagenet), False, STAT_RTOL, STAT_ATOL, {}),
        ("ImageNet MulticlassF1Score", lambda d: tc.MulticlassF1Score(num_classes=IN_CLASSES, average="macro",
                                                                      device=d),
         shared(imagenet), False, STAT_RTOL, STAT_ATOL, {}),
        ("ImageNet MulticlassConfusionMatrix", lambda d: tc.MulticlassConfusionMatrix(num_classes=IN_CLASSES,
                                                                                      device=d),
         shared(imagenet), True, 0, 0, {}),
        ("ImageNet MulticlassMatthewsCorrCoef", lambda d: tc.MulticlassMatthewsCorrCoef(num_classes=IN_CLASSES,
                                                                                        device=d),
         shared(imagenet), False, STAT_RTOL, STAT_ATOL, {}),
        ("ImageNet MulticlassJaccardIndex", lambda d: tc.MulticlassJaccardIndex(num_classes=IN_CLASSES, device=d),
         shared(imagenet), False, STAT_RTOL, STAT_ATOL, {}),
        ("ImageNet MulticlassCalibrationError", lambda d: tc.MulticlassCalibrationError(
            num_classes=IN_CLASSES, n_bins=15, norm="l1", device=d), shared(imagenet), False, SUM_RTOL, SUM_ATOL, {}),
        ("ImageNet MulticlassPrecision[top_k=5]", lambda d: tc.MulticlassPrecision(num_classes=IN_CLASSES, top_k=5,
                                                                                   device=d),
         shared(imagenet), False, STAT_RTOL, STAT_ATOL, {}),
        ("COCO MultilabelF1Score", lambda d: tc.MultilabelF1Score(num_labels=ML_LABELS, average="macro", device=d),
         shared(coco), False, STAT_RTOL, STAT_ATOL, {}),
        ("COCO MultilabelHammingDistance", lambda d: tc.MultilabelHammingDistance(num_labels=ML_LABELS, device=d),
         shared(coco), False, STAT_RTOL, STAT_ATOL, {}),
        ("COCO MultilabelExactMatch", lambda d: tc.MultilabelExactMatch(num_labels=ML_LABELS, device=d),
         shared(coco), False, STAT_RTOL, STAT_ATOL, {}),
        ("COCO MultilabelCoverageError", lambda d: tc.MultilabelCoverageError(num_labels=ML_LABELS, device=d),
         shared(coco), False, STAT_RTOL, STAT_ATOL, {}),
        ("COCO MultilabelRankingAveragePrecision", lambda d: tc.MultilabelRankingAveragePrecision(
            num_labels=ML_LABELS, device=d), shared(coco), False, STAT_RTOL, STAT_ATOL, {}),
        ("COCO MultilabelRankingLoss", lambda d: tc.MultilabelRankingLoss(num_labels=ML_LABELS, device=d),
         shared(coco), False, STAT_RTOL, STAT_ATOL, {}),
        ("MulticlassCohenKappa[quadratic]", lambda d: tc.MulticlassCohenKappa(
            num_classes=KAPPA_GRADES, weights="quadratic", device=d), batches(grades, PRC_STEPS), False,
         STAT_RTOL, STAT_ATOL, {}),
    ]
    # every new class through its task wrapper for each task it has, on 2^16 rows
    sizes = {"binary": {}, "multiclass": {"num_classes": 10}, "multilabel": {"num_labels": ML_LABELS}}

    def logits(task):
        if task == "binary":
            return lambda: (torch.from_numpy(rng.standard_normal(WRAPPED_N, dtype=np.float32)),
                            torch.from_numpy(rng.integers(0, 2, WRAPPED_N)))
        if task == "multiclass":
            return lambda: (torch.from_numpy(rng.standard_normal((WRAPPED_N, 10), dtype=np.float32)),
                            torch.from_numpy(rng.integers(0, 10, WRAPPED_N)))
        return lambda: (torch.from_numpy(rng.standard_normal((WRAPPED_N, ML_LABELS), dtype=np.float32)),
                        torch.from_numpy((rng.random((WRAPPED_N, ML_LABELS)) < ML_POSITIVE).astype(np.int64)))

    three = ("binary", "multiclass", "multilabel")
    wrapped = [(tc.Precision, {}, three), (tc.Recall, {}, three), (tc.FBetaScore, {"beta": 2.0}, three),
               (tc.F1Score, {}, three), (tc.Specificity, {}, three), (tc.NegativePredictiveValue, {}, three),
               (tc.HammingDistance, {}, three), (tc.ConfusionMatrix, {}, three), (tc.JaccardIndex, {}, three),
               (tc.MatthewsCorrCoef, {}, three), (tc.ExactMatch, {}, ("multiclass", "multilabel")),
               (tc.CohenKappa, {}, ("binary", "multiclass")), (tc.CalibrationError, {}, ("binary", "multiclass")),
               (tc.HingeLoss, {}, ("binary", "multiclass"))]
    for cls, extra, tasks in wrapped:
        for task in tasks:
            def factory(d, cls=cls, task=task, extra=extra):
                return cls(task=task, device=d, **sizes[task], **extra)
            summed = cls in (tc.CalibrationError, tc.HingeLoss)
            runs.append((f"{cls.__name__}[{task}]", factory, batches(logits(task), 1), cls is tc.ConfusionMatrix,
                         SUM_RTOL if summed else STAT_RTOL, SUM_ATOL if summed else STAT_ATOL, {}))
    runs.append(("Dice[multiclass,macro]", lambda d: tc.Dice(average="macro", num_classes=10, device=d),
                 batches(logits("multiclass"), 1), False, STAT_RTOL, STAT_ATOL, {}))

    for name, make, feed, exact, rtol, atol, expect in runs:
        gpu, cpu, got, want = run(name, make, feed, expect)
        _same_states(name, gpu, cpu, rtol, atol)
        out[name]["max_abs_diff_vs_cpu"] = _agree(name, got, want, exact, rtol, atol)
        if isinstance(got, torch.Tensor) and got.numel() == 1:
            out[name]["value"] = float(got)

    # float64 scores under torch's float64 default: the float64 binned counts, compared in float64
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        name = "BinaryAUROC[float64]"
        gpu, cpu, got, want = run(name, lambda d: tc.BinaryAUROC(thresholds=PRC_THRESHOLDS, device=d),
                                  batches(binary64, PRC_STEPS), {"binned_counts": PRC_STEPS})
        _same_states(name, gpu, cpu)
        out[name]["max_abs_diff_vs_cpu"] = _agree(name, got, want, False)
        out[name]["value"] = float(got)
    finally:
        torch.set_default_dtype(previous)


# ----------------------------------------------------------------------------- phase 5
def measure(rng: np.random.Generator, plain: bool = True) -> dict:
    """Kernel, plain and library times at the main path's shapes; ``plain=False`` times the kernels only."""
    import torch.nn.functional as F

    from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
    from metrics_tpu_torch.functional.image.ssim import _gaussian_taps_np
    from metrics_tpu_torch.ops.binned_hist import (
        binned_counts,
        binned_counts_labels,
        binned_counts_labels_plain,
        binned_counts_plain,
    )
    from metrics_tpu_torch.ops.profile import flush_buffer, time_ms
    from metrics_tpu_torch.ops.ssim_window import ssim_window, ssim_window_plain

    def bound(moved, ops):
        return {"bound_ms": 1000 * max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S),
                "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"}

    flush = flush_buffer()
    res = {}
    t = PRC_THRESHOLDS
    thresholds = _adjust_threshold_arg(t, torch.device("cuda"))
    for label, n, c in [("binary", BIN_N, 1), ("multiclass", MC_N, 10), ("multilabel", ML_N, ML_LABELS)]:
        args = [
            torch.from_numpy(rng.random((n, c), dtype=np.float32)).cuda(),
            torch.from_numpy(rng.integers(0, 2, (n, c), dtype=np.int32)).cuda(),
            torch.ones((n, c), dtype=torch.bool, device="cuda"),
            thresholds,
        ]
        moved = n * c * (4 + 4 + 1) + 4 * t + 4 * (2 * c * t + 2 * c)
        ops = n * c * math.ceil(math.log2(t + 1))
        res[f"binned_counts[{label}]"] = {
            "shape": [n, c, t],
            "ms": time_ms(lambda: binned_counts(*args), flush=flush),
            "plain_ms": time_ms(lambda: binned_counts_plain(*args), reps=5, flush=flush) if plain else None,
            **bound(moved, ops),
            "library_ms": None,
        }
    n, c = MC_N, 10
    largs = [torch.from_numpy(rng.random((n, c), dtype=np.float32)).cuda(),
             torch.from_numpy(rng.integers(0, c, n, dtype=np.int32)).cuda(), thresholds]
    moved = n * c * 4 + n * 4 + 4 * t + 4 * (2 * c * t + 2 * c)
    res["binned_counts_labels[multiclass]"] = {
        "shape": [n, c, t],
        "ms": time_ms(lambda: binned_counts_labels(*largs), flush=flush),
        "plain_ms": time_ms(lambda: binned_counts_labels_plain(*largs), reps=5, flush=flush) if plain else None,
        **bound(moved, n * c * math.ceil(math.log2(t + 1))),
        "library_ms": None,
    }

    # the float64 instantiation: binary scores of 8 bytes with float64 thresholds
    n = BIN_N
    preds64, grid64 = float64_near_grid(rng, (n, 1), t)
    args64 = [torch.from_numpy(preds64).cuda(), torch.from_numpy(rng.integers(0, 2, (n, 1), dtype=np.int32)).cuda(),
              torch.ones((n, 1), dtype=torch.bool, device="cuda"), torch.from_numpy(grid64).cuda()]
    moved = n * (8 + 4 + 1) + 8 * t + 4 * (2 * t + 2)
    res["binned_counts_f64[binary]"] = {
        "shape": [n, 1, t],
        "ms": time_ms(lambda: binned_counts(*args64), flush=flush),
        "plain_ms": time_ms(lambda: binned_counts_plain(*args64), reps=5, flush=flush) if plain else None,
        **bound(moved, n * math.ceil(math.log2(t + 1))),
        "library_ms": None,
    }

    b, ch, h, w = SSIM_SHAPE
    k = _gaussian_taps_np(11, 1.5)
    planes = 5 * b * ch
    x = torch.from_numpy(rng.random((planes, h + 10, w + 10), dtype=np.float32)).cuda()
    moved = 4 * planes * ((h + 10) * (w + 10) + h * w)
    ops = 2 * planes * (11 * h * (w + 10) + 11 * h * w)
    row = {"shape": [planes, h + 10, w + 10, 11, 11], "ms": time_ms(lambda: ssim_window(x, k, k), flush=flush),
           "plain_ms": None, **bound(moved, ops), "library_ms": None}
    if plain:
        weight = torch.from_numpy(np.outer(k, k).astype(np.float32)).reshape(1, 1, 11, 11).cuda()
        x4 = x.unsqueeze(1)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        row["plain_ms"] = time_ms(lambda: ssim_window_plain(x, k, k), reps=5, flush=flush)
        row["library_ms"] = time_ms(lambda: F.conv2d(x4, weight), reps=10, flush=flush)
        row["library_max_abs_err_vs_plain"] = float((F.conv2d(x4, weight)[:, 0] - ssim_window_plain(x, k, k))
                                                    .abs().max())
    res["ssim_window"] = row
    return res


def measure_baseline(directory: str, seed: int) -> dict:
    """The older tree's own ``measure`` (its kernels only), in a process started in ``directory``."""
    code = ("import json, sys, numpy as np, chip_smoke; from metrics_tpu_torch.ops import _native; _native.build();"
            f" res = chip_smoke.measure(np.random.default_rng({seed}));"
            " print('BASELINE ' + json.dumps({k: v['ms'] for k, v in res.items()}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=directory, capture_output=True, text=True, timeout=600,
                          env=env)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("BASELINE ")]
    if proc.returncode != 0 or not lines:
        fail(f"baseline measurement in {directory} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("BASELINE "):])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--baseline", default=None,
                        help="an unpacked older tree of this repository whose kernels are timed in turns with these")
    opts = parser.parse_args()
    seed = opts.seed

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script measures the port on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from metrics_tpu_torch.ops import _native
    from metrics_tpu_torch.ops.binned_hist import binned_counts, binned_counts_labels
    from metrics_tpu_torch.ops.ssim_window import ssim_window

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({torch.cuda.device_count()} visible); torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    _native.build(ptxas_verbose=True)
    build_s = time.perf_counter() - t0
    log(f"built {len(_native.KERNEL_SOURCES)} kernel libraries in {build_s:.1f} s")
    for name, text in _native.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas[{name}]: {line.strip()}")

    rng = np.random.default_rng(seed)
    errs = check_kernels(rng)

    wrappers = {"binned_counts": binned_counts, "binned_counts_labels": binned_counts_labels,
                "ssim_window": ssim_window}
    t0 = time.perf_counter()
    path = main_path(seed, wrappers)
    log(f"main path in {time.perf_counter() - t0:.1f} s: {json.dumps(path)}")
    expect = {"BinaryPrecisionRecallCurve": {"binned_counts": PRC_STEPS},
              "MulticlassPrecisionRecallCurve": {"binned_counts_labels": PRC_STEPS},
              "StructuralSimilarityIndexMeasure": {"ssim_window": SSIM_STEPS},
              "MultilabelAveragePrecision": {"binned_counts": PRC_STEPS},
              "BinaryAUROC": {"binned_counts": PRC_STEPS},
              "MulticlassAUROC": {"binned_counts_labels": PRC_STEPS},
              "BinaryAUROC[exact,max_fpr=0.5]": {}}
    for metric in path:
        task = metric.rsplit("[", 1)[-1].rstrip("]")
        if "expected_launches" in path[metric]:
            expect[metric] = path[metric]["expected_launches"]
        elif task in ("binary", "multilabel"):
            expect[metric] = {"binned_counts": 1}
        elif task == "multiclass":
            expect[metric] = {"binned_counts_labels": 1}
    for metric, want in expect.items():
        got = {k: v for k, v in path[metric]["launches"].items() if v}
        if got != want:
            fail(f"{metric} launched {got}, expected {want}")
    launches = {name: sum(run["launches"][name] for run in path.values()) for name in wrappers}
    log(f"kernel launches on the main path: {launches}")
    for name, count in launches.items():
        if count < 1:
            fail(f"the main path never launched {name}")

    old = []
    if opts.baseline:
        old.append(measure_baseline(opts.baseline, seed))
    timing = measure(rng)
    if opts.baseline:
        again = measure(rng, plain=False)
        old.append(measure_baseline(opts.baseline, seed))
        for key, row in timing.items():
            row["ms_runs"] = [row["ms"], again[key]["ms"]]
            row["baseline_ms_runs"] = [run[key] for run in old if key in run]
    for name, row in timing.items():
        log(f"{name}: {json.dumps(row)}")

    sources = {"binned_counts[binary]": ("binned_counts", "metrics_tpu_torch/csrc/binned_hist.cu",
                                         "metrics_tpu/ops/binned_hist.py:151"),
               "binned_counts[multiclass]": ("binned_counts", "metrics_tpu_torch/csrc/binned_hist.cu",
                                             "metrics_tpu/ops/binned_hist.py:151"),
               "binned_counts[multilabel]": ("binned_counts", "metrics_tpu_torch/csrc/binned_hist.cu",
                                             "metrics_tpu/ops/binned_hist.py:151"),
               "binned_counts_labels[multiclass]": ("binned_counts_labels", "metrics_tpu_torch/csrc/binned_hist.cu",
                                                    "metrics_tpu/ops/binned_hist.py:151"),
               "binned_counts_f64[binary]": ("binned_counts", "metrics_tpu_torch/csrc/binned_hist.cu",
                                             "metrics_tpu/ops/binned_hist.py:151"),
               "ssim_window": ("ssim_window", "metrics_tpu_torch/csrc/ssim_window.cu",
                               "metrics_tpu/ops/ssim_window.py:60")}
    kernels = []
    for key, (name, source, replaces) in sources.items():
        row = timing[key]
        err = errs["binned_counts_f64" if key.startswith("binned_counts_f64") else name]
        kernels.append({
            "name": key, "route": "cuda", "source": source, "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })

    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
