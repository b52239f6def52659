"""The CUDA kernels of the port against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; on the card run it without the JAX rig's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import metrics_tpu_torch.classification as tc
from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
from metrics_tpu_torch.functional.image.ssim import _gaussian_taps_np
from metrics_tpu_torch.image import StructuralSimilarityIndexMeasure
from metrics_tpu_torch.ops.binned_hist import (
    binned_counts,
    binned_counts_labels,
    binned_counts_labels_plain,
    binned_counts_plain,
)
from metrics_tpu_torch.ops.ssim_window import ssim_window, ssim_window_plain

# the shapes of tests/test_binned_hist_kernel.py, a main-path shape, one whose classes are tiled over
# blocks (300 classes do not fit a block's shared memory), and one whose buckets are tiled too
# (20,000 thresholds: one class's histogram does not fit, and the thresholds stay in global memory)
BINNED_SHAPES = [(100, 1, 5), (257, 3, 17), (1000, 4, 100), (50, 2, 129), (8, 1, 1), (1 << 16, 10, 200),
                 (4096, 300, 200), (3000, 2, 20000)]
# each output is a sum of 11 + 11 products of values in [0, 1]; the kernel rounds each step as the
# plain version does, so the only licence is for a compiler's different reading of that order
SSIM_ATOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda")


def _binned_args(n, c, t, seed, device):
    rng = np.random.RandomState(seed)
    preds = torch.from_numpy(rng.rand(n, c).astype(np.float32))
    target01 = torch.from_numpy(rng.randint(0, 2, (n, c)).astype(np.int32))
    valid = torch.from_numpy(rng.rand(n, c) > 0.1)
    return [x.to(device) for x in (preds, target01, valid, _adjust_threshold_arg(t))]


@pytest.mark.cuda
@pytest.mark.parametrize(("n", "c", "t"), BINNED_SHAPES)
def test_binned_kernel_matches_plain(cuda_device, n, c, t):
    args = _binned_args(n, c, t, 7, cuda_device)
    before = binned_counts.launches
    got = binned_counts(*args)
    torch.cuda.synchronize()
    assert binned_counts.launches == before + 1
    for g, w in zip(got, binned_counts_plain(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
def test_binned_kernel_matches_plain_at_the_multilabel_width(cuda_device):
    """80 labels at 200 thresholds: the labels are tiled over two blocks (one block's histogram holds 40),
    which takes the one-element-at-a-time loop; -1 targets are masked out and some scores are NaN, as in the
    multilabel curve's update."""
    rng = np.random.RandomState(21)
    n, c = 1 << 16, 80
    preds = rng.rand(n, c).astype(np.float32)
    preds[rng.rand(n, c) < 0.02] = np.nan
    target = np.where(rng.rand(n, c) < 0.1, -1, (rng.rand(n, c) < 0.036).astype(np.int64))
    target = torch.from_numpy(target).to(cuda_device)
    args = [torch.from_numpy(preds).to(cuda_device), target.clamp(0, 1).int().contiguous(),
            (target >= 0).contiguous(), _adjust_threshold_arg(200).to(cuda_device)]
    before = binned_counts.launches
    got = binned_counts(*args)
    torch.cuda.synchronize()
    assert binned_counts.launches == before + 1
    for g, w in zip(got, binned_counts_plain(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _labels_args(n, c, t, seed, device):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n, c).astype(np.float32)
    preds[rng.rand(n, c) < 0.02] = np.nan
    labels = rng.randint(-1, c + 1, n).astype(np.int32)  # -1 ignored, c out of range: a negative of every class
    return [torch.from_numpy(x).to(device) for x in (preds, labels)] + [_adjust_threshold_arg(t).to(device)]


@pytest.mark.cuda
@pytest.mark.parametrize(("n", "c", "t"), [s for s in BINNED_SHAPES if s[1] > 1] + [(1 << 20, 10, 200)])
def test_binned_labels_kernel_matches_plain_and_the_one_hot_mode(cuda_device, n, c, t):
    preds, labels, thresholds = _labels_args(n, c, t, 11, cuda_device)
    before = binned_counts_labels.launches
    got = binned_counts_labels(preds, labels, thresholds)
    torch.cuda.synchronize()
    assert binned_counts_labels.launches == before + 1
    for g, w in zip(got, binned_counts_labels_plain(preds, labels, thresholds)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    target01 = (labels[:, None] == torch.arange(c, device=cuda_device)).int()
    valid = (labels >= 0)[:, None].expand(n, c).contiguous()
    for g, w in zip(got, binned_counts(preds, target01, valid, thresholds)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(("n", "c"), [(1 << 20, 1), (1 << 18, 10)])
def test_binned_kernels_match_plain_on_skewed_scores(cuda_device, n, c):
    """Every score inside one threshold step, or on a threshold: the shared atomics all hit a few cells."""
    rng = np.random.RandomState(3)
    thresholds = _adjust_threshold_arg(200).to(cuda_device)
    preds = (0.5 + 0.004 * rng.rand(n, c)).astype(np.float32)
    preds[rng.rand(n, c) < 0.3] = np.float32(thresholds[100].item())
    preds = torch.from_numpy(preds).to(cuda_device)
    target01 = torch.from_numpy(rng.randint(0, 2, (n, c)).astype(np.int32)).to(cuda_device)
    valid = torch.ones((n, c), dtype=torch.bool, device=cuda_device)
    for g, w in zip(binned_counts(preds, target01, valid, thresholds),
                    binned_counts_plain(preds, target01, valid, thresholds)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if c > 1:
        labels = torch.from_numpy(rng.randint(0, c, n).astype(np.int32)).to(cuda_device)
        for g, w in zip(binned_counts_labels(preds, labels, thresholds),
                        binned_counts_labels_plain(preds, labels, thresholds)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
def test_binned_kernels_match_plain_on_unaligned_inputs(cuda_device):
    """Views one element into their storage: the kernel takes its one-element-at-a-time path."""
    n, c, t = 5000, 3, 50
    args = _binned_args(n + 1, c, t, 5, cuda_device)
    flat = [x.reshape(-1)[1:1 + n * c].view(n, c) for x in args[:3]]
    for g, w in zip(binned_counts(*flat, args[3]), binned_counts_plain(*flat, args[3])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    preds, labels, thresholds = _labels_args(n + 1, c, t, 6, cuda_device)
    preds, labels = preds.reshape(-1)[1:1 + n * c].view(n, c), labels[1:]
    for g, w in zip(binned_counts_labels(preds, labels, thresholds),
                    binned_counts_labels_plain(preds, labels, thresholds)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
def test_binned_kernel_matches_plain_on_edge_values(cuda_device):
    """Threshold ties, NaN and infinite scores, an all-invalid row and a NaN threshold."""
    preds = torch.tensor([[0.0], [0.25], [0.5], [0.5], [1.0], [float("nan")], [0.75], [float("inf")], [-float("inf")]])
    target01 = torch.tensor([[0], [1], [1], [0], [1], [1], [1], [1], [0]], dtype=torch.int32)
    valid = torch.tensor([[True]] * 6 + [[False]] + [[True]] * 2)
    thresholds = torch.tensor([0.0, 0.25, 0.5, 0.5, 1.0, float("nan")])
    args = [x.to(cuda_device) for x in (preds, target01, valid, thresholds)]
    for g, w in zip(binned_counts(*args), binned_counts_plain(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    ("shape", "kh", "kw"),
    [
        ((12, 42, 74), 11, 11),
        ((6, 20, 40), 11, 5),     # Kh != Kw, through the generic instantiation
        ((3, 100, 97), 1, 64),    # 1 tap and 64 taps; odd rows: 4-byte copies
        ((5, 150, 203), 11, 11),  # planes that are not tile multiples, odd rows
        ((4, 77, 90), 7, 7),      # a non-11 window
        ((2, 130, 131), 64, 1),
        ((70_000, 18, 18), 11, 11),  # more planes than a grid's z extent
    ],
)
def test_ssim_kernel_matches_plain(cuda_device, shape, kh, kw):
    x = torch.rand(shape, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    taps_h = np.full(kh, 1.0 / kh, np.float32)
    taps_w = _gaussian_taps_np(kw, 1.5)
    got = ssim_window(x, taps_h, taps_w)
    torch.testing.assert_close(got, ssim_window_plain(x, taps_h, taps_w), rtol=0, atol=SSIM_ATOL)


@pytest.mark.cuda
def test_ssim_kernel_matches_plain_on_unaligned_planes(cuda_device):
    """Planes one float into their storage: even rows, but only 4-byte aligned."""
    n, h, w = 3, 80, 90
    x = torch.rand(n * h * w + 1, generator=torch.Generator().manual_seed(1)).to(cuda_device)[1:].view(n, h, w)
    taps = _gaussian_taps_np(11, 1.5)
    torch.testing.assert_close(ssim_window(x, taps, taps), ssim_window_plain(x, taps, taps), rtol=0, atol=SSIM_ATOL)


def _float64_near_thresholds(shape, t, seed):
    """float64 scores: a third uniform, a third on the float64 grid, a third within half a float32 ulp of it
    (above and below), and a few NaNs; with the (T,) float64 grid."""
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _linspace_thresholds

    rng = np.random.RandomState(seed)
    grid = _linspace_thresholds(t, torch.float64)
    on = grid[rng.randint(0, t, shape)]
    half_ulp = np.spacing(np.abs(on).astype(np.float32)).astype(np.float64) / 4
    near = on + np.where(rng.rand(*shape) < 0.5, -1, 1) * half_ulp * rng.rand(*shape)
    which = rng.randint(0, 3, shape)
    preds = np.where(which == 0, rng.rand(*shape), np.where(which == 1, on, near))
    preds[rng.rand(*shape) < 0.01] = np.nan
    return torch.from_numpy(preds), torch.from_numpy(grid)


@pytest.mark.cuda
@pytest.mark.parametrize(("n", "c", "t"), [(1000, 1, 5), (257, 3, 17), (1 << 16, 10, 200), (4096, 300, 200),
                                           (3000, 2, 20000), (1 << 18, 80, 200), (1 << 22, 1, 200)])
def test_binned_kernel_float64_matches_plain_in_both_modes(cuda_device, n, c, t):
    """The float64 instantiation compares in float64: scores on a threshold and within half a float32 ulp of
    one count as the plain version (float64 searchsorted) counts them, in the (N, C) and the labels mode."""
    preds, thresholds = _float64_near_thresholds((n, c), t, 5)
    preds, thresholds = preds.to(cuda_device), thresholds.to(cuda_device)
    rng = np.random.RandomState(6)
    target01 = torch.from_numpy(rng.randint(0, 2, (n, c)).astype(np.int32)).to(cuda_device)
    valid = torch.from_numpy(rng.rand(n, c) > 0.1).to(cuda_device)
    before = binned_counts.launches
    got = binned_counts(preds, target01, valid, thresholds)
    torch.cuda.synchronize()
    assert binned_counts.launches == before + 1
    for g, w in zip(got, binned_counts_plain(preds, target01, valid, thresholds)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if c > 1:
        labels = torch.from_numpy(rng.randint(-1, c + 1, n).astype(np.int32)).to(cuda_device)
        before = binned_counts_labels.launches
        got = binned_counts_labels(preds, labels, thresholds)
        torch.cuda.synchronize()
        assert binned_counts_labels.launches == before + 1
        for g, w in zip(got, binned_counts_labels_plain(preds, labels, thresholds)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
def test_binned_kernel_float64_differs_from_float32_where_it_should(cuda_device):
    """Scores just below a threshold, by less than half a float32 ulp: float64 does not count them, a
    float32 compare of the rounded scores would; the kernel gives the float64 counts."""
    thresholds = torch.tensor([0.1, 0.3, 0.7], dtype=torch.float64, device=cuda_device)
    preds = (thresholds - 1e-12).repeat(5)[:, None]
    target01 = torch.ones_like(preds, dtype=torch.int32)
    valid = torch.ones_like(preds, dtype=torch.bool)
    tp = binned_counts(preds, target01, valid, thresholds)[0]
    tp32 = binned_counts_plain(preds.float(), target01, valid, thresholds.float())[0]
    assert tp.cpu().tolist() == [[10, 5, 0]]
    assert tp32.tolist() == [[15, 10, 5]]


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    args = _binned_args(16, 2, 5, 0, cuda_device)
    with pytest.raises(TypeError, match="target01"):
        binned_counts(args[0], args[1].long(), args[2], args[3])
    with pytest.raises(TypeError, match="float64 with float64"):
        binned_counts(args[0].double(), args[1], args[2], args[3])
    with pytest.raises(TypeError, match="float64 with float64"):
        binned_counts_labels(args[0], args[1][:, 0].contiguous(), args[3].double())
    with pytest.raises(ValueError, match="taps"):
        ssim_window(torch.rand(2, 80, 80, device=cuda_device), [0.01] * 65, [1.0])


@pytest.mark.cuda
def test_slice_on_card_goes_through_both_kernels(cuda_device):
    binned_counts.launches = binned_counts_labels.launches = ssim_window.launches = 0
    rng = np.random.RandomState(0)
    prc = tc.BinaryPrecisionRecallCurve(thresholds=50, device=cuda_device)
    prc.update(torch.from_numpy(rng.rand(1000).astype(np.float32)).to(cuda_device),
               torch.from_numpy(rng.randint(0, 2, 1000)).to(cuda_device))
    ssim = StructuralSimilarityIndexMeasure(data_range=1.0, device=cuda_device)
    ssim.update(torch.rand(2, 3, 32, 32, device=cuda_device), torch.rand(2, 3, 32, 32, device=cuda_device))
    mc = tc.MulticlassPrecisionRecallCurve(num_classes=4, thresholds=20, device=cuda_device)
    mc.update(torch.from_numpy(rng.rand(500, 4).astype(np.float32)).to(cuda_device),
              torch.from_numpy(rng.randint(0, 4, 500)).to(cuda_device))
    prc.compute()
    ssim.compute()
    mc.compute()
    assert binned_counts.launches == 1 and ssim_window.launches == 1 and binned_counts_labels.launches == 1
    binned_counts.launches = binned_counts_labels.launches = 0
    ml = tc.MultilabelAveragePrecision(num_labels=80, thresholds=200, device=cuda_device)
    for _ in range(2):
        ml.update(torch.from_numpy(rng.rand(300, 80).astype(np.float32)).to(cuda_device),
                  torch.from_numpy(rng.randint(0, 2, (300, 80))).to(cuda_device))
    assert bool(torch.isfinite(ml.compute()))
    assert binned_counts.launches == 2 and binned_counts_labels.launches == 0


@pytest.mark.cuda
def test_stat_score_family_on_card_matches_cpu_and_launches_no_kernel(cuda_device):
    """Every class of the stat-score and confusion-matrix family, through its task wrapper for each task,
    on the card against the CPU: counters equal, scores within rtol 1e-5 (float sums within 1e-4), and no
    kernel launched."""
    rng = np.random.RandomState(30)
    n, c = 4096, 10
    data = {"binary": (rng.randn(n).astype(np.float32), rng.randint(0, 2, n)),
            "multiclass": (rng.randn(n, c).astype(np.float32), rng.randint(0, c, n)),
            "multilabel": (rng.randn(n, c).astype(np.float32), rng.randint(0, 2, (n, c)))}
    sizes = {"binary": {}, "multiclass": {"num_classes": c}, "multilabel": {"num_labels": c}}
    three = ("binary", "multiclass", "multilabel")
    classes = [(tc.Precision, {}, three), (tc.Recall, {}, three), (tc.FBetaScore, {"beta": 0.5}, three),
               (tc.F1Score, {}, three), (tc.Specificity, {}, three), (tc.NegativePredictiveValue, {}, three),
               (tc.HammingDistance, {}, three), (tc.ConfusionMatrix, {"normalize": "true"}, three),
               (tc.JaccardIndex, {}, three), (tc.MatthewsCorrCoef, {}, three),
               (tc.ExactMatch, {}, ("multiclass", "multilabel")), (tc.CohenKappa, {"weights": "linear"},
                                                                   ("binary", "multiclass")),
               (tc.CalibrationError, {}, ("binary", "multiclass")), (tc.HingeLoss, {}, ("binary", "multiclass"))]
    metrics = [(f"{cls.__name__}[{task}]", task, lambda d, cls=cls, task=task, extra=extra:
                cls(task=task, device=d, **sizes[task], **extra)) for cls, extra, tasks in classes for task in tasks]
    metrics += [(f"{cls.__name__}", "multilabel", lambda d, cls=cls: cls(num_labels=c, device=d))
                for cls in (tc.MultilabelCoverageError, tc.MultilabelRankingAveragePrecision,
                            tc.MultilabelRankingLoss)]
    metrics.append(("Dice", "multiclass", lambda d: tc.Dice(average="macro", num_classes=c, device=d)))
    binned_counts.launches = binned_counts_labels.launches = ssim_window.launches = 0
    for name, task, make in metrics:
        preds, target = (torch.from_numpy(x) for x in data[task])
        gpu, cpu = make(cuda_device), make("cpu")
        gpu.update(preds.to(cuda_device), target.to(cuda_device))
        cpu.update(preds, target)
        got, want = gpu.compute().cpu(), cpu.compute()
        summed = name.startswith(("CalibrationError", "HingeLoss"))
        assert got.dtype == want.dtype, name
        torch.testing.assert_close(got, want, rtol=1e-4 if summed else 1e-5, atol=1e-6, msg=name)
    torch.cuda.synchronize()
    assert binned_counts.launches == binned_counts_labels.launches == ssim_window.launches == 0


@pytest.mark.cuda
def test_float64_auroc_on_card_goes_through_the_float64_kernel(cuda_device):
    """Under torch's float64 default, float64 scores reach the float64 binned counts, one launch per update,
    and count as on the CPU."""
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        preds, grid = _float64_near_thresholds((1 << 16,), 200, 31)
        target = torch.from_numpy(np.random.RandomState(32).randint(0, 2, 1 << 16))
        gpu = tc.BinaryAUROC(thresholds=200, device=cuda_device)
        cpu = tc.BinaryAUROC(thresholds=200, device="cpu")
        preds = torch.nan_to_num(preds, nan=0.5)
        binned_counts.launches = 0
        for part in (slice(0, 1 << 15), slice(1 << 15, None)):
            gpu.update(preds[part].to(cuda_device), target[part].to(cuda_device))
            cpu.update(preds[part], target[part])
        assert binned_counts.launches == 2
        torch.testing.assert_close(gpu.confmat.cpu(), cpu.confmat, rtol=0, atol=0)
        torch.testing.assert_close(gpu.compute().cpu(), cpu.compute(), rtol=1e-5, atol=1e-6)
    finally:
        torch.set_default_dtype(previous)
