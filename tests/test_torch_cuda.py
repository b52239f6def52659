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
from metrics_tpu_torch import MetricCollection
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


# ----------------------------------------------------------------------------- collections and sync on the card
def _coco_collection(device, compute_groups):
    return MetricCollection([tc.MultilabelAveragePrecision(num_labels=80, thresholds=200, device=device),
                             tc.MultilabelAUROC(num_labels=80, thresholds=200, device=device)],
                            compute_groups=compute_groups)


@pytest.mark.cuda
@pytest.mark.parametrize(("compute_groups", "launches"), [
    ([["MultilabelAveragePrecision", "MultilabelAUROC"]], 3),  # the leader alone, every update
    (True, 4),  # the first update runs both members to find the group, then the leader alone
    (False, 6),
])
def test_compute_groups_launch_the_binned_kernel_once_per_group(cuda_device, compute_groups, launches):
    rng = np.random.RandomState(1)
    batches = [(rng.rand(2000, 80).astype(np.float32), (rng.rand(2000, 80) < 0.05).astype(np.int64))
               for _ in range(3)]
    gpu, cpu = _coco_collection(cuda_device, compute_groups), _coco_collection("cpu", compute_groups)
    binned_counts.launches = 0
    for p, t in batches:
        gpu.update(torch.from_numpy(p).to(cuda_device), torch.from_numpy(t).to(cuda_device))
        cpu.update(torch.from_numpy(p), torch.from_numpy(t))
    got, want = gpu.compute(), cpu.compute()
    torch.cuda.synchronize()
    assert binned_counts.launches == launches
    for key in want:
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-5, atol=1e-6)


def _open_host_read():
    from metrics_tpu_torch.observe import tracing

    return next((s.label for s in reversed(tracing._stack()) if s.phase == "host_read"), None)


@pytest.mark.cuda
@pytest.mark.parametrize("thresholds", [200, None], ids=["binned", "exact"])
def test_every_sync_of_a_curve_and_ece_update_is_inside_a_host_read_span(cuda_device, thresholds):
    """Under CUDA's sync debug mode, each synchronizing call of an update of the Criteo evaluation's collection
    happens while one of the program's ``host_read`` spans is open: one site a compute group, two syncs each
    (``torch.unique``'s size, then the copy of its values)."""
    import warnings

    from metrics_tpu_torch import observe

    col = MetricCollection(
        {"auroc": tc.BinaryAUROC(thresholds=thresholds, device=cuda_device),
         "ap": tc.BinaryAveragePrecision(thresholds=thresholds, device=cuda_device),
         "ece": tc.BinaryCalibrationError(n_bins=15, norm="l1", device=cuda_device)},
        compute_groups=[["auroc", "ap"], ["ece"]],
    )
    g = torch.Generator(device=cuda_device)
    g.manual_seed(3)
    preds = torch.rand(1 << 20, generator=g, device=cuda_device)
    target = (torch.rand(1 << 20, generator=g, device=cuda_device) < 0.3).long()
    col.update(preds, target)  # every kernel loaded before the counted update
    torch.cuda.synchronize()
    seen = []

    def show(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            seen.append(_open_host_read())

    observe.enable(reset=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                col.update(preds, target)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        observe.disable()
        observe.reset()
    assert sorted(seen) == ["binary_confusion_matrix.target"] * 2 + ["binary_precision_recall_curve.target"] * 2


def _regression_shards(ranks, seed=2):
    rng = np.random.RandomState(seed)
    out = []
    for n in ranks:
        y = rng.randn(n).astype(np.float32)
        out.append((torch.from_numpy((0.7 * y + 0.5 * rng.randn(n)).astype(np.float32)), torch.from_numpy(y)))
    return out


@pytest.mark.cuda
def test_nccl_world_of_one_sync_keeps_every_state(cuda_device, tmp_path):
    import torch.distributed as dist

    from metrics_tpu_torch import CatMetric, MeanMetric, SumMetric
    from metrics_tpu_torch.regression import MeanSquaredError, PearsonCorrCoef, SpearmanCorrCoef

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        (x, y), = _regression_shards([5000])
        x, y = x.to(cuda_device), y.to(cuda_device)
        metrics = [MeanSquaredError(device=cuda_device), PearsonCorrCoef(device=cuda_device),
                   SpearmanCorrCoef(device=cuda_device), MeanMetric(device=cuda_device),
                   SumMetric(device=cuda_device), CatMetric(device=cuda_device),
                   tc.BinaryFairness(num_groups=5, device=cuda_device),
                   tc.MulticlassConfusionMatrix(num_classes=7, device=cuda_device)]
        groups = torch.randint(0, 5, (5000,), device=cuda_device)
        for metric in metrics:
            if isinstance(metric, tc.BinaryFairness):
                metric.update(torch.sigmoid(x), (y > 0).long(), groups)
            elif isinstance(metric, tc.MulticlassConfusionMatrix):
                metric.update((x.abs() * 3).long().clamp(0, 6), (y.abs() * 3).long().clamp(0, 6))
            elif isinstance(metric, (MeanMetric, SumMetric, CatMetric)):
                metric.update(x)
            else:
                metric.update(x, y)
        for metric in metrics:
            local = {k: (torch.cat(v) if isinstance(v, list) else v) for k, v in metric.metric_state.items()}
            value = metric.compute()
            metric.sync(distributed_available=True)
            for key, before in local.items():
                after = metric.metric_state[key]
                assert after.device.type == "cuda"
                if isinstance(metric, PearsonCorrCoef):
                    assert torch.equal(after, before.unsqueeze(0))  # one replica deep
                else:
                    assert torch.equal(after, before), (type(metric).__name__, key)
            metric.unsync()
            assert all(v is not None for v in metric.metric_state.values())
            metric._computed = None
            metric.distributed_available_fn = lambda: True
            again = metric.compute()
            for a, b in (zip(again.values(), value.values()) if isinstance(value, dict) else [(again, value)]):
                assert torch.equal(a, b), type(metric).__name__
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_fan_in_of_four_ranks_on_the_card_equals_the_single_stream(cuda_device):
    from metrics_tpu_torch import CatMetric, MeanMetric
    from metrics_tpu_torch.parallel import allreduce_over_mesh
    from metrics_tpu_torch.regression import MeanSquaredError, PearsonCorrCoef, SpearmanCorrCoef

    sizes = [3000, 500, 4100, 1200]
    shards = [(x.to(cuda_device), y.to(cuda_device)) for x, y in _regression_shards(sizes)]
    runs = [(MeanSquaredError, 1e-5, False), (MeanMetric, 1e-5, False), (PearsonCorrCoef, 1e-4, False),
            (SpearmanCorrCoef, 1e-4, True), (CatMetric, 0.0, True)]
    for cls, rtol, empty_rank in runs:
        ranks, whole = [cls(device=cuda_device) for _ in sizes], cls(device=cuda_device)
        for rank, (x, y) in enumerate(shards):
            args = (x,) if cls in (MeanMetric, CatMetric) else (x, y)
            whole.update(*args)
            if not (empty_rank and rank == 1):
                ranks[rank].update(*args)
        if empty_rank:  # the single stream without rank 1's shard
            whole = cls(device=cuda_device)
            for rank, (x, y) in enumerate(shards):
                if rank != 1:
                    whole.update(*((x,) if cls is CatMetric else (x, y)))
        merged = allreduce_over_mesh([m.metric_state for m in ranks], ranks[0]._reductions)
        folded = cls(device=cuda_device).load_merged_state(merged, update_count=len(sizes))
        torch.testing.assert_close(folded.compute(), whole.compute(), rtol=rtol, atol=1e-6 if rtol else 0.0)


def _gloo_world_on_the_card(world, tmp_path):
    """Every case of tests/_torch_sync_workers.py in ``world`` processes on the one card."""
    import pickle

    import torch.multiprocessing as mp

    import _torch_sync_workers as workers

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=workers.run, args=(rank, world, str(tmp_path / "store"), str(tmp_path), "cuda"),
                         daemon=True) for rank in range(world)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(300)
    alive = [proc.is_alive() for proc in procs]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    assert not any(alive) and [proc.exitcode for proc in procs] == [0] * world
    for rank in range(world):
        results = pickle.loads((tmp_path / f"{rank}.pkl").read_bytes())
        assert results == {name: "ok" for name in workers.case_names()}, results


@pytest.mark.cuda
def test_gloo_sync_of_two_ranks_on_one_card(cuda_device, tmp_path):
    """Every case of tests/_torch_sync_workers.py with the states on the card: two processes share the one
    device in a gloo group (NCCL takes one rank per device), each held against the single stream."""
    _gloo_world_on_the_card(2, tmp_path)


@pytest.mark.cuda
def test_gloo_subgroup_sync_of_four_ranks_on_one_card(cuda_device, tmp_path):
    """Four processes on the one card, laid out as (model 2, data 2): the subgroup case syncs each rank over
    its data row's ``dist.new_group`` only; every other case runs in the world of four."""
    _gloo_world_on_the_card(4, tmp_path)


# ----------------------------------------------------------------------------- retrieval, detection, bootstrap
def _retrieval_rows(seed, n=5000, queries=300):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n).astype(np.float32)
    preds[::7] = 0.5
    return (torch.from_numpy(rng.randint(-5, queries, n)), torch.from_numpy(preds),
            torch.from_numpy((rng.rand(n) < 0.1).astype(np.int64)), torch.from_numpy(rng.randint(0, 4, n)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalMRR", "RetrievalNormalizedDCG", "RetrievalRecall",
                                  "RetrievalAUROC", "RetrievalPrecisionRecallCurve"])
def test_retrieval_on_card_matches_cpu(cuda_device, name):
    import metrics_tpu_torch.retrieval as tr

    kw = {"top_k": 10} if name in ("RetrievalMRR", "RetrievalNormalizedDCG", "RetrievalRecall") else {}
    values = {}
    for device in ("cpu", "cuda"):
        metric = getattr(tr, name)(device=device, **kw)
        for seed in (0, 1):
            idx, preds, binary, graded = _retrieval_rows(seed)
            metric.update(preds, graded if name == "RetrievalNormalizedDCG" else binary, indexes=idx)
        values[device] = metric.compute()
    got = values["cuda"] if isinstance(values["cuda"], tuple) else (values["cuda"],)
    want = values["cpu"] if isinstance(values["cpu"], tuple) else (values["cpu"],)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-7)


def _detection_images(seed, n=40):
    rng = np.random.RandomState(seed)
    images = []
    for _ in range(n):
        ng = rng.randint(0, 8)
        gb = rng.rand(ng, 4) * 300
        gb[:, 2:] = gb[:, :2] + 2 + rng.rand(ng, 2) * 150
        nd = ng + rng.randint(0, 5)
        db = np.concatenate([gb + rng.randn(ng, 4) * 4, rng.rand(nd - ng, 4) * 300])
        db[:, 2:] = np.maximum(db[:, 2:], db[:, :2] + 2)
        glab = rng.randint(0, 5, ng)
        images.append(({"boxes": torch.from_numpy(db), "scores": torch.from_numpy(rng.rand(nd)),
                        "labels": torch.from_numpy(np.concatenate([glab, rng.randint(0, 5, nd - ng)]))},
                       {"boxes": torch.from_numpy(gb), "labels": torch.from_numpy(glab),
                        "iscrowd": torch.from_numpy((rng.rand(ng) < 0.05).astype(np.int64))}))
    return images


@pytest.mark.cuda
def test_map_on_card_matches_cpu(cuda_device):
    from metrics_tpu_torch.detection import MeanAveragePrecision

    images = _detection_images(0)
    values = {}
    for device in ("cpu", "cuda"):
        metric = MeanAveragePrecision(device=device, class_metrics=True)
        metric.update([p for p, _ in images], [t for _, t in images])
        values[device] = metric.compute()
    for key, want in values["cpu"].items():
        assert values["cuda"][key].device.type == "cuda"
        torch.testing.assert_close(values["cuda"][key].cpu(), want, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_iou_and_matching_run_on_card_and_match_cpu(cuda_device):
    from metrics_tpu_torch.functional.detection import intersection_over_union
    from metrics_tpu_torch.functional.detection.map_matching import batched_box_iou, match_units

    rng = np.random.RandomState(1)
    db = torch.from_numpy(rng.rand(64, 20, 4) * 100)
    db[..., 2:] += db[..., :2]
    gb = torch.from_numpy(rng.rand(64, 12, 4) * 100)
    gb[..., 2:] += gb[..., :2]
    crowd = torch.from_numpy(rng.rand(64, 12) < 0.1)
    ious = {d: batched_box_iou(db.to(d), gb.to(d), crowd.to(d)) for d in ("cpu", "cuda")}
    assert ious["cuda"].device.type == "cuda" and torch.equal(ious["cuda"].cpu(), ious["cpu"])
    masks = [torch.from_numpy(x) for x in (rng.rand(64, 12) < 0.9, crowd.numpy(), rng.rand(64, 4, 12) < 0.2,
                                           rng.rand(64, 20) < 0.9, rng.rand(64, 4, 20) < 0.2)]
    thr = torch.linspace(0.5, 0.95, 10, dtype=torch.float64)
    flags = {d: match_units(ious[d], *[m.to(d) for m in masks], thr) for d in ("cpu", "cuda")}
    for got, want in zip(flags["cuda"], flags["cpu"]):
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    pair = [intersection_over_union(db[0].to(d), gb[0, :1].expand(20, 4).to(d), aggregate=False) for d in ("cpu", "cuda")]
    torch.testing.assert_close(pair[1].cpu(), pair[0], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_bootstrapper_draws_the_same_indices_on_both_devices(cuda_device):
    from metrics_tpu_torch.wrappers import BootStrapper

    rng = np.random.RandomState(2)
    batches = [(torch.from_numpy(rng.randint(0, 10, 500)), torch.from_numpy(rng.randint(0, 10, 500)))
               for _ in range(3)]
    wrappers = {}
    for device in ("cpu", "cuda"):
        np.random.seed(11)
        wrappers[device] = BootStrapper(tc.MulticlassAccuracy(num_classes=10, average="micro", device=device),
                                        num_bootstraps=6, quantile=[0.1, 0.9], raw=True)
        for p, t in batches:
            wrappers[device].update(p.to(device), t.to(device))
    for got, want in zip(wrappers["cuda"].metrics, wrappers["cpu"].metrics):
        for key, value in want.metric_state.items():
            assert torch.equal(got.metric_state[key].cpu(), value), key
    out = {d: w.compute() for d, w in wrappers.items()}
    for key, want in out["cpu"].items():
        torch.testing.assert_close(out["cuda"][key].cpu(), want, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(15, 179, 265), (15, 94, 137), (15, 40, 51), (3, 20, 21)],
                         ids=["div2k-scale4", "div2k-scale5", "under-a-tile", "tiny"])
def test_ssim_kernel_matches_plain_at_ms_ssim_planes(cuda_device, shape):
    """MS-SSIM's small scales: odd padded widths (4-byte copies) and planes smaller than one 64 x 64 tile."""
    x = torch.rand(shape, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    taps = _gaussian_taps_np(11, 1.5)
    before = ssim_window.launches
    got = ssim_window(x, taps, taps)
    assert ssim_window.launches == before + 1
    torch.testing.assert_close(got, ssim_window_plain(x, taps, taps), rtol=0, atol=SSIM_ATOL)


@pytest.mark.cuda
def test_ms_ssim_on_card_matches_cpu_with_one_launch_a_scale(cuda_device):
    from metrics_tpu_torch.image import MultiScaleStructuralSimilarityIndexMeasure

    rng = np.random.RandomState(3)
    batches = []
    for _ in range(2):
        a = rng.rand(2, 3, 200, 231).astype(np.float32)
        batches.append((torch.from_numpy(a), torch.from_numpy((0.8 * a + 0.2 * rng.rand(*a.shape)).astype(np.float32))))
    values = {}
    for device in ("cpu", "cuda"):
        metric = MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, reduction="none", device=device)
        before = ssim_window.launches
        for a, b in batches:
            metric.update(a.to(device), b.to(device))
        values[device] = metric.compute()
        assert ssim_window.launches - before == (10 if device == "cuda" else 0)
    assert values["cuda"].device.type == "cuda"
    torch.testing.assert_close(values["cuda"].cpu(), values["cpu"], rtol=0, atol=1e-5)


def _segm_images(seed, n=24):
    """Filled ellipses as ground truths, noisy copies and stray ellipses as detections, on two image sizes and,
    for the last image, a third (a size group of at most three units: the float64 quotient)."""
    rng = np.random.RandomState(seed)
    images = []
    for i in range(n):
        h, w = (40, 56) if i == n - 1 else (48, 64) if i % 3 else (64, 48)
        yy, xx = np.mgrid[:h, :w]

        def ellipses(k):
            c = rng.rand(k, 2) * [w, h]
            r = 2 + rng.rand(k, 2) * [w / 3, h / 3]
            return ((xx + 0.5 - c[:, 0, None, None]) / r[:, 0, None, None]) ** 2 \
                + ((yy + 0.5 - c[:, 1, None, None]) / r[:, 1, None, None]) ** 2 <= 1

        ng = rng.randint(1, 6)
        gm = ellipses(ng)
        nd = ng + rng.randint(0, 4)
        dm = np.concatenate([gm ^ (rng.rand(ng, h, w) < 0.03), ellipses(nd - ng)])
        glab = rng.randint(0, 3, ng)
        images.append(({"masks": torch.from_numpy(dm), "scores": torch.from_numpy(rng.rand(nd)),
                        "labels": torch.from_numpy(np.concatenate([glab, rng.randint(0, 3, nd - ng)]))},
                       {"masks": torch.from_numpy(gm), "labels": torch.from_numpy(glab),
                        "iscrowd": torch.from_numpy((rng.rand(ng) < 0.1).astype(np.int64))}))
    return images


@pytest.mark.cuda
def test_segm_map_on_card_matches_cpu(cuda_device):
    from metrics_tpu_torch.detection import MeanAveragePrecision

    images = _segm_images(4)
    metrics, values = {}, {}
    for device in ("cpu", "cuda"):
        metric = MeanAveragePrecision(iou_type="segm", extended_summary=True, device=device)
        metric.update([{k: v.to(device) for k, v in p.items()} for p, _ in images],
                      [{k: v.to(device) for k, v in t.items()} for _, t in images])
        metrics[device], values[device] = metric, metric.compute()
    assert metrics["cuda"].detection_rle == metrics["cpu"].detection_rle
    stages = metrics["cuda"].last_evaluation["segm"]
    assert stages["f32_iou_units"] > 0 and stages["f64_iou_units"] > 0 and stages["mask_iou_device_s"] > 0
    assert stages["match_device_s"] > 0
    for key, want in values["cpu"].items():
        if isinstance(want, dict):  # the IoU matrices, bit for bit
            for k, v in want.items():
                assert torch.equal(values["cuda"][key][k].cpu(), v), k
            continue
        assert values["cuda"][key].device.type == "cuda"
        torch.testing.assert_close(values["cuda"][key].cpu(), want, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_panoptic_pixel_pass_on_card_matches_cpu(cuda_device):
    from metrics_tpu_torch.detection import ModifiedPanopticQuality, PanopticQuality
    from metrics_tpu_torch.detection.panoptic_quality import _segment_pairs

    rng = np.random.RandomState(5)
    target = np.zeros((4, 60, 80, 2), np.int64)
    target[..., 0] = rng.choice([10, 11], (4, 1, 1))
    for b in range(4):
        for inst in range(5):
            y, x = rng.randint(0, 50), rng.randint(0, 70)
            target[b, y:y + rng.randint(5, 30), x:x + rng.randint(5, 30)] = (rng.randint(1, 4), inst)
    preds = np.roll(target, (2, -3), axis=(1, 2))
    preds, target = torch.from_numpy(preds), torch.from_numpy(target)
    stuffs = torch.tensor([10, 11])
    pairs = {d: _segment_pairs(preds.to(d), target.to(d), stuffs.to(d)) for d in ("cpu", "cuda")}
    for got, want in zip(pairs["cuda"], pairs["cpu"]):
        np.testing.assert_array_equal(got, want)
    for cls in (PanopticQuality, ModifiedPanopticQuality):
        out = {}
        for device in ("cpu", "cuda"):
            metric = cls({1, 2, 3}, {10, 11}, return_sq_and_rq=True, device=device)
            metric.update(preds.to(device), target.to(device))
            out[device] = metric
        for key in ("iou_sum", "true_positives", "false_positives", "false_negatives"):
            assert torch.equal(getattr(out["cuda"], key).cpu(), getattr(out["cpu"], key)), key
        torch.testing.assert_close(out["cuda"].compute().cpu(), out["cpu"].compute(), rtol=1e-6, atol=0)


# ----------------------------------------------------------------------------- regression and wrappers on the card
@pytest.mark.cuda
def test_wrapped_binned_metrics_launch_once_per_update(cuda_device):
    """ClasswiseWrapper over 80-label AP and both input transformers around BinaryAUROC: one binned-counts launch
    an update each, and the unwrapped metric's values on the transformed inputs."""
    import metrics_tpu_torch.wrappers as tw

    rng = np.random.RandomState(40)
    labels = [f"label{i}" for i in range(80)]
    wrapped = tw.ClasswiseWrapper(tc.MultilabelAveragePrecision(num_labels=80, thresholds=200, average=None,
                                                                device=cuda_device), labels=labels)
    plain = tc.MultilabelAveragePrecision(num_labels=80, thresholds=200, average=None, device=cuda_device)
    batches = [(torch.from_numpy(rng.rand(3000, 80).astype(np.float32)).to(cuda_device),
                torch.from_numpy((rng.rand(3000, 80) < 0.05).astype(np.int64)).to(cuda_device)) for _ in range(3)]
    binned_counts.launches = binned_counts_labels.launches = 0
    for p, t in batches:
        wrapped.update(p, t)
    got = wrapped.compute()
    torch.cuda.synchronize()
    assert binned_counts.launches == 3 and binned_counts_labels.launches == 0
    for p, t in batches:
        plain.update(p, t)
    assert list(got) == [f"multilabelaverageprecision_{lab}" for lab in labels]
    assert torch.equal(torch.stack(list(got.values())), plain.compute())

    logits = [torch.from_numpy(rng.randn(1 << 16).astype(np.float32)).to(cuda_device) for _ in range(2)]
    soft = [torch.from_numpy(rng.rand(1 << 16).astype(np.float32)).to(cuda_device) for _ in range(2)]
    for wrapper, transform in (
        (tw.LambdaInputTransformer(tc.BinaryAUROC(thresholds=200, device=cuda_device), transform_pred=torch.sigmoid),
         lambda p, t: (torch.sigmoid(p), (t > 0.5).long())),
        (tw.BinaryTargetTransformer(tc.BinaryAUROC(thresholds=200, device=cuda_device), threshold=0.5),
         lambda p, t: (p, (t > 0.5).long())),
    ):
        reference = tc.BinaryAUROC(thresholds=200, device=cuda_device)
        binned_counts.launches = 0
        for p, t in zip(logits, soft):
            wrapper.update(p, (t > 0.5).long() if isinstance(wrapper, tw.LambdaInputTransformer) else t)
        value = wrapper.compute()
        torch.cuda.synchronize()
        assert binned_counts.launches == 2
        for p, t in zip(logits, soft):
            reference.update(*transform(p, t))
        assert torch.equal(value, reference.compute())


@pytest.mark.cuda
def test_regression_and_wrappers_on_card_match_cpu(cuda_device):
    """The new regression classes and MultioutputWrapper with NaNs on the card against the same inputs on the
    CPU: counts equal, Kendall exact, float sums within rtol 1e-5."""
    import metrics_tpu_torch.regression as tr
    import metrics_tpu_torch.wrappers as tw

    rng = np.random.RandomState(41)
    makers = {
        "ExplainedVariance": lambda d: tr.ExplainedVariance(device=d),
        "NRMSE": lambda d: tr.NormalizedRootMeanSquaredError(normalization="std", device=d),
        "Concordance": lambda d: tr.ConcordanceCorrCoef(device=d),
        "R2": lambda d: tr.R2Score(device=d),
        "MAPE": lambda d: tr.MeanAbsolutePercentageError(device=d),
        "Tweedie": lambda d: tr.TweedieDevianceScore(power=1.5, device=d),
        "Kendall": lambda d: tr.KendallRankCorrCoef(variant="b", device=d),
    }
    batches = []
    for _ in range(3):
        t = np.exp(rng.randn(3000)).astype(np.float32)
        batches.append(((t * np.exp(0.2 * rng.randn(3000))).astype(np.float32), np.round(t, 1)))
    for name, make in makers.items():
        gpu, cpu = make(cuda_device), make("cpu")
        for p, t in batches:
            gpu.update(torch.from_numpy(p).to(cuda_device), torch.from_numpy(t).to(cuda_device))
            cpu.update(torch.from_numpy(p), torch.from_numpy(t))
        got, want = gpu.compute(), cpu.compute()
        assert got.device.type == "cuda", name
        if name == "Kendall":
            assert torch.equal(got.cpu(), want), name
        else:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6, msg=name)
    csi = {d: tr.CriticalSuccessIndex(74.0, keep_sequence_dim=1, device=d) for d in ("cpu", "cuda")}
    vil = rng.randint(0, 255, (2, 12, 64, 64)).astype(np.float32)
    for d, metric in csi.items():
        metric.update(torch.from_numpy(vil).to(d), torch.from_numpy(np.roll(vil, 3, axis=-1)).to(d))
    for key in ("hits", "misses", "false_alarms"):
        assert torch.equal(csi["cuda"].metric_state[key][0].cpu(), csi["cpu"].metric_state[key][0])
    multi = {d: tw.MultioutputWrapper(tr.R2Score(device=d), num_outputs=12) for d in ("cpu", "cuda")}
    x = rng.randn(4096, 12).astype(np.float32)
    y = (x + 0.3 * rng.randn(4096, 12)).astype(np.float32)
    y[rng.rand(4096, 12) < 0.01] = np.nan
    for d, metric in multi.items():
        metric.update(torch.from_numpy(x).to(d), torch.from_numpy(y).to(d))
    assert [int(m.total) for m in multi["cuda"].metrics] == [int(m.total) for m in multi["cpu"].metrics]
    torch.testing.assert_close(multi["cuda"].compute().cpu(), multi["cpu"].compute(), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_wrapper_refuses_metrics_on_the_card_and_the_cpu(cuda_device):
    import metrics_tpu_torch.regression as tr
    import metrics_tpu_torch.wrappers as tw

    with pytest.raises(ValueError, match="one device"):
        tw.MultitaskWrapper({"a": tr.MeanSquaredError(device=cuda_device), "b": tr.MeanSquaredError(device="cpu")})
    with pytest.raises(ValueError, match="one device"):
        tw.MinMaxMetric(tr.MeanSquaredError(device=cuda_device), device="cpu")
    assert tw.MetricTracker(tr.MeanSquaredError(device=cuda_device)).device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize(
    ("shape", "taps"),
    [
        ((4, 512, 768), ("gauss", 17)),  # VIF's scale-0 window on its LIVE planes
        ((6, 130, 200), ("gauss", 9)),
        ((6, 70, 90), ("gauss", 5)),
        ((7, 33, 47), ("gauss", 3)),     # a plane under one 64 x 64 tile
        ((10, 263, 263), ("uniform", 8)),  # the scipy-style uniform filter and SCC's window on 256 x 256
        ((10, 262, 262), ("uniform", 7)),
    ],
)
def test_window_kernel_matches_plain_at_the_image_metrics_windows(cuda_device, shape, taps):
    kind, n = taps
    k = _gaussian_taps_np(n, n / 5.0) if kind == "gauss" else np.full(n, np.float32(1) / np.float32(n), np.float32)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(n)).to(cuda_device)
    before = ssim_window.launches
    got = ssim_window(x, k, k)
    torch.cuda.synchronize()
    assert ssim_window.launches == before + 1
    torch.testing.assert_close(got, ssim_window_plain(x, k, k), rtol=0, atol=SSIM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize(
    ("name", "launches"),
    [("universal_image_quality_index", 1), ("visual_information_fidelity", 7), ("relative_average_spectral_error", 2),
     ("spatial_correlation_coefficient", 1), ("root_mean_squared_error_using_sliding_window", 1)],
)
def test_window_metrics_on_the_card_match_the_cpu_with_their_launches(cuda_device, name, launches):
    import metrics_tpu_torch.functional.image as tfi

    rng = np.random.RandomState(31)
    a = rng.rand(3, 3, 64, 72).astype(np.float32) * 255
    b = (0.8 * a + 0.2 * rng.rand(*a.shape) * 255).astype(np.float32)
    fn = getattr(tfi, name)
    before = ssim_window.launches
    got = fn(torch.from_numpy(a).to(cuda_device), torch.from_numpy(b).to(cuda_device))
    torch.cuda.synchronize()
    assert ssim_window.launches == before + launches
    want = fn(torch.from_numpy(a), torch.from_numpy(b))
    rtol = 1e-4 if name == "visual_information_fidelity" else 1e-5
    torch.testing.assert_close(got.cpu(), want, rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("with_pan_lr", [False, True])
def test_pansharpening_indices_on_the_card_match_the_cpu_with_their_launches(cuda_device, with_pan_lr):
    import metrics_tpu_torch.functional.image as tfi

    rng = np.random.RandomState(32)
    preds, pan = (torch.from_numpy(rng.rand(2, 4, 64, 64).astype(np.float32)) for _ in range(2))
    ms, pan_lr = (torch.from_numpy(rng.rand(2, 4, 16, 16).astype(np.float32)) for _ in range(2))
    target = {"ms": ms, "pan": pan, **({"pan_lr": pan_lr} if with_pan_lr else {})}
    card_target = {k: v.to(cuda_device) for k, v in target.items()}
    for fn, launches in ((tfi.spatial_distortion_index, 2 if with_pan_lr else 3),
                         (tfi.quality_with_no_reference, 4 if with_pan_lr else 5)):
        before = ssim_window.launches
        got = fn(preds.to(cuda_device), card_target)
        torch.cuda.synchronize()
        assert ssim_window.launches == before + launches
        torch.testing.assert_close(got.cpu(), fn(preds, target), rtol=1e-5, atol=1e-6)
    before = ssim_window.launches
    got = tfi.spectral_distortion_index(preds.to(cuda_device), ms.to(cuda_device))
    assert ssim_window.launches == before + 2
    torch.testing.assert_close(got.cpu(), tfi.spectral_distortion_index(preds, ms), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("distance_metric", ["euclidean", "chessboard", "taxicab"])
def test_hausdorff_blocked_on_the_card_equals_the_cpu(cuda_device, distance_metric, monkeypatch):
    """The card's distances in float64, in blocks of 7 rows of the first edge set and in one block, equal the
    CPU's."""
    from metrics_tpu_torch.functional.segmentation import hausdorff_distance
    from metrics_tpu_torch.functional.segmentation import metrics as seg

    rng = np.random.RandomState(33)
    target = torch.from_numpy(np.kron(rng.randint(0, 5, (2, 6, 8)), np.ones((1, 12, 12), np.int64)))
    preds = torch.roll(target, shifts=(2, -3), dims=(1, 2))
    args = (5, False, distance_metric, (0.8, 1.1), False, "index")
    want = hausdorff_distance(preds, target, *args)
    got = hausdorff_distance(preds.to(cuda_device), target.to(cuda_device), *args)
    assert torch.equal(got.cpu(), want)
    monkeypatch.setattr(seg, "_distance_block_rows", lambda e1, e2, device: 7)
    got = hausdorff_distance(preds.to(cuda_device), target.to(cuda_device), *args)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_segmentation_counts_on_the_card_equal_the_cpu(cuda_device):
    from metrics_tpu_torch.functional.segmentation import metrics as seg

    rng = np.random.RandomState(34)
    preds = torch.from_numpy(rng.randint(-1, 21, (3, 128, 256)))
    target = torch.from_numpy(rng.randint(0, 19, (3, 128, 256)))
    target[:, -8:] = 255
    want = seg._class_sums(preds, target, 19, "index", False)
    got = seg._class_sums(preds.to(cuda_device), target.to(cuda_device), 19, "index", False)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, 4096])
def test_expected_mutual_info_blocked_on_the_card_equals_the_cpu(cuda_device, budget, monkeypatch):
    """AMI's expected mutual information on the card, in one block or in blocks of 4,096 terms, against the
    CPU's one block: float64 sums in another order, the same float32 result within 1 ulp."""
    from metrics_tpu_torch.functional.clustering import extrinsic as tx

    rng = np.random.RandomState(31)
    target = rng.randint(0, 20, 3000)
    preds = np.where(rng.rand(3000) < 0.5, target, rng.randint(0, 25, 3000))
    cpu = tx.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target))
    want = tx._expected_mutual_info(cpu)
    if budget is not None:
        monkeypatch.setattr(tx, "_emi_block_terms", lambda device: budget)
    got = tx._expected_mutual_info(cpu.to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, rtol=1.2e-7, atol=0)
    ami = tx.adjusted_mutual_info_score(torch.from_numpy(preds).to(cuda_device), torch.from_numpy(target).to(cuda_device))
    torch.testing.assert_close(ami.cpu(), tx.adjusted_mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target)),
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("exponent", [None, 3])
def test_blocked_l1_and_minkowski_on_the_card_equal_the_cpu(cuda_device, exponent, monkeypatch):
    """Manhattan and Minkowski distances on the card in blocks of 7 rows against the CPU's one block."""
    from metrics_tpu_torch.functional import pairwise as tp
    from metrics_tpu_torch.functional.pairwise import metrics as tpm

    rng = np.random.RandomState(32)
    x, y = torch.from_numpy(rng.randn(300, 64).astype(np.float32)), torch.from_numpy(rng.randn(200, 64).astype(np.float32))
    fn = (lambda a, b: tp.pairwise_manhattan_distance(a, b)) if exponent is None else (
        lambda a, b: tp.pairwise_minkowski_distance(a, b, exponent=exponent))
    want = fn(x, y)
    monkeypatch.setattr(tpm, "_distance_block_rows", lambda n, m, d, device: 7)
    got = fn(x.to(cuda_device), y.to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.cuda
def test_clustering_nominal_and_shape_classes_on_the_card_match_the_cpu(cuda_device):
    import metrics_tpu_torch.clustering as tcl
    import metrics_tpu_torch.nominal as tno
    import metrics_tpu_torch.shape as tsh

    rng = np.random.RandomState(33)
    labels_t = rng.randint(0, 6, 1000)
    labels_p = np.where(rng.rand(1000) < 0.6, labels_t, rng.randint(0, 8, 1000))
    data = (rng.randn(1000, 16) + 3 * labels_t[:, None]).astype(np.float32)
    pc1 = rng.randn(64, 17, 3).astype(np.float32)
    pc2 = (1.3 * pc1 + 0.05 * rng.randn(64, 17, 3)).astype(np.float32)
    cases = [(tcl.AdjustedMutualInfoScore, {}, (labels_p, labels_t)), (tcl.AdjustedRandScore, {}, (labels_p, labels_t)),
             (tcl.DaviesBouldinScore, {}, (data, labels_t)), (tcl.DunnIndex, {"p": 1.0}, (data, labels_t)),
             (tno.CramersV, {"num_classes": 8}, (labels_p, labels_t)), (tno.TheilsU, {"num_classes": 8}, (labels_p, labels_t)),
             (tsh.ProcrustesDisparity, {}, (pc1, pc2))]
    for cls, kwargs, args in cases:
        gpu, cpu = cls(device=cuda_device, **kwargs), cls(device="cpu", **kwargs)
        for i in range(2):
            gpu.update(*(torch.from_numpy(a[i::2]).to(cuda_device) for a in args))
            cpu.update(*(torch.from_numpy(a[i::2]) for a in args))
        torch.testing.assert_close(gpu.compute().cpu(), cpu.compute(), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_to_device_mid_stream_and_fingerprints_across_devices(cuda_device):
    """A metric moved card -> CPU -> card between updates equals the single stream on the card, and a card
    metric and its CPU twin with bit-equal states have one fingerprint."""
    import metrics_tpu_torch.clustering as tcl

    rng = np.random.RandomState(34)
    batches = [(torch.from_numpy(rng.randint(0, 5, 200)), torch.from_numpy(rng.randint(0, 4, 200))) for _ in range(3)]
    moved, single, twin = (tcl.NormalizedMutualInfoScore(device=d) for d in (cuda_device, cuda_device, "cpu"))
    for i, (p, t) in enumerate(batches):
        device = moved.device
        moved.update(p.to(device), t.to(device))
        single.update(p.to(cuda_device), t.to(cuda_device))
        twin.update(p, t)
        moved.to_device("cpu" if i == 0 else cuda_device)
    assert moved.device.type == "cuda" and all(v.device.type == "cuda" for v in moved.preds)
    assert torch.equal(moved.compute(), single.compute())
    assert single.state_fingerprint() == twin.state_fingerprint() == moved.state_fingerprint()


# ----------------------------------------------------------------------------- sketches, windows, drift
def _syncs(fn):
    """The synchronizations CUDA's sync debug mode reports during ``fn()``."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def _sketch_cases():
    from metrics_tpu_torch.drift import CUSUM, KSDistance, PSI
    from metrics_tpu_torch.sketches import DDSketch, HyperLogLog, ReservoirSample, StreamingAUROC, StreamingCalibrationError

    def scores(rng):
        t = rng.randint(0, 2, 4096)
        return torch.from_numpy(np.clip(0.3 * t + 0.7 * rng.rand(4096), 0, 1).astype(np.float32)), torch.from_numpy(t)

    def values(rng):
        v = rng.lognormal(0, 2, 4096).astype(np.float32)
        v[::50], v[::97] = 0.0, np.nan
        v[::31] = -v[::31]
        return (torch.from_numpy(v),)

    return {
        "HyperLogLog": (lambda d: HyperLogLog(p=12, device=d), lambda rng: (torch.from_numpy(rng.randint(0, 10**6, 4096)),)),
        "DDSketch": (lambda d: DDSketch(num_buckets=1024, device=d), values),
        "ReservoirSample": (lambda d: ReservoirSample(k=256, seed=3, device=d), values),
        "StreamingAUROC": (lambda d: StreamingAUROC(num_bins=512, device=d), scores),
        "StreamingCalibrationError": (lambda d: StreamingCalibrationError(num_bins=15, device=d), scores),
        "PSI": (lambda d: PSI(lo=-5.0, hi=5.0, num_bins=32, device=d),
                lambda rng: (torch.from_numpy(rng.randn(4096).astype(np.float32)),
                             torch.from_numpy(rng.randn(3000).astype(np.float32)))),
        "KSDistance": (lambda d: KSDistance(lo=-5.0, hi=5.0, num_bins=32, device=d),
                       lambda rng: (torch.from_numpy(rng.randn(4096).astype(np.float32)),
                                    torch.from_numpy(rng.randn(3000).astype(np.float32)))),
        "CUSUM": (lambda d: CUSUM(target=0.0, k=0.5, h=4.0, device=d),
                  lambda rng: (torch.from_numpy(rng.randn(512).astype(np.float32)),)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["HyperLogLog", "DDSketch", "ReservoirSample", "StreamingAUROC",
                                  "StreamingCalibrationError", "PSI", "KSDistance", "CUSUM"])
def test_sketch_and_drift_classes_on_the_card_equal_the_cpu_without_syncs(cuda_device, name):
    """Integer states, the reservoir and the histograms equal the CPU run's bit for bit; the confidence sums
    within rtol 1e-6, and CUSUM's summaries within atol 1e-4: differences of float32 prefix sums of 512 values,
    which reach tens and are scanned in another order on the card, so they differ by a few ulps of those
    sums; a later update reads nothing back from the card."""
    make, batch = _sketch_cases()[name]
    gpu, cpu = make(cuda_device), make("cpu")
    rng = np.random.RandomState(11)
    syncs = []
    for i in range(4):
        args = batch(rng)
        cuda_args = [a.to(cuda_device) for a in args]
        torch.cuda.synchronize()
        if i:
            syncs.append(_syncs(lambda: gpu.update(*cuda_args)))
        else:
            gpu.update(*cuda_args)
        cpu.update(*args)
    assert syncs == [0, 0, 0], syncs
    for key, value in cpu.metric_state.items():
        got = gpu.metric_state[key].cpu()
        assert got.dtype == value.dtype and got.shape == value.shape, key
        if name == "CUSUM":
            torch.testing.assert_close(got, value, rtol=1e-5, atol=1e-4)
        elif key == "conf_sum":
            torch.testing.assert_close(got, value, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(got, value), key
    torch.testing.assert_close(gpu.compute().cpu(), cpu.compute(), rtol=1e-5 if name == "CUSUM" else 1e-6,
                               atol=1e-4 if name == "CUSUM" else 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["TimeDecayed", "TimeDecayed[compensated]", "TumblingWindow", "DecayedDDSketch",
                                  "DecayedHLL"])
def test_window_classes_on_the_card_equal_the_cpu(cuda_device, name):
    """Decay weights, pane ids and the decayed sketches' states equal the CPU run's bit for bit; the windows
    over a base's float sums within rtol 1e-6."""
    from metrics_tpu_torch import MeanMetric, SumMetric
    from metrics_tpu_torch.windows import DecayedDDSketch, DecayedHLL, TimeDecayed, TumblingWindow

    makers = {
        "TimeDecayed": lambda d: TimeDecayed(MeanMetric(nan_strategy="disable", device=d), half_life_s=30.0),
        "TimeDecayed[compensated]": lambda d: TimeDecayed(MeanMetric(nan_strategy="disable", device=d),
                                                          half_life_s=30.0, compensated=True),
        "TumblingWindow": lambda d: TumblingWindow(SumMetric(nan_strategy="disable", device=d), pane_s=6.0, n_panes=5),
        "DecayedDDSketch": lambda d: DecayedDDSketch(half_life_s=30.0, num_buckets=512, device=d),
        "DecayedHLL": lambda d: DecayedHLL(half_life_s=30.0, p=10, device=d),
    }
    gpu, cpu = makers[name](cuda_device), makers[name]("cpu")
    rng = np.random.RandomState(12)
    for i in range(40):
        t = float(i) - (9.0 if i % 13 == 5 else 0.0)  # a late batch now and then
        v = torch.from_numpy(rng.lognormal(0, 1, 1024).astype(np.float32))
        if name == "DecayedHLL":
            v = torch.from_numpy(rng.randint(0, 5000, 1024))
        gpu.update(t, v.to(cuda_device))
        cpu.update(t, v)
    exact = name.startswith("Decayed")
    for key, value in cpu.metric_state.items():
        if key.endswith("_comp"):
            continue
        got = gpu.metric_state[key].cpu()
        if exact or not value.is_floating_point():
            assert torch.equal(got, value), key
        else:
            torch.testing.assert_close(got, value, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(gpu.compute().cpu(), cpu.compute(), rtol=1e-6, atol=0.0)


# ----------------------------------------------------------------------------- text and audio
@pytest.mark.cuda
def test_sdr_batched_solves_on_the_card_match_the_cpu_without_a_host_sync(cuda_device):
    """SDR's 512 x 512 Toeplitz systems, a batch of them solved by ``solve_ex`` without its error check: later
    updates read nothing back, and the values agree with the CPU run within 0.01 dB."""
    from metrics_tpu_torch.audio import SignalDistortionRatio

    gpu, cpu = SignalDistortionRatio(device=cuda_device), SignalDistortionRatio(device="cpu")
    rng = np.random.default_rng(70)
    syncs = []
    for i in range(3):
        target = torch.from_numpy(rng.standard_normal((4, 2, 8000)).astype(np.float32))
        preds = target + 0.3 * torch.from_numpy(rng.standard_normal((4, 2, 8000)).astype(np.float32))
        p, t = preds.to(cuda_device), target.to(cuda_device)
        torch.cuda.synchronize()
        if i:
            syncs.append(_syncs(lambda: gpu.update(p, t)))
        else:
            gpu.update(p, t)
        cpu.update(preds, target)
    assert syncs == [0, 0], syncs
    assert int(gpu.total) == int(cpu.total) == 24
    torch.testing.assert_close(gpu.compute().cpu(), cpu.compute(), rtol=0.0, atol=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("ignore_index", [None, -100])
def test_perplexity_at_gpt2_vocabulary_on_the_card_matches_the_cpu(cuda_device, ignore_index):
    """Logits of GPT-2's 50,257 tokens: the count equal, the sum of log-probabilities within rtol 1e-5."""
    from metrics_tpu_torch.text import Perplexity

    gpu, cpu = Perplexity(ignore_index, device=cuda_device), Perplexity(ignore_index, device="cpu")
    g = torch.Generator().manual_seed(71)
    for _ in range(2):
        logits = 4 * torch.randn(2, 64, 50257, generator=g)
        target = torch.randint(0, 50257, (2, 64), generator=g)
        if ignore_index is not None:
            target[torch.rand(2, 64, generator=g) < 0.1] = ignore_index
        gpu.update(logits.to(cuda_device), target.to(cuda_device))
        cpu.update(logits, target)
    assert gpu.count.dtype == torch.int64 and int(gpu.count) == int(cpu.count)
    torch.testing.assert_close(gpu.total_log_probs.cpu(), cpu.total_log_probs, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(gpu.compute().cpu(), cpu.compute(), rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("spk", [2, 3])
def test_pit_on_the_card_matches_the_cpu(cuda_device, spk):
    """Permutations equal and values within 1e-4 dB; two speakers read nothing back, three read the metric
    matrix once for the assignment."""
    from metrics_tpu_torch.functional.audio import permutation_invariant_training, scale_invariant_signal_distortion_ratio

    rng = np.random.default_rng(72 + spk)
    target = torch.from_numpy(rng.standard_normal((16, spk, 4000)).astype(np.float32))
    preds = target[:, torch.randperm(spk)] + 0.5 * torch.from_numpy(rng.standard_normal((16, spk, 4000)).astype(np.float32))
    p, t = preds.to(cuda_device), target.to(cuda_device)
    permutation_invariant_training(p, t, scale_invariant_signal_distortion_ratio)
    torch.cuda.synchronize()
    out = {}
    syncs = _syncs(lambda: out.update(gpu=permutation_invariant_training(p, t, scale_invariant_signal_distortion_ratio)))
    best_cpu, perm_cpu = permutation_invariant_training(preds, target, scale_invariant_signal_distortion_ratio)
    best_gpu, perm_gpu = out["gpu"]
    assert syncs == (0 if spk == 2 else 1), syncs
    assert torch.equal(perm_gpu.cpu(), perm_cpu)
    torch.testing.assert_close(best_gpu.cpu(), best_cpu, rtol=0.0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("norm", [False, True])
def test_srmr_on_the_card_matches_the_cpu(cuda_device, norm):
    from metrics_tpu_torch.functional.audio import speech_reverberation_modulation_energy_ratio

    rng = np.random.default_rng(74)
    t = np.arange(32000) / 16000
    x = torch.from_numpy(np.stack([(1 + np.sin(2 * np.pi * f * t)) * rng.standard_normal(32000)
                                   for f in (3.0, 7.0, 12.0)]).astype(np.float32))
    got = speech_reverberation_modulation_energy_ratio(x.to(cuda_device), 16000, norm=norm)
    want = speech_reverberation_modulation_energy_ratio(x, 16000, norm=norm)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("extended", [False, True])
def test_stoi_on_the_card_matches_the_cpu(cuda_device, extended):
    from metrics_tpu_torch.functional.audio import short_time_objective_intelligibility

    rng = np.random.default_rng(75)
    n, fs = 48000, 16000
    env = np.clip(np.sin(2 * np.pi * 2.3 * np.arange(n) / fs), 0, None)
    clean = env * rng.standard_normal((4, n))
    noisy = clean + np.array([0.1, 0.5, 1.0, 3.0])[:, None] * rng.standard_normal((4, n))
    p, t = torch.from_numpy(noisy.astype(np.float32)), torch.from_numpy(clean.astype(np.float32))
    got = short_time_objective_intelligibility(p.to(cuda_device), t.to(cuda_device), fs, extended)
    want = short_time_objective_intelligibility(p, t, fs, extended)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=0.0, atol=1e-5)
    same = short_time_objective_intelligibility(t.to(cuda_device), t.to(cuda_device), fs, extended)
    torch.testing.assert_close(same.cpu(), torch.ones(4), rtol=0.0, atol=1e-6)


# ----------------------------------------------------------------------------- observe and durability on the card
def _coco80(rng, n=4096):
    target = (rng.rand(n, 80) < 0.036).astype(np.int64)
    preds = ((rng.rand(n, 80).astype(np.float32) + 0.5 * target) / 1.5).astype(np.float32)
    return torch.from_numpy(preds), torch.from_numpy(target)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["telemetry", "skip_batch", "propagate"])
def test_telemetry_and_guards_add_no_host_sync_to_a_later_update(cuda_device, variant):
    """The binned multilabel AP (without input validation, whose read of the targets is a host sync) and the
    DDSketch read nothing back from the card in a later update; under telemetry, or guarded by ``skip_batch``
    or ``propagate``, they still read nothing."""
    from metrics_tpu_torch import observe
    from metrics_tpu_torch.resilience import install_guard
    from metrics_tpu_torch.sketches import DDSketch

    rng = np.random.RandomState(5)
    preds, target = (x.to(cuda_device) for x in _coco80(rng))
    values = torch.from_numpy(rng.lognormal(size=1 << 16).astype(np.float32)).to(cuda_device)

    def metrics():
        return ((tc.MultilabelAveragePrecision(num_labels=80, thresholds=200, validate_args=False,
                                               device=cuda_device), (preds, target)),
                (DDSketch(device=cuda_device), (values,)))

    def later_syncs(metric, args):
        metric.update(*args)
        torch.cuda.synchronize()
        return [_syncs(lambda: metric.update(*args)) for _ in range(3)]

    for metric, args in metrics():
        assert later_syncs(metric, args) == [0, 0, 0], type(metric).__name__
    with observe.scope():
        if variant != "telemetry":
            observe.disable()
        for metric, args in metrics():
            if variant != "telemetry":
                install_guard(metric, variant)
            assert later_syncs(metric, args) == [0, 0, 0], (variant, type(metric).__name__)
        if variant == "telemetry":
            assert observe.snapshot()["counters"]["update_eager"] == {"MultilabelAveragePrecision": 4, "DDSketch": 4}


@pytest.mark.cuda
def test_a_checkpoint_saved_from_the_card_restores_on_the_cpu(cuda_device, tmp_path):
    from metrics_tpu_torch.resilience import restore_checkpoint, save_checkpoint

    def make(d):
        return MetricCollection([tc.MulticlassAccuracy(num_classes=10, device=d),
                                 tc.MulticlassConfusionMatrix(num_classes=10, device=d),
                                 tc.MulticlassAUROC(num_classes=10, thresholds=50, device=d)])

    rng = np.random.RandomState(6)
    col = make(cuda_device)
    for _ in range(3):
        col.update(torch.from_numpy(rng.rand(2048, 10).astype(np.float32)).to(cuda_device),
                   torch.from_numpy(rng.randint(0, 10, 2048)).to(cuda_device))
    path = str(tmp_path / "card.ckpt")
    save_checkpoint(col, path)
    cpu = restore_checkpoint(make("cpu"), path)
    card = restore_checkpoint(make(cuda_device), path)
    for name, metric in col.items():
        assert cpu[name].state_fingerprint() == metric.state_fingerprint() == card[name].state_fingerprint(), name
        assert all(v.device.type == "cpu" for v in cpu[name].metric_state.values())
    for key, value in col.compute().items():
        torch.testing.assert_close(cpu.compute()[key], value.cpu(), rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_the_span_range_encloses_its_kernel_launch_in_a_profiler_trace(cuda_device, tmp_path):
    import json

    from metrics_tpu_torch import observe
    from metrics_tpu_torch.ops.profile import kernels_inside

    rng = np.random.RandomState(7)
    preds, target = (x.to(cuda_device) for x in _coco80(rng))
    ap = tc.MultilabelAveragePrecision(num_labels=80, thresholds=200, device=cuda_device)
    ap.update(preds, target)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with observe.scope():
        with torch.profiler.profile(activities=activities) as prof:
            ap.update(preds, target)
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    inside = kernels_inside(trace, "update:MultilabelAveragePrecision")
    assert any("binned_counts" in name for name in inside), inside
    assert not kernels_inside(trace, "compute:MultilabelAveragePrecision")


# ----------------------------------------------------------------------------- the batched forms (fleet engine)
def _per_row_launches(fn, rows):
    """Each row's kernel launch on its own: the oracle of a batched launch."""
    return [fn(r) for r in range(rows)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(("rows", "n", "c", "t"), [(1, 100, 1, 16), (5, 16, 3, 16), (64, 257, 2, 200)])
def test_vmapped_binned_kernel_equals_per_row_launches(cuda_device, dtype, rows, n, c, t):
    from torch.func import vmap

    g = torch.Generator().manual_seed(rows + c)
    preds = torch.rand(rows, n, c, generator=g, dtype=torch.float64).to(dtype).to(cuda_device)
    target = torch.randint(0, 2, (rows, n, c), generator=g).int().to(cuda_device)
    valid = (torch.rand(rows, n, c, generator=g) > 0.1).to(cuda_device)
    thr = _adjust_threshold_arg(t).to(dtype).to(cuda_device)
    before = binned_counts.launches
    got = vmap(binned_counts, in_dims=(0, 0, 0, None))(preds, target, valid, thr)
    torch.cuda.synchronize()
    assert binned_counts.launches - before == 1  # one launch for every row
    want = _per_row_launches(lambda r: binned_counts(preds[r].contiguous(), target[r].contiguous(),
                                                     valid[r].contiguous(), thr), rows)
    for r in range(rows):
        for a, b in zip(got, want[r]):
            assert torch.equal(a[r], b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 100])
def test_vmapped_labels_kernel_equals_per_row_label_launches(cuda_device, rows):
    from torch.func import vmap

    g = torch.Generator().manual_seed(rows)
    preds = torch.rand(rows, 256, 10, generator=g).to(cuda_device)
    labels = torch.randint(-1, 11, (rows, 256), generator=g).int().to(cuda_device)
    thr = _adjust_threshold_arg(200).to(cuda_device)
    before = (binned_counts.launches, binned_counts_labels.launches)
    got = vmap(binned_counts_labels, in_dims=(0, 0, None))(preds, labels, thr)
    torch.cuda.synchronize()
    # under vmap the labels become the plain mode's one-hot columns: one plain-mode launch
    assert (binned_counts.launches - before[0], binned_counts_labels.launches - before[1]) == (1, 0)
    for r in range(rows):
        want = binned_counts_labels(preds[r].contiguous(), labels[r].contiguous(), thr)
        for a, b in zip(got, want):
            assert torch.equal(a[r], b)


@pytest.mark.cuda
@pytest.mark.parametrize(("rows", "planes"), [(1, 15), (8, 15), (33, 3)])
def test_vmapped_ssim_kernel_equals_per_row_launches(cuda_device, rows, planes):
    from torch.func import vmap

    g = torch.Generator().manual_seed(rows)
    x = torch.rand(rows, planes, 74, 90, generator=g).to(cuda_device)
    k = _gaussian_taps_np(11, 1.5)
    before = ssim_window.launches
    got = vmap(lambda a: ssim_window(a, k, k))(x)
    torch.cuda.synchronize()
    assert ssim_window.launches - before == 1
    for r in range(rows):
        assert torch.equal(got[r], ssim_window(x[r].contiguous(), k, k))


@pytest.mark.cuda
def test_small_fleet_on_the_card_equals_the_same_fleet_on_the_cpu(cuda_device):
    from metrics_tpu_torch.engine import StreamEngine

    def fleet(device):
        g = torch.Generator().manual_seed(3)
        engine = StreamEngine(initial_capacity=8)
        sids = [engine.add_session(tc.MulticlassAccuracy(num_classes=4, device=device)) for _ in range(5)]
        sids += [engine.add_session(tc.BinaryAUROC(thresholds=16, device=device)) for _ in range(5)]
        sids += [engine.add_session(StructuralSimilarityIndexMeasure(data_range=1.0, device=device)) for _ in range(3)]
        for _ in range(3):
            for i, sid in enumerate(sids):
                if i < 5:
                    args = (torch.randint(0, 4, (16,), generator=g), torch.randint(0, 4, (16,), generator=g))
                elif i < 10:
                    args = (torch.rand(16, generator=g), torch.randint(0, 2, (16,), generator=g))
                else:
                    a = torch.rand(1, 3, 32, 32, generator=g)
                    args = (a, 0.5 * a + 0.5 * torch.rand(1, 3, 32, 32, generator=g))
                engine.submit(sid, *(x.to(device) for x in args))
            assert engine.tick() == 1
        return engine, sids

    before = (binned_counts.launches, ssim_window.launches)
    gpu, sids = fleet(cuda_device)
    torch.cuda.synchronize()
    assert (binned_counts.launches - before[0], ssim_window.launches - before[1]) == (3, 3)  # one a tick each
    cpu, _ = fleet("cpu")
    values_gpu, values_cpu = gpu.compute_all(), cpu.compute_all()
    for sid in sids:
        sg, sc = gpu._sessions[sid], cpu._sessions[sid]
        for k in sc.bucket.stacked:
            a, b = sg.bucket.stacked[k][sg.slot].cpu(), sc.bucket.stacked[k][sc.slot]
            if a.is_floating_point():
                assert torch.allclose(a, b, rtol=1e-5, atol=1e-6), (sid, k)
            else:
                assert torch.equal(a, b), (sid, k)
        assert torch.allclose(values_gpu[sid].double(), values_cpu[sid].double(), rtol=1e-5, atol=1e-6)


def _served_fleet(device):
    """Sixteen sessions (MulticlassAccuracy and BinaryAUROC) served over a socketpair into an engine on
    ``device``, three numpy waves, one tick each; the producer's metrics are on the CPU, rebuilt on ``device``."""
    import socket

    from metrics_tpu_torch.engine import StreamEngine
    from metrics_tpu_torch.serve.protocol import Producer
    from metrics_tpu_torch.serve.server import MetricsServer

    engine = StreamEngine(initial_capacity=16)
    server = MetricsServer(engine, "card-key", host=None, device=device)
    srv, cli = socket.socketpair()
    server.adopt(srv)
    prod = Producer(None, "card-key", name="p", sock=cli, drive=lambda: server.poll(0.0))
    rng = np.random.default_rng(9)
    for i in range(8):
        prod.add_session(tc.MulticlassAccuracy(num_classes=4, validate_args=False, device="cpu"), session_id=f"a{i}")
        prod.add_session(tc.BinaryAUROC(thresholds=16, device="cpu"), session_id=f"b{i}")
    for _ in range(3):
        for i in range(8):
            prod.submit(f"a{i}", rng.integers(0, 4, 16), rng.integers(0, 4, 16))
            prod.submit(f"b{i}", rng.random(16, dtype=np.float32), rng.integers(0, 2, 16))
        prod.flush(30.0)
        assert server.tick() == 1
    assert prod.errors == []
    server.close()
    return engine


@pytest.mark.cuda
def test_a_small_served_fleet_on_the_card_equals_the_same_fleet_served_on_the_cpu(cuda_device):
    before = binned_counts.launches
    gpu = _served_fleet(cuda_device)
    torch.cuda.synchronize()
    assert binned_counts.launches - before == 3  # the AUROC bucket: one launch a tick
    cpu = _served_fleet("cpu")
    for sid in cpu.session_ids():
        sg, sc = gpu._sessions[sid], cpu._sessions[sid]
        assert sg.metric.device.type == "cuda"
        for k in sc.bucket.stacked:
            assert torch.equal(sg.bucket.stacked[k][sg.slot].cpu(), sc.bucket.stacked[k][sc.slot]), (sid, k)


# the Inception taps on the card and on the CPU, both in float32 with TF32 off: as tests/test_torch_models.py
# holds the port against the JAX package (atol 1e-5 of each tap's largest value, rtol 1e-4)
INCEPTION_ATOL_OF_SCALE, INCEPTION_RTOL = 1e-5, 1e-4


@pytest.mark.cuda
def test_inception_taps_on_the_card_with_tf32_off_equal_the_cpu(cuda_device):
    from metrics_tpu_torch.models import InceptionV3FID, init_inception_params

    taps = (64, 192, 768, 2048, "logits_unbiased", "logits")
    state = init_inception_params(5, device="cpu")
    x = torch.from_numpy(np.random.default_rng(10).integers(0, 256, (4, 3, 64, 80)).astype(np.float32))
    outs = {}
    for device in (cuda_device, torch.device("cpu")):
        model = InceptionV3FID()
        model.load_state_dict(state)
        model.to(device).eval()
        from metrics_tpu_torch.models._backbone import exact_fp32

        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        with torch.inference_mode(), exact_fp32():
            outs[device.type] = {k: v.cpu() for k, v in model(x.to(device), features=taps).items()}
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    for tap in taps:
        want, got = outs["cpu"][tap], outs["cuda"][tap]
        scale = float(want.abs().max())
        assert torch.allclose(got, want, rtol=INCEPTION_RTOL, atol=INCEPTION_ATOL_OF_SCALE * scale), tap


@pytest.mark.cuda
def test_fid_on_the_card_equals_fid_on_the_cpu_for_the_same_features(cuda_device):
    """The float64 sums and products on the card, FID's float64 ``eigh`` on the card: within rtol 1e-5 of the
    CPU's, as the CPU tests hold the port against the JAX package."""
    from metrics_tpu_torch.image import FrechetInceptionDistance

    rng = np.random.default_rng(11)
    real = rng.standard_normal((600, 64)).astype(np.float32)
    fake = (rng.standard_normal((600, 64)) * 1.2 + 0.3).astype(np.float32)
    values = {}
    for device in (cuda_device, torch.device("cpu")):
        fid = FrechetInceptionDistance(device=device)
        for r, f in zip(np.array_split(real, 3), np.array_split(fake, 3)):
            fid.update(torch.from_numpy(r).to(device), real=True)
            fid.update(torch.from_numpy(f).to(device), real=False)
        assert fid.real_features_cov_sum.device.type == device.type
        values[device.type] = float(fid.compute())
    assert values["cuda"] == pytest.approx(values["cpu"], rel=1e-5)


@pytest.mark.cuda
def test_clip_forwards_on_the_card_with_tf32_allowed_equal_the_cpu(cuda_device, tmp_path):
    """``load_clip``'s encoders run inside ``exact_fp32``: with TF32 allowed globally, a tiny local CLIP's
    image and text features on the card equal the CPU's within 1e-5 of their scale, and the flags come back."""
    from _torch_hf import tiny_clip

    from metrics_tpu_torch.models import load_clip

    path, _, _ = tiny_clip(tmp_path / "clip")
    card, host = load_clip(path, device=cuda_device), load_clip(path, device="cpu")
    images = torch.rand(4, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    texts = ["a photo of a cat", "a good dog", "the bad photo", "a cat"]
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
    try:
        for got, want in ((card[0](images), host[0](images)), (card[1](texts), host[1](texts))):
            assert got.device.type == "cuda" and got.shape == want.shape
            scale = float(want.abs().max())
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-5 * scale)
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.cuda
def test_model_based_text_and_multimodal_on_the_card_equal_the_cpu(cuda_device):
    """BERTScore, InfoLM (each measure), CLIPScore and CLIP-IQA over the same embeddings: the card's float64
    pair batches and float32 scores equal the CPU's within rtol 1e-5."""
    from metrics_tpu_torch.multimodal import CLIPImageQualityAssessment, CLIPScore
    from metrics_tpu_torch.text import BERTScore, InfoLM

    g = torch.Generator().manual_seed(3)
    lengths = torch.randint(1, 30, (40,), generator=g).tolist()
    emb = [torch.randn(n, 64, generator=g) for n in lengths]
    dist = [torch.softmax(torch.randn(n, 500, generator=g), -1) for n in lengths]
    texts = [str(i) for i in range(40)]

    def on(table, dev):
        return lambda xs: [table[int(x)].to(dev) for x in xs]

    def close(got, want):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-7)

    pairs = (texts[:20], texts[20:])
    for make in (lambda d: BERTScore(encoder=on(emb, d), device=d),
                 *[lambda d, m=m: InfoLM(distribution_fn=on(dist, d), information_measure=m, device=d)
                   for m in InfoLM._MEASURES]):
        card, host = make(cuda_device), make("cpu")
        card.update(*pairs)
        host.update(*pairs)
        got, want = card.compute(), host.compute()
        for k in (want if isinstance(want, dict) else [None]):
            close(got[k] if k else got, want[k] if k else want)
    img = torch.randn(8, 32, generator=g)
    txt = {t: torch.randn(32, generator=g) for t in ("a", "b", "Good photo.", "Bad photo.", "x.", "y.")}
    encoders = lambda d: dict(image_encoder=lambda x: img[: len(x)].to(d),  # noqa: E731
                              text_encoder=lambda ts: torch.stack([txt[t] for t in ts]).to(d))
    card, host = CLIPScore(device=cuda_device, **encoders(cuda_device)), CLIPScore(device="cpu", **encoders("cpu"))
    card.update(torch.zeros(2, 3, 4, 4), ["a", "b"])
    host.update(torch.zeros(2, 3, 4, 4), ["a", "b"])
    close(card.compute(), host.compute())
    prompts = ("quality", ("x.", "y."))
    card = CLIPImageQualityAssessment(prompts=prompts, device=cuda_device, **encoders(cuda_device))
    host = CLIPImageQualityAssessment(prompts=prompts, device="cpu", **encoders("cpu"))
    card.update(torch.zeros(8, 3, 4, 4))
    host.update(torch.zeros(8, 3, 4, 4))
    got, want = card.compute(), host.compute()
    assert list(got) == list(want) == ["quality", "user_defined_0"]
    for k in want:
        close(got[k], want[k])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["BinaryAUROC", "MeanSquaredError", "MeanIoU"])
def test_transfer_verdict_on_the_card_equals_its_cpu_prediction(cuda_device, name):
    """Under ``set_sync_debug_mode("error")`` the class's steady update loop does on the card what the CPU's
    host-read recorder predicted: BinaryAUROC reads the targets' distinct values, the others read nothing."""
    from metrics_tpu_torch.analysis import transfer_contracts

    case = next(c for c in transfer_contracts.transfer_cases() if c.name == name)
    card = transfer_contracts.check_transfer_case(case, "cuda")
    cpu = transfer_contracts.check_transfer_case(case, "cpu")
    assert card.agree and cpu.agree, (card.render(), cpu.render())
    assert card.runtime.split(":")[0] == cpu.runtime.split(":")[0], (card.render(), cpu.render())


@pytest.mark.cuda
def test_fleet_contract_on_a_cuda_bucket_launches_the_binned_counts(cuda_device):
    """BinaryAUROC's churning 4-slot bucket on the card agrees with its per-instance oracles and runs B1
    through the custom op's ``vmap`` rule."""
    from metrics_tpu_torch.analysis import fleet_contracts

    case = next(c for c in fleet_contracts.fleet_cases() if c.name == "BinaryAUROC")
    before = binned_counts.launches
    r = fleet_contracts.check_fleet_case(case, "cuda")
    torch.cuda.synchronize()
    assert r.ok, r.render()
    assert binned_counts.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["PeakSignalNoiseRatio", "StructuralSimilarityIndexMeasure", "CUSUM"])
def test_the_eager_and_vmapped_gap_on_the_card_is_inside_the_fleet_tolerance(cuda_device, name):
    """The classes whose float state the fleet contract holds only within tolerance on the card: the same
    batches through eager updates and a bucket's vmapped update differ by less than that tolerance."""
    from metrics_tpu_torch.analysis import fleet_contracts

    case = next(c for c in fleet_contracts.fleet_cases() if c.name == name)
    gaps = fleet_contracts.eager_vs_bucket_gap(case, "cuda")
    print(name, gaps)
    assert len(gaps) == 4 and max(g for tick in gaps.values() for g in tick.values()) <= fleet_contracts._RTOL, gaps


@pytest.mark.cuda
def test_abstract_contracts_on_fake_cuda_tensors_equal_the_cpu_s(cuda_device):
    """Every functional kernel traces on fake CUDA tensors (the wrappers' card branch, through the three ops'
    fake implementations) to the shapes and dtypes of its fake CPU trace, and launches nothing."""
    from metrics_tpu_torch.analysis.abstract_contracts import verify_contracts

    before = (binned_counts.launches, binned_counts_labels.launches, ssim_window.launches)
    card, cpu = verify_contracts(device="cuda"), verify_contracts(device="cpu")
    assert [r.error for r in card if not r.ok] == []
    assert [r.outputs for r in card] == [r.outputs for r in cpu]
    assert (binned_counts.launches, binned_counts_labels.launches, ssim_window.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernel", [("BinaryAUROC", "binned_counts"), ("MulticlassAUROC", "binned_counts_labels"),
                                         ("StructuralSimilarityIndexMeasure", "ssim_window")])
def test_a_donation_case_per_kernel_on_the_card(cuda_device, name, kernel):
    """The 3-update lifecycle on the card launches the class's kernel and gives the CPU's verdict."""
    from metrics_tpu_torch.analysis.donation_contracts import check_donation_case, donation_cases

    case = next(c for c in donation_cases() if c.name == name)
    wrapper = {"binned_counts": binned_counts, "binned_counts_labels": binned_counts_labels,
               "ssim_window": ssim_window}[kernel]
    before = wrapper.launches
    card = check_donation_case(case, "cuda")
    torch.cuda.synchronize()
    assert wrapper.launches - before >= 3
    cpu = check_donation_case(case, "cpu")
    assert card.agree and card.runtime == "EAGER", card.render()
    assert (card.static_eligible, card.costs_eligible, card.runtime) == (cpu.static_eligible, cpu.costs_eligible,
                                                                         cpu.runtime)
