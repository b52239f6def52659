"""The port's kernel modules: each plain version against the JAX package's Pallas
kernel in interpret mode, the wrappers' routing, the kernel build, and the
slice end to end with a state carried from the JAX package into the port.

The CUDA kernels themselves are held against their plain versions on the card
by ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu_torch.classification as tc
from metrics_tpu.functional.classification.precision_recall_curve import _adjust_threshold_arg
from metrics_tpu.functional.image._helpers import _gaussian
from metrics_tpu.image import StructuralSimilarityIndexMeasure as JSSIM
from metrics_tpu.ops.binned_hist import binned_counts_pallas
from metrics_tpu.ops.ssim_window import ssim_window_pallas
from metrics_tpu_torch.image import StructuralSimilarityIndexMeasure as TSSIM
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.ops import _native, variants
from metrics_tpu_torch.ops.binned_hist import (
    binned_counts,
    binned_counts_labels,
    binned_counts_labels_plain,
    binned_counts_plain,
)
from metrics_tpu_torch.ops.ssim_window import ssim_window, ssim_window_plain, windowed_sum_nchw

BINNED_SHAPES = [(100, 1, 5), (257, 3, 17), (1000, 4, 100), (50, 2, 129), (8, 1, 1)]
SSIM_ATOL = 1e-6


def _binned_inputs(n, c, t, seed):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n, c).astype(np.float32)
    target01 = rng.randint(0, 2, (n, c)).astype(np.int32)
    valid = rng.rand(n, c) > 0.1
    thresholds = np.asarray(_adjust_threshold_arg(t))
    return preds, target01, valid, thresholds


def _edge_inputs():
    """Threshold ties, NaN and infinite scores, an all-invalid row, and a NaN threshold."""
    preds = np.array([[0.0], [0.25], [0.5], [0.5], [1.0], [np.nan], [0.75], [np.inf], [-np.inf]], np.float32)
    target01 = np.array([[0], [1], [1], [0], [1], [1], [1], [1], [0]], np.int32)
    valid = np.array([[True]] * 6 + [[False]] + [[True]] * 2)
    thresholds = np.array([0.0, 0.25, 0.5, 0.5, 1.0, np.nan], np.float32)
    return preds, target01, valid, thresholds


def _pallas_counts(preds, target01, valid, thresholds):
    out = binned_counts_pallas(jnp.asarray(preds), jnp.asarray(target01), jnp.asarray(valid), jnp.asarray(thresholds),
                               interpret=True)
    return [np.asarray(o) for o in out]


def _torch_args(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


# ----------------------------------------------------------------------------- B1 plain vs Pallas
@pytest.mark.parametrize(("n", "c", "t"), BINNED_SHAPES)
def test_binned_plain_matches_pallas_kernel(n, c, t):
    inputs = _binned_inputs(n, c, t, seed=n + c + t)
    got = binned_counts_plain(*_torch_args(*inputs))
    for g, w, name in zip(got, _pallas_counts(*inputs), ("tp", "fp", "pos_tot", "neg_tot")):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_binned_plain_matches_pallas_kernel_on_edge_values():
    inputs = _edge_inputs()
    got = binned_counts_plain(*_torch_args(*inputs))
    for g, w in zip(got, _pallas_counts(*inputs)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_binned_wrapper_runs_plain_version_on_cpu_without_counting():
    before = binned_counts.launches
    inputs = _torch_args(*_binned_inputs(64, 2, 9, seed=1))
    for g, w in zip(binned_counts(*inputs), binned_counts_plain(*inputs)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert binned_counts.launches == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        binned_counts(*[x.to("meta") for x in inputs])


@pytest.mark.parametrize(("n", "c", "t"), [(100, 2, 5), (257, 3, 17), (1000, 4, 100), (50, 10, 129)])
def test_binned_labels_plain_matches_pallas_kernel_on_the_one_hot(n, c, t):
    """Labels mode: ignored labels (-1), labels >= C (negatives of every class) and NaN scores."""
    rng = np.random.RandomState(n + c)
    preds = rng.rand(n, c).astype(np.float32)
    preds[rng.rand(n, c) < 0.05] = np.nan
    labels = rng.randint(-1, c + 1, n).astype(np.int32)  # -1 ignored, c out of range
    thresholds = np.asarray(_adjust_threshold_arg(t))
    target01 = (labels[:, None] == np.arange(c)).astype(np.int32)
    valid = np.broadcast_to((labels >= 0)[:, None], (n, c)).copy()
    want = _pallas_counts(preds, target01, valid, thresholds)
    got = binned_counts_labels_plain(*_torch_args(preds, labels, thresholds))
    for g, w, name in zip(got, want, ("tp", "fp", "pos_tot", "neg_tot")):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    before = binned_counts_labels.launches
    for g, w in zip(binned_counts_labels(*_torch_args(preds, labels, thresholds)), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert binned_counts_labels.launches == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        binned_counts_labels(*[x.to("meta") for x in _torch_args(preds, labels, thresholds)])


# ----------------------------------------------------------------------------- B2 plain vs Pallas
def test_ssim_plain_matches_pallas_kernel():
    rng = np.random.RandomState(0)
    k1 = [float(v) for v in np.asarray(_gaussian(11, 1.5)[0])]
    x = rng.rand(12, 42, 74).astype(np.float32)
    want = np.asarray(ssim_window_pallas(jnp.asarray(x), tuple(k1), tuple(k1), interpret=True))
    got = ssim_window_plain(torch.from_numpy(x), k1, k1)
    np.testing.assert_allclose(got.numpy(), want, atol=SSIM_ATOL, rtol=0)


def test_ssim_plain_matches_pallas_kernel_asymmetric_taps():
    rng = np.random.RandomState(0)
    k1 = [float(v) for v in np.asarray(_gaussian(11, 1.5)[0])]
    k2 = [float(v) for v in np.asarray(_gaussian(5, 0.8)[0])]
    planes = rng.rand(6, 20, 40).astype(np.float32)
    want = np.asarray(ssim_window_pallas(jnp.asarray(planes), tuple(k1), tuple(k2), interpret=True))
    got = ssim_window_plain(torch.from_numpy(planes), k1, k2)
    assert got.shape == (6, 10, 36)
    np.testing.assert_allclose(got.numpy(), want, atol=SSIM_ATOL, rtol=0)


def test_ssim_wrapper_runs_plain_version_on_cpu_without_counting():
    before = ssim_window.launches
    x = torch.rand(2, 3, 20, 22)
    taps = [np.full(5, 0.2, np.float32), np.full(3, 1 / 3, np.float32)]
    out = windowed_sum_nchw(x, taps)
    assert out.shape == (2, 3, 16, 20)
    torch.testing.assert_close(out, ssim_window_plain(x.reshape(6, 20, 22), taps[0], taps[1]).reshape(2, 3, 16, 20))
    assert ssim_window.launches == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ssim_window(x[0].to("meta"), taps[0], taps[1])


# ----------------------------------------------------------------------------- build and imports
def test_library_path_is_keyed_by_source(tmp_path, monkeypatch):
    first = _native.library_path("binned_hist")
    assert first.parent == _native.BUILD_DIR and first == _native.library_path("binned_hist")
    assert first != _native.library_path("ssim_window")
    fake = tmp_path / "csrc"
    fake.mkdir()
    (fake / "binned_hist.cu").write_text((_native.CSRC / "binned_hist.cu").read_text() + "\n// edited\n")
    (fake / "common.cuh").write_text((_native.CSRC / "common.cuh").read_text())
    monkeypatch.setattr(_native, "CSRC", fake)
    assert _native.library_path("binned_hist") != first


def test_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.build()


def test_kernel_variants_apply_to_the_sources():
    """Every variant that ``ops/variants.py`` times finds the constant or line it changes in the committed source."""
    for name, table in (("ssim_window", variants.SSIM), ("binned_hist", variants.BINNED)):
        committed = (_native.CSRC / f"{name}.cu").read_text()
        for subs, _ in table.values():
            assert (variants.variant_source(name, subs) == committed) == (not subs)
    with pytest.raises(ValueError, match="not found"):
        variants.variant_source("ssim_window", {"kNoSuchConstant": 1})


def test_port_imports_no_jax():
    code = (
        "import sys, metrics_tpu_torch.ops.ssim_window, metrics_tpu_torch.ops.binned_hist;"
        "import metrics_tpu_torch.ops.profile, metrics_tpu_torch.ops.variants;"
        "import metrics_tpu_torch.classification, metrics_tpu_torch.image, metrics_tpu_torch.interop;"
        "import metrics_tpu_torch.functional.classification, metrics_tpu_torch.functional.image;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'metrics_tpu.')) or m == 'metrics_tpu'];"
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


# ----------------------------------------------------------------------------- the slice end to end
def _stream(kind, seed, n_batches=4):
    rng = np.random.RandomState(seed)
    for _ in range(n_batches):
        if kind == "multiclass":
            yield rng.rand(128, 5).astype(np.float32), rng.randint(0, 5, 128)
        elif kind == "binary":
            yield rng.rand(128).astype(np.float32), rng.randint(0, 2, 128)
        else:
            a = rng.rand(2, 3, 24, 24).astype(np.float32)
            yield a, (0.7 * a + 0.3 * rng.rand(2, 3, 24, 24)).astype(np.float32)


@pytest.mark.parametrize(
    ("port_cls", "ref_cls", "kwargs", "kind"),
    [
        (tc.MulticlassAccuracy, jc.MulticlassAccuracy, {"num_classes": 5, "average": "micro"}, "multiclass"),
        (tc.MulticlassAccuracy, jc.MulticlassAccuracy, {"num_classes": 5, "average": "macro"}, "multiclass"),
        (tc.BinaryPrecisionRecallCurve, jc.BinaryPrecisionRecallCurve, {"thresholds": 200}, "binary"),
        (tc.MulticlassPrecisionRecallCurve, jc.MulticlassPrecisionRecallCurve,
         {"num_classes": 5, "thresholds": 100}, "multiclass"),
        (TSSIM, JSSIM, {"data_range": 1.0}, "image"),
    ],
    ids=["accuracy-micro", "accuracy-macro", "binary-prc", "multiclass-prc", "ssim"],
)
def test_state_carried_from_reference_finishes_in_port(port_cls, ref_cls, kwargs, kind):
    """Half the batches in the JAX package, the state carried across, the rest in the port:
    the result equals one pass of the JAX package over every batch."""
    batches = list(_stream(kind, seed=40))
    single = ref_cls(**kwargs)
    first_half = ref_cls(**kwargs)
    first_half.persistent(True)
    for i, (a, b) in enumerate(batches):
        single.update(jnp.asarray(a), jnp.asarray(b))
        if i < len(batches) // 2:
            first_half.update(jnp.asarray(a), jnp.asarray(b))
    port = load_reference_state(port_cls(device="cpu", **kwargs), first_half.state_dict())
    for a, b in batches[len(batches) // 2:]:
        port.update(torch.from_numpy(a), torch.from_numpy(b))
    assert port.update_count == len(batches)
    got, want = port.compute(), single.compute()
    for g, w in zip(got if isinstance(got, tuple) else [got], want if isinstance(want, tuple) else [want]):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64), rtol=1e-6, atol=1e-5)
