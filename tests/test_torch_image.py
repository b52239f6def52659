"""The port's SSIM (2-D and 3-D), MS-SSIM and PSNR against the JAX package's on the same seeded images.

SSIM and MS-SSIM agree at atol 1e-5: the window sums reassociate nowhere
(both run the same shifted-slice cascade on the CPU), but the epilogue's
float32 arithmetic, and MS-SSIM's average pooling and powers, are free to
round differently in the two frameworks. PSNR agrees at rtol 1e-6: its float32
sums of squared errors are taken in another order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.image as jfi
import metrics_tpu.image as ji
import metrics_tpu_torch.functional.image as tfi
import metrics_tpu_torch.image as ti
from metrics_tpu.functional.image import _helpers as jhelpers
from metrics_tpu.functional.image.ssim import structural_similarity_index_measure as j_ssim
from metrics_tpu.image import StructuralSimilarityIndexMeasure as JSSIM
from metrics_tpu_torch.functional.image import _helpers as thelpers
from metrics_tpu_torch.functional.image.ssim import structural_similarity_index_measure as t_ssim
from metrics_tpu_torch.image import StructuralSimilarityIndexMeasure as TSSIM

ATOL = 1e-5
PSNR_RTOL = 1e-6
VOLUME = (2, 2, 13, 14, 16)  # (B, C, D, H, W)


def _images(seed, shape=(2, 3, 24, 28), scale=1.0):
    rng = np.random.RandomState(seed)
    a = (rng.rand(*shape) * scale).astype(np.float32)
    b = (0.8 * a + 0.2 * rng.rand(*shape) * scale).astype(np.float32)
    return a, b


def _close(port, ref):
    if isinstance(ref, tuple):
        for p, r in zip(port, ref):
            _close(p, r)
        return
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"data_range": 1.0},
        {"data_range": (0.1, 0.9)},
        {"gaussian_kernel": False, "kernel_size": 7, "data_range": 1.0},
        {"gaussian_kernel": False, "kernel_size": (5, 9)},
        {"sigma": (1.0, 2.0), "data_range": 1.0},
        {"sigma": 0.5, "k1": 0.02, "k2": 0.05},
        {"reduction": "none"},
        {"reduction": "sum", "data_range": 1.0},
        {"return_full_image": True, "data_range": 1.0},
        {"return_contrast_sensitivity": True, "data_range": 1.0},
    ],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default",
)
def test_functional_ssim_matches_reference(kwargs):
    a, b = _images(0, scale=1.7)
    _close(t_ssim(torch.from_numpy(a), torch.from_numpy(b), **kwargs), j_ssim(jnp.asarray(a), jnp.asarray(b), **kwargs))


@pytest.mark.parametrize("data_range", [None, 1.0])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_ssim_metric_over_several_updates(data_range, reduction):
    port = TSSIM(data_range=data_range, reduction=reduction, device="cpu")
    ref = JSSIM(data_range=data_range, reduction=reduction)
    for seed in range(3):
        # batches of different value ranges: data_range=None is taken per batch
        a, b = _images(seed + 1, scale=1.0 + seed)
        port.update(torch.from_numpy(a), torch.from_numpy(b))
        ref.update(jnp.asarray(a), jnp.asarray(b))
    assert int(port.total) == int(ref.total) == 6
    _close(port.compute(), ref.compute())


def test_ssim_metric_returns_full_images():
    port = TSSIM(data_range=1.0, return_full_image=True, device="cpu")
    ref = JSSIM(data_range=1.0, return_full_image=True)
    a, b = _images(5)
    port.update(torch.from_numpy(a), torch.from_numpy(b))
    ref.update(jnp.asarray(a), jnp.asarray(b))
    got, want = port.compute(), ref.compute()
    assert got[1].shape == (2, 3, 24, 28)
    _close(got, want)


def test_ssim_input_validation():
    with pytest.raises(RuntimeError, match="same shape"):
        t_ssim(torch.rand(1, 1, 16, 16), torch.rand(1, 1, 16, 15))
    with pytest.raises(ValueError, match="BxCxHxW or BxCxDxHxW"):
        t_ssim(torch.rand(1, 16, 16), torch.rand(1, 16, 16))
    with pytest.raises(ValueError, match="odd positive"):
        t_ssim(torch.rand(1, 1, 16, 16), torch.rand(1, 1, 16, 16), gaussian_kernel=False, kernel_size=4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        t_ssim(torch.rand(1, 1, 16, 16), torch.rand(1, 1, 16, 16), return_full_image=True,
               return_contrast_sensitivity=True)
    with pytest.raises(ValueError, match="reduction"):
        TSSIM(reduction="max", device="cpu")


# ----------------------------------------------------------------------------- 3-D SSIM
@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"data_range": 1.0},
        {"data_range": (0.1, 0.9)},
        {"gaussian_kernel": False, "kernel_size": 5, "data_range": 1.0},
        {"gaussian_kernel": False, "kernel_size": (3, 5, 7)},
        {"sigma": (0.8, 1.0, 1.2), "data_range": 1.0},
        {"reduction": "none"},
        {"reduction": "sum", "data_range": 1.0},
        {"return_full_image": True, "data_range": 1.0},
        {"return_contrast_sensitivity": True, "data_range": 1.0},
    ],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default",
)
def test_functional_3d_ssim_matches_reference(kwargs):
    a, b = _images(10, shape=VOLUME, scale=1.3)
    _close(t_ssim(torch.from_numpy(a), torch.from_numpy(b), **kwargs), j_ssim(jnp.asarray(a), jnp.asarray(b), **kwargs))


@pytest.mark.parametrize("reduction", ["elementwise_mean", "none"])
def test_ssim_metric_takes_volumes(reduction):
    port = TSSIM(data_range=1.0, reduction=reduction, device="cpu")
    ref = JSSIM(data_range=1.0, reduction=reduction)
    for seed in range(2):
        a, b = _images(seed + 20, shape=VOLUME)
        port.update(torch.from_numpy(a), torch.from_numpy(b))
        ref.update(jnp.asarray(a), jnp.asarray(b))
    _close(port.compute(), ref.compute())


def test_3d_ssim_input_validation():
    vol = torch.rand(1, 1, 12, 12, 12)
    with pytest.raises(ValueError, match="two less than target"):
        t_ssim(vol, vol, gaussian_kernel=False, kernel_size=(3, 3))
    with pytest.raises(ValueError, match="odd positive"):
        t_ssim(vol, vol, gaussian_kernel=False, kernel_size=(3, 4, 3))


def test_reflect_pad_takes_three_spatial_dims():
    x = np.random.RandomState(3).rand(2, 3, 5, 6, 7).astype(np.float32)
    got = thelpers._reflect_pad(torch.from_numpy(x), [1, 2, 3])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jhelpers._reflect_pad(jnp.asarray(x), [1, 2, 3])))


@pytest.mark.parametrize("shape", [(2, 3, 8, 10), (1, 2, 9, 11), (1, 1, 7, 6)])
def test_avg_pool2d_drops_an_odd_last_row_or_column(shape):
    x = np.random.RandomState(4).rand(*shape).astype(np.float32)
    got = thelpers.avg_pool2d(torch.from_numpy(x), 2)
    want = np.asarray(jhelpers.avg_pool2d(jnp.asarray(x), 2))
    assert got.shape == want.shape == (*shape[:2], shape[2] // 2, shape[3] // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.numpy(), x[..., :shape[2] // 2 * 2, :shape[3] // 2 * 2]
                               .reshape(*shape[:2], shape[2] // 2, 2, shape[3] // 2, 2).mean((3, 5)), rtol=1e-6)


# ----------------------------------------------------------------------------- MS-SSIM
BETAS3 = (0.3, 0.4, 0.3)


@pytest.mark.parametrize("normalize", ["relu", "simple", None])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_functional_ms_ssim_matches_reference(normalize, reduction):
    a, b = _images(30, shape=(2, 3, 47, 53))
    kw = {"betas": BETAS3, "normalize": normalize, "reduction": reduction, "data_range": 1.0}
    _close(tfi.multiscale_structural_similarity_index_measure(torch.from_numpy(a), torch.from_numpy(b), **kw),
           jfi.multiscale_structural_similarity_index_measure(jnp.asarray(a), jnp.asarray(b), **kw))


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"data_range": (0.1, 0.9)},
        {"gaussian_kernel": False, "kernel_size": 7, "data_range": 1.0},
        {"sigma": (1.0, 1.3), "k1": 0.02, "k2": 0.04, "data_range": 1.0},
    ],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default",
)
def test_functional_ms_ssim_options_match_reference(kwargs):
    # dissimilar images: some contrast terms go negative, which the relu normalisation clips
    rng = np.random.RandomState(31)
    a = rng.rand(2, 2, 50, 46).astype(np.float32)
    b = np.where(rng.rand(2, 2, 50, 46) < 0.5, a, rng.rand(2, 2, 50, 46)).astype(np.float32)
    kw = {"betas": BETAS3, **kwargs}
    _close(tfi.multiscale_structural_similarity_index_measure(torch.from_numpy(a), torch.from_numpy(b), **kw),
           jfi.multiscale_structural_similarity_index_measure(jnp.asarray(a), jnp.asarray(b), **kw))


def test_ms_ssim_with_the_default_five_betas_at_180():
    a, b = _images(32, shape=(1, 3, 180, 180))
    _close(tfi.multiscale_structural_similarity_index_measure(torch.from_numpy(a), torch.from_numpy(b), data_range=1.0),
           jfi.multiscale_structural_similarity_index_measure(jnp.asarray(a), jnp.asarray(b), data_range=1.0))


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_ms_ssim_metric_over_several_updates(reduction):
    kw = {"betas": BETAS3, "reduction": reduction}
    port = ti.MultiScaleStructuralSimilarityIndexMeasure(device="cpu", **kw)
    ref = ji.MultiScaleStructuralSimilarityIndexMeasure(**kw)
    for seed in range(3):
        a, b = _images(seed + 33, shape=(2, 1, 45, 48), scale=1.0 + seed)
        port.update(torch.from_numpy(a), torch.from_numpy(b))
        ref.update(jnp.asarray(a), jnp.asarray(b))
    assert int(port.total) == int(ref.total) == 6
    _close(port.compute(), ref.compute())


def test_ms_ssim_input_validation():
    img = torch.rand(1, 1, 48, 48)
    ms_ssim = tfi.multiscale_structural_similarity_index_measure
    with pytest.raises(ValueError, match="3D images"):
        ms_ssim(torch.rand(1, 1, 48, 48, 48), torch.rand(1, 1, 48, 48, 48), betas=BETAS3)
    with pytest.raises(ValueError, match="larger than 176"):
        ms_ssim(img, img)
    with pytest.raises(ValueError, match="tuple of floats"):
        ms_ssim(img, img, betas=[0.5, 0.5])
    with pytest.raises(ValueError, match="normalize"):
        ms_ssim(img, img, betas=BETAS3, normalize="max")
    with pytest.raises(ValueError, match="tuple of floats"):
        ti.MultiScaleStructuralSimilarityIndexMeasure(betas=(1, 2), device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        ti.MultiScaleStructuralSimilarityIndexMeasure(reduction="max", device="cpu")


# ----------------------------------------------------------------------------- PSNR
def _psnr_close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=PSNR_RTOL, atol=0)


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"data_range": 1.0},
        {"data_range": (0.2, 0.8)},
        {"data_range": 1.0, "base": 2.0},
        {"data_range": 1.0, "dim": 1},
        {"data_range": 1.0, "dim": (1, 2), "reduction": "none"},
        {"data_range": (0.0, 0.9), "dim": (2, 3), "reduction": "sum"},
    ],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default",
)
def test_functional_psnr_matches_reference(kwargs):
    a, b = _images(40, shape=(3, 2, 10, 12))
    _psnr_close(tfi.peak_signal_noise_ratio(torch.from_numpy(a), torch.from_numpy(b), **kwargs),
                jfi.peak_signal_noise_ratio(jnp.asarray(a), jnp.asarray(b), **kwargs))


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"data_range": 1.0}, {"data_range": (0.1, 0.7)}, {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"},
     {"data_range": 2.0, "dim": 1}],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default",
)
def test_psnr_metric_over_several_updates(kwargs):
    port, ref = ti.PeakSignalNoiseRatio(device="cpu", **kwargs), ji.PeakSignalNoiseRatio(**kwargs)
    for seed in range(3):
        # targets of different ranges: without data_range the span is that of every target seen
        a, b = _images(seed + 41, shape=(2, 3, 8, 9), scale=1.0 + seed)
        port.update(torch.from_numpy(a), torch.from_numpy(b))
        ref.update(jnp.asarray(a), jnp.asarray(b))
    if "data_range" not in kwargs:
        assert float(port.min_target) == float(ref.min_target) and float(port.max_target) == float(ref.max_target)
    _psnr_close(port.compute(), ref.compute())


def test_psnr_total_passes_2_to_the_31_without_wrapping():
    """A running count past 2^31 pixels (about 259 DIV2K pairs of 3 x 1356 x 2040) stays exact, and PSNR equals
    its float64 value from the same states."""
    psnr = ti.PeakSignalNoiseRatio(data_range=1.0, device="cpu")
    psnr.total = torch.tensor(2**31 - 1000, dtype=psnr.total.dtype)
    psnr.sum_squared_error = torch.tensor(float(psnr.total) * 1.5e-3, dtype=torch.float32)
    sse0, total0 = float(psnr.sum_squared_error), int(psnr.total)
    rng = np.random.RandomState(43)
    target = rng.rand(1, 3, 1356, 2040).astype(np.float32)
    preds = np.clip(target + 0.04 * rng.randn(*target.shape), 0, 1).astype(np.float32)
    psnr.update(torch.from_numpy(preds), torch.from_numpy(target))
    sse1 = float(((preds.astype(np.float64) - target) ** 2).sum())
    assert psnr.total.dtype == torch.int64 and int(psnr.total) == total0 + target.size > 2**31
    got = psnr.compute()
    want = 10 * np.log10(1.0 / ((sse0 + sse1) / (total0 + target.size)))
    assert bool(torch.isfinite(got))
    np.testing.assert_allclose(float(got), want, rtol=PSNR_RTOL, atol=0)
    _, num_obs = tfi.psnr._psnr_update(torch.from_numpy(preds), torch.from_numpy(target), dim=(1, 2, 3))
    assert num_obs.dtype == torch.int64


def test_psnr_input_validation():
    x = torch.rand(2, 4)
    with pytest.raises(ValueError, match="data_range"):
        tfi.peak_signal_noise_ratio(x, x, dim=1)
    with pytest.raises(ValueError, match="data_range"):
        ti.PeakSignalNoiseRatio(dim=1, device="cpu")
    with pytest.raises(RuntimeError, match="same shape"):
        tfi.peak_signal_noise_ratio(x, x[:1])
    with pytest.warns(UserWarning, match="not have any effect"):
        tfi.peak_signal_noise_ratio(x, x * 0.5, reduction="sum")
