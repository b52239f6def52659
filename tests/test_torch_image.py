"""The port's 2-D SSIM against the JAX package's on the same seeded images, at atol 1e-5.

The window sums reassociate nowhere (both run the same shifted-slice cascade
on the CPU), but the epilogue's float32 arithmetic is free to round
differently in the two frameworks.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.functional.image.ssim import structural_similarity_index_measure as j_ssim
from metrics_tpu.image import StructuralSimilarityIndexMeasure as JSSIM
from metrics_tpu_torch.functional.image.ssim import structural_similarity_index_measure as t_ssim
from metrics_tpu_torch.image import StructuralSimilarityIndexMeasure as TSSIM

ATOL = 1e-5


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
    with pytest.raises(ValueError, match="BxCxHxW"):
        t_ssim(torch.rand(1, 1, 4, 16, 16), torch.rand(1, 1, 4, 16, 16))
    with pytest.raises(ValueError, match="odd positive"):
        t_ssim(torch.rand(1, 1, 16, 16), torch.rand(1, 1, 16, 16), gaussian_kernel=False, kernel_size=4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        t_ssim(torch.rand(1, 1, 16, 16), torch.rand(1, 1, 16, 16), return_full_image=True,
               return_contrast_sensitivity=True)
    with pytest.raises(ValueError, match="reduction"):
        TSSIM(reduction="max", device="cpu")
