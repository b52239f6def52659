"""The port's UQI, SAM, ERGAS, RMSE-SW, RASE, TV, SCC, PSNR-B, VIF, D_lambda, D_s, QNR and image gradients
against the JAX package's, on the same seeded numpy inputs.

Tolerances, and why:

* the gaussian and uniform taps, the symmetric padding and image gradients are equal;
* UQI, SCC and RMSE-SW values within atol 1e-5: the JAX package convolves with the dense 2-D window, the port
  applies its two 1-D factors one after the other (the window kernel's route), so the window sums round
  differently (1/49 against (1/7)², and the order of the products);
* VIF within rtol 1e-4: its log10 sums run over whole maps of such window sums;
* every other value within rtol 1e-5, atol 1e-7: float32 reductions taken in another order.
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
from metrics_tpu.functional.image import _helpers as jh
from metrics_tpu_torch.functional.image import _helpers as th
from metrics_tpu_torch.interop import load_reference_state

WINDOW_ATOL = 1e-5
VIF_RTOL = 1e-4
RTOL, ATOL = 1e-5, 1e-7


def _pair(seed, shape=(3, 4, 40, 44), scale=1.0):
    rng = np.random.RandomState(seed)
    a = (rng.rand(*shape) * scale).astype(np.float32)
    b = (0.8 * a + 0.2 * rng.rand(*shape) * scale).astype(np.float32)
    return a, b


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _close(port, ref, atol=ATOL, rtol=RTOL):
    if isinstance(ref, (tuple, list)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _close(p, r, atol, rtol)
        return
    ref = np.asarray(ref)
    port = np.asarray(port)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=atol, rtol=rtol)


# ----------------------------------------------------------------------------- helpers
@pytest.mark.parametrize("kernel_size", [1, 2, 3, 5, 7, 8, 9, 11, 17, 21, 32])
@pytest.mark.parametrize("sigma", [0.6, 1.5, 3.4])
def test_gaussian_taps_equal_the_reference(kernel_size, sigma):
    want = np.asarray(jh._gaussian(kernel_size, sigma))
    np.testing.assert_array_equal(th._gaussian(kernel_size, sigma).numpy(), want)


@pytest.mark.parametrize(
    ("kernel_size", "sigma"), [((11, 11), (1.5, 1.5)), ((17, 9), (3.4, 1.8)), ((3, 5), (0.6, 1.0))]
)
def test_dense_kernels_equal_the_reference(kernel_size, sigma):
    want = np.asarray(jh._gaussian_kernel_2d(3, kernel_size, sigma))
    np.testing.assert_array_equal(th._gaussian_kernel_2d(3, kernel_size, sigma).numpy(), want)
    want = np.asarray(jh._uniform_kernel(2, kernel_size))
    np.testing.assert_array_equal(th._uniform_kernel(2, kernel_size).numpy(), want)


@pytest.mark.parametrize("pads", [[(1, 1), (1, 1)], [(0, 2), (3, 0)], [(20, 9), (1, 30)]])
def test_symmetric_pad_equals_numpy(pads):
    x = np.random.RandomState(0).rand(2, 3, 7, 9).astype(np.float32)
    want = np.pad(x, [(0, 0), (0, 0), *pads], mode="symmetric")
    np.testing.assert_array_equal(th._symmetric_pad(torch.from_numpy(x), pads).numpy(), want)


@pytest.mark.parametrize("window_size", [1, 2, 3, 7, 8])
def test_scipy_uniform_filter_matches_reference(window_size):
    x = np.random.RandomState(window_size).rand(2, 3, 19, 23).astype(np.float32)
    got = th.scipy_uniform_filter(torch.from_numpy(x), window_size)
    _close(got, jh.scipy_uniform_filter(jnp.asarray(x), window_size), atol=1e-6, rtol=0)


@pytest.mark.parametrize("window", [(3, 3), (5, 3), (2, 4)])
def test_depthwise_conv_matches_reference(window):
    rng = np.random.RandomState(1)
    x = rng.rand(2, 3, 12, 13).astype(np.float32)
    k = rng.randn(3, 1, *window).astype(np.float32)
    _close(th.depthwise_conv(*_t(x, k)), jh.depthwise_conv(*_j(x, k)), atol=WINDOW_ATOL, rtol=0)


@pytest.mark.parametrize("size", [(16, 16), (37, 23), (128, 100), (64, 64)])
def test_resize_bilinear_antialiases_as_the_reference(size):
    x = np.random.RandomState(2).rand(2, 3, 64, 64).astype(np.float32)
    _close(th.resize_bilinear(torch.from_numpy(x), size), jh.resize_bilinear(jnp.asarray(x), size), atol=1e-6, rtol=0)


# ----------------------------------------------------------------------------- functions
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
@pytest.mark.parametrize(("kernel_size", "sigma"), [((11, 11), (1.5, 1.5)), ((7, 5), (1.0, 2.0))])
def test_uqi_matches_reference(reduction, kernel_size, sigma):
    a, b = _pair(0)
    port = tfi.universal_image_quality_index(*_t(a, b), kernel_size, sigma, reduction)
    ref = jfi.universal_image_quality_index(*_j(a, b), kernel_size, sigma, reduction)
    # "sum" adds some 6,000 map values of about 1
    _close(port, ref, atol=WINDOW_ATOL if reduction != "sum" else 1e-2, rtol=0 if reduction != "sum" else 1e-6)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_sam_and_ergas_match_reference(reduction):
    a, b = _pair(1, scale=3.0)
    _close(tfi.spectral_angle_mapper(*_t(a, b), reduction), jfi.spectral_angle_mapper(*_j(a, b), reduction))
    for ratio in (4, 2.5):
        _close(
            tfi.error_relative_global_dimensionless_synthesis(*_t(a, b), ratio, reduction),
            jfi.error_relative_global_dimensionless_synthesis(*_j(a, b), ratio, reduction),
        )


def test_sam_and_ergas_input_validation():
    a, b = _pair(2, shape=(2, 1, 8, 8))
    with pytest.raises(ValueError, match="C > 1"):
        tfi.spectral_angle_mapper(*_t(a, b))
    with pytest.raises(ValueError, match="BxCxHxW"):
        tfi.error_relative_global_dimensionless_synthesis(*_t(a[0], b[0]))
    with pytest.raises(RuntimeError, match="same shape"):
        tfi.spectral_angle_mapper(*_t(a, b[:1]))


@pytest.mark.parametrize("window_size", [3, 7, 8])
def test_rmse_sw_and_rase_match_reference(window_size):
    a, b = _pair(3)
    port = tfi.root_mean_squared_error_using_sliding_window(*_t(a, b), window_size, return_rmse_map=True)
    ref = jfi.root_mean_squared_error_using_sliding_window(*_j(a, b), window_size, return_rmse_map=True)
    _close(port, ref, atol=WINDOW_ATOL, rtol=0)
    _close(tfi.root_mean_squared_error_using_sliding_window(*_t(a, b), window_size), ref[0], atol=WINDOW_ATOL, rtol=0)
    _close(tfi.relative_average_spectral_error(*_t(a, b), window_size),
           jfi.relative_average_spectral_error(*_j(a, b), window_size))


def test_rmse_sw_window_size_bound():
    a, b = _pair(4, shape=(1, 2, 8, 9))
    with pytest.raises(ValueError, match="smaller than 8"):
        tfi.root_mean_squared_error_using_sliding_window(*_t(a, b), window_size=16)
    with pytest.raises(ValueError, match="positive integer"):
        tfi.root_mean_squared_error_using_sliding_window(*_t(a, b), window_size=0)
    with pytest.raises(ValueError, match="positive integer"):
        tfi.relative_average_spectral_error(*_t(a, b), window_size=2.5)
    with pytest.raises(ValueError, match="positive integer"):
        ti.RootMeanSquaredErrorUsingSlidingWindow(window_size=0, device="cpu")


@pytest.mark.parametrize("reduction", ["sum", "mean", "elementwise_mean", "none", None])
def test_total_variation_matches_reference(reduction):
    a, _ = _pair(5, scale=255.0)
    _close(tfi.total_variation(torch.from_numpy(a), reduction), jfi.total_variation(jnp.asarray(a), reduction))
    with pytest.raises(RuntimeError, match="4D"):
        tfi.total_variation(torch.from_numpy(a[0]))


@pytest.mark.parametrize("window_size", [3, 7, 8])
@pytest.mark.parametrize("reduction", ["mean", "none", None])
def test_scc_matches_reference(window_size, reduction):
    a, b = _pair(6)
    _close(tfi.spatial_correlation_coefficient(*_t(a, b), window_size=window_size, reduction=reduction),
           jfi.spatial_correlation_coefficient(*_j(a, b), window_size=window_size, reduction=reduction),
           atol=WINDOW_ATOL, rtol=0)


@pytest.mark.parametrize("hp_shape", [(3, 3), (5, 3), (2, 4)])
def test_scc_with_a_user_filter_and_3d_inputs(hp_shape):
    a, b = _pair(7)
    hp = np.random.RandomState(8).randn(*hp_shape).astype(np.float32)
    _close(tfi.spatial_correlation_coefficient(*_t(a, b), hp_filter=torch.from_numpy(hp)),
           jfi.spatial_correlation_coefficient(*_j(a, b), hp_filter=jnp.asarray(hp)), atol=WINDOW_ATOL, rtol=0)
    _close(tfi.spatial_correlation_coefficient(*_t(a[:, 0], b[:, 0])),
           jfi.spatial_correlation_coefficient(*_j(a[:, 0], b[:, 0])), atol=WINDOW_ATOL, rtol=0)
    with pytest.raises(ValueError, match="'mean' or 'none'"):
        tfi.spatial_correlation_coefficient(*_t(a, b), reduction="sum")


@pytest.mark.parametrize("block_size", [8, 5, 4, 64])
@pytest.mark.parametrize("scale", [1.0, 255.0])
def test_psnrb_matches_reference(block_size, scale):
    a, b = _pair(9, shape=(3, 1, 40, 44), scale=scale)
    _close(tfi.peak_signal_noise_ratio_with_blocked_effect(*_t(a, b), block_size),
           jfi.peak_signal_noise_ratio_with_blocked_effect(*_j(a, b), block_size))


def test_psnrb_refuses_colour():
    a, b = _pair(10, shape=(2, 3, 16, 16))
    with pytest.raises(ValueError, match="grayscale"):
        tfi.peak_signal_noise_ratio_with_blocked_effect(*_t(a, b))
    with pytest.raises(ValueError, match="positive integer"):
        ti.PeakSignalNoiseRatioWithBlockedEffect(block_size=0, device="cpu")


@pytest.mark.parametrize(("shape", "sigma_n_sq"), [((2, 1, 41, 41), 2.0), ((2, 3, 41, 41), 2.0),
                                                   ((3, 1, 64, 80), 0.5), ((1, 3, 57, 45), 10.0)])
def test_vif_matches_reference(shape, sigma_n_sq):
    a, b = _pair(11, shape=shape, scale=255.0)
    _close(tfi.visual_information_fidelity(*_t(a, b), sigma_n_sq),
           jfi.visual_information_fidelity(*_j(a, b), sigma_n_sq), atol=0, rtol=VIF_RTOL)


def test_vif_refuses_images_below_41():
    a, b = _pair(12, shape=(1, 1, 40, 41))
    with pytest.raises(ValueError, match="at least 41x41"):
        tfi.visual_information_fidelity(*_t(a, b))
    with pytest.raises(ValueError, match="sigma_n_sq"):
        ti.VisualInformationFidelity(sigma_n_sq=-1.0, device="cpu")


def _pansharpening(seed, b=3, c=4, lr=(20, 22), hr=(40, 44)):
    rng = np.random.RandomState(seed)
    preds = rng.rand(b, c, *hr).astype(np.float32)
    ms = rng.rand(b, c, *lr).astype(np.float32)
    pan = (0.7 * preds + 0.3 * rng.rand(b, c, *hr)).astype(np.float32)
    pan_lr = rng.rand(b, c, *lr).astype(np.float32)
    return preds, ms, pan, pan_lr


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "mean", "sum", "none"])
@pytest.mark.parametrize("channels", [2, 4])
def test_spectral_distortion_index_matches_reference(p, reduction, channels):
    preds, ms, _, _ = _pansharpening(13, c=channels)
    _close(tfi.spectral_distortion_index(*_t(preds, ms), p, reduction),
           jfi.spectral_distortion_index(*_j(preds, ms), p, reduction), atol=1e-6)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "none"])
def test_spectral_distortion_index_of_one_band(reduction):
    """With one band, D_lambda is the difference of two images' UQI against themselves: 1 up to rounding, so
    the value is rounding noise of about 1e-7 (p = 1 only: a root of it would magnify the noise)."""
    preds, ms, _, _ = _pansharpening(13, c=1)
    _close(tfi.spectral_distortion_index(*_t(preds, ms), 1, reduction),
           jfi.spectral_distortion_index(*_j(preds, ms), 1, reduction), atol=1e-6)


def test_spectral_distortion_index_input_validation():
    preds, ms, _, _ = _pansharpening(14)
    with pytest.raises(ValueError, match="positive integer"):
        tfi.spectral_distortion_index(*_t(preds, ms), p=0)
    with pytest.raises(ValueError, match="same batch and channel"):
        tfi.spectral_distortion_index(*_t(preds, ms[:, :2]))
    with pytest.raises(ValueError, match="BxCxHxW"):
        tfi.spectral_distortion_index(*_t(preds[0], ms[0]))


@pytest.mark.parametrize("with_pan_lr", [False, True])
@pytest.mark.parametrize(("norm_order", "window_size"), [(1, 7), (2, 5)])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_spatial_distortion_index_both_signatures(with_pan_lr, norm_order, window_size, reduction):
    preds, ms, pan, pan_lr = _pansharpening(15)
    lr = pan_lr if with_pan_lr else None
    ref = jfi.spatial_distortion_index(*_j(preds, ms, pan), None if lr is None else jnp.asarray(lr),
                                       norm_order, window_size, reduction)
    port = tfi.spatial_distortion_index(*_t(preds, ms, pan), None if lr is None else torch.from_numpy(lr),
                                        norm_order, window_size, reduction)
    _close(port, ref, atol=1e-6)
    target = {"ms": torch.from_numpy(ms), "pan": torch.from_numpy(pan)}
    if with_pan_lr:
        target["pan_lr"] = torch.from_numpy(pan_lr)
    by_dict = tfi.spatial_distortion_index(torch.from_numpy(preds), target, norm_order=norm_order,
                                           window_size=window_size, reduction=reduction)
    torch.testing.assert_close(by_dict, port, rtol=0, atol=0)


def test_spatial_distortion_index_input_validation():
    preds, ms, pan, _ = _pansharpening(16)
    target = {"ms": torch.from_numpy(ms), "pan": torch.from_numpy(pan)}
    with pytest.raises(ValueError, match="keyword arguments"):
        tfi.spatial_distortion_index(torch.from_numpy(preds), target, 1)
    with pytest.raises(ValueError, match="keys"):
        tfi.spatial_distortion_index(torch.from_numpy(preds), {"ms": torch.from_numpy(ms)})
    with pytest.raises(ValueError, match="`ms` and `pan`"):
        tfi.spatial_distortion_index(torch.from_numpy(preds), torch.from_numpy(ms))
    with pytest.raises(ValueError, match="window_size"):
        tfi.spatial_distortion_index(*_t(preds, ms, pan), window_size=20)
    with pytest.raises(ValueError, match="norm_order"):
        tfi.spatial_distortion_index(*_t(preds, ms, pan), norm_order=0)
    with pytest.raises(ValueError, match="same batch and channel"):
        tfi.spatial_distortion_index(*_t(preds, ms[:, :2], pan))
    with pytest.raises(ValueError, match="keys"):
        ti.SpatialDistortionIndex(device="cpu").update(torch.from_numpy(preds), torch.from_numpy(ms))


@pytest.mark.parametrize(("alpha", "beta"), [(1.0, 1.0), (0.5, 2.0)])
@pytest.mark.parametrize("with_pan_lr", [False, True])
def test_qnr_matches_reference(alpha, beta, with_pan_lr):
    preds, ms, pan, pan_lr = _pansharpening(17)
    jt = {"ms": jnp.asarray(ms), "pan": jnp.asarray(pan)}
    tt = {"ms": torch.from_numpy(ms), "pan": torch.from_numpy(pan)}
    if with_pan_lr:
        jt["pan_lr"], tt["pan_lr"] = jnp.asarray(pan_lr), torch.from_numpy(pan_lr)
    ref = jfi.quality_with_no_reference(jnp.asarray(preds), jt, alpha=alpha, beta=beta)
    _close(tfi.quality_with_no_reference(torch.from_numpy(preds), tt, alpha=alpha, beta=beta), ref, atol=1e-6)
    positional = tfi.quality_with_no_reference(*_t(preds, ms, pan), torch.from_numpy(pan_lr) if with_pan_lr else None,
                                               alpha, beta)
    _close(positional, ref, atol=1e-6)


def test_image_gradients_equal_the_reference():
    a, _ = _pair(18)
    for port, ref in zip(tfi.image_gradients(torch.from_numpy(a)), jfi.image_gradients(jnp.asarray(a))):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    with pytest.raises(RuntimeError, match="does not match"):
        tfi.image_gradients(torch.from_numpy(a[0]))


# ----------------------------------------------------------------------------- classes
PAIRED = [
    ("UniversalImageQualityIndex", {}, WINDOW_ATOL, 0.0),
    ("UniversalImageQualityIndex", {"kernel_size": (5, 7), "sigma": (1.0, 1.2), "reduction": "none"}, WINDOW_ATOL, 0.0),
    ("SpectralAngleMapper", {}, ATOL, RTOL),
    ("SpectralAngleMapper", {"reduction": "none"}, ATOL, RTOL),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {"ratio": 2}, ATOL, RTOL),
    ("RelativeAverageSpectralError", {"window_size": 5}, ATOL, RTOL),
    ("RootMeanSquaredErrorUsingSlidingWindow", {}, WINDOW_ATOL, 0.0),
    ("SpatialCorrelationCoefficient", {"window_size": 7}, WINDOW_ATOL, 0.0),
    ("VisualInformationFidelity", {"sigma_n_sq": 1.0}, 0.0, VIF_RTOL),
    ("SpectralDistortionIndex", {"p": 2}, 1e-6, RTOL),
]
PAIRED_IDS = [f"{name}-{i}" for i, (name, *_) in enumerate(PAIRED)]


def _paired_batches(name, seed):
    shape = (2, 3, 44, 48) if name != "SpectralDistortionIndex" else (2, 3, 32, 36)
    a, b = _pair(seed, shape=shape, scale=255.0 if name == "VisualInformationFidelity" else 1.0)
    if name == "SpectralDistortionIndex":
        b = b[..., ::2, ::2].copy()
    return a, b


@pytest.mark.parametrize(("name", "kwargs", "atol", "rtol"), PAIRED, ids=PAIRED_IDS)
def test_sample_store_classes_over_several_updates(name, kwargs, atol, rtol):
    port, ref = getattr(ti, name)(device="cpu", **kwargs), getattr(ji, name)(**kwargs)
    for seed in (20, 21, 22):
        a, b = _paired_batches(name, seed)
        port.update(*_t(a, b))
        ref.update(*_j(a, b))
    _close(port.compute(), ref.compute(), atol=atol, rtol=rtol)


def test_psnrb_class_over_several_updates():
    port, ref = ti.PeakSignalNoiseRatioWithBlockedEffect(device="cpu"), ji.PeakSignalNoiseRatioWithBlockedEffect()
    for seed in (23, 24):
        a, b = _pair(seed, shape=(2, 1, 32, 40), scale=255.0)
        port.update(*_t(a, b))
        ref.update(*_j(a, b))
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_total_variation_class_over_several_updates(reduction):
    port, ref = ti.TotalVariation(reduction, device="cpu"), ji.TotalVariation(reduction)
    for seed in (25, 26, 27):
        a, _ = _pair(seed, shape=(2, 3, 20, 24))
        port.update(torch.from_numpy(a))
        ref.update(jnp.asarray(a))
    _close(port.compute(), ref.compute())
    assert port.update_count == 3
    with pytest.raises(ValueError, match="'sum', 'mean', 'none' or None"):
        ti.TotalVariation("max", device="cpu")


@pytest.mark.parametrize("name", ["SpatialDistortionIndex", "QualityWithNoReference"])
@pytest.mark.parametrize("with_pan_lr", [False, True])
def test_pansharpening_classes_over_several_updates(name, with_pan_lr):
    port, ref = getattr(ti, name)(device="cpu"), getattr(ji, name)()
    for seed in (28, 29):
        preds, ms, pan, pan_lr = _pansharpening(seed, b=2)
        tt = {"ms": torch.from_numpy(ms), "pan": torch.from_numpy(pan)}
        jt = {"ms": jnp.asarray(ms), "pan": jnp.asarray(pan)}
        if with_pan_lr:
            tt["pan_lr"], jt["pan_lr"] = torch.from_numpy(pan_lr), jnp.asarray(pan_lr)
        port.update(torch.from_numpy(preds), tt)
        ref.update(jnp.asarray(preds), jt)
    _close(port.compute(), ref.compute(), atol=1e-6)


def _fake_sync(peers):
    """A dist_sync_fn handing back each state beside the peers' values of the same state, in rank order."""
    def sync_fn(states, group):
        return [[local] + [list(peer.values())[i] for peer in peers] for i, local in enumerate(states)]
    return sync_fn


def _fed(make, feed, seeds):
    metric = make()
    for seed in seeds:
        feed(metric, seed)
    return metric


def _feed_uqi(metric, seed):
    metric.update(*_t(*_pair(seed, shape=(2, 2, 24, 26))))


def _feed_tv(metric, seed):
    metric.update(torch.from_numpy(_pair(seed, shape=(2, 2, 24, 26))[0]))


SPLIT = [
    ("UniversalImageQualityIndex", lambda: ti.UniversalImageQualityIndex(device="cpu"), _feed_uqi),
    ("TotalVariation-sum", lambda: ti.TotalVariation(device="cpu"), _feed_tv),
    ("TotalVariation-mean", lambda: ti.TotalVariation("mean", device="cpu"), _feed_tv),
    ("TotalVariation-none", lambda: ti.TotalVariation("none", device="cpu"), _feed_tv),
]


@pytest.mark.parametrize(("label", "make", "feed"), SPLIT, ids=[s[0] for s in SPLIT])
def test_split_update_merge_equals_the_single_stream(label, make, feed):
    whole = _fed(make, feed, (30, 31, 32))
    shards = [_fed(make, feed, (s,)) for s in (30, 31, 32)]
    for shard in reversed(shards[:-1]):  # an incoming state's samples go first
        shards[-1].merge_state(shard)
    _close(shards[-1].compute(), whole.compute(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize(("label", "make", "feed"), SPLIT, ids=[s[0] for s in SPLIT])
def test_sync_through_a_fake_dist_sync_fn_equals_the_single_stream(label, make, feed):
    port = _fed(make, feed, (33,))
    peers = [dict(_fed(make, feed, (s,)).metric_state) for s in (34, 35)]
    local = dict(port.metric_state)
    port.sync(dist_sync_fn=_fake_sync(peers), distributed_available=True)
    _close(port._compute_impl(), _fed(make, feed, (33, 34, 35)).compute(), atol=1e-6, rtol=1e-6)
    port.unsync()
    for key, value in local.items():
        restored = port.metric_state[key]
        if isinstance(value, list):
            assert len(restored) == len(value) and all(a is b for a, b in zip(restored, value))
        else:
            assert restored is value


STATE_CASES = [
    ("UniversalImageQualityIndex", {}), ("SpectralAngleMapper", {}),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {}), ("RelativeAverageSpectralError", {}),
    ("RootMeanSquaredErrorUsingSlidingWindow", {}), ("TotalVariation", {}), ("TotalVariation", {"reduction": "none"}),
    ("SpatialCorrelationCoefficient", {}), ("PeakSignalNoiseRatioWithBlockedEffect", {}),
    ("VisualInformationFidelity", {}), ("SpectralDistortionIndex", {}), ("SpatialDistortionIndex", {}),
    ("QualityWithNoReference", {}),
]


@pytest.mark.parametrize(("name", "kwargs"), STATE_CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(STATE_CASES)])
def test_reference_state_loads_into_the_port(name, kwargs):
    port, ref = getattr(ti, name)(device="cpu", **kwargs), getattr(ji, name)(**kwargs)
    channels = 1 if name == "PeakSignalNoiseRatioWithBlockedEffect" else 3

    def feed(metric, as_array, seed):
        preds, ms, pan, _ = _pansharpening(seed, b=2, c=channels, lr=(21, 22), hr=(42, 44))
        if name == "TotalVariation":
            metric.update(as_array(preds))
        elif name in ("SpatialDistortionIndex", "QualityWithNoReference"):
            metric.update(as_array(preds), {"ms": as_array(ms), "pan": as_array(pan)})
        else:
            metric.update(as_array(preds), as_array(pan))

    for seed in (40, 41):
        feed(ref, jnp.asarray, seed)
    ref.persistent(True)
    load_reference_state(port, ref.state_dict())
    assert port.update_count == 2
    feed(ref, jnp.asarray, 42)
    feed(port, torch.from_numpy, 42)
    rtol = VIF_RTOL if name == "VisualInformationFidelity" else 1e-5
    _close(port.compute(), ref.compute(), atol=WINDOW_ATOL, rtol=rtol)
