"""The port's model-based image metrics held against the JAX package's (``tests/test_model_based.py``).

FID, KID, IS, MiFID, LPIPS and PPL take the same numpy inputs in both packages, through injected functions
and through backbones carried across from the same weights (SimpleFeatureCNN from flax variables; the LPIPS
tower and heads from local ``.pth`` files that both packages' hubs read). Tolerances, on float32 outputs of
float64 computes: FID and MiFID ``rtol = 1e-5``, KID ``rtol = 1e-6`` (the same float32 features and the same
subset draws), IS ``rtol = 1e-5``, LPIPS and PPL ``rtol = 1e-4`` (a float32 network on each side). FID's
float32 states, formed from float64 sums, agree to ``rtol = 1e-6``. Then the JAX package's own image cases of
that file, run on the port, and ``FeatureShare``'s single forward.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.image as ji
import metrics_tpu.wrappers as jw
import metrics_tpu_torch.image as ti
import metrics_tpu_torch.wrappers as tw
from metrics_tpu.functional.image.perceptual import perceptual_path_length as j_ppl
from metrics_tpu_torch.functional.image.perceptual import perceptual_path_length as t_ppl

CPU = {"device": "cpu"}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gaussians(seed=0, n=400, d=16, shift=0.7):
    rng = np.random.default_rng(seed)
    real = rng.standard_normal((n, d)).astype(np.float32)
    fake = (rng.standard_normal((n, d)) * 1.3 + shift).astype(np.float32)
    return real, fake


def _fed(jm, tm, real, fake, batches=4):
    for r, f in zip(np.array_split(real, batches), np.array_split(fake, batches)):
        jm.update(jnp.asarray(r), real=True)
        jm.update(jnp.asarray(f), real=False)
        tm.update(torch.from_numpy(r), real=True)
        tm.update(torch.from_numpy(f), real=False)


# ------------------------------------------------------------------ FID
def test_fid_states_and_value_equal_the_jax_package_s():
    real, fake = _gaussians()
    jm, tm = ji.FrechetInceptionDistance(), ti.FrechetInceptionDistance(**CPU)
    _fed(jm, tm, real, fake)
    for k in ("real_features_sum", "real_features_cov_sum", "fake_features_sum", "fake_features_cov_sum"):
        np.testing.assert_allclose(_np(tm._state[k]), np.asarray(jm._state[k]), rtol=1e-6, atol=1e-6, err_msg=k)
        assert tm._state[k].dtype == torch.float32
    assert int(tm.real_features_num_samples) == int(jm.real_features_num_samples) == 400
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=1e-5)


def test_fid_through_a_carried_feature_network_equals_the_jax_package_s():
    """SimpleFeatureCNN carried from the same flax variables extracts on each side, for FID, MiFID, KID and IS."""
    from metrics_tpu.models.simple_cnn import SimpleFeatureCNN as JCNN

    from metrics_tpu_torch.models.simple_cnn import SimpleFeatureCNN, from_flax_variables

    variables = JCNN().init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))
    jnet = jax.jit(lambda x: JCNN().apply(variables, x))
    tnet = SimpleFeatureCNN()
    tnet.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, variables)))
    tnet.eval()

    def textract(x):
        with torch.no_grad():
            return tnet(x)

    rng = np.random.default_rng(1)
    imgs = rng.random((64, 3, 32, 32), dtype=np.float32)
    for cls in ("FrechetInceptionDistance", "MemorizationInformedFrechetInceptionDistance"):
        jm, tm = getattr(ji, cls)(feature=jnet, normalize=True), getattr(ti, cls)(feature=textract, normalize=True,
                                                                                 **CPU)
        _fed(jm, tm, imgs[:32], np.clip(imgs[32:] * 0.8 + 0.1, 0, 1), batches=2)
        np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=1e-4, err_msg=cls)
    jk = ji.KernelInceptionDistance(feature=jnet, subsets=4, subset_size=16)
    tk = ti.KernelInceptionDistance(feature=textract, subsets=4, subset_size=16, **CPU)
    _fed(jk, tk, imgs[:32], imgs[32:], batches=2)
    np.testing.assert_allclose([float(v) for v in tk.compute()], [float(v) for v in jk.compute()], rtol=1e-4)
    js, ts = ji.InceptionScore(feature=jnet, splits=4), ti.InceptionScore(feature=textract, splits=4, **CPU)
    js.update(jnp.asarray(imgs))
    ts.update(torch.from_numpy(imgs))
    (tmean, tstd), (jmean, jstd) = ts.compute(), js.compute()
    np.testing.assert_allclose(float(tmean), float(jmean), rtol=1e-4)
    # the splits' scores are all within 1e-4 of 1: their std is float32 rounding of values near 1 (ulp 1.2e-7)
    np.testing.assert_allclose(float(tstd), float(jstd), rtol=0, atol=1e-6)


@pytest.mark.parametrize("reset_real", [True, False])
def test_fid_reset_keeps_the_real_statistics_as_the_jax_package_does(reset_real):
    real, fake = _gaussians(2, n=200, d=6)
    jm = ji.FrechetInceptionDistance(reset_real_features=reset_real)
    tm = ti.FrechetInceptionDistance(reset_real_features=reset_real, **CPU)
    _fed(jm, tm, real, fake)
    jm.reset()
    tm.reset()
    for k in ("real_features_sum", "fake_features_sum"):
        np.testing.assert_allclose(_np(tm._state[k]), np.asarray(jm._state[k]), rtol=1e-6, atol=1e-6)
    if not reset_real:
        jm.update(jnp.asarray(fake), real=False)
        tm.update(torch.from_numpy(fake), real=False)
        np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=1e-5)


def test_fid_vs_closed_form():
    """FID between two gaussians matches the analytic Fréchet distance of the empirical moments."""
    rng = np.random.RandomState(99)
    d = 8
    real = rng.randn(5000, d)
    fake = rng.randn(5000, d) * 1.5 + 1.0
    fid = ti.FrechetInceptionDistance(feature=None, **CPU)
    fid.update(torch.from_numpy(real.astype(np.float32)), real=True)
    fid.update(torch.from_numpy(fake.astype(np.float32)), real=False)
    got = float(fid.compute())
    mu1, mu2 = real.mean(0), fake.mean(0)
    c1, c2 = np.cov(real, rowvar=False), np.cov(fake, rowvar=False)
    from scipy.linalg import sqrtm

    ref = float((mu1 - mu2) @ (mu1 - mu2) + np.trace(c1 + c2 - 2 * sqrtm(c1 @ c2).real))
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_fid_identical_near_zero_and_reset_real():
    feats = np.random.RandomState(1).randn(500, 6).astype(np.float32)
    fid = ti.FrechetInceptionDistance(feature=None, reset_real_features=False, **CPU)
    fid.update(torch.from_numpy(feats), real=True)
    fid.update(torch.from_numpy(feats), real=False)
    np.testing.assert_allclose(float(fid.compute()), 0.0, atol=1e-4)
    fid.reset()
    fid.update(torch.from_numpy(feats), real=False)
    np.testing.assert_allclose(float(fid.compute()), 0.0, atol=1e-4)


def test_fid_requires_two_samples_and_checks_feature_shapes():
    rng = np.random.RandomState(2)
    fid = ti.FrechetInceptionDistance(**CPU)
    fid.update(torch.from_numpy(rng.randn(1, 4).astype(np.float32)), real=True)
    fid.update(torch.from_numpy(rng.randn(5, 4).astype(np.float32)), real=False)
    with pytest.raises(RuntimeError, match="More than one sample"):
        fid.compute()
    with pytest.raises(ValueError, match="dimension 4"):
        fid.update(torch.zeros(3, 5), real=True)
    with pytest.raises(ValueError, match="2d"):
        fid.update(torch.zeros(3), real=True)
    declared = ti.FrechetInceptionDistance(num_features=3, **CPU)
    assert declared.real_features_cov_sum.shape == (3, 3)


def test_fid_int_feature_gated(monkeypatch):
    monkeypatch.delenv("METRICS_TPU_WEIGHTS", raising=False)
    with pytest.raises(ModuleNotFoundError, match="offline"):
        ti.FrechetInceptionDistance(feature=2048, **CPU)
    with pytest.raises(ModuleNotFoundError, match="offline"):
        ti.InceptionScore(feature=2048, **CPU)


# ------------------------------------------------------------------ KID, IS, MiFID
@pytest.mark.parametrize("degree,gamma,coef", [(3, None, 1.0), (2, 0.5, 0.0)])
def test_kid_equals_the_jax_package_s(degree, gamma, coef):
    real, fake = _gaussians(3, n=120, d=8)
    kw = dict(subsets=6, subset_size=40, degree=degree, gamma=gamma, coef=coef)
    jm, tm = ji.KernelInceptionDistance(**kw), ti.KernelInceptionDistance(**kw, **CPU)
    _fed(jm, tm, real, fake, batches=3)
    (jmean, jstd), (tmean, tstd) = jm.compute(), tm.compute()
    np.testing.assert_allclose([float(tmean), float(tstd)], [float(jmean), float(jstd)], rtol=1e-6)


def test_kid_separated_vs_identical():
    x = np.random.RandomState(4).randn(200, 8).astype(np.float32)
    kid_same = ti.KernelInceptionDistance(subsets=5, subset_size=50, **CPU)
    kid_same.update(torch.from_numpy(x), real=True)
    kid_same.update(torch.from_numpy(x.copy()), real=False)
    mean_same, _ = kid_same.compute()
    kid_diff = ti.KernelInceptionDistance(subsets=5, subset_size=50, **CPU)
    kid_diff.update(torch.from_numpy(x), real=True)
    kid_diff.update(torch.from_numpy(x + 2.0), real=False)
    mean_diff, _ = kid_diff.compute()
    assert abs(float(mean_same)) < 0.1
    assert float(mean_diff) > float(mean_same)
    with pytest.raises(ValueError, match="subset_size"):
        small = ti.KernelInceptionDistance(subsets=2, subset_size=500, **CPU)
        small.update(torch.from_numpy(x), real=True)
        small.update(torch.from_numpy(x), real=False)
        small.compute()


@pytest.mark.parametrize("splits", [1, 4, 7])
def test_inception_score_equals_the_jax_package_s(splits):
    logits = (np.random.default_rng(5).standard_normal((90, 12)) * 3).astype(np.float32)
    jm, tm = ji.InceptionScore(splits=splits), ti.InceptionScore(splits=splits, **CPU)
    for part in np.array_split(logits, 3):
        jm.update(jnp.asarray(part))
        tm.update(torch.from_numpy(part))
    (jmean, jstd), (tmean, tstd) = jm.compute(), tm.compute()
    np.testing.assert_allclose(float(tmean), float(jmean), rtol=1e-5)
    if splits > 1:
        np.testing.assert_allclose(float(tstd), float(jstd), rtol=1e-4)


def test_inception_score_uniform_vs_confident():
    rng = np.random.RandomState(6)
    n, k = 200, 10
    uniform_logits = np.zeros((n, k), dtype=np.float32)
    confident = np.full((n, k), -20.0, dtype=np.float32)
    confident[np.arange(n), rng.randint(0, k, n)] = 20.0
    m1 = ti.InceptionScore(splits=4, **CPU)
    m1.update(torch.from_numpy(uniform_logits))
    low, _ = m1.compute()
    m2 = ti.InceptionScore(splits=4, **CPU)
    m2.update(torch.from_numpy(confident))
    high, _ = m2.compute()
    np.testing.assert_allclose(float(low), 1.0, atol=1e-4)
    assert float(high) > 5.0


@pytest.mark.parametrize("eps", [0.1, 0.9])
def test_mifid_equals_the_jax_package_s(eps):
    real, fake = _gaussians(7, n=300, d=8, shift=0.5)
    jm = ji.MemorizationInformedFrechetInceptionDistance(cosine_distance_eps=eps)
    tm = ti.MemorizationInformedFrechetInceptionDistance(cosine_distance_eps=eps, **CPU)
    _fed(jm, tm, real, fake, batches=3)
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=1e-5)


def test_mifid_forward_does_not_mix_batch_and_history():
    rng = np.random.RandomState(8)
    real = rng.randn(100, 8).astype(np.float32)
    fake = (rng.randn(100, 8) + 0.5).astype(np.float32)
    m = ti.MemorizationInformedFrechetInceptionDistance(**CPU)
    m.update(torch.from_numpy(real), real=True)
    m.update(torch.from_numpy(fake), real=False)
    running = float(m.compute())
    count = m._update_count
    with pytest.raises((RuntimeError, ValueError)):
        m(torch.from_numpy(fake), real=False)
    np.testing.assert_allclose(float(m.compute()), running, rtol=1e-6)
    assert m._update_count == count


def test_mifid_reset_keeps_the_real_store():
    real, fake = _gaussians(9, n=60, d=4)
    m = ti.MemorizationInformedFrechetInceptionDistance(reset_real_features=False, **CPU)
    m.update(torch.from_numpy(real), real=True)
    m.update(torch.from_numpy(fake), real=False)
    m.reset()
    assert len(m.real_feature_store) == 1 and len(m.fake_feature_store) == 0
    assert int(m.real_features_num_samples) == 60 and int(m.fake_features_num_samples) == 0


# ------------------------------------------------------------------ LPIPS
def _toy_net(x):
    return [x, x[:, :, ::2, ::2]]


@pytest.mark.parametrize("reduction,normalize", [("mean", False), ("sum", True)])
def test_lpips_with_an_injected_net_equals_the_jax_package_s(reduction, normalize):
    rng = np.random.default_rng(10)
    lo = 0.0 if normalize else -1.0
    a = (rng.random((4, 3, 16, 16), dtype=np.float32) * (1 - lo) + lo)
    b = (rng.random((4, 3, 16, 16), dtype=np.float32) * (1 - lo) + lo)
    jm = ji.LearnedPerceptualImagePatchSimilarity(net=_toy_net, reduction=reduction, normalize=normalize)
    tm = ti.LearnedPerceptualImagePatchSimilarity(net=_toy_net, reduction=reduction, normalize=normalize, **CPU)
    for i in range(2):
        jm.update(jnp.asarray(a[2 * i: 2 * i + 2]), jnp.asarray(b[2 * i: 2 * i + 2]))
        tm.update(torch.from_numpy(a[2 * i: 2 * i + 2]), torch.from_numpy(b[2 * i: 2 * i + 2]))
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=1e-5)


def test_lpips_identical_zero_and_validation(monkeypatch):
    monkeypatch.delenv("METRICS_TPU_WEIGHTS", raising=False)
    a = torch.from_numpy(np.random.RandomState(11).rand(4, 3, 16, 16).astype(np.float32))
    m = ti.LearnedPerceptualImagePatchSimilarity(net=_toy_net, **CPU)
    m.update(a, a)
    np.testing.assert_allclose(float(m.compute()), 0.0, atol=1e-6)
    with pytest.raises(ModuleNotFoundError, match="offline"):
        ti.LearnedPerceptualImagePatchSimilarity(**CPU)
    with pytest.raises(ValueError, match=r"\[N, 3, H, W\]"):
        m.update(a[:, :2], a[:, :2])
    with pytest.raises(ValueError, match=r"\[0, 1\] range"):
        ti.LearnedPerceptualImagePatchSimilarity(net=_toy_net, normalize=True, **CPU).update(a * 2, a)
    with pytest.raises(ValueError, match="net_type"):
        ti.LearnedPerceptualImagePatchSimilarity(net=_toy_net, net_type="resnet", **CPU)


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    """One random AlexNet tower and LPIPS heads as local ``.pth`` files, which both packages' hubs read."""
    from metrics_tpu_torch.models import init_lpips

    d = tmp_path_factory.mktemp("lpips_weights")
    variables, _ = init_lpips("alex", rng_seed=3, device="cpu")
    torch.save(variables, d / "alexnet.pth")
    gen = torch.Generator().manual_seed(4)
    torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=gen)
                for i, c in enumerate((64, 192, 384, 256, 256))}, d / "lpips_alex.pth")
    return d


def test_lpips_at_the_carried_alexnet_equals_the_jax_package_s(lpips_weights, monkeypatch):
    from metrics_tpu.functional.image.perceptual import learned_perceptual_image_patch_similarity as j_fn

    from metrics_tpu_torch.functional.image.perceptual import learned_perceptual_image_patch_similarity as t_fn

    monkeypatch.setenv("METRICS_TPU_WEIGHTS", str(lpips_weights))
    rng = np.random.default_rng(12)
    a = rng.random((3, 3, 64, 64), dtype=np.float32)
    b = rng.random((3, 3, 64, 64), dtype=np.float32)
    jm = ji.LearnedPerceptualImagePatchSimilarity(net_type="alex", normalize=True)
    tm = ti.LearnedPerceptualImagePatchSimilarity(net_type="alex", normalize=True, **CPU)
    jm.update(jnp.asarray(a), jnp.asarray(b))
    tm.update(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=1e-4)
    for reduction in ("mean", "sum"):
        got = t_fn(torch.from_numpy(a), torch.from_numpy(b), "alex", reduction, True)
        want = j_fn(jnp.asarray(a), jnp.asarray(b), "alex", reduction, True)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


# ------------------------------------------------------------------ PPL
class _Generator:
    """A fixed random linear generator to images in [0, 255], written once per package."""

    def __init__(self, xp, z=8, size=16, num_classes=None, seed=13):
        rng = np.random.default_rng(seed)
        self._w = (rng.standard_normal((z, 3 * size * size)) / np.sqrt(z)).astype(np.float32)
        self._emb = rng.standard_normal((num_classes or 1, z)).astype(np.float32)
        self.xp, self.z, self.size = xp, z, size
        self._draws = np.random.default_rng(seed + 1)
        if num_classes is not None:
            self.num_classes = num_classes

    def sample(self, n):
        lat = self._draws.standard_normal((n, self.z)).astype(np.float32)
        return jnp.asarray(lat) if self.xp == "jax" else torch.from_numpy(lat)

    def __call__(self, z, labels=None):
        if self.xp == "jax":
            if labels is not None:
                z = z + jnp.asarray(self._emb)[labels]
            x = jax.nn.sigmoid(z @ jnp.asarray(self._w))
        else:
            if labels is not None:
                z = z + torch.from_numpy(self._emb)[labels]
            x = torch.sigmoid(z @ torch.from_numpy(self._w))
        return 255 * x.reshape(z.shape[0], 3, self.size, self.size)


def _sq_dist(a, b):
    return ((a - b) ** 2).reshape(a.shape[0], -1).mean(-1)


@pytest.mark.parametrize("method", ["lerp", "slerp_any", "slerp_unit"])
@pytest.mark.parametrize("conditional", [False, True])
def test_ppl_with_an_injected_similarity_equals_the_jax_package_s(method, conditional):
    kw = dict(num_samples=40, batch_size=16, interpolation_method=method, epsilon=1e-2, sim_net=_sq_dist,
              conditional=conditional, lower_discard=0.05, upper_discard=0.95)
    nc = 5 if conditional else None
    jmean, jstd, jd = j_ppl(_Generator("jax", num_classes=nc), **kw)
    tmean, tstd, td = t_ppl(_Generator("torch", num_classes=nc), **kw)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4)
    np.testing.assert_allclose([float(tmean), float(tstd)], [float(jmean), float(jstd)], rtol=1e-4)


def test_ppl_at_the_carried_lpips_with_resize_equals_the_jax_package_s(lpips_weights, monkeypatch):
    """``sim_net="alex"`` resolves the same local weights in both packages; 96×96 outputs are area-resized to
    64 and 40×40 bilinearly, by the reference's rule."""
    monkeypatch.setenv("METRICS_TPU_WEIGHTS", str(lpips_weights))
    for size, resize in ((96, 64), (40, 64)):
        kw = dict(num_samples=12, batch_size=6, epsilon=1e-2, sim_net="alex", resize=resize,
                  lower_discard=None, upper_discard=None)
        jmean, _, jd = j_ppl(_Generator("jax", size=size), **kw)
        tm = ti.PerceptualPathLength(**kw, **CPU)
        tm.update(_Generator("torch", size=size))
        tmean, _, td = tm.compute()
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-3, atol=1e-3 * float(np.abs(jd).max()))
        np.testing.assert_allclose(float(tmean), float(jmean), rtol=1e-3)


def test_ppl_validates_as_the_jax_package_does():
    with pytest.raises(ValueError, match="num_samples"):
        ti.PerceptualPathLength(num_samples=0, sim_net=_sq_dist, **CPU)
    with pytest.raises(ValueError, match="interpolation_method"):
        ti.PerceptualPathLength(interpolation_method="cubic", sim_net=_sq_dist, **CPU)
    m = ti.PerceptualPathLength(sim_net=_sq_dist, conditional=True, **CPU)
    with pytest.raises(RuntimeError, match="update"):
        m.compute()
    with pytest.raises(NotImplementedError, match="sample"):
        m.update(object())
    with pytest.raises(AttributeError, match="num_classes"):
        m.update(_Generator("torch"))


# ------------------------------------------------------------------ FeatureShare
def test_feature_share_single_forward():
    calls = {"n": 0}

    def net(x):
        calls["n"] += 1
        return x

    rng = np.random.RandomState(99)
    fid = ti.FrechetInceptionDistance(feature=net, **CPU)
    kid = ti.KernelInceptionDistance(feature=net, subsets=2, subset_size=20, **CPU)
    fs = tw.FeatureShare([fid, kid])
    batch = torch.from_numpy(rng.randn(50, 6).astype(np.float32))
    fs.update(batch, real=True)
    assert calls["n"] == 1
    fs.update(torch.from_numpy(rng.randn(50, 6).astype(np.float32)), real=False)
    assert calls["n"] == 2
    assert fid.feature_extractor is kid.feature_extractor is fs.network_cache


def test_feature_share_of_all_four_equals_the_jax_package_s():
    """FID, KID, IS and MiFID behind one shared network: one forward a batch, the values of the JAX
    package's FeatureShare on the same inputs."""
    counts = {"jax": 0, "torch": 0}

    def counted(side):
        def net(x):
            counts[side] += 1
            return x
        return net

    def members(mod, side, **kw):
        return {
            "fid": mod.FrechetInceptionDistance(feature=counted(side), **kw),
            "kid": mod.KernelInceptionDistance(feature=counted(side), subsets=3, subset_size=20, **kw),
            "is": mod.InceptionScore(feature=counted(side), splits=2, **kw),
            "mifid": mod.MemorizationInformedFrechetInceptionDistance(feature=counted(side), **kw),
        }

    jfs = jw.FeatureShare(members(ji, "jax"))
    tfs = tw.FeatureShare(members(ti, "torch", **CPU))
    real, fake = _gaussians(14, n=60, d=10)
    for r, f in zip(np.array_split(real, 3), np.array_split(fake, 3)):
        jfs.update(jnp.asarray(r), real=True)
        jfs.update(jnp.asarray(f), real=False)
        tfs.update(torch.from_numpy(r), real=True)
        tfs.update(torch.from_numpy(f), real=False)
    assert counts["torch"] == counts["jax"] == 6  # one forward a batch, four members
    jv, tv = jfs.compute(), tfs.compute()
    assert set(jv) == set(tv)
    for k in jv:
        np.testing.assert_allclose(np.asarray([_np(v) for v in np.atleast_1d(tv[k])] if isinstance(tv[k], tuple)
                                              else _np(tv[k]), dtype=np.float64),
                                   np.asarray([np.asarray(v) for v in jv[k]] if isinstance(jv[k], tuple)
                                              else np.asarray(jv[k]), dtype=np.float64),
                                   rtol=1e-4, err_msg=k)


def test_network_cache_holds_its_argument_and_evicts_the_oldest():
    calls = []
    cache = tw.NetworkCache(lambda x: calls.append(id(x)) or x.sum(), max_size=2)
    a, b, c = torch.ones(2), torch.ones(3), torch.ones(4)
    for x in (a, a, b, c):
        cache(x)
    assert len(calls) == 3  # a hit once
    cache(a)  # a was evicted by c
    assert len(calls) == 4
    assert all(entry[0] is not None for entry in cache._cache.values())
