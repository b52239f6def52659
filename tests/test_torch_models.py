"""The port's backbones held against the JAX package's flax ones, tap by tap (``tests/test_backbones.py``).

One set of flax variables per backbone, drawn with numpy from a seed (He-normal kernels, non-trivial
batch-norm statistics, so that a wrong BatchNorm mapping shows), goes through the JAX package's flax
forward and, carried across with ``from_flax_variables``, through the port's module on the same numpy
images. The InceptionV3 file shares ONE flax forward of all six taps on three images (module-scoped; the
flax forward takes about 14 s on the CPU). Tolerance: every tap within ``atol = 1e-5 × max|tap|`` and
``rtol = 1e-4`` (float32 through ~90 layers; the measured worst case is about 2e-6 of the tap's scale).

Then the torch oracle (``tests/_torch_inception.py``): its ``state_dict()`` loads through
``convert_torch_state_dict`` and the port's module is bit-equal to it on the CPU. Then the hub: local
``.pth`` weights resolve, a directory with only the JAX package's ``.msgpack`` is refused, the LPIPS towers
and heads resolve, and the Hugging Face loaders refuse a non-local name.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_inception import TorchInceptionV3FID
from metrics_tpu.models import inception_v3 as j_incep
from metrics_tpu.models import lpips_nets as j_lpips
from metrics_tpu.models import simple_cnn as j_cnn
from metrics_tpu_torch.models import (
    AlexNetFeatures,
    InceptionV3FID,
    SimpleFeatureCNN,
    VGG16Features,
    build_lpips,
    convert_torch_state_dict,
    init_inception_params,
    init_lpips,
    load_clip,
    load_feature_extractor,
    load_lpips,
    load_text_encoder,
    make_feature_extractor,
)
from metrics_tpu_torch.models import inception_v3 as t_incep
from metrics_tpu_torch.models import lpips_nets as t_lpips
from metrics_tpu_torch.models import simple_cnn as t_cnn

TAPS = (64, 192, 768, 2048, "logits_unbiased", "logits")
ATOL_OF_SCALE = 1e-5
RTOL = 1e-4


def random_flax_variables(init_fn, seed: int):
    """Flax variables of ``init_fn``'s shapes (``jax.eval_shape``: nothing compiles), filled with numpy."""
    shapes = jax.eval_shape(init_fn)
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = fill(v)
                continue
            s = tuple(v.shape)
            if k == "kernel":
                a = rng.standard_normal(s) * np.sqrt(2.0 / np.prod(s[:-1]))
            elif k in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, s)
            else:  # biases, BN shifts and means
                a = rng.normal(0.0, 0.1, s)
            out[k] = a.astype(np.float32)
        return out

    return {k: fill(v) for k, v in shapes.items()}


def assert_tap(got: np.ndarray, want: np.ndarray, name) -> None:
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_OF_SCALE * float(np.abs(want).max()),
                               err_msg=str(name))


# ------------------------------------------------------------------ InceptionV3
@pytest.fixture(scope="module")
def inception():
    """One flax variable set, one flax forward of every tap, one port forward, on the same three images."""
    variables = random_flax_variables(
        lambda: j_incep.InceptionV3FID().init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 299, 299)), features=TAPS),
        seed=0)
    images = np.random.default_rng(1).integers(0, 256, (3, 3, 40, 48)).astype(np.float32)
    ref = j_incep.InceptionV3FID().apply(variables, jnp.asarray(images), features=TAPS)
    model = InceptionV3FID()
    model.load_state_dict(t_incep.from_flax_variables(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(images), features=TAPS)
    return {
        "variables": variables, "images": images, "model": model,
        "ref": {k: np.asarray(v) for k, v in ref.items()}, "got": {k: v.numpy() for k, v in got.items()},
    }


@pytest.mark.parametrize("tap", TAPS, ids=str)
def test_inception_tap_equals_the_flax_forward(inception, tap):
    assert_tap(inception["got"][tap], inception["ref"][tap], tap)


def test_inception_tap_shapes_are_torch_fidelity_s(inception):
    shapes = {k: v.shape for k, v in inception["got"].items()}
    assert shapes == {64: (3, 64, 73, 73), 192: (3, 192, 35, 35), 768: (3, 768, 17, 17), 2048: (3, 2048),
                      "logits_unbiased": (3, 1008), "logits": (3, 1008)}


def test_the_carried_state_dict_covers_every_parameter(inception):
    sd = t_incep.from_flax_variables(inception["variables"])
    assert set(sd) == set(InceptionV3FID().state_dict())
    assert not any("num_batches_tracked" in k for k in sd)


def test_feature_extractor_pools_the_spatial_taps(inception):
    """``make_feature_extractor`` gives each tap as torch-fidelity pools it: spatial taps averaged to (N, C)."""
    for tap in (64, 768, 2048, "logits"):
        ext = make_feature_extractor(inception["model"], tap)
        got = ext(torch.from_numpy(inception["images"])).numpy()
        want = inception["ref"][tap]
        want = want.mean(axis=(2, 3)) if want.ndim == 4 else want
        assert_tap(got, want, tap)


def test_feature_extractor_resizes_any_input():
    ext = make_feature_extractor(init_inception_params(0, device="cpu"), 2048)
    small = torch.from_numpy(np.random.default_rng(2).integers(0, 255, (3, 3, 64, 64)).astype(np.float32))
    out = ext(small)
    assert out.shape == (3, 2048) and out.dtype == torch.float32 and not out.requires_grad


def test_torch_oracle_state_dict_loads_and_is_bit_equal():
    """``tests/_torch_inception.py``'s torch-fidelity-layout state dict (with ``num_batches_tracked``) goes
    through ``convert_torch_state_dict``; the port's module is then bit-equal to the oracle on the CPU."""
    torch.manual_seed(3)
    oracle = TorchInceptionV3FID()
    with torch.no_grad():
        for name, b in oracle.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0, 0.1)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5)
    oracle.eval()
    sd = oracle.state_dict()
    assert any("num_batches_tracked" in k for k in sd)
    model = InceptionV3FID()
    model.load_state_dict(convert_torch_state_dict(sd))
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 3, 299, 299)).astype(np.float32))
    with torch.no_grad():
        want = oracle(x)
        got = model(x, features=TAPS)
    for tap in TAPS:
        assert torch.equal(got[tap], want[tap]), tap
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    model2 = InceptionV3FID()
    model2.load_state_dict(convert_torch_state_dict(numpy_sd))
    for a, b in zip(model2.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)


def test_init_is_seeded_and_device_placed():
    a, b, c = (init_inception_params(s, device="cpu") for s in (7, 7, 8))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Conv2d_1a_3x3.conv.weight"], c["Conv2d_1a_3x3.conv.weight"])
    assert {v.device.type for v in a.values()} == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_inception_params(0)


# ------------------------------------------------------------------ LPIPS towers
_TOWERS = {"vgg": (j_lpips.VGG16Features, VGG16Features, j_lpips.VGG16_TAPS),
           "alex": (j_lpips.AlexNetFeatures, AlexNetFeatures, j_lpips.ALEX_TAPS),
           "squeeze": (j_lpips.SqueezeNetFeatures, t_lpips.SqueezeNetFeatures, j_lpips.SQUEEZE_TAPS)}


@pytest.fixture(scope="module")
def towers():
    out = {}
    rng = np.random.default_rng(5)
    a = (rng.random((2, 3, 64, 64), dtype=np.float32) * 2 - 1)
    b = (rng.random((2, 3, 64, 64), dtype=np.float32) * 2 - 1)
    for i, (name, (jcls, tcls, taps)) in enumerate(_TOWERS.items()):
        variables = random_flax_variables(lambda c=jcls: c().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))),
                                          seed=10 + i)
        lin = [np.random.default_rng(20 + i).random(c).astype(np.float32) for c in taps]
        ref_taps = [np.asarray(t) for t in jcls().apply(variables, jnp.asarray(a.transpose(0, 2, 3, 1)))]
        ref_score = np.asarray(j_lpips.build_lpips(name, variables, [jnp.asarray(w) for w in lin])(
            jnp.asarray(a), jnp.asarray(b)))
        out[name] = {"variables": variables, "lin": lin, "ref_taps": ref_taps, "ref_score": ref_score}
    return out, a, b


@pytest.mark.parametrize("net_type", list(_TOWERS))
def test_lpips_tower_taps_equal_the_flax_forward(towers, net_type):
    data, a, _b = towers
    tcls = _TOWERS[net_type][1]
    net = tcls()
    net.load_state_dict(t_lpips.from_flax_variables(data[net_type]["variables"], net_type))
    with torch.no_grad():
        got = net(torch.from_numpy(a))
    assert tuple(t.shape[1] for t in got) == _TOWERS[net_type][2]
    for i, (g, w) in enumerate(zip(got, data[net_type]["ref_taps"])):
        assert_tap(g.numpy(), w.transpose(0, 3, 1, 2), f"{net_type} tap {i}")


@pytest.mark.parametrize("net_type", list(_TOWERS))
def test_lpips_scores_equal_the_jax_package_s(towers, net_type):
    data, a, b = towers
    d = data[net_type]
    score = build_lpips(net_type, t_lpips.from_flax_variables(d["variables"], net_type), d["lin"], device="cpu")
    got = score(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, d["ref_score"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("net_type", list(_TOWERS))
def test_lpips_scorer_properties(net_type):
    variables, lin = init_lpips(net_type, device="cpu")
    score = build_lpips(net_type, variables, lin, device="cpu")
    a = torch.from_numpy(np.random.default_rng(6).random((2, 3, 64, 64), dtype=np.float32) * 2 - 1)
    assert np.allclose(score(a, a).numpy(), 0.0, atol=1e-6)
    assert (score(a, -a).numpy() > 0).all()


# ------------------------------------------------------------------ SimpleFeatureCNN
def test_simple_cnn_equals_the_flax_forward():
    variables = random_flax_variables(
        lambda: j_cnn.SimpleFeatureCNN().init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32))), seed=30)
    for shape in ((4, 3, 32, 32), (2, 3, 33, 27)):  # odd sizes exercise flax's "SAME" padding
        x = np.random.default_rng(31).random(shape, dtype=np.float32)
        want = np.asarray(j_cnn.SimpleFeatureCNN().apply(variables, jnp.asarray(x)))
        net = SimpleFeatureCNN()
        net.load_state_dict(t_cnn.from_flax_variables(variables))
        with torch.no_grad():
            got = net(torch.from_numpy(x)).numpy()
        assert_tap(got, want, shape)


def test_simple_cnn_bind_apply_is_a_plain_function():
    fn = SimpleFeatureCNN().bind_apply(rng_seed=0, device="cpu")
    out = fn(np.random.default_rng(0).random((3, 3, 32, 32), dtype=np.float32))
    assert out.shape == (3, 64) and torch.isfinite(out).all()
    assert torch.equal(out, SimpleFeatureCNN().bind_apply(rng_seed=0, device="cpu")(
        np.random.default_rng(0).random((3, 3, 32, 32), dtype=np.float32)))


# ------------------------------------------------------------------ the hub
def _save_inception(tmp_path, name="pt_inception-2015-12-05.pth"):
    torch.save(init_inception_params(0, device="cpu"), tmp_path / name)


def test_fid_integer_feature_resolves_from_torch_pth(tmp_path, monkeypatch):
    from metrics_tpu_torch.image import FrechetInceptionDistance

    _save_inception(tmp_path)
    monkeypatch.setenv("METRICS_TPU_WEIGHTS", str(tmp_path))
    fid = FrechetInceptionDistance(feature=192, device="cpu")
    imgs = torch.from_numpy(np.random.default_rng(7).integers(0, 255, (6, 3, 32, 32)).astype(np.float32))
    fid.update(imgs, real=True)
    fid.update(imgs + 5, real=False)
    assert np.isfinite(float(fid.compute()))
    assert fid.real_features_sum.shape == (192,)


def test_a_directory_with_only_the_msgpack_form_is_refused(tmp_path, monkeypatch):
    """The port reads no flax: the JAX package's ``inception_v3_fid.msgpack`` alone names the ``.pth`` form."""
    from metrics_tpu_torch.image import FrechetInceptionDistance

    (tmp_path / "inception_v3_fid.msgpack").write_bytes(b"\x80")
    monkeypatch.setenv("METRICS_TPU_WEIGHTS", str(tmp_path))
    with pytest.raises(ModuleNotFoundError, match=r"msgpack.*\.pth"):
        FrechetInceptionDistance(feature=2048, device="cpu")
    _save_inception(tmp_path, "inception_v3_fid.pth")  # the torch form beside it wins
    assert load_feature_extractor("inception_v3_fid", feature=64, device="cpu")(
        torch.zeros(1, 3, 16, 16)).shape == (1, 64)


def test_hub_refuses_unknown_features_names_and_absent_weights(tmp_path, monkeypatch):
    monkeypatch.delenv("METRICS_TPU_WEIGHTS", raising=False)
    with pytest.raises(ModuleNotFoundError, match="offline"):
        load_feature_extractor("inception_v3_fid", device="cpu")
    with pytest.raises(ValueError, match="Integer `feature`"):
        load_feature_extractor("inception_v3_fid", feature=1000, device="cpu")
    with pytest.raises(ValueError, match="LPIPS scorer"):
        load_feature_extractor("vgg", device="cpu")
    with pytest.raises(ValueError, match="Unknown backbone"):
        load_feature_extractor("resnet", device="cpu")
    with pytest.raises(ModuleNotFoundError, match="offline"):
        load_lpips("alex", device="cpu")
    assert load_feature_extractor("simple_cnn", device="cpu")(torch.zeros(2, 3, 32, 32)).shape == (2, 64)


def test_the_weights_are_read_without_pickle_code(tmp_path):
    """``.pth`` files load with ``weights_only=True``: a pickle that names a callable is refused."""
    import pickle

    from metrics_tpu_torch.models.hub import _load_torch_sd

    class Evil:
        def __reduce__(self):
            return (print, ("ran",))

    torch.save({"w": torch.zeros(1), "x": Evil()}, tmp_path / "evil.pth")
    with pytest.raises(pickle.UnpicklingError):
        _load_torch_sd(str(tmp_path / "evil.pth"))


@pytest.mark.parametrize("net_type", ["alex", "squeeze"])
def test_lpips_metric_resolves_local_weights(tmp_path, monkeypatch, net_type):
    from metrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity

    variables, _lin = init_lpips(net_type, rng_seed=1, device="cpu")
    backbone = {"alex": "alexnet.pth", "squeeze": "squeezenet1_1.pth"}[net_type]
    torch.save(variables, tmp_path / backbone)
    taps = {"alex": j_lpips.ALEX_TAPS, "squeeze": j_lpips.SQUEEZE_TAPS}[net_type]
    torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1) for i, c in enumerate(taps)},
               tmp_path / f"lpips_{net_type}.pth")
    monkeypatch.setenv("METRICS_TPU_WEIGHTS", str(tmp_path))
    metric = LearnedPerceptualImagePatchSimilarity(net_type=net_type, device="cpu")
    a = torch.from_numpy(np.random.default_rng(8).random((2, 3, 64, 64), dtype=np.float32) * 2 - 1)
    metric.update(a, a)
    assert float(metric.compute()) == pytest.approx(0.0, abs=1e-6)
    metric2 = LearnedPerceptualImagePatchSimilarity(net_type=net_type, device="cpu")
    metric2.update(a, torch.clamp(-a, -1, 1))
    assert float(metric2.compute()) > 0


def test_lin_heads_convert_from_the_lpips_layout():
    for taps in (j_lpips.ALEX_TAPS, j_lpips.VGG16_TAPS, j_lpips.SQUEEZE_TAPS):
        sd = {f"lin{i}.model.1.weight": np.random.default_rng(i).random((1, c, 1, 1)) for i, c in enumerate(taps)}
        lin = t_lpips.convert_torch_lin(sd)
        assert tuple(int(w.shape[0]) for w in lin) == taps
        want = j_lpips.convert_torch_lin(sd)
        for a, b in zip(lin, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_torchvision_backbone_dicts_convert_with_or_without_the_prefix():
    variables, _ = init_lpips("vgg", device="cpu")
    bare = {k[len("features."):]: v.numpy() for k, v in variables.items()}
    bare["classifier.0.weight"] = np.zeros((4, 4), dtype=np.float32)
    for sd in (variables, bare):
        got = t_lpips.convert_torch_backbone(sd, "vgg")
        assert set(got) == set(variables) and all(torch.equal(got[k], variables[k]) for k in variables)


def test_clip_and_text_loaders_error_without_local_checkpoint(monkeypatch):
    monkeypatch.delenv("METRICS_TPU_WEIGHTS", raising=False)
    with pytest.raises(ModuleNotFoundError, match="local"):
        load_clip("openai/clip-vit-large-patch14", device="cpu")
    with pytest.raises(ModuleNotFoundError, match="local"):
        load_text_encoder("roberta-large", device="cpu")


def test_text_encoder_loads_a_local_torch_checkpoint(tmp_path):
    """A tiny random BERT saved locally through ``transformers``' torch classes drives the loader."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                                  intermediate_size=37, max_position_embeddings=64)
    torch.manual_seed(0)
    ckpt = tmp_path / "tiny-bert"
    transformers.BertModel(cfg).save_pretrained(str(ckpt))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "photo", "cat", "dog", "the"]
    (ckpt / "vocab.txt").write_text("\n".join(vocab))
    (ckpt / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "BertTokenizer",
                                                            "do_lower_case": True}))
    enc = load_text_encoder(str(ckpt), device="cpu")
    out = enc(["a photo cat", "the dog"])
    assert [tuple(o.shape) for o in out] == [(5, 32), (4, 32)]  # [CLS] + words + [SEP], padding trimmed
    assert all(torch.isfinite(o).all() for o in out)
