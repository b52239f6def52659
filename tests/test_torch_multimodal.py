"""CLIPScore and CLIP-IQA of the port against the JAX package, through the same numpy-backed injected encoders.

The image encoder is a fixed random projection of the flattened images, the text encoder a sum of seeded
per-word vectors; the JAX side's return ``jnp`` arrays, the port's tensors, with the same values. Both
packages normalise, take cosines x 100 and (CLIP-IQA) a softmax over each prompt pair in float32.
Tolerance: rtol 1e-5, atol 1e-6. The class's ``update`` does not divide by a ``data_range`` where the function
does, in both packages. The default path runs a tiny random ``CLIPModel`` (2 layers, 32 wide) with a
hand-written tokenizer vocabulary saved locally, held against the injected path over the same model.
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.multimodal as jfm
import metrics_tpu.multimodal as jm
import metrics_tpu_torch.functional.multimodal as tfm
import metrics_tpu_torch.multimodal as tm
from _torch_hf import tiny_clip
from metrics_tpu.functional.multimodal.clip_iqa import _PROMPTS as J_PROMPTS
from metrics_tpu.functional.multimodal.clip_iqa import _resolve_prompts as j_resolve
from metrics_tpu_torch.functional.multimodal.clip_iqa import _PROMPTS as T_PROMPTS
from metrics_tpu_torch.functional.multimodal.clip_iqa import _resolve_prompts as t_resolve

RTOL, ATOL = 1e-5, 1e-6
DIM = 12
IMG = (3, 8, 8)
PROJ = np.random.RandomState(0).randn(int(np.prod(IMG)), DIM)
CAPTIONS = ["a cat on a mat", "two dogs", "a red car", "the sea at dusk", "an empty room", "green trees"]


def _close(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=RTOL, atol=ATOL)


def _image_rows(images):
    if isinstance(images, torch.Tensor):
        arr = images.detach().cpu().numpy()
    elif isinstance(images, (list, tuple)) and images and isinstance(images[0], torch.Tensor):
        arr = torch.stack(list(images)).numpy()
    else:
        arr = np.asarray(images)
    return (arr.reshape(len(arr), -1).astype(np.float64) @ PROJ).astype(np.float32)


def _word(w):
    return np.random.RandomState(zlib.crc32(w.lower().encode())).randn(DIM)


def _text_rows(texts):
    return np.stack([sum(_word(w) for w in t.split()) for t in texts]).astype(np.float32)


def _encoders(sign=1.0):
    """(JAX image, JAX text, port image, port text) encoders over the same numpy functions."""
    return (lambda x: jnp.asarray(sign * _image_rows(x)), lambda t: jnp.asarray(_text_rows(t)),
            lambda x: torch.from_numpy(sign * _image_rows(x)), lambda t: torch.from_numpy(_text_rows(t)))


def _images(seed, n, scale=1.0):
    return (np.random.RandomState(seed).rand(n, *IMG) * scale).astype(np.float32)


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["sign+", "sign-"])
def test_clip_score_class_matches_the_reference(sign):
    ji, jt, ti, tt = _encoders(sign)
    ref = jm.CLIPScore(image_encoder=ji, text_encoder=jt)
    port = tm.CLIPScore(image_encoder=ti, text_encoder=tt, device="cpu")
    for seed, caps in ((1, CAPTIONS[:4]), (2, CAPTIONS[4:])):
        imgs = _images(seed, len(caps))
        ref.update(jnp.asarray(imgs), caps)
        port.update(torch.from_numpy(imgs), caps)
    one = _images(3, 1)[0]  # a single (C, H, W) image and a single caption
    ref.update(jnp.asarray(one), "a cat")
    port.update(torch.from_numpy(one), "a cat")
    _close(port.compute(), ref.compute())
    _close(port.score, ref.score)
    assert int(port.n_samples) == int(ref.n_samples) == 7 and port.n_samples.dtype == torch.int64
    # the image embeddings' sign flips the raw mean, so one of the two cases is clamped: at the mean
    raw = float(port.score) / 7
    assert float(port.compute()) == pytest.approx(max(raw, 0.0), rel=1e-6) and raw != 0


def test_clip_score_refuses_mismatched_lengths_as_the_reference():
    ji, jt, ti, tt = _encoders()
    with pytest.raises(ValueError) as port_err:
        tm.CLIPScore(image_encoder=ti, text_encoder=tt, device="cpu").update(torch.zeros(2, *IMG), ["a"])
    with pytest.raises(ValueError) as ref_err:
        jm.CLIPScore(image_encoder=ji, text_encoder=jt).update(jnp.zeros((2, *IMG)), ["a"])
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("pair", ["image-text", "text-image", "text-text", "image-image", "list-of-images"])
def test_clip_score_function_matches_the_reference(pair):
    ji, jt, ti, tt = _encoders()
    imgs_a, imgs_b = _images(4, 3), _images(5, 3)
    caps_a, caps_b = CAPTIONS[:3], CAPTIONS[3:]
    port_args = {"image-text": (torch.from_numpy(imgs_a), caps_a), "text-image": (caps_a, torch.from_numpy(imgs_b)),
                 "text-text": (caps_a, caps_b), "image-image": (torch.from_numpy(imgs_a), torch.from_numpy(imgs_b)),
                 "list-of-images": (list(torch.from_numpy(imgs_a)), caps_b)}[pair]
    ref_args = {"image-text": (jnp.asarray(imgs_a), caps_a), "text-image": (caps_a, jnp.asarray(imgs_b)),
                "text-text": (caps_a, caps_b), "image-image": (jnp.asarray(imgs_a), jnp.asarray(imgs_b)),
                "list-of-images": (list(imgs_a), caps_b)}[pair]
    _close(tfm.clip_score(*port_args, image_encoder=ti, text_encoder=tt, device="cpu"),
           jfm.clip_score(*ref_args, image_encoder=ji, text_encoder=jt))
    with pytest.raises(ValueError) as port_err:
        tfm.clip_score(caps_a, caps_b[:2], image_encoder=ti, text_encoder=tt, device="cpu")
    with pytest.raises(ValueError) as ref_err:
        jfm.clip_score(caps_a, caps_b[:2], image_encoder=ji, text_encoder=jt)
    assert str(port_err.value) == str(ref_err.value)


PROMPT_SETS = [("quality",), tuple(J_PROMPTS), ("quality", ("Nice photo.", "Ugly photo."), "warm", ("A cat.", "A dog."))]


@pytest.mark.parametrize("prompts", PROMPT_SETS, ids=["single", "all-sixteen", "custom-tuples"])
def test_clip_iqa_class_matches_the_reference(prompts):
    ji, jt, ti, tt = _encoders()
    ref = jm.CLIPImageQualityAssessment(prompts=prompts, image_encoder=ji, text_encoder=jt)
    port = tm.CLIPImageQualityAssessment(prompts=prompts, image_encoder=ti, text_encoder=tt, device="cpu")
    for seed in (6, 7):  # two updates; the class hands the images over undivided, as the JAX package's
        imgs = _images(seed, 3, scale=255.0)
        ref.update(jnp.asarray(imgs))
        port.update(torch.from_numpy(imgs))
    r, p = ref.compute(), port.compute()
    if len(prompts) == 1:
        _close(p, r)
        return
    # the port keeps the prompt order, the JAX package's compute sorts its dict (ROADMAP section C); custom
    # tuples are numbered by their own count
    assert list(p) == t_resolve(prompts)[1] and sorted(p) == sorted(r)
    for k in r:
        _close(p[k], r[k])


@pytest.mark.parametrize("prompts", PROMPT_SETS, ids=["single", "all-sixteen", "custom-tuples"])
@pytest.mark.parametrize("data_range", [1.0, 255.0])
def test_clip_iqa_function_matches_the_reference(prompts, data_range):
    ji, jt, ti, tt = _encoders()
    for imgs in (_images(8, 4, scale=data_range), _images(9, 1, scale=data_range)[0]):  # a batch, one image
        r = jfm.clip_image_quality_assessment(jnp.asarray(imgs), data_range=data_range, prompts=prompts,
                                              image_encoder=ji, text_encoder=jt)
        p = tfm.clip_image_quality_assessment(torch.from_numpy(imgs), data_range=data_range, prompts=prompts,
                                              image_encoder=ti, text_encoder=tt, device="cpu")
        if isinstance(r, dict):
            assert list(p) == list(r)
            for k in r:
                _close(p[k], r[k])
        else:
            _close(p, r)


def test_prompt_table_and_resolution_equal_the_reference():
    assert T_PROMPTS == J_PROMPTS and len(T_PROMPTS) == 16
    prompts = (("x.", "y."), "quality", ("u.", "v."), "relaxing")
    assert t_resolve(prompts) == j_resolve(prompts)
    assert t_resolve(prompts)[1] == ["user_defined_0", "quality", "user_defined_1", "relaxing"]
    for bad in (("nope",), (("only-one",),), (3,)):
        with pytest.raises(ValueError) as port_err:
            t_resolve(bad)
        with pytest.raises(ValueError) as ref_err:
            j_resolve(bad)
        assert str(port_err.value) == str(ref_err.value)


def test_default_path_is_a_local_clip_checkpoint(tmp_path):
    """With no encoders, both classes and both functions load a local Hugging Face CLIP checkpoint (a tiny
    random one here) on the given device and score as the injected path over the same model does."""
    path, model, processor = tiny_clip(tmp_path / "tiny-clip")

    def img_enc(images):
        arr = [np.asarray(i.detach().cpu() if isinstance(i, torch.Tensor) else i) for i in images]
        with torch.no_grad():
            return model.get_image_features(pixel_values=processor(images=arr, return_tensors="pt")["pixel_values"])

    def txt_enc(texts):
        batch = processor(text=list(texts), return_tensors="pt", padding=True)
        with torch.no_grad():
            return model.get_text_features(input_ids=batch["input_ids"], attention_mask=batch["attention_mask"])

    imgs = torch.from_numpy(np.random.RandomState(10).rand(3, 3, 32, 32).astype(np.float32))
    caps = ["a photo of a cat", "a dog", "the good photo"]
    default = tm.CLIPScore(model_name_or_path=path, device="cpu")
    injected = tm.CLIPScore(image_encoder=img_enc, text_encoder=txt_enc, device="cpu")
    for m in (default, injected):
        m.update(imgs, caps)
    np.testing.assert_allclose(float(default.compute()), float(injected.compute()), rtol=1e-5)
    np.testing.assert_allclose(float(tfm.clip_score(imgs, caps, model_name_or_path=path, device="cpu")),
                               float(injected.compute()), rtol=1e-5)
    prompts = ("quality", ("a good photo.", "a bad photo."))
    default = tm.CLIPImageQualityAssessment(model_name_or_path=path, prompts=prompts, device="cpu")
    injected = tm.CLIPImageQualityAssessment(prompts=prompts, image_encoder=img_enc, text_encoder=txt_enc,
                                             device="cpu")
    for m in (default, injected):
        m.update(imgs)
    got, want = default.compute(), injected.compute()
    assert list(got) == ["quality", "user_defined_0"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6)
    fn = tfm.clip_image_quality_assessment(imgs, model_name_or_path=path, prompts=prompts, device="cpu")
    for k in want:
        np.testing.assert_allclose(fn[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ModuleNotFoundError):
        tm.CLIPScore(model_name_or_path=str(tmp_path / "absent"), device="cpu")
