"""BERTScore and InfoLM of the port against the JAX package, through the same numpy-backed injected callables.

Both packages get encoders (and distribution functions) built over one seeded numpy table: the JAX side's
return ``jnp`` arrays, the port's tensors, with the same values. The JAX package scores pair by pair in
float64 numpy; the port scores batches of pairs in float64 torch; both round once to float32. Tolerance:
rtol 1e-6, atol 1e-7. Every information measure runs at ``temperature`` 1.0 and 0.25, over one-token
sentences too, and an empty pair list scores 0.0 in both. The default BERTScore path runs a tiny random BERT
(2 layers, 32 wide) saved locally, held against the injected path over the same model.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.text as jft
import metrics_tpu.text as jt
import metrics_tpu_torch.functional.text as tft
import metrics_tpu_torch.text as tt
from _torch_hf import tiny_bert

RTOL, ATOL = 1e-6, 1e-7
WORDS = "the cat sat on mat a dog ran far away quick brown fox jumps over lazy".split()
MEASURES = ("kl_divergence", "alpha_divergence", "beta_divergence", "ab_divergence", "renyi_divergence",
            "l1_distance", "l2_distance", "l_infinity_distance", "fisher_rao_distance")


def _close(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=RTOL, atol=ATOL)


def _sentences(seed, n, lo=1, hi=7):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, rng.randint(lo, hi + 1))) for _ in range(n)]


def _tables(seed=0, dim=8, vocab=11):
    rng = np.random.RandomState(seed)
    emb = {w: rng.randn(dim) for w in WORDS}
    logits = {w: rng.randn(vocab) * 2 for w in WORDS}
    dist = {w: np.exp(v - v.max()) / np.exp(v - v.max()).sum() for w, v in logits.items()}
    return emb, dist


EMB, DIST = _tables()


def _rows(table, text):
    return np.stack([table[w] for w in text.split()])


def _encoders(table):
    """(the JAX side's callable returning jnp arrays, the port's returning tensors), over one numpy table."""
    return (lambda texts: [jnp.asarray(_rows(table, t)) for t in texts],
            lambda texts: [torch.from_numpy(_rows(table, t)) for t in texts])


J_ENC, T_ENC = _encoders(EMB)
J_DIST, T_DIST = _encoders(DIST)
PAIRS = [(_sentences(1, 9), _sentences(2, 9)), (_sentences(3, 5, 1, 1), _sentences(4, 5, 1, 1)),
         (_sentences(5, 4, 1, 1), _sentences(6, 4, 3, 7))]


@pytest.mark.parametrize("pair", range(len(PAIRS)))
def test_bert_score_matches_the_reference(pair):
    preds, target = PAIRS[pair]
    ref = jt.BERTScore(encoder=J_ENC)
    port = tt.BERTScore(encoder=T_ENC, device="cpu")
    for sl in (slice(0, 2), slice(2, None)):  # two updates
        ref.update(preds[sl], target[sl])
        port.update(preds[sl], target[sl])
    r, p = ref.compute(), port.compute()
    assert sorted(p) == sorted(r)  # the JAX package returns its dict sorted (ROADMAP section C)
    for k in r:
        _close(p[k], r[k])
    _close(tft.bert_score(preds, target, encoder=T_ENC, device="cpu")["f1"],
           jft.bert_score(preds, target, encoder=J_ENC)["f1"])


def test_bert_score_of_no_pairs_and_a_reset_is_zero():
    port = tt.BERTScore(encoder=T_ENC, device="cpu")
    ref = jt.BERTScore(encoder=J_ENC)
    for k, v in port.compute().items():
        _close(v, ref.compute()[k])
        assert float(v) == 0.0
    port.update("the cat", "a dog")
    assert float(port.compute()["f1"]) != 0.0
    port.reset()
    assert port._pairs == [] and float(port.compute()["f1"]) == 0.0


def test_bert_score_of_identical_pairs_is_one_and_keeps_the_pairs_out_of_the_states():
    port = tt.BERTScore(encoder=T_ENC, device="cpu")
    port.update(["the cat sat", "fox"], ["the cat sat", "fox"])
    np.testing.assert_allclose(float(port.compute()["f1"]), 1.0, rtol=1e-6)
    assert port._defaults == {} and len(port._pairs) == 2  # a host list: no sync() carries it


@pytest.mark.parametrize("temperature", [1.0, 0.25])
@pytest.mark.parametrize("measure", MEASURES)
def test_infolm_matches_the_reference(measure, temperature):
    kw = dict(information_measure=measure, temperature=temperature, alpha=0.3, beta=0.6)
    for preds, target in PAIRS:
        ref = jt.InfoLM(distribution_fn=J_DIST, **kw)
        port = tt.InfoLM(distribution_fn=T_DIST, device="cpu", **kw)
        ref.update(preds, target)
        port.update(preds, target)
        _close(port.compute(), ref.compute())
        _close(port.compute_sentence_scores(), ref.compute_sentence_scores())
    corpus, sentences = tft.infolm(preds, target, distribution_fn=T_DIST, return_sentence_level_score=True,
                                   device="cpu", **kw)
    r_corpus, r_sentences = jft.infolm(preds, target, distribution_fn=J_DIST, return_sentence_level_score=True,
                                       **kw)
    _close(corpus, r_corpus)
    _close(sentences, r_sentences)


@pytest.mark.parametrize("measure", MEASURES)
def test_infolm_of_no_pairs_is_zero(measure):
    port = tt.InfoLM(distribution_fn=T_DIST, information_measure=measure, device="cpu")
    ref = jt.InfoLM(distribution_fn=J_DIST, information_measure=measure)
    _close(port.compute(), ref.compute())
    assert float(port.compute()) == 0.0
    corpus, sentences = tft.infolm([], [], distribution_fn=T_DIST, information_measure=measure,
                                   return_sentence_level_score=True, device="cpu")
    assert float(corpus) == 0.0 and tuple(sentences.shape) == (0,)


def test_infolm_batches_agree_with_one_batch(monkeypatch):
    """Pairs scored over many small batches equal one batch."""
    import metrics_tpu_torch.text.model_based as mb

    preds, target = PAIRS[0]
    whole = tt.InfoLM(distribution_fn=T_DIST, device="cpu")
    whole.update(preds, target)
    monkeypatch.setattr(mb, "_CHUNK_BYTES", 1)  # one pair a batch
    split = tt.InfoLM(distribution_fn=T_DIST, device="cpu")
    split.update(preds, target)
    np.testing.assert_allclose(split.compute_sentence_scores().numpy(), whole.compute_sentence_scores().numpy(),
                               rtol=1e-12)
    bert = tt.BERTScore(encoder=T_ENC, device="cpu")
    bert.update(preds, target)
    ref = jt.BERTScore(encoder=J_ENC)
    ref.update(preds, target)
    _close(bert.compute()["f1"], ref.compute()["f1"])


def test_infolm_refuses_what_the_reference_refuses():
    for kwargs, exc in (({"distribution_fn": None}, ModuleNotFoundError),
                        ({"distribution_fn": T_DIST, "information_measure": "hellinger"}, ValueError),
                        ({"distribution_fn": T_DIST, "temperature": 0}, ValueError)):
        with pytest.raises(exc) as port_err:
            tt.InfoLM(device="cpu", **kwargs)
        ref_kwargs = dict(kwargs, distribution_fn=J_DIST if kwargs["distribution_fn"] else None)
        with pytest.raises(exc) as ref_err:
            jt.InfoLM(**ref_kwargs)
        assert str(port_err.value) == str(ref_err.value)


def test_bert_score_default_path_is_a_local_checkpoint(tmp_path):
    """With no encoder, BERTScore loads a local Hugging Face checkpoint (a tiny random BERT here) on the
    metric's device and scores as the injected path over the same model does."""
    ckpt, model, tok = tiny_bert(tmp_path / "tiny-bert")

    def injected(texts):
        out = []
        for t in texts:
            with torch.no_grad():
                out.append(model(**tok(t, return_tensors="pt")).last_hidden_state[0])
        return out

    preds, target = PAIRS[0]
    default = tt.BERTScore(model_name_or_path=ckpt, device="cpu")
    manual = tt.BERTScore(encoder=injected, device="cpu")
    for m in (default, manual):
        m.update(preds, target)
    got, want = default.compute(), manual.compute()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    with pytest.raises(ModuleNotFoundError):
        tt.BERTScore(model_name_or_path=str(tmp_path / "absent"), device="cpu")
