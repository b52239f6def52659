"""The port's text metrics against the JAX package's, on the same seeded inputs.

Strings are tokenized and compared on the host in both packages with the same
algorithms, so every host-computed score and count is equal bit for bit: the
error rates and edit distances, the BLEU and chrF counts, ROUGE, TER, EED and
SQuAD, each a float32 rounding of the same float64 or integer. BLEU's score is
computed from its counts on the device in float32 (``BLEU_RTOL``: the same
float32 steps, with XLA's and torch's ``exp``/``log`` free to differ by an
ulp); perplexity sums float32 log-probabilities in another order
(``PERPLEXITY_RTOL``). The text states keep the JAX package's types: float32
counts (errors, totals, BLEU's and chrF's n-gram counts) and int64 counters
(``EditDistance``'s and ``Perplexity``'s counts; the JAX package's int32 under
x32). The raw-string metrics (ROUGE, TER, EED, SQuAD) keep their stores out of
the state system: ``forward``, ``merge_state`` and ``reset`` carry them, a
sync does not (held on both packages), and ``load_reference_state`` takes
them. The second half runs the JAX package's own text tests
(``tests/test_text.py``) on the port, and the port's SacreBLEU tokenizers
against the ``sacrebleu`` package's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.text as jf
import metrics_tpu.functional.text.helper as jhelper
import metrics_tpu.text as jt
import metrics_tpu_torch.functional.text as tf
import metrics_tpu_torch.functional.text.helper as thelper
import metrics_tpu_torch.text as tt
from metrics_tpu_torch.interop import load_reference_state

BLEU_RTOL = 1e-6
# chrF's class computes its corpus score from the float32 counts on the device: the mean of the per-order F
# values, summed in another order than XLA's (1.7e-7 relative seen), the same licence as BLEU's device compute
CHRF_DEVICE_RTOL = 1e-6
PERPLEXITY_RTOL = 1e-5
CPU = {"device": "cpu"}

_VOCAB = ["the", "cat", "is", "on", "mat", "a", "dog", "sat", "there", "here", "an", "other", "sample", "one",
          "prediction", "reference", "with", "of", "and", "to", "in", "it", "that", "was"]
_PUNCT = [",", ".", "!", "?", ";", "(x)", "3.14", "1,000", "e.g.", "Dr.", "U.S.", "-", "$5"]


def _sentence(rng, n, punct=False):
    words = list(rng.choice(_VOCAB, n))
    if punct:
        for _ in range(max(1, n // 4)):
            words.insert(int(rng.integers(0, len(words) + 1)), str(rng.choice(_PUNCT)))
    return words


def _corrupt(rng, words, sub=0.15, ins=0.05, dele=0.05):
    out = []
    for w in words:
        r = rng.random()
        if r < dele:
            continue
        out.append(str(rng.choice(_VOCAB)) if r < dele + sub else w)
        if rng.random() < ins:
            out.append(str(rng.choice(_VOCAB)))
    return out


def _pairs(seed, n=12, length=(3, 14), punct=False):
    """(preds, target) lists of sentences; the predictions are the targets with substitutions, insertions and
    deletions; one pair is empty on the prediction side and one is identical."""
    rng = np.random.default_rng(seed)
    target, preds = [], []
    for i in range(n):
        words = _sentence(rng, int(rng.integers(*length)), punct)
        target.append(" ".join(words))
        preds.append("" if i == 1 else " ".join(words if i == 2 else _corrupt(rng, words)))
    return preds, target


def _multi_ref(seed, n=8, refs=(1, 4), punct=False, length=(4, 14)):
    """(preds, target) with one to three references per sentence."""
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for _ in range(n):
        words = _sentence(rng, int(rng.integers(*length)), punct)
        preds.append(" ".join(_corrupt(rng, words)))
        target.append([" ".join(_corrupt(rng, words, 0.1, 0.05, 0.05)) for _ in range(int(rng.integers(*refs)))])
    return preds, target


def _eq(port, ref):
    """Equal bit for bit, dtype and shape included."""
    ref = np.asarray(ref)
    got = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype, got.shape, ref.shape)
    assert got.tobytes() == ref.tobytes(), (got, ref)


def _close(port, ref, rtol):
    ref = np.asarray(ref)
    got = port.detach().cpu().numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0.0)


def _eq_tree(port, ref):
    if isinstance(ref, dict):
        assert list(port) == list(ref)
        for k in ref:
            _eq(port[k], ref[k])
    elif isinstance(ref, tuple):
        assert isinstance(port, tuple) and len(port) == len(ref)
        for p, r in zip(port, ref):
            _eq(p, r)
    else:
        _eq(port, ref)


# ----------------------------------------------------------------------------- the host DPs
@pytest.mark.parametrize("seed", range(4))
def test_edit_distance_counts_and_distance_equal_reference(seed):
    """The backtrack's split of hits, substitutions, insertions and deletions (diagonal first, then the
    insertion) and the row DP's distance, on random word and character sequences."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        ref = list(rng.choice(_VOCAB[:6], int(rng.integers(0, 12))))
        pred = _corrupt(rng, ref, 0.3, 0.2, 0.2) if ref else list(rng.choice(_VOCAB[:6], 3))
        assert thelper._edit_distance_counts(pred, ref) == jhelper._edit_distance_counts(pred, ref)
        assert thelper._edit_distance(pred, ref) == jhelper._edit_distance(pred, ref)
        assert thelper._edit_distance(list("".join(pred)), list("".join(ref))) == jhelper._edit_distance(
            list("".join(pred)), list("".join(ref)))


@pytest.mark.parametrize("name", ["_tokenize_13a", "_tokenize_zh", "_tokenize_international", "_tokenize_chars",
                                  "_tokenize_words", "_squad_normalize"])
def test_tokenizers_equal_reference(name):
    lines = ["The cat, is on the mat!", "Hello-world 3.14 (x) $5 'quote' 1,000", "我爱北京天安门, ok. 東京",
             "Ünïcödé—dash «q» 12-3 <skipped> a-\nb", "  spaced \t out  ", "", "An apple; the end."]
    for line in lines:
        assert getattr(thelper, name)(line) == getattr(jhelper, name)(line)


def test_ngram_counts_equal_reference():
    rng = np.random.default_rng(3)
    tokens = list(rng.choice(_VOCAB[:5], 30))
    for n in (1, 2, 4, 6):
        assert thelper._ngram_counts(tokens, n) == jhelper._ngram_counts(tokens, n)


# ----------------------------------------------------------------------------- error rates
ERROR_FNS = ["word_error_rate", "char_error_rate", "match_error_rate", "word_information_preserved",
             "word_information_lost"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ERROR_FNS)
def test_error_rate_functions_equal_reference(name, seed):
    preds, target = _pairs(seed)
    _eq(getattr(tf, name)(preds, target, **CPU), getattr(jf, name)(preds, target))
    _eq(getattr(tf, name)(preds[0], target[0], **CPU), getattr(jf, name)(preds[0], target[0]))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
@pytest.mark.parametrize("substitution_cost", [0, 1, 2])
def test_edit_distance_function_equal_reference(substitution_cost, reduction):
    preds, target = _pairs(4, n=6)
    _eq(tf.edit_distance(preds, target, substitution_cost, reduction, **CPU),
        jf.edit_distance(preds, target, substitution_cost, reduction))


def test_edit_distance_reduction_refused_as_reference():
    with pytest.raises(ValueError, match="Expected argument `reduction` to either be") as port:
        tf.edit_distance(["a"], ["b"], reduction="max", **CPU)
    with pytest.raises(ValueError) as ref:
        jf.edit_distance(["a"], ["b"], reduction="max")
    assert str(port.value) == str(ref.value)


# ----------------------------------------------------------------------------- perplexity
def _logits(seed, b=2, s=9, v=37, ignore_share=0.2, dtype=np.float32, ignore_index=-100):
    rng = np.random.default_rng(seed)
    preds = (3 * rng.standard_normal((b, s, v))).astype(dtype)
    target = rng.integers(0, v, (b, s))
    target[rng.random((b, s)) < ignore_share] = ignore_index
    return preds, target


@pytest.mark.parametrize("ignore_index", [None, -100, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_perplexity_function_within_rtol(seed, ignore_index):
    preds, target = _logits(seed, ignore_share=0.0 if ignore_index is None else 0.2, ignore_index=ignore_index or 0)
    got = tf.perplexity(torch.from_numpy(preds), torch.from_numpy(target), ignore_index)
    _close(got, jf.perplexity(jnp.asarray(preds), jnp.asarray(target), ignore_index), PERPLEXITY_RTOL)
    total, count = tf.perplexity.__globals__["_perplexity_update"](
        torch.from_numpy(preds), torch.from_numpy(target), ignore_index)
    assert total.dtype == torch.float32 and count.dtype == torch.int64


def test_perplexity_reads_half_precision_logits_as_float32():
    preds, target = _logits(2, ignore_share=0.0, dtype=np.float16)
    _close(tf.perplexity(torch.from_numpy(preds), torch.from_numpy(target)),
           jf.perplexity(jnp.asarray(preds), jnp.asarray(target)), PERPLEXITY_RTOL)


@pytest.mark.parametrize(("shape_p", "shape_t"), [((2, 3), (2, 3)), ((2, 3, 4), (2,)), ((2, 3, 4), (2, 4))])
def test_perplexity_shape_errors_as_reference(shape_p, shape_t):
    with pytest.raises(ValueError) as port:
        tf.perplexity(torch.zeros(shape_p), torch.zeros(shape_t, dtype=torch.long))
    with pytest.raises(ValueError) as ref:
        jf.perplexity(jnp.zeros(shape_p), jnp.zeros(shape_t, dtype=jnp.int32))
    assert str(port.value) == str(ref.value)


# ----------------------------------------------------------------------------- BLEU
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("n_gram", [1, 2, 4])
def test_bleu_counts_equal_and_score_within_rtol(n_gram, smooth):
    preds, target = _multi_ref(5)
    from metrics_tpu.functional.text.bleu import _bleu_score_update as jupdate
    from metrics_tpu_torch.functional.text.bleu import _bleu_score_update as tupdate

    args = (preds, target, np.zeros(n_gram), np.zeros(n_gram), 0.0, 0.0, n_gram)
    got, want = tupdate(*args[:2], np.zeros(n_gram), np.zeros(n_gram), *args[4:]), jupdate(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _close(tf.bleu_score(preds, target, n_gram, smooth, **CPU), jf.bleu_score(preds, target, n_gram, smooth), BLEU_RTOL)


def test_bleu_weights_and_errors_as_reference():
    preds, target = _multi_ref(6)
    w = [0.4, 0.3, 0.2, 0.1]
    _close(tf.bleu_score(preds, target, weights=w, **CPU), jf.bleu_score(preds, target, weights=w), BLEU_RTOL)
    for kwargs in ({"weights": [0.5, 0.5]}, {}):
        p = preds if kwargs else preds[:-1]
        with pytest.raises(ValueError) as port:
            tf.bleu_score(p, target, **kwargs, **CPU)
        with pytest.raises(ValueError) as ref:
            jf.bleu_score(p, target, **kwargs)
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("lowercase", [False, True])
@pytest.mark.parametrize("tokenize", ["none", "13a", "zh", "intl", "char"])
def test_sacre_bleu_tokenizers_within_rtol(tokenize, lowercase):
    preds, target = _multi_ref(7, punct=True)
    preds = [p.title() if i % 2 else p + " 北京" for i, p in enumerate(preds)]
    _close(tf.sacre_bleu_score(preds, target, tokenize=tokenize, lowercase=lowercase, **CPU),
           jf.sacre_bleu_score(preds, target, tokenize=tokenize, lowercase=lowercase), BLEU_RTOL)


@pytest.mark.parametrize("tokenize", ["ja-mecab", "ko-mecab", "flores101", "flores200", "bogus"])
def test_sacre_bleu_unavailable_tokenizers_raise_as_reference(tokenize):
    error = ValueError if tokenize == "bogus" else ModuleNotFoundError
    with pytest.raises(error) as port:
        tf.sacre_bleu_score(["a"], [["a"]], tokenize=tokenize, **CPU)
    with pytest.raises(error) as ref:
        jf.sacre_bleu_score(["a"], [["a"]], tokenize=tokenize)
    assert str(port.value) == str(ref.value)
    with pytest.raises(error):
        tt.SacreBLEUScore(tokenize=tokenize, **CPU)


# ----------------------------------------------------------------------------- chrF
@pytest.mark.parametrize(("n_char_order", "n_word_order", "beta", "lowercase", "whitespace"), [
    (6, 0, 2.0, False, False), (6, 2, 2.0, False, False), (4, 1, 1.0, True, False), (3, 3, 3.0, False, True),
    (1, 0, 0.0, True, True)])
def test_chrf_function_equal_reference(n_char_order, n_word_order, beta, lowercase, whitespace):
    preds, target = _multi_ref(8, punct=True)
    preds = [p.upper() if i % 3 == 0 else p for i, p in enumerate(preds)]
    args = (preds, target, n_char_order, n_word_order, beta, lowercase, whitespace)
    _eq(tf.chrf_score(*args, **CPU), jf.chrf_score(*args))
    _eq_tree(tf.chrf_score(*args, return_sentence_level_score=True, **CPU),
             jf.chrf_score(*args, return_sentence_level_score=True))


@pytest.mark.parametrize("kwargs", [{"n_char_order": 0}, {"n_char_order": 1.5}, {"n_word_order": -1},
                                    {"beta": -1.0}])
def test_chrf_argument_errors_as_reference(kwargs):
    with pytest.raises(ValueError) as port:
        tf.chrf_score(["a"], [["a"]], **kwargs, **CPU)
    with pytest.raises(ValueError) as ref:
        jf.chrf_score(["a"], [["a"]], **kwargs)
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match=str(ref.value)[:30]):
        tt.CHRFScore(**kwargs, **CPU)


# ----------------------------------------------------------------------------- ROUGE
def _summaries(seed, n=5):
    """Multi-sentence summaries (newline-separated) with one or two references."""
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for _ in range(n):
        sents = [_sentence(rng, int(rng.integers(3, 9)), punct=True) for _ in range(int(rng.integers(1, 4)))]
        preds.append("\n".join(" ".join(_corrupt(rng, s)) for s in sents) + " running cats WALKED")
        target.append(["\n".join(" ".join(_corrupt(rng, s, 0.1)) for s in sents) + " runs cat walking"
                       for _ in range(int(rng.integers(1, 3)))])
    return preds, target


@pytest.mark.parametrize("use_stemmer", [False, True])
@pytest.mark.parametrize("accumulate", ["best", "avg"])
def test_rouge_every_key_equal_reference(accumulate, use_stemmer):
    preds, target = _summaries(9)
    keys = ("rouge1", "rouge2", "rouge3", "rouge4", "rouge5", "rouge6", "rouge7", "rouge8", "rouge9", "rougeL",
            "rougeLsum")
    _eq_tree(tf.rouge_score(preds, target, accumulate, use_stemmer, keys, **CPU),
             jf.rouge_score(preds, target, accumulate, use_stemmer, keys))


def test_rouge_single_strings_and_errors_as_reference():
    _eq_tree(tf.rouge_score("My name is John", "Is your name John", rouge_keys="rougeL", **CPU),
             jf.rouge_score("My name is John", "Is your name John", rouge_keys="rougeL"))
    for kwargs in ({"rouge_keys": ("rouge10",)}, {"accumulate": "max"}):
        with pytest.raises(ValueError) as port:
            tf.rouge_score("a", "a", **kwargs, **CPU)
        with pytest.raises(ValueError) as ref:
            jf.rouge_score("a", "a", **kwargs)
        assert str(port.value) == str(ref.value)


# ----------------------------------------------------------------------------- TER, EED, SQuAD
@pytest.mark.parametrize(("normalize", "no_punctuation", "lowercase", "asian_support"), [
    (False, False, True, False), (True, False, True, False), (False, True, False, False),
    (True, True, True, True), (False, False, False, True)])
def test_ter_function_equal_reference(normalize, no_punctuation, lowercase, asian_support):
    preds, target = _multi_ref(10, n=4, refs=(1, 3), punct=True, length=(3, 10))
    preds = [p.replace("cat", "Cat") + (" 東京です" if asian_support else "") for p in preds]
    args = (preds, target, normalize, no_punctuation, lowercase, asian_support)
    _eq(tf.translation_edit_rate(*args, **CPU), jf.translation_edit_rate(*args))
    _eq_tree(tf.translation_edit_rate(*args, return_sentence_level_score=True, **CPU),
             jf.translation_edit_rate(*args, return_sentence_level_score=True))


def test_ter_shift_search_equal_reference():
    rng = np.random.default_rng(11)
    for _ in range(5):
        ref = list(rng.choice(_VOCAB, 9))
        pred = ref[4:] + ref[:4]
        from metrics_tpu.functional.text.misc import _ter_shifts as jshifts
        from metrics_tpu_torch.functional.text.misc import _ter_shifts as tshifts

        assert tshifts(pred, ref) == jshifts(pred, ref)


@pytest.mark.parametrize("language", ["en", "ja"])
def test_eed_function_equal_reference(language):
    preds, target = _multi_ref(12, n=5, punct=True)
    if language == "ja":
        preds = [p + " ｶﾀｶﾅ。" for p in preds]
    _eq(tf.extended_edit_distance(preds, target, language, **CPU), jf.extended_edit_distance(preds, target, language))
    _eq_tree(tf.extended_edit_distance(preds, target, language, True, 1.5, 0.2, 0.3, 0.9, **CPU),
             jf.extended_edit_distance(preds, target, language, True, 1.5, 0.2, 0.3, 0.9))
    with pytest.raises(ValueError) as port:
        tf.extended_edit_distance(preds, target, "de", **CPU)
    with pytest.raises(ValueError) as ref:
        jf.extended_edit_distance(preds, target, "de")
    assert str(port.value) == str(ref.value)


def _squad(seed, n=30):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for i in range(n):
        answers = [" ".join(_sentence(rng, int(rng.integers(1, 5)), punct=True)) for _ in range(int(rng.integers(1, 4)))]
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"q{i}"})
        pick = rng.random()
        text = answers[0] if pick < 0.3 else ("The " + answers[-1].upper() + "!") if pick < 0.6 else \
            " ".join(_sentence(rng, 3))
        if i != 3:  # one question without a prediction
            preds.append({"prediction_text": text, "id": f"q{i}"})
    preds.append({"prediction_text": "", "id": "q3"})
    return preds, target


def test_squad_function_equal_reference():
    preds, target = _squad(13)
    _eq_tree(tf.squad(preds, target, **CPU), jf.squad(preds, target))
    _eq_tree(tf.squad(preds[0], target[0], **CPU), jf.squad(preds[0], target[0]))
    for bad_p, bad_t, error in (([{"id": "q0"}], target[:1], KeyError), (preds[:1], [{"id": "q0"}], KeyError),
                                (preds[:2], target[:1], ValueError)):
        with pytest.raises(error) as port:
            tf.squad(bad_p, bad_t, **CPU)
        with pytest.raises(error) as ref:
            jf.squad(bad_p, bad_t)
        assert str(port.value) == str(ref.value)


# ----------------------------------------------------------------------------- the classes
def _text_inputs(name, seed):
    if name == "TranslationEditRate":  # short sentences: the shift search re-runs the DP for every candidate
        return _multi_ref(seed, n=3, refs=(1, 3), punct=True, length=(3, 8))
    if name in ("BLEUScore", "SacreBLEUScore", "CHRFScore", "TranslationEditRate", "ExtendedEditDistance"):
        return _multi_ref(seed, n=3, refs=(1, 3), punct=True)
    if name == "ROUGEScore":
        return _summaries(seed, n=3)
    if name == "SQuAD":
        return _squad(seed, n=6)
    return _pairs(seed, n=5)


CLASSES = {
    "WordErrorRate": {}, "CharErrorRate": {}, "MatchErrorRate": {}, "WordInfoPreserved": {}, "WordInfoLost": {},
    "EditDistance": {}, "EditDistance[sum,cost2]": {"reduction": "sum", "substitution_cost": 2},
    "EditDistance[none]": {"reduction": "none"}, "BLEUScore": {}, "BLEUScore[smooth,2]": {"smooth": True, "n_gram": 2},
    "SacreBLEUScore": {}, "SacreBLEUScore[intl,lower]": {"tokenize": "intl", "lowercase": True},
    "CHRFScore": {}, "CHRFScore[sentence]": {"return_sentence_level_score": True, "n_word_order": 0},
    "ROUGEScore": {}, "ROUGEScore[avg,stem]": {"accumulate": "avg", "use_stemmer": True},
    "TranslationEditRate": {}, "ExtendedEditDistance": {"return_sentence_level_score": True}, "SQuAD": {},
}
STORE_CLASSES = ("ROUGEScore", "TranslationEditRate", "ExtendedEditDistance", "SQuAD")
FLOAT_DEVICE = ("BLEUScore", "SacreBLEUScore")


def _make(case):
    cls = case.split("[")[0]
    return getattr(tt, cls)(**CLASSES[case], **CPU), getattr(jt, cls)(**CLASSES[case])


def _values(case, port, ref):
    if case.split("[")[0] in FLOAT_DEVICE:
        _close(port, ref, BLEU_RTOL)
    elif case.startswith("CHRFScore"):
        corpus = (port[0], ref[0]) if isinstance(ref, tuple) else (port, ref)
        _close(*corpus, CHRF_DEVICE_RTOL)
        if isinstance(ref, tuple):
            _eq(port[1], ref[1])  # the sentence scores are host-computed
    else:
        _eq_tree(port, ref)


def _states(port, ref):
    assert list(port.metric_state) == list(ref.metric_state)
    for key, value in ref.metric_state.items():
        if isinstance(value, list):
            assert len(port.metric_state[key]) == len(value)
            for p, r in zip(port.metric_state[key], value):
                _eq(p, r)
            continue
        got = port.metric_state[key]
        if np.asarray(value).dtype == np.int32:  # count_dtype(): int64 in the port, int32 under x32
            assert got.dtype == torch.int64 and int(got) == int(value), key
        else:
            _eq(got, value)


@pytest.mark.parametrize("case", list(CLASSES))
def test_class_update_compute_forward_merge_reset_match_reference(case):
    port, ref = _make(case)
    batches = [_text_inputs(case, s) for s in (20, 21, 22)]
    for p, t in batches[:2]:
        port.update(p, t)
        ref.update(p, t)
    _states(port, ref)
    _values(case, port.compute(), ref.compute())
    _values(case, port.forward(*batches[2]), ref.forward(*batches[2]))
    _states(port, ref)
    _values(case, port.compute(), ref.compute())
    # merge: a second stream folded in (the incoming one counts as the earlier)
    port2, ref2 = _make(case)
    for p, t in (batches[1], batches[0]):
        port2.update(p, t)
        ref2.update(p, t)
    port.merge_state(port2)
    ref.merge_state(ref2)
    _states(port, ref)
    if case.split("[")[0] in STORE_CLASSES:
        assert port._preds_store == ref._preds_store and port._target_store == ref._target_store
    _values(case, port.compute(), ref.compute())
    port.reset()
    ref.reset()
    _states(port, ref)
    if case.split("[")[0] in STORE_CLASSES:
        assert port._preds_store == [] and port._target_store == []


@pytest.mark.parametrize("name", ["WordErrorRate", "CharErrorRate", "MatchErrorRate", "WordInfoPreserved",
                                  "WordInfoLost", "BLEUScore", "SacreBLEUScore", "CHRFScore"])
def test_text_count_states_are_float32(name):
    port = getattr(tt, name)(**CPU)
    assert port.metric_state and all(v.dtype == torch.float32 for v in port.metric_state.values())


def test_edit_distance_and_perplexity_counters_are_int64():
    assert tt.EditDistance(**CPU).num_elements.dtype == torch.int64
    assert tt.Perplexity(**CPU).count.dtype == torch.int64


@pytest.mark.parametrize("ignore_index", [None, -100])
def test_perplexity_class_within_rtol(ignore_index):
    port, ref = tt.Perplexity(ignore_index, **CPU), jt.Perplexity(ignore_index)
    for seed in (3, 4):
        preds, target = _logits(seed, ignore_share=0.0 if ignore_index is None else 0.2)
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    assert int(port.count) == int(ref.count)
    _close(port.total_log_probs, ref.total_log_probs, PERPLEXITY_RTOL)
    _close(port.compute(), ref.compute(), PERPLEXITY_RTOL)
    with pytest.raises(ValueError, match="`ignore_index` expected"):
        tt.Perplexity(ignore_index=1.5, **CPU)


def test_string_store_forward_is_all_or_nothing():
    port = tt.SQuAD(**CPU)
    preds, target = _squad(14, n=4)
    port.update(preds, target)
    with pytest.raises(KeyError):
        port.forward([{"id": "x"}], [{"id": "x", "answers": {"text": ["a"]}}])
    assert len(port._preds_store) == len(preds) and port.update_count == 1


def test_string_store_merge_refuses_other_metrics_as_reference():
    with pytest.raises(ValueError, match="holding its string stores"):
        tt.ROUGEScore(**CPU).merge_state(tt.WordErrorRate(**CPU))
    with pytest.raises(ValueError, match="holding its string stores"):
        jt.ROUGEScore().merge_state(jt.WordErrorRate())


def _fake_sync(peers, as_array):
    def sync_fn(states, group):
        return [[local] + [as_array(np.asarray(p[i])) for p in peers] for i, local in enumerate(states)]
    return sync_fn


@pytest.mark.parametrize("case", ["WordErrorRate", "BLEUScore", "CHRFScore", "ROUGEScore", "TranslationEditRate",
                                  "SQuAD"])
def test_fake_sync_sums_counts_and_leaves_string_stores_local(case):
    """A sync through the same fake transport: the count states are summed over the ranks; the string stores
    are not carried, so a raw-string metric computes on its own rank's strings, in both packages."""
    port, ref = _make(case)
    local_only, _ = _make(case)
    p, t = _text_inputs(case, 30)
    for m in (port, ref, local_only):
        m.update(p, t)
    peers_t, peers_j = [], []
    for seed in (31, 32):
        pt, pj = _make(case)
        pt.update(*_text_inputs(case, seed))
        pj.update(*_text_inputs(case, seed))
        peers_t.append([v.numpy() for v in pt.metric_state.values()])
        peers_j.append([np.asarray(v) for v in pj.metric_state.values()])
    port.sync(dist_sync_fn=_fake_sync(peers_t, torch.from_numpy), distributed_available=True)
    ref.sync(dist_sync_fn=_fake_sync(peers_j, jnp.asarray), distributed_available=True)
    _states(port, ref)
    _values(case, port._compute_impl(), ref._compute_impl())
    if case in STORE_CLASSES:
        _values(case, port._compute_impl(), local_only.compute())
    port.unsync()


@pytest.mark.parametrize("case", ["WordErrorRate", "EditDistance[none]", "BLEUScore", "CHRFScore[sentence]",
                                  "ROUGEScore", "ExtendedEditDistance", "SQuAD"])
def test_reference_stream_resumes_in_the_port(case):
    """A stream started in the JAX package goes on in the port: its states, and the raw-string metrics' stores
    added to the dict, carry over."""
    port, ref = _make(case)
    ref.persistent(True)
    ref.update(*_text_inputs(case, 40))
    state = ref.state_dict()
    if case.split("[")[0] in STORE_CLASSES:
        with pytest.raises(ValueError, match="_preds_store"):
            load_reference_state(port, state)
        state = {**state, "_preds_store": ref._preds_store, "_target_store": ref._target_store}
    load_reference_state(port, state)
    batch = _text_inputs(case, 41)
    port.update(*batch)
    ref.update(*batch)
    assert port.update_count == ref.update_count == 2
    _states(port, ref)
    _values(case, port.compute(), ref.compute())


TEXT_FUNCTIONS = [("word_error_rate", ("a b", "a c")), ("char_error_rate", ("ab", "ac")),
                  ("match_error_rate", ("a b", "a c")), ("word_information_preserved", ("a b", "a c")),
                  ("word_information_lost", ("a b", "a c")), ("edit_distance", (["ab"], ["ac"])),
                  ("bleu_score", (["a b"], [["a b"]])), ("sacre_bleu_score", (["a b"], [["a b"]])),
                  ("chrf_score", (["a b"], [["a b"]])), ("rouge_score", ("a b", "a b")),
                  ("translation_edit_rate", (["a b"], [["a b"]])), ("extended_edit_distance", (["a b"], [["a b"]])),
                  ("squad", ({"prediction_text": "a", "id": "1"}, {"answers": {"text": ["a"]}, "id": "1"}))]


def test_without_a_card_text_classes_and_string_functions_need_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the model-based classes take their model as an injected callable (no weights here)
    injected = {"BERTScore": {"encoder": lambda texts: []}, "InfoLM": {"distribution_fn": lambda texts: []}}
    for name in tt.__all__:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(tt, name)(**injected.get(name, {}))
        getattr(tt, name)(**CPU, **injected.get(name, {}))
    for name, args in TEXT_FUNCTIONS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(tf, name)(*args)
        getattr(tf, name)(*args, **CPU)


# ----------------------------------------------------------------------------- the JAX package's text tests, on the port
PREDS = ["this is the prediction", "there is an other sample"]
TARGET = ["this is the reference", "there is another one"]


def test_wer_known_value():
    m = tt.WordErrorRate(**CPU)
    m.update(PREDS, TARGET)
    np.testing.assert_allclose(float(m.compute()), 0.5)


def test_cer_vs_manual_dp():
    def lev(a, b):
        dp = np.zeros((len(a) + 1, len(b) + 1), dtype=int)
        dp[:, 0] = np.arange(len(a) + 1)
        dp[0, :] = np.arange(len(b) + 1)
        for i in range(1, len(a) + 1):
            for j in range(1, len(b) + 1):
                dp[i, j] = min(dp[i - 1, j] + 1, dp[i, j - 1] + 1, dp[i - 1, j - 1] + (a[i - 1] != b[j - 1]))
        return dp[-1, -1]

    m = tt.CharErrorRate(**CPU)
    m.update(PREDS, TARGET)
    errors = sum(lev(p, t) for p, t in zip(PREDS, TARGET))
    np.testing.assert_allclose(float(m.compute()), errors / sum(len(t) for t in TARGET), rtol=1e-6)


def test_mer_wil_wip_known_values():
    """The values jiwer gives for this fixture."""
    for cls, want in ((tt.MatchErrorRate, 0.4444), (tt.WordInfoPreserved, 0.3472), (tt.WordInfoLost, 0.6528)):
        m = cls(**CPU)
        m.update(PREDS, TARGET)
        np.testing.assert_allclose(float(m.compute()), want, atol=1e-4)


def test_edit_distance_known_values():
    m = tt.EditDistance(**CPU)
    m.update(["rain"], ["shine"])
    np.testing.assert_allclose(float(m.compute()), 3.0)
    m2 = tt.EditDistance(reduction="none", **CPU)
    m2.update(["rain", "lnaguaeg"], ["shine", "language"])
    np.testing.assert_allclose(m2.compute().numpy(), [3.0, 4.0])


def test_bleu_vs_nltk():
    from nltk.translate.bleu_score import corpus_bleu

    preds = ["the cat is on the mat", "there is a cat on the mat"]
    target = [["the cat is on the mat"], ["a cat is on the mat", "there is a cat on a mat"]]
    m = tt.BLEUScore(**CPU)
    m.update(preds, target)
    ref = corpus_bleu([[t.split() for t in refs] for refs in target], [p.split() for p in preds])
    np.testing.assert_allclose(float(m.compute()), ref, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bleu_vs_nltk_on_random_corpora(seed):
    from nltk.translate.bleu_score import corpus_bleu

    preds, target = _multi_ref(50 + seed, n=20)
    ref = corpus_bleu([[t.split() for t in refs] for refs in target], [p.split() for p in preds])
    np.testing.assert_allclose(float(tf.bleu_score(preds, target, **CPU)), ref, atol=1e-5)


def test_bleu_accumulation_matches_single_shot():
    preds = ["the cat is on the mat", "there is a cat on the mat"]
    target = [["the cat sat on the mat"], ["a cat is on the mat"]]
    m1, m2 = tt.BLEUScore(**CPU), tt.BLEUScore(**CPU)
    m1.update(preds, target)
    for p, t in zip(preds, target):
        m2.update([p], [t])
    np.testing.assert_allclose(float(m1.compute()), float(m2.compute()), rtol=1e-6)


def test_sacrebleu_13a_tokenizer():
    m = tt.SacreBLEUScore(tokenize="13a", **CPU)
    m.update(["The cat, is on the mat!"], [["The cat is on the mat."]])
    assert 0 < float(m.compute()) < 1


@pytest.mark.parametrize("tokenize", ["13a", "zh", "intl", "char"])
def test_tokenizers_equal_the_sacrebleu_package(tokenize):
    from sacrebleu.tokenizers.tokenizer_13a import Tokenizer13a
    from sacrebleu.tokenizers.tokenizer_char import TokenizerChar
    from sacrebleu.tokenizers.tokenizer_intl import TokenizerV14International
    from sacrebleu.tokenizers.tokenizer_zh import TokenizerZh

    from metrics_tpu_torch.functional.text.bleu import _get_tokenizer

    theirs = {"13a": Tokenizer13a, "zh": TokenizerZh, "intl": TokenizerV14International, "char": TokenizerChar}
    ours = _get_tokenizer(tokenize)
    preds, target = _multi_ref(60, punct=True)
    for line in preds + ["我爱北京天安门, ok. 東京", "Ünïcödé—dash «q» 12-3", "Hello-world 3.14 (x) $5 'quote' 1,000"]:
        assert ours(line) == theirs[tokenize]()(line).split()


def test_chrf_identical_is_one():
    m = tt.CHRFScore(**CPU)
    m.update(["the cat is here"], [["the cat is here"]])
    np.testing.assert_allclose(float(m.compute()), 1.0, atol=1e-6)


def test_rouge_known_value():
    m = tt.ROUGEScore(rouge_keys=("rouge1", "rouge2", "rougeL"), **CPU)
    m.update("My name is John", "Is your name John")
    res = m.compute()
    np.testing.assert_allclose(float(res["rouge1_fmeasure"]), 0.75, atol=1e-4)
    np.testing.assert_allclose(float(res["rouge2_fmeasure"]), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(res["rougeL_fmeasure"]), 0.5, atol=1e-4)


def test_perplexity_uniform_is_vocab_size():
    vocab = 7
    target = torch.from_numpy(np.random.RandomState(0).randint(vocab, size=(2, 10)))
    m = tt.Perplexity(**CPU)
    m.update(torch.zeros((2, 10, vocab)), target)
    np.testing.assert_allclose(float(m.compute()), vocab, rtol=1e-5)


def test_perplexity_ignore_index():
    vocab = 5
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 6, vocab).astype(np.float32)
    target = np.asarray([[0, 1, 2, -100, 3, 4], [1, 1, -100, 2, 2, 0]])
    m = tt.Perplexity(ignore_index=-100, **CPU)
    m.update(torch.from_numpy(logits), torch.from_numpy(target))
    lp = logits - np.log(np.exp(logits.astype(np.float64)).sum(-1, keepdims=True))
    tot, cnt = 0.0, 0
    for b in range(2):
        for t in range(6):
            if target[b, t] != -100:
                tot -= lp[b, t, target[b, t]]
                cnt += 1
    np.testing.assert_allclose(float(m.compute()), np.exp(tot / cnt), rtol=1e-5)


def test_ter_identical_zero_and_known():
    m = tt.TranslationEditRate(**CPU)
    m.update(["the cat is on the mat"], [["the cat is on the mat"]])
    np.testing.assert_allclose(float(m.compute()), 0.0)
    m2 = tt.TranslationEditRate(**CPU)
    m2.update(["the cat is on the mat"], [["there is a cat on the mat", "a cat is on the mat"]])
    np.testing.assert_allclose(float(m2.compute()), 1 / 6.5, atol=1e-4)


def test_ter_shift_beats_pure_edit():
    m = tt.TranslationEditRate(lowercase=False, **CPU)
    m.update(["b a"], [["a b"]])
    np.testing.assert_allclose(float(m.compute()), 0.5)


def test_eed_reasonable_range():
    m = tt.ExtendedEditDistance(**CPU)
    m.update(PREDS, TARGET)
    assert 0.0 < float(m.compute()) < 1.0
    m2 = tt.ExtendedEditDistance(**CPU)
    m2.update(["same text"], ["same text"])
    assert 0.0 < float(m2.compute()) < 0.05


def test_squad():
    preds = [{"prediction_text": "1976", "id": "id1"}, {"prediction_text": "the alps", "id": "id2"}]
    target = [
        {"answers": {"answer_start": [97], "text": ["1976"]}, "id": "id1"},
        {"answers": {"answer_start": [1], "text": ["The Alps mountains"]}, "id": "id2"},
    ]
    m = tt.SQuAD(**CPU)
    m.update(preds, target)
    res = m.compute()
    np.testing.assert_allclose(float(res["exact_match"]), 50.0)
    assert 50.0 < float(res["f1"]) <= 100.0


def test_wer_accumulation_across_updates():
    m = tt.WordErrorRate(**CPU)
    for p, t in zip(PREDS, TARGET):
        m.update([p], [t])
    np.testing.assert_allclose(float(m.compute()), 0.5)
