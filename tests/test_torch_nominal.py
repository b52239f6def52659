"""The port's nominal-association metrics against the JAX package's, on the same seeded numpy inputs.

The contingency matrices are equal, so each statistic is the same float32 arithmetic on the same table with
its sums taken in another order: within ``NOMINAL_RTOL``, and ``NOMINAL_ATOL`` besides, since Theil's U (a
difference of two entropies of order 1) and the bias-corrected phi^2 cancel near independence, where an ulp
of float32 at 1 is a large share of the result. The ``*_matrix`` functions count every column pair
in one pass and must give, entry by entry, the value of the scalar function on that pair (equal), and the JAX
package's within ``NOMINAL_RTOL``. ``FleissKappa(mode="probs")`` over several updates is held against the
single stream, which the JAX package does not give (it concatenates along the categories).
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.nominal as jfn
import metrics_tpu.nominal as jn
import metrics_tpu_torch.functional.nominal as tfn
import metrics_tpu_torch.nominal as tn
from metrics_tpu_torch import MetricCollection
from metrics_tpu_torch.interop import load_reference_state

NOMINAL_RTOL = 1e-6
NOMINAL_ATOL = 1e-6
X64_RTOL = 1e-12

PAIR_FNS = ["cramers_v", "tschuprows_t", "pearsons_contingency_coefficient", "theils_u"]
MATRIX_FNS = ["cramers_v_matrix", "tschuprows_t_matrix", "pearsons_contingency_coefficient_matrix",
              "theils_u_matrix"]
BIASED = {"cramers_v", "tschuprows_t", "cramers_v_matrix", "tschuprows_t_matrix"}
STRATEGIES = [("replace", 0.0), ("replace", 3.0), ("drop", None)]
STRATEGY_IDS = ["replace0", "replace3", "drop"]


def _pair(seed, n=300, k_preds=5, k_target=4, nan_share=0.05):
    """Two dependent categorical float variables with NaNs in each; the codes are not contiguous."""
    rng = np.random.RandomState(seed)
    target = rng.randint(0, k_target, n).astype(np.float64)
    preds = np.where(rng.rand(n) < 0.5, target % k_preds, rng.randint(0, k_preds, n)).astype(np.float64) * 2
    preds[rng.rand(n) < nan_share] = np.nan
    target[rng.rand(n) < nan_share] = np.nan
    return preds, target


def _matrix(seed, n=400, cards=(3, 5, 2, 7, 4), nan_share=0.03):
    """Columns of the given cardinalities, each tied in part to the first, with NaNs; one value of the last
    column appears only in rows whose other columns are NaN, so that dropping removes it for those pairs."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 50, n)
    cols = [np.where(rng.rand(n) < 0.6, base % c, rng.randint(0, c, n)).astype(np.float64) for c in cards]
    m = np.stack(cols, axis=1)
    m[rng.rand(*m.shape) < nan_share] = np.nan
    m[:2, :-1] = np.nan
    m[:2, -1] = 99.0
    return m


def _close(port, ref, rtol=NOMINAL_RTOL, atol=NOMINAL_ATOL):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (port.dtype, ref.dtype)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def _kwargs(name, strategy, value, bias=True):
    kwargs = {"nan_strategy": strategy, "nan_replace_value": value}
    if name in BIASED:
        kwargs["bias_correction"] = bias
    return kwargs


@pytest.mark.parametrize(("strategy", "value"), STRATEGIES, ids=STRATEGY_IDS)
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", PAIR_FNS)
def test_pair_function_matches_reference(name, seed, strategy, value):
    p, t = _pair(seed)
    kwargs = _kwargs(name, strategy, value)
    got = getattr(tfn, name)(torch.from_numpy(p), torch.from_numpy(t), **kwargs)
    want = getattr(jfn, name)(jnp.asarray(p), jnp.asarray(t), **kwargs)
    _close(got, want)


@pytest.mark.parametrize("name", ["cramers_v", "tschuprows_t"])
def test_without_bias_correction_matches_reference(name):
    p, t = _pair(2)
    got = getattr(tfn, name)(torch.from_numpy(p), torch.from_numpy(t), bias_correction=False)
    want = getattr(jfn, name)(jnp.asarray(p), jnp.asarray(t), bias_correction=False)
    _close(got, want)


def test_integer_inputs_match_reference():
    rng = np.random.RandomState(3)
    p, t = rng.randint(0, 4, 100), rng.randint(0, 3, 100)
    for name in PAIR_FNS:
        _close(getattr(tfn, name)(torch.from_numpy(p), torch.from_numpy(t)),
               getattr(jfn, name)(jnp.asarray(p), jnp.asarray(t)))


def test_cramers_v_bias_correction_with_a_zero_denominator_warns_and_is_nan_in_both():
    """Two categories against one: the corrected denominator is 0."""
    p = np.array([0, 1, 0, 1, 1, 0, 1, 0], dtype=np.float64)
    t = np.zeros(8)
    with pytest.warns(UserWarning, match="bias correction"):
        want = jfn.cramers_v(jnp.asarray(p), jnp.asarray(t))
    with pytest.warns(UserWarning, match="bias correction"):
        got = tfn.cramers_v(torch.from_numpy(p), torch.from_numpy(t))
    assert bool(torch.isnan(got)) and bool(jnp.isnan(want)) and got.dtype == torch.float32


@pytest.mark.parametrize(("strategy", "value"), STRATEGIES, ids=STRATEGY_IDS)
@pytest.mark.parametrize("name", MATRIX_FNS)
def test_matrix_function_matches_reference(name, strategy, value):
    m = _matrix(4)
    kwargs = _kwargs(name, strategy, value)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = getattr(tfn, name)(torch.from_numpy(m), **kwargs)
        want = getattr(jfn, name)(jnp.asarray(m), **kwargs)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize(("strategy", "value"), STRATEGIES, ids=STRATEGY_IDS)
@pytest.mark.parametrize("name", MATRIX_FNS)
def test_matrix_entries_equal_the_pair_function(name, strategy, value):
    """Counting every column pair in one pass changes no value: each entry is the scalar function's on its
    pair (``theils_u_matrix[i, j]`` is U(column i | column j))."""
    m = torch.from_numpy(_matrix(5))
    kwargs = _kwargs(name, strategy, value)
    scalar = getattr(tfn, name[: -len("_matrix")])
    got = getattr(tfn, name)(m, **kwargs)
    for i in range(m.shape[1]):
        assert float(got[i, i]) == 1.0
        for j in range(m.shape[1]):
            if i == j or (name != "theils_u_matrix" and j < i):
                continue
            want = scalar(m[:, i], m[:, j], **kwargs).to(torch.float32)
            assert torch.equal(got[i, j], want), (i, j)
            if name != "theils_u_matrix":
                assert torch.equal(got[j, i], want), (j, i)


def test_theils_u_matrix_is_asymmetric_as_reference():
    m = _matrix(6, nan_share=0.0)
    got = tfn.theils_u_matrix(torch.from_numpy(m))
    assert not torch.equal(got, got.T)
    _close(got, jfn.theils_u_matrix(jnp.asarray(m)))


@pytest.mark.parametrize("name", PAIR_FNS + MATRIX_FNS)
def test_float64_regime_matches_reference(name):
    p, t = _pair(7)
    m = _matrix(7)
    args_np = (m,) if name in MATRIX_FNS else (p, t)
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        got = getattr(tfn, name)(*(torch.from_numpy(a) for a in args_np))
    finally:
        torch.set_default_dtype(previous)
    with jax.enable_x64(True):
        want = np.asarray(getattr(jfn, name)(*(jnp.asarray(a) for a in args_np)))
    # the matrices are float32 in both packages whatever the regime
    assert want.dtype == (np.float32 if name in MATRIX_FNS else np.float64)
    if name in MATRIX_FNS:
        _close(got, want)
    else:
        _close(got, want, X64_RTOL, 0.0)


def _ratings_counts(seed, n=40, cats=5, raters=7):
    rng = np.random.RandomState(seed)
    votes = rng.randint(0, cats, (n, raters))
    votes[: n // 2] = votes[: n // 2, :1]  # half the subjects agreed on
    return np.stack([(votes == c).sum(1) for c in range(cats)], axis=1)


def _ratings_probs(seed, n=30, cats=4, raters=6):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, cats, raters) + 2.0 * (np.arange(cats)[None, :, None] == (np.arange(n) % cats)[:, None, None])
    return (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["counts", "probs"])
def test_fleiss_kappa_matches_reference(mode, seed):
    r = _ratings_counts(seed) if mode == "counts" else _ratings_probs(seed)
    _close(tfn.fleiss_kappa(torch.from_numpy(r), mode), jfn.fleiss_kappa(jnp.asarray(r), mode))


def test_fleiss_kappa_bad_inputs_raise_as_in_reference():
    for fn, arr in ((tfn.fleiss_kappa, torch.from_numpy), (jfn.fleiss_kappa, jnp.asarray)):
        with pytest.raises(ValueError, match="probs"):
            fn(arr(np.ones((3, 4))), "probs")
        with pytest.raises(ValueError, match="counts"):
            fn(arr(np.ones((3, 4, 2))), "counts")
        with pytest.raises(ValueError, match="mode"):
            fn(arr(np.ones((3, 4))), "votes")


def test_fleiss_kappa_probs_class_one_update_matches_reference():
    r = _ratings_probs(3)
    port, ref = tn.FleissKappa(mode="probs", device="cpu"), jn.FleissKappa(mode="probs")
    port.update(torch.from_numpy(r))
    ref.update(jnp.asarray(r))
    _close(port.compute(), ref.compute())


def test_fleiss_kappa_probs_class_several_updates_equal_the_single_stream():
    """The port concatenates probability updates along the samples: three updates give one update's value.
    The JAX package concatenates them along the categories and gives another value (ROADMAP, known
    differences)."""
    r = _ratings_probs(4, n=36)
    chunks = [r[:12], r[12:24], r[24:]]
    port = tn.FleissKappa(mode="probs", device="cpu")
    ref = jn.FleissKappa(mode="probs")
    for c in chunks:
        port.update(torch.from_numpy(c))
        ref.update(jnp.asarray(c))
    single = tfn.fleiss_kappa(torch.from_numpy(r), "probs")
    assert torch.equal(port.compute(), single)
    _close(single, jfn.fleiss_kappa(jnp.asarray(r), "probs"))
    assert abs(float(ref.compute()) - float(single)) > 1e-3


def test_fleiss_kappa_counts_class_several_updates_match_reference():
    r = _ratings_counts(5, n=60)
    port, ref = tn.FleissKappa(device="cpu"), jn.FleissKappa()
    for c in (r[:20], r[20:45], r[45:]):
        port.update(torch.from_numpy(c))
        ref.update(jnp.asarray(c))
    _close(port.compute(), ref.compute())


CLASSES = [("CramersV", {"num_classes": 5}), ("CramersV", {"num_classes": 5, "bias_correction": False}),
           ("TschuprowsT", {"num_classes": 5}), ("PearsonsContingencyCoefficient", {"num_classes": 5}),
           ("TheilsU", {"num_classes": 5}), ("CramersV", {"num_classes": 5, "nan_strategy": "drop"}),
           ("TheilsU", {"num_classes": 5, "nan_strategy": "drop"}),
           ("TschuprowsT", {"num_classes": 5, "nan_strategy": "replace", "nan_replace_value": 1.0})]
CLASS_IDS = [f"{n}{kw}" for n, kw in CLASSES]


@pytest.mark.parametrize(("name", "kwargs"), CLASSES, ids=CLASS_IDS)
def test_class_matches_reference(name, kwargs):
    p, t = _pair(8, n=360)
    port, ref = getattr(tn, name)(device="cpu", **kwargs), getattr(jn, name)(**kwargs)
    for i in range(3):
        port.update(torch.from_numpy(p[i::3].reshape(-1, 4)), torch.from_numpy(t[i::3].reshape(-1, 4)))
        ref.update(jnp.asarray(p[i::3].reshape(-1, 4)), jnp.asarray(t[i::3].reshape(-1, 4)))
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize("name", ["CramersV", "TschuprowsT", "PearsonsContingencyCoefficient", "TheilsU",
                                  "FleissKappa"])
def test_class_defaults_to_cuda_and_raises_without_one(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(tn, name)(**({} if name == "FleissKappa" else {"num_classes": 3}))


def test_bad_class_arguments_raise_as_in_reference():
    for mod, kw in ((tn, {"device": "cpu"}), (jn, {})):
        with pytest.raises(ValueError, match="nan_strategy"):
            mod.CramersV(num_classes=3, nan_strategy="keep", **kw)
        with pytest.raises(ValueError, match="nan_replace_value"):
            mod.TheilsU(num_classes=3, nan_replace_value=None, **kw)
        with pytest.raises(ValueError, match="num_classes"):
            mod.PearsonsContingencyCoefficient(num_classes=0, **kw)
        with pytest.raises(ValueError, match="mode"):
            mod.FleissKappa(mode="votes", **kw)


@pytest.mark.parametrize("name", ["CramersV", "TheilsU"])
def test_state_carried_from_reference_continues_as_reference(name):
    p, t = _pair(9, n=200)
    port, ref = getattr(tn, name)(num_classes=5, device="cpu"), getattr(jn, name)(num_classes=5)
    ref.update(jnp.asarray(p[:100]), jnp.asarray(t[:100]))
    ref.persistent(True)
    load_reference_state(port, ref.state_dict())
    port.update(torch.from_numpy(p[100:]), torch.from_numpy(t[100:]))
    ref.update(jnp.asarray(p[100:]), jnp.asarray(t[100:]))
    _close(port.compute(), ref.compute())


def test_fleiss_kappa_state_carried_from_reference():
    r = _ratings_counts(10, n=50)
    port, ref = tn.FleissKappa(device="cpu"), jn.FleissKappa()
    ref.update(jnp.asarray(r[:30]))
    ref.persistent(True)
    load_reference_state(port, ref.state_dict())
    port.update(torch.from_numpy(r[30:]))
    ref.update(jnp.asarray(r[30:]))
    _close(port.compute(), ref.compute())


def test_merge_state_and_a_collection_equal_the_single_stream():
    """The nominal metrics keep ``full_state_update=False``: two metrics' list states merge into the single
    stream's table (equal values: a table does not depend on the order of its samples), and a collection of
    the four equals each alone."""
    p, t = _pair(11, n=240)
    names = ["CramersV", "TschuprowsT", "PearsonsContingencyCoefficient", "TheilsU"]
    coll = MetricCollection({n: getattr(tn, n)(num_classes=5, device="cpu") for n in names})
    coll.update(torch.from_numpy(p), torch.from_numpy(t))
    got = coll.compute()
    for n in names:
        a, b, single = (getattr(tn, n)(num_classes=5, device="cpu") for _ in range(3))
        a.update(torch.from_numpy(p[:100]), torch.from_numpy(t[:100]))
        b.update(torch.from_numpy(p[100:]), torch.from_numpy(t[100:]))
        a.merge_state(b)
        single.update(torch.from_numpy(p), torch.from_numpy(t))
        assert torch.equal(a.compute(), single.compute())
        assert torch.equal(got[n], single.compute())
        want = getattr(jn, n)(num_classes=5)
        want.update(jnp.asarray(p), jnp.asarray(t))
        _close(got[n], want.compute())
