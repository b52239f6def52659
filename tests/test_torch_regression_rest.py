"""The port's other sixteen regression metrics against the JAX package's.

MSLE, MAPE, SMAPE, WMAPE, log-cosh, Minkowski, Tweedie deviance, CSI, NRMSE,
concordance, Kendall, R², relative squared error, explained variance, cosine
similarity and KL divergence: the same seeded numpy inputs go through both
packages, functional and class, with every option (``multioutput``,
``adjusted``, the normalisations, the Tweedie powers, the Kendall variants and
tests, ``keep_sequence_dim``). Float32 values agree within rtol 1e-5, atol
1e-6; CSI counts and Kendall (at n <= 4096, where the JAX package's float32
pair counts are exact) are equal. The moment states (explained variance,
NRMSE, concordance) and R²'s sums are also held in the float64 regime, through
a sync over the same fake ``dist_sync_fn`` and through
``allreduce_over_mesh``; every class's state is carried over by ``interop``.
"""

from __future__ import annotations

import contextlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.regression as jf
import metrics_tpu.parallel.sync as jsync
import metrics_tpu.regression as jr
import metrics_tpu.utils.compute as jcompute
import metrics_tpu_torch.functional.regression as tf
import metrics_tpu_torch.functional.regression.kendall as tkendall
import metrics_tpu_torch.parallel as tsync
import metrics_tpu_torch.regression as tr
import metrics_tpu_torch.utils.compute as tcompute
from metrics_tpu.utils.exceptions import TPUMetricsUserError as JaxUserError
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError

RTOL, ATOL = 1e-5, 1e-6
N = 120


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _close(port, ref, exact=False):
    if isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref)
        for p, r in zip(port, ref):
            _close(p, r, exact)
        return
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    if exact or ref.dtype.kind in "biu":
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=RTOL, atol=ATOL)


def _inputs(seed, kind="normal", outputs=1, n=N):
    """(preds, target) as float32 numpy arrays: ``normal`` around 0, ``positive`` log-normal, ``probs`` rows of a
    softmax, ``ties`` rounded to one decimal."""
    rng = np.random.RandomState(seed)
    shape = (n,) if outputs == 1 else (n, outputs)
    if kind == "positive":
        t = np.exp(0.5 * rng.randn(*shape))
        p = t * np.exp(0.2 * rng.randn(*shape))
    elif kind == "probs":
        p = np.exp(rng.randn(n, 7))
        t = np.exp(rng.randn(n, 7))
        p, t = p / p.sum(1, keepdims=True), t / t.sum(1, keepdims=True)
    else:
        t = rng.randn(*shape)
        p = 0.8 * t + 0.4 * rng.randn(*shape)
        if kind == "ties":
            p, t = np.round(p, 1), np.round(t, 1)
    return p.astype(np.float32), t.astype(np.float32)


def _both(fn_name, preds, target, **kwargs):
    port = getattr(tf, fn_name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    ref = getattr(jf, fn_name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    return port, ref


# ----------------------------------------------------------------------------- utils/compute
def test_safe_helpers_match_reference():
    x = np.array([0.0, 0.0, 2.0, 3.0, 0.5], dtype=np.float32)
    y = np.array([0.0, np.nan, 1.5, 0.0, 4.0], dtype=np.float32)
    _close(tcompute._safe_xlogy(torch.from_numpy(x), torch.from_numpy(y)),
           jcompute._safe_xlogy(jnp.asarray(x), jnp.asarray(y)))
    _close(tcompute._safe_log(torch.from_numpy(x)), jcompute._safe_log(jnp.asarray(x)))
    assert torch.isfinite(tcompute._safe_log(torch.zeros(2))).all()
    a, b = np.random.RandomState(0).randn(2, 4, 3).astype(np.float32)
    _close(tcompute._safe_matmul(torch.from_numpy(a), torch.from_numpy(b)),
           jcompute._safe_matmul(jnp.asarray(a), jnp.asarray(b)))


# ----------------------------------------------------------------------------- functional
FUNCTIONAL = [
    ("mean_squared_log_error", "positive", 1, {}),
    ("mean_absolute_percentage_error", "normal", 1, {}),
    ("symmetric_mean_absolute_percentage_error", "normal", 1, {}),
    ("weighted_mean_absolute_percentage_error", "normal", 1, {}),
    ("log_cosh_error", "normal", 1, {}),
    ("log_cosh_error", "normal", 3, {}),
    ("minkowski_distance", "normal", 1, {"p": 1}),
    ("minkowski_distance", "normal", 1, {"p": 2.5}),
    ("minkowski_distance", "normal", 1, {"p": 3}),
    ("tweedie_deviance_score", "positive", 1, {"power": -0.5}),
    ("tweedie_deviance_score", "normal", 1, {"power": 0.0}),
    ("tweedie_deviance_score", "positive", 1, {"power": 1}),
    ("tweedie_deviance_score", "positive", 1, {"power": 1.5}),
    ("tweedie_deviance_score", "positive", 1, {"power": 2}),
    ("tweedie_deviance_score", "positive", 1, {"power": 3}),
    ("r2_score", "normal", 1, {}),
    ("r2_score", "normal", 1, {"adjusted": 3}),
    ("r2_score", "normal", 3, {"multioutput": "raw_values"}),
    ("r2_score", "normal", 3, {"multioutput": "uniform_average"}),
    ("r2_score", "normal", 3, {"multioutput": "variance_weighted", "adjusted": 2}),
    ("relative_squared_error", "normal", 1, {}),
    ("relative_squared_error", "normal", 3, {"squared": False}),
    ("normalized_root_mean_squared_error", "positive", 1, {"normalization": "mean"}),
    ("normalized_root_mean_squared_error", "normal", 1, {"normalization": "range"}),
    ("normalized_root_mean_squared_error", "normal", 3, {"normalization": "std", "num_outputs": 3}),
    ("normalized_root_mean_squared_error", "normal", 3, {"normalization": "l2", "num_outputs": 3}),
    ("explained_variance", "normal", 1, {}),
    ("explained_variance", "normal", 3, {"multioutput": "raw_values"}),
    ("explained_variance", "normal", 3, {"multioutput": "variance_weighted"}),
    ("concordance_corrcoef", "normal", 1, {}),
    ("concordance_corrcoef", "normal", 3, {}),
    ("cosine_similarity", "normal", 4, {"reduction": "sum"}),
    ("cosine_similarity", "normal", 4, {"reduction": "mean"}),
    ("cosine_similarity", "normal", 4, {"reduction": "none"}),
    ("kl_divergence", "probs", 1, {}),
    ("kl_divergence", "probs", 1, {"reduction": "sum"}),
    ("kl_divergence", "probs", 1, {"reduction": "none"}),
]


@pytest.mark.parametrize(("fn", "kind", "outputs", "kwargs"), FUNCTIONAL,
                         ids=[f"{c[0]}-{c[2]}-{c[3]}" for c in FUNCTIONAL])
def test_functional_matches_reference(fn, kind, outputs, kwargs):
    p, t = _inputs(1, kind, outputs)
    port, ref = _both(fn, p, t, **kwargs)
    assert port.dtype == torch.float32
    _close(port, ref)


def test_kl_divergence_of_log_probabilities_matches_reference():
    p, t = _inputs(2, "probs")
    p, t = np.log(p), np.log(t)
    for reduction in ("mean", "none"):
        port, ref = _both("kl_divergence", p, t, log_prob=True, reduction=reduction)
        _close(port, ref)


@pytest.mark.parametrize("threshold", [0.0, 0.7])
@pytest.mark.parametrize("keep", [None, 0, 1, 2])
def test_critical_success_index_matches_reference(threshold, keep):
    rng = np.random.RandomState(3)
    t = rng.randn(4, 5, 6).astype(np.float32)
    p = (t + 0.5 * rng.randn(4, 5, 6)).astype(np.float32)
    port, ref = _both("critical_success_index", p, t, threshold=threshold, keep_sequence_dim=keep)
    _close(port, ref)
    port_counts = tf.csi._critical_success_index_update(torch.from_numpy(p), torch.from_numpy(t), threshold, keep)
    ref_counts = jf.csi._critical_success_index_update(jnp.asarray(p), jnp.asarray(t), threshold, keep)
    for a, b in zip(port_counts, ref_counts):
        assert a.dtype == torch.int64
        _close(a, b, exact=True)


@pytest.mark.parametrize("variant", ["a", "b", "c"])
@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("outputs", [1, 2])
def test_kendall_matches_reference_exactly(variant, kind, outputs):
    p, t = _inputs(4, kind, outputs, n=300)
    port, ref = _both("kendall_rank_corrcoef", p, t, variant=variant)
    _close(port, ref, exact=True)


@pytest.mark.parametrize("alternative", ["two-sided", "less", "greater"])
def test_kendall_t_test_matches_reference_exactly(alternative):
    p, t = _inputs(5, "ties", n=200)
    port, ref = _both("kendall_rank_corrcoef", p, t, variant="b", t_test=True, alternative=alternative)
    assert isinstance(port, tuple) and len(port) == 2
    _close(port, ref, exact=True)


@pytest.mark.parametrize("n", [1, 2, 2047, 2049, 4096])
def test_kendall_counts_over_several_blocks_match_reference(monkeypatch, n):
    """Blocks of 2048 rows (the CPU's) and of 7 rows: the pairs each block sees, above its square's diagonal
    and right of it, cover every pair once; at n <= 4096 the JAX package's float32 counts are exact too."""
    p, t = _inputs(6, "ties", n=n)
    want = jf.kendall_rank_corrcoef(jnp.asarray(p), jnp.asarray(t), variant="b")
    _close(tf.kendall_rank_corrcoef(torch.from_numpy(p), torch.from_numpy(t), variant="b"), want, exact=True)
    if n <= 2049:
        monkeypatch.setattr(tkendall, "_CPU_PAIR_BLOCK", 7)
        _close(tf.kendall_rank_corrcoef(torch.from_numpy(p), torch.from_numpy(t), variant="b"), want, exact=True)


def test_kendall_pair_counts_are_exact_integers():
    x = torch.tensor([1.0, 2.0, 2.0, 3.0, 0.0])
    y = torch.tensor([1.0, 1.0, 3.0, 2.0, 0.0])
    con_min_dis, con_plus_dis, tx, ty = tkendall._pair_counts(x, y, "a")
    # by hand: 10 pairs; ties in x: (1,2); ties in y: (0,1); concordant 7, discordant 1, untied 8
    assert [int(v) for v in (con_min_dis, con_plus_dis, tx, ty)] == [6, 8, 1, 1]
    assert all(v.dtype == torch.int64 for v in (con_min_dis, con_plus_dis, tx, ty))


# ----------------------------------------------------------------------------- classes
# (name, constructor kwargs, input kind, outputs)
CLASSES = [
    ("MeanSquaredLogError", {}, "positive", 1),
    ("MeanAbsolutePercentageError", {}, "normal", 1),
    ("SymmetricMeanAbsolutePercentageError", {}, "normal", 1),
    ("WeightedMeanAbsolutePercentageError", {}, "normal", 1),
    ("LogCoshError", {}, "normal", 1),
    ("LogCoshError", {"num_outputs": 3}, "normal", 3),
    ("MinkowskiDistance", {"p": 3}, "normal", 1),
    ("TweedieDevianceScore", {"power": 0.0}, "normal", 1),
    ("TweedieDevianceScore", {"power": 1.5}, "positive", 1),
    ("TweedieDevianceScore", {"power": 2}, "positive", 1),
    ("NormalizedRootMeanSquaredError", {"normalization": "mean"}, "positive", 1),
    ("NormalizedRootMeanSquaredError", {"normalization": "range"}, "normal", 1),
    ("NormalizedRootMeanSquaredError", {"normalization": "std", "num_outputs": 3}, "normal", 3),
    ("NormalizedRootMeanSquaredError", {"normalization": "l2", "num_outputs": 3}, "normal", 3),
    ("ConcordanceCorrCoef", {}, "normal", 1),
    ("ConcordanceCorrCoef", {"num_outputs": 3}, "normal", 3),
    ("KendallRankCorrCoef", {"variant": "a"}, "ties", 1),
    ("KendallRankCorrCoef", {"variant": "c", "num_outputs": 2}, "ties", 2),
    ("KendallRankCorrCoef", {"variant": "b", "t_test": True, "alternative": "greater"}, "ties", 1),
    ("R2Score", {}, "normal", 1),
    ("R2Score", {"adjusted": 2}, "normal", 1),
    ("R2Score", {"num_outputs": 3, "multioutput": "raw_values"}, "normal", 3),
    ("R2Score", {"num_outputs": 3, "multioutput": "variance_weighted"}, "normal", 3),
    ("RelativeSquaredError", {}, "normal", 1),
    ("RelativeSquaredError", {"num_outputs": 3, "squared": False}, "normal", 3),
    ("ExplainedVariance", {}, "normal", 1),
    ("ExplainedVariance", {"multioutput": "raw_values"}, "normal", 3),
    ("ExplainedVariance", {"multioutput": "variance_weighted"}, "normal", 3),
    ("CosineSimilarity", {"reduction": "sum"}, "normal", 4),
    ("CosineSimilarity", {"reduction": "mean"}, "normal", 4),
    ("CosineSimilarity", {"reduction": "none"}, "normal", 4),
    ("KLDivergence", {}, "probs", 1),
    ("KLDivergence", {"reduction": "sum"}, "probs", 1),
    ("KLDivergence", {"reduction": "none"}, "probs", 1),
    ("KLDivergence", {"log_prob": True}, "logprobs", 1),
]
CLASS_IDS = [f"{c[0]}-{c[1]}" for c in CLASSES]


def _batches(kind, outputs, seed=10, n_batches=3):
    out = []
    for i in range(n_batches):
        if kind == "logprobs":
            p, t = _inputs(seed + i, "probs", outputs, n=40)
            out.append((np.log(p), np.log(t)))
        else:
            out.append(_inputs(seed + i, kind, outputs, n=40))
    return out


def _pair(name, kwargs):
    return getattr(tr, name)(device="cpu", **kwargs), getattr(jr, name)(**kwargs)


def _close_states(port, ref):
    for key, value in ref.metric_state.items():
        mine = port.metric_state[key]
        if isinstance(value, list):
            assert isinstance(mine, list) and len(mine) == len(value)
            mine, value = torch.cat([m.reshape(-1) for m in mine]), np.concatenate([np.ravel(v) for v in value])
        if np.asarray(value).dtype.kind in "iu":
            assert not mine.is_floating_point()
        _close(mine, value)


@pytest.mark.parametrize(("name", "kwargs", "kind", "outputs"), CLASSES, ids=CLASS_IDS)
def test_class_matches_reference(name, kwargs, kind, outputs):
    port, ref = _pair(name, kwargs)
    for p, t in _batches(kind, outputs):
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    _close_states(port, ref)
    _close(port.compute(), ref.compute(), exact=name == "KendallRankCorrCoef")


@pytest.mark.parametrize(("name", "kwargs", "kind", "outputs"), [c for c in CLASSES if c[0] != "ExplainedVariance"
                                                                  or c[3] == 1],
                         ids=[i for c, i in zip(CLASSES, CLASS_IDS) if c[0] != "ExplainedVariance" or c[3] == 1])
def test_forward_matches_reference(name, kwargs, kind, outputs):
    port, ref = _pair(name, kwargs)
    for p, t in _batches(kind, outputs, seed=20):
        _close(port(torch.from_numpy(p), torch.from_numpy(t)), ref(jnp.asarray(p), jnp.asarray(t)),
               exact=name == "KendallRankCorrCoef")
    _close(port.compute(), ref.compute(), exact=name == "KendallRankCorrCoef")


@pytest.mark.parametrize("keep", [0, 1, 2])
def test_csi_cat_states_match_reference(keep):
    port, ref = _pair("CriticalSuccessIndex", {"threshold": 0.3, "keep_sequence_dim": keep})
    rng = np.random.RandomState(11)
    for _ in range(3):
        t = rng.randn(3, 4, 5).astype(np.float32)
        p = (t + 0.6 * rng.randn(3, 4, 5)).astype(np.float32)
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    for key in ("hits", "misses", "false_alarms"):
        assert len(port.metric_state[key]) == 3
        for a, b in zip(port.metric_state[key], ref.metric_state[key]):
            assert a.dtype == torch.int64
            _close(a, b, exact=True)
    _close(port.compute(), ref.compute())


def test_csi_summed_counts_match_reference():
    port, ref = _pair("CriticalSuccessIndex", {"threshold": 0.5})
    rng = np.random.RandomState(12)
    for _ in range(3):
        t = rng.randn(2, 6, 6).astype(np.float32)
        p = (t + 0.6 * rng.randn(2, 6, 6)).astype(np.float32)
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    for key in ("hits", "misses", "false_alarms"):
        assert port.metric_state[key].dtype == torch.int64
        _close(port.metric_state[key], ref.metric_state[key], exact=True)
    _close(port.compute(), ref.compute())


def test_explained_variance_of_several_outputs_forward_and_merge_equal_the_single_stream():
    """The JAX package's generic merge reads one moment set of several outputs as a stack of per-rank sets (its
    forward on (N, K) inputs returns a wrong value); the port stacks by the count, so forward, merge and an update
    after them equal the single stream."""
    batches = _batches("normal", 3, seed=30, n_batches=4)
    whole = tr.ExplainedVariance(multioutput="raw_values", device="cpu")
    stepped = tr.ExplainedVariance(multioutput="raw_values", device="cpu")
    for p, t in batches:
        whole.update(torch.from_numpy(p), torch.from_numpy(t))
    for p, t in batches[:3]:
        batch_value = stepped(torch.from_numpy(p), torch.from_numpy(t))
        _close(batch_value, tf.explained_variance(torch.from_numpy(p), torch.from_numpy(t), "raw_values"))
    stepped.update(torch.from_numpy(batches[3][0]), torch.from_numpy(batches[3][1]))
    _close(stepped.compute(), whole.compute())
    left, right = (tr.ExplainedVariance(multioutput="raw_values", device="cpu") for _ in range(2))
    for metric, part in ((left, batches[:2]), (right, batches[2:])):
        for p, t in part:
            metric.update(torch.from_numpy(p), torch.from_numpy(t))
    left.merge_state(right)
    assert left.num_obs.shape == (2,) and left.mean_diff.shape == (2, 3)
    _close(left.compute(), whole.compute())


def test_nrmse_update_after_forward_equals_the_single_stream():
    batches = _batches("normal", 1, seed=31, n_batches=3)
    whole, stepped = (tr.NormalizedRootMeanSquaredError(normalization="std", device="cpu") for _ in range(2))
    for p, t in batches:
        whole.update(torch.from_numpy(p), torch.from_numpy(t))
    stepped(torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]))
    stepped(torch.from_numpy(batches[1][0]), torch.from_numpy(batches[1][1]))
    stepped.update(torch.from_numpy(batches[2][0]), torch.from_numpy(batches[2][1]))
    assert stepped.num_obs.ndim == 0
    _close(stepped.compute(), whole.compute())


# ----------------------------------------------------------------------------- float64 regime
@contextlib.contextmanager
def _float64_regime():
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_default_dtype(previous)


MOMENT_CLASSES = [
    ("ExplainedVariance", {}, 1),
    ("NormalizedRootMeanSquaredError", {"normalization": "std"}, 1),
    ("NormalizedRootMeanSquaredError", {"normalization": "l2", "num_outputs": 3}, 3),
    ("ConcordanceCorrCoef", {}, 1),
    ("R2Score", {"num_outputs": 3, "multioutput": "raw_values"}, 3),
    ("RelativeSquaredError", {}, 1),
]
MOMENT_IDS = [f"{c[0]}-{c[1]}" for c in MOMENT_CLASSES]


@pytest.mark.parametrize(("name", "kwargs", "outputs"), MOMENT_CLASSES, ids=MOMENT_IDS)
def test_float64_regime_matches_reference(name, kwargs, outputs):
    with _float64_regime():
        port, ref = _pair(name, kwargs)
        for p, t in _batches("normal", outputs, seed=40):
            port.update(torch.from_numpy(p), torch.from_numpy(t))
            ref.update(jnp.asarray(p), jnp.asarray(t))
        for key, value in ref.metric_state.items():
            assert str(port.metric_state[key].dtype).replace("torch.", "") == str(value.dtype).replace(
                "int32", "int64"), key
        got, want = port.compute(), ref.compute()
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        _close(got, want)


# ----------------------------------------------------------------------------- sync and fan-in
SYNCED = [
    ("ExplainedVariance", {}, 1),
    ("NormalizedRootMeanSquaredError", {"normalization": "mean"}, 1),
    ("NormalizedRootMeanSquaredError", {"normalization": "std", "num_outputs": 3}, 3),
    ("ConcordanceCorrCoef", {}, 1),
    ("R2Score", {}, 1),
    ("R2Score", {"num_outputs": 3, "multioutput": "variance_weighted"}, 3),
]
SYNCED_IDS = [f"{c[0]}-{c[1]}" for c in SYNCED]


def _fed(factory, as_array, seeds_sizes, outputs):
    metric = factory()
    for seed, n in seeds_sizes:
        p, t = _inputs(seed, "positive" if outputs == 1 else "normal", outputs, n=n)
        metric.update(as_array(p), as_array(t))
    return metric


def _fake_sync(peers, as_array):
    """A dist_sync_fn handing back each state beside the peers' values of the same state, in rank order."""
    def sync_fn(states, group):
        return [[local] + [as_array(np.asarray(_np(list(peer.values())[i]))) for peer in peers]
                for i, local in enumerate(states)]
    return sync_fn


@pytest.mark.parametrize(("name", "kwargs", "outputs"), SYNCED, ids=SYNCED_IDS)
def test_sync_through_the_same_dist_sync_fn_matches_reference(name, kwargs, outputs):
    port_make = lambda: getattr(tr, name)(device="cpu", **kwargs)  # noqa: E731
    ref_make = lambda: getattr(jr, name)(**kwargs)  # noqa: E731
    port = _fed(port_make, torch.from_numpy, [(50, 30)], outputs)
    ref = _fed(ref_make, jnp.asarray, [(50, 30)], outputs)
    port_peers = [dict(_fed(port_make, torch.from_numpy, [(s, 20 + s)], outputs).metric_state) for s in (51, 52)]
    ref_peers = [dict(_fed(ref_make, jnp.asarray, [(s, 20 + s)], outputs).metric_state) for s in (51, 52)]
    local = dict(port.metric_state)
    port.sync(dist_sync_fn=_fake_sync(port_peers, torch.from_numpy), distributed_available=True)
    ref.sync(dist_sync_fn=_fake_sync(ref_peers, jnp.asarray), distributed_available=True)
    for key in ref.metric_state:
        _close(port.metric_state[key], ref.metric_state[key])
    _close(port._compute_impl(), ref._compute_impl())
    # the synced value is the single stream's
    whole = _fed(port_make, torch.from_numpy, [(50, 30), (51, 71), (52, 72)], outputs)
    _close(port._compute_impl(), whole.compute())
    port.unsync()
    for key, value in local.items():
        assert port.metric_state[key] is value


@pytest.mark.parametrize(("name", "kwargs", "outputs"), SYNCED, ids=SYNCED_IDS)
def test_allreduce_over_mesh_matches_reference(name, kwargs, outputs):
    sizes = [17, 4, 30, 9]
    port_states, ref_states = [], []
    for rank, n in enumerate(sizes):
        port_states.append(dict(_fed(lambda: getattr(tr, name)(device="cpu", **kwargs), torch.from_numpy,
                                     [(60 + rank, n)], outputs).metric_state))
        ref_states.append(dict(_fed(lambda: getattr(jr, name)(**kwargs), jnp.asarray,
                                    [(60 + rank, n)], outputs).metric_state))
    port, ref = _pair(name, kwargs)
    merged = tsync.allreduce_over_mesh(port_states, port._reductions)
    want = jsync.allreduce_over_mesh(ref_states, ref._reductions)
    assert sorted(merged) == sorted(want)
    for key in want:
        _close(merged[key], want[key])
    port.load_merged_state(merged, update_count=len(sizes))
    ref.load_merged_state(want, update_count=len(sizes))
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize(("name", "kwargs", "outputs"), SYNCED, ids=SYNCED_IDS)
def test_split_update_merge_equals_the_single_stream(name, kwargs, outputs):
    make = lambda: getattr(tr, name)(device="cpu", **kwargs)  # noqa: E731
    whole = _fed(make, torch.from_numpy, [(70, 25), (71, 13), (72, 40)], outputs)
    shards = [_fed(make, torch.from_numpy, [(70 + i, n)], outputs) for i, n in enumerate((25, 13, 40))]
    if name == "ConcordanceCorrCoef":  # full_state_update: folded through the mesh path, as Pearson is
        merged = tsync.allreduce_over_mesh([dict(s.metric_state) for s in shards], shards[0]._reductions)
        shards[0].load_merged_state(merged, update_count=3)
    else:
        for shard in shards[1:]:
            shards[0].merge_state(shard)
    _close(shards[0].compute(), whole.compute())


# ----------------------------------------------------------------------------- interop
@pytest.mark.parametrize(("name", "kwargs", "kind", "outputs"), CLASSES, ids=CLASS_IDS)
def test_reference_state_loads_into_the_port(name, kwargs, kind, outputs):
    port, ref = _pair(name, kwargs)
    batches = _batches(kind, outputs, seed=80)
    for p, t in batches[:2]:
        ref.update(jnp.asarray(p), jnp.asarray(t))
    ref.persistent(True)
    load_reference_state(port, ref.state_dict())
    p, t = batches[2]
    ref.update(jnp.asarray(p), jnp.asarray(t))
    port.update(torch.from_numpy(p), torch.from_numpy(t))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _close(port.compute(), ref.compute(), exact=name == "KendallRankCorrCoef")


@pytest.mark.parametrize("keep", [None, 1])
def test_csi_reference_state_loads_into_the_port(keep):
    port, ref = _pair("CriticalSuccessIndex", {"threshold": 0.2, "keep_sequence_dim": keep})
    rng = np.random.RandomState(81)
    batches = [(rng.randn(2, 3, 4).astype(np.float32), rng.randn(2, 3, 4).astype(np.float32)) for _ in range(3)]
    for p, t in batches[:2]:
        ref.update(jnp.asarray(p), jnp.asarray(t))
    ref.persistent(True)
    load_reference_state(port, ref.state_dict())
    ref.update(jnp.asarray(batches[2][0]), jnp.asarray(batches[2][1]))
    port.update(torch.from_numpy(batches[2][0]), torch.from_numpy(batches[2][1]))
    _close(port.compute(), ref.compute())


def test_stacked_moment_states_load_into_the_port():
    """A synced (stacked) moment state from the JAX package loads, and folds at compute."""
    ref_states = [dict(_fed(lambda: jr.ExplainedVariance(), jnp.asarray, [(90 + r, 20)], 1).metric_state)
                  for r in range(3)]
    ref = jr.ExplainedVariance().load_merged_state(jsync.allreduce_over_mesh(ref_states, jr.ExplainedVariance()
                                                                             ._reductions), update_count=3)
    ref.persistent(True)
    port = load_reference_state(tr.ExplainedVariance(device="cpu"), ref.state_dict())
    assert port.num_obs.shape == (3,)
    _close(port.compute(), ref.compute())


# ----------------------------------------------------------------------------- errors
def test_argument_errors_match_reference():
    p, t = _inputs(95)
    for package, err, kw in ((tr, TPUMetricsUserError, {"device": "cpu"}), (jr, JaxUserError, {})):
        with pytest.raises(err, match="``p``"):
            package.MinkowskiDistance(p=0.5, **kw)
        with pytest.raises(ValueError, match="power"):
            package.TweedieDevianceScore(power=0.5, **kw)
        with pytest.raises(ValueError, match="keep_sequence_dim"):
            package.CriticalSuccessIndex(0.5, keep_sequence_dim=-1, **kw)
        with pytest.raises(ValueError, match="normalization"):
            package.NormalizedRootMeanSquaredError(normalization="max", **kw)
        with pytest.raises(ValueError, match="adjusted"):
            package.R2Score(adjusted=-1, **kw)
        with pytest.raises(ValueError, match="multioutput"):
            package.ExplainedVariance(multioutput="mean", **kw)
        with pytest.raises(ValueError, match="variant"):
            package.KendallRankCorrCoef(variant="d", **kw)
        with pytest.raises(ValueError, match="reduction"):
            package.CosineSimilarity(reduction="max", **kw)
        with pytest.raises(TypeError, match="log_prob"):
            package.KLDivergence(log_prob=1, **kw)
    with pytest.raises(TPUMetricsUserError, match="``p``"):
        tf.minkowski_distance(torch.from_numpy(p), torch.from_numpy(t), p=0.9)
    with pytest.raises(ValueError, match="not a bool"):
        tf.critical_success_index(torch.from_numpy(p), torch.from_numpy(t), 0.5, keep_sequence_dim=True)
    with pytest.raises(ValueError, match="not a bool"):
        jf.critical_success_index(jnp.asarray(p), jnp.asarray(t), 0.5, keep_sequence_dim=True)
    with pytest.raises(ValueError, match="at least two samples"):
        tf.r2_score(torch.ones(1), torch.ones(1))
    r2 = tr.R2Score(device="cpu")
    r2.update(torch.ones(1), torch.ones(1))
    with pytest.raises(ValueError, match="at least two samples"):
        r2.compute()
    with pytest.raises(ValueError, match="2D"):
        tf.cosine_similarity(torch.ones(3), torch.ones(3))
    with pytest.raises(ValueError, match="2D"):
        tf.kl_divergence(torch.ones(3), torch.ones(3))


@pytest.mark.parametrize("adjusted", [10, 11])
def test_adjusted_r2_falls_back_with_a_warning_as_the_reference(adjusted):
    p, t = _inputs(96, n=11)
    with pytest.warns(UserWarning, match="r2 score"):
        port = tf.r2_score(torch.from_numpy(p), torch.from_numpy(t), adjusted=adjusted)
    with pytest.warns(UserWarning, match="r2 score"):
        ref = jf.r2_score(jnp.asarray(p), jnp.asarray(t), adjusted=adjusted)
    _close(port, ref)


def test_metrics_need_a_device_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.R2Score()
