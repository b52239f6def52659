"""The port's retrieval metrics against the JAX package's.

The same seeded numpy rows (query ids, float32 scores, targets) go through
both packages: every functional metric, every class for each
``empty_target_action``, with ``top_k``, ``ignore_index``, the aggregations,
tied scores, NaN and -0.0 scores and negative query ids, ``compute_flat``, the
view shared by a compute group, and state carried over from the JAX package.
Scores agree within rtol 1e-5 (float32 sums over the queries, taken in another
order); integer outputs and stored ids exactly. The JAX package sorts on the
host on the CPU (its 64-bit composite key), the order the port reproduces.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.retrieval as jf
import metrics_tpu.retrieval as jr
import metrics_tpu_torch.functional.retrieval as tf
import metrics_tpu_torch.retrieval as tr
from metrics_tpu_torch import MetricCollection
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.parallel import allreduce_over_mesh
from metrics_tpu_torch.retrieval import base as port_base

RTOL, ATOL = 1e-5, 1e-7
CLASSES = [n for n in jr.__all__ if n != "RetrievalMetric"]
TOP_K = {"RetrievalMAP", "RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalFallOut",
         "RetrievalHitRate", "RetrievalNormalizedDCG", "RetrievalAUROC"}


def _rows(seed=0, n=240, queries=(-3, 14), graded=False, special=True, empty_queries=True):
    """Query ids (some negative), scores with ties, NaN and -0.0, and binary (or graded) targets."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(*queries, n)
    preds = rng.rand(n).astype(np.float32)
    preds[::9] = 0.5
    if special:
        preds[3], preds[4], preds[11], preds[12] = -0.0, 0.0, np.nan, -0.0
    target = rng.randint(0, 4 if graded else 2, n)
    if not empty_queries:
        for q in np.unique(idx):  # one relevant and one non-relevant row in every query
            rows = np.nonzero(idx == q)[0]
            target[rows[0]] = 1
            if len(rows) > 1:
                target[rows[-1]] = 0
    return idx, preds, target


def _outputs(x):
    return [np.asarray(v) for v in (x if isinstance(x, tuple) else (x,))]


def _agree(port, ref):
    got, want = _outputs(port), _outputs(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _both(name, rows_list, **kw):
    port = getattr(tr, name)(device="cpu", **kw)
    ref = getattr(jr, name)(**kw)
    for idx, preds, target in rows_list:
        port.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(idx))
        ref.update(jnp.asarray(preds), jnp.asarray(target), indexes=jnp.asarray(idx))
    return port, ref


def _kw(name, top_k):
    return {"top_k": top_k} if name in TOP_K and top_k else {}


# ----------------------------------------------------------------------------- functional
FUNCTIONS = [
    ("retrieval_precision", {}), ("retrieval_precision", {"top_k": 3}),
    ("retrieval_precision", {"top_k": 40, "adaptive_k": True}), ("retrieval_recall", {}),
    ("retrieval_recall", {"top_k": 2}), ("retrieval_fall_out", {}), ("retrieval_fall_out", {"top_k": 4}),
    ("retrieval_hit_rate", {}), ("retrieval_hit_rate", {"top_k": 1}), ("retrieval_average_precision", {}),
    ("retrieval_average_precision", {"top_k": 5}), ("retrieval_reciprocal_rank", {}),
    ("retrieval_reciprocal_rank", {"top_k": 2}), ("retrieval_r_precision", {}),
    ("retrieval_normalized_dcg", {}), ("retrieval_normalized_dcg", {"top_k": 3}), ("retrieval_auroc", {}),
    ("retrieval_auroc", {"top_k": 6}), ("retrieval_auroc", {"max_fpr": 0.5}),
    ("retrieval_precision_recall_curve", {}), ("retrieval_precision_recall_curve", {"max_k": 30}),
    ("retrieval_precision_recall_curve", {"max_k": 30, "adaptive_k": True}),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize(("fn", "kw"), FUNCTIONS, ids=[f"{f}-{k}" for f, k in FUNCTIONS])
def test_functional_matches_reference(fn, kw, seed):
    rng = np.random.RandomState(seed)
    preds = rng.rand(20).astype(np.float32)
    preds[::4] = 0.25  # ties keep their input order
    preds[1] = -0.0
    target = rng.randint(0, 4 if fn == "retrieval_normalized_dcg" else 2, 20)
    port = getattr(tf, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    ref = getattr(jf, fn)(jnp.asarray(preds), jnp.asarray(target), **kw)
    _agree(port, ref)


@pytest.mark.parametrize("fn", ["retrieval_precision", "retrieval_recall", "retrieval_average_precision"])
def test_functional_refuses_a_bad_top_k(fn):
    for package in (tf, jf):
        with pytest.raises(ValueError, match="top_k"):
            getattr(package, fn)(torch.rand(4) if package is tf else jnp.ones(4), torch.ones(4, dtype=torch.long)
                                 if package is tf else jnp.ones(4, jnp.int32), top_k=0)


# ----------------------------------------------------------------------------- classes
@pytest.mark.parametrize("action", ["neg", "pos", "skip"])
@pytest.mark.parametrize("name", CLASSES)
def test_class_matches_reference(name, action):
    graded = name == "RetrievalNormalizedDCG"
    rows = [_rows(s, graded=graded) for s in (0, 1)]
    port, ref = _both(name, rows, empty_target_action=action)
    _agree(port.compute(), ref.compute())


@pytest.mark.parametrize("top_k", [1, 3, 10])
@pytest.mark.parametrize("name", sorted(TOP_K))
def test_top_k_matches_reference(name, top_k):
    rows = [_rows(2, graded=name == "RetrievalNormalizedDCG")]
    port, ref = _both(name, rows, **_kw(name, top_k))
    _agree(port.compute(), ref.compute())


@pytest.mark.parametrize("aggregation", ["mean", "median", "min", "max"])
@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalMRR", "RetrievalNormalizedDCG", "RetrievalRecall"])
def test_aggregation_matches_reference(name, aggregation):
    port, ref = _both(name, [_rows(3, graded=name == "RetrievalNormalizedDCG")], aggregation=aggregation)
    _agree(port.compute(), ref.compute())


def test_callable_aggregation_gets_the_valid_scores():
    port, ref = _both("RetrievalMAP", [_rows(4)], empty_target_action="skip",
                      aggregation=lambda v: v.max() if isinstance(v, torch.Tensor) else jnp.max(v))
    _agree(port.compute(), ref.compute())


@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalNormalizedDCG", "RetrievalPrecision", "RetrievalFallOut"])
def test_ignore_index_drops_the_rows(name):
    idx, preds, target = _rows(5, graded=name == "RetrievalNormalizedDCG")
    target[::5] = -100
    port, ref = _both(name, [(idx, preds, target)], ignore_index=-100)
    _agree(port.compute(), ref.compute())
    assert sum(len(x) for x in port.indexes) == int((target != -100).sum())


@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalMRR", "RetrievalFallOut",
                                  "RetrievalPrecisionRecallCurve"])
def test_error_action_raises_on_an_empty_query_and_scores_otherwise(name):
    idx, preds, target = _rows(6, empty_queries=False)
    target[idx == 2], target[idx == 5] = 0, 1  # a query with no relevant row, and one with no other row
    port, ref = _both(name, [(idx, preds, target)], empty_target_action="error")
    for metric in (port, ref):
        with pytest.raises(ValueError, match="no (positive|negative) target"):
            metric.compute()
    port, ref = _both(name, [_rows(6, empty_queries=False)], empty_target_action="error")
    _agree(port.compute(), ref.compute())


@pytest.mark.parametrize("seed", [0, 7])
def test_grouping_order_matches_the_reference_host_sort(seed):
    """The port's int64 key orders rows as the JAX package's unsigned composite key does: negative ids
    after the others, ties by input order, -0.0 with +0.0, NaN last in its query."""
    from metrics_tpu.retrieval.base import _order_by_query_desc as ref_order

    idx, preds, _ = _rows(seed, n=400, queries=(-5, 9))
    preds[20:30] = np.nan
    port = port_base._order_by_query_desc(torch.from_numpy(idx).int(), torch.from_numpy(preds))
    want = np.asarray(ref_order(jnp.asarray(idx.astype(np.int32)), jnp.asarray(preds)))
    np.testing.assert_array_equal(port.numpy(), want)


def test_negative_query_ids_rank_after_the_others():
    idx = torch.tensor([-1, 2, 0, -7, 2], dtype=torch.int32)
    order = port_base._order_by_query_desc(idx, torch.zeros(5))
    assert idx[order].tolist() == [0, 2, 2, -7, -1]


def test_recall_at_fixed_precision_matches_reference():
    for kw in ({"min_precision": 0.3}, {"min_precision": 0.99, "max_k": 5}, {"min_precision": 0.2, "adaptive_k": True}):
        port, ref = _both("RetrievalRecallAtFixedPrecision", [_rows(8)], **kw)
        _agree(port.compute(), ref.compute())


def test_input_validation_matches_reference():
    idx, preds, target = (torch.tensor(x) for x in ([0, 0, 1], [0.1, 0.2, 0.3], [0, 1, 2]))
    for package in (tr, jr):
        metric = package.RetrievalMAP(device="cpu") if package is tr else package.RetrievalMAP()
        conv = (lambda x: x) if package is tr else (lambda x: jnp.asarray(x.numpy()))
        with pytest.raises(ValueError, match="binary"):
            metric.update(conv(preds), conv(target), indexes=conv(idx))
        with pytest.raises(ValueError, match="integers"):
            metric.update(conv(preds), conv(target.clamp(max=1)), indexes=conv(idx.float()))
        with pytest.raises(ValueError, match="floats"):
            metric.update(conv(target), conv(target.clamp(max=1)), indexes=conv(idx))
        with pytest.raises(IndexError, match="same shape"):
            metric.update(conv(preds[:2]), conv(target.clamp(max=1)), indexes=conv(idx))
        with pytest.raises(ValueError, match="cannot be None"):
            metric.update(conv(preds), conv(target.clamp(max=1)), indexes=None)
    with pytest.raises(ValueError, match="empty_target_action"):
        tr.RetrievalMAP(empty_target_action="drop", device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        tr.RetrievalMRR(top_k=0, device="cpu")


# ----------------------------------------------------------------------------- compute_flat, shared view
@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalNormalizedDCG", "RetrievalAUROC", "RetrievalMRR"])
def test_compute_flat_matches_reference_and_compute(name):
    idx, preds, target = _rows(9, graded=name == "RetrievalNormalizedDCG", special=False)
    port, ref = _both(name, [(idx, preds, target)])
    flat = port.compute_flat(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(idx))
    _agree(flat, ref.compute_flat(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(idx)))
    _agree(flat, port.compute())


def test_compute_group_shares_one_sorted_view(monkeypatch):
    """Members of one compute group hold the same list tensors, so the grouping sort runs once."""
    built = []
    init = port_base.GroupedQueries.__init__
    monkeypatch.setattr(port_base.GroupedQueries, "__init__", lambda self, *a: built.append(1) or init(self, *a))
    names = ["RetrievalMAP", "RetrievalMRR", "RetrievalRecall", "RetrievalHitRate"]
    collection = MetricCollection({n: getattr(tr, n)(device="cpu") for n in names})
    rows = [_rows(s, special=False) for s in (10, 11)]
    for idx, preds, target in rows:
        collection.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(idx))
    assert list(collection.compute_groups) == [0] and sorted(collection.compute_groups[0]) == sorted(names)
    values = collection.compute()
    assert len(built) == 1
    for name in names:
        _agree(values[name], _both(name, rows)[1].compute())


# ----------------------------------------------------------------------------- state and ranks
def test_reference_state_loads_into_the_port():
    port, ref = _both("RetrievalNormalizedDCG", [_rows(12, graded=True)], top_k=5)
    ref.persistent(True)
    loaded = load_reference_state(tr.RetrievalNormalizedDCG(top_k=5, device="cpu"), ref.state_dict())
    assert [x.dtype for x in loaded.indexes] == [torch.int32]
    assert torch.equal(loaded.indexes[0], port.indexes[0]) and torch.equal(loaded.target[0], port.target[0])
    _agree(loaded.compute(), ref.compute())


def test_ragged_rank_states_folded_equal_the_single_stream():
    """Four ranks' list states (one rank empty) concatenated by the fan-in, as the JAX package's dryrun
    folds them over its mesh, score as the single stream does."""
    rng = np.random.RandomState(13)
    sizes = [17, 0, 31, 24]
    ranks, single = [], tr.RetrievalNormalizedDCG(device="cpu")
    for r, size in enumerate(sizes):
        metric = tr.RetrievalNormalizedDCG(device="cpu")
        if size:
            preds, target = torch.from_numpy(rng.rand(size).astype(np.float32)), torch.from_numpy(rng.randint(0, 3, size))
            indexes = torch.from_numpy(rng.randint(0, 4, size) + 10 * r)
            metric.update(preds, target, indexes=indexes)
            single.update(preds, target, indexes=indexes)
        ranks.append(metric)
    merged = allreduce_over_mesh([m.metric_state for m in ranks], {k: "cat" for k in ("indexes", "preds", "target")})
    folded = tr.RetrievalNormalizedDCG(device="cpu").load_merged_state(merged)
    torch.testing.assert_close(folded.compute(), single.compute(), rtol=RTOL, atol=0)
