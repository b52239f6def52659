"""The port's MetricCollection and CompositionalMetric against the JAX package's.

The same seeded numpy inputs go through both packages. Compute groups must be
the same dicts; counters and confusion matrices equal; scores within rtol 1e-6
(the port divides int64 counters in float64 and rounds once to float32, the
JAX package divides in float32); aggregator arithmetic is on values exact in
float32, so it agrees within rtol 1e-6 too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import metrics_tpu.aggregation as ja
import metrics_tpu.classification as jc
import metrics_tpu_torch.aggregation as ta
import metrics_tpu_torch.classification as tc
from metrics_tpu.collections import MetricCollection as JCollection
from metrics_tpu_torch import CompositionalMetric, MetricCollection
from metrics_tpu_torch.interop import load_reference_collection_state

RTOL = 1e-6
CLASSES, ROWS = 10, 64


def _close(port, ref, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port, dtype=np.float64), np.asarray(ref, dtype=np.float64), rtol=rtol)


def _same_results(port, ref):
    assert sorted(port) == sorted(ref)
    for key in ref:
        _close(port[key], ref[key])


def _multiclass(seed, n_batches=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(ROWS, CLASSES).astype(np.float32), rng.randint(0, CLASSES, ROWS)) for _ in range(n_batches)]


def _multilabel(seed, n_batches=3, labels=5):
    rng = np.random.RandomState(seed)
    return [(rng.rand(ROWS, labels).astype(np.float32), rng.randint(0, 2, (ROWS, labels))) for _ in range(n_batches)]


def _stat_set(package, **kw):
    """The ImageNet-like evaluation set of chip_smoke.py at a small size."""
    return [package.MulticlassAccuracy(num_classes=CLASSES, average="micro", **kw),
            package.MulticlassPrecision(num_classes=CLASSES, **kw),
            package.MulticlassRecall(num_classes=CLASSES, **kw),
            package.MulticlassF1Score(num_classes=CLASSES, average="macro", **kw),
            package.MulticlassConfusionMatrix(num_classes=CLASSES, **kw)]


def _curve_pair(package, **kw):
    return [package.MultilabelAveragePrecision(num_labels=5, thresholds=20, **kw),
            package.MultilabelAUROC(num_labels=5, thresholds=20, **kw)]


COLLECTIONS = {"stat_scores": (_stat_set, _multiclass), "ap_auroc": (_curve_pair, _multilabel)}


def _pair(kind, **kwargs):
    make, data = COLLECTIONS[kind]
    return MetricCollection(make(tc, device="cpu"), **kwargs), JCollection(make(jc), **kwargs), data


# ----------------------------------------------------------------------------- compute groups
@pytest.mark.parametrize("kind", sorted(COLLECTIONS))
def test_compute_groups_and_results_match_reference(kind):
    port, ref, data = _pair(kind)
    for step, (p, t) in enumerate(data(1)):
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
        assert port.compute_groups == ref.compute_groups, step
    _same_results(port.compute(), ref.compute())


def test_expected_groups_of_the_two_main_path_collections():
    port, _, data = _pair("stat_scores")
    p, t = data(2)[0]
    port.update(torch.from_numpy(p), torch.from_numpy(t))
    assert port.compute_groups == {0: ["MulticlassAccuracy"],
                                   1: ["MulticlassPrecision", "MulticlassRecall", "MulticlassF1Score"],
                                   2: ["MulticlassConfusionMatrix"]}
    port, _, data = _pair("ap_auroc")
    p, t = data(2)[0]
    port.update(torch.from_numpy(p), torch.from_numpy(t))
    assert port.compute_groups == {0: ["MultilabelAveragePrecision", "MultilabelAUROC"]}


def test_members_share_the_leader_tensors_and_stay_safe():
    port, _, data = _pair("stat_scores")
    batches = data(3)
    for p, t in batches[:2]:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    leader, member = port["MulticlassPrecision"], port["MulticlassRecall"]
    assert all(leader._state[k] is member._state[k] for k in leader._defaults)
    before = {k: v.clone() for k, v in leader.metric_state.items()}
    # a member updated on its own replaces its tensors; the leader's stay as they were
    p, t = batches[2]
    member.update(torch.from_numpy(p), torch.from_numpy(t))
    assert all(torch.equal(leader._state[k], before[k]) for k in before)
    assert not torch.equal(member.tp, leader.tp)


def test_list_states_are_copied_shallowly_in_groups():
    port = MetricCollection({"a": ta.CatMetric(device="cpu"), "b": ta.CatMetric(device="cpu")})
    port.update(torch.tensor([1.0, 2.0]))
    assert port.compute_groups == {0: ["a", "b"]}
    port.update(torch.tensor([3.0]))
    assert port["a"].value is not port["b"].value
    port["b"].update(torch.tensor([9.0]))
    assert torch.equal(port["a"].compute(), torch.tensor([1.0, 2.0, 3.0]))


def test_explicit_groups_update_only_their_leaders():
    groups = [["MultilabelAveragePrecision", "MultilabelAUROC"]]
    port, ref, data = _pair("ap_auroc", compute_groups=groups)
    assert port.compute_groups == ref.compute_groups == {0: groups[0]}
    for p, t in data(3):
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    assert port["MultilabelAUROC"].update_count == 3
    _same_results(port.compute(), ref.compute())
    with pytest.raises(ValueError, match="does not match a metric"):
        MetricCollection(_curve_pair(tc, device="cpu"), compute_groups=[["Nope"]])


def test_groups_off_keeps_every_metric_apart():
    port, ref, data = _pair("stat_scores", compute_groups=False)
    for p, t in data(4):
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    assert port.compute_groups == ref.compute_groups == {i: [n] for i, n in enumerate(port.keys(keep_base=True))}
    _same_results(port.compute(), ref.compute())


def test_reset_derives_groups_again():
    port, ref, data = _pair("stat_scores")
    for p, t in data(5):
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    port.reset()
    ref.reset()
    assert port.compute_groups == ref.compute_groups
    p, t = data(6)[0]
    port.update(torch.from_numpy(p), torch.from_numpy(t))
    ref.update(jnp.asarray(p), jnp.asarray(t))
    assert port.compute_groups == ref.compute_groups
    _same_results(port.compute(), ref.compute())


# ----------------------------------------------------------------------------- names, outputs, forward
def test_prefix_postfix_keys_and_items():
    port, ref, data = _pair("stat_scores", prefix="val_", postfix="_top1")
    assert port.keys() == ref.keys()
    assert list(port.keys(keep_base=True)) == list(ref.keys(keep_base=True))
    assert [k for k, _ in port.items()] == [k for k, _ in ref.items()]
    p, t = data(7)[0]
    port.update(torch.from_numpy(p), torch.from_numpy(t))
    ref.update(jnp.asarray(p), jnp.asarray(t))
    _same_results(port.compute(), ref.compute())
    clone = port.clone(prefix="test_")
    assert sorted(clone.compute()) == sorted(k.replace("val_", "test_") for k in port.compute())
    with pytest.raises(ValueError, match="Expected input `prefix`"):
        MetricCollection(_stat_set(tc, device="cpu"), prefix=1)


def test_nested_dict_outputs_flatten_as_reference():
    rng = np.random.RandomState(8)
    preds, target, groups = rng.rand(40).astype(np.float32), rng.randint(0, 2, 40), rng.randint(0, 3, 40)
    port = MetricCollection({"fair": tc.BinaryFairness(num_groups=3, device="cpu"),
                             "rates": tc.BinaryGroupStatRates(num_groups=3, device="cpu")}, prefix="p_")
    ref = JCollection({"fair": jc.BinaryFairness(num_groups=3), "rates": jc.BinaryGroupStatRates(num_groups=3)},
                      prefix="p_")
    port.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups))
    ref.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups))
    _same_results(port.compute(), ref.compute())


def test_forward_matches_reference():
    port, ref, data = _pair("stat_scores")
    for p, t in data(9):
        _same_results(port(torch.from_numpy(p), torch.from_numpy(t)), ref(jnp.asarray(p), jnp.asarray(t)))
    _same_results(port.compute(), ref.compute())


def test_construction_errors_match_reference():
    with pytest.raises(ValueError, match="two metrics both named"):
        MetricCollection([ta.SumMetric(device="cpu"), ta.SumMetric(device="cpu")])
    with pytest.raises(ValueError, match="string"):
        MetricCollection("SumMetric")
    with pytest.raises(ValueError, match="not compatible"):
        MetricCollection({"a": ta.SumMetric(device="cpu")}, ta.MeanMetric(device="cpu"))
    port = MetricCollection({"b": ta.SumMetric(device="cpu"), "a": ta.MeanMetric(device="cpu")})
    assert list(port.keys()) == ["a", "b"]
    port["c"] = ta.MaxMetric(device="cpu")
    assert "c" in port and len(port) == 3


# ----------------------------------------------------------------------------- state, copies, functional
def test_state_dict_round_trip_and_strict_loading():
    port, _, data = _pair("stat_scores")
    for p, t in data(10):
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    port.persistent(True)
    saved = port.state_dict()
    fresh, _, _ = _pair("stat_scores")
    fresh.persistent(True)
    fresh.load_state_dict(saved)
    _same_results(fresh.compute(), port.compute())
    with pytest.raises(RuntimeError, match="does not match collection members"):
        fresh.load_state_dict({k: v for k, v in saved.items() if k != "MulticlassRecall"})
    fresh.load_state_dict({k: v for k, v in saved.items() if k != "MulticlassRecall"}, strict=False)


def test_clone_is_independent():
    port, _, data = _pair("stat_scores")
    batches = data(11)
    port.update(torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]))
    clone = port.clone()
    assert clone.compute_groups == port.compute_groups
    clone.update(torch.from_numpy(batches[1][0]), torch.from_numpy(batches[1][1]))
    assert port["MulticlassAccuracy"].update_count == 1
    assert clone["MulticlassAccuracy"].update_count == 2
    lead, member = clone["MulticlassPrecision"], clone["MulticlassF1Score"]
    assert all(lead._state[k] is member._state[k] for k in lead._defaults)


def test_functional_matches_eager_and_leaves_the_collection_alone():
    port, ref, data = _pair("stat_scores")
    batches = data(12)
    port.update(torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]))
    ref.update(jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]))
    fns, jfns = port.functional(), ref.functional()
    assert sorted(fns.reductions) == sorted(jfns.reductions) == ["MulticlassAccuracy", "MulticlassConfusionMatrix",
                                                                 "MulticlassPrecision"]
    state, jstate = fns.init(), jfns.init()
    before = {k: v.clone() for k, v in port["MulticlassAccuracy"].metric_state.items()}
    for p, t in batches:
        state = fns.update(state, torch.from_numpy(p), torch.from_numpy(t))
        jstate = jfns.update(jstate, jnp.asarray(p), jnp.asarray(t))
    _same_results(fns.compute(state), jfns.compute(jstate))
    assert all(torch.equal(port["MulticlassAccuracy"]._state[k], v) for k, v in before.items())
    assert port["MulticlassAccuracy"].update_count == 1


def test_metric_functional_matches_reference():
    p, t = _multiclass(15)[0]
    port = tc.MulticlassPrecision(num_classes=CLASSES, device="cpu").functional()
    ref = jc.MulticlassPrecision(num_classes=CLASSES).functional()
    a = port.update(port.init(), torch.from_numpy(p[:40]), torch.from_numpy(t[:40]))
    b = port.update(port.init(), torch.from_numpy(p[40:]), torch.from_numpy(t[40:]))
    ja_ = ref.update(ref.init(), jnp.asarray(p[:40]), jnp.asarray(t[:40]))
    jb = ref.update(ref.init(), jnp.asarray(p[40:]), jnp.asarray(t[40:]))
    merged, jmerged = port.merge(a, b, 1, 1), ref.merge(ja_, jb, 1, 1)
    for key in jmerged:
        np.testing.assert_array_equal(merged[key].numpy(), np.asarray(jmerged[key]))
    _close(port.compute(merged), ref.compute(jmerged))
    assert port.associative == ref.associative == {"tp": True, "fp": True, "tn": True, "fn": True}
    assert [fn.__name__ for fn in port.reductions.values()] == [fn.__name__ for fn in ref.reductions.values()]
    init, update, compute, merge = port
    assert init()["tp"].sum() == 0


def test_set_dtype_casts_floating_states():
    port = MetricCollection([ta.MeanMetric(device="cpu"), tc.MulticlassConfusionMatrix(num_classes=3, device="cpu")])
    port.set_dtype(torch.float64)
    assert port["MeanMetric"].mean_value.dtype == torch.float64
    assert port["MulticlassConfusionMatrix"].confmat.dtype == torch.int64
    port["MeanMetric"].update(torch.tensor([1.0, 2.0]))
    assert port["MeanMetric"].compute().dtype == torch.float64


def test_reference_collection_state_loads_with_its_groups():
    _, ref, data = _pair("stat_scores")
    batches = data(13)
    for p, t in batches[:2]:
        ref.update(jnp.asarray(p), jnp.asarray(t))
    ref.persistent(True)
    port, _, _ = _pair("stat_scores")
    load_reference_collection_state(port, ref.state_dict(), ref.compute_groups)
    assert port.compute_groups == ref.compute_groups
    lead, member = port["MulticlassPrecision"], port["MulticlassRecall"]
    assert all(lead._state[k] is member._state[k] for k in lead._defaults)
    assert member.update_count == 2
    for p, t in batches[2:]:
        ref.update(jnp.asarray(p), jnp.asarray(t))
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    _same_results(port.compute(), ref.compute())


def test_reference_collection_state_without_groups_and_its_errors():
    _, ref, data = _pair("stat_scores")
    for p, t in data(14):
        ref.update(jnp.asarray(p), jnp.asarray(t))
    ref.persistent(True)
    port, _, _ = _pair("stat_scores")
    load_reference_collection_state(port, ref.state_dict())
    _same_results(port.compute(), ref.compute())
    with pytest.raises(ValueError, match="does not match the members"):
        load_reference_collection_state(port, {"MulticlassAccuracy": ref.state_dict()["MulticlassAccuracy"]})
    with pytest.raises(ValueError, match="another state than its group"):
        load_reference_collection_state(port, ref.state_dict(), [["MulticlassAccuracy", "MulticlassPrecision"],
                                                                  ["MulticlassRecall", "MulticlassF1Score"],
                                                                  ["MulticlassConfusionMatrix"]])


# ----------------------------------------------------------------------------- CompositionalMetric
def _sums(package, values, **kw):
    metric = package.SumMetric(**kw)
    for v in values:
        metric.update(v)
    return metric


def _confmats(package, make_tensor, **kw):
    metric = package.MulticlassConfusionMatrix(num_classes=3, **kw)
    metric.update(make_tensor(np.array([0, 1, 2, 2, 1, 0, 1])), make_tensor(np.array([0, 2, 2, 1, 1, 0, 0])))
    return metric


def _both(op, left, right):
    """(port, reference) compositions; ``left``/``right`` are "a", "b" (metrics) or a constant."""
    def build(package, as_array, **kw):
        a = _sums(package, [as_array(np.float32(6.5)), as_array(np.float32(1.25))], **kw)
        b = _sums(package, [as_array(np.float32(2.0))], **kw)
        pick = {"a": a, "b": b}
        return op(pick.get(left, left), pick.get(right, right))
    return build(ta, torch.tensor, device="cpu"), build(ja, jnp.asarray)


BINARY_OPS = {
    "add": lambda x, y: x + y, "sub": lambda x, y: x - y, "mul": lambda x, y: x * y,
    "truediv": lambda x, y: x / y, "floordiv": lambda x, y: x // y, "mod": lambda x, y: x % y,
    "pow": lambda x, y: x ** y, "eq": lambda x, y: x == y, "ne": lambda x, y: x != y,
    "ge": lambda x, y: x >= y, "gt": lambda x, y: x > y, "le": lambda x, y: x <= y, "lt": lambda x, y: x < y,
}


@pytest.mark.parametrize("sides", [("a", "b"), ("a", 3), (3, "a")])
@pytest.mark.parametrize("op", sorted(BINARY_OPS))
def test_compositional_operators_match_reference(op, sides):
    if op in ("eq", "ne", "ge", "gt", "le", "lt") and sides[0] == 3:
        sides = ("a", 7.75)  # a constant on the left of a comparison reflects to the metric's method
    port, ref = _both(BINARY_OPS[op], *sides)
    assert isinstance(port, CompositionalMetric)
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize("op", ["abs", "neg", "pos"])
def test_compositional_unary_operators_match_reference(op):
    fn = {"abs": abs, "neg": lambda x: -x, "pos": lambda x: +x}[op]
    port, ref = _both(lambda x, _: fn(x), "a", None)
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize("op", ["and", "or", "xor", "invert", "matmul", "index"])
def test_compositional_integer_operators_match_reference(op):
    port_a, ref_a = _confmats(tc, torch.from_numpy, device="cpu"), _confmats(jc, jnp.asarray)
    port_b, ref_b = _confmats(tc, torch.from_numpy, device="cpu"), _confmats(jc, jnp.asarray)
    fn = {"and": lambda x, y: x & y, "or": lambda x, y: x | y, "xor": lambda x, y: x ^ y,
          "invert": lambda x, _: ~x, "matmul": lambda x, y: x @ y, "index": lambda x, _: x[1]}[op]
    _close(fn(port_a, port_b).compute(), fn(ref_a, ref_b).compute())


def test_compositional_update_forward_reset_and_device():
    rmse, ref = ta.MeanMetric(device="cpu") ** 0.5, ja.MeanMetric() ** 0.5
    assert rmse.device == torch.device("cpu")
    for v in (4.0, 16.0):
        _close(rmse(torch.tensor(v)), ref(jnp.asarray(v)))
    _close(rmse.compute(), ref.compute())
    rmse.update(torch.tensor(1.0))
    ref.update(jnp.asarray(1.0))
    _close(rmse.compute(), ref.compute())
    rmse.reset()
    assert rmse.metric_a.update_count == 0
    assert "pow" in repr(rmse)
