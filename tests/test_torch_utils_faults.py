"""Faults C1-C3 of the port, fixed, against the JAX package; and the runtime marks the time windows read.

C1: ``metrics_tpu_torch.utils`` exports the JAX package's 25 names in its
order, ``utils.distributed`` has ``reduce``, ``class_reduce`` and the
re-exported ``gather_all_states``, and ``TPUMetricsUserWarning`` exists. C2:
``spearman_corrcoef`` of float64 inputs is float32, as the JAX package's
(whose inputs arrive as float32), while float16 ranks stay in float16. C3:
the retrieval curves' top-k is int32, as the JAX package's. Values are held
within rtol 1e-6 (reductions of a few float32 values) and integers exactly.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.utils as ju
import metrics_tpu.utils.distributed as jd
import metrics_tpu_torch.utils as tu
import metrics_tpu_torch.utils.distributed as td

RTOL = 1e-6


def _close(port, ref, rtol=RTOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=rtol, atol=1e-7)


# ----------------------------------------------------------------------------- C1
def test_utils_exports_the_reference_names_in_order():
    assert tu.__all__ == ju.__all__ and len(tu.__all__) == 25
    for name in tu.__all__:
        assert hasattr(tu, name), name
    from metrics_tpu_torch.utils import bincount, enums, imports, plot  # noqa: F401

    assert tu.bincount(torch.tensor([0, 2, 2]), 3).tolist() == [1, 0, 2]


def test_distributed_module_reexports_the_sync_gather():
    from metrics_tpu_torch.parallel.sync import gather_all_states
    from metrics_tpu_torch.utils.distributed import gather_all_states as reexported

    assert reexported is gather_all_states
    assert td.__all__ == jd.__all__
    with pytest.raises(AttributeError):
        td.no_such_name  # noqa: B018


def test_user_warning_is_a_user_warning():
    from metrics_tpu.utils.exceptions import TPUMetricsUserWarning as RefWarning
    from metrics_tpu_torch.utils.exceptions import TPUMetricsUserWarning

    assert issubclass(TPUMetricsUserWarning, UserWarning) and TPUMetricsUserWarning.__name__ == RefWarning.__name__
    with pytest.warns(TPUMetricsUserWarning):
        warnings.warn("degraded", TPUMetricsUserWarning)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none", None])
def test_reduce_matches_reference(reduction):
    x = np.random.RandomState(0).randn(7, 3).astype(np.float32)
    got, want = td.reduce(torch.from_numpy(x), reduction), jd.reduce(jnp.asarray(x), reduction)
    assert got.dtype == torch.float32
    _close(got, want)


def test_reduce_rejects_unknown_names_as_the_reference():
    for fn, arr in ((td.reduce, torch.ones(2)), (jd.reduce, jnp.ones(2))):
        with pytest.raises(ValueError, match="Reduction parameter unknown"):
            fn(arr, "median")


@pytest.mark.parametrize("class_reduction", ["micro", "macro", "weighted", "none", None])
def test_class_reduce_matches_reference(class_reduction):
    num = np.array([1.0, 2.0, 0.0, 3.0, 1.0], np.float32)
    denom = np.array([2.0, 2.0, 0.0, 4.0, 0.0], np.float32)  # a 0/0 class and an x/0 class
    weights = np.array([2.0, 2.0, 0.0, 4.0, 1.0], np.float32)
    got = td.class_reduce(torch.from_numpy(num), torch.from_numpy(denom), torch.from_numpy(weights), class_reduction)
    want = jd.class_reduce(jnp.asarray(num), jnp.asarray(denom), jnp.asarray(weights), class_reduction)
    np.testing.assert_array_equal(np.isinf(np.asarray(got)), np.isinf(np.asarray(want)))
    finite = np.isfinite(np.asarray(want))
    _close(np.asarray(got)[finite], np.asarray(want)[finite])
    with pytest.raises(ValueError, match="unknown"):
        td.class_reduce(torch.ones(2), torch.ones(2), torch.ones(2), "median")


# ----------------------------------------------------------------------------- C2
@pytest.mark.parametrize("shape", [(300,), (300, 3)])
def test_spearman_of_float64_inputs_is_float32_as_the_reference(shape):
    import metrics_tpu.functional.regression as jf
    import metrics_tpu_torch.functional.regression as tf

    rng = np.random.RandomState(3)
    y = rng.randn(*shape)
    x = 0.7 * y + 0.5 * rng.randn(*shape)
    got = tf.spearman_corrcoef(torch.from_numpy(x), torch.from_numpy(y))
    want = jf.spearman_corrcoef(jnp.asarray(x), jnp.asarray(y))
    assert x.dtype == np.float64 and str(want.dtype) == "float32"
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_spearman_keeps_float16_ranks_as_the_reference():
    """The reference caveat: ranks are taken in the input's type, so float16 inputs give float16."""
    import metrics_tpu.functional.regression as jf
    import metrics_tpu_torch.functional.regression as tf

    rng = np.random.RandomState(4)
    x, y = rng.randn(200).astype(np.float16), rng.randn(200).astype(np.float16)
    got = tf.spearman_corrcoef(torch.from_numpy(x), torch.from_numpy(y))
    want = jf.spearman_corrcoef(jnp.asarray(x), jnp.asarray(y))
    assert got.dtype == torch.float16 and str(want.dtype) == "float16"


# ----------------------------------------------------------------------------- C3
def _retrieval_rows(seed=0, n=120):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 6, n), rng.rand(n).astype(np.float32), rng.randint(0, 2, n))


@pytest.mark.parametrize("kwargs", [{"max_k": 5}, {"max_k": 9, "adaptive_k": True}, {}])
def test_retrieval_curve_top_k_is_int32(kwargs):
    import metrics_tpu.functional.retrieval as jf
    import metrics_tpu_torch.functional.retrieval as tf

    _, preds, target = _retrieval_rows()
    preds, target = preds[:7], target[:7]
    got = tf.retrieval_precision_recall_curve(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    want = jf.retrieval_precision_recall_curve(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    assert got[2].dtype == torch.int32 and str(want[2].dtype) == "int32"
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)


@pytest.mark.parametrize("name, kwargs", [("RetrievalPrecisionRecallCurve", {"max_k": 5}),
                                          ("RetrievalPrecisionRecallCurve", {}),
                                          ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.3, "max_k": 5}),
                                          ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.99})])
def test_retrieval_curve_classes_return_int32_top_k(name, kwargs):
    import metrics_tpu.retrieval as jr
    import metrics_tpu_torch.retrieval as tr

    idx, preds, target = _retrieval_rows(1)
    port, ref = getattr(tr, name)(device="cpu", **kwargs), getattr(jr, name)(**kwargs)
    port.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(idx))
    ref.update(jnp.asarray(preds), jnp.asarray(target), indexes=jnp.asarray(idx))
    got, want = port.compute(), ref.compute()
    assert got[-1].dtype == torch.int32 and str(want[-1].dtype) == "int32"
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1]))
    for g, w in zip(got[:-1], want[:-1]):
        _close(g, w, 1e-5)


# ----------------------------------------------------------------------------- runtime marks
def test_runtime_marks_match_the_reference():
    import metrics_tpu as jm
    import metrics_tpu.segmentation as js
    import metrics_tpu_torch as tm
    import metrics_tpu_torch.segmentation as ts

    assert tm.Metric.__jit_ineligible__ is jm.Metric.__jit_ineligible__ is False
    assert ts.HausdorffDistance.__jit_ineligible__ is js.HausdorffDistance.__jit_ineligible__ is True
    for strategy in ("error", "warn", "ignore", "disable", 0.0):
        port, ref = tm.MeanMetric(nan_strategy=strategy, device="cpu"), jm.MeanMetric(nan_strategy=strategy)
        assert port._jit_update_opt == ref._jit_update_opt, strategy
    assert tm.CatMetric(device="cpu")._has_list_state() and jm.CatMetric()._has_list_state()
    assert not tm.SumMetric(device="cpu")._has_list_state() and not jm.SumMetric()._has_list_state()


# ----------------------------------------------------------------------------- F2
def _accuracies(n_batches=3, seed=0):
    import metrics_tpu.classification as jc
    import metrics_tpu_torch.classification as tc

    rng = np.random.RandomState(seed)
    batches = [(rng.randint(0, 3, 32), rng.randint(0, 3, 32)) for _ in range(n_batches)]
    return (lambda: tc.MulticlassAccuracy(num_classes=3, device="cpu")), (lambda: jc.MulticlassAccuracy(num_classes=3)), batches


@pytest.mark.parametrize("wrapper", ["TimeDecayed", "TumblingWindow"])
@pytest.mark.parametrize("op", ["add", "mul"])
def test_a_composition_is_refused_by_the_time_windows_as_in_the_reference(wrapper, op):
    """``CompositionalMetric`` is jit-ineligible in both packages, so the windows refuse it at construction with
    the JAX package's error and text."""
    import metrics_tpu as jm
    import metrics_tpu_torch as tm
    from metrics_tpu.utils.exceptions import TPUMetricsUserError as RefError
    from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError

    make_t, make_j, _ = _accuracies()
    compose = (lambda a, b: a + b) if op == "add" else (lambda a, b: a * 2)
    kw = {"half_life_s": 10.0} if wrapper == "TimeDecayed" else {"pane_s": 10.0, "n_panes": 3}
    assert tm.CompositionalMetric.__jit_ineligible__ is jm.CompositionalMetric.__jit_ineligible__ is True
    with pytest.raises(TPUMetricsUserError) as port_err:
        getattr(tm, wrapper)(compose(make_t(), make_t()), **kw)
    with pytest.raises(RefError) as ref_err:
        getattr(jm, wrapper)(compose(make_j(), make_j()), **kw)
    assert str(port_err.value) == str(ref_err.value)
    assert "cannot wrap CompositionalMetric: its update body is declared jit-ineligible" in str(port_err.value)


def test_a_composition_still_updates_and_computes_as_the_reference():
    make_t, make_j, batches = _accuracies()
    port, ref = make_t() + make_t() * 2, make_j() + make_j() * 2
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    _close(port.compute(), ref.compute())
    assert not port._jit_eligible((), {})


def test_the_fleet_engine_still_sends_a_composition_loose():
    import metrics_tpu.engine as je
    import metrics_tpu_torch.engine as te

    make_t, make_j, batches = _accuracies()
    port_engine, ref_engine = te.StreamEngine(), je.StreamEngine()
    sp, sr = port_engine.add_session(make_t() + make_t()), ref_engine.add_session(make_j() + make_j())
    assert port_engine.session_health(sp) == ref_engine.session_health(sr) == "loose"
    for p, t in batches:
        port_engine.submit(sp, torch.from_numpy(p), torch.from_numpy(t))
        ref_engine.submit(sr, jnp.asarray(p), jnp.asarray(t))
        port_engine.tick()
        ref_engine.tick()
    _close(port_engine.compute(sp), ref_engine.compute(sr))


def test_bootstrapper_over_a_composition_still_agrees_with_the_reference():
    from metrics_tpu.wrappers import BootStrapper as RefBootStrapper
    from metrics_tpu_torch.wrappers import BootStrapper

    make_t, make_j, batches = _accuracies()
    np.random.seed(1234)
    ref = RefBootStrapper(make_j() + make_j(), num_bootstraps=5, quantile=0.5, raw=True)
    for p, t in batches:
        ref.update(jnp.asarray(p), jnp.asarray(t))
    np.random.seed(1234)
    port = BootStrapper(make_t() + make_t(), num_bootstraps=5, quantile=0.5, raw=True)
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    got, want = port.compute(), ref.compute()
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


# ----------------------------------------------------------------------------- F3
def test_the_shared_modules_missing_names_exist_as_in_the_reference():
    import importlib

    import metrics_tpu.utils.enums as je

    jss = importlib.import_module("metrics_tpu.functional.classification.stat_scores")
    te = importlib.import_module("metrics_tpu_torch.utils.enums")
    tss = importlib.import_module("metrics_tpu_torch.functional.classification.stat_scores")
    from metrics_tpu_torch.utils import compute, data

    for name in ("DataType", "AverageMethod", "MDMCAverageMethod"):
        port, ref = getattr(te, name), getattr(je, name)
        assert [(m.name, m.value) for m in port] == [(m.name, m.value) for m in ref], name
        assert issubclass(port, te.EnumStr)
    assert te.DataType.from_str("multilabel") == "MULTI-LABEL" and te.AverageMethod.NONE == "none"
    assert te.MDMCAverageMethod.from_str("global") is te.MDMCAverageMethod.GLOBAL
    with pytest.raises(ValueError, match="Invalid Average method"):
        te.AverageMethod.from_str("median")
    assert data.interp is compute.interp
    x, xp, fp = np.array([0.5, 1.5, 3.0], np.float32), np.array([0.0, 1.0, 2.0], np.float32), np.array(
        [1.0, 3.0, 2.0], np.float32)
    _close(data.interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp)),
           importlib.import_module("metrics_tpu.utils.data").interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    for value in (np.array([[1, 0], [2, 1]]), np.array([0.5, -1.0], np.float32), np.array(3)):
        assert tss.np_vals(torch.from_numpy(value)) == jss.np_vals(jnp.asarray(value))
        assert tss.np_vals(value) == jss.np_vals(value)


# ----------------------------------------------------------------------------- F4
def test_the_hugging_face_forwards_run_with_tf32_off(tmp_path):
    """``load_clip``'s two encoders and ``load_text_encoder``'s forward run inside ``exact_fp32``: a forward
    pre-hook sees both TF32 flags off, and the caller's flags come back after the forward."""
    from _torch_hf import tiny_bert, tiny_clip

    from metrics_tpu_torch.models import load_clip, load_text_encoder

    clip_path, _, _ = tiny_clip(tmp_path / "clip")
    bert_path, _, _ = tiny_bert(tmp_path / "bert")
    image_encoder, text_encoder = load_clip(clip_path, device="cpu")
    encoder = load_text_encoder(bert_path, device="cpu")
    seen = []
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda module, args: seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
    try:
        for call in (lambda: image_encoder(torch.rand(2, 3, 32, 32)), lambda: text_encoder(["a photo of a cat"]),
                     lambda: encoder(["the cat sat"])):
            seen.clear()
            call()
            assert seen and set(seen) == {(False, False)}
            assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
