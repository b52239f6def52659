"""The batched forms of both kernels, the traced mode, and the replica engine.

* Each kernel's custom op under ``torch.func.vmap`` (the ``register_vmap``
  rule: one call of the batch's columns or planes) equals a per-row loop of
  the plain version, bit for bit: B1 in float32 and float64, its labels mode,
  unbatched operands broadcast; B2 at a few row counts. A batched threshold
  vector raises.
* The traced mode: ``_is_traced`` sees ``torch.func`` wrappers, ``bincount``
  and the scatter helpers give the eager counts under ``vmap``, and the
  aggregators' ``nan_strategy`` acts as the JAX package's does under tracing.
* The replica engine (``wrappers/replicated.py``): ``BootStrapper`` (gather
  mode) and ``MultioutputWrapper`` (stacked mode) equal the JAX package's on
  the same seed and inputs, one dispatch an update, and equal their own loop;
  a refused body latches the loop without losing an update.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.func import vmap

from _torch_engine_sides import side
from metrics_tpu_torch.ops.binned_hist import (
    binned_counts,
    binned_counts_labels,
    binned_counts_labels_plain,
    binned_counts_plain,
)
from metrics_tpu_torch.ops.ssim_window import ssim_window, ssim_window_plain


def _rows_equal(batched, per_row):
    for r, ref in enumerate(per_row):
        for got, want in zip(batched, ref):
            assert got.dtype == want.dtype
            assert torch.equal(got[r], want), r


# ------------------------------------------------------------------ B1 under vmap
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,n,num_c", [(1, 33, 1), (3, 50, 4), (16, 16, 8)])
def test_binned_counts_vmap_equals_a_loop_of_the_plain_version(dtype, rows, n, num_c):
    g = torch.Generator().manual_seed(rows * 100 + num_c)
    preds = torch.rand(rows, n, num_c, generator=g, dtype=torch.float64).to(dtype)
    preds[0, 0, 0] = float("nan")  # a NaN score meets no threshold
    target = torch.randint(0, 2, (rows, n, num_c), generator=g).int()
    valid = torch.rand(rows, n, num_c, generator=g) > 0.1
    thr = torch.linspace(0, 1, 9, dtype=dtype)
    out = vmap(binned_counts, in_dims=(0, 0, 0, None))(preds, target, valid, thr)
    _rows_equal(out, [binned_counts_plain(preds[r], target[r], valid[r], thr) for r in range(rows)])
    # an unbatched operand is shared by every row
    out = vmap(binned_counts, in_dims=(0, None, None, None))(preds, target[0], valid[0], thr)
    _rows_equal(out, [binned_counts_plain(preds[r], target[0], valid[0], thr) for r in range(rows)])


@pytest.mark.parametrize("rows", [1, 5])
def test_binned_counts_labels_vmap_becomes_the_one_hot_plain_mode(rows):
    g = torch.Generator().manual_seed(rows)
    preds = torch.rand(rows, 40, 6, generator=g)
    labels = torch.randint(-1, 8, (rows, 40), generator=g).int()  # -1 masked, >= 6 a negative of every class
    thr = torch.linspace(0, 1, 5)
    out = vmap(binned_counts_labels, in_dims=(0, 0, None))(preds, labels, thr)
    _rows_equal(out, [binned_counts_labels_plain(preds[r], labels[r], thr) for r in range(rows)])
    out = vmap(binned_counts_labels, in_dims=(0, None, None))(preds, labels[0], thr)
    _rows_equal(out, [binned_counts_labels_plain(preds[r], labels[0], thr) for r in range(rows)])


def test_batched_thresholds_raise_and_nested_vmap_folds_both_levels():
    preds = torch.rand(2, 3, 10, 2)
    target = torch.randint(0, 2, (2, 3, 10, 2)).int()
    valid = torch.ones(2, 3, 10, 2, dtype=torch.bool)
    thr = torch.linspace(0, 1, 4)
    with pytest.raises(ValueError, match="thresholds are configuration"):
        vmap(binned_counts)(preds[0], target[0], valid[0], thr.expand(3, 4))
    inner = vmap(binned_counts, in_dims=(0, 0, 0, None))
    out = vmap(inner, in_dims=(0, 0, 0, None))(preds, target, valid, thr)
    for a in range(2):
        _rows_equal([o[a] for o in out], [binned_counts_plain(preds[a, r], target[a, r], valid[a, r], thr)
                                          for r in range(3)])


# ------------------------------------------------------------------ B2 under vmap
@pytest.mark.parametrize("rows,planes,taps", [(1, 5, 11), (4, 3, 11), (7, 2, 7)])
def test_ssim_window_vmap_equals_a_loop_of_the_plain_version(rows, planes, taps):
    g = torch.Generator().manual_seed(rows)
    x = torch.rand(rows, planes, 24 + taps - 1, 20 + taps - 1, generator=g)
    k = torch.softmax(torch.rand(taps, generator=g), 0).tolist()
    out = vmap(lambda a: ssim_window(a, k, k))(x)
    for r in range(rows):
        assert torch.equal(out[r], ssim_window_plain(x[r], k, k))


def test_kernel_wrappers_call_their_ops_only_under_vmap(monkeypatch):
    """The window wrapper calls its op only on batched planes (its eager route keeps the CPU gradient)."""
    import metrics_tpu_torch.ops.ssim_window as sw

    calls = []
    real = sw._ssim_window_op
    monkeypatch.setattr(sw, "_ssim_window_op", lambda *a: calls.append(1) or real(*a))
    x, k = torch.rand(2, 3, 14, 12), [0.25, 0.5, 0.25]
    ssim_window(x[0], k, k)  # eager: the plain version, no op
    assert calls == []
    vmap(lambda a: ssim_window(a, k, k))(x)
    assert len(calls) == 2  # the wrapper's op call, then the rule's one call of all the planes


def test_binned_counts_wrappers_call_their_ops_on_every_call(monkeypatch):
    import metrics_tpu_torch.ops.binned_hist as bh

    calls = []
    real = bh._binned_counts_op
    monkeypatch.setattr(bh, "_binned_counts_op", lambda *a: calls.append(1) or real(*a))
    preds, target = torch.rand(2, 12, 3), torch.randint(0, 2, (2, 12, 3)).int()
    valid, thr = torch.ones(2, 12, 3, dtype=torch.bool), torch.linspace(0, 1, 3)
    binned_counts(preds[0], target[0], valid[0], thr)
    assert len(calls) == 1
    vmap(binned_counts, in_dims=(0, 0, 0, None))(preds, target, valid, thr)
    assert len(calls) == 3  # the wrapper's op call, then the rule's one call of all the columns


def test_eager_ssim_window_on_the_cpu_stays_differentiable():
    """The eager route calls the plain version directly: SSIM as a loss on the CPU keeps its gradient, which the
    custom op (no autograd formula) would refuse."""
    from metrics_tpu_torch.ops.ssim_window import _ssim_window_op

    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, 18, 20, generator=g, requires_grad=True)
    k = [0.25, 0.5, 0.25]
    ssim_window(x, k, k).sum().backward()
    want = torch.autograd.grad(ssim_window_plain(x, k, k).sum(), x)[0]
    assert torch.equal(x.grad, want)
    with pytest.raises(RuntimeError, match="autograd"):
        _ssim_window_op(x, k, k).sum().backward()


# ------------------------------------------------------------------ traced mode
def test_is_traced_sees_functorch_wrappers_only():
    from metrics_tpu_torch.utils.checks import _is_traced

    x = torch.zeros(3, 2)
    assert not _is_traced(x, 1.0, None)
    seen = []
    vmap(lambda r: seen.append(_is_traced(r)) or r)(x)
    assert seen == [True]


def test_traced_bincount_and_scatter_helpers_give_the_eager_counts():
    from metrics_tpu_torch.functional.sketches.hll import hll_delta
    from metrics_tpu_torch.utils.data import bincount, bincount_weighted, select_topk

    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 9, (4, 30), generator=g)  # 7 and 8 fall outside minlength=7 and are dropped
    out = vmap(lambda r: bincount(r, 7))(x)
    assert torch.equal(out, torch.stack([torch.bincount(r, minlength=7)[:7] for r in x]))
    w = torch.rand(4, 30, generator=g)
    out = vmap(lambda r, v: bincount_weighted(r, v, 9))(x, w)
    assert torch.equal(out, torch.stack([bincount_weighted(r, v, 9) for r, v in zip(x, w)]))
    probs = torch.rand(4, 5, 3, generator=g)
    assert torch.equal(vmap(lambda p: select_topk(p, 2))(probs), torch.stack([select_topk(p, 2) for p in probs]))
    vals = torch.rand(4, 64, generator=g)
    ok = torch.ones(64, dtype=torch.bool)
    assert torch.equal(vmap(lambda v: hll_delta(v, ok, p=8))(vals), torch.stack([hll_delta(v, ok, p=8) for v in vals]))


def test_aggregator_nan_strategy_under_vmap_acts_as_under_jax_tracing():
    import metrics_tpu_torch as M

    x = torch.tensor([[1.0, float("nan"), 3.0], [2.0, 2.0, 2.0]])
    warn = M.MeanMetric(device="cpu")
    with pytest.warns(UserWarning, match="cannot inspect values"):
        new = vmap(lambda r: warn._functional_update(warn._fresh_state(), r))(x)
    assert torch.allclose(new["mean_value"] / new["weight"], torch.tensor([2.0, 2.0]))  # NaN dropped
    err = M.MeanMetric(nan_strategy="error", device="cpu")
    with pytest.raises(RuntimeError, match="cannot run inside torch.func.vmap"):
        vmap(lambda r: err._functional_update(err._fresh_state(), r))(x)
    # eagerly "error" still raises on the NaN, and "warn" warns and drops it, as before
    with pytest.raises(RuntimeError, match="Encountered `nan`"):
        err.update(x[0])
    with pytest.warns(UserWarning, match="Will be removed"):
        warn.update(x[0])
    assert float(warn.compute()) == 2.0


# ------------------------------------------------------------------ replica engine
def _bootstrap(s, num_bootstraps=8, sampling="multinomial"):
    from importlib import import_module

    wrappers = import_module(f"{s.pkg.__name__}.wrappers")
    np.random.seed(123)
    rng = np.random.RandomState(5)
    base = s.MulticlassAccuracy(num_classes=3, average="micro", **s.kw)
    boot = wrappers.BootStrapper(base, num_bootstraps=num_bootstraps, raw=True, sampling_strategy=sampling)
    for _ in range(3):
        boot.update(s.arr(rng.randint(3, size=64)), s.arr(rng.randint(3, size=64)))
    return {k: s.np(v) for k, v in boot.compute().items()}, s.count("replica_dispatch")


def test_bootstrapper_rides_the_replica_engine_and_equals_the_jax_package():
    ref_jax, port = side("jax"), side("torch")
    with ref_jax.fresh():
        ref, ref_dispatches = _bootstrap(ref_jax)
    with port.fresh():
        got, dispatches = _bootstrap(port)
    assert ref_dispatches == dispatches == 4  # one update dispatch per update, one compute dispatch
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got["raw"], ref["raw"])  # the replicates' accuracies are exact fractions


def test_bootstrapper_engine_equals_its_own_loop(monkeypatch):
    from metrics_tpu_torch.wrappers.replicated import ReplicatedWrapper

    port = side("torch")
    with port.fresh():
        engine, _ = _bootstrap(port)
    monkeypatch.setattr(ReplicatedWrapper, "_engine_ok", lambda self, a, k: False)
    with port.fresh():
        loop, dispatches = _bootstrap(port)
    assert dispatches == 0
    for k in engine:
        np.testing.assert_array_equal(engine[k], loop[k], err_msg=k)


def _multioutput(s):
    from importlib import import_module

    wrappers = import_module(f"{s.pkg.__name__}.wrappers")
    regression = import_module(f"{s.pkg.__name__}.regression")
    rng = np.random.RandomState(9)
    m = wrappers.MultioutputWrapper(regression.MeanSquaredError(**s.kw), num_outputs=3, remove_nans=False)
    for _ in range(2):
        m.update(s.arr(rng.rand(16, 3).astype(np.float32)), s.arr(rng.rand(16, 3).astype(np.float32)))
    return s.np(m.compute()), s.count("replica_dispatch"), [s.np(r.metric_state["sum_squared_error"])
                                                              for r in m.metrics]


def test_multioutput_wrapper_stacked_mode_equals_the_jax_package():
    ref_jax, port = side("jax"), side("torch")
    with ref_jax.fresh():
        ref = _multioutput(ref_jax)
    with port.fresh():
        got = _multioutput(port)
    assert ref[1] == got[1] == 3
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
    np.testing.assert_allclose(np.stack(got[2]), np.stack(ref[2]), rtol=1e-6)


def test_a_refused_replica_body_latches_the_loop_and_loses_nothing():
    from metrics_tpu_torch.wrappers import MultioutputWrapper

    port = side("torch")
    with port.fresh():
        m = MultioutputWrapper(port.custom("HostOnlyUpdate"), num_outputs=2, remove_nans=False)
        m.update(torch.tensor([[1.0, 5.0], [3.0, 2.0]]))
        m.update(torch.tensor([[4.0, 0.5], [0.0, 9.0]]))
        assert m._engine_failed and port.count("replica_fallback") == 1
        assert torch.equal(m.compute(), torch.tensor([4.0, 9.0]))
