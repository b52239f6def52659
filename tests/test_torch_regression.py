"""The port's MSE, MAE, Pearson and Spearman against the JAX package's.

The same seeded numpy inputs go through both packages, functional and class,
one and several outputs, and states carried across through ``interop``.
Counts must be equal; MSE and MAE within rtol 1e-5 (float32 sums over up to
a few hundred samples, in another order); Pearson's moments and both
correlations within rtol 1e-4, the tolerance the JAX package's own
multi-chip dryrun holds them to.
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
import metrics_tpu.regression as jr
import metrics_tpu_torch.functional.regression as tf
import metrics_tpu_torch.regression as tr
from metrics_tpu.functional.regression.pearson import _final_aggregation as ref_fold
from metrics_tpu.functional.regression.spearman import _rank_data as ref_rank
from metrics_tpu_torch.functional.regression.pearson import _final_aggregation as port_fold
from metrics_tpu_torch.functional.regression.spearman import _rank_data as port_rank
from metrics_tpu_torch.interop import load_reference_state

SUM_RTOL, CORR_RTOL = 1e-5, 1e-4
RTOL = {"MeanSquaredError": SUM_RTOL, "MeanAbsoluteError": SUM_RTOL, "PearsonCorrCoef": CORR_RTOL,
        "SpearmanCorrCoef": CORR_RTOL}


def _close(port, ref, rtol):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=rtol, atol=1e-7)


def _pairs(seed, n=200, outputs=1, ties=False, n_batches=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        shape = (n,) if outputs == 1 else (n, outputs)
        y = rng.randn(*shape).astype(np.float32)
        x = (0.8 * y + 0.4 * rng.randn(*shape)).astype(np.float32)
        if ties:
            x, y = np.round(x, 1), np.round(y, 1)
        out.append((x, y))
    return out


@pytest.mark.parametrize(("fn", "kwargs"), [("mean_squared_error", {}), ("mean_squared_error", {"squared": False}),
                                            ("mean_absolute_error", {}), ("pearson_corrcoef", {}),
                                            ("spearman_corrcoef", {})])
@pytest.mark.parametrize("outputs", [1, 3])
def test_functional_matches_reference(fn, kwargs, outputs):
    x, y = _pairs(1, outputs=outputs)[0]
    extra = {"num_outputs": outputs} if fn.startswith("mean") else {}
    got = getattr(tf, fn)(torch.from_numpy(x), torch.from_numpy(y), **kwargs, **extra)
    want = getattr(jf, fn)(jnp.asarray(x), jnp.asarray(y), **kwargs, **extra)
    assert got.dtype == torch.float32
    _close(got, want, SUM_RTOL if fn.startswith("mean") else CORR_RTOL)


@pytest.mark.parametrize("name", sorted(RTOL))
@pytest.mark.parametrize("outputs", [1, 2])
@pytest.mark.parametrize("ties", [False, True])
def test_class_matches_reference(name, outputs, ties):
    kwargs = {"num_outputs": outputs}
    port, ref = getattr(tr, name)(device="cpu", **kwargs), getattr(jr, name)(**kwargs)
    for x, y in _pairs(2, outputs=outputs, ties=ties):
        port.update(torch.from_numpy(x), torch.from_numpy(y))
        ref.update(jnp.asarray(x), jnp.asarray(y))
    for key, value in ref.metric_state.items():
        mine = port.metric_state[key]
        if isinstance(value, list):
            mine, value = torch.cat(mine), np.concatenate([np.asarray(v) for v in value])
        if np.asarray(value).dtype.kind == "i":
            assert mine.dtype == torch.int64
            np.testing.assert_array_equal(mine.numpy(), np.asarray(value))
        else:
            _close(mine, value, RTOL[name])
    _close(port.compute(), ref.compute(), RTOL[name])


@pytest.mark.parametrize("name", sorted(RTOL))
def test_forward_matches_reference(name):
    port, ref = getattr(tr, name)(device="cpu"), getattr(jr, name)()
    for x, y in _pairs(3):
        _close(port(torch.from_numpy(x), torch.from_numpy(y)), ref(jnp.asarray(x), jnp.asarray(y)), RTOL[name])
    _close(port.compute(), ref.compute(), RTOL[name])


def test_rmse_as_a_compositional_metric():
    port, ref = tr.MeanSquaredError(device="cpu") ** 0.5, jr.MeanSquaredError() ** 0.5
    direct = tr.MeanSquaredError(squared=False, device="cpu")
    for x, y in _pairs(4):
        for metric, conv in ((port, torch.from_numpy), (ref, jnp.asarray), (direct, torch.from_numpy)):
            metric.update(conv(x), conv(y))
    _close(port.compute(), ref.compute(), SUM_RTOL)
    _close(port.compute(), direct.compute(), SUM_RTOL)


@pytest.mark.parametrize("ties", [False, True])
def test_rank_data_matches_reference(ties):
    rng = np.random.RandomState(5)
    data = rng.randint(0, 20, 300).astype(np.float32) if ties else rng.randn(300).astype(np.float32)
    np.testing.assert_array_equal(port_rank(torch.from_numpy(data)).numpy(), np.asarray(ref_rank(jnp.asarray(data))))


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_pearson_fold_matches_reference(ranks):
    rng = np.random.RandomState(6)
    stacks = [rng.randn(ranks).astype(np.float32) for _ in range(5)] + [
        rng.randint(5, 50, ranks).astype(np.float32)]
    got = port_fold(*[torch.from_numpy(s) for s in stacks])
    want = ref_fold(*[jnp.asarray(s) for s in stacks])
    for g, w in zip(got, want):
        _close(g, w, CORR_RTOL)


def test_pearson_merged_shards_equal_the_single_stream():
    batches = _pairs(7, n_batches=4)
    shards = [tr.PearsonCorrCoef(device="cpu") for _ in range(4)]
    whole = tr.PearsonCorrCoef(device="cpu")
    for metric, (x, y) in zip(shards, batches):
        metric.update(torch.from_numpy(x), torch.from_numpy(y))
        whole.update(torch.from_numpy(x), torch.from_numpy(y))
    stacked = {k: torch.stack([m.metric_state[k] for m in shards]) for k in whole.metric_state}
    shards[0].load_merged_state(stacked, update_count=4)
    _close(shards[0].compute(), whole.compute(), CORR_RTOL)


def test_argument_errors_match_reference():
    for package in (tr, jr):
        kw = {"device": "cpu"} if package is tr else {}
        with pytest.raises(ValueError, match="squared"):
            package.MeanSquaredError(squared=1, **kw)
        with pytest.raises(ValueError, match="num_outputs"):
            package.MeanAbsoluteError(num_outputs=0, **kw)
        with pytest.raises(ValueError, match="num_outputs"):
            package.PearsonCorrCoef(num_outputs=0, **kw)
    x, y = _pairs(8, outputs=3)[0]  # three outputs into a one-output metric
    with pytest.raises(ValueError, match="num_outputs"):
        tr.PearsonCorrCoef(device="cpu").update(torch.from_numpy(x), torch.from_numpy(y))
    with pytest.raises(ValueError, match="num_outputs"):
        jr.PearsonCorrCoef().update(jnp.asarray(x), jnp.asarray(y))
    for fn, conv in ((tf.spearman_corrcoef, torch.from_numpy), (jf.spearman_corrcoef, jnp.asarray)):
        with pytest.raises(TypeError, match="floating point"):
            fn(conv(np.arange(4)), conv(np.arange(4)))


def test_near_zero_variance_warns_in_both():
    x = np.ones(10, dtype=np.float32)
    y = np.arange(10, dtype=np.float32)
    with pytest.warns(UserWarning, match="variance"):
        got = tf.pearson_corrcoef(torch.from_numpy(x), torch.from_numpy(y))
    with pytest.warns(UserWarning, match="variance"):
        want = jf.pearson_corrcoef(jnp.asarray(x), jnp.asarray(y))
    _close(got, want, CORR_RTOL)


@contextlib.contextmanager
def _float64_regime():
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_default_dtype(previous)


@pytest.mark.parametrize("name", sorted(RTOL))
def test_float64_regime_matches_reference(name):
    with _float64_regime():
        port, ref = getattr(tr, name)(device="cpu"), getattr(jr, name)()
        for x, y in _pairs(9):
            port.update(torch.from_numpy(x), torch.from_numpy(y))
            ref.update(jnp.asarray(x), jnp.asarray(y))
        got, want = port.compute(), ref.compute()
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        _close(got, want, RTOL[name])


@pytest.mark.parametrize("name", sorted(RTOL))
def test_reference_state_loads_into_the_port(name):
    port, ref = getattr(tr, name)(device="cpu"), getattr(jr, name)()
    batches = _pairs(10)
    for x, y in batches[:2]:
        ref.update(jnp.asarray(x), jnp.asarray(y))
    ref.persistent(True)
    load_reference_state(port, ref.state_dict())
    x, y = batches[2]
    ref.update(jnp.asarray(x), jnp.asarray(y))
    port.update(torch.from_numpy(x), torch.from_numpy(y))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _close(port.compute(), ref.compute(), RTOL[name])


def test_exports():
    assert {"MeanAbsoluteError", "MeanSquaredError", "PearsonCorrCoef", "SpearmanCorrCoef"} <= set(tr.__all__)
    assert tr.__all__ == jr.__all__  # the whole domain is ported
    assert set(tf.__all__) <= set(jf.__all__)
    assert set(tr.__all__) <= set(jr.__all__)
