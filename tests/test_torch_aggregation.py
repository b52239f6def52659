"""The port's aggregators against the JAX package's: every NaN strategy, weights,
the Neumaier mode, the running windows and the float64 regime.

Inputs come from seeded numpy and go through both packages. The values are
multiples of 2^-10 below 4 in magnitude and the weights multiples of 1/4, so
every float32 sum and product here is exact and both packages' sums come out
as if run in the same order, whatever order each runs them in; the compensated
mode's inputs sum two values per update, one rounding in any order. Values and
states agree within rtol 1e-6; kept samples (CatMetric), maxima and minima are
equal.
"""

from __future__ import annotations

import contextlib
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.aggregation as ja
import metrics_tpu_torch.aggregation as ta
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.wrappers import Running

RTOL = 1e-6
STRATEGIES = ["error", "warn", "ignore", "disable", 2.0, 0.0]
CLASSES = ["MaxMetric", "MinMetric", "SumMetric", "CatMetric", "MeanMetric"]


def _values(seed, n_batches=4, n=16, nan=True):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        x = (rng.randint(-4096, 4096, n) / 1024).astype(np.float32)
        if nan:
            x[rng.rand(n) < 0.2] = np.nan
        out.append(x)
    return out


def _close(port, ref, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port, dtype=np.float64), np.asarray(ref, dtype=np.float64), rtol=rtol)


def _same_states(port, ref, rtol=RTOL):
    for key, value in ref.metric_state.items():
        mine = port.metric_state[key]
        if isinstance(value, list):
            value = np.concatenate([np.atleast_1d(np.asarray(v)) for v in value]) if value else np.zeros(0)
            mine = torch.cat([torch.atleast_1d(v) for v in mine]).numpy() if mine else np.zeros(0)
        else:
            assert str(mine.dtype).replace("torch.", "") == str(np.asarray(value).dtype), key
        _close(mine, value, rtol)


def _run(name, kwargs, batches, weights=None):
    """Update a JAX and a port aggregator with the same batches; returns (port, ref, port value, ref value)."""
    ref = getattr(ja, name)(**kwargs)
    port = getattr(ta, name)(device="cpu", **kwargs)
    for i, x in enumerate(batches):
        extra_j = {} if weights is None else {"weight": jnp.asarray(weights[i])}
        extra_t = {} if weights is None else {"weight": torch.from_numpy(np.asarray(weights[i]))}
        ref.update(jnp.asarray(x), **extra_j)
        port.update(torch.from_numpy(x), **extra_t)
    return port, ref, port.compute(), ref.compute()


@contextlib.contextmanager
def _float64_regime():
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_default_dtype(previous)


# ----------------------------------------------------------------------------- NaN strategies
@pytest.mark.parametrize("name", CLASSES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_nan_strategy_matches_reference(name, strategy):
    batches = _values(1)
    kwargs = {"nan_strategy": strategy}
    if strategy == "error":
        ref, port = getattr(ja, name)(**kwargs), getattr(ta, name)(device="cpu", **kwargs)
        with pytest.raises(RuntimeError, match="Encountered `nan`"):
            ref.update(jnp.asarray(batches[0]))
        with pytest.raises(RuntimeError, match="Encountered `nan`"):
            port.update(torch.from_numpy(batches[0]))
        assert port.update_count == 0
        batches = _values(1, nan=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port, ref, got, want = _run(name, kwargs, batches)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(np.shape(want))
    _close(got, want)
    _same_states(port, ref)


@pytest.mark.parametrize("name", CLASSES)
def test_warn_strategy_warns_once_per_nan_batch(name):
    port = getattr(ta, name)(device="cpu")
    with pytest.warns(UserWarning, match="Encountered `nan`"):
        port.update(torch.tensor([1.0, float("nan")]))


def test_unknown_nan_strategy_raises_in_both():
    with pytest.raises(ValueError, match="nan_strategy"):
        ja.SumMetric(nan_strategy="drop")
    with pytest.raises(ValueError, match="nan_strategy"):
        ta.SumMetric(nan_strategy="drop", device="cpu")


# ----------------------------------------------------------------------------- weights
@pytest.mark.parametrize("strategy", ["warn", "ignore", "disable", 2.0, 0.0])
@pytest.mark.parametrize("weight_kind", ["scalar", "per_element", "nan_per_element", "nan_scalar"])
def test_mean_metric_weights_match_reference(strategy, weight_kind):
    rng = np.random.RandomState(3)
    batches = _values(4)
    if weight_kind == "scalar":
        weights = [np.float32(rng.randint(1, 9) / 4) for _ in batches]
    elif weight_kind == "nan_scalar":
        weights = [np.float32(np.nan) if i == 1 else np.float32(1.5) for i in range(len(batches))]
    else:
        weights = [(rng.randint(1, 9, 16) / 4).astype(np.float32) for _ in batches]
        if weight_kind == "nan_per_element":
            for w in weights:
                w[rng.rand(16) < 0.2] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port, ref, got, want = _run("MeanMetric", {"nan_strategy": strategy}, batches, weights)
    _close(got, want)
    _same_states(port, ref)


def test_scalar_weight_divergence_is_the_reference_s():
    """A float strategy replaces NaN values; a finite scalar weight stays as it is (the JAX package's
    documented divergence from its own reference, whose weights all take the replacement)."""
    x = np.array([1.0, np.nan, 3.0], dtype=np.float32)
    port, ref, got, want = _run("MeanMetric", {"nan_strategy": 0.0}, [x], [np.float32(2.0)])
    _close(got, want)
    _close(got, (1.0 * 2 + 0.0 * 2 + 3.0 * 2) / 6.0)


# ----------------------------------------------------------------------------- compensated mode
@pytest.mark.parametrize("name", ["SumMetric", "MeanMetric"])
def test_compensated_mode_matches_reference(name):
    rng = np.random.RandomState(5)
    # large and small magnitudes in turn: the residual state carries what float32 drops
    batches = [np.array([1e7 if i % 2 == 0 else -1e7, rng.rand()], dtype=np.float32) for i in range(16)]
    port, ref, got, want = _run(name, {"compensated": True}, batches)
    _close(got, want)
    _same_states(port, ref)
    comp = "sum_value_comp" if name == "SumMetric" else "mean_value_comp"
    assert port._precision[comp] == "compensated" == ref._precision[comp]


def test_compensated_sum_beats_the_plain_sum():
    rng = np.random.RandomState(6)
    values = (rng.rand(4000) * 1e-3).astype(np.float32)
    plain, comp = ta.SumMetric(device="cpu"), ta.SumMetric(compensated=True, device="cpu")
    plain.update(torch.tensor(1e4))
    comp.update(torch.tensor(1e4))
    for v in values:
        plain.update(torch.tensor(v))
        comp.update(torch.tensor(v))
    exact = 1e4 + float(np.sum(values.astype(np.float64)))
    assert abs(float(comp.compute()) - exact) < abs(float(plain.compute()) - exact)


# ----------------------------------------------------------------------------- running windows
@pytest.mark.parametrize("name", ["RunningMean", "RunningSum"])
@pytest.mark.parametrize("window", [1, 3, 5])
def test_running_matches_reference(name, window):
    batches = _values(7, n_batches=7, nan=False)
    ref, port = getattr(ja, name)(window=window), getattr(ta, name)(window=window, device="cpu")
    for x in batches:
        _close(port(torch.from_numpy(x)), ref(jnp.asarray(x)))
        _close(port.compute(), ref.compute())
    assert port.update_count == ref.update_count


def test_running_state_dict_round_trip():
    batches = _values(8, n_batches=4, nan=False)
    port = ta.RunningMean(window=2, device="cpu")
    port.persistent(True)
    for x in batches:
        port.update(torch.from_numpy(x))
    clone = ta.RunningMean(window=2, device="cpu")
    clone.persistent(True)
    clone.load_state_dict(port.state_dict())
    _close(clone.compute(), port.compute())
    clone.update(torch.from_numpy(batches[0]))
    port.update(torch.from_numpy(batches[0]))
    _close(clone.compute(), port.compute())


def test_running_refuses_full_state_update_base():
    with pytest.raises(ValueError, match="full_state_update"):
        Running(ta.MaxMetric(device="cpu"), window=2)


# ----------------------------------------------------------------------------- forward, merge, copies
@pytest.mark.parametrize("name", CLASSES)
def test_forward_matches_reference(name):
    batches = _values(9, nan=False)
    ref, port = getattr(ja, name)(), getattr(ta, name)(device="cpu")
    for x in batches:
        _close(port(torch.from_numpy(x)), ref(jnp.asarray(x)))
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize("name", ["SumMetric", "MeanMetric", "CatMetric"])
def test_merge_state_matches_reference(name):
    a, b = _values(10, nan=False), _values(11, nan=False)
    ref_a, ref_b = getattr(ja, name)(), getattr(ja, name)()
    port_a, port_b = getattr(ta, name)(device="cpu"), getattr(ta, name)(device="cpu")
    for x in a:
        ref_a.update(jnp.asarray(x))
        port_a.update(torch.from_numpy(x))
    for x in b:
        ref_b.update(jnp.asarray(x))
        port_b.update(torch.from_numpy(x))
    ref_a.merge_state(ref_b)
    port_a.merge_state(port_b)
    _close(port_a.compute(), ref_a.compute())
    assert port_a.update_count == ref_a.update_count


def test_max_metric_refuses_merge_state_as_reference():
    with pytest.raises(RuntimeError, match="full_state_update"):
        ja.MaxMetric().merge_state(ja.MaxMetric())
    with pytest.raises(RuntimeError, match="full_state_update"):
        ta.MaxMetric(device="cpu").merge_state(ta.MaxMetric(device="cpu"))


@pytest.mark.parametrize("name", CLASSES)
def test_clone_and_pickle_keep_the_state(name):
    port = getattr(ta, name)(device="cpu")
    for x in _values(12, nan=False):
        port.update(torch.from_numpy(x))
    for copy in (port.clone(), pickle.loads(pickle.dumps(port))):
        _close(copy.compute(), port.compute())
        copy.update(torch.ones(3))
        assert copy.update_count == port.update_count + 1
    assert port.update_count == 4


def test_merge_associative_is_inferred():
    assert ta.SumMetric(device="cpu")._merge_associative == {"sum_value": True}
    assert ta.CatMetric(device="cpu")._merge_associative == {"value": False}
    assert ja.CatMetric()._merge_associative == {"value": False}


# ----------------------------------------------------------------------------- float64 regime
@pytest.mark.parametrize("name", CLASSES)
def test_float64_regime_matches_reference(name):
    batches = _values(13, nan=False)
    with _float64_regime():
        port, ref, got, want = _run(name, {}, batches)
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        _close(got, want)
        _same_states(port, ref)


@pytest.mark.parametrize("name", ["SumMetric", "MeanMetric"])
def test_float64_regime_compensated_matches_reference(name):
    batches = _values(14, nan=False)
    with _float64_regime():
        port, ref, got, want = _run(name, {"compensated": True}, batches)
        _close(got, want)
        _same_states(port, ref)


@pytest.mark.parametrize("move", ["float", "double", "half"])
def test_dtype_moves_match_reference(move):
    # the JAX package holds float64 only under x64; PyTorch always can
    with jax.enable_x64(move == "double"):
        port, ref = ta.MeanMetric(device="cpu"), ja.MeanMetric()
        getattr(port, move)()
        getattr(ref, move)()
        assert str(port.mean_value.dtype).replace("torch.", "") == str(ref.mean_value.dtype)
    assert port.dtype == port.mean_value.dtype


def test_neumaier_helpers_match_reference():
    from metrics_tpu.utils import compute as jcompute
    from metrics_tpu_torch.utils import compute as tcompute

    rng = np.random.RandomState(16)
    total_t, comp_t = torch.tensor(0.0), torch.tensor(0.0)
    total_j, comp_j = jnp.asarray(0.0), jnp.asarray(0.0)
    for v in (rng.randn(50) * 10.0 ** rng.randint(-3, 8, 50)).astype(np.float32):
        total_t, comp_t = tcompute.neumaier_add(total_t, comp_t, torch.tensor(v))
        total_j, comp_j = jcompute.neumaier_add(total_j, comp_j, jnp.asarray(v))
    assert float(total_t) == float(total_j) and float(comp_t) == float(comp_j)
    assert float(tcompute.neumaier_value(total_t, comp_t)) == float(jcompute.neumaier_value(total_j, comp_j))
    assert tcompute.count_dtype() == torch.int64
    assert tcompute.acc_dtype() == torch.float32 and str(jcompute.acc_dtype()) == "float32"


# ----------------------------------------------------------------------------- state carried across
@pytest.mark.parametrize(("name", "kwargs"), [("SumMetric", {"compensated": True}),
                                              ("MeanMetric", {"compensated": True}), ("MeanMetric", {}),
                                              ("CatMetric", {}), ("MaxMetric", {})])
def test_reference_state_loads_into_the_port(name, kwargs):
    batches = _values(15, nan=False)
    ref = getattr(ja, name)(**kwargs)
    for x in batches[:2]:
        ref.update(jnp.asarray(x))
    ref.persistent(True)
    port = load_reference_state(getattr(ta, name)(device="cpu", **kwargs), ref.state_dict())
    for x in batches[2:]:
        ref.update(jnp.asarray(x))
        port.update(torch.from_numpy(x))
    _close(port.compute(), ref.compute())
    _same_states(port, ref)
