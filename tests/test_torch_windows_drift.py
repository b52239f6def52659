"""The port's time windows, decay operations and drift detectors against the JAX package's.

The same seeded numpy inputs, with timestamps out of order, late batches and
pane and bin edges, go through both packages. Bit-equal: the decay weights
(the JAX package's CPU ``exp2``, in the form its eager calls and its
compiled updates each take), pane ids at pane edges, drift bins at and next
to each bin edge, the decayed sketches' states (its compiled update fuses
``state * w_old + add`` into one rounding, which the port reproduces). Within
rtol 1e-5: the states whose base metric sums a batch of floats
(``TimeDecayed``, ``TumblingWindow``: float32 sums taken in another order),
CUSUM's prefix sums, and the scores. The validation errors must carry the
JAX package's messages, ``MeanMetric()`` with its default ``nan_strategy``
among them. ``sync()`` is held to the JAX package's per-state reductions,
which add ``TimeDecayed`` states anchored at different times without decay
and stack CUSUM's states (ROADMAP, reference caveats); ``merge_state``
decays and composes.

The second half mirrors the JAX package's ``test_windows`` and
``test_drift`` on the port, beside the engine and registry sweeps, which have
no port yet.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.drift as jd
import metrics_tpu.ops.decay as jops
import metrics_tpu.parallel.sync as jsync
import metrics_tpu.windows as jw
import metrics_tpu_torch as tm
import metrics_tpu_torch.drift as td
import metrics_tpu_torch.ops.decay as tops
import metrics_tpu_torch.parallel as tsync
import metrics_tpu_torch.windows as tw
from metrics_tpu.utils.exceptions import TPUMetricsUserError as RefUserError
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError

RTOL = 1e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(port, ref):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    if ref.dtype.kind == "f":
        np.testing.assert_array_equal(port.astype(ref.dtype).view(f"u{ref.itemsize}"), ref.view(f"u{ref.itemsize}"))
    else:
        np.testing.assert_array_equal(port.astype(np.int64), ref.astype(np.int64))


def _close(port, ref, rtol=RTOL, atol=1e-6):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=rtol, atol=atol)


# ----------------------------------------------------------------------------- ops/decay
STAMPS = np.random.RandomState(0).rand(5000).astype(np.float32) * 3600


@pytest.mark.parametrize("half_life", [300.0, 7.0, 0.37, 1.0, 1e30])
def test_decay_weights_are_bit_equal_in_both_forms(half_life):
    last_t, t = STAMPS, np.roll(STAMPS, 1)
    t[:5] = last_t[:5]  # equal timestamps: no decay
    got = tops.decay_weights(torch.from_numpy(last_t), torch.from_numpy(t), half_life)
    want = jops.decay_weights(jnp.asarray(last_t), jnp.asarray(t), half_life)
    for g, w in zip(got, want):
        _equal(g, w)
    got = tops._decay_weights_compiled(torch.from_numpy(last_t), torch.from_numpy(t), half_life)
    want = jax.jit(lambda a, b: jops.decay_weights(a, b, half_life))(jnp.asarray(last_t), jnp.asarray(t))
    for g, w in zip(got, want):
        _equal(g, w)


def test_decay_weights_underflow_to_zero_and_take_python_numbers():
    ref, w_old, w_new = tops.decay_weights(torch.tensor(0.0), 1e4, 1.0)
    assert float(ref) == 1e4 and float(w_old) == 0.0 and float(w_new) == 1.0
    _equal(tops.decay_weights(0.0, 5.0, 3.0)[1], jops.decay_weights(0.0, 5.0, 3.0)[1])


def test_exp_and_exp2_are_the_reference_backends():
    x = (np.random.RandomState(1).randn(200_000) * 40).astype(np.float32)
    _equal(tops._exp_f32(torch.from_numpy(x)), jnp.exp(jnp.asarray(x)))
    _equal(tops._exp2_f32(torch.from_numpy(x)), jnp.exp2(jnp.asarray(x)))


@pytest.mark.parametrize("pane_s", [0.7, 60.0, 0.1, 3.7])
def test_pane_ids_equal_at_pane_edges(pane_s):
    edges = (np.arange(3000, dtype=np.float32) * np.float32(pane_s)).astype(np.float32)
    t = np.concatenate([STAMPS, edges, np.nextafter(edges, np.float32(1e9)), np.nextafter(edges[1:], np.float32(0))])
    got = tops.pane_id(torch.from_numpy(t), pane_s)
    want = jax.jit(lambda x: jops.pane_id(x, pane_s))(jnp.asarray(t))
    assert got.dtype == torch.int32
    _equal(got, want)
    for cur in (0, 5, 61, 119):
        _equal(tops.pane_slot_onehot(torch.tensor(cur, dtype=torch.int32), 60), jops.pane_slot_onehot(cur, 60))


def test_cusum_segment_compose_and_decayed_hll_estimate_match():
    rng = np.random.RandomState(2)
    y, ok = rng.randn(500).astype(np.float32), rng.rand(500) > 0.1
    seg_t = tops.cusum_segment(torch.from_numpy(y), torch.from_numpy(ok))
    seg_j = jops.cusum_segment(jnp.asarray(y), jnp.asarray(ok))
    _close(seg_t, seg_j)
    other = rng.randn(3, 4).astype(np.float32)
    _close(tops.cusum_compose(seg_t.expand(3, 4), torch.from_numpy(other)), jops.cusum_compose(seg_j, jnp.asarray(other)))
    for scale in (0.01, 0.4, 3.0, 25.0):
        regs = (rng.randint(0, 20, 4096) * scale).astype(np.float32)
        _close(tops.decayed_hll_estimate(torch.from_numpy(regs)), jops.decayed_hll_estimate(jnp.asarray(regs)), 1e-6)


# ----------------------------------------------------------------------------- the classes
def _stream(kind, seed, n=8):
    """(t, value) updates with timestamps out of order, repeated, and late by up to two panes of 1 s."""
    rng = np.random.RandomState(seed)
    stamps = np.cumsum(rng.rand(n) * 0.8)
    stamps[2] = stamps[1]
    if n > 5:
        stamps[5] = max(stamps[4] - 1.7, 0.0)
    out = []
    for t in stamps.astype(np.float32):
        v = rng.lognormal(0, 1, 64).astype(np.float32)
        if kind == "DecayedHLL":
            v = rng.randint(0, 300, 64).astype(np.float32)
        out.append((t, v))
    return out


WINDOWS = {
    "TimeDecayed[Mean]": (lambda p: p["TimeDecayed"](p["MeanMetric"](nan_strategy="disable", **p["kw"]), half_life_s=2.0),
                          RTOL),
    "TimeDecayed[Sum, compensated]": (lambda p: p["TimeDecayed"](p["SumMetric"](nan_strategy="disable", **p["kw"]),
                                                                  half_life_s=2.0, compensated=True), RTOL),
    "TumblingWindow[Sum]": (lambda p: p["TumblingWindow"](p["SumMetric"](nan_strategy="disable", **p["kw"]), pane_s=1.0,
                                                          n_panes=3), RTOL),
    "TumblingWindow[Mean]": (lambda p: p["TumblingWindow"](p["MeanMetric"](nan_strategy="disable", **p["kw"]),
                                                           pane_s=0.7, n_panes=4), RTOL),
    "DecayedDDSketch": (lambda p: p["DecayedDDSketch"](half_life_s=1.5, num_buckets=256, **p["kw"]), 0.0),
    "DecayedHLL": (lambda p: p["DecayedHLL"](half_life_s=1.5, p=6, **p["kw"]), 0.0),
}
PORT = {"TimeDecayed": tw.TimeDecayed, "TumblingWindow": tw.TumblingWindow, "DecayedDDSketch": tw.DecayedDDSketch,
        "DecayedHLL": tw.DecayedHLL, "MeanMetric": tm.MeanMetric, "SumMetric": tm.SumMetric, "kw": {"device": "cpu"}}
REF = {"TimeDecayed": jw.TimeDecayed, "TumblingWindow": jw.TumblingWindow, "DecayedDDSketch": jw.DecayedDDSketch,
       "DecayedHLL": jw.DecayedHLL, "MeanMetric": jm.MeanMetric, "SumMetric": jm.SumMetric, "kw": {}}


def _window_pair(name):
    make, _ = WINDOWS[name]
    return make(PORT), make(REF)


def _check_states(port, ref, rtol):
    for key, value in ref.metric_state.items():
        if rtol == 0.0 or _np(value).dtype.kind != "f":
            _equal(port.metric_state[key], value)
        elif key.endswith("_comp"):  # a residual is rounding noise: hold the compensated sum instead
            base = key[: -len("_comp")]
            _close(port.metric_state[base] + port.metric_state[key], _np(ref.metric_state[base]) + _np(value), rtol)
        else:
            _close(port.metric_state[key], value, rtol)


@pytest.mark.parametrize("name", list(WINDOWS))
def test_window_update_compute_merge_forward_reset_match_reference(name):
    _, rtol = WINDOWS[name]
    port, ref = _window_pair(name)
    port_f, ref_f = _window_pair(name)
    kind = name.split("[")[0]
    for t, v in _stream(kind, 1):
        port.update(float(t), torch.from_numpy(v))
        ref.update(jnp.float32(t), jnp.asarray(v))
        _close(port_f(float(t), torch.from_numpy(v)), ref_f(jnp.float32(t), jnp.asarray(v)), max(rtol, 1e-6))
    _check_states(port, ref, rtol)
    _check_states(port_f, ref_f, max(rtol, 1e-6))
    _close(port.compute(), ref.compute(), max(rtol, 1e-6))
    other_t, other_j = _window_pair(name)
    for t, v in _stream(kind, 2, n=4):
        other_t.update(float(t) + 0.3, torch.from_numpy(v))
        other_j.update(jnp.float32(t + 0.3), jnp.asarray(v))
    port.merge_state(other_t)
    ref.merge_state(other_j)
    _check_states(port, ref, max(rtol, 1e-6))
    _close(port.compute(), ref.compute(), max(rtol, 1e-6))
    port.reset()
    ref.reset()
    _check_states(port, ref, 0.0)


DRIFT = {
    "PSI": (lambda m, kw: m.PSI(lo=-2.0, hi=3.3, num_bins=16, **kw)),
    "KSDistance": (lambda m, kw: m.KSDistance(lo=0.0, hi=7.0, num_bins=7, **kw)),
    "CUSUM": (lambda m, kw: m.CUSUM(target=0.2, k=0.1, h=2.0, **kw)),
}


def _drift_batches(name, seed, n=4):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if name == "CUSUM":
            v = (rng.randn(100) * 0.5 + (0.8 if i >= 2 else 0.2)).astype(np.float32)
            v[::17] = np.nan
            out.append((v,))
            continue
        lo, hi, bins = (-2.0, 3.3, 16) if name == "PSI" else (0.0, 7.0, 7)
        edges = (np.float32(lo) + np.arange(bins + 1, dtype=np.float32) * np.float32((hi - lo) / bins)).astype(np.float32)
        live = np.concatenate([rng.randn(200) * 2, edges, np.nextafter(edges, np.float32(1e9)),
                               np.nextafter(edges, np.float32(-1e9)), [np.nan, np.inf, -np.inf, 1e10, -1e10]])
        ref = rng.randn(150) * 2 + 0.5 if i != 1 else np.zeros(0)
        out.append((live.astype(np.float32), ref.astype(np.float32)))
    return out


@pytest.mark.parametrize("name", list(DRIFT))
def test_drift_update_compute_merge_forward_reset_match_reference(name):
    make = DRIFT[name]
    rtol = 1e-5 if name == "CUSUM" else 0.0
    port, ref, port_f, ref_f = make(td, {"device": "cpu"}), make(jd, {}), make(td, {"device": "cpu"}), make(jd, {})
    for batch in _drift_batches(name, 1):
        port.update(*(torch.from_numpy(x) for x in batch))
        ref.update(*(jnp.asarray(x) for x in batch))
        _close(port_f(*(torch.from_numpy(x) for x in batch)), ref_f(*(jnp.asarray(x) for x in batch)))
    _check_states(port, ref, rtol)
    _check_states(port_f, ref_f, rtol)
    _close(port.compute(), ref.compute())
    other_t, other_j = make(td, {"device": "cpu"}), make(jd, {})
    for batch in _drift_batches(name, 2, n=2):
        other_t.update(*(torch.from_numpy(x) for x in batch))
        other_j.update(*(jnp.asarray(x) for x in batch))
    port.merge_state(other_t)  # incoming first: for CUSUM the other stream is the earlier one
    ref.merge_state(other_j)
    _check_states(port, ref, rtol)
    _close(port.compute(), ref.compute())
    port.reset()
    ref.reset()
    _check_states(port, ref, 0.0)


def test_drift_bins_wrap_huge_values_into_underflow_as_reference():
    """The reference caveat: a bin number at or above 2^31 wraps, in the JAX package's int32, into the
    underflow bin; the port counts the same way."""
    v = np.array([1e10, -1e10, 3e38, 2147483520.0, 0.5], np.float32)
    got = td.PSI(lo=0.0, hi=1.0, num_bins=1, device="cpu")
    want = jd.PSI(lo=0.0, hi=1.0, num_bins=1)
    got.update(torch.from_numpy(v), torch.zeros(0))
    want.update(jnp.asarray(v), jnp.zeros(0))
    _equal(got.live_counts, want.live_counts)
    assert got.live_counts.tolist() == [3.0, 1.0, 1.0]


@pytest.mark.parametrize("name", list(WINDOWS) + list(DRIFT))
def test_reference_stream_resumes_in_the_port(name):
    """A stream started in the JAX package (its stacked panes with ``pane_ids``, the CUSUM summaries, the decayed
    states with ``last_t``) goes on in the port and gives the single stream's answer."""
    if name in DRIFT:
        port, ref, single = DRIFT[name](td, {"device": "cpu"}), DRIFT[name](jd, {}), DRIFT[name](td, {"device": "cpu"})
        batches = [tuple(torch.from_numpy(x) for x in b) for b in _drift_batches(name, 3)]
        jbatches = [tuple(jnp.asarray(x.numpy()) for x in b) for b in batches]
    else:
        (port, ref), (single, _) = _window_pair(name), _window_pair(name)
        stream = _stream(name.split("[")[0], 3)
        batches = [(float(t), torch.from_numpy(v)) for t, v in stream]
        jbatches = [(jnp.float32(t), jnp.asarray(v)) for t, v in stream]
    for batch in jbatches[:3]:
        ref.update(*batch)
    ref.persistent(True)
    load_reference_state(port, ref.state_dict())
    for batch in batches:
        single.update(*batch)
    for batch in batches[3:]:
        port.update(*batch)
    assert port.update_count == single.update_count
    _close(port.compute(), single.compute(), 1e-5)


# ----------------------------------------------------------------------------- validation
def _ref_last_t_init(self):
    jm.SumMetric.__init__(self, nan_strategy="disable")
    self.add_state("last_t", jnp.zeros(()), dist_reduce_fx="sum")


def _port_last_t_init(self):
    tm.SumMetric.__init__(self, nan_strategy="disable", device="cpu")
    self.add_state("last_t", torch.zeros(()), dist_reduce_fx="sum")


# a sum metric that registers `last_t`, one class of the same name in each package
_RefLastT = type("LastTSum", (jm.SumMetric,), {"__init__": _ref_last_t_init})
_PortLastT = type("LastTSum", (tm.SumMetric,), {"__init__": _port_last_t_init})


def _bases(package):
    j = package is jm
    kw = {} if j else {"device": "cpu"}
    seg = __import__("metrics_tpu.segmentation" if j else "metrics_tpu_torch.segmentation", fromlist=["x"])
    sk = __import__("metrics_tpu.sketches" if j else "metrics_tpu_torch.sketches", fromlist=["x"])
    return {
        "not a metric": "SumMetric",
        "jit-ineligible": seg.HausdorffDistance(num_classes=3, **kw),
        "list state": package.CatMetric(nan_strategy="disable", **kw),
        "nan_strategy warn": package.SumMetric(nan_strategy="warn", **kw),
        "nan_strategy error": package.SumMetric(nan_strategy="error", **kw),
        "MeanMetric()": package.MeanMetric(**kw),
        "full state": package.MaxMetric(nan_strategy="disable", **kw),
        "not sum": sk.HyperLogLog(p=6, **kw),
        "reserved last_t": _RefLastT() if j else _PortLastT(),
    }


CASES = ["not a metric", "jit-ineligible", "list state", "nan_strategy warn", "nan_strategy error", "MeanMetric()",
         "full state", "not sum"]


@pytest.mark.parametrize(("wrapper", "case"), [("TimeDecayed", c) for c in CASES + ["reserved last_t"]]
                         + [("TumblingWindow", c) for c in CASES])
def test_wrapper_validation_messages_match_reference(wrapper, case):
    port_base, ref_base = _bases(tm)[case], _bases(jm)[case]
    args = {"TimeDecayed": {"half_life_s": 1.0}, "TumblingWindow": {"pane_s": 1.0, "n_panes": 2}}[wrapper]
    with pytest.raises(RefUserError) as ref_err:
        getattr(jw, wrapper)(ref_base, **args)
    with pytest.raises(TPUMetricsUserError) as port_err:
        getattr(tw, wrapper)(port_base, device="cpu", **args)
    assert str(port_err.value) == str(ref_err.value)


def test_tumbling_window_reserves_pane_ids_as_reference():
    class RefPanes(jm.SumMetric):
        def __init__(self):
            super().__init__(nan_strategy="disable")
            self.add_state("pane_ids", jnp.zeros(()), dist_reduce_fx="sum")

    class PortPanes(tm.SumMetric):
        def __init__(self):
            super().__init__(nan_strategy="disable", device="cpu")
            self.add_state("pane_ids", torch.zeros(()), dist_reduce_fx="sum")

    with pytest.raises(RefUserError) as ref_err:
        jw.TumblingWindow(RefPanes(), pane_s=1.0, n_panes=2)
    with pytest.raises(TPUMetricsUserError) as port_err:
        tw.TumblingWindow(PortPanes(), pane_s=1.0, n_panes=2)
    assert str(port_err.value) == str(ref_err.value).replace("RefPanes", "PortPanes")


@pytest.mark.parametrize(("make", "match"), [
    (lambda p, b: p["TimeDecayed"](b, half_life_s=0.0), "half_life_s"),
    (lambda p, b: p["TumblingWindow"](b, pane_s=0.0, n_panes=2), "pane_s"),
    (lambda p, b: p["TumblingWindow"](b, pane_s=1.0, n_panes=0), "n_panes"),
    (lambda p, b: p["DecayedHLL"](half_life_s=-1.0, **p["kw"]), "half_life_s"),
    (lambda p, b: p["DecayedHLL"](half_life_s=1.0, p=19, **p["kw"]), r"\[4, 18\]"),
    (lambda p, b: p["DecayedDDSketch"](half_life_s=0.0, **p["kw"]), "half_life_s"),
    (lambda p, b: p["DecayedDDSketch"](half_life_s=1.0, num_buckets=1, **p["kw"]), "num_buckets"),
])
def test_bad_hyperparameters_raise_as_reference(make, match):
    for pkg in (PORT, REF):
        base = pkg["SumMetric"](nan_strategy="disable", **pkg["kw"])
        with pytest.raises(ValueError, match=match):
            make(pkg, base)


def test_decayed_hll_accepts_p_up_to_18_and_its_update_refuses_above_16_as_reference():
    """The reference caveat: construction takes p in [4, 18], ``hll_delta`` refuses p > 16 at the update."""
    for make, t, v in ((lambda: tw.DecayedHLL(half_life_s=1.0, p=18, device="cpu"), 0.0, torch.ones(3)),
                       (lambda: jw.DecayedHLL(half_life_s=1.0, p=18), jnp.float32(0.0), jnp.ones(3))):
        m = make()
        assert m.registers.shape == (1 << 18,)
        with pytest.raises(ValueError, match=r"\[4, 16\]"):
            m.update(t, v)


@contextlib.contextmanager
def _float64_regime():
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_default_dtype(previous)


@pytest.mark.parametrize("compensated", [False, True])
def test_time_decayed_float64_regime_matches_reference(compensated):
    """The JAX package's x64 parity, through ``jax.enable_x64(True)``: the states follow the default float type,
    the answer does not move."""
    with _float64_regime():
        port = tw.TimeDecayed(tm.SumMetric(nan_strategy="disable", device="cpu"), half_life_s=10.0,
                              compensated=compensated)
        ref = jw.TimeDecayed(jm.SumMetric(nan_strategy="disable"), half_life_s=10.0, compensated=compensated)
        for t, v in ((0.0, 1.0), (10.0, 1.0), (4.0, 2.5)):
            port.update(t, torch.tensor(v, dtype=torch.float32))
            ref.update(jnp.float32(t), jnp.asarray(v, jnp.float32))
        for key, value in ref.metric_state.items():
            assert str(port.metric_state[key].dtype).replace("torch.", "") == str(value.dtype), key
        _check_states(port, ref, 1e-12)
        _close(port.compute(), ref.compute(), 1e-12)
    assert float(port.compute()) == pytest.approx(1.5 + 2.5 * 2 ** -0.6, rel=1e-6)


# ----------------------------------------------------------------------------- sync
def _fake_sync(peers, as_array):
    def sync_fn(states, group):
        return [[local] + [as_array(_np(list(p.values())[i])) for p in peers] for i, local in enumerate(states)]
    return sync_fn


SYNCED = ["TimeDecayed[Mean]", "TumblingWindow[Sum]", "DecayedDDSketch", "DecayedHLL", "PSI", "CUSUM"]


def _fed_pair(name, seed, shift=0.0):
    if name in DRIFT:
        port, ref = DRIFT[name](td, {"device": "cpu"}), DRIFT[name](jd, {})
        for batch in _drift_batches(name, seed, n=2):
            port.update(*(torch.from_numpy(x) for x in batch))
            ref.update(*(jnp.asarray(x) for x in batch))
        return port, ref
    port, ref = _window_pair(name)
    for t, v in _stream(name.split("[")[0], seed, n=3):
        port.update(float(t) + shift, torch.from_numpy(v))
        ref.update(jnp.float32(t + shift), jnp.asarray(v))
    return port, ref


@pytest.mark.parametrize("name", SYNCED)
def test_sync_follows_the_reference_per_state_reductions(name):
    """``sync()`` applies each state's declared reduction, as the JAX package's does: the windows' states
    anchored at different ``last_t`` are added without decay and CUSUM's are stacked (reference caveats);
    the port must give the JAX package's states, and ``allreduce_over_mesh`` its 8-device mesh's."""
    port, ref = _fed_pair(name, 1)
    peers = [_fed_pair(name, seed, shift=1.5 * seed) for seed in (2, 3, 4)]
    peers_t = [dict(p.metric_state) for p, _ in peers]
    peers_j = [dict(r.metric_state) for _, r in peers]
    local = dict(port.metric_state)
    port.sync(dist_sync_fn=_fake_sync(peers_t, torch.from_numpy), distributed_available=True)
    ref.sync(dist_sync_fn=_fake_sync(peers_j, jnp.asarray), distributed_available=True)
    _check_states(port, ref, 1e-5)
    _close(port._compute_impl(), ref._compute_impl(), 1e-5)
    if name == "CUSUM":  # the stacked states: compute() reads ranks as fields, in both packages
        assert port.pos.shape == ref.pos.shape == (4, 4) and port._compute_impl().shape == (3, 4)
    port.unsync()
    states_t = [dict(local)] + peers_t
    got = tsync.allreduce_over_mesh(states_t, port._reductions)
    want = jsync.allreduce_over_mesh([{k: jnp.asarray(_np(v)) for k, v in s.items()} for s in states_t],
                                     ref._reductions)
    for key in want:
        _close(got[key], want[key], 1e-5)


def test_time_decayed_sync_adds_without_decay_where_merge_state_decays():
    """The reference caveat: two replicas anchored at different times, synced, add their states as they are;
    ``merge_state`` brings both to the newer anchor first. The port does what the JAX package does in each."""
    results = {}
    for pkg, arr, t in ((PORT, torch.tensor, float), (REF, jnp.asarray, jnp.float32)):
        make = lambda: pkg["TimeDecayed"](pkg["SumMetric"](nan_strategy="disable", **pkg["kw"]), half_life_s=10.0)  # noqa: E731
        a, b = make(), make()
        a.update(t(0.0), arr(1.0))
        b.update(t(10.0), arr(1.0))
        peer = dict(b.metric_state)
        a.sync(dist_sync_fn=_fake_sync([peer], arr if pkg is REF else torch.from_numpy),
               distributed_available=True)
        synced = float(a._compute_impl())
        a.unsync()
        a.merge_state(b)
        results[pkg is REF] = (synced, float(a.compute()))
    assert results[True] == pytest.approx(results[False], rel=1e-6)
    assert results[False][0] == pytest.approx(2.0) and results[False][1] == pytest.approx(1.5)


def test_cusum_merge_order_is_the_stream_order():
    """Composition is not commutative: merging the later segment first gives another trajectory, in both."""
    stream = np.random.RandomState(5).normal(0.5, 0.3, 300).astype(np.float32)
    for pkg, arr, kw in ((td, torch.from_numpy, {"device": "cpu"}), (jd, jnp.asarray, {})):
        single, early, late = (pkg.CUSUM(target=0.5, k=0.05, h=2.0, **kw) for _ in range(3))
        single.update(arr(stream))
        early.update(arr(stream[:120]))
        late.update(arr(stream[120:]))
        wrong = pkg.CUSUM(target=0.5, k=0.05, h=2.0, **kw)
        wrong.update(arr(stream[:120]))
        wrong.merge_state(late)  # the later segment as if it came first
        late.merge_state(early)
        _close(late.compute(), single.compute(), 1e-5)
        assert not np.allclose(_np(wrong.pos), _np(single.pos))


# ----------------------------------------------------------------------------- the JAX package's window tests, on the port
def _td(base=None, **kw):
    return tw.TimeDecayed(base or tm.SumMetric(nan_strategy="disable", device="cpu"), **kw)


def test_time_decayed_half_life_exact():
    m = _td(half_life_s=10.0)
    m.update(0.0, torch.tensor(1.0))
    m.update(10.0, torch.tensor(1.0))
    assert float(m.compute()) == pytest.approx(1.5, abs=1e-6)
    m.update(20.0, torch.tensor(1.0))
    assert float(m.compute()) == pytest.approx(1.75, abs=1e-6)


def test_time_decayed_mean_is_recency_weighted():
    m = _td(tm.MeanMetric(nan_strategy="disable", device="cpu"), half_life_s=10.0)
    m.update(0.0, torch.tensor([2.0]))
    m.update(10.0, torch.tensor([4.0]))
    assert float(m.compute()) == pytest.approx(5.0 / 1.5, rel=1e-6)


def test_time_decayed_dt_zero_and_out_of_order_pinned():
    m = _td(half_life_s=3.0)
    m.update(5.0, torch.tensor(2.0))
    m.update(5.0, torch.tensor(3.0))
    assert float(m.compute()) == pytest.approx(5.0, abs=1e-6) and float(m.last_t) == 5.0
    m = _td(half_life_s=10.0)
    m.update(10.0, torch.tensor(1.0))
    m.update(0.0, torch.tensor(1.0))  # one half-life older than the reference, which never rewinds
    assert float(m.compute()) == pytest.approx(1.5, abs=1e-6) and float(m.last_t) == 10.0


def test_time_decayed_order_invariance():
    rng = np.random.RandomState(3)
    stamps, vals, perm = rng.rand(12) * 40.0, rng.randn(12).astype(np.float32), rng.permutation(12)

    def run(order):
        m = _td(half_life_s=8.0)
        for i in order:
            m.update(float(stamps[i]), torch.tensor(vals[i]))
        return float(m.compute())

    assert run(range(12)) == pytest.approx(run(perm), rel=1e-4, abs=1e-5)


def test_time_decayed_long_horizon_stability():
    """Thousands of steps converge to the geometric fixed point and stay finite (the JAX package runs 1e6
    compiled steps; the port's eager steps take 5,000, well past convergence)."""
    hl, n = 5.0, 5000
    m = _td(half_life_s=hl)
    one = torch.tensor(1.0)
    for i in range(n):
        m.update(float(i), one)
    assert float(m.compute()) == pytest.approx(1.0 / (1.0 - 2.0 ** (-1.0 / hl)), rel=1e-3)
    assert all(bool(torch.isfinite(v).all()) for v in m.metric_state.values())


def test_time_decayed_underflow_forgets_exactly():
    m = _td(half_life_s=1.0)
    m.update(0.0, torch.tensor(123.0))
    m.update(10_000.0, torch.tensor(7.0))
    assert float(m.compute()) == 7.0


def test_time_decayed_merge_to_common_reference():
    stream = [(0.0, 1.0), (4.0, 2.0), (9.0, 3.0), (15.0, 4.0)]

    def fold(pairs):
        m = _td(half_life_s=6.0)
        for ts_, v in pairs:
            m.update(ts_, torch.tensor(v))
        return m

    early, late = fold(stream[:2]), fold(stream[2:])
    late.merge_state(early)
    assert float(late.compute()) == pytest.approx(float(fold(stream).compute()), rel=1e-5)


def _tw(n_panes=2, pane_s=1.0, base=None):
    return tw.TumblingWindow(base or tm.SumMetric(nan_strategy="disable", device="cpu"), pane_s=pane_s, n_panes=n_panes)


def test_tumbling_window_expiry_and_out_of_order_drop():
    m = _tw()
    for t, v in ((0.5, 1.0), (1.5, 2.0), (2.5, 4.0)):
        m.update(t, torch.tensor(v))
    assert float(m.compute()) == 6.0
    m = _tw()
    m.update(2.5, torch.tensor(4.0))
    m.update(0.5, torch.tensor(1.0))  # slot 0 holds the newer pane 2: dropped
    assert float(m.compute()) == 4.0 and m.pane_ids.tolist() == [2, -1]
    m.update(2.9, torch.tensor(5.0))
    assert float(m.compute()) == 9.0


def test_tumbling_window_merge_matches_single_pass_and_mean_base():
    stream = [(0.5, 1.0), (1.5, 2.0), (1.8, 3.0), (2.5, 4.0), (3.1, 5.0)]

    def fold(pairs):
        m = _tw(n_panes=3)
        for t, v in pairs:
            m.update(t, torch.tensor(v))
        return m

    early, late = fold(stream[:2]), fold(stream[2:])
    late.merge_state(early)
    assert float(late.compute()) == pytest.approx(float(fold(stream).compute()), rel=1e-6)
    m = _tw(n_panes=4, pane_s=10.0, base=tm.MeanMetric(nan_strategy="disable", device="cpu"))
    m.update(5.0, torch.tensor([2.0, 4.0]))
    m.update(15.0, torch.tensor([6.0]))
    assert float(m.compute()) == pytest.approx(4.0, rel=1e-6)


def test_decayed_ddsketch_forgets_old_regime():
    m = tw.DecayedDDSketch(half_life_s=1.0, quantiles=(0.5,), num_buckets=512, device="cpu")
    rng = np.random.RandomState(0)
    m.update(0.0, torch.from_numpy(rng.uniform(9.0, 11.0, 256).astype(np.float32)))
    m.update(30.0, torch.from_numpy(rng.uniform(99.0, 101.0, 256).astype(np.float32)))
    assert 95.0 < float(m.compute()) < 105.0


def test_decayed_hll_matches_plain_hll_at_infinite_half_life_and_forgets():
    from metrics_tpu_torch.sketches import HyperLogLog

    rng = np.random.RandomState(1)
    vals = torch.from_numpy(rng.randint(0, 500, 800).astype(np.float32))
    dec, plain = tw.DecayedHLL(half_life_s=1e30, p=8, device="cpu"), HyperLogLog(p=8, device="cpu")
    dec.update(0.0, vals)
    plain.update(vals)
    assert float(dec.compute()) == pytest.approx(float(plain.compute()), rel=1e-4)
    m = tw.DecayedHLL(half_life_s=1.0, p=8, device="cpu")
    m.update(0.0, torch.from_numpy(rng.randint(0, 1000, 512).astype(np.float32)))
    crowd = float(m.compute())
    m.update(200.0, torch.tensor([1234.0]))
    assert crowd > 100.0 and float(m.compute()) < 10.0


@pytest.mark.parametrize("name", ["TimeDecayed[Mean]", "TumblingWindow[Sum]", "DecayedDDSketch", "DecayedHLL"])
def test_time_shifted_shards_merge_to_the_single_pass(name):
    """The JAX package's time-shifted merge contract: shards that saw interleaved, time-shifted parts of one
    stream merge to the single pass."""
    stream = _stream(name.split("[")[0], 7, n=12)
    single, _ = _window_pair(name)
    shards = [_window_pair(name)[0] for _ in range(3)]
    for i, (t, v) in enumerate(stream):
        single.update(float(t), torch.from_numpy(v))
        shards[i % 3].update(float(t), torch.from_numpy(v))
    for shard in shards[1:]:
        shards[0].merge_state(shard)
    _close(shards[0].compute(), single.compute(), 1e-5)


@pytest.mark.parametrize("name", ["TimeDecayed[Mean]", "DecayedDDSketch", "DecayedHLL"])
def test_window_state_roundtrips_and_moves(name):
    import pickle

    port, _ = _window_pair(name)
    for t, v in _stream(name.split("[")[0], 4, n=3):
        port.update(float(t), torch.from_numpy(v))
    again = pickle.loads(pickle.dumps(port))
    clone = port.clone()
    for other in (again, clone):
        assert other.state_fingerprint() == port.state_fingerprint()
        _close(other.compute(), port.compute(), 0.0, 0.0)
    moved = port.clone().to_device("cpu")
    assert moved.device.type == "cpu"


# ----------------------------------------------------------------------------- the JAX package's drift tests, on the port
def _hist(vals, lo, hi, num_bins):
    v = np.asarray(vals, np.float64).reshape(-1)
    v = v[np.isfinite(v)]
    idx = np.clip(np.floor((v - lo) / (hi - lo) * num_bins).astype(int) + 1, 0, num_bins + 1)
    return np.bincount(idx, minlength=num_bins + 2).astype(np.float64)


def _props(counts):
    return counts / max(counts.sum(), 1.0)


def test_psi_and_ks_match_oracles_and_read_right():
    rng = np.random.RandomState(0)
    ref, same, shifted = (rng.normal(mu, 1.0, 4096).astype(np.float32) for mu in (0.0, 0.0, 1.5))
    for live, lo_ in ((same, True), (shifted, False)):
        m = td.PSI(lo=-4.0, hi=4.0, num_bins=32, device="cpu")
        m.update(torch.from_numpy(live), torch.from_numpy(ref))
        pl, pr = (np.clip(_props(_hist(x, -4.0, 4.0, 32)), 1e-6, 1.0) for x in (live, ref))
        assert float(m.compute()) == pytest.approx(float(np.sum((pl - pr) * np.log(pl / pr))), rel=1e-4, abs=1e-6)
        assert (float(m.compute()) < 0.1) if lo_ else (float(m.compute()) > 0.25)
    ref, live = rng.normal(0.0, 1.0, 8192).astype(np.float32), rng.normal(1.0, 1.0, 8192).astype(np.float32)
    k = td.KSDistance(lo=-5.0, hi=5.0, num_bins=64, device="cpu")
    k.update(torch.from_numpy(live), torch.from_numpy(ref))
    oracle = float(np.max(np.abs(np.cumsum(_props(_hist(ref, -5, 5, 64))) - np.cumsum(_props(_hist(live, -5, 5, 64))))))
    assert float(k.compute()) == pytest.approx(oracle, rel=1e-4, abs=1e-6)
    assert float(k.compute()) == pytest.approx(0.3829, abs=0.03)


def test_paired_histogram_empty_sides_and_nonfinite():
    m = td.PSI(lo=0.0, hi=1.0, num_bins=8, device="cpu")
    with pytest.warns(UserWarning):
        assert float(m.compute()) == pytest.approx(0.0, abs=1e-9)
    m.update(torch.zeros(0), torch.tensor([0.1, 0.2, 0.9]))
    m.update(torch.tensor([0.1, np.nan, np.inf, 5.0, -3.0]), torch.zeros(0))
    counts = m.live_counts.numpy()
    assert counts.sum() == 3.0 and counts[0] == 1.0 and counts[-1] == 1.0
    assert np.isfinite(float(m.compute()))
    for make in (lambda: td.PSI(lo=1.0, hi=1.0, device="cpu"), lambda: jd.PSI(lo=1.0, hi=1.0)):
        with pytest.raises(ValueError, match="hi"):
            make()


def test_psi_ks_merge_is_bit_level():
    rng = np.random.RandomState(2)
    batches = [(rng.rand(64).astype(np.float32), rng.rand(64).astype(np.float32)) for _ in range(6)]
    for cls in (td.PSI, td.KSDistance):
        single, early, late = (cls(lo=0.0, hi=1.0, num_bins=16, device="cpu") for _ in range(3))
        for i, (live, ref) in enumerate(batches):
            single.update(torch.from_numpy(live), torch.from_numpy(ref))
            (early if i < 3 else late).update(torch.from_numpy(live), torch.from_numpy(ref))
        late.merge_state(early)
        assert torch.equal(single.compute(), late.compute())


def _cusum_oracle(values, target, k):
    sp = sn = wp = wn = 0.0
    for x in np.asarray(values, np.float64).reshape(-1):
        if np.isfinite(x):
            sp, sn = max(0.0, sp + (x - target - k)), max(0.0, sn + (target - k - x))
            wp, wn = max(wp, sp), max(wn, sn)
    return sp, sn, wp, wn


def test_cusum_matches_sequential_oracle_and_stays_silent_in_control():
    rng = np.random.RandomState(3)
    stream = rng.normal(0.5, 0.2, 400).astype(np.float32)
    stream[250:] += 0.8
    m = td.CUSUM(target=0.5, k=0.1, h=5.0, device="cpu")
    for lo in range(0, 400, 50):
        m.update(torch.from_numpy(stream[lo:lo + 50]))
    sp, sn, wp, wn = _cusum_oracle(stream, 0.5, 0.1)
    got = m.compute().numpy()
    assert got[0] == pytest.approx(sp, rel=1e-4, abs=1e-4) and got[1] == pytest.approx(sn, rel=1e-4, abs=1e-4)
    assert got[2] == 1.0 and max(wp, wn) > 5.0
    quiet = td.CUSUM(target=0.0, k=1.0, h=10.0, device="cpu")
    quiet.update(torch.from_numpy(rng.normal(0.0, 1.0, 500).astype(np.float32)))
    assert float(quiet.compute()[2]) == 0.0


def test_cusum_watermark_catches_excursion_inside_batch():
    calm = np.full(50, 0.5, np.float32)
    spike = np.concatenate([calm, np.full(10, 3.0, np.float32), np.full(50, -2.0, np.float32)])
    m = td.CUSUM(target=0.5, k=0.1, h=5.0, device="cpu")
    m.update(torch.from_numpy(spike))
    out = m.compute().numpy()
    assert out[0] == pytest.approx(0.0, abs=1e-5) and out[2] == 1.0


def test_cusum_rejects_bad_hyperparams_as_reference():
    for pkg, kw in ((td, {"device": "cpu"}), (jd, {})):
        with pytest.raises(ValueError, match="`k`"):
            pkg.CUSUM(target=0.0, k=-0.1, **kw)
        with pytest.raises(ValueError, match="`h`"):
            pkg.CUSUM(target=0.0, h=0.0, **kw)
