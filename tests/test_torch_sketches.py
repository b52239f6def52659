"""The port's streaming sketches against the JAX package's.

The same seeded numpy inputs go through both packages: the hash on every
input type and on ±0, ±inf and NaN; HyperLogLog registers; DDSketch keys and
counts, at random and at the bucket edges ``γ^k`` and one ulp either side;
the ECDF histograms at the bin edges; the reservoir with ``-0.0``, NaN and
repeated values; then each class's update, compute, ``merge_state``,
``forward``, reset, sync and a stream started in the JAX package and resumed
in the port. Hashes, registers, counts and reservoir states must be equal;
float sums (the confidence sums, the reductions of the estimates) within
rtol 1e-5, since they are float32 sums taken in another order (the port sums
each batch in float64).

DDSketch keys: the JAX package's float32 ``log`` is XLA's polynomial, which
differs from ``torch.log`` by an ulp on some inputs, so at a bucket edge and
one ulp either side a few values take the next bucket (ROADMAP, kept by
design); each of them is still within α of its bucket's representative. The
JAX package's metrics run their updates compiled, where XLA multiplies by the
reciprocal of ``ln γ``; the functional checks call its function under
``jax.jit`` for that reason.

The second half mirrors the JAX package's own sketch tests (``test_sketches``,
``test_sketches_oracle`` and ``test_sketch_contracts``) on the port alone.
"""

from __future__ import annotations

import itertools
import math
import pickle

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import metrics_tpu.functional.sketches as jf
import metrics_tpu.parallel.sync as jsync
import metrics_tpu.sketches as js
import metrics_tpu_torch.functional.sketches as tf
import metrics_tpu_torch.parallel as tsync
import metrics_tpu_torch.sketches as ts
from metrics_tpu.ops.binned_hist import histogram_counts as ref_histogram_counts
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.ops.binned_hist import histogram_counts

RTOL = 1e-5
CLASSES = ["DDSketch", "HyperLogLog", "ReservoirSample", "StreamingAUROC", "StreamingCalibrationError"]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(port, ref):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    if ref.dtype.kind == "f":
        np.testing.assert_array_equal(port.astype(ref.dtype).view(f"u{ref.itemsize}"), ref.view(f"u{ref.itemsize}"))
    else:
        np.testing.assert_array_equal(port.astype(np.int64), ref.astype(np.int64))


def _close(port, ref, rtol=RTOL, atol=1e-7):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=rtol, atol=atol)


# ----------------------------------------------------------------------------- hashing
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 1e-45, 3.4e38], np.float32)


def _hash_inputs(kind, rng):
    if kind in ("float32", "float64", "float16", "bfloat16"):
        x = np.concatenate([rng.randn(2000) * 100, SPECIAL.astype(np.float64)])
        with np.errstate(over="ignore"):  # 3.4e38 is inf in float16
            return x.astype(ml_dtypes.bfloat16 if kind == "bfloat16" else kind)
    if kind == "int32":
        return rng.randint(-2**31, 2**31 - 1, 2000).astype(np.int32)
    if kind == "int64":  # values at and above 2^31 and negative ones: taken modulo 2^32
        return np.concatenate([rng.randint(-2**62, 2**62, 2000), [2**31, 2**32 + 5, -1, -2**31, 2**63 - 1]]).astype(np.int64)
    return rng.rand(2000) < 0.5


@pytest.mark.parametrize("kind", ["float32", "float64", "float16", "bfloat16", "int32", "int64", "bool"])
@pytest.mark.parametrize("seed", [0, 2**32 - 1, 2**33 + 3])
def test_hash32_matches_reference(kind, seed):
    x = _hash_inputs(kind, np.random.RandomState(1))
    port_in = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16) if kind == "bfloat16" else torch.from_numpy(x)
    got = tf.hash32(port_in, seed)
    want = np.asarray(jf.hash32(jnp.asarray(x), seed)).astype(np.int64)
    assert got.dtype == torch.int64 and int(got.min()) >= 0 and int(got.max()) < 2**32
    np.testing.assert_array_equal(got.numpy(), want)


def test_subnormals_hash_and_count_as_zero_as_reference():
    """XLA runs the JAX package's programs with float32 subnormals flushed: they hash and count as zeros."""
    v = np.array([1e-40, -1e-41, 0.0, 2.0], np.float32)
    np.testing.assert_array_equal(tf.hash32(torch.from_numpy(v)).numpy(),
                                  np.asarray(jf.hash32(jnp.asarray(v))).astype(np.int64))
    got = tf.ddsketch_delta(torch.from_numpy(v), torch.ones(4, dtype=torch.bool), **DD)
    want = jf.ddsketch_delta(jnp.asarray(v), jnp.ones(4, bool), **DD)
    for g, w in zip(got, want):
        _equal(g, w)
    assert int(got[2]) == 3


def test_hash32_zero_signs_collapse_and_fmix32_matches():
    assert tf.hash32(torch.tensor([0.0]), 3).item() == tf.hash32(torch.tensor([-0.0]), 3).item()
    words = np.random.RandomState(2).randint(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    got = tf.fmix32(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf.fmix32(jnp.asarray(words))).astype(np.int64))


# ----------------------------------------------------------------------------- HyperLogLog
@pytest.mark.parametrize("p", [4, 10, 16])
@pytest.mark.parametrize("kind", ["float32", "int32", "int64"])
def test_hll_registers_equal_reference(p, kind):
    rng = np.random.RandomState(p)
    x = _hash_inputs(kind, rng)
    valid = rng.rand(x.shape[0]) > 0.1
    got = tf.hll_delta(torch.from_numpy(x), torch.from_numpy(valid), p=p, seed=5)
    want = jf.hll_delta(jnp.asarray(x), jnp.asarray(valid), p=p, seed=5)
    assert got.dtype == torch.int32
    _equal(got, want)
    _close(tf.hll_estimate(got), jf.hll_estimate(want), 1e-6)


@pytest.mark.parametrize("p", [3, 17])
def test_hll_refuses_p_out_of_range_as_reference(p):
    for fn, arr in ((tf.hll_delta, torch.ones(3)), (jf.hll_delta, jnp.ones(3))):
        with pytest.raises(ValueError, match=r"`p` must be in \[4, 16\]"):
            fn(arr, arr > 0, p=p)
    assert tf.hll_std_error(12) == jf.hll_std_error(12)


@pytest.mark.parametrize("fill", [0, 1, 5, 20, 28])
def test_hll_estimate_ranges_match_reference(fill):
    """Linear counting, the raw estimate and the 2^32 correction."""
    regs = np.full(1 << 12, fill, np.int32)
    regs[::3] = 0 if fill < 5 else fill - 1
    _close(tf.hll_estimate(torch.from_numpy(regs)), jf.hll_estimate(jnp.asarray(regs)), 1e-6)


# ----------------------------------------------------------------------------- DDSketch
DD = {"alpha": 0.01, "key_offset": -1024, "num_buckets": 2048}


def _ref_dd_delta(v, valid, **kw):
    """The JAX package's delta as its metrics run it: compiled."""
    return jax.jit(lambda a, b: jf.ddsketch_delta(a, b, **kw))(jnp.asarray(v), jnp.asarray(valid))


def test_ddsketch_counts_equal_reference_on_random_values():
    rng = np.random.RandomState(3)
    v = np.concatenate([rng.lognormal(0, 3, 20000), -rng.lognormal(0, 2, 3000), np.zeros(40),
                        [np.nan, np.inf, -np.inf, -0.0, 1e30]]).astype(np.float32)
    valid = rng.rand(v.shape[0]) > 0.05
    got = tf.ddsketch_delta(torch.from_numpy(v), torch.from_numpy(valid), **DD)
    for want in (_ref_dd_delta(v, valid, **DD), jf.ddsketch_delta(jnp.asarray(v), jnp.asarray(valid), **DD)):
        for g, w in zip(got, want):
            _equal(g, w)
    assert all(g.dtype == torch.int64 for g in got)


def test_ddsketch_keys_at_bucket_edges_stay_within_alpha():
    """At γ^k and one ulp either side the keys may differ from the JAX package's (its float32 log is XLA's
    polynomial); every such value lies within α of the representative of the port's bucket."""
    gamma = tf.ddsketch_gamma(0.01)
    edge = np.exp(np.arange(-600, 600) * math.log(gamma)).astype(np.float32)
    v = np.concatenate([edge, np.nextafter(edge, np.float32(np.inf)), np.nextafter(edge, np.float32(0))])
    ones = np.ones(v.shape, bool)
    got = tf.ddsketch_delta(torch.from_numpy(v), torch.from_numpy(ones), **DD)[0].numpy()
    want = np.asarray(_ref_dd_delta(v, ones, **DD)[0])
    moved = int(np.abs(got - want).sum()) // 2
    assert moved <= 0.05 * v.size, moved  # 26 of 3,600 on this build; most edges agree
    inv_ln = np.float32(1.0) / np.float32(math.log(gamma))
    keys = np.ceil(torch.log(torch.from_numpy(v)).numpy() * inv_ln)
    rep = 2.0 * gamma ** keys.astype(np.float64) / (gamma + 1.0)
    # exactly α at an edge; float32 keys reach α + 1.7e-7 here, in both packages
    assert np.all(np.abs(rep - v) / v <= 0.01 + 1e-6)


@pytest.mark.parametrize("quantiles", [(0.0, 0.5, 1.0), (0.01, 0.25, 0.5, 0.9, 0.99, 0.999)])
def test_ddsketch_quantiles_equal_reference(quantiles):
    rng = np.random.RandomState(4)
    v = np.concatenate([rng.lognormal(0, 2, 5000), -rng.lognormal(0, 1, 500), np.zeros(30)]).astype(np.float32)
    pos, neg, zero = (np.asarray(x) for x in _ref_dd_delta(v, np.ones(v.shape, bool), **DD))
    got = tf.ddsketch_quantiles(*(torch.from_numpy(x.astype(np.int64)) for x in (pos, neg, zero)), quantiles,
                                alpha=0.01, key_offset=-1024)
    want = jf.ddsketch_quantiles(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(zero), quantiles, alpha=0.01,
                                 key_offset=-1024)
    _equal(got, want)
    empty = tf.ddsketch_quantiles(torch.zeros(8, dtype=torch.int64), torch.zeros(8, dtype=torch.int64),
                                  torch.zeros((), dtype=torch.int64), (0.5,), alpha=0.01, key_offset=-4)
    assert empty.tolist() == [0.0]
    for fn in (tf.ddsketch_gamma, jf.ddsketch_gamma):
        with pytest.raises(ValueError, match="alpha"):
            fn(1.0)


# ----------------------------------------------------------------------------- ECDF
EDGE_SCORES = np.concatenate([np.linspace(0, 1, 16, dtype=np.float32)] * 3)


def _edge_scores(num_bins, rng):
    edges = np.asarray(jf.uniform_edges(num_bins)).astype(np.float32)
    special = np.array([0.0, 1.0, -0.5, 1.5, np.nan, np.inf, -np.inf, -0.0], np.float32)
    return np.concatenate([rng.rand(3000).astype(np.float32), edges, np.nextafter(edges, np.float32(2)),
                           np.nextafter(edges, np.float32(-1)), special])


@pytest.mark.parametrize("num_bins", [2, 15, 2048])
def test_uniform_edges_and_histograms_equal_reference(num_bins):
    rng = np.random.RandomState(num_bins)
    np.testing.assert_array_equal(tf.uniform_edges(num_bins).numpy(), np.asarray(jf.uniform_edges(num_bins)))
    p = _edge_scores(num_bins, rng)
    t = rng.randint(0, 2, p.shape[0])
    valid = rng.rand(p.shape[0]) > 0.05
    got = tf.score_hist_delta(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(valid), num_bins=num_bins)
    want = jf.score_hist_delta(jnp.asarray(p), jnp.asarray(t), jnp.asarray(valid), num_bins=num_bins)
    for g, w in zip(got, want):
        _equal(g, w)
    got_c = tf.calibration_delta(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(valid), num_bins=num_bins)
    want_c = jf.calibration_delta(jnp.asarray(p), jnp.asarray(t), jnp.asarray(valid), num_bins=num_bins)
    _close(got_c[0], want_c[0])
    _equal(got_c[1], want_c[1])
    _equal(got_c[2], want_c[2])
    _close(tf.binned_auroc(*got), jf.binned_auroc(*want))
    _close(tf.binned_auroc_bound(*got), jf.binned_auroc_bound(*want))
    _close(tf.binned_ece(*got_c), jf.binned_ece(*want_c))


def test_histogram_counts_equal_reference():
    rng = np.random.RandomState(9)
    edges = np.array([-1.0, 0.0, 0.25, 0.5, 2.0], np.float64)
    v = np.concatenate([rng.randn(500), edges, [np.nan, -5.0, 7.0, np.inf]]).astype(np.float32)
    valid = rng.rand(v.shape[0]) > 0.1
    got = histogram_counts(torch.from_numpy(v), torch.from_numpy(valid), torch.from_numpy(edges))
    assert got.dtype == torch.int64
    _equal(got, ref_histogram_counts(jnp.asarray(v), jnp.asarray(valid), jnp.asarray(edges)))


def test_empty_and_one_sided_curve_states_read_zero_as_reference():
    z = torch.zeros(4, dtype=torch.int64)
    one = torch.tensor([0, 3, 0, 1])
    for a, b in ((z, z), (one, z), (z, one)):
        _close(tf.binned_auroc(a, b), jf.binned_auroc(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
        _close(tf.binned_auroc_bound(a, b), jf.binned_auroc_bound(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
    assert float(tf.binned_ece(torch.zeros(3), z[:3], z[:3])) == 0.0
    for fn in (tf.uniform_edges, jf.uniform_edges):
        with pytest.raises(ValueError, match="num_bins"):
            fn(1)


# ----------------------------------------------------------------------------- reservoir
def _reservoir_values(rng, n):
    v = rng.rand(n).astype(np.float32)
    v[::7] = 0.0
    v[::11] = -0.0  # hashes as +0.0 and ties with it; the value kept is the row's own
    v[::13] = 0.25  # repeated values share a priority
    v[5], v[9] = np.nan, np.inf
    return v


@pytest.mark.parametrize("k", [1, 64])
def test_reservoir_fold_and_merge_are_bit_equal(k):
    rng = np.random.RandomState(k)
    port, ref = tf.reservoir_empty(k), jf.reservoir_empty(k)
    _equal(port, ref)
    shards_t, shards_j = [], []
    for _ in range(4):
        v = _reservoir_values(rng, 500)
        valid = rng.rand(500) > 0.05
        port = tf.reservoir_fold(port, torch.from_numpy(v), torch.from_numpy(valid), seed=3)
        ref = jf.reservoir_fold(ref, jnp.asarray(v), jnp.asarray(valid), seed=3)
        _equal(port, ref)
        shards_t.append(port)
        shards_j.append(ref)
    _equal(tf.reservoir_merge(torch.stack(shards_t)), jf.reservoir_merge(jnp.stack(shards_j)))
    _equal(tf.reservoir_values(port), jf.reservoir_values(ref))
    for fn in (tf.reservoir_empty, jf.reservoir_empty):
        with pytest.raises(ValueError, match="`k`"):
            fn(0)


def test_reservoir_keeps_negative_zero_as_reference():
    v = np.array([-0.0, 0.0, -0.0, 0.5], np.float32)
    port = tf.reservoir_fold(tf.reservoir_empty(3), torch.from_numpy(v), torch.ones(4, dtype=torch.bool))
    ref = jf.reservoir_fold(jf.reservoir_empty(3), jnp.asarray(v), jnp.ones(4, bool))
    _equal(port, ref)
    assert np.signbit(port[2].numpy()).any()


# ----------------------------------------------------------------------------- the classes
def _batches(name, seed, n=4, size=200):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if name == "DDSketch":
            v = np.concatenate([rng.lognormal(0, 2, size), -rng.lognormal(0, 1, size // 10), [0.0, np.nan]])
            out.append((v.astype(np.float32),))
        elif name == "HyperLogLog":
            out.append((rng.randint(0, 5000, size).astype(np.int32),))
        elif name == "ReservoirSample":
            out.append((_reservoir_values(rng, size),))
        else:
            t = rng.randint(0, 2, size)
            out.append((np.clip(0.3 * t + 0.7 * rng.rand(size), 0, 1).astype(np.float32), t))
    return out


CONFIG = {"DDSketch": {"num_buckets": 256}, "HyperLogLog": {"p": 8, "seed": 3}, "ReservoirSample": {"k": 16, "seed": 2},
          "StreamingAUROC": {"num_bins": 64}, "StreamingCalibrationError": {"num_bins": 10}}


def _pair(name):
    return getattr(ts, name)(device="cpu", **CONFIG[name]), getattr(js, name)(**CONFIG[name])


def _states_match(port, ref):
    for key, value in ref.metric_state.items():
        if key == "conf_sum":
            _close(port.metric_state[key], value)
        else:
            _equal(port.metric_state[key], value)


def _values_match(port, ref):
    got, want = port, ref
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _values_match(g, w)
        return
    _close(got, want, RTOL, 1e-7)


@pytest.mark.parametrize("name", CLASSES)
def test_class_update_compute_merge_forward_reset_match_reference(name):
    port, ref = _pair(name)
    port_f, ref_f = _pair(name)
    for batch in _batches(name, 1):
        port.update(*(torch.from_numpy(x) for x in batch))
        ref.update(*(jnp.asarray(x) for x in batch))
        _values_match(port_f(*(torch.from_numpy(x) for x in batch)), ref_f(*(jnp.asarray(x) for x in batch)))
    _states_match(port, ref)
    _states_match(port_f, ref_f)
    _values_match(port.compute(), ref.compute())
    other_t, other_j = _pair(name)
    for batch in _batches(name, 2, n=2):
        other_t.update(*(torch.from_numpy(x) for x in batch))
        other_j.update(*(jnp.asarray(x) for x in batch))
    port.merge_state(other_t)
    ref.merge_state(other_j)
    _states_match(port, ref)
    assert port.update_count == ref.update_count == 6
    _values_match(port.compute(), ref.compute())
    port.reset()
    ref.reset()
    _states_match(port, ref)


@pytest.mark.parametrize("name", CLASSES)
def test_reference_stream_resumes_in_the_port(name):
    """A stream started in the JAX package (its int32 registers and counts, the (3, k) reservoir) goes on in
    the port and gives the single stream's answer."""
    batches = _batches(name, 3)
    port, ref = _pair(name)
    single, _ = _pair(name)
    for batch in batches[:2]:
        ref.update(*(jnp.asarray(x) for x in batch))
    ref.persistent(True)
    load_reference_state(port, ref.state_dict())
    for batch in batches:
        single.update(*(torch.from_numpy(x) for x in batch))
    for batch in batches[2:]:
        port.update(*(torch.from_numpy(x) for x in batch))
        ref.update(*(jnp.asarray(x) for x in batch))
    _states_match(port, ref)
    for key in single.metric_state:
        assert port.metric_state[key].dtype == single.metric_state[key].dtype
        if key != "conf_sum":
            _equal(port.metric_state[key], single.metric_state[key])
    _values_match(port.compute(), single.compute())


def _fake_sync(peers, as_array):
    def sync_fn(states, group):
        return [[local] + [as_array(_np(list(p.values())[i])) for p in peers] for i, local in enumerate(states)]
    return sync_fn


@pytest.mark.parametrize("name", CLASSES)
def test_sync_matches_reference(name):
    """``Metric.sync`` through the same fake transport, and ``allreduce_over_mesh`` against the JAX package's
    8-device mesh: HyperLogLog's max, the reservoir's bottom k of the (world, 3, k) stack, the sums."""
    port, ref = _pair(name)
    for batch in _batches(name, 4, n=2):
        port.update(*(torch.from_numpy(x) for x in batch))
        ref.update(*(jnp.asarray(x) for x in batch))
    peers_t, peers_j = [], []
    for seed in (5, 6, 7):
        pt, pj = _pair(name)
        for batch in _batches(name, seed, n=2):
            pt.update(*(torch.from_numpy(x) for x in batch))
            pj.update(*(jnp.asarray(x) for x in batch))
        peers_t.append(dict(pt.metric_state))
        peers_j.append(dict(pj.metric_state))
    local = dict(port.metric_state)
    port.sync(dist_sync_fn=_fake_sync(peers_t, torch.from_numpy), distributed_available=True)
    ref.sync(dist_sync_fn=_fake_sync(peers_j, jnp.asarray), distributed_available=True)
    _states_match(port, ref)
    _values_match(port._compute_impl(), ref._compute_impl())
    port.unsync()
    assert all(port.metric_state[k] is v for k, v in local.items())
    states_t = [dict(local)] + peers_t
    states_j = [{k: jnp.asarray(_np(v)) for k, v in s.items()} for s in states_t]
    got = tsync.allreduce_over_mesh(states_t, port._reductions)
    want = jsync.allreduce_over_mesh(states_j, ref._reductions)
    for key in want:
        (_close if key == "conf_sum" else _equal)(got[key], want[key])


# ----------------------------------------------------------------------------- the JAX package's sketch tests, on the port
def test_ddsketch_relative_error_within_alpha():
    rng = np.random.RandomState(0)
    vals = np.exp(rng.randn(50_000)).astype(np.float32)
    m = ts.DDSketch(alpha=0.02, quantiles=(0.1, 0.5, 0.9, 0.99), device="cpu")
    for chunk in np.split(vals, 5):
        m.update(torch.from_numpy(chunk))
    est = m.compute().numpy()
    exact = np.quantile(vals, (0.1, 0.5, 0.9, 0.99))
    assert np.all(np.abs(est - exact) / exact <= 0.02)


def test_ddsketch_handles_negative_zero_and_nonfinite():
    vals = np.array([-4.0, -1.0, 0.0, 0.0, 1.0, 4.0, np.nan, np.inf], np.float32)
    m = ts.DDSketch(alpha=0.01, quantiles=(0.0, 0.5, 1.0), num_buckets=256, device="cpu")
    m.update(torch.from_numpy(vals))
    lo, med, hi = m.compute().tolist()
    assert lo == pytest.approx(-4.0, rel=0.01) and med == 0.0 and hi == pytest.approx(4.0, rel=0.01)
    assert int(m.zero_count) == 2


def test_ddsketch_empty_compute_is_zero_and_reset_restores():
    m = ts.DDSketch(num_buckets=256, device="cpu")
    with pytest.warns(UserWarning, match="before the ``update``"):
        assert np.all(m.compute().numpy() == 0.0)
    m.update(torch.tensor([1.0, 2.0]))
    m.reset()
    with pytest.warns(UserWarning):
        assert np.all(m.compute().numpy() == 0.0)


def test_ddsketch_key_offset_defaults_scale_with_num_buckets():
    m = ts.DDSketch(alpha=0.01, quantiles=(0.5,), num_buckets=128, device="cpu")
    m.update(torch.full((100,), 3.0))
    assert float(m.compute()) == pytest.approx(3.0, rel=0.01)
    assert m.key_offset == js.DDSketch(num_buckets=128).key_offset == -64


@pytest.mark.parametrize("kwargs, match", [({"alpha": 0.0}, "alpha"), ({"num_buckets": 1}, "num_buckets"),
                                           ({"quantiles": ()}, "quantiles"), ({"quantiles": (1.5,)}, "quantiles")])
def test_ddsketch_rejects_bad_arguments_as_reference(kwargs, match):
    for make in (lambda: ts.DDSketch(device="cpu", **kwargs), lambda: js.DDSketch(**kwargs)):
        with pytest.raises(ValueError, match=match):
            make()


def test_hll_estimate_within_five_sigma():
    n = 40_000
    vals = (np.arange(n, dtype=np.int64) * 2654435761 % (2**31)).astype(np.int32)
    m = ts.HyperLogLog(p=10, device="cpu")
    for chunk in np.split(vals, 4):
        m.update(torch.from_numpy(chunk))
    assert abs(float(m.compute()) - n) / n <= 5 * m.std_error


def test_hll_small_range_linear_counting():
    m = ts.HyperLogLog(p=12, device="cpu")
    m.update(torch.arange(100, dtype=torch.int32))
    assert float(m.compute()) == pytest.approx(100, abs=5)


def test_hll_duplicates_do_not_inflate():
    m = ts.HyperLogLog(p=10, device="cpu")
    for _ in range(5):
        m.update(torch.arange(1000, dtype=torch.int32))
    assert float(m.compute()) == pytest.approx(1000, rel=5 * m.std_error)


def test_hll_merge_is_idempotent():
    rng = np.random.RandomState(2)
    a, b = ts.HyperLogLog(p=8, device="cpu"), ts.HyperLogLog(p=8, device="cpu")
    a.update(torch.from_numpy(rng.rand(500).astype(np.float32)))
    b.update(torch.from_numpy(rng.rand(500).astype(np.float32)))
    a.merge_state(b)
    once = float(a.compute())
    a.merge_state(b)
    assert float(a.compute()) == once
    for make in (lambda: ts.HyperLogLog(p=17, device="cpu"), lambda: js.HyperLogLog(p=17)):
        with pytest.raises(ValueError, match="`p`"):
            make()


def _bottom_k_oracle(vals: np.ndarray, k: int, seed: int) -> np.ndarray:
    h = tf.hash32(torch.from_numpy(vals), seed).numpy()
    order = np.lexsort((vals, h & 0xFFFF, h >> 16))
    return np.sort(vals[order[:k]])


def test_reservoir_matches_exact_bottom_k():
    vals = np.random.RandomState(4).rand(3000).astype(np.float32)
    m = ts.ReservoirSample(k=32, seed=11, device="cpu")
    for chunk in np.split(vals, 6):
        m.update(torch.from_numpy(chunk))
    np.testing.assert_array_equal(np.sort(m.compute().numpy()), _bottom_k_oracle(vals, 32, 11))


def test_reservoir_seed_selects_different_samples():
    vals = torch.from_numpy(np.random.RandomState(5).rand(1000).astype(np.float32))
    a, b = ts.ReservoirSample(k=16, seed=0, device="cpu"), ts.ReservoirSample(k=16, seed=1, device="cpu")
    a.update(vals)
    b.update(vals)
    assert not torch.equal(a.compute(), b.compute())


def test_reservoir_underfilled_slots_read_zero():
    m = ts.ReservoirSample(k=8, device="cpu")
    m.update(torch.tensor([5.0, 7.0]))
    out = np.sort(m.compute().numpy())
    assert np.allclose(out[-2:], [5.0, 7.0]) and np.all(out[:-2] == 0.0)


def test_streaming_auroc_within_own_bound():
    from metrics_tpu_torch.functional import auroc as exact_auroc

    rng = np.random.RandomState(6)
    t = (rng.rand(4000) < 0.4).astype(np.int32)
    s = np.clip(0.35 * t + 0.5 * rng.rand(4000), 0, 1).astype(np.float32)
    m = ts.StreamingAUROC(num_bins=256, device="cpu")
    for tt, ss in zip(np.split(t, 4), np.split(s, 4)):
        m.update(torch.from_numpy(ss), torch.from_numpy(tt))
    exact = float(exact_auroc(torch.from_numpy(s), torch.from_numpy(t), task="binary"))
    bound = float(m.error_bound())
    assert abs(float(m.compute()) - exact) <= bound + 1e-5 and bound < 0.05


def test_streaming_auroc_empty_class_is_zero():
    m = ts.StreamingAUROC(num_bins=32, device="cpu")
    m.update(torch.tensor([0.2, 0.8]), torch.tensor([1, 1]))
    assert float(m.compute()) == 0.0


def _ece_oracle(s, t, num_bins):
    conf = np.maximum(s, 1 - s)
    hit = (s >= 0.5).astype(np.int32) == t
    edges = np.linspace(0, 1, num_bins + 1)
    idx = np.clip(np.searchsorted(edges.astype(np.float32), conf.astype(np.float32), side="right") - 1, 0,
                  num_bins - 1)
    n = len(s)
    return sum((idx == b).sum() / n * abs(hit[idx == b].mean() - conf[idx == b].astype(np.float64).mean())
               for b in range(num_bins) if (idx == b).any())


def test_streaming_ece_matches_same_binned_oracle():
    rng = np.random.RandomState(7)
    t = (rng.rand(5000) < 0.5).astype(np.int32)
    s = rng.rand(5000).astype(np.float32)
    m = ts.StreamingCalibrationError(num_bins=15, device="cpu")
    for tt, ss in zip(np.split(t, 5), np.split(s, 5)):
        m.update(torch.from_numpy(ss), torch.from_numpy(tt))
    assert float(m.compute()) == pytest.approx(_ece_oracle(s, t, 15), abs=1e-5)


@pytest.mark.parametrize("name", CLASSES)
def test_sketch_states_keep_shape_and_dtype(name):
    """The port's counterpart of the JAX package's fixed-aval check: an update replaces each state by one of
    the same shape and dtype."""
    m, _ = _pair(name)
    shapes = {k: (v.shape, v.dtype) for k, v in m.metric_state.items()}
    for batch in _batches(name, 8, n=2):
        before = dict(m.metric_state)
        m.update(*(torch.from_numpy(x) for x in batch))
        assert {k: (v.shape, v.dtype) for k, v in m.metric_state.items()} == shapes
        assert all(m.metric_state[k] is not v for k, v in before.items())  # replaced, never changed in place


@pytest.mark.parametrize("name", CLASSES)
def test_sketch_state_dict_and_pickle_roundtrip(name):
    m, _ = _pair(name)
    for batch in _batches(name, 9, n=2):
        m.update(*(torch.from_numpy(x) for x in batch))
    m.persistent(True)
    fresh, _ = _pair(name)
    fresh.load_state_dict(m.state_dict())
    again = pickle.loads(pickle.dumps(m))
    for other in (fresh, again):
        _values_match(other.compute(), m.compute())
        assert other.state_fingerprint() == m.state_fingerprint()


# the 1e6-element oracles of the JAX package's test_sketches_oracle, on the port
N_ORACLE, CHUNKS = 1_000_000, 8


def _stream(*arrays):
    for parts in zip(*(np.array_split(a, CHUNKS) for a in arrays)):
        yield tuple(torch.from_numpy(p) for p in parts)


def test_ddsketch_quantiles_within_alpha_and_merge_at_1e6():
    rng = np.random.RandomState(0)
    vals = np.exp(rng.randn(N_ORACLE)).astype(np.float32)
    qs = (0.01, 0.25, 0.5, 0.9, 0.99, 0.999)
    m = ts.DDSketch(alpha=0.01, quantiles=qs, device="cpu")
    shards = [ts.DDSketch(alpha=0.01, quantiles=qs, device="cpu") for _ in range(4)]
    for i, (chunk,) in enumerate(_stream(vals)):
        m.update(chunk)
        shards[i % 4].update(chunk)
    exact = np.quantile(vals, qs)
    assert np.all(np.abs(m.compute().numpy() - exact) / exact <= 0.01)
    for s in shards[1:]:
        shards[0].merge_state(s)
    assert torch.equal(shards[0].compute(), m.compute())


def test_hll_within_five_sigma_and_merge_at_1e6():
    vals = (np.arange(N_ORACLE, dtype=np.int64) * 2654435761 % (2**31)).astype(np.int32)
    m = ts.HyperLogLog(p=12, device="cpu")
    shards = [ts.HyperLogLog(p=10, device="cpu") for _ in range(4)]
    single10 = ts.HyperLogLog(p=10, device="cpu")
    for i, (chunk,) in enumerate(_stream(vals)):
        m.update(chunk)
        single10.update(chunk)
        shards[i % 4].update(chunk)
    assert m.std_error == pytest.approx(1.04 / np.sqrt(4096))
    assert abs(float(m.compute()) - N_ORACLE) / N_ORACLE <= 5 * m.std_error
    for s in shards[1:]:
        shards[0].merge_state(s)
    assert torch.equal(shards[0].registers, single10.registers)


def test_reservoir_is_exact_bottom_k_at_1e6():
    vals = np.random.RandomState(2).rand(N_ORACLE).astype(np.float32)
    m = ts.ReservoirSample(k=64, seed=5, device="cpu")
    shards = [ts.ReservoirSample(k=64, seed=5, device="cpu") for _ in range(4)]
    for i, (chunk,) in enumerate(_stream(vals)):
        m.update(chunk)
        shards[i % 4].update(chunk)
    oracle = _bottom_k_oracle(vals, 64, 5)
    np.testing.assert_array_equal(np.sort(m.compute().numpy()), oracle)
    for s in shards[1:]:
        shards[0].merge_state(s)
    np.testing.assert_array_equal(np.sort(shards[0].compute().numpy()), oracle)


def test_streaming_auroc_within_bound_and_ece_on_1e6_stream():
    rng = np.random.RandomState(3)
    target = (rng.rand(N_ORACLE) < 0.3).astype(np.int32)
    preds = np.clip(0.25 * target + 0.6 * rng.rand(N_ORACLE), 0.0, 1.0).astype(np.float32)
    m = ts.StreamingAUROC(num_bins=2048, device="cpu")
    e = ts.StreamingCalibrationError(num_bins=15, device="cpu")
    for p, t in _stream(preds, target):
        m.update(p, t)
        e.update(p, t)
    order = np.argsort(preds, kind="mergesort")
    ranks = np.empty(N_ORACLE, np.float64)
    ranks[order] = np.arange(1, N_ORACLE + 1, dtype=np.float64)
    sorted_p = preds[order]
    bounds = np.flatnonzero(np.diff(sorted_p)) + 1
    for s, end in zip(np.concatenate(([0], bounds)), np.concatenate((bounds, [N_ORACLE]))):
        if end - s > 1:
            ranks[order[s:end]] = 0.5 * (s + 1 + end)
    n_pos = int(target.sum())
    exact = (ranks[target == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * (N_ORACLE - n_pos))
    bound = float(m.error_bound())
    assert bound <= 0.005 and abs(float(m.compute()) - exact) <= bound + 1e-6
    assert float(e.compute()) == pytest.approx(_ece_oracle(preds, target, 15), abs=1e-4)


# the JAX package's sketch merge contracts, on the port: every shard order and several splits
@pytest.mark.parametrize("name", CLASSES)
def test_every_shard_permutation_and_split_reproduce_single_pass(name):
    batches = [b for seed in range(6) for b in _batches(name, 1000 + seed, n=1)]

    def fold(shards, order):
        replicas = []
        for shard in shards:
            m, _ = _pair(name)
            for args in shard:
                m.update(*(torch.from_numpy(x) for x in args))
            replicas.append(m)
        acc = replicas[order[0]]
        for i in order[1:]:
            acc.merge_state(replicas[i])
        return acc

    single = fold([batches], (0,))
    shards = [batches[0:2], batches[2:3], batches[3:6]]
    for order in itertools.permutations(range(3)):
        merged = fold(shards, order)
        _states_match(merged, single) if name != "StreamingCalibrationError" else _values_match(
            merged.compute(), single.compute())
    for split in ([batches[:1], batches[1:]], [batches[:3], batches[3:]], [[b] for b in batches]):
        _values_match(fold(split, tuple(range(len(split)))).compute(), single.compute())
