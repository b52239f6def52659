"""The port's observe runtime against the JAX package's.

Parity: the same sequence of updates, computes, merges, fake syncs and folds gives the same snapshot keys,
counters, events and span phases in both packages (only the timings differ; the JAX side runs its eager
update path, ``jit_update=False``, which is the path the port has); the host twins (DDSketch, CUSUM, PSI,
time-decayed rate) equal the JAX package's twins and the port's device metrics; the fleet meter's ledgers,
``sync_telemetry``'s merges and ``render_report``'s text are equal. Then the disabled-mode contract on the
port, and the framework-neutral cases of the JAX package's ``tests/test_observe_runtime.py``,
``test_observe_disabled.py``, ``test_watchdog.py``, ``test_metering.py`` and ``test_compile_explain.py`` on
the port.

Tolerances: host twins in float64 against the JAX package's host twins are equal (the same arithmetic);
against the port's float32 device metrics, ``rtol=1e-5`` (float32 rounding of sums of ~100 terms).
"""

from __future__ import annotations

import collections
import importlib
import json
import math
import re
import sys
import tracemalloc
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.aggregation as ja
import metrics_tpu.classification as jc
import metrics_tpu.observe as jobs
import metrics_tpu.parallel.sync as jsync
import metrics_tpu.regression as jr
import metrics_tpu_torch.aggregation as ta
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.observe as tobs
import metrics_tpu_torch.parallel.sync as tsync
import metrics_tpu_torch.regression as tr
from metrics_tpu.collections import MetricCollection as JCollection
from metrics_tpu.observe import explain as jexplain
from metrics_tpu.observe import latency as jlatency
from metrics_tpu.observe import metering as jmetering
from metrics_tpu.observe import recorder as jrec
from metrics_tpu.observe import watchdog as jwatchdog
from metrics_tpu_torch import metric as tmetric_mod
from metrics_tpu_torch.collections import MetricCollection as TCollection
from metrics_tpu_torch.observe import explain as texplain
from metrics_tpu_torch.observe import latency as tlatency
from metrics_tpu_torch.observe import metering as tmetering
from metrics_tpu_torch.observe import recorder as trec
from metrics_tpu_torch.observe import tracing as ttracing
from metrics_tpu_torch.observe import watchdog as twatchdog

DEVICE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _scoped():
    with tobs.scope(reset=True), jobs.scope(reset=True):
        yield
    for obs in (tobs, jobs):
        obs.uninstall_watchdog()
        obs.uninstall_meter()


class _Side:
    """One package's handles: its modules, how it makes an array, and the metric kwargs of its eager path."""

    def __init__(self, name, obs, rec, agg, cls, reg, sync, collection, arr, kw):
        self.name, self.obs, self.rec, self.agg, self.cls, self.reg = name, obs, rec, agg, cls, reg
        self.sync, self.collection, self.arr, self.kw = sync, collection, arr, kw


PORT = _Side("port", tobs, trec, ta, tc, tr, tsync, TCollection, lambda x: torch.from_numpy(np.asarray(x)),
             {"device": "cpu"})
JAX = _Side("jax", jobs, jrec, ja, jc, jr, jsync, JCollection, lambda x: jnp.asarray(np.asarray(x)),
            {"jit_update": False})


def _drive(side: _Side) -> None:
    """The same runtime sequence in either package: updates, computes (one cached), a merge, a sync that
    retries once, a degraded sync, a fold of two ranks, a rolled-back update and a collection's groups."""
    rng = np.random.RandomState(3)
    a = side.arr
    m1 = side.agg.SumMetric(**side.kw)
    m1.update(a(rng.rand(8).astype(np.float32)))
    m1.update(a(rng.rand(8).astype(np.float32)))
    m1.compute()
    m1.compute()
    m2 = side.agg.SumMetric(**side.kw)
    m2.update(a(rng.rand(4).astype(np.float32)))
    m1.merge_state(m2)
    calls = {"n": 0}

    def flaky(states, group):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return [[s, s] for s in states]

    with side.sync.sync_policy(side.sync.SyncPolicy(retries=1, backoff_s=0.0)):
        m1.sync(dist_sync_fn=flaky, distributed_available=True)
    m1.unsync()
    lost = side.sync.SyncPeerLostError("lost", survivors=[{"sum_value": a(np.float32(2.0))}], survivor_counts=[1])

    def dead(states, group):
        raise lost

    with side.sync.sync_policy(side.sync.SyncPolicy(partial_merge=True)):
        m1.sync(dist_sync_fn=dead, distributed_available=True)
    m1.unsync()
    side.sync.allreduce_over_mesh(
        [{"total": a(np.float32(1.0)), "rows": [a(np.arange(3, dtype=np.float32))]},
         {"total": a(np.float32(2.0)), "rows": [a(np.arange(5, dtype=np.float32))]}],
        {"total": "sum", "rows": "cat"},
    )
    mse = side.reg.MeanSquaredError(**side.kw)
    with pytest.raises(Exception):
        mse.update(a(np.zeros(3, np.float32)), a(np.zeros(4, np.float32)))
    col = side.collection([side.cls.MulticlassPrecision(num_classes=3, **side.kw),
                           side.cls.MulticlassRecall(num_classes=3, **side.kw)])
    for _ in range(2):
        col.update(a(rng.randint(0, 3, 16)), a(rng.randint(0, 3, 16)))
    col.compute()


# the port's own spans, which the JAX package has not: each validation that reads the card, the read itself
# (also an ``explicit_transfer`` of its site) and each kernel wrapper's call
PORT_ONLY_PHASES = ("validate", "host_read", "kernel")


def _telemetry(side: _Side):
    snap = side.obs.snapshot()
    spans = [(s["phase"], s["label"], s["depth"]) for s in side.obs.drain_spans()]
    events = [{k: v for k, v in e.items() if k not in ("detail", "error")} for e in snap["events"]]
    timers = {n: {lbl: agg["count"] for lbl, agg in by.items()} for n, by in snap["timers"].items()}
    latency = {p: {lbl: agg["count"] for lbl, agg in by.items()} for p, by in snap["latency"].items()}
    return snap, spans, events, timers, latency


def _port_only(telemetry):
    """Take the port's own validation, host-read and kernel telemetry out of ``telemetry`` and return it."""
    snap, spans, _, _, latency = telemetry
    own_spans = [s for s in spans if s[0] in PORT_ONLY_PHASES]
    spans[:] = [s for s in spans if s[0] not in PORT_ONLY_PHASES]
    reads = snap["counters"]["explicit_transfer"]
    own_reads = {site: reads.pop(site) for site in list(reads) if site != "collection_state_equal"}
    own_latency = {p: latency.pop(p) for p in PORT_ONLY_PHASES if p in latency}
    for p in PORT_ONLY_PHASES:
        snap["latency"].pop(p, None)
    snap["derived"]["spans_total"] -= len(own_spans)
    return own_spans, own_reads, own_latency


def test_the_same_sequence_gives_the_same_telemetry_in_both_packages():
    for side in (PORT, JAX):
        _drive(side)
    port, ref = _telemetry(PORT), _telemetry(JAX)
    own_spans, own_reads, own_latency = _port_only(port)
    # the collection's first update validates both metrics, its second the group's leader: each validation
    # reads the integer preds and the target
    assert own_reads == {"multiclass_stat_scores.preds": 3, "multiclass_stat_scores.target": 3}
    assert own_spans.count(("validate", "multiclass_stat_scores", 1)) == 3
    assert sorted(s for s in own_spans if s[0] == "host_read") == (
        [("host_read", "multiclass_stat_scores.preds", 2)] * 3 + [("host_read", "multiclass_stat_scores.target", 2)] * 3)
    assert own_latency == {"validate": {"multiclass_stat_scores": 3},
                           "host_read": {"multiclass_stat_scores.preds": 3, "multiclass_stat_scores.target": 3}}
    assert set(port[0]) == set(ref[0]) and set(port[0]["derived"]) == set(ref[0]["derived"])
    assert port[0]["counters"] == ref[0]["counters"]
    assert port[0]["counters"]["update_eager"]["SumMetric"] == 3
    assert port[0]["counters"]["explicit_transfer"] == {"collection_state_equal": 1}
    assert port[0]["counters"]["sync_bytes"] == {"rows": 40, "total": 8}
    assert port[2] == ref[2]  # events: kinds, metrics, attempts, survivors in order
    assert [e["kind"] for e in port[2]] == ["sync_retry", "sync_degraded", "update_rolled_back"]
    assert port[3] == ref[3]  # timer names, labels and counts
    assert port[1] == ref[1]  # span phases, labels and depths in order
    assert port[4] == ref[4]
    derived_p = {k: v for k, v in port[0]["derived"].items() if v is not None}
    derived_r = {k: v for k, v in ref[0]["derived"].items() if v is not None}
    assert derived_p == derived_r


def test_disabled_runs_record_nothing_in_either_package():
    for side in (PORT, JAX):
        side.obs.disable()
        _drive(side)
        rec = side.rec.RECORDER
        assert rec.counters == {} and rec.timers == {} and len(rec.events) == 0
        assert len(rec.spans) == 0 and rec.latency == {} and rec._span_total == 0
        assert side.obs.prometheus() == ""


# ----------------------------------------------------------------------------- host twins against both
def _latency_values(kind, rng):
    if kind == "lognormal":
        return rng.lognormal(mean=-3.0, sigma=1.5, size=4096)
    if kind == "signed":
        return rng.standard_normal(2048) * 10.0 ** rng.integers(-6, 4, 2048)
    v = rng.lognormal(size=1024)
    v[::17] = 0.0
    v[::29] = np.inf
    v[5] = np.nan
    return v


@pytest.mark.parametrize("kind", ["lognormal", "signed", "zeros_and_nonfinite"])
def test_host_ddsketch_buckets_equal_the_jax_twin_and_the_device_sketch(kind):
    from metrics_tpu_torch.functional.sketches.ddsketch import ddsketch_delta

    values = _latency_values(kind, np.random.default_rng(5))
    port, ref = tlatency.HostDDSketch(), jlatency.HostDDSketch()
    for v in values:
        port.observe(v)
        ref.observe(v)
    for field in ("pos", "neg"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field))
    assert (port.zero, port.count, port.min, port.max) == (ref.zero, ref.count, ref.min, ref.max)
    assert port.sum == ref.sum
    qs = [0.01, 0.5, 0.9, 0.99, 0.999]
    np.testing.assert_array_equal(port.quantiles(qs), ref.quantiles(qs))
    # the device sketch buckets float32 values by the float32 key; away from a bucket edge it agrees
    v32 = values.astype(np.float32)
    pos, neg, zero = ddsketch_delta(torch.from_numpy(v32), torch.ones(v32.shape, dtype=torch.bool),
                                    alpha=port.alpha, key_offset=port.key_offset, num_buckets=port.num_buckets)
    host = tlatency.HostDDSketch()
    keys = np.log(np.abs(v32[np.isfinite(v32) & (v32 != 0)]).astype(np.float64)) / host._ln_gamma
    near_edge = np.abs(keys - np.round(keys)) < 1e-4
    for v in v32.astype(np.float64):
        host.observe(v)
    assert int(zero) == host.zero
    moved = int(np.abs(pos.numpy() - host.pos).sum() + np.abs(neg.numpy() - host.neg).sum())
    assert moved <= 2 * int(near_edge.sum())
    assert int(pos.sum() + neg.sum() + zero) == host.count


def test_host_cusum_equals_the_jax_twin_and_the_device_cusum():
    from metrics_tpu_torch.drift import CUSUM

    xs = np.random.default_rng(4).normal(loc=0.3, size=256).astype(np.float32)
    port, ref = twatchdog.HostCUSUM(0.0, k=0.5), jwatchdog.HostCUSUM(0.0, k=0.5)
    device = CUSUM(target=0.0, k=0.5, h=1e9, device="cpu")
    for chunk in np.array_split(xs, 8):
        for x in chunk:
            port.observe(float(x))
            ref.observe(float(x))
        device.update(torch.from_numpy(chunk))
    assert port.state() == ref.state()
    s_pos, s_neg, _ = device.compute().tolist()
    assert port.pos[1] == pytest.approx(s_pos, rel=DEVICE_RTOL, abs=1e-5)
    assert port.neg[1] == pytest.approx(s_neg, rel=DEVICE_RTOL, abs=1e-5)
    assert port.watermark() == pytest.approx(max(float(device.pos[3]), float(device.neg[3])), rel=DEVICE_RTOL)
    # the segment fold of two halves, local first
    left, right = twatchdog.HostCUSUM(0.0), twatchdog.HostCUSUM(0.0)
    jleft, jright = jwatchdog.HostCUSUM(0.0), jwatchdog.HostCUSUM(0.0)
    for i, x in enumerate(xs):
        (left if i < 100 else right).observe(float(x))
        (jleft if i < 100 else jright).observe(float(x))
    left.merge_state(right.state())
    jleft.merge_state(jright.state())
    assert left.state() == jleft.state()


def test_host_psi_equals_the_jax_twin_and_the_device_psi():
    from metrics_tpu_torch.drift import PSI

    rng = np.random.default_rng(6)
    ref_v, live_v = rng.normal(size=5000).astype(np.float32), rng.normal(0.4, 1.2, 5000).astype(np.float32)
    device = PSI(lo=-3.0, hi=3.0, num_bins=10, device="cpu")
    device.update(torch.from_numpy(live_v), torch.from_numpy(ref_v))
    ref_counts, live_counts = device.ref_counts.tolist(), device.live_counts.tolist()
    port, jax_twin = twatchdog.host_psi(ref_counts, live_counts), jwatchdog.host_psi(ref_counts, live_counts)
    assert port == jax_twin
    assert port == pytest.approx(float(device.compute()), rel=DEVICE_RTOL)
    assert twatchdog.host_psi(ref_counts, ref_counts) == pytest.approx(0.0, abs=1e-12)


def test_host_time_decayed_rate_equals_the_jax_twin_and_the_device_window():
    from metrics_tpu_torch import SumMetric
    from metrics_tpu_torch.windows import TimeDecayed

    rng = np.random.default_rng(8)
    times = np.cumsum(rng.uniform(0.5, 5.0, 40)).astype(np.float32)
    counts = rng.integers(0, 20, 40).astype(np.float32)
    port, ref = twatchdog.HostTimeDecayedRate(30.0), jwatchdog.HostTimeDecayedRate(30.0)
    mass = TimeDecayed(SumMetric(nan_strategy="disable", device="cpu"), half_life_s=30.0)
    norm = TimeDecayed(SumMetric(nan_strategy="disable", device="cpu"), half_life_s=30.0)
    prev = None
    for t, n in zip(times.tolist(), counts.tolist()):
        port.observe(n, t)
        ref.observe(n, t)
        mass.update(t, torch.tensor(n))
        if prev is not None:
            norm.update(t, torch.tensor(t - prev))
        prev = t
    assert port.state() == ref.state()
    assert port._sum == pytest.approx(float(mass.compute()), rel=DEVICE_RTOL)
    assert port._norm == pytest.approx(float(norm.compute()), rel=DEVICE_RTOL)
    other, jother = twatchdog.HostTimeDecayedRate(30.0), jwatchdog.HostTimeDecayedRate(30.0)
    for h in (other, jother):
        h.observe(3.0, 10.0)
        h.observe(4.0, float(times[-1]) + 3.0)
    port.merge_state(other.state())
    ref.merge_state(jother.state())
    assert port.state() == ref.state()


# ----------------------------------------------------------------------------- metering, latency merge, report
def _meter_sequence(mod):
    mt = mod.FleetMeter(top_k=4, sketch_capacity=8, policy=mod.MeterPolicy(max_updates=3, action="demote"))
    rng = np.random.RandomState(9)
    for i in range(30):
        wave = [f"s{j}" for j in rng.choice(12, size=rng.randint(1, 5), replace=False)]
        mt.note_dispatch(f"b{i % 3}", wave, 0.001 * (1 + i % 7), cost_key=("b", i % 3), cost_fn=lambda: (64.0, 32.0))
    mt.note_failed_dispatch("b0", 0.004)
    mt.note_loose_update("s1")
    mt.note_quarantine("s2")
    mt.note_wal_bytes("s0", 128)
    mt.note_ckpt_bytes(["s0", "s1", "s9"], 96)
    mt.note_ingest("producer-a", records=10, nbytes=640, dedup_skipped=1)
    mt.note_bucket_memory("engine", "b0", capacity=8, active=5, row_bytes=32)
    mt.note_bucket_memory("engine", "b1", capacity=4, active=4, row_bytes=16)
    mt.poll_quota(now=100.0)
    return mt


def test_fleet_meter_and_spacesaving_ledgers_equal_the_jax_package():
    port, ref = _meter_sequence(tmetering), _meter_sequence(jmetering)
    assert port.export_state() == ref.export_state()
    assert port.snapshot_payload() == ref.snapshot_payload()
    assert port.pending_demotions() == ref.pending_demotions()
    names = (jrec._prom_name, jrec._prom_label)

    def samples(lines):  # the help texts name the cost model's source, XLA's in the JAX package
        return [line for line in lines if not line.startswith("# HELP")]

    assert samples(port.prometheus_lines(*names)) == samples(ref.prometheus_lines(*names))
    shards_p, shards_r = [_meter_sequence(tmetering) for _ in range(2)], [_meter_sequence(jmetering) for _ in range(2)]
    folded_p = tmetering.FleetMeter(top_k=4, sketch_capacity=8).sync_telemetry([s.export_state() for s in shards_p])
    folded_r = jmetering.FleetMeter(top_k=4, sketch_capacity=8).sync_telemetry([s.export_state() for s in shards_r])
    assert folded_p.export_state() == folded_r.export_state()
    keys = [str(int(x)) for x in np.random.default_rng(2).zipf(1.5, 20_000) if x < 500]
    sk_p, sk_r = tmetering.SpaceSaving(32), jmetering.SpaceSaving(32)
    for k in keys:
        sk_p.offer(k)
        sk_r.offer(k)
    assert sk_p.items() == sk_r.items() and sk_p.state() == sk_r.state()


def test_sync_telemetry_merges_equal_the_jax_package():
    rng = np.random.default_rng(11)
    durations = rng.lognormal(-4.0, 1.0, size=(3, 200))
    peers = []
    for obs_side in ((PORT, JAX)):
        obs_side.obs.reset()
    for d in durations[0]:
        tobs.record_complete("update", "A", 0.0, float(d))
        jobs.record_complete("update", "A", 0.0, float(d))
    for row in durations[1:]:
        peer = tlatency.HostDDSketch()
        for d in row:
            peer.observe(float(d))
        peers.append({"update": {"A": peer.state()}, "tick": {"engine": peer.state()}})
    merged_p = tobs.sync_telemetry(peers)
    merged_r = jobs.sync_telemetry(json.loads(json.dumps(peers)))
    assert merged_p == merged_r
    assert merged_p["update"]["A"]["count"] == 600
    assert tlatency.export_state() == jlatency.export_state()
    assert tlatency.snapshot_latency() == jlatency.snapshot_latency()


def _compile_misses(rec_mod):
    rec_mod.note_compile_miss("shared_jit", "Acc", (("class", "Acc"), ("config:num_classes", 4), ("x64", False)))
    rec_mod.note_compile_miss("shared_jit", "Acc", (("class", "Acc"), ("config:num_classes", 5), ("x64", False)))
    rec_mod.note_compile_miss("shared_jit", "Acc", (("class", "Acc"), ("config:num_classes", 5), ("x64", False)))
    rec_mod.note_compile_miss("fleet", "Acc@1", (("capacity", 8), ("batch_avals", "f32")))
    rec_mod.note_compile_miss("fleet", "Acc@1", (("capacity", 16), ("batch_avals", "f64")))


def test_render_report_text_equals_the_jax_package():
    _compile_misses(trec)
    _compile_misses(jrec)
    sp, sr = tobs.snapshot(), jobs.snapshot()
    assert sp["counters"]["compile_cause"] == sr["counters"]["compile_cause"] == {
        "first": 2, "config:num_classes": 1, "rebuild": 1, "multiple": 1}
    assert texplain.render_report(sp) == jexplain.render_report(sr)
    assert texplain.render_report(sp, tail=1) == jexplain.render_report(sr, tail=1)
    assert texplain.render_report({}) == jexplain.render_report({})


def _watchdog_stimuli(obs, rec_mod, wd):
    signals = []
    rec_mod.RECORDER.set_gauge("fleet_rows_active", "b", 3.0)
    rec_mod.RECORDER.set_gauge("fleet_rows_capacity", "b", 4.0)
    for i in range(6):
        for j in range(i % 3):
            rec_mod.note_engine_compile("fleet", f"m{i}_{j}", 1)
        rec_mod.note_engine_hit("fleet", "m")
        rec_mod.RECORDER.set_gauge("wal_lag_records", "w", 5000.0 * i)
        obs.record_complete("tick", "engine", 0.0, 0.01 * (i + 1))
        rec_mod.RECORDER.add_count("fleet_dispatch", "b", 2)
        rec_mod.RECORDER.add_count("fleet_flush", "b", 1)
        signals.append(wd.sample(now=10.0 * i))
    return signals


def test_watchdog_signals_and_verdicts_equal_the_jax_package():
    port = _watchdog_stimuli(tobs, trec, twatchdog.Watchdog(min_interval_s=0.0))
    ref = _watchdog_stimuli(jobs, jrec, jwatchdog.Watchdog(min_interval_s=0.0))
    for p, r in zip(port, ref):
        assert p.pop("update_p99_s") is None  # the port's one extra signal: no update ran
        assert p == r
    sp, sr = tobs.snapshot(), jobs.snapshot()
    assert sp["counters"] == sr["counters"] and sp["gauges"] == sr["gauges"] | {
        "watchdog_signal": {k: v for k, v in sp["gauges"]["watchdog_signal"].items()}}
    strip = [{k: v for k, v in e.items() if k != "seq"} for e in sp["events"]]
    assert strip == [{k: v for k, v in e.items() if k != "seq"} for e in sr["events"]]


def test_prometheus_text_equals_the_jax_package_on_the_same_stimuli():
    for rec_mod, obs in ((trec, tobs), (jrec, jobs)):
        rec_mod.RECORDER.add_count("update_eager", 'We"ird\\label\n', 3)
        rec_mod.RECORDER.set_gauge("wal_lag_records", "w", 7.0)
        rec_mod.RECORDER.add_time("update", "A", 0.25)
        obs.record_complete("update", "A", 0.0, 0.25)
    assert tobs.prometheus() == jobs.prometheus()


# ----------------------------------------------------------------------------- the disabled-mode contract
def test_disabled_is_the_default():
    spec = importlib.util.find_spec("metrics_tpu_torch.observe.recorder")
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    assert fresh.ENABLED is False and fresh.enabled() is False


class _FlagReads:
    """Stands in for the recorder module in ``metric.py``: counts every attribute read."""

    def __init__(self, real):
        self.__dict__["_real"], self.__dict__["reads"] = real, collections.Counter()

    def __getattr__(self, name):
        self.reads[name] += 1
        return getattr(self._real, name)


def test_update_reads_one_flag_while_disabled(monkeypatch):
    tobs.disable()
    proxy = _FlagReads(trec)
    monkeypatch.setattr(tmetric_mod, "_observe", proxy)
    m = ta.SumMetric(device="cpu")
    m.update(torch.tensor([1.0, 2.0]))
    assert dict(proxy.reads) == {"ENABLED": 1}
    proxy.reads.clear()
    m.compute()
    assert dict(proxy.reads) == {"ENABLED": 1}
    proxy.reads.clear()
    tobs.enable()
    m.update(torch.tensor([1.0]))
    # the update's span reads the clock itself (observe/tracing.py), twice
    assert proxy.reads["ENABLED"] == 1 and proxy.reads["clock"] == 0 and proxy.reads["RECORDER"] == 1


def test_disabled_span_is_the_preallocated_singleton_and_allocates_nothing():
    tobs.disable()
    s1, s2 = tobs.span("tick", "engine"), tobs.span("flush", "other")
    assert s1 is s2 is ttracing._NULL_SPAN
    assert ttracing.profiler_range("update", "A") is ttracing._NULL_SPAN
    tobs.enable()
    assert ttracing.profiler_range("update", "A") is ttracing._NULL_SPAN  # no profiler records
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(ttracing.profiler_range("update", "A"), torch.profiler.record_function)
    tobs.disable()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with tobs.span("tick", "engine"):
                pass
            tobs.record_complete("tick", "engine", 0.0, 1.0)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = tracemalloc.Filter(True, ttracing.__file__)
    grown = [d for d in after.filter_traces([mine]).compare_to(before.filter_traces([mine]), "lineno") if d.size_diff > 0]
    assert grown == []
    rec = trec.RECORDER
    assert len(rec.spans) == 0 and rec.latency == {} and rec._span_total == 0
    assert tobs.timeline()["traceEvents"] == []


def test_record_event_is_a_noop_while_disabled():
    tobs.disable()
    tobs.record_event("probe", x=1)
    assert len(trec.RECORDER.events) == 0
    tobs.enable(reset=True)
    tobs.record_event("probe", x=1)
    assert len(trec.RECORDER.events) == 1


def test_enabled_and_disabled_runs_are_numerically_identical():
    values = [torch.tensor([1.0, 2.5]), torch.tensor([3.25])]
    tobs.disable()
    off = tr.MeanSquaredError(device="cpu")
    for v in values:
        off.update(v, v * 0.5)
    tobs.enable(reset=True)
    on = tr.MeanSquaredError(device="cpu")
    for v in values:
        on.update(v, v * 0.5)
    assert on.state_fingerprint() == off.state_fingerprint()
    assert torch.equal(on.compute(), off.compute())


def test_one_time_fallback_warning_fires_even_while_disabled():
    tobs.disable()
    trec.reset(include_warnings=True)
    with pytest.warns(UserWarning, match="Probe.*latched eager"):
        trec.note_eager_fallback("Probe", RuntimeError("x"))
    assert trec.RECORDER.counters == {}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        trec.note_eager_fallback("Probe", RuntimeError("x"))


# ----------------------------------------------------------------------------- the runtime cases on the port
def test_update_and_compute_timers_aggregate():
    m = ta.SumMetric(device="cpu")
    m.update(torch.tensor(1.0))
    m.update(torch.tensor(2.0))
    assert float(m.compute()) == 3.0
    snap = tobs.snapshot()
    upd = snap["timers"]["update"]["SumMetric"]
    assert upd["count"] == 2
    assert upd["total_s"] >= upd["max_s"] >= upd["min_s"] >= 0.0
    assert upd["mean_s"] == pytest.approx(upd["total_s"] / 2)
    assert snap["timers"]["compute"]["SumMetric"]["count"] == 1
    m.compute()
    snap = tobs.snapshot()
    assert snap["timers"]["compute"]["SumMetric"]["count"] == 1
    assert snap["counters"]["compute_cached"] == {"SumMetric": 1}
    assert snap["counters"]["update_eager"] == {"SumMetric": 2}


def test_merge_and_allreduce_instrumented():
    m1, m2 = ta.SumMetric(device="cpu"), ta.SumMetric(device="cpu")
    m1.update(torch.tensor(1.0))
    m2.update(torch.tensor(2.0))
    m1.merge_state(m2)
    assert float(m1.compute()) == 3.0
    snap = tobs.snapshot()
    assert snap["counters"]["merge"] == {"SumMetric": 1}
    assert snap["timers"]["merge"]["SumMetric"]["count"] == 1
    synced = tsync.allreduce_over_mesh([{"total": torch.tensor(2.0)}], {"total": "sum"})
    assert float(synced["total"]) == 2.0
    snap = tobs.snapshot()
    assert snap["counters"]["allreduce"] == {"data": 1}
    assert snap["timers"]["allreduce"]["data"]["count"] == 1
    assert snap["derived"]["sync_bytes_total"] == 4 and snap["counters"]["sync_bytes"] == {"total": 4}


def test_snapshot_schema_is_stable_and_json_able():
    ta.SumMetric(device="cpu").update(torch.tensor(1.0))
    snap = tobs.snapshot()
    assert set(snap) == {"enabled", "schema_version", "counters", "timers", "events", "gauges", "latency",
                         "series", "derived", "metering"}
    assert snap["enabled"] is True
    assert snap["schema_version"] == tobs.SCHEMA_VERSION == jobs.SCHEMA_VERSION == 4
    assert snap["metering"] == {"installed": False}
    assert set(snap["derived"]) == set(jobs.snapshot()["derived"])
    assert len(snap["derived"]) == 57
    for by_label in snap["timers"].values():
        for agg in by_label.values():
            assert set(agg) == {"count", "total_s", "mean_s", "min_s", "max_s"}
    assert snap["latency"]
    for by_label in snap["latency"].values():
        for agg in by_label.values():
            assert set(agg) == {"count", "total_s", "mean_s", "min_s", "max_s", "p50_s", "p90_s", "p99_s", "p999_s"}
    roundtrip = json.loads(tobs.snapshot_json())
    assert roundtrip["counters"] == snap["counters"]


def test_event_log_is_bounded_ring_buffer():
    tobs.enable(max_events=4, reset=True)
    for i in range(10):
        tobs.record_event("probe", i=i)
    events = tobs.snapshot()["events"]
    assert [e["i"] for e in events] == [6, 7, 8, 9]
    assert [e["seq"] for e in events] == [7, 8, 9, 10]


def test_span_ring_is_bounded_and_timeline_is_chrome_trace_json():
    tobs.enable(max_spans=3, reset=True)
    with tobs.span("epoch", "eval"):
        for _ in range(4):
            ta.SumMetric(device="cpu").update(torch.tensor(1.0))
    trace = json.loads(json.dumps(tobs.timeline()))
    assert trace["otherData"]["spans_total"] == 5 and trace["otherData"]["spans_retained"] == 3
    assert {e["ph"] for e in trace["traceEvents"]} == {"X"}
    names = sorted(e["name"] for e in trace["traceEvents"])
    assert names == ["epoch:eval", "update:SumMetric", "update:SumMetric"]
    depths = {e["name"]: e["args"]["depth"] for e in trace["traceEvents"]}
    assert depths == {"epoch:eval": 0, "update:SumMetric": 1}
    assert len(tobs.drain_spans()) == 3 and tobs.timeline()["traceEvents"] == []


def test_prometheus_text_format():
    m = ta.SumMetric(device="cpu")
    m.update(torch.tensor(1.0))
    ta.SumMetric(device="cpu").update(torch.tensor(1.0))
    m.compute()
    text = tobs.prometheus()
    assert "# TYPE metrics_tpu_update_eager_total counter" in text
    assert 'metrics_tpu_update_eager_total{metric="SumMetric"} 2' in text
    assert 'metrics_tpu_update_seconds_count{metric="SumMetric"} 2' in text
    assert 'metrics_tpu_phase_update_seconds{label="SumMetric",quantile="0.99"}' in text
    for line in text.strip().splitlines():
        assert line.startswith("#") or " " in line


def test_prometheus_label_values_escaped_per_exposition_format():
    trec.note_engine_compile("fleet", 'A\\B"C\nD', 1)
    trec.note_engine_compile("fleet", "A\\B\"C D", 1)
    text = tobs.prometheus()
    assert 'metric="A\\\\B\\"C\\nD"' in text
    assert 'metric="A\\\\B\\"C D"' in text
    series = [line for line in text.splitlines() if 'metric="A' in line]
    assert len(series) == 2 and all(line.endswith(" 1") for line in series)


def test_reset_drops_telemetry_and_rearms_warnings():
    with pytest.warns(UserWarning):
        trec.note_eager_fallback("Hosty", RuntimeError("x"))
    trec.reset()
    assert tobs.snapshot()["counters"] == {}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        trec.note_eager_fallback("Hosty", RuntimeError("x"))
    trec.reset(include_warnings=True)
    with pytest.warns(UserWarning):
        trec.note_eager_fallback("Hosty", RuntimeError("x"))


def test_collection_updates_its_leaders_one_span_each_and_no_fused_span():
    col = TCollection([tc.MulticlassPrecision(num_classes=3, device="cpu"),
                       tc.MulticlassRecall(num_classes=3, device="cpu"),
                       tc.MulticlassAccuracy(num_classes=3, average="micro", device="cpu")])
    p, t = torch.tensor([0, 1, 2, 1]), torch.tensor([0, 2, 2, 1])
    for _ in range(3):
        col.update(p, t)
    snap = tobs.snapshot()
    # first update: all three; later: one per group (precision and recall share a group)
    assert snap["counters"]["update_eager"] == {"MulticlassPrecision": 3, "MulticlassAccuracy": 3,
                                                "MulticlassRecall": 1}
    assert "fused_update" not in snap["timers"] and "fused_compile" not in snap["counters"]
    # one validation a leader's update, each reading the integer preds and the target
    assert snap["counters"]["explicit_transfer"] == {"collection_state_equal": 1, "multiclass_stat_scores.preds": 7,
                                                     "multiclass_stat_scores.target": 7}


def test_rolled_back_update_records_its_cause_and_keeps_the_state():
    m = tr.MeanSquaredError(device="cpu")
    m.update(torch.ones(3), torch.zeros(3))
    before = m.state_fingerprint()
    with pytest.raises(Exception) as info:
        m.update(torch.ones(3), torch.zeros(4))
    assert m.state_fingerprint() == before
    snap = tobs.snapshot()
    assert snap["derived"]["updates_rolled_back_total"] == 1
    [event] = [e for e in snap["events"] if e["kind"] == "update_rolled_back"]
    assert event["metric"] == "MeanSquaredError" and event["error"] == type(info.value).__name__


def test_sync_retry_and_degraded_merge_are_recorded():
    m = ta.SumMetric(device="cpu")
    m.update(torch.tensor(2.0))
    calls = {"n": 0}

    def flaky(states, group):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("transient")
        return [[s, s] for s in states]

    with tsync.sync_policy(tsync.SyncPolicy(retries=2, backoff_s=0.0)):
        m.sync(dist_sync_fn=flaky, distributed_available=True)
    assert float(m.sum_value) == 4.0
    m.unsync()
    lost = tsync.SyncPeerLostError("gone", survivors=[{"sum_value": torch.tensor(5.0)}], survivor_counts=[2])

    def dead(states, group):
        raise lost

    with tsync.sync_policy(tsync.SyncPolicy(partial_merge=True)):
        m.sync(dist_sync_fn=dead, distributed_available=True)
    assert float(m.sum_value) == 7.0
    m.unsync()
    snap = tobs.snapshot()
    assert snap["derived"]["sync_retries_total"] == 2 and snap["derived"]["sync_degraded_total"] == 1
    assert [e["attempt"] for e in snap["events"] if e["kind"] == "sync_retry"] == [1, 2]
    assert snap["counters"]["sync"] == {"SumMetric": 1} and snap["timers"]["sync"]["SumMetric"]["count"] == 2


def test_each_timed_call_runs_inside_its_profiler_range():
    m = ta.SumMetric(device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m.update(torch.tensor([1.0, 2.0]))
        m.compute()
        with tobs.span("ckpt", "save"):
            pass
    names = {e.key for e in prof.key_averages()}
    assert {"update:SumMetric", "compute:SumMetric", "ckpt:save"} <= names
    update = next(e for e in prof.events() if e.name == "update:SumMetric")
    inner = [e for e in prof.events() if e.name.startswith("aten::add")
             and update.time_range.start <= e.time_range.start <= update.time_range.end]
    assert inner  # the state's addition ran inside the range


def test_gather_all_states_counts_bytes_over_a_process_group_of_one(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        out = tsync.gather_all_states([torch.arange(6, dtype=torch.float32), [torch.ones(2), torch.ones(3)],
                                       torch.tensor(1, dtype=torch.int64)])
    finally:
        dist.destroy_process_group()
    assert torch.equal(out[0][0], torch.arange(6, dtype=torch.float32)) and out[1][0].shape == (5,)
    snap = tobs.snapshot()
    assert snap["counters"]["sync_bytes"] == {"state0": 24, "state1": 20, "state2": 8}
    assert snap["counters"]["gather_all"] == {"1": 1} and snap["timers"]["gather_all"]["1"]["count"] == 1


# ----------------------------------------------------------------------------- the watchdog cases on the port
def test_host_cusum_matches_sequential_recursion_oracle():
    xs = np.random.default_rng(3).normal(loc=0.3, scale=1.0, size=200)
    c = twatchdog.HostCUSUM(0.0, k=0.5)
    s_pos = s_neg = hi_pos = hi_neg = 0.0
    for x in xs:
        c.observe(float(x))
        s_pos = max(0.0, s_pos + (float(x) - 0.5))
        s_neg = max(0.0, s_neg + (-float(x) - 0.5))
        hi_pos, hi_neg = max(hi_pos, s_pos), max(hi_neg, s_neg)
        assert c.statistic() == pytest.approx(max(s_pos, s_neg), abs=1e-9)
    assert c.watermark() == pytest.approx(max(hi_pos, hi_neg), abs=1e-9)
    skipper = twatchdog.HostCUSUM(0.0)
    skipper.observe(float("nan"))
    skipper.observe(float("inf"))
    assert skipper.statistic() == 0.0
    with pytest.raises(ValueError):
        twatchdog.HostCUSUM(0.0, k=-1.0)


def test_host_time_decayed_rate_oracle_and_merge():
    r = twatchdog.HostTimeDecayedRate(half_life_s=10.0)
    assert r.rate() is None
    r.observe(5.0, now=100.0)
    assert r.rate() is None
    r.observe(5.0, now=110.0)
    assert r.rate() == pytest.approx((5.0 * 0.5 + 5.0) / 10.0)
    a, b = twatchdog.HostTimeDecayedRate(10.0), twatchdog.HostTimeDecayedRate(10.0)
    for h in (a, b):
        h.observe(3.0, now=100.0)
        h.observe(3.0, now=110.0)
    solo = a.rate()
    a.merge_state(b.state())
    assert a.rate() == pytest.approx(2.0 * solo)
    with pytest.raises(ValueError):
        twatchdog.HostTimeDecayedRate(0.0)


def test_host_psi_zero_on_identical_positive_on_shift_none_on_empty():
    ref = [10.0, 20.0, 30.0, 40.0]
    assert twatchdog.host_psi(ref, list(ref)) == pytest.approx(0.0, abs=1e-12)
    assert twatchdog.host_psi(ref, [40.0, 30.0, 20.0, 10.0]) > 0.1
    assert twatchdog.host_psi([], ref) is None
    assert twatchdog.host_psi(ref, [0.0] * 4) is None
    assert twatchdog.host_psi(ref, ref[:3]) is None


def test_slo_rule_validates_and_compares():
    rule = tobs.SloRule("lag", "wal_lag_records", "<=", 100.0, for_ticks=2)
    assert rule.healthy(100.0) and not rule.healthy(100.5)
    with pytest.raises(ValueError):
        tobs.SloRule("bad", "x", "==", 1.0)
    with pytest.raises(ValueError):
        tobs.SloRule("bad", "x", "<=", 1.0, for_ticks=0)
    assert [repr(r) for r in tobs.DEFAULT_SLOS] == [repr(r) for r in jobs.DEFAULT_SLOS]


def test_slo_fires_after_for_ticks_and_none_signal_carries_state():
    wd = tobs.Watchdog(rules=(tobs.SloRule("lag", "wal_lag_records", "<=", 10.0, for_ticks=2),), min_interval_s=0.0)
    trec.RECORDER.set_gauge("wal_lag_records", "w", 50.0)
    wd.sample()
    assert wd.health()["ok"]
    wd.sample()
    health = wd.health()
    assert not health["ok"] and health["firing"] == ["lag"]
    snap = tobs.snapshot()
    assert snap["derived"]["slo_alerts_fired_total"] == 1 and snap["derived"]["slo_alerts_firing"] == 1
    wd.sample()
    assert tobs.snapshot()["derived"]["slo_alerts_fired_total"] == 1
    trec.RECORDER.set_gauge("wal_lag_records", "w", 0.0)
    wd.sample()
    snap = tobs.snapshot()
    assert wd.health()["ok"] and snap["derived"]["slo_alerts_resolved_total"] == 1
    assert snap["derived"]["slo_alerts_firing"] == 0


def test_recompile_storm_fires_within_for_ticks_and_resolves_after():
    rule = next(r for r in tobs.DEFAULT_SLOS if r.name == "recompile_storm")
    wd = tobs.Watchdog(rules=(rule,), min_interval_s=0.0)
    wd.sample()
    fired_at = None
    for i in range(4):
        for j in range(4):
            trec.note_engine_compile("fleet", f"storm_{i}_{j}", 1)
        wd.sample()
        if not wd.health()["ok"]:
            fired_at = i + 1
            break
    assert fired_at is not None and fired_at <= rule.for_ticks + 1
    for _ in range(16):
        wd.sample()
        if wd.health()["ok"]:
            break
    assert wd.health()["verdict"] == "healthy"
    assert tobs.snapshot()["derived"]["slo_alerts_resolved_total"] == 1


def test_latency_regression_fires_tick_p99_slo():
    rule = next(r for r in tobs.DEFAULT_SLOS if r.name == "tick_latency_p99")
    wd = tobs.Watchdog(rules=(rule,), min_interval_s=0.0)
    for _ in range(8):
        tobs.record_complete("tick", "engine", 0.0, 0.5)
        wd.sample()
    health = wd.health()
    assert health["firing"] == ["tick_latency_p99"] and health["signals"]["tick_p99_s"] >= 0.25


def test_update_p99_rule_fires_below_the_measured_latency_and_resolves_when_raised():
    rule = tobs.SloRule("update_p99", "update_p99_s", "<=", 1e-9, for_ticks=1)
    wd = tobs.Watchdog(rules=(rule,), min_interval_s=0.0)
    m = ta.SumMetric(device="cpu")
    m.update(torch.tensor(1.0))
    assert wd.sample()["update_p99_s"] is None  # the first sample with data seeds the window
    for _ in range(3):
        m.update(torch.tensor(1.0))
    signals = wd.sample()
    assert signals["update_p99_s"] > 1e-9 and wd.health()["firing"] == ["update_p99"]
    rule.threshold = 60.0
    m.update(torch.tensor(1.0))
    wd.sample()
    assert wd.health()["ok"]
    kinds = [e["kind"] for e in tobs.snapshot()["events"]]
    assert kinds == ["slo_fired", "slo_resolved"]
    assert wd.sample()["update_p99_s"] is None  # no update since the last sample


def test_export_state_is_json_able_and_sync_merges_peer_shards():
    a, b = tobs.Watchdog(min_interval_s=0.0), tobs.Watchdog(min_interval_s=0.0)
    for i in range(3):
        trec.note_engine_compile("fleet", f"a{i}", 1)
        a.sample()
    state = json.loads(json.dumps(b.export_state()))
    before = a.health()["samples"]
    a.sync_telemetry([state])
    assert a.health()["samples"] == before + b.health()["samples"]
    assert math.isfinite(next(iter(a._cusums.values())).statistic())


def test_installed_watchdog_is_poked_at_most_once_per_interval():
    wd = tobs.install_watchdog(min_interval_s=3600.0)
    assert tobs.installed_watchdog() is wd and trec._WATCHDOG is wd
    for _ in range(5):
        tobs.poke_watchdog()
    assert tobs.snapshot()["derived"]["watchdog_samples_total"] == 1
    tobs.uninstall_watchdog()
    tobs.poke_watchdog()
    assert tobs.installed_watchdog() is None and tobs.snapshot()["derived"]["watchdog_samples_total"] == 1


_SAMPLE_RE = re.compile(r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(?P<labels>.*)\})? (?P<value>[0-9eE+.\-]+|NaN)$')


def _parse_exposition(text):
    helped, typed, samples = set(), set(), []
    for line in text.strip().splitlines():
        if line.startswith("# HELP "):
            helped.add(line.split()[2])
        elif line.startswith("# TYPE "):
            typed.add(line.split()[2])
        else:
            m = _SAMPLE_RE.match(line)
            assert m, f"unparseable exposition line: {line!r}"
            samples.append(m)
    return helped, typed, samples


def test_prometheus_round_trips_watchdog_and_alert_families():
    wd = tobs.Watchdog(rules=(tobs.SloRule("lag", "wal_lag_records", "<=", 1.0, for_ticks=1),), min_interval_s=0.0)
    trec.RECORDER.set_gauge("wal_lag_records", "w", 9.0)
    nasty = 'he said "hi"\\\nbye'
    trec.RECORDER.add_count("compile_explain", nasty)
    wd.sample()
    wd.sample()
    text = tobs.prometheus()
    helped, typed, samples = _parse_exposition(text)
    seen = set()
    for m in samples:
        name = m.group("name")
        assert name.startswith("metrics_tpu_")
        base = next((name[: -len(s)] for s in ("_total", "_count", "_sum") if name.endswith(s)), name)
        assert (base in helped or name in helped) and (base in typed or name in typed)
        seen.add(name)
    assert {"metrics_tpu_watchdog_signal", "metrics_tpu_slo_firing", "metrics_tpu_slo_fired_total",
            "metrics_tpu_watchdog_sample_total"} <= seen
    [lab] = re.findall(r'metrics_tpu_compile_explain_total\{metric="(.*)"\} 1', text)
    assert lab.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\") == nasty


# ----------------------------------------------------------------------------- the metering cases on the port
def test_spacesaving_matches_exact_oracle_on_skewed_stream():
    stream = np.random.default_rng(7).zipf(1.6, size=100_000)
    stream = stream[stream < 10_000]
    exact = collections.Counter(int(x) for x in stream)
    sk = tobs.SpaceSaving(capacity=64)
    for x in stream:
        sk.offer(str(int(x)))
    bound = sk.error_bound()
    assert sk.total == pytest.approx(float(len(stream))) and bound == pytest.approx(len(stream) / 64)
    for key, est, err in sk.items():
        true = exact[int(key)]
        assert err <= bound + 1e-9 and true <= est + 1e-9 and est - true <= err + 1e-9
    tracked = {key for key, _e, _r in sk.items()}
    assert all(str(k) in tracked for k, n in exact.items() if n > bound)


def test_spacesaving_merge_stays_within_the_mergeable_summaries_bound():
    stream = [str(int(x)) for x in np.random.default_rng(11).zipf(1.5, size=50_000) if x < 5_000]
    exact = collections.Counter(stream)
    shards = [tobs.SpaceSaving(64) for _ in range(4)]
    for i, key in enumerate(stream):
        shards[i % 4].offer(key)
    merged = tobs.SpaceSaving(64)
    for sh in shards:
        merged.merge(sh)
    assert merged.total == pytest.approx(float(len(stream)))
    blur = sum(sh.error_bound() for sh in shards) + 1e-9
    assert all(abs(est - exact[key]) <= blur for key, est, _ in merged.items())
    back = tobs.SpaceSaving.from_state(json.loads(json.dumps(merged.state())))
    assert back.items() == merged.items() and back.capacity == 64
    with pytest.raises(ValueError):
        tobs.SpaceSaving(0)


def test_dispatch_wall_amortizes_evenly_and_failed_dispatches_attribute_nothing():
    mt = tobs.FleetMeter(top_k=8)
    mt.note_dispatch("b0", ["s1", "s2", "s3", "s4"], 0.4)
    assert mt.totals()["attribution_pct"] == pytest.approx(100.0)
    assert all(row["dispatch_s"] == pytest.approx(0.1) and row["updates"] == 1 for row in mt.top_sessions())
    mt.note_failed_dispatch("b0", 0.4)
    assert mt.totals()["attribution_pct"] == pytest.approx(50.0)
    with pytest.raises(ValueError):
        tobs.FleetMeter(top_k=0)


def test_sessions_beyond_top_k_fold_into_sketch():
    mt = tobs.FleetMeter(top_k=2, sketch_capacity=8)
    for i in range(5):
        mt.note_dispatch("b0", [f"s{i}"], 0.1)
    t = mt.totals()
    assert (t["sessions_exact"], t["sessions_sketched"]) == (2, 3)
    assert t["sketch_total_s"] == pytest.approx(0.3)
    assert [mt.explain_session(s)["tracked"] for s in ("s0", "s4", "nope")] == ["exact", "sketch", None]


def test_sharded_fold_agrees_with_single_ledger_oracle():
    weights = np.random.default_rng(3).zipf(1.4, size=400).astype(float)
    oracle = tobs.FleetMeter(top_k=16, sketch_capacity=32)
    shards = [tobs.FleetMeter(top_k=16, sketch_capacity=32) for _ in range(4)]
    for i, w in enumerate(weights):
        oracle.note_dispatch("b", [f"s{i}"], 1e-3 * w)
        shards[i % 4].note_dispatch("b", [f"s{i}"], 1e-3 * w)
    folded = tobs.FleetMeter(top_k=16, sketch_capacity=32).sync_telemetry([s.export_state() for s in shards])
    assert folded.totals()["attributed_s"] == pytest.approx(oracle.totals()["attributed_s"])
    blur = folded.totals()["sketch_error_bound_s"] + 1e-9
    for row in folded.top_sessions(n=10):
        true = 1e-3 * weights[int(row["session"][1:])]
        assert true - 1e-9 <= row["dispatch_s"] <= true + blur


def test_meter_policy_observes_and_demotes_without_failing_anything():
    mt = tobs.install_meter(top_k=4, policy=tobs.MeterPolicy(max_updates=2, action="demote", cooldown_s=1e9))
    for _ in range(3):
        mt.note_dispatch("b", ["hog", "ok"], 0.01) if _ == 0 else mt.note_dispatch("b", ["hog"], 0.01)
    mt.poll_quota(now=1.0)
    mt.poll_quota(now=2.0)
    assert mt.pending_demotions() == ["hog"]
    mt.confirm_demotion("hog")
    assert mt.pending_demotions() == []
    snap = tobs.snapshot()
    assert snap["counters"]["quota_exceeded"] == {"updates": 1}
    assert snap["metering"]["installed"] is True and snap["derived"]["meter_sessions_tracked"] == 2
    assert snap["gauges"]["quota_sessions_over"] == {"meter": 1.0}
    with pytest.raises(ValueError):
        tobs.MeterPolicy(action="kill")


def test_prometheus_metering_families_parse_with_bounded_cardinality():
    mt = tobs.install_meter(top_k=4, sketch_capacity=8)
    nasty = 'job "a"\\\nb'
    mt.note_dispatch("b0", [nasty], 0.01)
    for i in range(50):
        mt.note_dispatch("b0", [f"s{i}"], 0.01)
    mt.note_bucket_memory("eng", "b0", capacity=16, active=10, row_bytes=8)
    helped, typed, samples = _parse_exposition(tobs.prometheus())
    labels = collections.defaultdict(set)
    for m in samples:
        if m.group("name").startswith("metrics_tpu_meter_session_"):
            labels[m.group("name")] |= set(re.findall(r'session="((?:[^"\\]|\\.)*)"', m.group("labels")))
    for fam in ("metrics_tpu_meter_session_dispatch_s_total", "metrics_tpu_meter_session_updates_total",
                "metrics_tpu_meter_session_wal_bytes_total"):
        assert fam in helped and fam in typed and 0 < len(labels[fam]) <= 4
    assert "metrics_tpu_meter_bucket_pad_waste_bytes" in typed
    unescaped = {lab.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
                 for lab in labels["metrics_tpu_meter_session_dispatch_s_total"]}
    assert nasty in unescaped


def test_meter_survives_disable_and_program_cost_waits_for_the_engine():
    mt = tobs.install_meter(top_k=4)
    tobs.disable()
    mt.note_dispatch("b", ["s"], 0.5)
    assert tobs.installed_meter() is mt and mt.totals()["measured_dispatch_s"] == 0.5
    # the engine's port brought program_cost: FLOPs of one row's update (a matmul-free update counts 0)
    # and the bytes of its states and operands, times the capacity; a failure gives (0, 0)
    assert "program_cost" in jmetering.__all__ and "program_cost" in tmetering.__all__
    flops, nbytes = tmetering.program_cost(tr.MeanSquaredError(device="cpu"), 8,
                                           (torch.zeros(8, 16), torch.ones(8, 16)), {})
    assert flops == 0.0 and nbytes == 8 * (2 * (4 + 8) + 2 * 16 * 4)
    assert tmetering.program_cost(tr.MeanSquaredError(device="cpu"), 8, ("bad",), {}) == (0.0, 0.0)
    tobs.uninstall_meter()
    assert tobs.installed_meter() is None and tobs.snapshot()["metering"] == {"installed": False}


# ----------------------------------------------------------------------------- compile explain on the port
def test_attribute_classifies_first_single_multiple_rebuild():
    assert texplain.attribute("t", (("a", 1), ("b", 2))) == ("first", (), {})
    cause, changed, detail = texplain.attribute("t", (("a", 1), ("b", 3)))
    assert cause == "b" and changed == ("b",) and detail == {"b": {"prior": "2", "now": "3"}}
    assert texplain.attribute("t", (("a", 9), ("b", 9)))[:2] == ("multiple", ("a", "b"))
    assert texplain.attribute("t", (("a", 1), ("b", 2)))[0] == "rebuild"
    assert texplain.history_depth("t") == 4
    texplain.clear_history()
    assert texplain.history_depth("t") == 0


def test_attribute_collapses_x64_flips_and_roster_changes():
    texplain.attribute("x", (("batch_avals", "f32"), ("x64", False)))
    assert texplain.attribute("x", (("batch_avals", "f64"), ("x64", True)))[:2] == ("x64", ("x64",))
    assert texplain.attribute("x", (("batch_avals", "f16"), ("x64", True)))[0] == "batch_avals"
    texplain.attribute("y", (("a", 1),))
    cause, _, detail = texplain.attribute("y", (("a", 1), ("guard", "skip")))
    assert cause == "guard" and detail["guard"] == {"prior": None, "now": "'skip'"}
    texplain.attribute("fz", (("batch_avals[a]", "f32"), ("batch_avals[b]", "f32"), ("x64", False)))
    assert texplain.attribute("fz", (("batch_avals[a]", "f64"), ("batch_avals[b]", "f64"), ("x64", True)))[0] == "x64"
    texplain.attribute("fb", (("mode", "fused"), ("capacity", 8), ("batch_avals", "f32")))
    cause, changed, _ = texplain.attribute(
        "fb", (("mode", "fused"), ("buckets", ("a", "b")), ("capacity[a]", 8), ("batch_avals[a]", "f32"),
               ("capacity[b]", 4), ("batch_avals[b]", "i32")))
    assert cause == "buckets" and changed == ("buckets",)


def test_compile_explain_counters_derived_totals_and_scope_clears_history():
    _compile_misses(trec)
    snap = tobs.snapshot()
    assert snap["counters"]["compile_explain"] == {"shared_jit": 3, "fleet": 2}
    assert snap["derived"]["compile_explains_total"] == 5
    json.dumps(snap)
    assert texplain.history_depth("shared_jit") == 3
    trec.reset()
    assert texplain.history_depth("shared_jit") == 0
    tobs.disable()
    trec.note_compile_miss("shared_jit", "Acc", (("class", "Acc"),))
    assert texplain.history_depth("shared_jit") == 0


def test_explain_cli_renders_report(tmp_path, capsys):
    _compile_misses(trec)
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(tobs.snapshot()))
    assert texplain.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "== why recompile ==" in out and "config:num_classes" in out and "shared_jit" in out
    assert texplain.main([str(tmp_path / "missing.json")]) == 2
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    assert texplain.main([str(empty)]) == 0
    assert "was telemetry enabled?" in capsys.readouterr().out


def test_the_observe_package_imports_neither_jax_nor_the_jax_package():
    names = [n for n in sys.modules if n.startswith("metrics_tpu_torch.observe")]
    assert names
    for name in names:
        source = open(sys.modules[name].__file__).read()
        assert not re.search(r"^\s*(import|from)\s+(jax|metrics_tpu)\b(?!_torch)", source, re.M), name


def test_kernels_inside_reads_the_launches_within_a_range_of_a_chrome_trace():
    from metrics_tpu_torch.ops.profile import kernels_inside

    def ev(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid, "args": args}

    trace = {"traceEvents": [
        ev("user_annotation", "update:MultilabelAveragePrecision", 100, 50),
        ev("cuda_runtime", "cudaLaunchKernelExC", 120, 5, correlation=11),
        ev("cuda_runtime", "cudaLaunchKernel", 160, 5, correlation=12),  # after the range
        ev("cuda_driver", "cuLaunchKernel", 130, 5, tid=2, correlation=13),  # another thread
        ev("kernel", "binned_counts_kernel<float, false, true, true>", 300, 20, tid=9, correlation=11),
        ev("kernel", "elementwise_kernel", 330, 2, tid=9, correlation=12),
        ev("kernel", "other_thread_kernel", 340, 2, tid=9, correlation=13),
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 120, "pid": 7, "tid": 1},
    ]}
    assert kernels_inside(trace, "update:MultilabelAveragePrecision") == ["binned_counts_kernel<float, false, true, true>"]
    assert kernels_inside(trace, "compute:MultilabelAveragePrecision") == []
    assert kernels_inside({}, "update:X") == []
