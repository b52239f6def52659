"""The port's StreamEngine held against the JAX package's, case by case (``tests/test_stream_engine.py``).

Each scenario runs on both packages with the same seeded numpy batches
(``tests/_torch_engine_sides.py``): inside, the JAX test's own assertions hold
on each side (every session's state bit-identical to a per-instance oracle,
churn within capacity never builds a program, one dispatch per tick, the loose
fallback loses nothing); across, the sides' results are compared: states and
counters by value, computed values within rtol 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest

from _torch_engine_sides import VALUE_RTOL, assert_same, both, side


def _values(s, engine, sids):
    values = engine.compute_all()
    return {sid: s.np(values[sid]) for sid in sids}


# --------------------------------------------------------------- bit-exactness
def _random_churn(s, n_live=24, ticks=8, seed=0):
    rng = np.random.RandomState(seed)
    engine = s.StreamEngine(initial_capacity=8)
    families = [(s.acc, s.acc_batch), (s.auroc, s.auroc_batch)]
    oracles, batchers, retired_values = {}, {}, {}

    def arrive():
        ctor, batch = families[rng.randint(2)]
        sid = engine.add_session(ctor())
        oracles[sid], batchers[sid] = ctor(), batch

    for _ in range(n_live):
        arrive()
    for _tick in range(ticks):
        for sid in list(oracles):
            if rng.rand() < 0.3:
                continue  # idle this tick: masked row must pass through untouched
            args = batchers[sid](rng)
            engine.submit(sid, *args)
            oracles[sid].update(*args)
        engine.tick()
        for sid in list(oracles):
            if rng.rand() < 0.15:
                retired = engine.expire(sid)
                value = s.np(retired.compute())
                np.testing.assert_array_equal(value, s.np(oracles.pop(sid).compute()))
                retired_values[sid] = value
                del batchers[sid]
        while len(oracles) < n_live:
            arrive()
    for sid, oracle in oracles.items():
        s.assert_rows(engine, sid, oracle)
    values = _values(s, engine, oracles)
    for sid, oracle in oracles.items():
        np.testing.assert_allclose(values[sid], s.np(oracle.compute()), rtol=VALUE_RTOL, atol=0)
    return {"rows": {sid: s.rows(engine, sid) for sid in oracles}, "values": values, "retired": retired_values}


def test_fleet_bit_exact_random_churn_vs_loop_oracle():
    ref, port = both(_random_churn)
    assert_same(ref["rows"], port["rows"])
    assert_same(ref["retired"], port["retired"], VALUE_RTOL)
    assert_same(ref["values"], port["values"], VALUE_RTOL)


def _fleet_scale(s, per_family=500, churn=100):
    rng = np.random.RandomState(1)
    engine = s.StreamEngine(initial_capacity=1024)
    families = [(s.acc, s.acc_batch), (s.auroc, s.auroc_batch)]
    oracles, batchers = {}, {}
    for ctor, batch in families:
        for _ in range(per_family):
            sid = engine.add_session(ctor())
            oracles[sid], batchers[sid] = ctor(), batch
    for t in range(3):
        for sid in list(oracles):
            args = batchers[sid](rng)
            engine.submit(sid, *args)
            oracles[sid].update(*args)
        engine.tick()
        if t == 1:
            for sid in list(oracles)[:churn]:
                retired = engine.expire(sid)
                np.testing.assert_array_equal(s.np(retired.compute()), s.np(oracles.pop(sid).compute()))
                del batchers[sid]
            for _ in range(churn):
                ctor, batch = families[rng.randint(2)]
                sid = engine.add_session(ctor())
                oracles[sid], batchers[sid] = ctor(), batch
    assert max(s.update_compiles().values()) == 1  # churn never built a program
    sampled = list(oracles)[::97]
    for sid in sampled:
        s.assert_rows(engine, sid, oracles[sid])
    return {sid: s.rows(engine, sid) for sid in sampled}


def test_fleet_bit_exact_10k_sessions():
    # the JAX package's 10,000-session case is marked slow there; here the same scenario at 1,000 sessions
    # (the card's chip_smoke.py runs 10,000)
    ref, port = both(_fleet_scale)
    assert_same(ref, port)


def _adopted(s):
    rng = np.random.RandomState(2)
    m, oracle = s.acc(), s.acc()
    for _ in range(2):  # pre-adoption history rides into the bucket row
        args = s.acc_batch(rng)
        m.update(*args)
        oracle.update(*args)
    engine = s.StreamEngine()
    sid = engine.add_session(m)
    args = s.acc_batch(rng)
    engine.submit(sid, *args)
    oracle.update(*args)
    engine.tick()
    s.assert_rows(engine, sid, oracle)
    rows = s.rows(engine, sid)
    back = engine.expire(sid)
    assert back is m and m._update_count == 3
    np.testing.assert_array_equal(s.np(m.compute()), s.np(oracle.compute()))
    return rows, s.np(m.compute())


def test_adopted_instance_keeps_accumulated_state():
    assert_same(*both(_adopted))


# ------------------------------------------------------------- masking & slots
def _masked(s):
    rng = np.random.RandomState(3)
    engine = s.StreamEngine(initial_capacity=4)
    sids = [engine.add_session(s.acc()) for _ in range(3)]
    for sid in sids:
        engine.submit(sid, *s.acc_batch(rng))
    engine.tick()
    bucket = engine._sessions[sids[0]].bucket
    idle_before = s.rows(engine, sids[1])
    virgin_slot = bucket.free[-1]
    virgin_before = {k: s.np(v[virgin_slot]) for k, v in bucket.stacked.items()}
    for sid in (sids[0], sids[2]):  # sids[1] idle: masked out of this dispatch
        engine.submit(sid, *s.acc_batch(rng))
    engine.tick()
    for k, ref in idle_before.items():
        np.testing.assert_array_equal(s.rows(engine, sids[1])[k], ref)
    for k, ref in virgin_before.items():
        np.testing.assert_array_equal(s.np(bucket.stacked[k][virgin_slot]), ref)
    return {sid: s.rows(engine, sid) for sid in sids}, virgin_slot


def test_masked_rows_and_padding_never_contaminated():
    assert_same(*both(_masked))


def _after_expiry(s):
    rng = np.random.RandomState(4)
    engine = s.StreamEngine()
    sid = engine.add_session(s.acc())
    oracle = s.acc()
    args = s.acc_batch(rng)
    engine.submit(sid, *args)
    oracle.update(*args)
    engine.tick()
    retired = engine.expire(sid)
    first = s.np(retired.compute())
    np.testing.assert_array_equal(first, s.np(oracle.compute()))
    args2 = s.acc_batch(rng)
    retired.update(*args2)  # the handed-back instance is independent of the engine
    oracle.update(*args2)
    np.testing.assert_array_equal(s.np(retired.compute()), s.np(oracle.compute()))
    with pytest.raises(KeyError):
        engine.compute(sid)
    with pytest.raises(KeyError):
        engine.submit(sid, *args2)
    return first, s.np(retired.compute())


def test_compute_after_expiry():
    assert_same(*both(_after_expiry))


def _expire_flushes(s):
    rng = np.random.RandomState(5)
    engine = s.StreamEngine()
    sid = engine.add_session(s.acc())
    oracle = s.acc()
    args = s.acc_batch(rng)
    engine.submit(sid, *args)  # still queued: no tick
    oracle.update(*args)
    retired = engine.expire(sid)
    np.testing.assert_array_equal(s.np(retired.compute()), s.np(oracle.compute()))
    return s.oracle_state(retired)


def test_expire_flushes_pending_submissions_first():
    assert_same(*both(_expire_flushes))


def _lifo(s):
    rng = np.random.RandomState(6)
    engine = s.StreamEngine(initial_capacity=4)
    sids = [engine.add_session(s.acc()) for _ in range(3)]
    for sid in sids:
        engine.submit(sid, *s.acc_batch(rng))
    engine.tick()
    freed_slot = engine._sessions[sids[1]].slot
    engine.expire(sids[1])
    newcomer = engine.add_session(s.acc())
    assert engine._sessions[newcomer].slot == freed_slot  # LIFO: the hole before untouched padding
    oracle = s.acc()
    s.assert_rows(engine, newcomer, oracle)  # the previous tenant's leftovers were scattered out
    args = s.acc_batch(rng)
    engine.submit(newcomer, *args)
    oracle.update(*args)
    engine.tick()
    s.assert_rows(engine, newcomer, oracle)
    return freed_slot, s.rows(engine, newcomer)


def test_slot_recycling_is_lifo_and_clean():
    assert_same(*both(_lifo))


# ------------------------------------------------------------------ ingest
def _waves(s):
    rng = np.random.RandomState(7)
    engine = s.StreamEngine()
    a, b = engine.add_session(s.acc()), engine.add_session(s.acc())
    oa, ob = s.acc(), s.acc()
    a1, a2, b1 = s.acc_batch(rng), s.acc_batch(rng), s.acc_batch(rng)
    engine.submit(a, *a1)
    engine.submit(a, *a2)  # second submission for `a` within one tick
    engine.submit(b, *b1)
    oa.update(*a1)
    oa.update(*a2)
    ob.update(*b1)
    assert engine.tick() == 1  # two waves chained inside one fused program
    s.assert_rows(engine, a, oa)
    s.assert_rows(engine, b, ob)
    return s.rows(engine, a), s.rows(engine, b)


def test_ingest_waves_preserve_per_session_order():
    assert_same(*both(_waves))


def _signatures(s):
    engine = s.StreamEngine()
    a, b = engine.add_session(s.acc()), engine.add_session(s.acc())
    oa, ob = s.acc(), s.acc()
    wide = (s.arr([0, 1, 2, 3]), s.arr([0, 1, 2, 0]))
    narrow = (s.arr([1, 1]), s.arr([1, 0]))
    engine.submit(a, *wide)
    engine.submit(b, *narrow)  # different shape: cannot share staging buffers
    oa.update(*wide)
    ob.update(*narrow)
    assert engine.tick() == 1
    s.assert_rows(engine, a, oa)
    s.assert_rows(engine, b, ob)
    return s.rows(engine, a), s.rows(engine, b)


def test_distinct_batch_signatures_split_waves():
    assert_same(*both(_signatures))


def _lazy(s):
    engine = s.StreamEngine()
    sid = engine.add_session(s.acc())
    engine.submit(sid, s.arr([1, 2]), s.arr([1, 2]))
    before = s.count("fleet_dispatch")
    engine.tick()
    return before, s.count("fleet_dispatch")


def test_submit_is_lazy_until_tick():
    ref, port = both(_lazy)
    assert ref == port == (0, 1)


# ------------------------------------------------------------------ buckets
def _heterogeneous(s):
    rng = np.random.RandomState(8)
    engine = s.StreamEngine()
    for _ in range(4):
        sid = engine.add_session(s.acc())
        engine.submit(sid, *s.acc_batch(rng))
    for _ in range(4):
        sid = engine.add_session(s.auroc())
        engine.submit(sid, *s.auroc_batch(rng))
    n_buckets = len(engine._buckets)
    return n_buckets, engine.tick(), {sid: s.rows(engine, sid) for sid in engine.session_ids()}


def test_heterogeneous_classes_one_fused_dispatch_per_tick():
    ref, port = both(_heterogeneous)
    assert ref[:2] == port[:2] == (2, 1)
    assert_same(ref[2], port[2])


def _fingerprints(s):
    engine = s.StreamEngine()
    engine.add_session(s.MulticlassAccuracy(num_classes=4, **s.kw))
    engine.add_session(s.MulticlassAccuracy(num_classes=7, **s.kw))  # different config
    engine.add_session(s.MulticlassAccuracy(num_classes=4, **s.kw))  # shares the first
    return len(engine._buckets)


def test_config_fingerprint_splits_buckets():
    assert both(_fingerprints) == (2, 2)


def _no_recompile(s):
    rng = np.random.RandomState(9)
    engine = s.StreamEngine(initial_capacity=8)
    sids = [engine.add_session(s.acc()) for _ in range(4)]
    for sid in sids:
        engine.submit(sid, *s.acc_batch(rng))
    engine.tick()
    assert s.update_compiles() == {engine._buckets[next(iter(engine._buckets))].label: 1}
    for sid in sids[:2]:
        engine.expire(sid)
    sids = sids[2:] + [engine.add_session(s.acc()) for _ in range(3)]  # 5 of 8 slots
    for _ in range(2):
        for sid in sids:
            engine.submit(sid, *s.acc_batch(rng))
        engine.tick()
    assert max(s.update_compiles().values()) == 1  # arrival/expiry changed data, not shapes
    return {sid: s.rows(engine, sid) for sid in sids}


def test_no_recompile_for_churn_within_capacity():
    assert_same(*both(_no_recompile))


def _doubling(s):
    rng = np.random.RandomState(10)
    engine = s.StreamEngine(initial_capacity=2)
    sids = [engine.add_session(s.acc()) for _ in range(2)]
    oracles = {sid: s.acc() for sid in sids}

    def feed_all():
        for sid in sids:
            args = s.acc_batch(rng)
            engine.submit(sid, *args)
            oracles[sid].update(*args)
        engine.tick()

    feed_all()
    compiles = [max(s.update_compiles().values())]
    sids.append(engine.add_session(s.acc()))  # third arrival: 2 -> 4 rows
    oracles[sids[-1]] = s.acc()
    assert next(iter(engine._buckets.values())).capacity == 4
    feed_all()
    compiles.append(max(s.update_compiles().values()))
    feed_all()
    compiles.append(max(s.update_compiles().values()))
    assert compiles == [1, 2, 2]  # ONE new program for the new shape
    for sid in sids:
        s.assert_rows(engine, sid, oracles[sid])
    return {sid: s.rows(engine, sid) for sid in sids}


def test_capacity_doubling_compiles_exactly_once_per_bucket():
    assert_same(*both(_doubling))


def _cached_compute(s):
    rng = np.random.RandomState(11)
    engine = s.StreamEngine()
    sids = [engine.add_session(s.custom("RunningMax")) for _ in range(3)]
    for sid in sids:
        engine.submit(sid, s.arr(np.abs(rng.randn(8)).astype(np.float32)))
    engine.tick()
    values = _values(s, engine, sids)
    engine.compute(sids[0])  # same bucket version: served from the cached stack
    first = s.count("fleet_compute_dispatch")
    engine.submit(sids[0], s.arr(np.abs(rng.randn(8)).astype(np.float32)))
    engine.compute(sids[0])  # flushes, version bumps, recomputes
    return first, s.count("fleet_compute_dispatch"), values


def test_compute_is_cached_until_state_changes():
    ref, port = both(_cached_compute)
    assert ref[:2] == port[:2] == (1, 2)
    assert_same(ref[2], port[2], VALUE_RTOL)


def _fold_polls(s):
    rng = np.random.RandomState(11)
    engine = s.StreamEngine()
    sids = [engine.add_session(s.acc()) for _ in range(3)]
    oracles = {sid: s.acc() for sid in sids}
    for sid in sids:
        args = s.acc_batch(rng)
        engine.submit(sid, *args)
        oracles[sid].update(*args)
    engine.tick()
    values = _values(s, engine, sids)
    engine.compute(sids[0])
    assert "fleet_compute_dispatch" not in s.counters()
    for sid in sids:
        np.testing.assert_allclose(values[sid], s.np(oracles[sid].compute()), rtol=VALUE_RTOL)
    before = s.counters().get("explicit_transfer", {}).copy()
    engine.compute_all()  # a second poll with no state change touches nothing at all
    assert s.counters().get("explicit_transfer", {}) == before
    return values


def test_fold_eligible_bucket_polls_without_compute_dispatches():
    assert_same(*both(_fold_polls), VALUE_RTOL)


# ------------------------------------------------------------------ loose path
def _demote_on_list(s):
    engine = s.StreamEngine()
    sid = engine.add_session(s.custom("AnySum"))
    oracle = s.custom("AnySum")
    args = (s.arr(np.array([1.0, 2.0], dtype=np.float32)),)
    engine.submit(sid, *args)
    oracle.update(*args)
    engine.tick()
    engine.submit(sid, [3.0, 4.0])  # a Python-list batch cannot enter a batched dispatch
    oracle.update([3.0, 4.0])
    engine.tick()
    assert engine._sessions[sid].bucket is None  # demoted, row handed back
    value = s.np(engine.compute(sid))
    np.testing.assert_array_equal(value, s.np(oracle.compute()))
    return value, s.count("fleet_loose_update")


def test_batch_ineligible_submission_demotes_to_loose():
    ref, port = both(_demote_on_list)
    assert ref[1] == port[1] == 1
    assert_same(ref[0], port[0])


def _refused_update(s):
    engine = s.StreamEngine()
    a = engine.add_session(s.custom("HostOnlyUpdate"))
    b = engine.add_session(s.custom("HostOnlyUpdate"))
    assert engine._sessions[a].bucket is not None  # eligible until proven otherwise
    engine.submit(a, s.arr(np.array([1.0, 5.0], dtype=np.float32)))
    engine.submit(b, s.arr(np.array([3.0, 2.0], dtype=np.float32)))
    engine.submit(a, s.arr(np.array([4.0, 0.5], dtype=np.float32)))
    engine.tick()  # the batched update is refused -> bucket dissolves -> eager replay, nothing lost
    assert engine._sessions[a].bucket is None and engine._sessions[b].bucket is None
    out = [float(engine.compute(a)), float(engine.compute(b)), s.count("fleet_fallback"),
           s.count("fleet_loose_update")]
    engine.submit(b, s.arr(np.array([9.0], dtype=np.float32)))
    engine.tick()
    out.append(float(engine.compute(b)))
    return out


def test_tracer_failure_demotes_bucket_and_replays_every_submission():
    ref, port = both(_refused_update)
    assert ref == port == [5.0, 3.0, 1, 3, 9.0]


def _refused_compute(s):
    engine = s.StreamEngine()
    a = engine.add_session(s.custom("HostOnlyCompute"))
    b = engine.add_session(s.custom("HostOnlyCompute"))
    engine.submit(a, s.arr(np.array([1.0, 2.0], dtype=np.float32)))
    engine.submit(b, s.arr(np.array([10.0, 0.0], dtype=np.float32)))
    dispatches = engine.tick()  # updates still ride ONE vmapped dispatch
    out = [dispatches, float(engine.compute(a)), float(engine.compute(b))]
    assert engine._sessions[a].bucket is not None  # compute fallback is not a demotion
    return out + [s.count("fleet_fallback")]


def test_compute_trace_failure_falls_back_to_per_row_compute():
    ref, port = both(_refused_compute)
    assert ref == port == [1, 3.0, 10.0, 1]


# ------------------------------------------------------------------ lifecycle
def _reset_one(s):
    rng = np.random.RandomState(13)
    engine = s.StreamEngine()
    a, b = engine.add_session(s.acc()), engine.add_session(s.acc())
    ob = s.acc()
    for sid in (a, b):
        args = s.acc_batch(rng)
        engine.submit(sid, *args)
        if sid == b:
            ob.update(*args)
    engine.tick()
    engine.submit(a, *s.acc_batch(rng))  # queued work dies with the reset
    engine.reset(a)
    engine.tick()
    s.assert_rows(engine, a, s.acc())  # back to defaults
    s.assert_rows(engine, b, ob)  # neighbor row untouched
    assert engine._sessions[a].metric._update_count == 0
    return s.rows(engine, a), s.rows(engine, b)


def test_reset_single_session():
    assert_same(*both(_reset_one))


def _reset_all(s):
    rng = np.random.RandomState(14)
    engine = s.StreamEngine()
    sids = [engine.add_session(s.acc()) for _ in range(3)]
    for sid in sids:
        engine.submit(sid, *s.acc_batch(rng))
    engine.tick()
    engine.reset()
    for sid in sids:
        s.assert_rows(engine, sid, s.acc())
    return {sid: s.rows(engine, sid) for sid in sids}


def test_reset_whole_fleet():
    assert_same(*both(_reset_all))


def _rejections(s):
    engine = s.StreamEngine()
    engine.add_session(s.acc(), session_id="s1")
    messages = []
    for call, match in ((lambda: engine.add_session(s.acc(), session_id="s1"), "already live"),
                        (lambda: engine.add_session("not a metric"), "expects a Metric"),
                        (lambda: s.StreamEngine(initial_capacity=0), "initial_capacity")):
        with pytest.raises(s.UserError, match=match) as err:
            call()
        messages.append(str(err.value))
    return messages


def test_add_session_rejects_duplicates_and_non_metrics():
    ref, port = both(_rejections)
    assert ref == port


def _cache_clear(s):
    rng = np.random.RandomState(15)
    engine = s.StreamEngine()
    sid = engine.add_session(s.acc())
    engine.submit(sid, *s.acc_batch(rng))
    engine.tick()
    engine.compute(sid)
    filled = len(s.core._FLEET_JIT_CACHE) >= 1
    s.clear_cache()  # the JAX package's clear_jit_cache(); the port has no jit cache and clears its own
    return filled, len(s.core._FLEET_JIT_CACHE)


def test_clear_jit_cache_drops_fleet_cache():
    assert both(_cache_clear) == ((True, 0), (True, 0))


def _eviction(s):
    rng = np.random.RandomState(16)
    old_max = s.core._FLEET_JIT_CACHE.max_entries
    s.core._FLEET_JIT_CACHE.max_entries = 1
    try:
        engine = s.StreamEngine()
        for ctor, batch in ((s.acc, s.acc_batch), (s.auroc, s.auroc_batch)):
            sid = engine.add_session(ctor())
            engine.submit(sid, *batch(rng))
            engine.tick()  # the second bucket's program evicts the first's
        evicts = s.count("fleet_evict")
        events = any(e["kind"] == "fleet_evict" for e in s.observe.snapshot()["events"])
    finally:
        s.core._FLEET_JIT_CACHE.max_entries = old_max
    return evicts, events


def test_fleet_cache_eviction_recorded():
    assert both(_eviction) == ((1, True), (1, True))


# ------------------------------------------------------------------ telemetry
def _stats(s):
    rng = np.random.RandomState(17)
    engine = s.StreamEngine(initial_capacity=8)
    sids = [engine.add_session(s.acc()) for _ in range(5)]
    for sid in sids:
        engine.submit(sid, *s.acc_batch(rng))
    engine.tick()
    engine.expire(sids[1])  # a hole below the high-water mark
    stats = engine.stats()
    (label,) = stats["buckets"]
    b = stats["buckets"][label]
    gauges = s.observe.snapshot()["gauges"]
    return {
        "bucket": {k: b[k] for k in ("capacity", "active", "fragmented", "occupancy_pct", "pad_waste_pct",
                                     "pending", "health", "faults")},
        "fleet": {k: stats[k] for k in ("sessions", "loose_sessions", "rows_active", "rows_capacity",
                                        "occupancy_pct", "pad_waste_pct", "ticks")},
        "gauges": [gauges["fleet_rows_active"][label], gauges["fleet_rows_capacity"][label],
                   gauges["fleet_rows_fragmented"][label]],
    }


def test_stats_occupancy_fragmentation_and_pad_waste():
    ref, port = both(_stats)
    assert ref == port
    assert port["bucket"]["capacity"] == 8 and port["bucket"]["active"] == 4 and port["bucket"]["fragmented"] == 1
    assert port["bucket"]["occupancy_pct"] == pytest.approx(50.0) == port["bucket"]["pad_waste_pct"]
    assert port["gauges"] == [4, 8, 1]


def test_stream_engine_root_export():
    import metrics_tpu
    import metrics_tpu_torch

    assert metrics_tpu.StreamEngine is side("jax").StreamEngine
    assert metrics_tpu_torch.StreamEngine is side("torch").StreamEngine
    from metrics_tpu_torch.engine.stream import StreamEngine

    assert metrics_tpu_torch.StreamEngine is StreamEngine


# ------------------------------------------------------------------ the port's own contracts
def test_validate_args_defaults_ride_a_bucket():
    # with validate_args=True defaults the traced mode skips the host checks: these sessions bucket
    import metrics_tpu_torch as M

    rng = np.random.RandomState(18)
    s = side("torch")
    with s.fresh():
        engine = s.StreamEngine(initial_capacity=4)
        cases = [
            (lambda: M.classification.MulticlassAccuracy(num_classes=4, device="cpu"), s.acc_batch),
            (lambda: M.classification.BinaryAUROC(thresholds=8, device="cpu"), s.auroc_batch),
            (lambda: M.MeanMetric(device="cpu"), lambda r: (s.arr(r.rand(8).astype(np.float32)),)),
            (lambda: M.HyperLogLog(p=8, device="cpu"), lambda r: (s.arr(r.rand(8).astype(np.float32)),)),
        ]
        oracles = {}
        for ctor, batch in cases:
            for _ in range(2):
                sid = engine.add_session(ctor())
                oracles[sid] = (ctor(), batch)
        for _ in range(2):
            for sid, (oracle, batch) in oracles.items():
                args = batch(rng)
                engine.submit(sid, *args)
                oracle.update(*args)
            assert engine.tick() == 1
        assert s.count("fleet_loose_update") == 0 and not engine.loose_session_ids()
        for sid, (oracle, _b) in oracles.items():
            assert engine.session_health(sid) == "healthy"
            s.assert_rows(engine, sid, oracle)


def test_jit_update_false_runs_loose_and_device_splits_buckets():
    s = side("torch")
    with s.fresh():
        engine = s.StreamEngine()
        a = engine.add_session(s.acc(jit_update=False))
        b = engine.add_session(s.acc())
        assert engine.session_health(a) == "loose" and engine.session_health(b) == "healthy"
        key = engine._bucket_key(s.acc())
        assert key[1] == "cpu" and len(engine._buckets) == 1


def test_fleet_smoke_economy_equals_the_jax_package_and_its_baseline_round_trips(tmp_path):
    from metrics_tpu.engine.smoke import run_fleet_smoke as jax_smoke

    from metrics_tpu_torch.engine.smoke import (
        diff_fleet_baseline,
        load_fleet_baseline,
        run_fleet_smoke,
        write_fleet_baseline,
    )

    port, ref = run_fleet_smoke(device="cpu"), jax_smoke()
    keys = ("streams", "buckets", "ticks", "churn", "dispatches_per_shard_tick", "update_compiles",
            "poll_dispatches_per_poll", "loose_updates", "fused_fallbacks", "bit_exact")
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert port["bit_exact"] and port["dispatches_per_shard_tick"] == 1.0 and port["update_compiles"] == 1
    path = str(tmp_path / "baseline.json")
    assert diff_fleet_baseline(port, load_fleet_baseline(path))[2]  # no baseline yet: reported as new
    pinned = write_fleet_baseline(path, port)
    assert load_fleet_baseline(path) == pinned
    assert diff_fleet_baseline(port, pinned) == ([], [], [])
    worse = dict(port, update_compiles=2, bit_exact=False)
    regressions, _stale, _new = diff_fleet_baseline(worse, pinned)
    assert len(regressions) == 2
