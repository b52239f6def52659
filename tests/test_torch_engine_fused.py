"""The port's one-program tick and O(1) polls held against the JAX package's, case by case
(``tests/test_fused_tick.py``).

One ``tick()`` is one dispatch (one call of the fused program) whatever the
bucket count and wave depth, bit-exact against per-instance oracles;
fold-eligible polls run no compute and stay correct across churn, expiry,
reset and checkpoint/restore; the blast-radius ladder survives fusion. Each
scenario runs on both packages with the same seeded numpy batches
(``tests/_torch_engine_sides.py``); states compare by value, values within
rtol 1e-6 (1e-12 in the float64 regime).
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from _torch_engine_sides import VALUE_RTOL, assert_same, both, side


def _auroc16(s):
    return s.BinaryAUROC(thresholds=16, **s.kw)


def _values(s, engine, sids):
    values = engine.compute_all()
    return {sid: s.np(values[sid]) for sid in sids}


# ------------------------------------------------------------- one-program tick
def _many_waves(s):
    rng = np.random.RandomState(3)
    engine = s.StreamEngine()
    sids, oracles, batchers = [], {}, {}
    for ctor, batch in ((s.acc, s.acc_batch), (lambda: _auroc16(s), s.auroc_batch)):
        for _ in range(4):
            sid = engine.add_session(ctor())
            sids.append(sid)
            oracles[sid], batchers[sid] = ctor(), batch
    for _t in range(4):
        for sid in sids:
            for _wave in range(3):  # three waves per bucket chain in-program
                args = batchers[sid](rng)
                engine.submit(sid, *args)
                oracles[sid].update(*args)
        assert engine.tick() == 1  # the WHOLE fleet: one dispatch
    for sid in sids:
        s.assert_rows(engine, sid, oracles[sid])  # bit-exact: waves keep each session's order
    values = _values(s, engine, sids)
    for sid in sids:
        np.testing.assert_allclose(values[sid], s.np(oracles[sid].compute()), rtol=VALUE_RTOL)
    return {sid: s.rows(engine, sid) for sid in sids}, values


def test_two_buckets_many_waves_one_dispatch_bit_exact():
    ref, port = both(_many_waves)
    assert_same(ref[0], port[0])
    assert_same(ref[1], port[1], VALUE_RTOL)


def _compiles_once(s):
    rng = np.random.RandomState(5)
    engine = s.StreamEngine()
    sids = [engine.add_session(s.acc()) for _ in range(3)] + [engine.add_session(_auroc16(s)) for _ in range(3)]
    for _t in range(3):
        for i, sid in enumerate(sids):
            engine.submit(sid, *(s.acc_batch(rng) if i < 3 else s.auroc_batch(rng)))
        engine.tick()
    return sum(s.update_compiles().values()), {sid: s.rows(engine, sid) for sid in sids}


def test_fused_program_compiles_once_across_ticks():
    ref, port = both(_compiles_once)
    assert ref[0] == port[0] == 1
    assert_same(ref[1], port[1])


# ------------------------------------------------------------- O(1) poll caches
def _fold_across_lifecycle(s, tmp_path):
    tmp_path = tmp_path / s.name
    tmp_path.mkdir()
    rng = np.random.RandomState(7)
    engine = s.StreamEngine(wal_path=str(tmp_path / "fleet.wal"))
    oracles = {}
    for _ in range(6):
        sid = engine.add_session(s.acc())
        oracles[sid] = s.acc()
    polls = []

    def submit_round():
        for sid in list(oracles):
            args = s.acc_batch(rng)
            engine.submit(sid, *args)
            oracles[sid].update(*args)

    def poll(eng=engine):
        values = eng.compute_all()
        assert set(values) == set(oracles)
        for sid, oracle in oracles.items():
            np.testing.assert_allclose(s.np(values[sid]), s.np(oracle.compute()), rtol=VALUE_RTOL, err_msg=str(sid))
        polls.append({sid: s.np(values[sid]) for sid in oracles})

    submit_round()
    engine.tick()
    poll()
    for sid in list(oracles)[:2]:  # churn: expire two, arrive two, keep polling
        engine.expire(sid)
        del oracles[sid]
    poll()
    for _ in range(2):
        sid = engine.add_session(s.acc())
        oracles[sid] = s.acc()
    submit_round()
    engine.tick()
    poll()
    victim = next(iter(oracles))  # a reset invalidates the fold caches; polls stay correct
    engine.reset(victim)
    oracles[victim] = s.acc()
    submit_round()
    engine.tick()
    poll()
    ckpt = engine.checkpoint(str(tmp_path / "fleet.mtckpt"))
    rebuilt = s.StreamEngine.restore(ckpt, wal_path=str(tmp_path / "fleet.wal"))
    poll(rebuilt)
    return polls


def test_fold_poll_matches_full_recompute_across_churn_expiry_reset_restore(tmp_path):
    ref, port = both(_fold_across_lifecycle, tmp_path)
    assert_same(ref, port, VALUE_RTOL)


def _one_transfer(s):
    rng = np.random.RandomState(11)
    engine = s.StreamEngine()
    sids = [engine.add_session(s.acc()) for _ in range(4)]
    for sid in sids:
        engine.submit(sid, *s.acc_batch(rng))
    engine.tick()
    engine.compute_all()
    first = s.counters().get("explicit_transfer", {}).get("poll_readout", 0)
    for _ in range(5):  # polls between ticks are pure host work: no dispatch, no new transfer
        engine.compute_all()
        engine.compute(sids[0])
    snap = s.counters()
    return first, "fleet_compute_dispatch" in snap, snap.get("explicit_transfer", {}).get("poll_readout", 0)


def test_fold_poll_zero_compute_dispatches_and_one_transfer_per_version():
    assert both(_one_transfer) == ((1, False, 1), (1, False, 1))


@contextlib.contextmanager
def _float64(s):
    if s.name == "jax":
        import jax

        assert jax.config.jax_enable_x64 is False
        jax.config.update("jax_enable_x64", True)
        try:
            s.clear_cache()
            yield
        finally:
            jax.config.update("jax_enable_x64", False)
            s.clear_cache()
    else:
        previous = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            s.clear_cache()
            yield
        finally:
            torch.set_default_dtype(previous)
            s.clear_cache()


def _fold_x64(s):
    with _float64(s):
        rng = np.random.RandomState(13)
        engine = s.StreamEngine()
        sids = [engine.add_session(s.acc()) for _ in range(3)]
        oracles = {sid: s.acc() for sid in sids}
        for _ in range(2):
            for sid in sids:
                args = s.acc_batch(rng)
                engine.submit(sid, *args)
                oracles[sid].update(*args)
            assert engine.tick() == 1
        values = engine.compute_all()
        assert "fleet_compute_dispatch" not in s.counters()
        out = {}
        for sid in sids:
            got, want = s.np(values[sid]), s.np(oracles[sid].compute())
            assert got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=1e-12)
            out[sid] = got
        return out


def test_fold_poll_bit_exact_under_x64():
    ref, port = both(_fold_x64)
    assert_same(ref, port, 1e-12)
    assert all(v.dtype == np.float64 for v in port.values())


def _sharded_partial(s):
    rng = np.random.RandomState(17)
    fleet = s.ShardedStreamEngine(n_shards=2, **({} if s.name == "jax" else {"devices": ["cpu"]}))
    template = s.acc()
    sids, oracle_batches = [], []
    for i in range(6):
        sid = f"agg-{i}"
        fleet.add_session(s.acc(), sid)
        sids.append(sid)
        args = s.acc_batch(rng)
        fleet.submit(sid, *args)
        oracle_batches.append((sid, args))
    fleet.tick()

    def oracle(skip=()):
        m = s.acc()
        for sid, args in oracle_batches:
            if sid not in skip:
                m.update(*args)
        return s.np(m.compute())

    merged = s.np(fleet.aggregate(template).compute())
    np.testing.assert_allclose(merged, oracle(), rtol=VALUE_RTOL)
    # a post-tick expiry leaves the tick-time partial stale for that bucket: per-row slices instead
    fleet.expire(sids[0])
    after = s.np(fleet.aggregate(template).compute())
    np.testing.assert_allclose(after, oracle(skip={sids[0]}), rtol=VALUE_RTOL)
    return merged, after


def test_sharded_aggregate_uses_tick_partial_and_survives_expiry():
    assert_same(*both(_sharded_partial), VALUE_RTOL)


# --------------------------------------------------------- blast-radius ladder
def _fused_refused(s, monkeypatch):
    rng = np.random.RandomState(19)
    engine = s.StreamEngine()
    sids = [engine.add_session(s.acc()) for _ in range(3)] + [engine.add_session(_auroc16(s)) for _ in range(3)]
    oracles = {sid: (s.acc() if i < 3 else _auroc16(s)) for i, sid in enumerate(sids)}
    for i, sid in enumerate(sids):
        args = s.acc_batch(rng) if i < 3 else s.auroc_batch(rng)
        engine.submit(sid, *args)
        oracles[sid].update(*args)

    def fused_refuses(*args, **kwargs):
        raise s.TraceIneligibleError("injected: fused program refused")

    stream_mod = __import__(f"{s.pkg.__name__}.engine.stream", fromlist=["x"])
    with monkeypatch.context() as mp:
        mp.setattr(stream_mod, "engine_update_fused", fused_refuses)
        dispatches = engine.tick()
    values = {}
    for sid in sids:  # nothing demoted, nothing lost
        assert engine.session_health(sid) == "healthy"
        values[sid] = s.np(engine.compute(sid))
        np.testing.assert_allclose(values[sid], s.np(oracles[sid].compute()), rtol=VALUE_RTOL)
    return dispatches, s.count("fleet_fused_fallback"), values


def test_fused_trace_failure_falls_back_per_bucket_and_loses_nothing(monkeypatch):
    ref, port = both(_fused_refused, monkeypatch)
    assert ref[:2] == port[:2] == (2, 1)
    assert_same(ref[2], port[2], VALUE_RTOL)


def _runtime_death(s, monkeypatch):
    rng = np.random.RandomState(23)
    engine = s.StreamEngine()
    sids = [engine.add_session(s.acc()) for _ in range(4)]
    oracles = {sid: s.acc() for sid in sids}
    for sid in sids:  # a clean warm-up tick so every row carries real state
        args = s.acc_batch(rng)
        engine.submit(sid, *args)
        oracles[sid].update(*args)
    assert engine.tick() == 1
    poison_tick = {sid: s.acc_batch(rng) for sid in sids}
    for sid in sids:
        engine.submit(sid, *poison_tick[sid])
        if sid != sids[1]:  # the oracle never sees the poison row's dropped batch
            oracles[sid].update(*poison_tick[sid])

    def dead_dispatch(*args, **kwargs):
        raise RuntimeError("injected: dispatch died at runtime, buffers intact")

    real_fu = s.Metric._functional_update
    calls = {"n": 0}

    def trapdoor(self, state, *args, **kwargs):
        i = calls["n"]
        calls["n"] += 1
        if i == 1:  # rows replay in wave order: call 1 is sids[1]'s row
            raise RuntimeError("injected: poison row")
        return real_fu(self, state, *args, **kwargs)

    stream_mod = __import__(f"{s.pkg.__name__}.engine.stream", fromlist=["x"])
    with monkeypatch.context() as mp:
        mp.setattr(stream_mod, "engine_update_fused", dead_dispatch)
        mp.setattr(stream_mod, "engine_update", dead_dispatch)
        mp.setattr(s.Metric, "_functional_update", trapdoor)
        engine.tick()
    health = [engine.session_health(sid) for sid in sids]
    values = {}
    for sid in sids:
        values[sid] = s.np(engine.compute(sid))
        np.testing.assert_allclose(values[sid], s.np(oracles[sid].compute()), rtol=VALUE_RTOL, err_msg=str(sid))
    counts = (s.count("fleet_quarantine"), s.count("fleet_row_replay"))
    for sid in sids:  # the next tick is clean: survivors ride one fused dispatch again
        args = s.acc_batch(rng)
        engine.submit(sid, *args)
        oracles[sid].update(*args)
    dispatches = engine.tick()
    for sid in sids:
        np.testing.assert_allclose(s.np(engine.compute(sid)), s.np(oracles[sid].compute()), rtol=VALUE_RTOL)
    return health, counts, dispatches, values


def test_fused_runtime_death_quarantines_exactly_the_poison_row(monkeypatch):
    ref, port = both(_runtime_death, monkeypatch)
    assert ref[:3] == port[:3] == (["healthy", "quarantined", "healthy", "healthy"], (1, 3), 1)
    assert_same(ref[3], port[3], VALUE_RTOL)


# --------------------------------------------------- core: same-spec entries
def _same_spec(s):
    rng = np.random.RandomState(29)
    tmpl_a, tmpl_b = s.acc(), s.acc()
    n = 4

    def entry_for(tmpl):
        if s.name == "jax":
            stacked = {k: s.xp.repeat(s.xp.asarray(d)[None], n, axis=0) for k, d in tmpl._defaults.items()}
        else:
            stacked = {k: d.unsqueeze(0).repeat((n,) + (1,) * d.ndim) for k, d in tmpl._defaults.items()}
        preds = s.arr(rng.randint(4, size=(n, 8)))
        target = s.arr(rng.randint(4, size=(n, 8)))
        mask = s.arr(np.array([True, True, False, True]))
        return stacked, ((preds, target), {}, mask)

    stacked_a, group_a = entry_for(tmpl_a)
    stacked_b, group_b = entry_for(tmpl_b)
    entries = [
        s.core.FusedEntry(template=tmpl_a, n=n, stacked=stacked_a, groups=[group_a], label="a"),
        s.core.FusedEntry(template=tmpl_b, n=n, stacked=stacked_b, groups=[group_b], label="b"),
    ]
    results = s.core.engine_update_fused(entries, label="samespec")
    assert len(s.core._FLEET_JIT_CACHE) == 1  # one program for both entries
    out = []
    for (stacked, (args, kwargs, mask)), (new_stacked, _v, _p) in zip(
        ((stacked_a, group_a), (stacked_b, group_b)), results
    ):
        oracle = s.core.engine_update(tmpl_a, n, stacked, args, kwargs, mask=mask, label="oracle")
        for k in oracle:
            np.testing.assert_array_equal(s.np(new_stacked[k]), s.np(oracle[k]))
        out.append({k: s.np(v) for k, v in new_stacked.items()})
    return out


def test_same_spec_entries_batch_and_match_per_entry_oracle():
    # the JAX package stacks same-spec entries under one more vmap; the port chains them in one program
    # call: one program either way, the same rows
    assert_same(*both(_same_spec))


# -------------------------------------------------------------- dirty-set index
def _idle(s):
    rng = np.random.RandomState(31)
    engine = s.StreamEngine()
    acc_sids = [engine.add_session(s.acc()) for _ in range(3)]
    auroc_sids = [engine.add_session(_auroc16(s)) for _ in range(3)]
    for sid in acc_sids:
        engine.submit(sid, *s.acc_batch(rng))
    for sid in auroc_sids:
        engine.submit(sid, *s.auroc_batch(rng))
    out = [engine.tick()]
    assert not engine._dirty_buckets and not engine._dirty_loose
    out.append(engine.tick())  # idle: two empty-dict checks, no bucket walk
    before = dict(s.counters().get("fleet_flush", {}))
    engine.submit(acc_sids[0], *s.acc_batch(rng))  # one pending submission: only ITS bucket flushes
    out.append(engine.tick())
    after = s.counters().get("fleet_flush", {})
    changed = {k for k in after if after[k] != before.get(k, 0)}
    assert len(changed) == 1 and "MulticlassAccuracy" in next(iter(changed))
    return out


def test_idle_tick_touches_nothing_and_partial_flush_is_o_pending():
    assert both(_idle) == ([1, 0, 1], [1, 0, 1])


def _skey(s):
    engine = s.StreamEngine()
    sid = engine.add_session(s.acc(), "meter-me")
    tracked = engine._skey_index[str(sid)] == sid
    engine.expire(sid)
    return tracked, str(sid) in engine._skey_index


def test_skey_index_tracks_add_expire():
    assert both(_skey) == ((True, False), (True, False))


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-q"]))
