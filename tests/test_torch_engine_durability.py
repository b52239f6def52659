"""The port's fleet durability held against the JAX package's, case by case (``tests/test_engine_durability.py``).

The CRC-framed ingest WAL (``MTWAL001``, ``>II`` frames), incremental fleet
checkpoints (MTCKPT, ``root_kind == "fleet"``), validated restore + journal
replay, and the blast-radius contracts: recovery is bit-exact versus a
never-crashed engine, and a quarantined session never demotes its bucket.
Each scenario runs on both packages with the same seeded numpy batches
(``tests/_torch_engine_sides.py``); states compare by value. The journal
cases at the end hold the port's files against the JAX package's reader:
they carry numpy arrays, never tensors.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch

from _torch_engine_sides import VALUE_RTOL, assert_same, both, side


def _set_at(s, x, i, value):
    if s.name == "jax":
        return x.at[i].set(value)
    x = x.clone()
    x[i] = value
    return x


def _engines_equal(s, got, want, sids):
    assert set(got.session_ids()) == set(want.session_ids())
    out = {}
    for sid in sids:
        a, b = s.rows(got, sid), s.rows(want, sid)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{s.name}: session {sid!r} state {k!r}")
        out[sid] = a
    return out


def _dir(tmp_path, s):
    d = tmp_path / s.name
    d.mkdir(exist_ok=True)
    return d


# ------------------------------------------------------------------ WAL frames
def _wal_roundtrip(s, tmp_path):
    path = str(_dir(tmp_path, s) / "ingest.wal")
    wal = s.durability.IngestWAL(path)
    wal.append("submit", 1, "a", ((1, 2), {}))
    wal.append("expire", 2, "a")
    wal.append("add", 3, "b", s.acc())  # Metric payloads ride as tagged pickles
    wal.sync()
    records, torn = s.durability.IngestWAL.read_records(path)
    assert not torn and records[0][3] == ((1, 2), {})
    tag, blob = records[2][3]
    assert tag == "__metric__" and isinstance(blob, bytes)
    wal.close()
    return [(r[0], r[1], r[2]) for r in records], open(path, "rb").read()[:8]


def test_wal_append_sync_read_roundtrip(tmp_path):
    ref, port = both(_wal_roundtrip, tmp_path)
    assert ref == port and port[0] == [("submit", 1, "a"), ("expire", 2, "a"), ("add", 3, "b")]
    assert port[1] == b"MTWAL001"


def _buffered(s, tmp_path):
    path = str(_dir(tmp_path, s) / "ingest.wal")
    wal = s.durability.IngestWAL(path)
    wal.append("submit", 1, "a", ((), {}))
    unsynced = s.durability.IngestWAL.read_records(path) == ([], False) or os.path.getsize(path) == len(
        s.durability.WAL_MAGIC)
    wal.sync()
    records, torn = s.durability.IngestWAL.read_records(path)
    wal.close()
    return unsynced, len(records), torn


def test_wal_append_is_buffered_until_sync(tmp_path):
    assert both(_buffered, tmp_path) == ((True, 1, False), (True, 1, False))


def _truncate(s, tmp_path):
    path = str(_dir(tmp_path, s) / "ingest.wal")
    wal = s.durability.IngestWAL(path)
    for seq in range(1, 6):
        wal.append("submit", seq, "a", ((seq,), {}))
    wal.sync()
    kept = wal.truncate(lambda seq: seq > 3)
    first = [r[1] for r in s.durability.IngestWAL.read_records(path)[0]]
    wal.append("submit", 6, "a", ((6,), {}))  # the reopened handle keeps working
    wal.sync()
    second = [r[1] for r in s.durability.IngestWAL.read_records(path)[0]]
    wal.close()
    return kept, first, second, open(path, "rb").read()


def test_wal_truncate_keeps_predicate_and_stays_appendable(tmp_path):
    ref, port = both(_truncate, tmp_path)
    assert ref[:3] == port[:3] == (2, [4, 5], [4, 5, 6])
    assert ref[3] == port[3]  # the same frames, byte for byte


def _torn(s, tmp_path):
    d = _dir(tmp_path, s)
    path = str(d / "ingest.wal")
    wal = s.durability.IngestWAL(path)
    for seq in range(1, 4):
        wal.append("submit", seq, "a", ((seq,), {}))
    wal.close()
    blob = open(path, "rb").read()
    with open(d / "torn.wal", "wb") as fh:
        fh.write(blob[:-5])  # a crash mid-append tears a suffix
    records, torn = s.durability.IngestWAL.read_records(str(d / "torn.wal"))
    out = [([r[1] for r in records], torn)]
    flipped = bytearray(blob)
    flipped[-1] ^= 0xFF
    with open(d / "flip.wal", "wb") as fh:
        fh.write(bytes(flipped))
    records, torn = s.durability.IngestWAL.read_records(str(d / "flip.wal"))
    out.append(([r[1] for r in records], torn))
    out.append(s.durability.IngestWAL.read_records(str(d / "missing.wal")))
    return out


def test_wal_torn_and_bitflipped_tail_stop_replay_cleanly(tmp_path):
    ref, port = both(_torn, tmp_path)
    assert ref == port == [([1, 2], True), ([1, 2], True), ([], False)]


# --------------------------------------------------------- checkpoint + replay
def _crash_recovery(s, tmp_path, restore_device=None):
    d = _dir(tmp_path, s)
    rng = np.random.RandomState(0)
    wal, ckpt = str(d / "ingest.wal"), str(d / "fleet.mtckpt")
    engine = s.StreamEngine(initial_capacity=4, wal_path=wal)
    sids = [engine.add_session(s.acc()) for _ in range(3)]
    sids += [engine.add_session(s.auroc()) for _ in range(3)]
    for _ in range(2):
        for sid in sids:
            engine.submit(sid, *(s.acc_batch(rng) if sid < 3 else s.auroc_batch(rng)))
        engine.tick()
    engine.checkpoint(ckpt)
    for sid in sids:  # the pending tail: journaled + fsynced, never ticked: the crash state
        engine.submit(sid, *(s.acc_batch(rng) if sid < 3 else s.auroc_batch(rng)))
    engine._wal.sync()
    kw = {} if restore_device is None else {"device": restore_device}
    recovered = s.StreamEngine.restore(ckpt, wal_path=wal, **kw)
    engine.tick()  # the never-crashed engine just applies the same tail
    recovered.tick()
    rows = _engines_equal(s, recovered, engine, sids)
    values = {}
    for sid in (sids[0], sids[-1]):
        values[sid] = s.np(recovered.compute(sid))
        np.testing.assert_array_equal(values[sid], s.np(engine.compute(sid)))
    counts = (s.count("wal_replay"), s.count("ckpt_restore"), s.count("fleet_restore"))
    assert counts == (len(sids), 1, 1)  # exactly the unticked wave
    return rows, values, counts


def test_crash_recovery_is_bit_exact_vs_never_crashed_oracle(tmp_path):
    ref, port = both(_crash_recovery, tmp_path)
    assert_same(ref[0], port[0])
    assert_same(ref[1], port[1], VALUE_RTOL)
    assert ref[2] == port[2]


def _one_dispatch_after_restore(s, tmp_path):
    d = _dir(tmp_path, s)
    rng = np.random.RandomState(1)
    wal, ckpt = str(d / "ingest.wal"), str(d / "fleet.mtckpt")
    engine = s.StreamEngine(wal_path=wal)
    sids = [engine.add_session(s.acc()) for _ in range(3)]
    for sid in sids:
        engine.submit(sid, *s.acc_batch(rng))
    engine.tick()
    engine.checkpoint(ckpt)
    for sid in sids:
        engine.submit(sid, *s.acc_batch(rng))
    engine._wal.sync()
    recovered = s.StreamEngine.restore(ckpt, wal_path=wal)
    first = recovered.tick()  # the replayed wave coalesces as a never-crashed tick would
    recovered.submit(sids[0], *s.acc_batch(rng))  # lifecycle keeps journaling on the repaired WAL
    return first, recovered.tick(), {sid: s.rows(recovered, sid) for sid in sids}


def test_restored_engine_keeps_one_dispatch_per_bucket_tick(tmp_path):
    ref, port = both(_one_dispatch_after_restore, tmp_path)
    assert ref[:2] == port[:2] == (1, 1)
    assert_same(ref[2], port[2])


def _expire_reset_replay(s, tmp_path):
    d = _dir(tmp_path, s)
    rng = np.random.RandomState(2)
    wal, ckpt = str(d / "ingest.wal"), str(d / "fleet.mtckpt")
    engine = s.StreamEngine(wal_path=wal)
    a, b = engine.add_session(s.acc()), engine.add_session(s.acc())
    for sid in (a, b):
        engine.submit(sid, *s.acc_batch(rng))
    engine.tick()
    engine.checkpoint(ckpt)
    engine.submit(a, *s.acc_batch(rng))
    engine.expire(b)
    engine.reset(a)  # discards a's queued submission too
    engine._wal.sync()
    recovered = s.StreamEngine.restore(ckpt, wal_path=wal)
    recovered.tick()
    engine.tick()
    assert set(recovered.session_ids()) == {a}
    rows = _engines_equal(s, recovered, engine, [a])
    for k, v in s.oracle_state(s.acc()).items():  # reset wound a back to defaults in both engines
        np.testing.assert_array_equal(rows[a][k], v)
    return rows


def test_expire_and_reset_replay_from_journal(tmp_path):
    assert_same(*both(_expire_reset_replay, tmp_path))


def _auto_ids(s, tmp_path):
    d = _dir(tmp_path, s)
    wal, ckpt = str(d / "ingest.wal"), str(d / "fleet.mtckpt")
    engine = s.StreamEngine(wal_path=wal)
    sids = [engine.add_session(s.acc()) for _ in range(3)]
    engine.checkpoint(ckpt)
    post = engine.add_session(s.acc())  # journaled, not checkpointed
    engine._wal.sync()
    recovered = s.StreamEngine.restore(ckpt, wal_path=wal)
    assert set(recovered.session_ids()) == {*sids, post}
    fresh = recovered.add_session(s.acc())
    assert fresh not in {*sids, post}  # recovered ids never recycle
    return sorted(recovered.session_ids())


def test_restore_resumes_auto_session_ids_past_journal(tmp_path):
    assert both(_auto_ids, tmp_path) == ([0, 1, 2, 3, 4], [0, 1, 2, 3, 4])


def _truncates(s, tmp_path):
    d = _dir(tmp_path, s)
    rng = np.random.RandomState(3)
    wal = str(d / "ingest.wal")
    engine = s.StreamEngine(wal_path=wal)
    sid = engine.add_session(s.acc())
    engine.submit(sid, *s.acc_batch(rng))
    engine.tick()
    engine.checkpoint(str(d / "a.mtckpt"))
    covered = s.durability.IngestWAL.read_records(wal)[0]  # the snapshot covers everything
    engine.submit(sid, *s.acc_batch(rng))  # pending again
    engine._wal.sync()
    engine.checkpoint(str(d / "b.mtckpt"))
    kinds = [r[0] for r in s.durability.IngestWAL.read_records(wal)[0]]  # pending records survive
    return covered, kinds, s.count("wal_truncate")


def test_checkpoint_truncates_journal_to_uncovered_records(tmp_path):
    assert both(_truncates, tmp_path) == (([], ["submit"], 2), ([], ["submit"], 2))


def _cached_bytes(s, tmp_path, monkeypatch):
    d = _dir(tmp_path, s)
    rng = np.random.RandomState(4)
    engine = s.StreamEngine()
    acc_sid = engine.add_session(s.acc())
    auroc_sid = engine.add_session(s.auroc())
    engine.submit(acc_sid, *s.acc_batch(rng))
    engine.submit(auroc_sid, *s.auroc_batch(rng))
    engine.tick()
    calls = []
    real = s.durability._bucket_node
    out = []
    with monkeypatch.context() as mp:
        mp.setattr(s.durability, "_bucket_node", lambda b: calls.append(b.label) or real(b))
        engine.checkpoint(str(d / "one.mtckpt"))
        out.append(len(calls))  # both buckets dirty on the first snapshot
        del calls[:]
        engine.checkpoint(str(d / "two.mtckpt"))
        out.append(len(calls))  # nothing moved: both re-emitted from cache
        engine.submit(acc_sid, *s.acc_batch(rng))
        engine.tick()
        engine.checkpoint(str(d / "three.mtckpt"))
        out.append(len(calls))  # only the bucket whose version moved re-pickles
    return out


def test_clean_buckets_reuse_cached_checkpoint_bytes(tmp_path, monkeypatch):
    assert both(_cached_bytes, tmp_path, monkeypatch) == ([2, 0, 1], [2, 0, 1])


def _corrupt(s, tmp_path):
    d = _dir(tmp_path, s)
    rng = np.random.RandomState(5)
    engine = s.StreamEngine()
    sid = engine.add_session(s.acc())
    engine.submit(sid, *s.acc_batch(rng))
    engine.tick()
    ckpt = str(d / "fleet.mtckpt")
    engine.checkpoint(ckpt)
    blob = open(ckpt, "rb").read()
    with open(d / "torn.mtckpt", "wb") as fh:
        fh.write(blob[:-9])
    with pytest.raises(s.checkpoint.CorruptCheckpointError):
        s.StreamEngine.restore(str(d / "torn.mtckpt"))
    flipped = bytearray(blob)
    flipped[len(flipped) // 2] ^= 0xFF
    with open(d / "flip.mtckpt", "wb") as fh:
        fh.write(bytes(flipped))
    with pytest.raises(s.checkpoint.CorruptCheckpointError):
        s.StreamEngine.restore(str(d / "flip.mtckpt"))
    return set(s.StreamEngine.restore(ckpt).session_ids()), blob[:8]  # the intact original still restores


def test_corrupt_fleet_checkpoint_rejected(tmp_path):
    assert both(_corrupt, tmp_path) == (({0}, b"MTCKPT01"), ({0}, b"MTCKPT01"))


def _alien(s, tmp_path):
    d = _dir(tmp_path, s)
    rng = np.random.RandomState(6)
    wal, ckpt = str(d / "ingest.wal"), str(d / "fleet.mtckpt")
    engine = s.StreamEngine(wal_path=wal)
    sid = engine.add_session(s.acc())
    engine.checkpoint(ckpt)
    engine.submit(sid, *s.acc_batch(rng))
    engine._wal.sync()
    records, _ = s.durability.IngestWAL.read_records(wal)
    alien = s.durability.IngestWAL(str(d / "alien.wal"))
    for kind, seq, _sid, payload in records:
        alien.append(kind, seq, "never-added", payload)
    alien.close()
    # a journal from a DIFFERENT engine history must not replay onto this snapshot
    with pytest.raises(s.checkpoint.CorruptCheckpointError, match="unknown") as err:
        s.StreamEngine.restore(ckpt, wal_path=str(d / "alien.wal"))
    return str(err.value).split(": ", 1)[1]


def test_journal_targeting_unknown_session_rejected(tmp_path):
    ref, port = both(_alien, tmp_path)
    assert ref == port


# ------------------------------------------------------------ precision regime
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
            yield
        finally:
            torch.set_default_dtype(previous)


def _regimes(s, tmp_path):
    d = _dir(tmp_path, s)
    rng = np.random.RandomState(7)
    ckpt32, ckpt64 = str(d / "f32.mtckpt"), str(d / "f64.mtckpt")
    engine = s.StreamEngine()
    sid = engine.add_session(s.acc())
    engine.submit(sid, *s.acc_batch(rng))
    engine.tick()
    engine.checkpoint(ckpt32)
    with _float64(s):
        with pytest.raises(s.checkpoint.IncompatibleCheckpointError, match="precision regime"):
            s.StreamEngine.restore(ckpt32)  # f32-written, f64-read: refused loudly, never silently cast
        wide = s.StreamEngine()
        wsid = wide.add_session(s.acc())
        wide.submit(wsid, *s.acc_batch(rng))
        wide.tick()
        wide.checkpoint(ckpt64)
        rows = _engines_equal(s, s.StreamEngine.restore(ckpt64), wide, [wsid])  # bit-exact natively
    with pytest.raises(s.checkpoint.IncompatibleCheckpointError, match="precision regime"):
        s.StreamEngine.restore(ckpt64)  # f64-written, f32-read: the other direction
    return rows


def test_roundtrip_under_x64_and_regime_mismatch_rejected(tmp_path):
    assert_same(*both(_regimes, tmp_path))


# --------------------------------------------------------- blast-radius limits
def _nan_guard(s):
    rng = np.random.RandomState(8)
    engine = s.StreamEngine(nan_guard=True)
    sids = [engine.add_session(s.auroc()) for _ in range(4)]
    oracles = {sid: s.auroc() for sid in sids[1:]}
    for sid in sids[1:]:
        args = s.auroc_batch(rng)
        engine.submit(sid, *args)
        oracles[sid].update(*args)
    preds, target = s.auroc_batch(rng)
    engine.submit(sids[0], _set_at(s, preds, 3, float("nan")), target)
    # the poisoned batch is dropped before the dispatch; the survivors coalesce into ONE dispatch
    out = [engine.tick(), [engine.session_health(sid) for sid in sids]]
    for sid in sids[1:]:
        assert engine._sessions[sid].bucket is not None
        s.assert_rows(engine, sid, oracles[sid])
    stats = engine.stats()
    (label,) = stats["buckets"]
    out += [s.count("fleet_quarantine"), s.count("fleet_dispatch"), stats["quarantined_sessions"],
            stats["buckets"][label]["health"]]
    clean = s.auroc_batch(rng)  # the quarantined session lives on loose: clean submissions still land
    engine.submit(sids[0], *clean)
    engine.tick()
    oracle = s.auroc()
    oracle.update(*clean)
    value = s.np(engine.compute(sids[0]))
    np.testing.assert_array_equal(value, s.np(oracle.compute()))
    return out, value, {sid: s.rows(engine, sid) for sid in sids[1:]}


def test_nan_guard_quarantines_one_session_never_the_bucket():
    ref, port = both(_nan_guard)
    assert ref[0] == port[0] == [1, ["quarantined", "healthy", "healthy", "healthy"], 1, 1, 1, "degraded"]
    assert_same(ref[1:], port[1:])


def _row_replay(s):
    stream_mod = __import__(f"{s.pkg.__name__}.engine.stream", fromlist=["x"])
    rng = np.random.RandomState(9)
    engine = s.StreamEngine()
    sids = [engine.add_session(s.auroc()) for _ in range(3)]
    oracles = {sid: s.auroc() for sid in sids}
    for j, sid in enumerate(sids):
        preds, target = s.auroc_batch(rng)
        if j == 1:
            preds = _set_at(s, preds, 0, 7.0)  # the marker the row replay will reject
        engine.submit(sid, preds, target)
        oracles[sid].update(preds, target)
    bucket = engine._sessions[sids[0]].bucket
    real_update = stream_mod.engine_update
    real_row = bucket.template._functional_update

    def dead_dispatch(*args, **kwargs):
        raise RuntimeError("injected runtime dispatch death")

    def picky_row(row, preds, target):
        if float(s.np(preds).max()) > 1.0:
            raise ValueError("poisoned row")
        return real_row(row, preds, target)

    fused = stream_mod.engine_update_fused
    stream_mod.engine_update = dead_dispatch
    stream_mod.engine_update_fused = dead_dispatch
    bucket.template._functional_update = picky_row
    try:
        engine.tick()  # the dispatch dies -> per-row eager replay with intact states
    finally:
        stream_mod.engine_update = real_update
        stream_mod.engine_update_fused = fused
        del bucket.template.__dict__["_functional_update"]
    health = [engine.session_health(sid) for sid in sids]
    for sid in (sids[0], sids[2]):  # survivors landed their updates bit-exact
        assert engine._sessions[sid].bucket is not None
        s.assert_rows(engine, sid, oracles[sid])
    s.assert_rows(engine, sids[1], s.auroc())  # the poisoned session rolled back: its batch was consumed
    return health, s.count("fleet_quarantine"), s.count("fleet_row_replay"), {
        sid: s.rows(engine, sid) for sid in sids}


def test_runtime_dispatch_death_replays_rows_and_quarantines_the_poison():
    ref, port = both(_row_replay)
    assert ref[:3] == port[:3] == (["healthy", "quarantined", "healthy"], 1, 2)
    assert_same(ref[3], port[3])


def _quarantined_restore(s, tmp_path):
    d = _dir(tmp_path, s)
    rng = np.random.RandomState(10)
    wal, ckpt = str(d / "ingest.wal"), str(d / "fleet.mtckpt")
    engine = s.StreamEngine(wal_path=wal, nan_guard=True)
    sids = [engine.add_session(s.auroc()) for _ in range(2)]
    preds, target = s.auroc_batch(rng)
    engine.submit(sids[0], _set_at(s, preds, 0, float("inf")), target)
    engine.submit(sids[1], *s.auroc_batch(rng))
    engine.tick()
    assert engine.session_health(sids[0]) == "quarantined"
    engine.checkpoint(ckpt)
    recovered = s.StreamEngine.restore(ckpt, wal_path=wal)
    return [recovered.session_health(sid) for sid in sids], _engines_equal(s, recovered, engine, sids)


def test_quarantined_sessions_checkpoint_and_restore_loose(tmp_path):
    ref, port = both(_quarantined_restore, tmp_path)
    assert ref[0] == port[0] == ["quarantined", "healthy"]
    assert_same(ref[1], port[1])


# ------------------------------------------------- crashpoints + torn tails
def _truncation_order(s, tmp_path, monkeypatch):
    d = _dir(tmp_path, s)
    rng = np.random.RandomState(37)
    wal, ckpt = str(d / "ingest.wal"), str(d / "fleet.mtckpt")
    engine = s.StreamEngine(wal_path=wal)
    sid = engine.add_session(s.acc())
    oracle = s.acc()
    args = s.acc_batch(rng)
    engine.submit(sid, *args)
    oracle.update(*args)
    engine.tick()
    seen = {}

    def crashing_truncate(self, keep):
        seen["ckpt_durable"] = os.path.exists(ckpt) and os.path.getsize(ckpt) > 0
        seen["wal_bytes"] = os.path.getsize(wal)
        raise RuntimeError("injected crash before truncate")

    with monkeypatch.context() as mp:
        mp.setattr(s.durability.IngestWAL, "truncate", crashing_truncate)
        with pytest.raises(RuntimeError, match="injected crash"):
            engine.checkpoint(ckpt)
    assert seen == {"ckpt_durable": True, "wal_bytes": os.path.getsize(wal)}  # the journal untouched
    engine._wal.close()
    recovered = s.StreamEngine.restore(ckpt, wal_path=wal)
    value = s.np(recovered.compute(sid))
    np.testing.assert_array_equal(value, s.np(oracle.compute()))
    return value


def test_wal_truncation_waits_for_a_durable_checkpoint(tmp_path, monkeypatch):
    assert_same(*both(_truncation_order, tmp_path, monkeypatch))


def _sharded_truncation_order(s, tmp_path, monkeypatch):
    d = _dir(tmp_path, s)
    rng = np.random.RandomState(39)
    wal_dir, ckpt_dir = str(d / "w"), str(d / "c")
    extra = {} if s.name == "jax" else {"devices": ["cpu"]}
    fleet = s.ShardedStreamEngine(n_shards=2, wal_dir=wal_dir, **extra)
    shard_of = s.sharded.shard_of
    sids, i = [], 0
    while len(sids) < 4:  # two sessions per shard
        sid = f"s{i}"
        i += 1
        if sum(1 for x in sids if shard_of(x, 2) == shard_of(sid, 2)) < 2:
            sids.append(sid)
    oracles = {sid: s.acc() for sid in sids}
    for sid in sids:
        fleet.add_session(s.acc(), sid)
        args = s.acc_batch(rng)
        fleet.submit(sid, *args)
        oracles[sid].update(*args)
    fleet.tick()
    manifest_path = os.path.join(ckpt_dir, s.sharded.MANIFEST_NAME)
    durable_at_truncate = []
    real_truncate = s.durability.IngestWAL.truncate

    def observing_truncate(self, keep):
        durable_at_truncate.append(
            os.path.exists(manifest_path) and s.checkpoint.load_manifest(manifest_path)["generation"] == 1
        )
        if len(durable_at_truncate) == 2:
            raise RuntimeError("injected crash between shard truncations")
        return real_truncate(self, keep)

    with monkeypatch.context() as mp:
        mp.setattr(s.durability.IngestWAL, "truncate", observing_truncate)
        with pytest.raises(RuntimeError, match="injected crash"):
            fleet.checkpoint(ckpt_dir)
    assert durable_at_truncate == [True, True]  # the manifest preceded EVERY truncate
    for shard in fleet._shards:
        if shard._wal is not None:
            shard._wal.close()
    rec = s.ShardedStreamEngine.restore(ckpt_dir, wal_dir=wal_dir, **extra)
    assert set(rec.session_ids()) == set(sids)
    values = {}
    for sid in sids:
        values[sid] = s.np(rec.compute(sid))
        np.testing.assert_array_equal(values[sid], s.np(oracles[sid].compute()))
    return values


def test_sharded_truncation_waits_for_a_durable_manifest(tmp_path, monkeypatch):
    assert_same(*both(_sharded_truncation_order, tmp_path, monkeypatch), VALUE_RTOL)


def _torn_tail(s, tmp_path):
    d = _dir(tmp_path, s)
    rng = np.random.RandomState(41)
    wal, ckpt = str(d / "ingest.wal"), str(d / "fleet.mtckpt")
    engine = s.StreamEngine(wal_path=wal)
    sid = engine.add_session(s.acc())
    oracle = s.acc()
    args = s.acc_batch(rng)
    engine.submit(sid, *args)
    oracle.update(*args)
    engine.tick()
    engine.checkpoint(ckpt)
    args = s.acc_batch(rng)  # journaled after the snapshot: survives the tear
    engine.submit(sid, *args)
    oracle.update(*args)
    engine.submit(sid, *s.acc_batch(rng))  # the frame the crash tears off
    engine._wal.sync()
    engine._wal.close()
    blob = open(wal, "rb").read()
    open(wal, "wb").write(blob[:-5])
    records, torn = s.durability.IngestWAL.read_records_detailed(wal)
    assert torn is not None and torn["frame_index"] == len(records) == 1
    assert 0 < torn["byte_offset"] < len(blob)
    recovered = s.StreamEngine.restore(ckpt, wal_path=wal)
    assert recovered.stats()["wal_torn_tail"] == (torn["frame_index"], torn["byte_offset"])
    events = [e for e in s.observe.snapshot()["events"] if e["kind"] == "wal_torn_tail"]
    assert events[-1]["frame"] == torn["frame_index"] and events[-1]["offset"] == torn["byte_offset"]
    out = [s.count("wal_torn_tail"), s.observe.snapshot()["derived"]["wal_torn_tails_total"], torn["frame_index"]]
    recovered.tick()  # everything before the tear still replays
    value = s.np(recovered.compute(sid))
    np.testing.assert_array_equal(value, s.np(oracle.compute()))
    return out, value


def test_torn_tail_location_is_surfaced_in_stats_and_events(tmp_path):
    ref, port = both(_torn_tail, tmp_path)
    assert ref[0] == port[0] == [1, 1, 1]
    assert_same(ref[1], port[1])


# ------------------------------------------------- the port's journal, the JAX package's reader
def test_jax_reader_reads_a_port_journal_to_the_same_records(tmp_path):
    from metrics_tpu.engine.durability import IngestWAL as JaxWAL

    s = side("torch")
    rng = np.random.RandomState(43)
    with s.fresh():
        wal = str(tmp_path / "port.wal")
        engine = s.StreamEngine(wal_path=wal)
        sids = [engine.add_session(s.acc()), engine.add_session(s.auroc(), session_id="auroc-1")]
        engine.submit(sids[0], *s.acc_batch(rng))
        engine.submit(sids[1], *s.auroc_batch(rng))
        engine.tick()
        engine.reset(sids[0])
        engine.serve_mark("producer-a", 7)
        engine.expire(sids[1])
        engine._wal.sync()
        port_records, port_torn = s.durability.IngestWAL.read_records(wal)
    jax_records, jax_torn = JaxWAL.read_records(wal)
    assert not port_torn and not jax_torn
    assert [(k, q, sid) for k, q, sid, _p in jax_records] == [(k, q, sid) for k, q, sid, _p in port_records] == [
        ("add", 1, 0), ("add", 2, "auroc-1"), ("submit", 3, 0), ("submit", 4, "auroc-1"), ("reset", 5, 0),
        ("serve_mark", 6, "producer-a"), ("expire", 7, "auroc-1")]
    # the payloads are numpy arrays and host bytes: no pickled tensor anywhere in the file
    args, kwargs = jax_records[2][3]
    assert all(isinstance(a, np.ndarray) for a in args) and kwargs == {}
    blob = open(wal, "rb").read()
    assert b"_rebuild_tensor" not in blob and b"torch._utils" not in blob


def test_card_journal_replays_on_the_cpu(tmp_path):
    # a packed metric keeps its device's name; restore(device=...) rebuilds it elsewhere, here cpu -> cpu
    # through the same path a card journal takes to the CPU
    s = side("torch")
    with s.fresh():
        ref = _crash_recovery(s, tmp_path, restore_device="cpu")
    from metrics_tpu_torch.engine.durability import pack_metric, unpack_metric

    m = s.auroc()
    blob = pack_metric(m)
    assert b"_rebuild_tensor" not in blob
    back = unpack_metric(blob, device="cpu")
    assert type(back) is type(m) and back.device.type == "cpu"
    assert back.config_fingerprint() == m.config_fingerprint()
    assert ref[2] == (6, 1, 1)


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-q"]))
