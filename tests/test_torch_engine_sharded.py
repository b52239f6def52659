"""The port's sharded fleet held against the JAX package's, case by case (``tests/test_sharded_engine.py``).

crc32 routing is process-stable and covers every shard; the partitioned fleet
stays bit-identical to per-instance oracles while shards sharing a metric
class share ONE program; ``aggregate`` folds through the declared merge
algebra (and, with ``mesh=`` a ``torch.distributed`` group, through
``all_reduce`` over it: the gloo case at the end); checkpoint/restore is
per-shard file + manifest and bit-exact through journal tails, elastic resize
and lost shards; the blast-radius ladder (dispatch death, shard self-heal,
demote to loose) never loses a submission. Each scenario runs on both
packages with the same seeded numpy batches (``tests/_torch_engine_sides.py``;
the port's shards all on the CPU, ``devices=["cpu"]``).
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import pytest
import torch

from _torch_engine_sides import VALUE_RTOL, assert_same, both, side


def _fleet(s, **kw):
    if s.name == "torch":
        kw.setdefault("devices", ["cpu"])
    return s.ShardedStreamEngine(**kw)


def _restore(s, *args, **kw):
    if s.name == "torch":
        kw.setdefault("devices", ["cpu"])
    return s.ShardedStreamEngine.restore(*args, **kw)


def _sids_covering(s, n_shards, per_shard=2):
    """Deterministic string sids that land ``per_shard`` sessions on EVERY shard."""
    found = {k: 0 for k in range(n_shards)}
    out, i = [], 0
    while any(v < per_shard for v in found.values()):
        sid = f"s{i}"
        i += 1
        k = s.sharded.shard_of(sid, n_shards)
        if found[k] < per_shard:
            found[k] += 1
            out.append(sid)
    return out


def _crash(fleet):
    """The host dies: journals stop mid-air, nothing else flushes."""
    for shard in fleet._shards:
        if shard._wal is not None:
            shard._wal.close()


def _computes(s, fleet, sids, oracles, rtol=0.0):
    out = {}
    for sid in sids:
        out[sid] = s.np(fleet.compute(sid))
        np.testing.assert_allclose(out[sid], s.np(oracles[sid].compute()), rtol=rtol, atol=0, err_msg=f"{s.name}: {sid}")
    return out


# ------------------------------------------------------------------- routing
def _routing(s):
    shard_of = s.sharded.shard_of
    assert shard_of("stream-7", 8) == zlib.crc32(b"'stream-7'") % 8  # crc32 of repr, never the salted hash()
    assert shard_of(1234, 8) == zlib.crc32(b"1234") % 8
    assert {shard_of(f"s{i}", 8) for i in range(256)} == set(range(8))
    fleet = _fleet(s, n_shards=4)
    sid = fleet.add_session(s.acc(), "stream-7")
    assert fleet._shards[fleet.shard_of(sid)].session_ids() == ["stream-7"]
    return [shard_of(f"s{i}", 8) for i in range(64)], fleet.shard_of(sid)


def test_shard_routing_is_crc_stable_and_covers_every_shard():
    ref, port = both(_routing)
    assert ref == port


def _partitioned(s):
    rng = np.random.RandomState(3)
    fleet = _fleet(s, n_shards=3)
    ctors = {"acc": (s.acc, s.acc_batch), "auroc": (s.auroc, s.auroc_batch)}
    sids = _sids_covering(s, 3, per_shard=2)
    kinds = {sid: ("acc" if i % 2 else "auroc") for i, sid in enumerate(sids)}
    oracles = {}
    for sid in sids:
        fleet.add_session(ctors[kinds[sid]][0](), sid)
        oracles[sid] = ctors[kinds[sid]][0]()
    for _ in range(3):
        for sid in sids:
            if rng.rand() < 0.8:  # ragged: not every stream every tick
                args = ctors[kinds[sid]][1](rng)
                fleet.submit(sid, *args)
                oracles[sid].update(*args)
        fleet.tick()
    assert len(fleet) == len(sids) and set(fleet.session_ids()) == set(sids)
    for sid in sids:  # states bit-exact; the bucket-wide compute within rtol (the JAX side's 1-ulp caveat)
        shard = fleet._shards[fleet.shard_of(sid)]
        s.assert_rows(shard, sid, oracles[sid])
    values = _computes(s, fleet, sids, oracles, VALUE_RTOL)
    out = fleet.expire(sids[0])  # expiry hands back a live metric carrying the full stream history
    np.testing.assert_array_equal(s.np(out.compute()), s.np(oracles[sids[0]].compute()))
    assert len(fleet) == len(sids) - 1
    return values


def test_partitioned_fleet_is_bit_exact_vs_per_instance_oracles():
    # the JAX package's own case fails by 1 ulp in its bucket-wide compute (a reference caveat); here both
    # sides hold their own oracles exactly and agree with each other within rtol 1e-6
    assert_same(*both(_partitioned), VALUE_RTOL)


def _one_program(s):
    rng = np.random.RandomState(5)
    fleet = _fleet(s, n_shards=4)
    sids = _sids_covering(s, 4, per_shard=2)
    for sid in sids:
        fleet.add_session(s.acc(), sid)
    for sid in sids:
        fleet.submit(sid, *s.acc_batch(rng))
    out = [fleet.tick(), sum(s.update_compiles().values())]  # 4 shard dispatches, ONE program
    for sid in sids:
        fleet.submit(sid, *s.acc_batch(rng))
    out += [fleet.tick(), sum(s.update_compiles().values())]  # steady state: no new program
    return out


def test_shards_share_one_compiled_program_and_one_dispatch_each():
    assert both(_one_program) == ([4, 1, 4, 1], [4, 1, 4, 1])


def _auto_ids(s):
    fleet = _fleet(s, n_shards=3)
    a = fleet.add_session(s.acc())
    b = fleet.add_session(s.acc())
    fleet.add_session(s.acc(), 17)  # an explicit int bumps the auto counter past it
    c = fleet.add_session(s.acc())
    assert a != b and c not in {a, b, 17}
    return sorted(fleet.session_ids())


def test_auto_ids_are_fleet_unique_and_dodge_explicit_ints():
    assert both(_auto_ids) == ([0, 1, 17, 18], [0, 1, 17, 18])


# ----------------------------------------------------------------- aggregate
def _aggregate(s):
    rng = np.random.RandomState(11)
    fleet = _fleet(s, n_shards=3)
    sids = _sids_covering(s, 3, per_shard=2)
    oracle = s.acc()  # sum-reduction states: pooling all batches == merging
    updates = 0
    for sid in sids:
        fleet.add_session(s.acc(), sid)
    fleet.add_session(s.auroc(), "other")  # a non-matching class must not leak in
    fleet.submit("other", *s.auroc_batch(rng))
    for sid in sids:
        for _ in range(2):
            args = s.acc_batch(rng)
            fleet.submit(sid, *args)
            oracle.update(*args)
            updates += 1
    merged = fleet.aggregate(s.acc())
    assert merged._update_count == updates
    values = [s.np(merged.compute())]
    np.testing.assert_array_equal(values[0], s.np(oracle.compute()))
    # the intra-group fold size and the collective path change staging, never the result (the port's
    # mesh=True folds on the host when no process group is initialized)
    for kwargs in ({"group_size": 2}, {"mesh": True}):
        again = s.np(fleet.aggregate(s.acc(), **kwargs).compute())
        np.testing.assert_array_equal(again, s.np(oracle.compute()))
        values.append(again)
    assert fleet.aggregate(s.MulticlassAccuracy(num_classes=7, **s.kw)) is None
    return updates, values, {k: s.np(v) for k, v in merged._state.items()}


def test_aggregate_folds_matching_sessions_through_declared_algebra():
    assert_same(*both(_aggregate))


# ---------------------------------------------------------------- durability
def _journal_tails(s, tmp_path):
    d = tmp_path / s.name
    rng = np.random.RandomState(7)
    wal_dir, ckpt_dir = str(d / "w"), str(d / "c")
    fleet = _fleet(s, n_shards=2, wal_dir=wal_dir)
    sids = _sids_covering(s, 2, per_shard=2)
    oracles = {sid: s.acc() for sid in sids}
    for sid in sids:
        fleet.add_session(s.acc(), sid)
    for sid in sids:
        args = s.acc_batch(rng)
        fleet.submit(sid, *args)
        oracles[sid].update(*args)
    fleet.tick()
    manifest_path = fleet.checkpoint(ckpt_dir)
    assert os.path.basename(manifest_path) == s.sharded.MANIFEST_NAME
    for sid in sids[:2]:  # post-checkpoint ingest lives only in the per-shard journals
        args = s.acc_batch(rng)
        fleet.submit(sid, *args)
        oracles[sid].update(*args)
    fleet.tick()
    _crash(fleet)
    rec = _restore(s, ckpt_dir, wal_dir=wal_dir)
    assert rec.n_shards == 2 and set(rec.session_ids()) == set(sids)
    return _computes(s, rec, sids, oracles), sorted(os.listdir(ckpt_dir))


def test_checkpoint_restore_is_bit_exact_through_journal_tails(tmp_path):
    assert_same(*both(_journal_tails, tmp_path), VALUE_RTOL)


def _resize(s, tmp_path):
    d = tmp_path / s.name
    rng = np.random.RandomState(13)
    wal_dir, ckpt_dir = str(d / "w"), str(d / "c")
    fleet = _fleet(s, n_shards=2, wal_dir=wal_dir)
    sids = _sids_covering(s, 2, per_shard=2)
    oracles = {sid: s.acc() for sid in sids}
    for sid in sids:
        fleet.add_session(s.acc(), sid)
        args = s.acc_batch(rng)
        fleet.submit(sid, *args)
        oracles[sid].update(*args)
    fleet.tick()
    fleet.checkpoint(ckpt_dir)
    _crash(fleet)
    grown = _restore(s, ckpt_dir, wal_dir=wal_dir, n_shards=3)
    assert grown.n_shards == 3 and set(grown.session_ids()) == set(sids)
    # the resize re-checkpointed at once: the manifest on disk describes the live topology
    manifest = s.checkpoint.load_manifest(os.path.join(ckpt_dir, s.sharded.MANIFEST_NAME))
    assert manifest["n_shards"] == 3 and manifest["generation"] == grown._generation
    for sid in sids:
        assert grown.shard_of(sid) == s.sharded.shard_of(sid, 3)
    first = _computes(s, grown, sids, oracles)
    _crash(grown)  # the rewritten manifest + journals are self-sufficient: crash + restore again
    rec = _restore(s, ckpt_dir, wal_dir=wal_dir)
    assert rec.n_shards == 3
    return first, _computes(s, rec, sids, oracles), manifest["generation"]


def test_elastic_resize_rehashes_and_rewrites_the_manifest(tmp_path):
    assert_same(*both(_resize, tmp_path), VALUE_RTOL)


def _lost_shard(s, tmp_path):
    d = tmp_path / s.name
    rng = np.random.RandomState(17)
    wal_dir, ckpt_dir = str(d / "w"), str(d / "c")
    fleet = _fleet(s, n_shards=2, wal_dir=wal_dir)
    sids = _sids_covering(s, 2, per_shard=2)
    oracles = {sid: s.acc() for sid in sids}
    for sid in sids:
        fleet.add_session(s.acc(), sid)
        args = s.acc_batch(rng)
        fleet.submit(sid, *args)
        oracles[sid].update(*args)
    fleet.tick()
    fleet.checkpoint(ckpt_dir)
    _crash(fleet)
    victim = os.path.join(ckpt_dir, f"g{fleet._generation:08d}-shard000.mtckpt")  # its CRC no longer matches
    blob = bytearray(open(victim, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(victim, "wb").write(bytes(blob))
    with pytest.raises(s.checkpoint.CheckpointError):
        _restore(s, ckpt_dir, wal_dir=wal_dir)
    rec = _restore(s, ckpt_dir, wal_dir=wal_dir, on_lost_shard="demote")
    survivors = [sid for sid in sids if s.sharded.shard_of(sid, 2) == 1]
    assert rec.stats()["demoted_shards"] == [0] and set(rec.session_ids()) == set(survivors)
    values = _computes(s, rec, survivors, oracles)
    i = 0  # the demoted shard keeps accepting arrivals: loose, never a vmapped dispatch
    while s.sharded.shard_of(f"n{i}", 2) != 0:
        i += 1
    rec.add_session(s.acc(), f"n{i}")
    health = rec.session_health(f"n{i}")
    rec.submit(f"n{i}", *s.acc_batch(rng))
    for sid in survivors:
        rec.submit(sid, *s.acc_batch(rng))
    return values, health, rec.tick()


def test_lost_shard_raises_by_default_and_demotes_on_request(tmp_path):
    ref, port = both(_lost_shard, tmp_path)
    assert ref[1:] == port[1:] == ("loose", 1)
    assert_same(ref[0], port[0], VALUE_RTOL)


def _torn_manifest(s, tmp_path):
    d = tmp_path / s.name
    fleet = _fleet(s, n_shards=2, wal_dir=str(d / "w"))
    fleet.add_session(s.acc(), "s0")
    fleet.checkpoint(str(d / "c"))
    path = os.path.join(str(d / "c"), s.sharded.MANIFEST_NAME)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-7])
    with pytest.raises(s.checkpoint.CorruptCheckpointError) as err:
        _restore(s, str(d / "c"))
    return blob[:8], "truncated or trailing garbage" in str(err.value)


def test_torn_manifest_is_rejected(tmp_path):
    ref, port = both(_torn_manifest, tmp_path)
    assert ref == port == (b"MTMAN001", True)


# -------------------------------------------------------- blast-radius ladder
def _poison_tick(s, shard):
    # the pipelined sharded tick drives the stage/dispatch halves directly; the dispatch half is where
    # a death that leaves the stacked states unusable surfaces
    def dead_dispatch(staged):
        raise s.core.DispatchConsumedError("injected: stacked states lost with a dead dispatch")

    shard._dispatch_flush = dead_dispatch


def _durable_two_shard_fleet(s, tmp_path, rng):
    d = tmp_path / s.name
    fleet = _fleet(s, n_shards=2, wal_dir=str(d / "w"))
    sids = _sids_covering(s, 2, per_shard=2)
    oracles = {sid: s.acc() for sid in sids}
    for sid in sids:
        fleet.add_session(s.acc(), sid)
        args = s.acc_batch(rng)
        fleet.submit(sid, *args)
        oracles[sid].update(*args)
    fleet.tick()
    fleet.checkpoint(str(d / "c"))
    return fleet, sids, oracles


def _self_heal(s, tmp_path):
    rng = np.random.RandomState(23)
    fleet, sids, oracles = _durable_two_shard_fleet(s, tmp_path, rng)
    wounded = [sid for sid in sids if s.sharded.shard_of(sid, 2) == 0]
    args = s.acc_batch(rng)  # journal a post-checkpoint submission on shard 0, then kill its dispatch
    fleet.submit(wounded[0], *args)
    oracles[wounded[0]].update(*args)
    old_shard = fleet._shards[0]
    _poison_tick(s, old_shard)
    fleet.tick()  # heals shard 0 in place; shard 1 never stopped ticking
    assert fleet._shards[0] is not old_shard
    assert 0 in fleet._heal_suspect and not fleet._demoted
    values = _computes(s, fleet, sids, oracles)  # checkpoint + journal replay, the in-flight wave too
    fleet.tick()  # a clean tick ends heal probation
    assert 0 not in fleet._heal_suspect
    return values, s.count("shard_restore")


def test_dispatch_death_self_heals_the_one_shard_from_its_own_files(tmp_path):
    ref, port = both(_self_heal, tmp_path)
    assert ref[1] == port[1] == 1
    assert_same(ref[0], port[0], VALUE_RTOL)


def _death_loop(s, tmp_path):
    rng = np.random.RandomState(29)
    fleet, sids, oracles = _durable_two_shard_fleet(s, tmp_path, rng)
    _poison_tick(s, fleet._shards[0])
    fleet.tick()  # first death: heal, enter probation
    _poison_tick(s, fleet._shards[0])
    fleet.tick()  # second death before a clean tick: the last rung, demote
    assert fleet.stats()["demoted_shards"] == [0]
    healthy = [sid for sid in sids if s.sharded.shard_of(sid, 2) == 1]
    wounded = [sid for sid in sids if s.sharded.shard_of(sid, 2) == 0]
    assert all(fleet.session_health(sid) == "loose" for sid in wounded)
    for sid in sids:
        args = s.acc_batch(rng)
        fleet.submit(sid, *args)
        oracles[sid].update(*args)
    dispatches = fleet.tick()  # shard 1's bucket only; demoted sessions run eagerly
    values = _computes(s, fleet, sids, oracles)
    return dispatches, fleet.session_health(healthy[0]), values


def test_dispatch_death_loop_demotes_the_shard_not_the_fleet(tmp_path):
    ref, port = both(_death_loop, tmp_path)
    assert ref[:2] == port[:2] == (1, "healthy")
    assert_same(ref[2], port[2], VALUE_RTOL)


def _no_durability(s):
    fleet = _fleet(s, n_shards=2)
    fleet.add_session(s.acc(), "s0")
    _poison_tick(s, fleet._shards[s.sharded.shard_of("s0", 2)])
    with pytest.raises(s.core.DispatchConsumedError):
        fleet.tick()
    return True


def test_dispatch_death_without_durability_must_surface():
    assert both(_no_durability) == (True, True)


# ----------------------------------------------------------------- telemetry
def _telemetry(s):
    rng = np.random.RandomState(31)
    fleet = _fleet(s, n_shards=2, name="obs")
    sids = _sids_covering(s, 2, per_shard=2)
    for sid in sids:
        fleet.add_session(s.acc(), sid)
        fleet.submit(sid, *s.acc_batch(rng))
    fleet.tick()
    stats = fleet.stats()
    per = {x["shard"]: x for x in stats["shards"]}
    snap = s.observe.snapshot()
    assert snap["derived"]["shard_occupancy_pct"] == pytest.approx(stats["occupancy_pct"])
    return {
        "fleet": {k: stats[k] for k in ("name", "n_shards", "ticks", "sessions", "demoted_shards", "rows_active",
                                        "rows_capacity", "occupancy_pct")},
        "shards": {k: {f: v[f] for f in ("name", "health", "sessions", "rows_active", "rows_capacity")}
                   for k, v in per.items()},
        "gauges": sorted(snap["gauges"]["shard_healthy"]),
        "derived": (snap["derived"]["fleet_shards_total"], snap["derived"]["fleet_shards_demoted"]),
    }


def test_stats_shard_stats_and_observe_gauges():
    ref, port = both(_telemetry)
    assert ref == port
    assert port["fleet"]["name"] == "obs" and port["shards"][0]["name"] == "obs/shard0"
    assert port["gauges"] == ["obs/shard0", "obs/shard1"] and port["derived"] == (2, 0)


# -------------------------------------------------------------- recovery sweep
_SWEEP = {
    "MulticlassAccuracy": lambda s: (s.acc, s.acc_batch),
    "BinaryAUROC": lambda s: (s.auroc, s.auroc_batch),
    "MeanMetric": lambda s: (lambda: s.pkg.MeanMetric(nan_strategy="ignore", **s.kw),
                             lambda r: (s.arr(r.rand(8).astype(np.float32)),)),
    "SumMetric": lambda s: (lambda: s.pkg.SumMetric(nan_strategy="ignore", **s.kw),
                            lambda r: (s.arr(r.rand(8).astype(np.float32)),)),
}


def _recovery(s, name, tmp_path):
    """Host kill and elastic resize against a never-crashed fleet fed the same batches."""
    d = tmp_path / s.name / name
    rng = np.random.RandomState(zlib.crc32(name.encode()) % (2**31))
    ctor, batch = _SWEEP[name](s)
    sids = _sids_covering(s, 2, per_shard=2)
    fleet = _fleet(s, n_shards=2, wal_dir=str(d / "w"))
    calm = _fleet(s, n_shards=2)
    for sid in sids:
        fleet.add_session(ctor(), sid)
        calm.add_session(ctor(), sid)
    for t in range(3):
        for sid in sids:
            args = batch(rng)
            fleet.submit(sid, *args)
            calm.submit(sid, *args)
        if t == 1:
            fleet.checkpoint(str(d / "c"))
        fleet.tick()
        calm.tick()
    _crash(fleet)
    rec = _restore(s, str(d / "c"), wal_dir=str(d / "w"))
    grown = _restore(s, str(d / "c"), wal_dir=str(d / "w"), n_shards=3)
    out = {}
    for sid in sids:
        want = s.np(calm.compute(sid))
        for fl in (rec, grown):
            np.testing.assert_array_equal(s.np(fl.compute(sid)), want, err_msg=f"{s.name}: {name} {sid}")
        out[sid] = want
    return out


@pytest.mark.parametrize("name", sorted(_SWEEP))
def test_registry_wide_shard_chaos_sweep(name, tmp_path):
    # the JAX package's registry-wide sweep is marked slow there; here host-kill and elastic-resize recovery
    # over four classes, bit-exact against a never-crashed fleet in each package
    assert_same(*both(_recovery, name, tmp_path), VALUE_RTOL)


# -------------------------------------------------------------- the collective fold over gloo
def test_aggregate_mesh_all_reduces_over_a_gloo_group(tmp_path):
    import torch.multiprocessing as mp

    from _torch_engine_workers import aggregate_worker

    world = 2
    out = str(tmp_path / "out")
    os.makedirs(out)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=aggregate_worker, args=(rank, world, f"file://{tmp_path / 'store'}", out))
             for rank in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
        assert p.exitcode == 0
    results = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(world)]
    # every rank holds the fold of both ranks' fleets, equal to one oracle fed every batch
    for res in results:
        assert res["count"] == results[0]["oracle_count"]
        for k, v in res["state"].items():
            assert torch.equal(v, results[0]["oracle"][k]), k
    assert results[0]["empty_is_none"]
