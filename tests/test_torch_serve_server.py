"""The port's front-door reactor held against the JAX package's, case by case (``tests/test_serve_server.py``).

Socketpair-driven (``server.adopt``), single-threaded: the test plays both
ends. Each scenario runs on both packages with the same seeded numpy batches
(``tests/test_torch_serve_cases.py``), asserts what the JAX package's case
asserts on each, and the two sides must agree on acks, watermarks, counters and
states. Then the cases of the port alone: a metric blob of the JAX package is
refused with an ``err`` ack and the reactor survives, and a served fleet equals
a JAX-served fleet fed the same producer sequence.
"""

from __future__ import annotations

import pickle
import socket

import numpy as np
import pytest

from _torch_engine_sides import assert_same
from test_torch_serve_cases import KEY, batch, on_both, serve_side


# ------------------------------------------------------------------ handshake
def _wrong_key(sv, d):
    engine = sv.engine(wal_path=str(d / "serve.wal"))
    server = sv.server(engine, host=None)
    srv_sock, cli = socket.socketpair()
    server.adopt(srv_sock)
    with pytest.raises(sv.protocol.ProtocolError):
        sv.Producer(None, "wrong-key", name="evil", sock=cli, drive=lambda: server.poll(0.0))
    assert server.stats()["producers"] == []
    assert len(engine) == 0
    return server.stats()["admission"]


def test_wrong_session_key_is_rejected_before_any_data(tmp_path):
    ref, port = on_both(_wrong_key, tmp_path)
    assert ref == port


def _data_before_hello(sv, d):
    engine = sv.engine(wal_path=str(d / "serve.wal"))
    server = sv.server(engine, host=None)
    srv_sock, cli = socket.socketpair()
    server.adopt(srv_sock)
    cli.sendall(sv.WAL_MAGIC + sv.encode_frame("submit", 1, "s0", ((), {})))
    server.poll(0.0)
    assert server.protocol_errors == 1
    assert len(engine) == 0
    return server.protocol_errors, server.disconnects


def test_data_before_hello_is_a_protocol_error(tmp_path):
    ref, port = on_both(_data_before_hello, tmp_path)
    assert ref == port


def _welcome(sv, d):
    engine, server, prod = sv.rig(d, window=7)
    assert prod.window == 7
    assert prod.server_watermark == 0
    prod.add_session(sv.metric(), session_id="s0")
    prod.flush(5.0)
    srv2, cli2 = socket.socketpair()
    server.adopt(srv2)
    prod2 = sv.Producer(None, KEY, name="prod-a", sock=cli2, drive=lambda: server.poll(0.0))
    assert prod2.server_watermark == 1
    return prod.window, prod2.server_watermark


def test_welcome_carries_the_fleet_watermark_and_credits(tmp_path):
    ref, port = on_both(_welcome, tmp_path)
    assert ref == port


# ----------------------------------------------------------- admission verdicts
def _defer(sv, d):
    defer_once = sv.AdmissionController((
        sv.AdmissionRule("always_defer", "occupancy_pct", ">=", 0.0, "defer", 0.0),
    ))
    engine, server, prod = sv.rig(d, admission=defer_once)
    pseq = prod.add_session(sv.metric(), session_id="s0")
    prod.pump()
    server.poll(0.0)
    prod.pump()
    assert prod.deferred >= 1
    assert engine.serve_watermark("prod-a") < pseq
    server.admission = sv.AdmissionController()
    prod.flush(5.0)
    assert len(engine) == 1
    assert engine.serve_watermark("prod-a") == pseq
    return pseq, prod.deferred >= 1


def test_defer_is_not_watermarked_and_retries_to_acceptance(tmp_path):
    ref, port = on_both(_defer, tmp_path)
    assert ref == port


def _reject(sv, d):
    reject_all = sv.AdmissionController((
        sv.AdmissionRule("always_reject", "occupancy_pct", ">=", 0.0, "reject"),
    ))
    engine, server, prod = sv.rig(d, admission=reject_all)
    pseq = prod.add_session(sv.metric(), session_id="s0")
    prod.flush(5.0)
    assert prod.rejected == 1
    assert len(engine) == 0
    assert engine.serve_watermark("prod-a") == pseq
    prod._send_raw(sv.encode_frame("add", pseq, "s0", sv.metric()))
    server.poll(0.0)
    prod.pump()
    assert server.dedup_skipped == 1
    assert len(engine) == 0
    return prod.errors, server.dedup_skipped, dict(server.admission.counts)


def test_reject_is_watermarked_so_resends_dedup(tmp_path):
    ref, port = on_both(_reject, tmp_path)
    assert ref == port


def _shed(sv, d):
    engine = sv.engine(wal_path=str(d / "serve.wal"))
    auto = sv.AutonomicController(engine, min_interval_s={"shed": 0.0})
    shed_table = sv.AdmissionController((
        sv.AdmissionRule("overload", "occupancy_pct", ">=", 0.0, "shed"),
    ))
    engine, server, prod = sv.rig(d, engine=engine, admission=shed_table, autonomic=auto)
    engine.add_session(sv.metric(), session_id="bucketed")
    engine.add_session(sv.metric(), session_id="loose")
    engine._demote_session(engine._sessions["loose"])
    prod.add_session(sv.metric(), session_id="arrival")
    prod.flush(5.0)
    assert "loose" not in engine._sessions
    assert "bucketed" in engine._sessions
    assert "arrival" in engine._sessions
    assert auto.counts["shed"] == 1
    return sorted(engine._sessions), dict(auto.counts)


def test_shed_verdict_evicts_loose_first_then_admits(tmp_path):
    ref, port = on_both(_shed, tmp_path)
    assert ref == port


# ------------------------------------------------------------- per-record faults
def _bad_call(sv, d):
    engine, server, prod = sv.rig(d)
    prod.add_session(sv.metric(), session_id="s0")
    prod.flush(5.0)
    bad = prod.submit("no-such-session", *batch())
    prod.flush(5.0)
    assert [e[0] for e in prod.errors] == [bad]
    assert "KeyError" in prod.errors[0][3] or "unknown" in prod.errors[0][3].lower()
    prod.submit("s0", *batch())
    prod.flush(5.0)
    server.tick()
    assert sv.applied(engine, "s0") >= 1
    return [e[:3] for e in prod.errors], prod.errors[0][3], sv.state(engine, "s0")


def test_bad_api_call_gets_err_ack_and_the_connection_survives(tmp_path):
    ref, port = on_both(_bad_call, tmp_path)
    assert_same(ref, port)


def _dup(sv, d):
    engine, server, prod = sv.rig(d)
    prod.add_session(sv.metric(), session_id="s0")
    pseq = prod.submit("s0", *batch())
    prod.flush(5.0)
    server.tick()
    applied = sv.applied(engine, "s0")
    assert applied == 1
    prod._send_raw(sv.encode_frame("submit", pseq, "s0", (batch(), {})))
    server.poll(0.0)
    prod.pump()
    server.tick()
    assert server.dedup_skipped == 1
    assert sv.applied(engine, "s0") == applied
    return server.dedup_skipped, sv.state(engine, "s0")


def test_duplicate_pseq_dedups_against_the_watermark(tmp_path):
    ref, port = on_both(_dup, tmp_path)
    assert_same(ref, port)


# ----------------------------------------------------- in-order resolution
def _deferred_not_lost(sv, d):
    defer_arrivals = sv.AdmissionController((
        sv.AdmissionRule("arrivals_defer", "occupancy_pct", ">=", 0.0, "defer", 0.0),
    ))
    engine, server, prod = sv.rig(d, admission=defer_arrivals)
    add_pseq = prod.add_session(sv.metric(), session_id="s0")
    sub_pseq = prod.submit("s0", *batch())
    for _ in range(4):
        prod.pump()
        server.poll(0.0)
        prod.pump()
    assert engine.serve_watermark("prod-a") == 0
    assert server.ordering_defers >= 1
    assert len(engine) == 0
    server.admission = sv.AdmissionController()
    prod.flush(5.0)
    server.tick()
    assert "s0" in engine._sessions
    assert sv.applied(engine, "s0") == 1
    assert engine.serve_watermark("prod-a") == max(add_pseq, sub_pseq)
    assert prod.errors == []
    return engine.serve_watermark("prod-a"), sv.state(engine, "s0")


def test_deferred_record_is_not_lost_behind_later_pseqs(tmp_path):
    ref, port = on_both(_deferred_not_lost, tmp_path)
    assert_same(ref, port)


def _reject_behind_defer(sv, d):
    defer_arrivals = sv.AdmissionController((
        sv.AdmissionRule("arrivals_defer", "occupancy_pct", ">=", 0.0, "defer", 0.0),
        sv.AdmissionRule("reject_rest", "occupancy_pct", ">=", 0.0, "reject", None, False),
    ))
    engine, server, prod = sv.rig(d, admission=defer_arrivals)
    prod.add_session(sv.metric(), session_id="s0")
    prod.submit("s0", *batch())
    for _ in range(3):
        prod.pump()
        server.poll(0.0)
        prod.pump()
    assert engine.serve_watermark("prod-a") == 0
    server.admission = sv.AdmissionController()
    prod.flush(5.0)
    assert engine.serve_watermark("prod-a") == 2
    return engine.serve_watermark("prod-a"), len(engine)


def test_reject_behind_a_deferred_record_does_not_watermark_the_gap(tmp_path):
    ref, port = on_both(_reject_behind_defer, tmp_path)
    assert ref == port


# ------------------------------------------------------- hostile-peer fencing
def _hostile_preauth(sv, d):
    import struct
    import zlib

    engine, server, prod = sv.rig(d)
    srv2, evil = socket.socketpair()
    server.adopt(srv2)
    gadget = b"c__builtin__\neval\n(V1+1\ntR."
    frame = struct.pack(">II", len(gadget), zlib.crc32(gadget) & 0xFFFFFFFF) + gadget
    evil.sendall(sv.WAL_MAGIC + frame)
    server.poll(0.0)
    assert server.protocol_errors == 1
    assert server.disconnects == 1
    prod.add_session(sv.metric(), session_id="s0")
    prod.flush(5.0)
    assert len(engine) == 1
    return server.protocol_errors, server.disconnects, len(engine)


def test_preauth_hostile_pickle_drops_the_connection_only(tmp_path):
    ref, port = on_both(_hostile_preauth, tmp_path)
    assert ref == port


def _malformed(sv, d):
    engine, server, prod = sv.rig(d)
    hostile_frames = [
        sv.encode_frame("hello", 0, "h1", ["not", "a", "dict"]),
        sv.encode_frame("hello", 0, "h2", {"key": "éé-key", "producer": "h2"}),
    ]
    for frame in hostile_frames:
        srv_n, cli_n = socket.socketpair()
        server.adopt(srv_n)
        cli_n.sendall(sv.WAL_MAGIC + frame)
        server.poll(0.0)
        cli_n.close()
    srv_n, cli_n = socket.socketpair()
    server.adopt(srv_n)
    cli_n.sendall(
        sv.WAL_MAGIC
        + sv.encode_frame("hello", 0, "h3", {"key": KEY, "producer": "h3"})
        + sv.encode_frame("submit", "not-an-int", "s0", ((), {}))
    )
    server.poll(0.0)
    assert server.protocol_errors >= 1
    prod.add_session(sv.metric(), session_id="s0")
    prod.flush(5.0)
    assert len(engine) == 1
    return server.protocol_errors, len(engine)


def test_malformed_crc_valid_records_do_not_kill_the_reactor(tmp_path):
    ref, port = on_both(_malformed, tmp_path)
    assert ref == port


def _dying_connection(sv, d):
    reject_all = sv.AdmissionController((
        sv.AdmissionRule("always_reject", "occupancy_pct", ">=", 0.0, "reject"),
    ))
    engine = sv.engine(wal_path=str(d / "serve.wal"))
    server = sv.server(engine, host=None, admission=reject_all)
    srv_sock, cli = socket.socketpair()
    server.adopt(srv_sock)
    good = sv.encode_frame("add", 1, "s0", sv.metric())
    bad = bytearray(sv.encode_frame("add", 2, "s1", sv.metric()))
    bad[-1] ^= 0xFF
    cli.sendall(sv.WAL_MAGIC + sv.encode_frame("hello", 0, "p", {"key": KEY, "producer": "p"}) + good + bytes(bad))
    server.poll(0.0)
    assert server.protocol_errors == 1
    assert len(engine) == 0
    assert server.admission.counts["reject"] == 1
    return dict(server.admission.counts), server.protocol_errors


def test_drained_records_from_a_dying_connection_face_live_admission(tmp_path):
    ref, port = on_both(_dying_connection, tmp_path)
    assert ref == port


def _firehose(sv, d):
    engine, server, prod = sv.rig(d)
    prod.add_session(sv.metric(), session_id="s0")
    prod.flush(5.0)
    server.read_budget_bytes = 4096
    server.pending_cap = 4
    burst = b"".join(sv.encode_frame("submit", 2 + i, "s0", (batch(i), {})) for i in range(64))
    prod._sock.sendall(burst)
    polled_bytes_before = server.bytes_in_total
    server.poll(0.0)
    assert server.bytes_in_total - polled_bytes_before <= 4096
    for _ in range(256):
        server.poll(0.0)
    server.tick()
    assert server.queue_high_water < 64
    assert engine.serve_watermark("prod-a") == 65
    assert sv.applied(engine, "s0") == 64
    return engine.serve_watermark("prod-a"), sv.state(engine, "s0")


def test_read_budget_and_pending_cap_bound_one_connection(tmp_path):
    ref, port = on_both(_firehose, tmp_path)
    assert_same(ref, port)


# ------------------------------------------------------------ durability ordering
def _acked_on_disk(sv, d):
    wal = d / "serve.wal"
    engine, server, prod = sv.rig(d)
    prod.add_session(sv.metric(), session_id="s0")
    prod.submit("s0", *batch())
    prod.flush(5.0)
    records, torn = sv.durability.IngestWAL.read_records_detailed(str(wal))
    assert torn is None
    kinds = [r[0] for r in records]
    assert kinds.count("add") == 1 and kinds.count("submit") == 1
    assert kinds.count("serve_mark") == 2
    marks = [(r[2], r[3]) for r in records if r[0] == "serve_mark"]
    assert marks == [("prod-a", 1), ("prod-a", 2)]
    return [(r[0], r[1], r[2]) for r in records], records[1][3]


def test_every_acked_record_is_on_disk_before_the_ack(tmp_path):
    ref, port = on_both(_acked_on_disk, tmp_path)
    assert_same(ref, port)


# ------------------------------------------------------------------ sharded routing
def _sharded(sv, d):
    fleet = sv.fleet(2, wal_dir=str(d / "fleet"))
    server = sv.server(fleet, host=None)
    srv_sock, cli_sock = socket.socketpair()
    server.adopt(srv_sock)
    prod = sv.Producer(None, KEY, name="prod-a", sock=cli_sock, drive=lambda: server.poll(0.0))
    sids = {}
    i = 0
    while len(sids) < 2:
        sids.setdefault(sv.s.sharded.shard_of(f"s{i}", 2), f"s{i}")
        i += 1
    for sid in sids.values():
        prod.add_session(sv.metric(), session_id=sid)
        prod.submit(sid, *batch())
    prod.flush(5.0)
    server.tick()
    out = {}
    for shard_idx, sid in sids.items():
        shard = fleet._shards[shard_idx]
        assert sid in shard._sessions
        assert shard.serve_watermark("prod-a") >= 1
        out[sid] = (shard_idx, shard.serve_watermark("prod-a"), sv.state(shard, sid))
    assert fleet.serve_watermark("prod-a") == 4
    return out


def test_sharded_engine_routes_and_watermarks_per_shard(tmp_path):
    ref, port = on_both(_sharded, tmp_path)
    assert_same(ref, port)


# ------------------------------------------------------------------ lifecycle
def _loopback(sv, d):
    engine = sv.engine(wal_path=str(d / "serve.wal"))
    server = sv.server(engine, host="127.0.0.1")
    assert server.address is not None
    server.serve_in_thread(poll_interval_s=0.005, tick_every=2)
    try:
        prod = sv.Producer(server.address, KEY, name="prod-a")
        prod.add_session(sv.metric(), session_id="s0")
        prod.submit("s0", *batch())
        prod.flush(10.0)
        assert prod.outstanding == 0
        prod.close()
    finally:
        server.close()
    assert len(engine) == 1
    engine.tick()
    return sv.state(engine, "s0")


def test_loopback_listener_and_thread_loop(tmp_path):
    ref, port = on_both(_loopback, tmp_path)
    assert_same(ref, port)


# ------------------------------------------------------------------ the port's refusals
def test_a_jax_package_metric_blob_gets_an_err_ack_and_the_reactor_survives(tmp_path):
    """The port never imports the JAX package because a peer sent one of its metrics: the blob is refused
    before its classes load, the record is acked ``err`` with the reason, and the connection goes on."""
    from metrics_tpu.classification import MulticlassAccuracy as JaxAccuracy

    sv = serve_side("torch")
    with sv.s.fresh():
        engine, server, prod = sv.rig(tmp_path)
        pseq = prod._data("add", "alien", ("__metric__", pickle.dumps(JaxAccuracy(num_classes=4))))
        prod.flush(5.0)
        assert [e[0] for e in prod.errors] == [pseq]
        assert "ProtocolError" in prod.errors[0][3] and "metrics_tpu.classification" in prod.errors[0][3]
        assert len(engine) == 0 and server.protocol_errors == 0
        assert engine.serve_watermark("prod-a") == pseq  # resolved: a resend dedups
        prod.add_session(sv.metric(), session_id="s0")
        prod.submit("s0", *batch())
        prod.flush(5.0)
        server.tick()
        assert len(engine) == 1 and sv.applied(engine, "s0") == 1
        server.close()


def test_a_torch_global_frame_drops_only_its_connection(tmp_path):
    import torch

    sv = serve_side("torch")
    with sv.s.fresh():
        engine, server, prod = sv.rig(tmp_path)
        srv2, evil = socket.socketpair()
        server.adopt(srv2)
        body = pickle.dumps(("submit", 1, "s0", ((torch.arange(4),), {})), protocol=pickle.HIGHEST_PROTOCOL)
        import struct
        import zlib

        evil.sendall(sv.WAL_MAGIC + struct.pack(">II", len(body), zlib.crc32(body) & 0xFFFFFFFF) + body)
        server.poll(0.0)
        assert server.protocol_errors == 1 and server.disconnects == 1
        prod.add_session(sv.metric(), session_id="s0")
        prod.flush(5.0)
        assert len(engine) == 1
        server.close()


def test_arrivals_are_rebuilt_on_the_server_s_device_not_the_producer_s(tmp_path):
    """A producer's metric names its own device (here a card this host does not have); the server rebuilds it
    on the device it serves from."""
    import torch

    from metrics_tpu_torch.engine import durability

    sv = serve_side("torch")
    with sv.s.fresh():
        engine, server, prod = sv.rig(tmp_path)
        m = sv.metric()
        m.__dict__["device"] = torch.device("cuda", 3)  # only the name travels; the states are numpy
        prod._data("add", "s0", ("__metric__", durability.pack_metric(m)))
        prod.submit("s0", *batch())
        prod.flush(5.0)
        server.tick()
        assert prod.errors == []
        assert engine._sessions["s0"].metric.device == torch.device("cpu")
        assert sv.applied(engine, "s0") == 1
        server.close()


# ------------------------------------------------------------------ same fleet, either server
def _served_fleet(sv, d):
    """Two producers, sixteen sessions of two classes, three submit waves with churn."""
    engine, server, prod_a = sv.rig(d, name="prod-a")
    srv_b, cli_b = socket.socketpair()
    server.adopt(srv_b)
    prod_b = sv.Producer(None, KEY, name="prod-b", sock=cli_b, drive=lambda: server.poll(0.0))
    rng = np.random.default_rng(21)
    for i in range(8):
        prod_a.add_session(sv.metric(), session_id=f"a{i}")
        prod_b.add_session(sv.s.BinaryAUROC(thresholds=8, **sv.s.kw), session_id=f"b{i}")
    for wave in range(3):
        for i in range(8):
            if not (wave == 2 and i == 0):  # a0 expired in wave 1
                prod_a.submit(f"a{i}", rng.integers(0, 4, 8), rng.integers(0, 4, 8))
            prod_b.submit(f"b{i}", rng.random(8, dtype=np.float32), rng.integers(0, 2, 8))
        if wave == 1:
            prod_a.expire("a0")
            prod_b.reset("b1")
        prod_a.flush(5.0)
        prod_b.flush(5.0)
        server.tick()
    assert prod_a.errors == [] and prod_b.errors == []
    states = {sid: sv.state(engine, sid) for sid in sorted(engine.session_ids())}
    marks = engine.serve_watermarks()
    server.close()
    return states, marks


def test_the_same_producer_sequence_leaves_equal_states_and_watermarks(tmp_path):
    ref, port = on_both(_served_fleet, tmp_path)
    assert_same(ref, port)
    assert ref[1] == {"prod-a": 32, "prod-b": 33}  # 8 adds, 23 submits, 1 expire; 8 adds, 24 submits, 1 reset


def test_a_jax_ingest_wal_reads_the_port_server_s_journal(tmp_path):
    """The port server's journal is the JAX package's format: its reader gets the same (kind, seq, sid)."""
    from metrics_tpu.engine.durability import IngestWAL as JaxWAL

    sv = serve_side("torch")
    with sv.s.fresh():
        engine, server, prod = sv.rig(tmp_path)
        prod.add_session(sv.metric(), session_id="s0")
        prod.submit("s0", *batch(1))
        prod.expire("s0")
        prod.flush(5.0)
        server.close()
    path = str(tmp_path / "serve.wal")
    got, torn_j = JaxWAL.read_records_detailed(path)
    want, torn_t = sv.durability.IngestWAL.read_records_detailed(path)
    assert torn_j is None and torn_t is None
    assert [r[:3] for r in got] == [r[:3] for r in want] == [
        ("add", 1, "s0"), ("serve_mark", 2, "prod-a"), ("submit", 3, "s0"), ("serve_mark", 4, "prod-a"),
        ("expire", 5, "s0"), ("serve_mark", 6, "prod-a")]
    (args, kwargs) = got[2][3]
    assert all(isinstance(a, np.ndarray) for a in args) and kwargs == {}
    np.testing.assert_array_equal(args[0], batch(1)[0])


def test_run_serve_smoke_on_the_cpu_equals_the_jax_package_s():
    """The loopback smoke passes on the port and counts what the JAX package's counts; the device defaults to
    the card, so the CPU run names it."""
    import metrics_tpu.serve.smoke as jax_smoke

    from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE
    from metrics_tpu_torch.serve.smoke import run_serve_smoke

    _FLEET_JIT_CACHE.clear()
    port = run_serve_smoke(device="cpu")
    assert port["ok"], port["failures"]
    assert len(_FLEET_JIT_CACHE) == 0  # the smoke leaves the program cache as it found it
    ref = jax_smoke.run_serve_smoke()
    keep = ("sessions", "frames_total", "dedup_skipped", "protocol_errors", "shed_sessions", "acked",
            "wal_lag_records", "ok")
    assert {k: port[k] for k in keep} == {k: ref[k] for k in keep}


def test_run_serve_smoke_defaults_to_the_card():
    import torch

    from metrics_tpu_torch.serve.smoke import run_serve_smoke

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_serve_smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_side("torch").server_mod.MetricsServer(serve_side("torch").engine(), KEY, host=None)


def test_a_rebuilt_arrival_holds_its_configuration_tensors_on_the_target_device(tmp_path):
    """A curve packed on the CPU keeps its thresholds as a host tensor while unpickling; the server settles the
    whole metric on its device, as a metric built there holds it (``meta`` stands in for the card here)."""
    import torch

    from metrics_tpu_torch.engine.durability import pack_metric, unpack_metric

    sv = serve_side("torch")
    m = sv.s.BinaryAUROC(thresholds=16, device="cpu")
    server = sv.server_mod.MetricsServer(sv.engine(), KEY, host=None, device="meta")
    got = server._materialize_metric(("__metric__", pack_metric(m)), "s0")
    assert got.device == torch.device("meta") and got.thresholds.device.type == "meta"
    assert all(v.device.type == "meta" for v in got._state.values())
    assert unpack_metric(pack_metric(m), device="meta").thresholds.device.type == "meta"
    assert unpack_metric(pack_metric(m)).thresholds.device.type == "cpu"  # no device named: where it was
    server.close()
