"""Crash recovery through the port's front door, held against the JAX package's (``tests/test_serve_recovery.py``).

The contract: **no record the server ever acked may be lost by a crash**, because
the ack goes out only after the record and its ``serve_mark`` are fsynced into
the shard journal. Each rig runs on both packages with the same numpy batches:
an in-process crash over a socketpair, a paranoid full resend, a fresh producer
resuming past the watermark, and a real ``kill -9`` of a child server process
(a fresh interpreter; the port's child imports no JAX) mid-stream over TCP,
restarted from the surviving journal. The recovered states are bit-exact
against an oracle engine fed each unique record once, and equal across the
two packages.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from _torch_engine_sides import assert_same
from test_torch_serve_cases import KEY, batch, on_both


def _wal_only_restart(sv, wal_path):
    """Fresh engine, replay the journal, then attach it for appends: no checkpoint needed."""
    eng = sv.engine()
    sv.durability.replay_wal(eng, wal_path)
    eng._wal = sv.durability.IngestWAL(wal_path)
    eng._wal_path = str(wal_path)
    return eng


def _oracle(sv, batches):
    """A never-crashed engine fed every unique record exactly once."""
    eng = sv.engine()
    eng.add_session(sv.metric(), session_id="s0")
    for b in batches:
        eng.submit("s0", *b)
    eng.tick()
    return sv.s.oracle_state(eng.expire("s0"))


def _final(sv, engine):
    return sv.s.oracle_state(engine.expire("s0"))


# -------------------------------------------------------- in-process crash sim
def _crash_sim(sv, d):
    wal = d / "serve.wal"
    engine, server, prod = sv.rig(d)
    batches = [batch(i) for i in range(4)]
    prod.add_session(sv.metric(), session_id="s0")
    for b in batches[:2]:
        prod.submit("s0", *b)
    prod.flush(5.0)
    acked_before_crash = prod.acked
    assert acked_before_crash == 3
    lost = [prod.submit("s0", *b) for b in batches[2:]]
    assert prod.outstanding == 2
    prod._drive = None
    server.close()
    del engine

    recovered = _wal_only_restart(sv, wal)
    assert recovered.serve_watermark("prod-a") == acked_before_crash
    server2 = sv.server(recovered, host=None)
    srv2, cli2 = socket.socketpair()
    server2.adopt(srv2)
    prod._drive = lambda: server2.poll(0.0)
    prod.reconnect(cli2)
    assert prod.server_watermark == acked_before_crash
    prod.flush(5.0)
    server2.tick()
    assert prod.outstanding == 0
    assert prod.errors == []
    assert recovered.serve_watermark("prod-a") == max(lost)
    got = _final(sv, recovered)
    assert_same(_oracle(sv, batches), got)
    server2.close()
    return got, server2.dedup_skipped


def test_crash_sim_replays_wal_and_reconciles_watermarks(tmp_path):
    ref, port = on_both(_crash_sim, tmp_path)
    assert_same(ref, port)


def _resend_all(sv, d):
    wal = d / "serve.wal"
    engine, server, prod = sv.rig(d)
    batches = [batch(i) for i in range(3)]
    prod.add_session(sv.metric(), session_id="s0")
    for b in batches:
        prod.submit("s0", *b)
    prod.flush(5.0)
    server.close()

    recovered = _wal_only_restart(sv, wal)
    server2 = sv.server(recovered, host=None)
    srv2, cli2 = socket.socketpair()
    server2.adopt(srv2)
    prod2 = sv.Producer(None, KEY, name="prod-a", sock=cli2, drive=lambda: server2.poll(0.0))
    prod2.add_session(sv.metric(), session_id="s0")
    for b in batches:
        prod2.submit("s0", *b)
    prod2.flush(5.0)
    server2.tick()
    assert server2.dedup_skipped == 4
    got = _final(sv, recovered)
    assert_same(_oracle(sv, batches), got)
    server2.close()
    return got, server2.dedup_skipped


def test_resending_every_acked_record_dedups_after_restart(tmp_path):
    ref, port = on_both(_resend_all, tmp_path)
    assert_same(ref, port)


def _fresh_producer(sv, d):
    wal = d / "serve.wal"
    engine, server, prod = sv.rig(d)
    prod.add_session(sv.metric(), session_id="s0")
    prod.submit("s0", *batch(0))
    prod.flush(5.0)
    server.close()

    recovered = _wal_only_restart(sv, wal)
    server2 = sv.server(recovered, host=None)
    srv2, cli2 = socket.socketpair()
    server2.adopt(srv2)
    prod2 = sv.Producer(None, KEY, name="prod-a", sock=cli2, drive=lambda: server2.poll(0.0))
    assert prod2.resume_from_watermark() == 2
    prod2.submit("s0", *batch(1))
    prod2.flush(5.0)
    server2.tick()
    assert server2.dedup_skipped == 0
    assert recovered.serve_watermark("prod-a") == 3
    got = _final(sv, recovered)
    assert_same(_oracle(sv, [batch(0), batch(1)]), got)
    live = {"on": True}
    s_srv, s_cli = socket.socketpair()
    server2.adopt(s_srv)
    p = sv.Producer(None, KEY, name="prod-b", sock=s_cli,
                    drive=lambda: server2.poll(0.0) if live["on"] else None)
    live["on"] = False
    p.submit("s0", *batch(2))
    with pytest.raises(Exception, match="unacked"):
        p.resume_from_watermark()
    server2.close()
    return got


def test_fresh_producer_with_new_data_resumes_past_the_watermark(tmp_path):
    ref, port = on_both(_fresh_producer, tmp_path)
    assert_same(ref, port)


# ------------------------------------------------------------- real kill -9
_CHILD = {
    "jax": """
import sys
from metrics_tpu.classification import MulticlassAccuracy  # preload for unpickling
from metrics_tpu.engine.stream import StreamEngine
from metrics_tpu.serve.server import MetricsServer

engine = StreamEngine(wal_path=sys.argv[1])
server = MetricsServer(engine, {key!r}, host="127.0.0.1")
print(server.address[1], flush=True)
n = 0
while True:
    server.poll(0.05)
    n += 1
    if n % 8 == 0:
        engine.tick()
""",
    "torch": """
import sys
from metrics_tpu_torch.engine.stream import StreamEngine
from metrics_tpu_torch.serve.server import MetricsServer

assert "jax" not in sys.modules and "metrics_tpu" not in sys.modules
engine = StreamEngine(wal_path=sys.argv[1])
server = MetricsServer(engine, {key!r}, host="127.0.0.1", device="cpu")
print(server.address[1], flush=True)
n = 0
while True:
    server.poll(0.05)
    n += 1
    if n % 8 == 0:
        engine.tick()
    assert "jax" not in sys.modules and "metrics_tpu" not in sys.modules
""",
}


def _kill_nine(sv, d):
    wal = d / "serve.wal"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD[sv.name].format(key=KEY), str(wal)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env, text=True, cwd=str(d),
    )
    try:
        port = int(child.stdout.readline())
        prod = sv.Producer(("127.0.0.1", port), KEY, name="prod-a")
        batches = [batch(i) for i in range(6)]
        prod.add_session(sv.metric(), session_id="s0")
        for b in batches[:3]:
            prod.submit("s0", *b)
        prod.flush(30.0)
        acked_before_kill = prod.acked

        wave2 = [prod.submit("s0", *b) for b in batches[3:]]
        deadline = time.monotonic() + 30.0
        while prod.acked < acked_before_kill + 1:
            prod.pump()
            assert time.monotonic() < deadline, "no wave-2 ack before deadline"
            time.sleep(0.005)
        acked_at_kill = prod.acked
        os.kill(child.pid, signal.SIGKILL)
        child.wait(30.0)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(30.0)
    assert child.returncode == -signal.SIGKILL

    recovered = _wal_only_restart(sv, wal)
    assert recovered.serve_watermark("prod-a") >= acked_at_kill
    server2 = sv.server(recovered, host="127.0.0.1")
    try:
        sock = socket.create_connection(server2.address)
        prod._drive = lambda: server2.poll(0.0)
        prod.reconnect(sock)
        assert prod.server_watermark >= acked_at_kill
        prod.flush(30.0)
        server2.tick()
        assert prod.outstanding == 0
        assert prod.errors == []
        assert recovered.serve_watermark("prod-a") == max(wave2)
        got = _final(sv, recovered)
        assert_same(_oracle(sv, batches), got)
        prod.close()
    finally:
        server2.close()
    return got


def test_kill_dash_nine_mid_stream_loses_no_acked_record(tmp_path):
    ref, port = on_both(_kill_nine, tmp_path)
    assert_same(ref, port)
