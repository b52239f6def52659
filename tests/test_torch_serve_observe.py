"""The port's serve telemetry held against the JAX package's (``tests/test_serve_observe.py``).

Snapshot schema v4, the Prometheus export of the ``metrics_tpu_serve_*``
families, and the ``fleet_top`` ``== serve ==`` report section, all driven by
the same front-door traffic over a socketpair on both packages. ``fleet_top``
reads the port's snapshot as it reads the JAX package's; the report's module
imports no JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import socket

import numpy as np

from test_torch_serve_cases import KEY, on_both, serve_side


def _traffic(sv, d):
    """One connected producer, a few applied records, one reject, one dup, one protocol error, one autonomic
    double: every serve family nonzero."""
    engine = sv.engine(initial_capacity=4, wal_path=str(d / "serve.wal"))
    auto = sv.AutonomicController(engine, min_interval_s={"double": 0.0})
    server = sv.server(engine, host=None, autonomic=auto)
    srv_sock, cli_sock = socket.socketpair()
    server.adopt(srv_sock)
    prod = sv.Producer(None, KEY, name="prod-a", sock=cli_sock, drive=lambda: server.poll(0.0))
    rng = np.random.default_rng(3)
    for i in range(4):
        prod.add_session(sv.metric(), session_id=f"s{i}")
        prod.submit(f"s{i}", rng.integers(0, 4, 8), rng.integers(0, 4, 8))
    prod.flush(5.0)
    server.tick()
    prod._send_raw(sv.encode_frame("add", 1, "s0", sv.metric()))
    server.poll(0.0)
    server.admission = sv.AdmissionController((
        sv.AdmissionRule("closed", "occupancy_pct", ">=", 0.0, "reject"),
    ))
    prod.add_session(sv.metric(), session_id="late")
    try:
        prod.flush(5.0)
    finally:
        server.admission = sv.AdmissionController()
    bad_srv, bad_cli = socket.socketpair()
    server.adopt(bad_srv)
    bad_cli.sendall(sv.WAL_MAGIC + sv.encode_frame("submit", 1, "s0", ((), {})))
    server.poll(0.0)
    bad_cli.close()
    server.poll(0.0)
    return engine, server, prod


_SERVE_KEYS = ("serve_producers_connected", "serve_frames_total", "serve_bytes_in_total", "serve_admitted_total",
               "serve_rejected_total", "serve_dedup_skipped_total", "serve_protocol_errors_total",
               "serve_deferred_total", "serve_shed_total", "autonomic_actions_total")


def _snapshot_case(sv, d):
    engine, server, prod = _traffic(sv, d)
    try:
        snap = sv.observe.snapshot()
        assert snap["schema_version"] == sv.observe.SCHEMA_VERSION == 4
        dv = snap["derived"]
        assert dv["serve_producers_connected"] == 1
        assert dv["serve_frames_total"] >= 10
        assert dv["serve_bytes_in_total"] > 0
        assert dv["serve_admitted_total"] == 8
        assert dv["serve_rejected_total"] == 1
        assert dv["serve_dedup_skipped_total"] == 1
        assert dv["serve_protocol_errors_total"] == 1
        assert dv["serve_deferred_total"] == 0 and dv["serve_shed_total"] == 0
        assert dv["autonomic_actions_total"] >= 1
        json.dumps(snap)
        # bytes differ where the add records carry each package's own metric blob
        return {k: dv[k] for k in _SERVE_KEYS if k != "serve_bytes_in_total"}
    finally:
        server.close()


def test_snapshot_schema_v4_carries_populated_serve_keys(tmp_path):
    ref, port = on_both(_snapshot_case, tmp_path)
    assert ref == port


def _prometheus_case(sv, d):
    engine, server, prod = _traffic(sv, d)
    try:
        snap = sv.observe.snapshot()
        text = sv.observe.prometheus()
    finally:
        server.close()
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_part, value = line.rsplit(" ", 1)
        samples[name_part] = float(value)

    def family_total(prefix):
        return sum(v for k, v in samples.items() if k.startswith(prefix))

    dv = snap["derived"]
    assert family_total("metrics_tpu_serve_frames_total") == dv["serve_frames_total"]
    assert family_total("metrics_tpu_serve_bytes_in_total") == dv["serve_bytes_in_total"]
    assert samples['metrics_tpu_serve_admission_total{metric="accept"}'] == dv["serve_admitted_total"]
    assert samples['metrics_tpu_serve_admission_total{metric="reject"}'] == dv["serve_rejected_total"]
    assert family_total("metrics_tpu_serve_dedup_skipped_total") == 1
    assert family_total("metrics_tpu_serve_protocol_errors_total") == 1
    assert family_total("metrics_tpu_autonomic_actions_total") >= 1
    assert samples['metrics_tpu_serve_producers{metric="serve"}'] == 1
    return {k: v for k, v in samples.items()
            if (k.startswith("metrics_tpu_serve_") or k.startswith("metrics_tpu_autonomic_"))
            and not k.startswith("metrics_tpu_serve_bytes_in")}


def test_prometheus_round_trips_the_serve_families(tmp_path):
    ref, port = on_both(_prometheus_case, tmp_path)
    assert ref == port


def _load_fleet_top():
    path = os.path.join(os.path.dirname(__file__), "..", "tools", "fleet_top.py")
    spec = importlib.util.spec_from_file_location("fleet_top_port_view", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fleet_top_case(sv, d, fleet_top, capsys):
    engine, server, prod = _traffic(sv, d)
    try:
        snap = sv.observe.snapshot()
    finally:
        server.close()
    report = fleet_top.build_report(snap)
    sr = report["serve"]
    assert sr["producers"] == 1
    assert sr["frames"] == snap["derived"]["serve_frames_total"]
    assert sr["admission"] == {"accept": 8, "defer": 0, "shed": 0, "reject": 1}
    assert sr["dedup_skipped"] == 1 and sr["protocol_errors"] == 1
    assert sr["autonomic"].get("double", 0) >= 1
    rendered = fleet_top.render_report(snap)
    assert "== serve ==" in rendered
    assert "producer(s) connected" in rendered
    assert "accept=8" in rendered and "reject=1" in rendered
    assert "autonomic" in rendered
    p = d / "snap.json"
    p.write_text(json.dumps(snap))
    assert fleet_top.main(["--json", str(p)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["serve"] == json.loads(json.dumps(sr))
    return {k: v for k, v in sr.items() if k not in ("bytes_in", "bytes")}


def test_fleet_top_serve_section_renders_the_port_s_snapshot(tmp_path, capsys):
    fleet_top = _load_fleet_top()
    ref, port = on_both(_fleet_top_case, tmp_path, fleet_top, capsys)
    assert ref == port


def test_serve_section_absent_without_traffic(tmp_path):
    fleet_top = _load_fleet_top()
    sv = serve_side("torch")
    with sv.s.fresh():
        engine = sv.engine(initial_capacity=4)
        engine.add_session(sv.metric(), session_id="s0")
        engine.tick()
        snap = sv.observe.snapshot()
    report = fleet_top.build_report(snap)
    assert report["serve"] is None
    assert "== serve ==" not in fleet_top.render_report(snap)


def test_fleet_top_renders_a_port_snapshot_without_importing_jax(tmp_path):
    """A fresh interpreter renders the port's served snapshot through ``fleet_top --json`` and never loads
    JAX or the JAX package."""
    import subprocess
    import sys

    sv = serve_side("torch")
    with sv.s.fresh():
        engine, server, prod = _traffic(sv, tmp_path)
        snap = sv.observe.snapshot()
        server.close()
    p = tmp_path / "port-snap.json"
    p.write_text(json.dumps(snap))
    tool = os.path.join(os.path.dirname(__file__), "..", "tools", "fleet_top.py")
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('fleet_top', {tool!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        f"assert mod.main(['--json', {str(p)!r}]) == 0\n"
        "assert not any(m.split('.')[0] in ('jax', 'metrics_tpu') for m in sys.modules), 'jax loaded'\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["serve"]["admission"] == {"accept": 8, "defer": 0, "shed": 0, "reject": 1}
