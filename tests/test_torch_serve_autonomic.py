"""The port's observe-to-act reflexes held against the JAX package's, case by case (``tests/test_serve_autonomic.py``).

Each rung is tripped in isolation with the clock pinned (``step(now=...)``):
double on occupancy pressure, demote through the meter's pending-demotion
handshake (and the ghost confirmation that keeps its queue from wedging),
resize on shard population skew, and shed loose-first on overload. A
``dry_run`` controller decides, logs and counts, and mutates nothing. Each
scenario runs on both packages; the actions, counts and surviving sessions
must agree.
"""

from __future__ import annotations

from test_torch_serve_cases import on_both


def _full_engine(sv, n=4, capacity=4, loose=0):
    engine = sv.engine(initial_capacity=capacity)
    for i in range(n):
        engine.add_session(sv.metric(), session_id=f"s{i}")
    for i in range(loose):
        engine._demote_session(engine._sessions[f"s{i}"])
    for i in range(loose):
        engine.add_session(sv.metric(), session_id=f"r{i}")
    return engine


def _acts(actions):
    return [(a.action, a.reason, a.dry_run, a.executed) for a in actions]


# ------------------------------------------------------------------- double
def _double(sv, d):
    engine = _full_engine(sv, n=4, capacity=4)
    auto = sv.AutonomicController(engine, occupancy_high_pct=85.0)
    capacity_before = engine.stats()["rows_capacity"]
    actions = auto.step(now=0.0)
    assert [a.action for a in actions] == ["double"]
    assert actions[0].executed and not actions[0].dry_run
    assert engine.stats()["rows_capacity"] > capacity_before
    assert auto.counts["double"] == 1
    grown = engine.stats()["rows_capacity"]
    for i in range(4, int(grown * 0.9)):
        engine.add_session(sv.metric(), session_id=f"s{i}")
    assert auto.step(now=1.0) == []
    again = auto.step(now=2.5)
    assert [a.action for a in again] == ["double"]
    assert auto.counts["double"] == 2
    return _acts(actions) + _acts(again), engine.stats()["rows_capacity"], dict(auto.counts)


def test_double_fires_on_occupancy_and_respects_its_rate_limit(tmp_path):
    ref, port = on_both(_double, tmp_path)
    assert ref == port


def _quiet(sv, d):
    engine = _full_engine(sv, n=1, capacity=8)
    auto = sv.AutonomicController(engine)
    assert auto.step(now=0.0) == []
    assert auto.counts == {a: 0 for a in sv.autonomic.AUTONOMIC_ACTIONS}
    return dict(auto.counts)


def test_double_stays_quiet_below_the_threshold(tmp_path):
    ref, port = on_both(_quiet, tmp_path)
    assert ref == port


# ------------------------------------------------------------------- demote
def _demote(sv, d):
    engine = _full_engine(sv, n=2, capacity=8)
    mt = sv.observe.install_meter(top_k=8, policy=sv.metering.MeterPolicy(action="demote"))
    try:
        with mt._lock:
            mt._pending_demote.add("s1")
            mt._demoted.add("s1")
        auto = sv.AutonomicController(engine)
        actions = auto.step(now=0.0)
        assert [a.action for a in actions] == ["demote"]
        assert actions[0].detail["sessions"] == ["s1"]
        assert mt.pending_demotions() == []
        assert "s1" in [str(s) for s in engine.loose_session_ids()]
        assert "s0" not in [str(s) for s in engine.loose_session_ids()]
        return _acts(actions), actions[0].detail, [str(s) for s in engine.loose_session_ids()]
    finally:
        sv.observe.uninstall_meter()


def test_demote_drives_the_meter_handshake(tmp_path):
    ref, port = on_both(_demote, tmp_path)
    assert ref == port


def _ghost(sv, d):
    engine = _full_engine(sv, n=1, capacity=8)
    mt = sv.observe.install_meter(top_k=8, policy=sv.metering.MeterPolicy(action="demote"))
    try:
        with mt._lock:
            mt._pending_demote.add("long-gone")
            mt._demoted.add("long-gone")
        auto = sv.AutonomicController(engine)
        actions = auto.step(now=0.0)
        assert actions == []
        assert mt.pending_demotions() == []
        return _acts(actions), mt.pending_demotions()
    finally:
        sv.observe.uninstall_meter()


def test_demote_confirms_ghosts_so_the_queue_cannot_wedge(tmp_path):
    ref, port = on_both(_ghost, tmp_path)
    assert ref == port


# ------------------------------------------------------------------- resize
def _skewed_fleet(sv):
    fleet = sv.fleet(2)
    added = 0
    i = 0
    while added < 5:
        sid = f"s{i}"
        i += 1
        if sv.s.sharded.shard_of(sid, 2) == 0:
            fleet.add_session(sv.metric(), session_id=sid)
            added += 1
    return fleet


def _resize(sv, d):
    fleet = _skewed_fleet(sv)
    auto = sv.AutonomicController(fleet, imbalance_ratio=4.0)
    actions = auto.step(now=0.0)
    assert [a.action for a in actions] == ["resize"]
    assert actions[0].detail["to_shards"] == 3
    assert fleet.stats()["n_shards"] == 3
    assert len(fleet) == 5
    return _acts(actions), actions[0].detail, sorted(fleet.session_ids())


def test_resize_fires_on_shard_imbalance(tmp_path):
    ref, port = on_both(_resize, tmp_path)
    assert ref == port


def _capped(sv, d):
    fleet = _skewed_fleet(sv)
    auto = sv.AutonomicController(fleet, imbalance_ratio=4.0, max_shards=2)
    assert auto.step(now=0.0) == []
    assert fleet.stats()["n_shards"] == 2
    return fleet.stats()["n_shards"]


def test_resize_is_capped_by_max_shards(tmp_path):
    ref, port = on_both(_capped, tmp_path)
    assert ref == port


# --------------------------------------------------------------------- shed
def _shed_bounded(sv, d):
    engine = _full_engine(sv, n=4, capacity=4, loose=3)
    auto = sv.AutonomicController(engine, max_shed_per_step=2)
    actions = auto.step(now=0.0)
    shed_acts = [a for a in actions if a.action == "shed"]
    assert len(shed_acts) == 1
    assert len(shed_acts[0].detail["sessions"]) == 2
    assert "s3" in engine._sessions
    assert len(engine.loose_session_ids()) == 1
    return _acts(actions), shed_acts[0].detail, sorted(engine._sessions)


def test_shed_takes_loose_sessions_first_and_is_bounded(tmp_path):
    ref, port = on_both(_shed_bounded, tmp_path)
    assert ref == port


def _on_demand(sv, d):
    engine = _full_engine(sv, n=3, capacity=8, loose=2)
    auto = sv.AutonomicController(engine)
    first = auto.shed(1, reason="admission")
    assert len(first) == 1
    assert auto.shed(1, reason="admission") == []
    assert auto.counts["shed"] == 1
    return first, dict(auto.counts)


def test_on_demand_shed_is_rate_limited(tmp_path):
    ref, port = on_both(_on_demand, tmp_path)
    assert ref == port


def _helper(sv, d):
    engine = _full_engine(sv, n=3, capacity=8, loose=1)
    assert sv.autonomic.shed_loose(engine, n=5) == ["s0"]
    assert set(engine._sessions) == {"s1", "s2", "r0"}
    return sorted(engine._sessions)


def test_shed_loose_helper_never_touches_bucketed_sessions(tmp_path):
    ref, port = on_both(_helper, tmp_path)
    assert ref == port


# ------------------------------------------------------------------ dry run
def _dry(sv, d):
    engine = _full_engine(sv, n=4, capacity=4, loose=2)
    mt = sv.observe.install_meter(top_k=8, policy=sv.metering.MeterPolicy(action="demote"))
    try:
        with mt._lock:
            mt._pending_demote.add("s3")
            mt._demoted.add("s3")
        auto = sv.AutonomicController(engine, dry_run=True)
        actions = auto.step(now=0.0)
        assert {a.action for a in actions} == {"double", "demote", "shed"}
        assert all(a.dry_run and not a.executed for a in actions)
        assert auto.counts["double"] == auto.counts["shed"] == 1
        assert len(auto.history) == 3
        assert engine.stats()["rows_capacity"] == 4
        assert set(engine._sessions) == {"s0", "s1", "s2", "s3", "r0", "r1"}
        assert mt.pending_demotions() == ["s3"]
        assert auto.shed(5) == []
        assert set(engine._sessions) == {"s0", "s1", "s2", "s3", "r0", "r1"}
        return _acts(actions), [a.detail for a in actions], dict(auto.counts)
    finally:
        sv.observe.uninstall_meter()


def test_dry_run_decides_and_counts_but_never_mutates(tmp_path):
    ref, port = on_both(_dry, tmp_path)
    assert ref == port


# ------------------------------------------------------------- bookkeeping
def _bookkeeping(sv, d):
    engine = _full_engine(sv, n=1, capacity=8)
    auto = sv.AutonomicController(engine)
    assert auto.counts == {a: 0 for a in sv.autonomic.AUTONOMIC_ACTIONS}
    assert list(auto.history) == []
    engine2 = _full_engine(sv, n=4, capacity=4)
    auto2 = sv.AutonomicController(engine2)
    (act,) = auto2.step(now=0.0)
    assert act == auto2.history[-1]
    assert act.action == "double" and act.reason in ("occupancy", "occupancy_psi")
    snap = sv.observe.snapshot()
    assert snap["derived"]["autonomic_actions_total"] >= 1
    events = [e for e in snap["events"] if e["kind"] == "autonomic_action"]
    # bucket labels carry a digest of each package's own config key: compare how many buckets grew
    return _acts([act]), snap["derived"]["autonomic_actions_total"], [
        {k: (len(v) if k == "buckets" else v) for k, v in e.items() if k not in ("t", "time", "ts")}
        for e in events]


def test_counts_are_preseeded_and_history_is_structured(tmp_path):
    ref, port = on_both(_bookkeeping, tmp_path)
    assert ref == port
