"""Chaos contract harness: inject faults, assert the runtime's recovery promises (counterpart of
``metrics_tpu/analysis/chaos_contracts.py``).

For every jit-eligible class of the profile registry (the transfer contract's slice of
``observe.costs.PROFILE_CASES``), on the metrics' device:

- **update faults**: exceptions raised before, mid-way through (after a state mutation) and after the
  update body: the update must be transactional (states, ``_update_count`` and the compute cache roll back
  bit-exactly) and the next clean update must land;
- **poisoned inputs**: a NaN batch under ``install_guard``: ``skip_batch`` quarantines it and
  ``raise_on_host`` raises :class:`~metrics_tpu_torch.resilience.guards.PoisonedInputError`, then keeps
  working;
- **corrupt checkpoints**: truncated and bit-flipped files are refused with the target untouched, an intact
  one round-trips bit-exactly;
- **dropped sync peer**: a sync that loses a peer after a transient retry degrades to the count-weighted
  merge of the survivors, records ``sync_retry``/``sync_degraded``, and restores the local state on unsync.

The JAX package's ``exc_trace`` (the trace/compile stage dies) and ``dispatch_death[probation|steady]``
(the compiled executable dies) have no target in an eager update: they are reported in
``ChaosResult.skipped`` with that reason.

Three more suites: the fleet runtime's durability (:func:`check_fleet_chaos_case`: kill mid-tick,
mid-flush and mid-checkpoint, a torn or bit-flipped journal, a poison row in a full bucket, a dead fused
dispatch replayed row by row, each recovery bit-exact by ``Metric.state_fingerprint``), the sharded fleet
(:func:`check_shard_chaos_case`: host kill, lost shard files, a torn manifest, an elastic resize) and the
front door (:func:`check_serve_chaos_case`: a producer dead mid-frame, a frame torn at a read boundary, a
replayed ``pseq``, an autonomic demotion racing an expiry). Violations are baselined by class in the
``chaos``, ``fleet``, ``shard`` and ``serve`` sections of
``metrics_tpu_torch/analysis/baselines/chaos_baseline.json`` (expected empty).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.analysis.fleet_contracts import _compare, _host

__all__ = [
    "ChaosResult",
    "chaos_cases",
    "check_chaos_case",
    "check_fleet_chaos_case",
    "check_serve_chaos_case",
    "check_shard_chaos_case",
    "diff_chaos_baseline",
    "main",
    "run_chaos_check",
]

Device = Union[str, torch.device]
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baselines", "chaos_baseline.json")

# the JAX package's faults that an eager update has no target for, and why
SKIPPED_FAULTS = {
    "exc_trace": "no trace or compile stage: every port update runs eagerly",
    "dispatch_death": "no compiled executable to kill: every port update runs eagerly",
}


@dataclasses.dataclass(frozen=True)
class ChaosResult:
    name: str
    ran: Tuple[str, ...]  # fault names exercised
    skipped: Tuple[str, ...]  # faults not applicable, "name: reason" where the reason is not obvious
    violations: Tuple[str, ...]  # "fault: what broke" — empty means contract held

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self) -> str:
        mark = "ok " if self.ok else "VIOLATED"
        head = f"{mark} {self.name}: {len(self.ran)} fault(s)"
        if self.skipped:
            head += f", skipped {','.join(self.skipped)}"
        for v in self.violations:
            head += f"\n    {v}"
        return head


def chaos_cases() -> List[Any]:
    """The jit-eligible slice of the profile registry (the transfer contract's)."""
    from metrics_tpu_torch.analysis.transfer_contracts import transfer_cases

    return transfer_cases()


# ------------------------------------------------------------------- helpers
def _host_state(m: Any) -> Dict[str, Any]:
    """Host copy of the live state, read through ``__dict__``."""
    return {k: _host(v) for k, v in m.__dict__["_state"].items()}


def _state_diff(before: Dict[str, Any], after: Dict[str, Any]) -> str:
    """'' when bit-identical (NaN == NaN), else a description of the first drift."""
    if set(before) != set(after):
        return f"state keys changed {sorted(before)} -> {sorted(after)}"
    for k in sorted(before):
        x, y = before[k], after[k]
        if x.shape != y.shape or not np.array_equal(x, y, equal_nan=x.dtype.kind in "fc"):
            return f"state {k!r} changed"
    return ""


def _trees_close(a: Any, b: Any) -> bool:
    from torch.utils._pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x, y = _host(x), _host(y)
        if x.shape != y.shape or not np.allclose(x, y, rtol=1e-5, atol=1e-6, equal_nan=True):
            return False
    return True


def _poison_batch(batch: Tuple[Any, ...]) -> Tuple[Optional[Tuple[Any, ...]], bool]:
    """NaN-inject the first float tensor argument; (None, False) when there is none."""
    out = list(batch)
    for i, a in enumerate(out):
        if isinstance(a, torch.Tensor) and a.is_floating_point() and a.numel():
            poisoned = a.clone()
            poisoned.view(-1)[0] = float("nan")
            out[i] = poisoned
            return tuple(out), True
    return None, False


class _InjectedFault(RuntimeError):
    """The fault the harness injects: anything else escaping is a real bug."""


def _rng_for(case: Any) -> Any:
    from metrics_tpu_torch.observe.costs import _rng

    return _rng(case)


def _batch(case: Any, rng: Any, device: Device) -> Tuple[Any, ...]:
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in case.batch(rng))


def _check_rollback(m: Any, fault: str, batch: Tuple[Any, ...], before: Dict[str, Any], count: int) -> List[str]:
    """Run one (pre-sabotaged) faulty update; assert propagation and a bit-exact rollback."""
    bad: List[str] = []
    raised = False
    try:
        m.update(*batch)
    except _InjectedFault:
        raised = True
    if not raised:
        bad.append(f"{fault}: injected exception was swallowed")
    drift = _state_diff(before, _host_state(m))
    if drift:
        bad.append(f"{fault}: rollback incomplete — {drift}")
    if m._update_count != count:
        bad.append(f"{fault}: _update_count {count} -> {m._update_count} after failed update")
    return bad


def _fault_update_exceptions(case: Any, device: Device) -> Tuple[List[str], List[str]]:
    """pre/mid/post exception injection into the update body."""
    bad: List[str] = []
    m = case.ctor(device)
    batch = _batch(case, _rng_for(case), device)
    m.update(*batch)  # real (non-default) state first
    before, count = _host_state(m), m._update_count
    real = m._update_impl

    def pre(*a: Any, **k: Any) -> None:
        raise _InjectedFault("pre-update fault")

    def mid(*a: Any, **k: Any) -> None:
        state = m.__dict__["_state"]
        for key, v in state.items():  # corrupt one state, then die mid-update
            if isinstance(v, torch.Tensor):
                state[key] = torch.zeros_like(v)
                break
        raise _InjectedFault("mid-update fault")

    def post(*a: Any, **k: Any) -> None:
        real(*a, **k)  # the body fully ran; the failure is after it
        raise _InjectedFault("post-update fault")

    for depth, impl in (("pre", pre), ("mid", mid), ("post", post)):
        m.__dict__["_update_impl"] = impl
        try:
            bad.extend(_check_rollback(m, f"exc_eager[{depth}]", batch, before, count))
        finally:
            m.__dict__["_update_impl"] = real
    m.update(*batch)  # recovery: the next clean update must land
    if m._update_count != count + 1:
        bad.append("exc_eager: clean update after faults did not advance the count")
    return bad, [f"exc_eager[{d}]" for d in ("pre", "mid", "post")]


def _fault_nan_guard(case: Any, device: Device) -> Tuple[List[str], bool]:
    """skip_batch quarantine and raise_on_host, against an unguarded control."""
    from metrics_tpu_torch.resilience.guards import GUARD_STATE, PoisonedInputError, install_guard, poisoned_count
    from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError

    rng = _rng_for(case)
    clean = [_batch(case, rng, device) for _ in range(2)]
    poisoned, ok = _poison_batch(_batch(case, rng, device))
    if not ok:
        return [], False  # nothing float-typed to poison
    bad: List[str] = []
    try:
        guarded = install_guard(case.ctor(device), policy="skip_batch")
    except TPUMetricsUserError:
        return [], False  # growable states: the guard refuses them
    control = case.ctor(device)
    for b in clean:
        control.update(*b)
    guarded.update(*clean[0])
    guarded.update(*poisoned)  # must be quarantined wholesale
    guarded.update(*clean[1])
    if poisoned_count(guarded) != 1:
        bad.append(f"nan_guard[skip]: poisoned_count={poisoned_count(guarded)}, expected 1")
    g_state = {k: v for k, v in _host_state(guarded).items() if k != GUARD_STATE}
    drift = _state_diff(_host_state(control), g_state)
    if drift:
        bad.append(f"nan_guard[skip]: quarantine leaked into payload state — {drift}")
    if not _trees_close(guarded.compute(), control.compute()):
        bad.append("nan_guard[skip]: compute drifted from the never-poisoned control")

    loud = install_guard(case.ctor(device), policy="raise_on_host")
    loud.update(*clean[0])
    try:
        loud.update(*poisoned)
        bad.append("nan_guard[raise]: poisoned batch did not raise PoisonedInputError")
    except PoisonedInputError:
        pass
    loud.update(*clean[1])  # documented contract: catching and continuing is safe
    if poisoned_count(loud) != 1:
        bad.append(f"nan_guard[raise]: poisoned_count={poisoned_count(loud)}, expected 1")
    return bad, True


def _fault_checkpoint(case: Any, device: Device) -> List[str]:
    """Round trip, truncation and bit-flip against the atomic snapshot format."""
    import tempfile

    from metrics_tpu_torch.resilience.checkpoint import CorruptCheckpointError, restore_checkpoint, save_checkpoint

    bad: List[str] = []
    rng = _rng_for(case)
    batches = [_batch(case, rng, device) for _ in range(2)]
    m = case.ctor(device)
    for b in batches:
        m.update(*b)
    with tempfile.TemporaryDirectory(prefix="chaos_ckpt_") as tmp:
        path = os.path.join(tmp, "m.ckpt")
        save_checkpoint(m, path)
        with open(path, "rb") as fh:
            blob = fh.read()
        fresh = case.ctor(device)
        restore_checkpoint(fresh, path)
        drift = _state_diff(_host_state(m), _host_state(fresh))
        if drift:
            bad.append(f"ckpt[roundtrip]: restored state not bit-exact — {drift}")
        if fresh._update_count != m._update_count:
            bad.append("ckpt[roundtrip]: update_count not restored")
        for fault, mutated in (
            ("truncate", blob[: len(blob) - 7]),
            ("bitflip", blob[:-1] + bytes([blob[-1] ^ 0xFF])),
        ):
            broken = os.path.join(tmp, f"{fault}.ckpt")
            with open(broken, "wb") as fh:
                fh.write(mutated)
            target = case.ctor(device)
            target.update(*batches[0])
            before = _host_state(target)
            try:
                restore_checkpoint(target, broken)
                bad.append(f"ckpt[{fault}]: corrupt checkpoint was accepted")
            except CorruptCheckpointError:
                pass
            drift = _state_diff(before, _host_state(target))
            if drift:
                bad.append(f"ckpt[{fault}]: rejected restore still touched the target — {drift}")
    return bad


def _fault_sync_degraded(case: Any, probe: Any, device: Device) -> List[str]:
    """Lose a peer after one transient failure; expect the survivor merge."""
    import copy

    from metrics_tpu_torch.parallel.sync import SyncPeerLostError, SyncPolicy, sync_policy

    bad: List[str] = []
    rng = _rng_for(case)
    m = case.ctor(device)
    for _ in range(2):
        m.update(*_batch(case, rng, device))
    local = copy.copy(m.__dict__["_state"])
    count = m._update_count
    peer = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in local.items()}  # a surviving twin
    attempts = {"n": 0}

    def lossy(states: Any, group: Any) -> Any:
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise RuntimeError("transient collective timeout")
        raise SyncPeerLostError("peer 1 lost", survivors=[peer], survivor_counts=[count])

    before_events = len(probe.events)
    with sync_policy(SyncPolicy(retries=1, backoff_s=0.0, partial_merge=True)):
        m.sync(dist_sync_fn=lossy, distributed_available=True)
    if attempts["n"] != 2:
        bad.append(f"sync[degraded]: expected 1 retry (2 attempts), saw {attempts['n']}")
    expected = m._merge_state_dicts(dict(local), dict(peer), count, count)
    drift = _state_diff({k: _host(v) for k, v in expected.items()}, _host_state(m))
    if drift:
        bad.append(f"sync[degraded]: merged state disagrees with the _merge_state_dicts oracle — {drift}")
    if not m._is_synced:
        bad.append("sync[degraded]: metric not marked synced after the degraded merge")
    kinds = [e.get("kind") for e in list(probe.events)[before_events:]]
    if "sync_retry" not in kinds:
        bad.append("sync[degraded]: no sync_retry event recorded for the transient failure")
    if "sync_degraded" not in kinds:
        bad.append("sync[degraded]: no sync_degraded event recorded")
    m.unsync()
    drift = _state_diff({k: _host(v) for k, v in local.items()}, _host_state(m))
    if drift:
        bad.append(f"sync[degraded]: unsync did not restore local state — {drift}")
    return bad


class _probe_recorder:
    """A fresh observe Recorder, enabled, for the extent; the real one and the switch restored after."""

    def __enter__(self) -> Any:
        from metrics_tpu_torch.observe import recorder as _observe

        self._observe = _observe
        self.saved = (_observe.RECORDER, _observe.ENABLED)
        _observe.RECORDER = _observe.Recorder()
        _observe.ENABLED = True
        return _observe.RECORDER

    def __exit__(self, *exc: Any) -> None:
        self._observe.RECORDER, self._observe.ENABLED = self.saved


# ------------------------------------------------------------------ the case
def check_chaos_case(case: Any, device: Device = "cuda") -> ChaosResult:
    """One class through the whole fault suite; never raises."""
    violations: List[str] = []
    ran: List[str] = []
    skipped: List[str] = [f"{name}: {why}" for name, why in SKIPPED_FAULTS.items()]
    with _probe_recorder() as probe:
        try:
            bad, names = _fault_update_exceptions(case, device)
            violations += bad
            ran += names
            bad, applicable = _fault_nan_guard(case, device)
            if applicable:
                violations += bad
                ran += ["nan_guard[skip]", "nan_guard[raise]"]
            else:
                skipped.append("nan_guard")
            violations += _fault_checkpoint(case, device)
            ran += ["ckpt[roundtrip]", "ckpt[truncate]", "ckpt[bitflip]"]
            violations += _fault_sync_degraded(case, probe, device)
            ran += ["sync[degraded]"]
        except Exception as exc:  # noqa: BLE001 — a crash in the harness is itself a verdict
            violations.append(f"harness: {type(exc).__name__}: {str(exc)[:200]}")
    return ChaosResult(case.name, tuple(ran), tuple(skipped), tuple(violations))


def collect_chaos_report(cases: Optional[Sequence[Any]] = None, device: Device = "cuda") -> List[ChaosResult]:
    return [check_chaos_case(c, device) for c in (cases if cases is not None else chaos_cases())]


# --------------------------------------------------------- fleet durability suite
_FLEET_SESSIONS = 3  # sessions per scenario engine (one bucket, distinct rows)


def _fleet_script(case: Any, n_batches: int, device: Device) -> List[Tuple[int, Tuple[Any, ...]]]:
    """Deterministic round-robin ingest script: (session index, batch)."""
    rng = _rng_for(case)
    return [(i % _FLEET_SESSIONS, _batch(case, rng, device)) for i in range(n_batches)]


def _fleet_oracle(case: Any, script: Sequence[Tuple[int, Tuple[Any, ...]]], device: Device) -> List[str]:
    """Per-session state fingerprints from a never-crashed engine fed ``script``."""
    from metrics_tpu_torch.engine.stream import StreamEngine

    eng = StreamEngine()
    sids = [eng.add_session(case.ctor(device)) for _ in range(_FLEET_SESSIONS)]
    for idx, batch in script:
        eng.submit(sids[idx], *batch)
    eng.tick()
    return [eng.expire(sid).state_fingerprint() for sid in sids]


def _fleet_recovered(engine: Any, sids: Sequence[Any]) -> List[str]:
    engine.tick()
    return [engine.expire(sid).state_fingerprint() for sid in sids]


def _diff_fingerprints(fault: str, got: Sequence[str], want: Sequence[str]) -> List[str]:
    return [
        f"{fault}: session {i} not bit-exact vs the never-crashed oracle"
        for i, (g, w) in enumerate(zip(got, want))
        if g != w
    ]


def _scenario_kill(case: Any, tmp: str, stage: str, device: Device) -> List[str]:
    """Kill the process mid-tick (unapplied journal suffix) or mid-flush (the
    post-checkpoint records were applied, then the process died): recovery is
    checkpoint + journal replay, bit-exact either way."""
    from metrics_tpu_torch.engine.stream import StreamEngine

    wal = os.path.join(tmp, f"{stage}.wal")
    ckpt = os.path.join(tmp, f"{stage}.ckpt")
    script = _fleet_script(case, 8, device)
    cut = 5
    eng = StreamEngine(wal_path=wal)
    sids = [eng.add_session(case.ctor(device)) for _ in range(_FLEET_SESSIONS)]
    for idx, batch in script[:cut]:
        eng.submit(sids[idx], *batch)
    eng.tick()
    eng.checkpoint(ckpt)
    for idx, batch in script[cut:]:
        eng.submit(sids[idx], *batch)
    if stage == "mid_flush":
        eng.tick()  # effects applied in memory, then the process dies
    else:
        eng._wal.sync()  # tick's durability point ran; the dispatch never did
    eng._wal.close()
    del eng  # crash
    rec = StreamEngine.restore(ckpt, wal_path=wal, device=device)
    return _diff_fingerprints(f"kill[{stage}]", _fleet_recovered(rec, sids), _fleet_oracle(case, script, device))


def _scenario_kill_mid_ckpt(case: Any, tmp: str, device: Device) -> List[str]:
    """Die while writing a newer snapshot: the torn/bit-flipped file must be
    rejected, and the previous snapshot + the (untruncated) journal must still
    recover the full history bit-exact."""
    from metrics_tpu_torch.engine.durability import save_fleet_checkpoint
    from metrics_tpu_torch.engine.stream import StreamEngine
    from metrics_tpu_torch.resilience.checkpoint import CorruptCheckpointError

    bad: List[str] = []
    wal = os.path.join(tmp, "mid_ckpt.wal")
    ckpt1 = os.path.join(tmp, "good.ckpt")
    ckpt2 = os.path.join(tmp, "torn.ckpt")
    script = _fleet_script(case, 8, device)
    cut = 5
    eng = StreamEngine(wal_path=wal)
    sids = [eng.add_session(case.ctor(device)) for _ in range(_FLEET_SESSIONS)]
    for idx, batch in script[:cut]:
        eng.submit(sids[idx], *batch)
    eng.tick()
    eng.checkpoint(ckpt1)
    for idx, batch in script[cut:]:
        eng.submit(sids[idx], *batch)
    eng.tick()
    # the second snapshot must NOT truncate the journal: it never becomes valid,
    # so recovery has to reach past it from ckpt1
    save_fleet_checkpoint(eng, ckpt2, truncate_wal=False)
    eng._wal.close()
    del eng  # crash mid-write: simulate the torn result
    with open(ckpt2, "rb") as fh:
        blob = fh.read()
    for fault, mutated in (
        ("truncate", blob[: len(blob) - 7]),
        ("bitflip", blob[:-1] + bytes([blob[-1] ^ 0xFF])),
    ):
        with open(ckpt2, "wb") as fh:
            fh.write(mutated)
        try:
            StreamEngine.restore(ckpt2, wal_path=wal, device=device)
            bad.append(f"kill[mid_ckpt]: {fault}d snapshot was accepted")
        except CorruptCheckpointError:
            pass
    rec = StreamEngine.restore(ckpt1, wal_path=wal, device=device)
    bad += _diff_fingerprints("kill[mid_ckpt]", _fleet_recovered(rec, sids), _fleet_oracle(case, script, device))
    return bad


def _scenario_journal_damage(case: Any, tmp: str, fault: str, device: Device) -> List[str]:
    """Torn or bit-flipped final journal frame: replay must stop cleanly at the
    damage and recover exactly the intact prefix of the history."""
    from metrics_tpu_torch.engine.stream import StreamEngine

    wal = os.path.join(tmp, f"{fault}.wal")
    ckpt = os.path.join(tmp, f"{fault}.ckpt")
    script = _fleet_script(case, 6, device)
    eng = StreamEngine(wal_path=wal)
    sids = [eng.add_session(case.ctor(device)) for _ in range(_FLEET_SESSIONS)]
    eng.checkpoint(ckpt)  # snapshot of the empty fleet; every submit lives in the WAL
    for idx, batch in script:
        eng.submit(sids[idx], *batch)
    eng._wal.sync()
    eng._wal.close()
    del eng  # crash
    with open(wal, "rb") as fh:
        blob = fh.read()
    damaged = blob[:-5] if fault == "torn" else blob[:-1] + bytes([blob[-1] ^ 0xFF])
    with open(wal, "wb") as fh:
        fh.write(damaged)
    rec = StreamEngine.restore(ckpt, wal_path=wal, device=device)
    # the damage eats exactly the final record; the oracle saw the prefix
    return _diff_fingerprints(
        f"journal[{fault}]", _fleet_recovered(rec, sids), _fleet_oracle(case, script[:-1], device)
    )


def _scenario_poison_row(case: Any, device: Device) -> Tuple[List[str], bool]:
    """One poisoned row in a full bucket under ``nan_guard``: that session is
    quarantined (its poisoned batch dropped), every other row is bit-exact, and
    the flush still costs exactly one dispatch for the bucket."""
    from metrics_tpu_torch.engine.stream import StreamEngine

    script = _fleet_script(case, _FLEET_SESSIONS * 2, device)
    poisoned, ok = _poison_batch(script[1][1])
    if not ok:
        return [], False  # nothing float-typed to poison
    bad: List[str] = []
    eng = StreamEngine(nan_guard=True)
    sids = [eng.add_session(case.ctor(device)) for _ in range(_FLEET_SESSIONS)]
    for i, (idx, batch) in enumerate(script):
        eng.submit(sids[idx], *(poisoned if i == 1 else batch))
    dispatches = eng.tick()
    # wave 1 (first submission per slot) carries the poison; wave 2 is clean:
    # both waves chain inside the ONE fused program (engine/core.py), so even a
    # quarantine-bearing tick must cost exactly one dispatch, never more
    if dispatches > 1:
        bad.append(f"poison[row]: quarantine broke tick fusion ({dispatches} dispatches for 2 waves)")
    if eng.session_health(sids[1]) != "quarantined":
        bad.append(f"poison[row]: poisoned session health is {eng.session_health(sids[1])!r}, expected 'quarantined'")
    for i in (0, 2):
        if eng.session_health(sids[i]) != "healthy":
            bad.append(f"poison[row]: clean session {i} health is {eng.session_health(sids[i])!r}")
    # the oracle never sees the poisoned batch at all (nan_guard drops it). The quarantined session's later
    # batch ran eagerly where the oracle's ran in the bucket, and on the card an eager update and a vmapped one
    # may sum floats in another order (SSIM's per-image mean; fleet_contracts.eager_vs_bucket_gap measures
    # it): there, and only there, a fingerprint mismatch of that session falls back to the fleet pass's
    # tolerance, as death[replay] does for its replayed rows
    on_card = torch.device(device).type == "cuda"
    oracle = StreamEngine()
    osids = [oracle.add_session(case.ctor(device)) for _ in range(_FLEET_SESSIONS)]
    for idx, batch in (sb for i, sb in enumerate(script) if i != 1):
        oracle.submit(osids[idx], *batch)
    oracle.tick()
    for i, (sid, osid) in enumerate(zip(sids, osids)):
        g, w = eng.expire(sid), oracle.expire(osid)
        if g.state_fingerprint() == w.state_fingerprint():
            continue
        if not (on_card and i == 1) or _compare(dict(g.__dict__["_state"]), dict(w.__dict__["_state"])) == "diverged":
            bad.append(f"poison[row]: session {i} not bit-exact vs the never-crashed oracle")
    return bad, True


def _scenario_dispatch_death(case: Any, device: Device) -> List[str]:
    """Fused-program runtime death with INTACT buffers (engine/stream.py): the
    per-bucket fallback is also dead, so the engine walks down to per-row
    eager replay — which must quarantine exactly the poison row (state rolled
    back, batch dropped) and land every surviving row bit-exact."""
    import metrics_tpu_torch.engine.stream as stream_mod
    from metrics_tpu_torch.engine.stream import StreamEngine
    from metrics_tpu_torch.metric import Metric

    script = _fleet_script(case, _FLEET_SESSIONS, device)  # one wave, one row per session
    bad: List[str] = []
    eng = StreamEngine()
    sids = [eng.add_session(case.ctor(device)) for _ in range(_FLEET_SESSIONS)]
    for idx, batch in script:
        eng.submit(sids[idx], *batch)

    def dead_dispatch(*_a: Any, **_k: Any) -> Any:
        raise RuntimeError("chaos: injected runtime dispatch death (buffers intact)")

    real_fused = stream_mod.engine_update_fused
    real_update = stream_mod.engine_update
    real_fu = Metric._functional_update
    calls = {"n": 0, "depth": 0}

    def trapdoor(self: Any, state: Any, *a: Any, **k: Any) -> Any:
        # count TOP-LEVEL calls only: composite kernels (TimeDecayed, pane
        # windows) re-enter _functional_update on their base metric, and a
        # raw call count would land the poison on the wrong session's row
        if calls["depth"] == 0:
            i = calls["n"]
            calls["n"] += 1
            if i == 1:  # rows replay in wave order: call 1 is session 1's row
                raise RuntimeError("chaos: poison row")
        calls["depth"] += 1
        try:
            return real_fu(self, state, *a, **k)
        finally:
            calls["depth"] -= 1

    stream_mod.engine_update_fused = dead_dispatch
    stream_mod.engine_update = dead_dispatch
    Metric._functional_update = trapdoor
    try:
        eng.tick()
    finally:
        stream_mod.engine_update_fused = real_fused
        stream_mod.engine_update = real_update
        Metric._functional_update = real_fu

    if eng.session_health(sids[1]) != "quarantined":
        bad.append(
            f"death[replay]: poison session health is {eng.session_health(sids[1])!r}, "
            "expected 'quarantined'"
        )
    for i in (0, 2):
        if eng.session_health(sids[i]) != "healthy":
            bad.append(f"death[replay]: surviving session {i} health is {eng.session_health(sids[i])!r}")
    # the poison row's batch is dropped; every other row replays eagerly
    # through the pure per-row kernel. The never-crashed oracle ran the
    # vmapped jitted program instead, and eager-vs-jit bit-exactness is
    # kernel-dependent (XLA may reassociate differently under vmap), so a
    # fingerprint mismatch falls back to the fleet pass's tolerance verdict
    # before being called a fault — the same EXACT/LOOSE ladder that pass
    # applies to engine-vs-eager state agreement.
    from metrics_tpu_torch.engine.stream import StreamEngine as _SE

    oracle = _SE()
    osids = [oracle.add_session(case.ctor(device)) for _ in range(_FLEET_SESSIONS)]
    for idx, batch in (sb for i, sb in enumerate(script) if i != 1):
        oracle.submit(osids[idx], *batch)
    oracle.tick()
    for i, (sid, osid) in enumerate(zip(sids, osids)):
        g, w = eng.expire(sid), oracle.expire(osid)
        if g.state_fingerprint() == w.state_fingerprint():
            continue
        if _compare(dict(g.__dict__["_state"]), dict(w.__dict__["_state"])) == "diverged":
            bad.append(f"death[replay]: session {i} not bit-exact vs the never-crashed oracle")
    return bad


def _bucketable(case: Any, device: Device) -> bool:
    """Whether the class's metric rides a fleet bucket (the fleet suites run only those)."""
    from metrics_tpu_torch.engine.stream import StreamEngine

    probe_engine = StreamEngine()
    sid = probe_engine.add_session(case.ctor(device))
    bucketable = probe_engine._sessions[sid].bucket is not None
    probe_engine.expire(sid)
    return bucketable


def _run_suite(case: Any, device: Device, suite: str, prefix: str, body: Any) -> ChaosResult:
    """``body(tmp) -> (violations, ran, skipped)`` for a bucketable class, under a fresh recorder and a
    cleared program cache; never raises."""
    import tempfile

    from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE

    violations: List[str] = []
    ran: List[str] = []
    skipped: List[str] = []
    with _probe_recorder():
        _FLEET_JIT_CACHE.clear()
        try:
            if not _bucketable(case, device):
                return ChaosResult(case.name, (), (suite,), ())
            with tempfile.TemporaryDirectory(prefix=prefix) as tmp:
                violations, ran, skipped = body(tmp)
        except Exception as exc:  # noqa: BLE001 — a crash in the harness is itself a verdict
            violations.append(f"harness: {type(exc).__name__}: {str(exc)[:200]}")
        finally:
            _FLEET_JIT_CACHE.clear()
    return ChaosResult(case.name, tuple(ran), tuple(skipped), tuple(violations))


def check_fleet_chaos_case(case: Any, device: Device = "cuda") -> ChaosResult:
    """One class through the fleet durability scenarios; never raises."""

    def body(tmp: str) -> Tuple[List[str], List[str], List[str]]:
        violations: List[str] = []
        ran: List[str] = []
        skipped: List[str] = []
        for stage in ("mid_tick", "mid_flush"):
            violations += _scenario_kill(case, tmp, stage, device)
            ran.append(f"kill[{stage}]")
        violations += _scenario_kill_mid_ckpt(case, tmp, device)
        ran.append("kill[mid_ckpt]")
        for fault in ("torn", "bitflip"):
            violations += _scenario_journal_damage(case, tmp, fault, device)
            ran.append(f"journal[{fault}]")
        bad, applicable = _scenario_poison_row(case, device)
        if applicable:
            violations += bad
            ran.append("poison[row]")
        else:
            skipped.append("poison[row]")
        violations += _scenario_dispatch_death(case, device)
        ran.append("death[replay]")
        return violations, ran, skipped

    return _run_suite(case, device, "fleet", "chaos_fleet_", body)


def collect_fleet_chaos_report(cases: Optional[Sequence[Any]] = None, device: Device = "cuda") -> List[ChaosResult]:
    return [check_fleet_chaos_case(c, device) for c in (cases if cases is not None else chaos_cases())]


# --------------------------------------------------------- sharded fleet suite
_SHARD_N = 2  # shards per scenario fleet (small, but every cross-shard seam)


def _shard_sids(n_shards: int, per_shard: int = 2) -> List[str]:
    """Deterministic session ids covering every shard ``per_shard`` times."""
    from metrics_tpu_torch.engine.sharded import shard_of

    got = {k: 0 for k in range(n_shards)}
    out: List[str] = []
    i = 0
    while any(v < per_shard for v in got.values()):
        sid = f"s{i}"
        i += 1
        k = shard_of(sid, n_shards)
        if got[k] < per_shard:
            got[k] += 1
            out.append(sid)
    return out


def _shard_script(case: Any, sids: Sequence[str], n_batches: int, device: Device) -> List[Tuple[str, Tuple[Any, ...]]]:
    rng = _rng_for(case)
    return [(sids[i % len(sids)], _batch(case, rng, device)) for i in range(n_batches)]


def _shard_oracle(case: Any, sids: Sequence[str], script: Sequence[Tuple[str, Tuple[Any, ...]]], device: Device) -> Dict[str, str]:
    """Per-session fingerprints from a never-crashed (unsharded) engine: the
    sharding layer must never change any session's numbers."""
    from metrics_tpu_torch.engine.stream import StreamEngine

    eng = StreamEngine()
    for sid in sids:
        eng.add_session(case.ctor(device), sid)
    for sid, batch in script:
        eng.submit(sid, *batch)
    eng.tick()
    return {sid: eng.expire(sid).state_fingerprint() for sid in sids}


def _shard_crash(fleet: Any) -> None:
    """Simulate a host kill: journals are on disk, nothing else survives."""
    for shard in fleet._shards:
        if shard._wal is not None:
            shard._wal.sync()
            shard._wal.close()


def _diff_shard_fingerprints(fault: str, got: Dict[str, str], want: Dict[str, str]) -> List[str]:
    return [
        f"{fault}: session {sid} not bit-exact vs the never-crashed oracle"
        for sid in want
        if got.get(sid) != want[sid]
    ]


def _shard_ckpt_file(d: str, gen: int, k: int) -> str:
    return os.path.join(d, f"g{gen:08d}-shard{k:03d}.mtckpt")


def _shard_scenario_host_kill(case: Any, tmp: str, device: Device) -> List[str]:
    """Kill the host with a journal tail past the last checkpoint: restore must
    be bit-exact, with each shard replaying only its own journal."""
    from metrics_tpu_torch.engine.sharded import ShardedStreamEngine

    d = os.path.join(tmp, "host_kill")
    sids = _shard_sids(_SHARD_N)
    script = _shard_script(case, sids, 8, device)
    cut = 5
    fleet = ShardedStreamEngine(n_shards=_SHARD_N, wal_dir=d, devices=[device])
    for sid in sids:
        fleet.add_session(case.ctor(device), sid)
    for sid, batch in script[:cut]:
        fleet.submit(sid, *batch)
    fleet.tick()
    fleet.checkpoint(d)
    for sid, batch in script[cut:]:
        fleet.submit(sid, *batch)
    _shard_crash(fleet)  # the post-checkpoint tail lives only in the journals
    rec = ShardedStreamEngine.restore(d, devices=[device])
    rec.tick()
    got = {sid: rec.expire(sid).state_fingerprint() for sid in sids}
    return _diff_shard_fingerprints("shard_kill[host]", got, _shard_oracle(case, sids, script, device))


def _shard_scenario_lost_recoverable(case: Any, tmp: str, device: Device) -> List[str]:
    """Delete one shard's checkpoint file whose snapshot covered nothing: that
    shard must rebuild from its journal alone, bit-exact, no flags needed."""
    from metrics_tpu_torch.engine.sharded import ShardedStreamEngine

    d = os.path.join(tmp, "lost_recoverable")
    sids = _shard_sids(_SHARD_N)
    script = _shard_script(case, sids, 6, device)
    fleet = ShardedStreamEngine(n_shards=_SHARD_N, wal_dir=d, devices=[device])
    fleet.checkpoint(d)  # snapshot of the empty fleet: the journal IS the history
    for sid in sids:
        fleet.add_session(case.ctor(device), sid)
    for sid, batch in script:
        fleet.submit(sid, *batch)
    _shard_crash(fleet)
    os.remove(_shard_ckpt_file(d, 1, 0))
    rec = ShardedStreamEngine.restore(d, devices=[device])
    rec.tick()
    got = {sid: rec.expire(sid).state_fingerprint() for sid in sids}
    return _diff_shard_fingerprints("shard_lost[recoverable]", got, _shard_oracle(case, sids, script, device))


def _shard_scenario_lost_unrecoverable(case: Any, tmp: str, device: Device) -> List[str]:
    """Bit-flip one shard's checkpoint file that DID cover state: the default
    restore must refuse; ``on_lost_shard="demote"`` must bring the fleet back
    with the lost shard empty + demoted, every surviving session bit-exact, and
    the surviving shards still at one dispatch per bucket per tick."""
    from metrics_tpu_torch.engine.sharded import ShardedStreamEngine, shard_of
    from metrics_tpu_torch.resilience.checkpoint import CheckpointError

    bad: List[str] = []
    d = os.path.join(tmp, "lost_unrecoverable")
    sids = _shard_sids(_SHARD_N)
    survivors = [sid for sid in sids if shard_of(sid, _SHARD_N) != 0]
    rng = _rng_for(case)
    pre = [(sids[i % len(sids)], _batch(case, rng, device)) for i in range(6)]
    extra = [(sid, _batch(case, rng, device)) for sid in survivors]  # lands post-restore
    fleet = ShardedStreamEngine(n_shards=_SHARD_N, wal_dir=d, devices=[device])
    for sid in sids:
        fleet.add_session(case.ctor(device), sid)
    for sid, batch in pre:
        fleet.submit(sid, *batch)
    fleet.tick()
    fleet.checkpoint(d)
    _shard_crash(fleet)
    fpath = _shard_ckpt_file(d, 1, 0)
    with open(fpath, "rb") as fh:
        blob = fh.read()
    with open(fpath, "wb") as fh:
        fh.write(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
    try:
        ShardedStreamEngine.restore(d, devices=[device])
        bad.append("shard_lost[strict]: corrupt shard checkpoint was accepted")
    except CheckpointError:
        pass
    rec = ShardedStreamEngine.restore(d, on_lost_shard="demote", devices=[device])
    if sorted(rec._demoted) != [0]:
        bad.append(f"shard_lost[demote]: demoted set is {sorted(rec._demoted)}, expected [0]")
    if set(rec.session_ids()) != set(survivors):
        bad.append("shard_lost[demote]: surviving session population is wrong")
    # the surviving shard keeps its dispatch economy while shard 0 sits demoted
    for sid, batch in extra:
        rec.submit(sid, *batch)
    dispatches = rec.tick()
    if dispatches != 1:
        bad.append(
            f"shard_lost[demote]: surviving shard cost {dispatches} dispatches for one bucket"
        )
    # a new arrival routed to the demoted shard runs loose, never a dispatch
    i = 0
    while shard_of(f"n{i}", _SHARD_N) != 0:
        i += 1
    new_sid = f"n{i}"
    rec.add_session(case.ctor(device), new_sid)
    if rec.session_health(new_sid) != "loose":
        bad.append(
            f"shard_lost[demote]: arrival on the demoted shard is "
            f"{rec.session_health(new_sid)!r}, expected 'loose'"
        )
    rec.submit(new_sid, *_batch(case, _rng_for(case), device))
    if rec.tick() != 0:
        bad.append("shard_lost[demote]: demoted shard's loose work cost a dispatch")
    got = {sid: rec.expire(sid).state_fingerprint() for sid in survivors}
    want = _shard_oracle(
        case, survivors, [e for e in pre if e[0] in survivors] + extra
    , device)
    bad += _diff_shard_fingerprints("shard_lost[demote]", got, want)
    return bad


def _shard_scenario_torn_manifest(case: Any, tmp: str, device: Device) -> List[str]:
    """Truncate the manifest mid-write: the restore must be rejected outright
    (the per-shard files are unreachable without an intact manifest)."""
    from metrics_tpu_torch.engine.sharded import MANIFEST_NAME, ShardedStreamEngine
    from metrics_tpu_torch.resilience.checkpoint import CorruptCheckpointError

    d = os.path.join(tmp, "torn_manifest")
    sids = _shard_sids(_SHARD_N)
    fleet = ShardedStreamEngine(n_shards=_SHARD_N, wal_dir=d, devices=[device])
    for sid in sids:
        fleet.add_session(case.ctor(device), sid)
    for sid, batch in _shard_script(case, sids, 4, device):
        fleet.submit(sid, *batch)
    fleet.tick()
    fleet.checkpoint(d)
    _shard_crash(fleet)
    man = os.path.join(d, MANIFEST_NAME)
    with open(man, "rb") as fh:
        blob = fh.read()
    with open(man, "wb") as fh:
        fh.write(blob[: len(blob) - 7])
    try:
        ShardedStreamEngine.restore(d, devices=[device])
        return ["shard_manifest[torn]: torn manifest was accepted"]
    except CorruptCheckpointError:
        return []


def _shard_scenario_resize(case: Any, tmp: str, device: Device) -> List[str]:
    """Elastic resize through restore: grow 2→3 then shrink 3→1, each hop
    re-hashing every session through the normal arrival path, bit-exact."""
    from metrics_tpu_torch.engine.sharded import ShardedStreamEngine

    bad: List[str] = []
    d = os.path.join(tmp, "resize")
    sids = _shard_sids(_SHARD_N)
    script = _shard_script(case, sids, 6, device)
    fleet = ShardedStreamEngine(n_shards=_SHARD_N, wal_dir=d, devices=[device])
    for sid in sids:
        fleet.add_session(case.ctor(device), sid)
    for sid, batch in script:
        fleet.submit(sid, *batch)
    fleet.tick()
    fleet.checkpoint(d)
    _shard_crash(fleet)
    want = _shard_oracle(case, sids, script, device)
    grown = ShardedStreamEngine.restore(d, n_shards=_SHARD_N + 1, devices=[device])  # also re-checkpoints
    if grown.n_shards != _SHARD_N + 1:
        bad.append(f"shard_resize[grow]: n_shards is {grown.n_shards}")
    _shard_crash(grown)
    shrunk = ShardedStreamEngine.restore(d, n_shards=1, devices=[device])
    shrunk.tick()
    got = {sid: shrunk.expire(sid).state_fingerprint() for sid in sids}
    bad += _diff_shard_fingerprints("shard_resize[grow+shrink]", got, want)
    return bad


def check_shard_chaos_case(case: Any, device: Device = "cuda") -> ChaosResult:
    """One class through the sharded-fleet scenarios; never raises."""

    def body(tmp: str) -> Tuple[List[str], List[str], List[str]]:
        violations = _shard_scenario_host_kill(case, tmp, device)
        violations += _shard_scenario_lost_recoverable(case, tmp, device)
        violations += _shard_scenario_lost_unrecoverable(case, tmp, device)
        violations += _shard_scenario_torn_manifest(case, tmp, device)
        violations += _shard_scenario_resize(case, tmp, device)
        ran = ["shard_kill[host]", "shard_lost[recoverable]", "shard_lost[strict]", "shard_lost[demote]",
               "shard_manifest[torn]", "shard_resize[grow+shrink]"]
        return violations, ran, []

    return _run_suite(case, device, "shard", "chaos_shard_", body)


def collect_shard_chaos_report(cases: Optional[Sequence[Any]] = None, device: Device = "cuda") -> List[ChaosResult]:
    return [check_shard_chaos_case(c, device) for c in (cases if cases is not None else chaos_cases())]


# ----------------------------------------------------- serve front-door suite
_SERVE_KEY = "chaos-serve-key"


def _serve_rig(tmp: str, sub: str, device: Device, autonomic: bool = False) -> Tuple[Any, Any, Any, Any]:
    """A listener-less server over one half of a socketpair, WAL on disk.

    Returns ``(engine, server, client_socket, autonomic_or_None)`` — the
    harness drives the client end with raw bytes (no :class:`Producer`: the
    scenarios need frame surgery a well-behaved producer cannot perform).
    """
    import socket

    from metrics_tpu_torch.engine.stream import StreamEngine
    from metrics_tpu_torch.serve.autonomic import AutonomicController
    from metrics_tpu_torch.serve.server import MetricsServer

    engine = StreamEngine(wal_path=os.path.join(tmp, f"{sub}.wal"))
    auto = (
        AutonomicController(
            engine, min_interval_s={"double": 0.0, "demote": 0.0, "resize": 0.0, "shed": 0.0}
        )
        if autonomic
        else None
    )
    server = MetricsServer(engine, _SERVE_KEY, host=None, autonomic=auto, name=f"chaos-{sub}", device=device)
    srv_sock, cli = socket.socketpair()
    server.adopt(srv_sock)
    cli.setblocking(False)
    return engine, server, cli, auto


def _serve_hello(producer: str = "chaos") -> bytes:
    from metrics_tpu_torch.serve.protocol import PROTO_VERSION, WAL_MAGIC, encode_frame

    return WAL_MAGIC + encode_frame(
        "hello", 0, producer, {"key": _SERVE_KEY, "producer": producer, "proto": PROTO_VERSION}
    )


def _serve_np(batch: Tuple[Any, ...]) -> Tuple[Any, ...]:
    """Host copies of a case batch: what a remote producer sends."""
    return tuple(_host(a) if isinstance(a, torch.Tensor) else a for a in batch)


def _serve_oracle(case: Any, batches: Sequence[Tuple[Any, ...]], device: Device) -> str:
    """Fingerprint of a never-networked engine fed the same records."""
    from metrics_tpu_torch.engine.stream import StreamEngine

    eng = StreamEngine()
    eng.add_session(case.ctor(device), "s0")
    for batch in batches:
        eng.submit("s0", *batch)
    eng.tick()
    return eng.expire("s0").state_fingerprint()


def _serve_scenario_mid_frame(case: Any, tmp: str, device: Device) -> List[str]:
    """Producer dies mid-frame: the engine must hold exactly the acked
    records — the torn tail never decodes and is not a framing error."""
    from metrics_tpu_torch.serve.protocol import encode_frame

    engine, server, cli, _ = _serve_rig(tmp, "mid_frame", device)
    out: List[str] = []
    try:
        script = [_serve_np(_batch(case, _rng_for(case), device)) for _ in range(4)]
        blob = _serve_hello() + encode_frame("add", 1, "s0", case.ctor(device))
        for i, batch in enumerate(script[:3]):
            blob += encode_frame("submit", 2 + i, "s0", (batch, {}))
        cli.sendall(blob)
        server.poll(0.0)  # all four records applied, journaled, acked
        torn = encode_frame("submit", 5, "s0", (script[3], {}))
        cli.sendall(torn[: len(torn) // 2])
        cli.close()
        server.poll(0.0)  # reads the half frame, then EOF
        engine.tick()
        if server.protocol_errors:
            out.append("serve_kill[mid_frame]: a torn tail at EOF is not a framing error")
        if server.disconnects != 1:
            out.append(f"serve_kill[mid_frame]: {server.disconnects} disconnects, expected 1")
        got = engine.expire("s0").state_fingerprint()
        if got != _serve_oracle(case, script[:3], device):
            out.append("serve_kill[mid_frame]: state not bit-exact vs the acked-records oracle")
    finally:
        server.close()
    return out


def _serve_scenario_torn_boundary(case: Any, tmp: str, device: Device) -> List[str]:
    """A frame split across two reads applies exactly once; a bit-flipped CRC
    keeps the intact records decoded before it and drops the connection."""
    from metrics_tpu_torch.serve.protocol import encode_frame

    engine, server, cli, _ = _serve_rig(tmp, "torn_boundary", device)
    out: List[str] = []
    try:
        script = [_serve_np(_batch(case, _rng_for(case), device)) for _ in range(3)]
        cli.sendall(_serve_hello() + encode_frame("add", 1, "s0", case.ctor(device)))
        server.poll(0.0)
        split = encode_frame("submit", 2, "s0", (script[0], {}))
        cli.sendall(split[:7])  # mid-header: not even the length is whole
        server.poll(0.0)
        cli.sendall(split[7:])
        server.poll(0.0)
        good = encode_frame("submit", 3, "s0", (script[1], {}))
        bad = bytearray(encode_frame("submit", 4, "s0", (script[2], {})))
        bad[-1] ^= 0xFF  # body bit-flip: the CRC no longer matches
        cli.sendall(good + bytes(bad))
        server.poll(0.0)
        engine.tick()
        if server.protocol_errors != 1:
            out.append(
                f"serve_torn[boundary]: {server.protocol_errors} framing errors, expected 1"
            )
        if server.disconnects != 1:
            out.append("serve_torn[boundary]: damaged framing must drop the connection")
        got = engine.expire("s0").state_fingerprint()
        if got != _serve_oracle(case, script[:2], device):
            out.append(
                "serve_torn[boundary]: state not bit-exact vs the intact-records oracle"
            )
    finally:
        server.close()
    return out


def _serve_scenario_dup_replay(case: Any, tmp: str, device: Device) -> List[str]:
    """A byte-identical replayed ``pseq`` dedups against the shard watermark:
    applied exactly once, acked ``dup``, state bit-exact."""
    from metrics_tpu_torch.serve.protocol import encode_frame

    engine, server, cli, _ = _serve_rig(tmp, "dup_replay", device)
    out: List[str] = []
    try:
        batch = _serve_np(_batch(case, _rng_for(case), device))
        frame = encode_frame("submit", 2, "s0", (batch, {}))
        cli.sendall(_serve_hello() + encode_frame("add", 1, "s0", case.ctor(device)) + frame)
        server.poll(0.0)
        cli.sendall(frame)  # the replay: same bytes, same pseq
        server.poll(0.0)
        engine.tick()
        if server.dedup_skipped != 1:
            out.append(
                f"serve_dup[replay]: {server.dedup_skipped} dedups, expected exactly 1"
            )
        if engine.serve_watermark("chaos") != 2:
            out.append(
                f"serve_dup[replay]: watermark {engine.serve_watermark('chaos')}, expected 2"
            )
        got = engine.expire("s0").state_fingerprint()
        if got != _serve_oracle(case, [batch], device):
            out.append("serve_dup[replay]: state not bit-exact vs the once-applied oracle")
    finally:
        server.close()
    return out


def _serve_scenario_autonomic_race(case: Any, tmp: str, device: Device) -> List[str]:
    """An autonomic demote/shed whose target expires first must confirm the
    ghost (handshake cannot wedge) and leave survivors untouched."""
    from metrics_tpu_torch import observe
    from metrics_tpu_torch.observe.metering import MeterPolicy
    from metrics_tpu_torch.serve.protocol import encode_frame

    engine, server, cli, auto = _serve_rig(tmp, "autonomic_race", device, autonomic=True)
    saved_meter = observe.installed_meter()
    mt = observe.install_meter(top_k=8, policy=MeterPolicy(action="demote"))
    out: List[str] = []
    try:
        batch = _serve_np(_batch(case, _rng_for(case), device))
        cli.sendall(
            _serve_hello()
            + encode_frame("add", 1, "s0", case.ctor(device))
            + encode_frame("add", 2, "s1", case.ctor(device))
            + encode_frame("submit", 3, "s0", (batch, {}))
        )
        server.poll(0.0)
        engine.tick()
        survivor = engine._sessions["s0"].metric.state_fingerprint()
        engine._demote_session(engine._sessions["s1"])  # the shed candidate
        # inject the race: the meter queues a demotion for s1, then the
        # expiry lands before the reflex runs — step() must confirm the ghost
        with mt._lock:
            mt._pending_demote.add("s1")
        cli.sendall(encode_frame("expire", 4, "s1"))
        server.poll(0.0)  # applies the expiry, then runs autonomic.step()
        if mt.pending_demotions():
            out.append(
                f"serve_race[expire]: handshake wedged on {mt.pending_demotions()}"
            )
        # and the on-demand shed path, with the only loose session gone
        if auto.shed(1, reason="chaos"):
            out.append("serve_race[expire]: shed returned a session that no longer exists")
        engine.tick()
        if engine._sessions["s0"].metric.state_fingerprint() != survivor:
            out.append("serve_race[expire]: the race perturbed a surviving session")
    finally:
        observe.uninstall_meter()
        if saved_meter is not None:
            observe.install_meter(saved_meter)
        server.close()
    return out


def check_serve_chaos_case(case: Any, device: Device = "cuda") -> ChaosResult:
    """One class through the front-door scenarios; never raises."""

    def body(tmp: str) -> Tuple[List[str], List[str], List[str]]:
        violations = _serve_scenario_mid_frame(case, tmp, device)
        violations += _serve_scenario_torn_boundary(case, tmp, device)
        violations += _serve_scenario_dup_replay(case, tmp, device)
        violations += _serve_scenario_autonomic_race(case, tmp, device)
        ran = ["serve_kill[mid_frame]", "serve_torn[boundary]", "serve_dup[replay]", "serve_race[expire]"]
        return violations, ran, []

    return _run_suite(case, device, "serve", "chaos_serve_", body)


def collect_serve_chaos_report(cases: Optional[Sequence[Any]] = None, device: Device = "cuda") -> List[ChaosResult]:
    return [check_serve_chaos_case(c, device) for c in (cases if cases is not None else chaos_cases())]


# ------------------------------------------------------------------- baseline
def load_chaos_baseline(path: str, section: str = "chaos") -> Dict[str, str]:
    from metrics_tpu_torch.analysis.engine import load_baseline_section

    return {str(k): str(v) for k, v in load_baseline_section(path, section).items()}


def write_chaos_baseline(
    path: str, results: Sequence[ChaosResult], section: str = "chaos"
) -> Dict[str, str]:
    from metrics_tpu_torch.analysis.engine import write_baseline_section

    values = {
        r.name: "UNJUSTIFIED: " + "; ".join(r.violations)
        for r in sorted(results, key=lambda r: r.name)
        if not r.ok
    }
    write_baseline_section(
        path,
        section,
        values,  # type: ignore[arg-type]
        "chaos baseline: contract violations of the chaos, fleet, shard and serve suites (class -> "
        "justification; expected empty). Regenerate with "
        "`python -m metrics_tpu_torch.analysis.cli --pass chaos --update-baseline`.",
    )
    return values


def diff_chaos_baseline(
    results: Sequence[ChaosResult], baseline: Dict[str, str]
) -> Tuple[List[ChaosResult], List[str]]:
    """Split into (failures, stale_baseline_keys): unbaselined violations fail."""
    failures = [r for r in results if not r.ok and r.name not in baseline]
    observed = {r.name for r in results}
    violated = {r.name for r in results if not r.ok}
    stale = sorted(name for name in baseline if name not in violated or name not in observed)
    return failures, stale


def run_chaos_check(
    root: str,
    baseline_path: Optional[str] = None,
    update_baseline: bool = False,
    quiet: bool = False,
    report: Optional[Dict[str, Any]] = None,
    device: Device = "cuda",
) -> int:
    """The ``chaos`` pass: inject, verify, verdict.

    Runs all FOUR suites — the per-metric fault taxonomy (baselined under
    ``chaos``), the fleet durability scenarios (baselined under ``fleet``),
    the sharded-fleet scenarios (baselined under ``shard``) and the network
    front-door scenarios (baselined under ``serve``).
    """
    path = baseline_path or DEFAULT_BASELINE
    results = collect_chaos_report(device=device)
    fleet_results = collect_fleet_chaos_report(device=device)
    shard_results = collect_shard_chaos_report(device=device)
    serve_results = collect_serve_chaos_report(device=device)
    if update_baseline:
        chaos = write_chaos_baseline(path, results, section="chaos")
        fleet = write_chaos_baseline(path, fleet_results, section="fleet")
        shard = write_chaos_baseline(path, shard_results, section="shard")
        serve = write_chaos_baseline(path, serve_results, section="serve")
        if not quiet:
            print(
                f"chaos: baseline written to {path} "
                f"({len(chaos)} chaos / {len(fleet)} fleet / {len(shard)} shard / "
                f"{len(serve)} serve violation(s))"
            )
        return 0
    failures, stale = diff_chaos_baseline(results, load_chaos_baseline(path, "chaos"))
    fleet_failures, fleet_stale = diff_chaos_baseline(
        fleet_results, load_chaos_baseline(path, "fleet")
    )
    shard_failures, shard_stale = diff_chaos_baseline(
        shard_results, load_chaos_baseline(path, "shard")
    )
    serve_failures, serve_stale = diff_chaos_baseline(
        serve_results, load_chaos_baseline(path, "serve")
    )
    if report is not None:
        report.update(
            {
                "cases": len(results),
                "faults_injected": sum(len(r.ran) for r in results),
                "failures": [r.render() for r in failures],
                "baselined": sum(1 for r in results if not r.ok) - len(failures),
                "stale_baseline_keys": stale,
                "skipped": {r.name: list(r.skipped) for r in results if r.skipped},
                "fleet_cases": len(fleet_results),
                "fleet_scenarios": sum(len(r.ran) for r in fleet_results),
                "fleet_failures": [r.render() for r in fleet_failures],
                "fleet_baselined": sum(1 for r in fleet_results if not r.ok) - len(fleet_failures),
                "fleet_stale_baseline_keys": fleet_stale,
                "shard_cases": len(shard_results),
                "shard_scenarios": sum(len(r.ran) for r in shard_results),
                "shard_failures": [r.render() for r in shard_failures],
                "shard_baselined": sum(1 for r in shard_results if not r.ok) - len(shard_failures),
                "shard_stale_baseline_keys": shard_stale,
                "serve_cases": len(serve_results),
                "serve_scenarios": sum(len(r.ran) for r in serve_results),
                "serve_failures": [r.render() for r in serve_failures],
                "serve_baselined": sum(1 for r in serve_results if not r.ok) - len(serve_failures),
                "serve_stale_baseline_keys": serve_stale,
            }
        )
        return 1 if failures or fleet_failures or shard_failures or serve_failures else 0
    for r in failures:
        print(f"chaos: {r.render()}")
    for r in fleet_failures:
        print(f"chaos[fleet]: {r.render()}")
    for r in shard_failures:
        print(f"chaos[shard]: {r.render()}")
    for r in serve_failures:
        print(f"chaos[serve]: {r.render()}")
    if not quiet:
        for key in stale:
            print(f"chaos: stale baseline entry: {key}")
        for key in fleet_stale:
            print(f"chaos[fleet]: stale baseline entry: {key}")
        for key in shard_stale:
            print(f"chaos[shard]: stale baseline entry: {key}")
        for key in serve_stale:
            print(f"chaos[serve]: stale baseline entry: {key}")
        ok = sum(1 for r in results if r.ok)
        faults = sum(len(r.ran) for r in results)
        fleet_ok = sum(1 for r in fleet_results if r.ok)
        fleet_n = sum(len(r.ran) for r in fleet_results)
        shard_ok = sum(1 for r in shard_results if r.ok)
        shard_n = sum(len(r.ran) for r in shard_results)
        serve_ok = sum(1 for r in serve_results if r.ok)
        serve_n = sum(len(r.ran) for r in serve_results)
        print(
            f"chaos: {ok}/{len(results)} classes survived {faults} injected fault(s), "
            f"{len(failures)} failure(s), {len(stale)} stale; "
            f"fleet: {fleet_ok}/{len(fleet_results)} classes survived {fleet_n} "
            f"recovery scenario(s), {len(fleet_failures)} failure(s), {len(fleet_stale)} stale; "
            f"shard: {shard_ok}/{len(shard_results)} classes survived {shard_n} "
            f"sharded scenario(s), {len(shard_failures)} failure(s), {len(shard_stale)} stale; "
            f"serve: {serve_ok}/{len(serve_results)} classes survived {serve_n} "
            f"front-door scenario(s), {len(serve_failures)} failure(s), {len(serve_stale)} stale"
        )
    return 1 if failures or fleet_failures or shard_failures or serve_failures else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="chaos-contracts", description=__doc__.splitlines()[0])
    p.add_argument("--baseline", default=None, help="chaos baseline JSON path")
    p.add_argument("--update-baseline", action="store_true")
    p.add_argument("--device", default="cuda", help="where the metrics run (default: the card)")
    p.add_argument("--only", default=None, help="case-name substring filter (the baseline diff is skipped)")
    p.add_argument("-v", "--verbose", action="store_true", help="print every class verdict")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    if args.only:
        picked = [c for c in chaos_cases() if args.only.lower() in c.name.lower()]
        results = (collect_chaos_report(picked, args.device) + collect_fleet_chaos_report(picked, args.device)
                   + collect_shard_chaos_report(picked, args.device) + collect_serve_chaos_report(picked, args.device))
        for r in results:
            print(r.render())
        return 1 if any(not r.ok for r in results) else 0
    return run_chaos_check(os.getcwd(), baseline_path=args.baseline, update_baseline=args.update_baseline,
                           quiet=args.quiet, device=args.device)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
