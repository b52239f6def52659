"""Deterministic interleaving harness: the dynamic half of racelint (counterpart of
``metrics_tpu/analysis/interleave_contracts.py``).

racelint claims, statically, that the control plane's ordering is safe: fsync dominates ack, watermark advances
summarize durable marks, autonomic reflexes serialize with the tick, and the read paths never observe a
half-assembled wave. This module *drives* those claims: a virtual scheduler runs the real objects —
``StreamEngine(wal_path=)``, ``MetricsServer(..., host=None, autonomic=, device=)`` over a socketpair,
``Producer(sock=, drive=)``, ``AutonomicController`` — through explicit **atomic segments**

    ingest     one producer record enters the wire (and drains any acks)
    pump       producer round: drain acks, refill the credit window
    poll       one reactor pass (read → apply → fsync → autonomic → ack)
    tick       one engine tick (wave assembly + launch)
    autonomic  one observe→act pass of the controller
    aggregate  a dashboard read (``compute_all``), checked against an oracle
    kill       crash: drop server+engine, WAL-only restart, reconnect

and explores their interleavings three ways, as the JAX package does and with its schedule set: **bounded
exhaustive** over every distinct permutation of a small base schedule, **adversarial** hand-built schedules (a
kill-point at every position of the canonical ingest flow, double-kill, autonomic storms), and **seeded-random**
longer schedules beyond that — deterministic end to end (fixed seed, fixed record streams), so a violation is a
reproducible schedule string, not a flake. The sessions live on ``device`` (the card unless named).

Invariants asserted after *every* segment of *every* schedule:

* ``wm-monotonic``   — the per-producer serve watermark never regresses;
* ``acked-durable``  — every pseq the producer saw acked is covered by the engine's durable watermark
  (fsync-before-ack), and re-checked across real kill-points from the journal alone;
* ``aggregate-oracle`` — a read observes exactly the records folded so far: never a half-assembled wave,
  never a double-applied resend;
* ``serialized``     — tick and autonomic never overlap or re-enter (probe on the live objects);
* ``complete``       — after the final quiesce the resolved prefix is the whole stream (contiguous, no holes)
  and the state equals an every-record-exactly-once oracle.

The producer's ``drive`` is one zero-timeout reactor pass, as in the JAX package: over the rig's AF_UNIX
socketpair a frame is readable as soon as it is sent, so a pass never misses one (the TCP front door's smoke
polls until the frame is read instead). Disagreements are baselined in the ``interleave`` section of
``metrics_tpu_torch/analysis/baselines/racelint_baseline.json`` — expected (and test-pinned) empty.
"""

from __future__ import annotations

import itertools
import os
import random
import shutil
import socket
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

import torch

__all__ = [
    "DEFAULT_TARGET_SCHEDULES",
    "explore_schedules",
    "run_interleave_check",
]

Device = Union[str, torch.device]
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baselines", "racelint_baseline.json")
_SECTION = "interleave"
_KEY = "interleave-key"
_SEED = 20260807

# distinct schedules explored by default; the acceptance floor is 1000
DEFAULT_TARGET_SCHEDULES = 1100

# bounded-exhaustive base: every distinct permutation (6!/2! = 360)
_BASE_SCHEDULE = ("ingest", "ingest", "tick", "autonomic", "aggregate", "poll")
# the canonical happy path a kill-point walks through
_CANONICAL = ("ingest", "poll", "pump", "ingest", "poll", "tick", "aggregate")
_RANDOM_ALPHABET = (
    # ingest-heavy mix so random schedules carry real data flow; kill is rare
    # but present, so crash-recovery rides the random sweep too
    ["ingest"] * 4 + ["poll"] * 4 + ["pump"] * 2 + ["tick"] * 3
    + ["autonomic"] * 2 + ["aggregate"] * 2 + ["kill"]
)
_RANDOM_LEN = 8


class _SerializationProbe:
    """Detects overlap/re-entry between tick and autonomic on the live objects."""

    def __init__(self) -> None:
        self.active: Set[str] = set()
        self.violations: List[str] = []

    def wrap(self, label: str, fn: Callable[..., Any]) -> Callable[..., Any]:
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            if self.active:
                self.violations.append(
                    f"`{label}` entered while {sorted(self.active)} active"
                )
            self.active.add(label)
            try:
                return fn(*args, **kwargs)
            finally:
                self.active.discard(label)

        return wrapped


class _Rig:
    """One live server/engine/producer/controller stack driven segment-by-segment."""

    def __init__(self, tmpdir: str, device: Device) -> None:
        # local imports: this is a dynamic pass, keep plain lint invocations light
        from metrics_tpu_torch.aggregation import SumMetric
        from metrics_tpu_torch.engine.stream import StreamEngine
        from metrics_tpu_torch.serve.autonomic import AutonomicController
        from metrics_tpu_torch.serve.protocol import Producer
        from metrics_tpu_torch.serve.server import MetricsServer

        self._SumMetric = SumMetric
        self._StreamEngine = StreamEngine
        self._AutonomicController = AutonomicController
        self._MetricsServer = MetricsServer
        self.device = device
        self.wal_path = os.path.join(tmpdir, "interleave.wal")
        self.probe = _SerializationProbe()
        self.violations: List[str] = []

        self.engine = StreamEngine(wal_path=self.wal_path)
        self._wrap_engine()
        self.controller = AutonomicController(self.engine)
        self.controller.step = self.probe.wrap("autonomic", self.controller.step)  # type: ignore[method-assign]
        self.server = MetricsServer(self.engine, _KEY, host=None, autonomic=self.controller, device=device)
        srv_sock, cli_sock = socket.socketpair()
        self.server.adopt(srv_sock)
        self.producer = Producer(None, _KEY, name="prod-a", sock=cli_sock, drive=lambda: self.server.poll(0.0))

        self.values: Dict[int, float] = {}       # submit pseq -> value
        self.next_value = 0.0
        self.ticked: Tuple[int, ...] = ()        # applied pseqs folded by the last tick
        self.last_wm = 0
        self.add_pseq = self.producer.add_session(SumMetric(device=device), "s0")

    # ------------------------------------------------------------- plumbing
    def _wrap_engine(self) -> None:
        self.engine.tick = self.probe.wrap("tick", self.engine.tick)  # type: ignore[method-assign]

    def _watermark(self) -> int:
        return int(self.engine.serve_watermark("prod-a"))

    def _applied_submits(self) -> Tuple[int, ...]:
        wm = self._watermark()
        return tuple(sorted(p for p in self.values if p <= wm))

    def _flag(self, kind: str, detail: str) -> None:
        self.violations.append(f"{kind}: {detail}")

    # ------------------------------------------------------------- segments
    def segment(self, name: str) -> None:
        if name == "ingest":
            self.next_value += 1.0
            pseq = self.producer.submit("s0", self.next_value)
            self.values[pseq] = self.next_value
        elif name == "pump":
            self.producer.pump()
        elif name == "poll":
            self.server.poll(0.0)
        elif name == "tick":
            self.engine.tick()
            self.ticked = self._applied_submits()
        elif name == "autonomic":
            self.controller.step()
        elif name == "aggregate":
            self._check_aggregate()
        elif name == "kill":
            self._kill_and_restart()
        else:  # pragma: no cover - schedule generators only emit known names
            raise ValueError(f"unknown segment {name!r}")
        self._check_invariants()

    def _check_invariants(self) -> None:
        wm = self._watermark()
        if wm < self.last_wm:
            self._flag("wm-monotonic", f"watermark regressed {self.last_wm} -> {wm}")
        self.last_wm = wm
        if self.producer.acked > wm:
            self._flag(
                "acked-durable",
                f"producer saw pseq {self.producer.acked} acked but durable "
                f"watermark is {wm} — ack outran the fsync",
            )
        if self.producer.errors:
            self._flag("complete", f"producer errors: {self.producer.errors!r}")

    def _check_aggregate(self) -> None:
        # compute_all flushes pending first (stream.py `compute_all`), so a read
        # must observe EXACTLY the applied prefix: every record the watermark
        # covers, once each — never a half-assembled wave, never a double apply.
        applied = self._applied_submits()
        values = self.engine.compute_all()
        got = float(values.get("s0", 0.0)) if values else 0.0
        expected = sum(self.values[p] for p in applied)
        if abs(got - expected) > 1e-6:
            self._flag(
                "aggregate-oracle",
                f"read {got} but the applied prefix is exactly {list(applied)} "
                f"(expected {expected}) — half-assembled wave or double apply",
            )
        self.ticked = applied

    def _kill_and_restart(self) -> None:
        from metrics_tpu_torch.engine.durability import IngestWAL, replay_wal

        acked_at_kill = self.producer.acked
        self.server.close()
        self.engine = self._StreamEngine()
        replay_wal(self.engine, self.wal_path, device=self.device)
        self.engine._wal = IngestWAL(self.wal_path)
        self.engine._wal_path = self.wal_path
        self._wrap_engine()
        if self._watermark() < acked_at_kill:
            self._flag(
                "acked-durable",
                f"WAL-only restart recovered watermark {self._watermark()} "
                f"< acked {acked_at_kill} — an acked record died with the process",
            )
        # recovery tick: fold the replayed prefix before serving reads again
        self.engine.tick()
        self.ticked = self._applied_submits()
        self.controller = self._AutonomicController(self.engine)
        self.controller.step = self.probe.wrap("autonomic", self.controller.step)  # type: ignore[method-assign]
        self.server = self._MetricsServer(self.engine, _KEY, host=None, autonomic=self.controller,
                                          device=self.device)
        srv_sock, cli_sock = socket.socketpair()
        self.server.adopt(srv_sock)
        self.producer._drive = lambda: self.server.poll(0.0)
        self.producer.reconnect(cli_sock)

    # ------------------------------------------------------------- teardown
    def finish(self) -> None:
        """Quiesce, then hold the final state to the exactly-once oracle."""
        try:
            self.producer.flush(10.0)
        except Exception as exc:  # noqa: BLE001 - a wedged flush IS the violation
            self._flag("complete", f"final flush failed: {exc}")
        self.server.poll(0.0)
        self.engine.tick()
        self.ticked = self._applied_submits()
        wm = self._watermark()
        total = 1 + len(self.values)  # the add frame + every submit
        if wm != total:
            self._flag(
                "complete",
                f"resolved prefix ends at {wm}, stream has {total} frames — "
                "a hole in the contiguous pseq prefix survived the quiesce",
            )
        self._check_aggregate()
        self.violations.extend(f"serialized: {v}" for v in self.probe.violations)

    def close(self) -> None:
        try:
            self.producer.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            self.server.close()
        except Exception:  # noqa: BLE001
            pass


# ----------------------------------------------------------------- schedules
def _schedules(target: int) -> List[Tuple[str, ...]]:
    """Deterministic schedule set: exhaustive + adversarial + seeded-random."""
    out: List[Tuple[str, ...]] = []
    seen: Set[Tuple[str, ...]] = set()

    def add(s: Sequence[str]) -> None:
        t = tuple(s)
        if t not in seen:
            seen.add(t)
            out.append(t)

    # bounded exhaustive over the base multiset
    for perm in itertools.permutations(_BASE_SCHEDULE):
        add(perm)
    # adversarial: a kill-point at every position of the canonical flow
    for i in range(1, len(_CANONICAL) + 1):
        add(_CANONICAL[:i] + ("kill",) + _CANONICAL[i:])
    add(("kill",) + _CANONICAL)                     # crash before first byte
    add(_CANONICAL[:3] + ("kill", "kill") + _CANONICAL[3:])  # double crash
    add(("ingest", "poll", "autonomic", "autonomic", "tick", "autonomic", "aggregate"))
    add(("ingest", "ingest", "ingest", "poll", "kill", "poll", "tick", "aggregate"))
    # seeded-random beyond: longer schedules, rare kills riding along
    rng = random.Random(_SEED)
    while len(out) < target:
        add(tuple(rng.choice(_RANDOM_ALPHABET) for _ in range(_RANDOM_LEN)))
    return out


def _run_schedule(schedule: Tuple[str, ...], tmpdir: str, device: Device) -> List[str]:
    rig = _Rig(tmpdir, device)
    try:
        for seg in schedule:
            rig.segment(seg)
        rig.finish()
    except Exception as exc:  # noqa: BLE001 - a crash IS an ordering violation
        rig.violations.append(f"crash: {type(exc).__name__}: {exc}")
    finally:
        rig.close()
    return rig.violations


def explore_schedules(target: int = DEFAULT_TARGET_SCHEDULES, device: Device = "cuda") -> Dict[str, Any]:
    """Run the full exploration on ``device``; returns schedules explored + violations found."""
    from metrics_tpu_torch import observe

    schedules = _schedules(target)
    violations: Dict[str, int] = {}
    details: List[str] = []
    t0 = time.perf_counter()
    with observe.scope(reset=True):
        for schedule in schedules:
            tmpdir = tempfile.mkdtemp(prefix="interleave-")
            try:
                for v in _run_schedule(schedule, tmpdir, device):
                    kind = v.split(":", 1)[0]
                    key = f"{kind}::{'-'.join(schedule)}"
                    violations[key] = violations.get(key, 0) + 1
                    if len(details) < 32:
                        details.append(f"[{'-'.join(schedule)}] {v}")
            finally:
                shutil.rmtree(tmpdir, ignore_errors=True)
    return {
        "schedules_explored": len(schedules),
        "violations": violations,
        "details": details,
        "wall_s": round(time.perf_counter() - t0, 3),
    }


# ----------------------------------------------------------------- the pass
def run_interleave_check(
    root: str,
    baseline_path: Optional[str] = None,
    update_baseline: bool = False,
    quiet: bool = False,
    report: Optional[Dict[str, Any]] = None,
    target_schedules: int = DEFAULT_TARGET_SCHEDULES,
    device: Device = "cuda",
) -> int:
    """The ``interleave`` pass: explore, assert, one verdict."""
    from metrics_tpu_torch.analysis.engine import load_baseline_section, write_baseline_section

    path = baseline_path or DEFAULT_BASELINE
    results = explore_schedules(target_schedules, device)
    violations: Dict[str, int] = results["violations"]
    if update_baseline:
        write_baseline_section(
            path, _SECTION, dict(sorted(violations.items())),
            "racelint baseline: concurrency and ordering violations keyed path::rule::context (`rules`) and "
            "schedule-exploration disagreements (`interleave`). Both stay empty: an ordering bug is fixed or "
            "annotated (`# racelint: single-writer`, `# racelint: disable=RC00N`), never baselined.",
            seed={"rules": {}},
        )
        if not quiet:
            print(f"interleave: baseline written to {path} ({len(violations)} key(s))")
        return 0
    baseline = load_baseline_section(path, _SECTION)
    new = {k: n for k, n in violations.items() if n > int(baseline.get(k, 0) or 0)}
    stale = sorted(k for k in baseline if k not in violations)
    if report is not None:
        report.update(
            {
                "schedules_explored": results["schedules_explored"],
                "violations": violations,
                "new": new,
                "details": results["details"],
                "stale_baseline_keys": stale,
                "explore_wall_s": results["wall_s"],
            }
        )
        return 1 if new else 0
    for d in results["details"]:
        print(f"interleave: {d}")
    if not quiet:
        for key in stale:
            print(f"interleave: stale baseline entry: {key}")
        print(
            f"interleave: {results['schedules_explored']} distinct schedules, "
            f"{sum(violations.values())} violation(s) ({len(new)} new), "
            f"{len(stale)} stale, {results['wall_s']}s"
        )
    return 1 if new else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="interleave-contracts",
        description="Drive the real server/engine/autonomic stack through permuted "
        "and adversarial segment interleavings, asserting the ordering invariants "
        "racelint claims statically.",
    )
    p.add_argument("--baseline", default=None, help="racelint baseline JSON path")
    p.add_argument("--update-baseline", action="store_true",
                   help="record current disagreements as the new baseline and exit 0")
    p.add_argument("--target", type=int, default=DEFAULT_TARGET_SCHEDULES,
                   help="distinct schedules to explore (default %(default)s)")
    p.add_argument("--device", default="cuda", help="where the sessions live (default: the card)")
    p.add_argument("-q", "--quiet", action="store_true", help="suppress the summary line")
    args = p.parse_args(argv)
    return run_interleave_check(os.getcwd(), baseline_path=args.baseline, update_baseline=args.update_baseline,
                                quiet=args.quiet, target_schedules=args.target, device=args.device)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
