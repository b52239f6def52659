"""Serve front-door smoke (counterpart of ``metrics_tpu/serve/smoke.py``): loopback producer, 100 sessions,
one forced overload→shed→recover cycle.

One real TCP loopback connection drives the whole MTWAL001 story end to end:
handshake + auth, credit-window pumping, per-record acks, write-ahead
journaling with fsync-before-ack, and watermark dedup on an intentional
resend. The overload leg swaps in an admission table whose shed row trips at
occupancy 0%, proves the loose-first shed actually evicted loose sessions
(``status="ok"`` still — shed admits the arrival after making room), then
restores the default table and proves a fresh arrival is plainly accepted.

Exit code 0 with a one-line JSON verdict on stdout; 1 with the failing
checks named. Runs under a private telemetry probe, so the process-wide
recorder is untouched. ``device`` runs the engine and its metrics there: the
card when omitted (raising without one); pass ``device="cpu"`` to run it on
the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE
from metrics_tpu_torch.engine.stream import StreamEngine
from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.observe import recorder as rec_mod
from metrics_tpu_torch.serve.admission import AdmissionController, AdmissionRule, DEFAULT_ADMISSION_TABLE
from metrics_tpu_torch.serve.autonomic import AutonomicController
from metrics_tpu_torch.serve.protocol import Producer, encode_frame
from metrics_tpu_torch.serve.server import MetricsServer

__all__ = ["run_serve_smoke"]

_SHED_TABLE = (AdmissionRule("forced_overload", "occupancy_pct", ">=", 0.0, "shed", None),)


def run_serve_smoke(
    n_sessions: int = 100,
    n_loose: int = 4,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Any]:
    """Drive the loopback smoke; returns observed numbers plus failed checks."""
    from metrics_tpu_torch.classification.accuracy import MulticlassAccuracy

    device = resolve_device(device)

    def new_metric() -> MulticlassAccuracy:
        return MulticlassAccuracy(num_classes=8, device=device)

    rng = np.random.default_rng(seed)
    failures: List[str] = []
    saved_enabled, saved_recorder = rec_mod.ENABLED, rec_mod.RECORDER
    probe = rec_mod.Recorder()
    rec_mod.RECORDER, rec_mod.ENABLED = probe, True
    _FLEET_JIT_CACHE.clear()
    try:
        with tempfile.TemporaryDirectory() as td:
            engine = StreamEngine(
                initial_capacity=max(8, n_sessions), wal_path=os.path.join(td, "serve.wal")
            )
            autonomic = AutonomicController(engine, min_interval_s={"shed": 0.0})
            server = MetricsServer(engine, "smoke-key", host="127.0.0.1", autonomic=autonomic, device=device)
            prod = Producer(
                server.address, "smoke-key", name="smoke-producer",
                drive=lambda _t=None: server.poll(0.0),
            )
            prod.pump()

            # steady intake: n_sessions arrivals, two submit waves, two ticks
            for i in range(n_sessions):
                prod.add_session(new_metric(), session_id=f"s{i}")
            prod.flush(20.0)
            for _ in range(2):
                for i in range(n_sessions):
                    n = int(rng.integers(4, 16))
                    prod.submit(f"s{i}", rng.integers(0, 8, n), rng.integers(0, 8, n))
                prod.flush(20.0)
                server.tick()
            if prod.errors:
                failures.append(f"steady-state errors: {prod.errors[:3]}")
            if len(engine) != n_sessions:
                failures.append(f"engine holds {len(engine)} sessions, expected {n_sessions}")

            # watermark dedup: replay an already-acked pseq (dedup consults the
            # watermark before admission or apply, so the payload is irrelevant)
            prod._send_raw(encode_frame("submit", 1, "s0", ((), {})))
            # the frame crosses a socket: poll until it has been read (one pass may find nothing yet)
            deadline = time.monotonic() + 5.0
            while server.dedup_skipped < 1 and time.monotonic() < deadline:
                server.poll(0.05)
            prod.pump()
            if server.dedup_skipped < 1:
                failures.append("resent record was not watermark-deduped")

            # forced overload: demote a few sessions to loose, then swap in a
            # table whose shed row trips on every arrival
            for i in range(n_loose):
                engine._demote_session(engine._sessions[f"s{i}"])
            server.admission = AdmissionController(_SHED_TABLE)
            shed_before = sum(
                v for (name, _l), v in probe.counters.items() if name == "serve_shed_sessions"
            )
            prod.add_session(new_metric(), session_id="overload-arrival")
            prod.flush(20.0)
            shed_after = sum(
                v for (name, _l), v in probe.counters.items() if name == "serve_shed_sessions"
            )
            if shed_after <= shed_before:
                failures.append("forced overload shed no loose sessions")
            if "overload-arrival" not in engine._sessions:
                failures.append("shed verdict failed to admit the arrival after making room")

            # recover: default table back, a fresh arrival is plainly accepted
            server.admission = AdmissionController(DEFAULT_ADMISSION_TABLE)
            prod.add_session(new_metric(), session_id="recovered-arrival")
            prod.flush(20.0)
            server.tick()
            if server.admission.counts["accept"] < 1:
                failures.append("post-recovery arrival was not accepted")
            if prod.outstanding:
                failures.append(f"{prod.outstanding} records never acked")

            result = {
                "sessions": len(engine),
                "frames_total": server.frames_total,
                "bytes_in_total": server.bytes_in_total,
                "dedup_skipped": server.dedup_skipped,
                "protocol_errors": server.protocol_errors,
                "shed_sessions": int(shed_after),
                "acked": prod.acked,
                "wal_lag_records": engine.stats()["wal_lag_records"],
                "failures": failures,
                "ok": not failures,
            }
            prod.close()
            server.close()
            return result
    finally:
        rec_mod.RECORDER, rec_mod.ENABLED = saved_recorder, saved_enabled
        _FLEET_JIT_CACHE.clear()


def main() -> int:
    result = run_serve_smoke()
    print(json.dumps(result, sort_keys=True))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
