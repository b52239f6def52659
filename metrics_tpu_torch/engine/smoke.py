"""Small-fleet smoke: 64 churning streams, ratcheted dispatch economics (counterpart of
``metrics_tpu/engine/smoke.py``).

The StreamEngine's whole value is a pair of invariants that are easy to break
silently: a bucketing-key regression splits one bucket into many dispatches;
a cache-key regression builds a program on every arrival. This module runs a small
heterogeneous fleet (MulticlassAccuracy + BinaryAUROC streams, mid-run churn)
under a private telemetry probe and reduces it to the numbers a baseline file
pins in its ``fleet`` section (the caller names the file):

* ``dispatches_per_shard_tick``: update dispatches over ticks; 1.0 means a
  whole shard's tick (every touched bucket, every wave) ran as exactly ONE
  call of the fused program;
* ``update_compiles``: total update programs built; 1 means the fused
  program was built once and arrival/expiry churn within padded capacity never
  built another;
* ``poll_dispatches_per_poll``: compute dispatches per ``compute_all`` poll;
  0.0 means every dashboard poll was answered from the incremental-fold caches
  the fused tick maintains, never by a compute dispatch;
* ``bit_exact``: every stream's accumulated *state* (live and expired) is
  bit-identical to a per-instance oracle metric fed the identical batches,
  expired streams' computed values are bit-identical too (they compute on
  their own sliced rows), and live computed values agree to float ulp (the
  bucket-wide vmapped compute may reassociate float reductions).

``device`` runs the fleet and its oracles there: the metrics' own default
(``"cuda"``, which raises without a card) when omitted; pass ``device="cpu"``
to run it on the CPU.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE
from metrics_tpu_torch.engine.stream import StreamEngine
from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.observe import recorder as rec_mod
from metrics_tpu_torch.analysis.engine import load_baseline_section, write_baseline_section

__all__ = [
    "diff_fleet_baseline",
    "load_fleet_baseline",
    "run_fleet_smoke",
    "write_fleet_baseline",
]

_RATCHETED_MAX = (
    "dispatches_per_shard_tick",
    "update_compiles",
    "poll_dispatches_per_poll",
)


def _stream_ctors(device: torch.device) -> List[Tuple[str, Any, Any]]:
    """(kind, metric ctor, batch fn) per heterogeneous stream family; the batches are tensors on ``device``."""
    from metrics_tpu_torch.classification import BinaryAUROC, MulticlassAccuracy

    def acc_batch(rng: np.random.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.from_numpy(rng.integers(0, 8, size=32)).to(device),
                torch.from_numpy(rng.integers(0, 8, size=32)).to(device))

    def auroc_batch(rng: np.random.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.from_numpy(rng.random(32, dtype=np.float32)).to(device),
                torch.from_numpy(rng.integers(0, 2, size=32)).to(device))

    return [
        ("acc", lambda: MulticlassAccuracy(num_classes=8, device=device), acc_batch),
        ("auroc", lambda: BinaryAUROC(thresholds=16, device=device), auroc_batch),
    ]


def run_fleet_smoke(
    n_streams: int = 64,
    ticks: int = 6,
    churn: int = 8,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Any]:
    """Drive the smoke fleet and return its observed dispatch economics.

    Runs under a private Recorder (the process-wide telemetry state is saved
    and restored), with the fleet program cache cleared so compile counts
    start from zero.
    """
    families = _stream_ctors(resolve_device(device))
    per_family = n_streams // len(families)
    # capacity sized so churn stays within the padded stack: the smoke pins
    # the zero-recompile claim, not the growth path (tests cover doubling)
    capacity = 1 << (per_family - 1).bit_length()
    rng = np.random.default_rng(seed)

    saved_enabled, saved_recorder = rec_mod.ENABLED, rec_mod.RECORDER
    probe = rec_mod.Recorder()
    rec_mod.RECORDER, rec_mod.ENABLED = probe, True
    _FLEET_JIT_CACHE.clear()
    try:
        engine = StreamEngine(initial_capacity=capacity)
        oracles: Dict[Any, Any] = {}
        batchers: Dict[Any, Any] = {}
        kinds: Dict[Any, str] = {}
        retired_exact = True
        for kind, ctor, batch in families:
            for _ in range(per_family):
                sid = engine.add_session(ctor())
                oracles[sid] = ctor()
                batchers[sid] = batch
                kinds[sid] = kind
        next_family = 0
        polls = 0
        for t in range(ticks):
            for sid in list(oracles):
                args = batchers[sid](rng)
                engine.submit(sid, *args)
                oracles[sid].update(*args)
            engine.tick()
            # the 1 Hz dashboard poll: must ride the fold caches the fused
            # tick maintains, never a device compute dispatch
            engine.compute_all()
            polls += 1
            if t == ticks // 2:
                # mid-run churn: retire `churn` sessions round-robin across the
                # families (so no bucket outgrows its padded capacity — the
                # smoke pins zero-recompile churn), verify the retirees against
                # their oracles, and arrive replacements into the holes
                by_kind = {k: [s for s in oracles if kinds[s] == k] for k, _, _ in families}
                doomed: List[Any] = []
                while len(doomed) < churn:
                    pool = by_kind[families[len(doomed) % len(families)][0]]
                    doomed.append(pool.pop(0))
                for sid in doomed:
                    retired = engine.expire(sid)
                    if not torch.equal(retired.compute().cpu(), oracles[sid].compute().cpu()):
                        retired_exact = False
                    del oracles[sid], batchers[sid], kinds[sid]
                for _ in range(churn):
                    kind, ctor, batch = families[next_family % len(families)]
                    next_family += 1
                    sid = engine.add_session(ctor())
                    oracles[sid] = ctor()
                    batchers[sid] = batch
                    kinds[sid] = kind
        values = engine.compute_all()
        polls += 1
        # steady-state poll latency (informational, not ratcheted: wall clock):
        # nothing changed since the last poll, so this is the pure cached path
        t0 = time.perf_counter()
        engine.compute_all()
        poll_ms = (time.perf_counter() - t0) * 1000.0
        polls += 1
        live_exact = True
        for sid, oracle in oracles.items():
            sess = engine._sessions[sid]
            row = (
                sess.metric._state
                if sess.bucket is None
                else {k: v[sess.slot] for k, v in sess.bucket.stacked.items()}
            )
            for k, ref in oracle._state.items():
                if not torch.equal(row[k].cpu(), ref.cpu()):
                    live_exact = False
            if not torch.allclose(values[sid].cpu(), oracle.compute().cpu(), rtol=1e-6, atol=0.0):
                live_exact = False
        counters: Dict[str, Dict[str, int]] = {}
        for (name, label), v in probe.counters.items():
            counters.setdefault(name, {})[label] = v
    finally:
        rec_mod.RECORDER, rec_mod.ENABLED = saved_recorder, saved_enabled
        _FLEET_JIT_CACHE.clear()

    update_compiles = {
        label: v for label, v in counters.get("fleet_compile", {}).items() if not label.endswith(":compute")
    }
    n_buckets = len(counters.get("fleet_flush", {}))
    dispatches = sum(counters.get("fleet_dispatch", {}).values())
    compute_dispatches = sum(counters.get("fleet_compute_dispatch", {}).values())
    return {
        "streams": n_streams,
        "buckets": n_buckets,
        "ticks": ticks,
        "churn": churn,
        "dispatches_per_shard_tick": round(dispatches / ticks, 4) if ticks else None,
        "update_compiles": sum(update_compiles.values()),
        "poll_dispatches_per_poll": round(compute_dispatches / polls, 4) if polls else None,
        "poll_latency_ms": round(poll_ms, 3),
        "loose_updates": sum(counters.get("fleet_loose_update", {}).values()),
        "fused_fallbacks": sum(counters.get("fleet_fused_fallback", {}).values()),
        "bit_exact": bool(live_exact and retired_exact),
    }


# ------------------------------------------------------------------ baseline IO
# The file format is the JAX package's (``analysis/engine.py`` in both packages): one JSON object,
# a top-level "comment" and one object per section; a write rewrites its own section and keeps every sibling.
def load_fleet_baseline(path: str) -> Dict[str, Any]:
    """The ``fleet`` section of the baseline file at ``path`` ({} when the file or section is missing)."""
    return load_baseline_section(path, "fleet")


def write_fleet_baseline(path: str, observed: Dict[str, Any]) -> Dict[str, Any]:
    """Pin ``observed``'s ratcheted numbers as the ``fleet`` section of the baseline file at ``path``."""
    pinned = {k: observed[k] for k in ("streams", "buckets", *_RATCHETED_MAX)}
    return write_baseline_section(
        path, "fleet", pinned,
        "fleet-engine dispatch economy ('fleet'), pinned by metrics_tpu_torch.engine.smoke.write_fleet_baseline")


def diff_fleet_baseline(observed: Dict[str, Any], baseline: Dict[str, Any]) -> Tuple[List[str], List[str], List[str]]:
    """(regressions, stale, new) for the fleet smoke, mirroring the cost ratchet."""
    regressions: List[str] = []
    stale: List[str] = []
    new: List[str] = []
    if not observed.get("bit_exact", False):
        regressions.append("fleet: smoke fleet diverged from the per-instance oracle")
    if observed.get("loose_updates", 0):
        regressions.append(
            f"fleet: {observed['loose_updates']} update(s) fell off the bucketed path "
            "(sessions demoted to loose eager metrics)"
        )
    if observed.get("fused_fallbacks", 0):
        regressions.append(
            f"fleet: {observed['fused_fallbacks']} fused dispatch(es) fell back to "
            "per-bucket programs (the one-program tick failed to trace or run)"
        )
    if not baseline:
        new.append("fleet: no baseline section (record with --update-baseline)")
        return regressions, stale, new
    for field in _RATCHETED_MAX:
        cur, ref = observed.get(field), baseline.get(field)
        if cur is None:
            regressions.append(f"fleet: {field} unobserved (no bucket was ever flushed)")
        elif ref is not None and float(cur) > float(ref) + 1e-9:
            regressions.append(f"fleet: {field} {cur} > baseline {ref}")
        elif ref is not None and float(cur) < float(ref) - 1e-9:
            stale.append(f"fleet: {field} improved {ref} -> {cur}; ratchet the baseline down")
    return regressions, stale, new
