"""Dynamic fleet-contract harness: every registry class through a churning bucket (counterpart of
``metrics_tpu/analysis/fleet_contracts.py``).

For every jit-eligible class of the profile registry this drives a 4-slot ``StreamEngine`` bucket on the
metrics' device through the multi-tenant lifecycle and holds the engine's rows against per-instance oracle
metrics fed the same batches:

* **churn**: a session expired mid-stream computes like its oracle;
* **masked rows**: a session that submits nothing in a tick keeps its row (and the padded virgin row)
  bit-identical;
* **checkpoint**: ``checkpoint()`` then ``StreamEngine.restore`` lands every live row bit-exactly;
* **merge**: two expired engine-resident states merged via ``merge_state`` agree with the same merge of
  their oracles;
* **values**: final live states are bit-identical and computes agree.

Verdicts: ``EXACT`` (states and computes bit-identical), ``CLOSE`` (states bit-identical, computes within
float tolerance; on a CUDA device a float state too, since a reduction batched under ``vmap`` may associate
its sum otherwise than the eager one, which :func:`eager_vs_bucket_gap` measures), ``LOOSE`` (the class never
formed a bucket and its eager sessions agree), ``DIVERGED``, ``ERROR:<why>``. The JAX package's donation leg has nothing to test: the port donates no buffer (an update
replaces its tensor states), so every result reports ``donation=n/a``. On a CUDA device the bucket's kernels
(B1, B2) launch through their custom ops' ``vmap`` rules. ``DIVERGED``/``ERROR`` fail unless baselined in the
``fleet`` section of ``metrics_tpu_torch/analysis/baselines/fleet_baseline.json`` (expected empty).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "FleetResult",
    "check_fleet_case",
    "diff_fleet_contract_baseline",
    "fleet_cases",
    "main",
    "run_fleet_check",
]

Device = Union[str, torch.device]
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baselines", "fleet_baseline.json")
_CAPACITY = 4  # 3 live sessions + 1 padded virgin row
_RTOL, _ATOL = 1e-5, 1e-7


@dataclasses.dataclass(frozen=True)
class FleetResult:
    name: str
    verdict: str  # EXACT | CLOSE | LOOSE | DIVERGED | ERROR:<why>
    donation: str  # n/a: the port donates nothing
    detail: str = ""

    @property
    def ok(self) -> bool:
        return self.verdict in ("EXACT", "CLOSE", "LOOSE")

    def render(self) -> str:
        mark = "ok " if self.ok else "FAIL"
        return f"{mark} {self.name}: {self.verdict} donation={self.donation}" + (f" ({self.detail})" if self.detail else "")


def fleet_cases() -> List[Any]:
    """The jit-eligible slice of the profile registry (the transfer contract's)."""
    from metrics_tpu_torch.analysis.transfer_contracts import transfer_cases

    return transfer_cases()


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(value: Any) -> List[Any]:
    from torch.utils._pytree import tree_leaves

    return tree_leaves(value)


def _compare(a: Any, b: Any) -> str:
    """'' if the trees are bit-identical, 'close' within tolerance, 'diverged' else."""
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return "diverged"
    worst = ""
    for x, y in zip(la, lb):
        xa, ya = _host(x), _host(y)
        if xa.shape != ya.shape:
            return "diverged"
        if np.array_equal(xa, ya, equal_nan=xa.dtype.kind in "fc"):
            continue
        if np.allclose(xa.astype(np.float64), ya.astype(np.float64), rtol=_RTOL, atol=_ATOL, equal_nan=True):
            worst = "close"
        else:
            return "diverged"
    return worst


def _row(engine: Any, sid: Any) -> Dict[str, Any]:
    """A session's engine-resident state, wherever it lives right now."""
    sess = engine._sessions[sid]
    if sess.bucket is None:
        return dict(sess.metric._state)
    return {k: v[sess.slot] for k, v in sess.bucket.stacked.items()}


def eager_vs_bucket_gap(case: Any, device: Device = "cuda") -> Dict[str, Dict[str, float]]:
    """The witness of the CUDA tolerance here and in the chaos contract's poison row: the ticks of
    :func:`check_fleet_case` (the same batches, the masked tick, the recycled slot) through a 4-slot bucket's
    vmapped update and through eager updates of per-session metrics. After each tick, for each state, the
    largest gap between a live bucket row and its eager twin, relative to the eager state's largest
    magnitude; 0.0 is bit-identical."""
    from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE
    from metrics_tpu_torch.engine.stream import StreamEngine
    from metrics_tpu_torch.observe.costs import _rng

    _FLEET_JIT_CACHE.clear()
    rng = _rng(case)
    engine = StreamEngine(initial_capacity=_CAPACITY)
    sids = [engine.add_session(case.ctor(device)) for _ in range(3)]
    if engine._sessions[sids[0]].bucket is None:
        raise ValueError(f"{case.name} forms no bucket: there is no vmapped update to compare")
    eager = {sid: case.ctor(device) for sid in sids}
    out: Dict[str, Dict[str, float]] = {}

    def feed(label: str, active: Sequence[Any], live: Sequence[Any]) -> None:
        for sid in active:
            args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in case.batch(rng))
            engine.submit(sid, *args)
            eager[sid].update(*args)
        engine.tick()
        gaps = out.setdefault(label, {})
        for sid in live:
            row = _row(engine, sid)
            for k, ref in eager[sid]._state.items():
                for x, y in zip(_leaves(row[k]), _leaves(ref)):
                    got, want = _host(x).astype(np.float64), _host(y).astype(np.float64)
                    both_nan = np.isnan(got) & np.isnan(want)
                    diff = np.where(both_nan, 0.0, np.abs(got - want))
                    scale = np.where(both_nan, 0.0, np.abs(want))
                    gap = float(diff.max() / max(scale.max(), 1e-30)) if diff.size else 0.0
                    gaps[k] = max(gaps.get(k, 0.0), gap)

    feed("tick 1", sids, sids)
    feed("tick 2", sids, sids)
    feed("tick 3, masked", [sids[0], sids[2]], sids)
    engine.expire(sids[1])
    replacement = engine.add_session(case.ctor(device))
    eager[replacement] = case.ctor(device)
    live = [sids[0], sids[2], replacement]
    feed("tick 4, recycled slot", live, live)
    return out


def check_fleet_case(case: Any, device: Device = "cuda") -> FleetResult:
    """One class through the churning 4-slot bucket; never raises."""
    from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE
    from metrics_tpu_torch.engine.stream import StreamEngine
    from metrics_tpu_torch.observe.costs import _rng

    _FLEET_JIT_CACHE.clear()
    donation = "n/a"
    try:
        rng = _rng(case)
        engine = StreamEngine(initial_capacity=_CAPACITY)
        sids = [engine.add_session(case.ctor(device)) for _ in range(3)]
        oracles = {sid: case.ctor(device) for sid in sids}

        def feed(active: Sequence[Any]) -> None:
            for sid in active:
                args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in case.batch(rng))
                engine.submit(sid, *args)
                oracles[sid].update(*args)
            engine.tick()

        feed(sids)  # tick 1: builds the programs
        feed(sids)  # tick 2: steady state
        bucketed = engine._sessions[sids[0]].bucket is not None

        # masked rows: sids[1] sits a tick out; its row and the padded virgin row come through bit-identical
        idle = sids[1]
        before_idle = {k: _host(v) for k, v in _row(engine, idle).items()}
        before_virgin, free_slot = None, None
        if bucketed:
            bucket = engine._sessions[sids[0]].bucket
            free_slot = bucket.free[-1] if bucket.free else None
            if free_slot is not None:
                before_virgin = {k: _host(v[free_slot]) for k, v in bucket.stacked.items()}
        feed([sids[0], sids[2]])  # tick 3: masked flush
        after_idle = {k: _host(v) for k, v in _row(engine, idle).items()}
        for k, ref in before_idle.items():
            if not np.array_equal(after_idle[k], ref, equal_nan=ref.dtype.kind in "fc"):
                return FleetResult(case.name, "DIVERGED", donation, f"masked row mutated: state '{k}'")
        if before_virgin is not None:
            bucket = engine._sessions[sids[0]].bucket
            for k, ref in before_virgin.items():
                if not np.array_equal(_host(bucket.stacked[k][free_slot]), ref, equal_nan=ref.dtype.kind in "fc"):
                    return FleetResult(case.name, "DIVERGED", donation, f"padded virgin row mutated: state '{k}'")

        # churn: expire mid-stream, check the retiree, recycle its slot
        retired = engine.expire(idle)
        churn_cmp = _compare(retired.compute(), oracles[idle].compute())
        if churn_cmp == "diverged":
            return FleetResult(case.name, "DIVERGED", donation, "expired session diverged from oracle")
        replacement = engine.add_session(case.ctor(device))
        oracles[replacement] = case.ctor(device)
        live = [sids[0], sids[2], replacement]
        feed(live)  # tick 4: the recycled slot in the masked dispatch

        # values: engine-resident states bit-exact (a float state within tolerance on a CUDA device, where a
        # batched sum may associate otherwise than the eager one), computes agree
        verdict = "EXACT" if not churn_cmp else "CLOSE"
        detail = ""
        for sid in live:
            row = _row(engine, sid)
            for k, ref in oracles[sid]._state.items():
                cmp = _compare(row[k], ref)
                if cmp == "close" and torch.device(device).type == "cuda" and ref.is_floating_point():
                    verdict = "CLOSE"
                    gap = float((row[k].double() - ref.double()).abs().max()
                                / ref.double().abs().max().clamp_min(1e-30))
                    detail = f"state '{k}' within tolerance (max relative gap {gap:.1e})"
                elif cmp != "":
                    return FleetResult(case.name, "DIVERGED", donation,
                                       f"live state '{k}' diverged from oracle (session {sid})")
            cmp = _compare(engine.compute(sid), oracles[sid].compute())
            if cmp == "diverged":
                return FleetResult(case.name, "DIVERGED", donation, f"live compute diverged (session {sid})")
            if cmp == "close":
                verdict = "CLOSE"

        # durability: a checkpoint -> restore round trip lands every live row bit-exactly
        with tempfile.TemporaryDirectory(prefix="fleet_ckpt_") as tmp:
            ckpt = os.path.join(tmp, "fleet.ckpt")
            engine.checkpoint(ckpt)
            restored = StreamEngine.restore(ckpt, device=device)
            for sid in live:
                for k, ref in _row(engine, sid).items():
                    if _compare(_row(restored, sid)[k], ref) != "":
                        return FleetResult(case.name, "DIVERGED", donation,
                                           f"checkpoint round-trip drifted: state '{k}' (session {sid})")

        # merge: two expired engine-resident states against the same merge of their oracles
        m_a, m_b = engine.expire(sids[0]), engine.expire(sids[2])
        o_a, o_b = oracles[sids[0]], oracles[sids[2]]
        merge_detail = ""
        try:
            o_a.merge_state(o_b)
        except Exception as exc:  # noqa: BLE001 — merge unsupported: merge_contracts' turf
            merge_detail = f"merge skipped ({type(exc).__name__})"
        else:
            m_a.merge_state(m_b)
            merge_cmp = _compare(m_a.compute(), o_a.compute())
            if merge_cmp == "diverged":
                return FleetResult(case.name, "DIVERGED", donation, "merged engine-resident states diverged")
            if merge_cmp == "close":
                verdict = "CLOSE"
        if not bucketed:
            verdict = "LOOSE"
        return FleetResult(case.name, verdict, donation, "; ".join(d for d in (detail, merge_detail) if d))
    except Exception as exc:  # noqa: BLE001 — every failure is a reportable verdict
        return FleetResult(case.name, f"ERROR:{type(exc).__name__}", donation, str(exc)[:200])
    finally:
        _FLEET_JIT_CACHE.clear()


def collect_fleet_report(cases: Optional[Sequence[Any]] = None, device: Device = "cuda") -> List[FleetResult]:
    return [check_fleet_case(c, device) for c in (cases if cases is not None else fleet_cases())]


# ------------------------------------------------------------------- baseline
def load_fleet_contract_baseline(path: str) -> Dict[str, str]:
    from metrics_tpu_torch.analysis.engine import load_baseline_section

    return {str(k): str(v) for k, v in load_baseline_section(path, "fleet").items()}


def write_fleet_contract_baseline(path: str, results: Sequence[FleetResult]) -> Dict[str, str]:
    from metrics_tpu_torch.analysis.engine import write_baseline_section

    fleet = {
        r.name: f"UNJUSTIFIED: {r.verdict} donation={r.donation}"
        for r in sorted(results, key=lambda r: r.name)
        if not r.ok
    }
    write_baseline_section(
        path, "fleet", fleet,  # type: ignore[arg-type]
        "fleet-contract baseline: StreamEngine lifecycle disagreements (class -> justification; expected "
        "empty). Regenerate with `python -m metrics_tpu_torch.analysis.cli --pass fleet --update-baseline`.",
    )
    return fleet


def diff_fleet_contract_baseline(
    results: Sequence[FleetResult], baseline: Dict[str, str]
) -> Tuple[List[FleetResult], List[str]]:
    """Split into (failures, stale_baseline_keys): unbaselined disagreements fail."""
    failures = [r for r in results if not r.ok and r.name not in baseline]
    failing = {r.name for r in results if not r.ok}
    observed = {r.name for r in results}
    stale = sorted(name for name in baseline if name not in failing or name not in observed)
    return failures, stale


def run_fleet_check(
    root: str,
    baseline_path: Optional[str] = None,
    update_baseline: bool = False,
    quiet: bool = False,
    report: Optional[Dict[str, Any]] = None,
    device: Device = "cuda",
) -> int:
    """The ``fleet`` pass: churn every class, one verdict."""
    path = baseline_path or DEFAULT_BASELINE
    results = collect_fleet_report(device=device)
    if update_baseline:
        fleet = write_fleet_contract_baseline(path, results)
        if not quiet:
            print(f"fleet: baseline written to {path} ({len(fleet)} disagreement(s))")
        return 0
    failures, stale = diff_fleet_contract_baseline(results, load_fleet_contract_baseline(path))
    if report is not None:
        report.update({
            "cases": len(results),
            "failures": [r.render() for r in failures],
            "baselined": sum(1 for r in results if not r.ok) - len(failures),
            "stale_baseline_keys": stale,
            "verdicts": {r.name: r.verdict for r in results},
        })
        return 1 if failures else 0
    for r in failures:
        print(f"fleet: {r.render()}")
    if not quiet:
        for key in stale:
            print(f"fleet: stale baseline entry: {key}")
        exact = sum(1 for r in results if r.verdict == "EXACT")
        loose = sum(1 for r in results if r.verdict == "LOOSE")
        print(f"fleet: {sum(1 for r in results if r.ok)}/{len(results)} classes agree ({exact} exact, {loose} "
              f"loose), {len(failures)} failure(s), {len(stale)} stale")
    return 1 if failures else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="fleet-contracts", description=__doc__.splitlines()[0])
    p.add_argument("--baseline", default=None, help="fleet baseline JSON path")
    p.add_argument("--update-baseline", action="store_true")
    p.add_argument("--device", default="cuda", help="where the buckets live (default: the card)")
    p.add_argument("-v", "--verbose", action="store_true", help="print every class verdict")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    if args.verbose:
        for r in collect_fleet_report(device=args.device):
            print(r.render())
    return run_fleet_check(os.getcwd(), baseline_path=args.baseline, update_baseline=args.update_baseline,
                           quiet=args.quiet, device=args.device)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
