"""Dynamic transfer-contract harness: hotlint's verdicts, proven under a guard (counterpart of
``metrics_tpu/analysis/transfer_contracts.py``).

For every jit-eligible class of the profile registry this runs a steady-state update loop under a guard and
cross-checks three verdicts on one question: *does this class's steady update loop read the card on the
host?*

1. **static**: :func:`metrics_tpu_torch.analysis.sync_rules.classify_transfers`, read off the update path's
   source (the class bodies and the package functions they call);
2. **declared**: ``Metric._jit_eligible``, the class's claim that its update may run batched under
   ``torch.func.vmap`` in the fleet engine;
3. **runtime**: what happened after one warm-up update, with the batches already on the metric's device:
   * on a CUDA device, ``torch.cuda.set_sync_debug_mode("error")``: any synchronizing call raises;
   * on the CPU, :class:`HostReadRecorder`, a ``TorchDispatchMode`` that records the ops that would read
     the card on the host (``_local_scalar_dense``, which every ``.item()``/``float()``/``bool()``
     reaches; ``nonzero``, ``unique``, ``bincount``, ``masked_select``, boolean-mask indexing,
     ``repeat_interleave`` without ``output_size``, ``equal``; copies between devices) and the Python-level
     reads (``.tolist()``, ``.numpy()``, ``.cpu()``). It exists to predict the card's verdict.

The verdict is ``CLEAN``, ``TRANSFER:<what>`` or ``ERROR:<why>``; the JAX package's ``EAGER`` (no compiled
step ran) has no counterpart, since every port update is eager. The same guard then goes around the fleet:
a 100-session ``StreamEngine`` steady tick and a ``ShardedStreamEngine`` churn tick, where only the engine's
annotated sites (``engine/stream.py::_transfer_scope``) may read, each lifting the guard for its extent. On
the card that guard records where each sync was called from instead of raising
(``set_sync_debug_mode("warn")``): the engine's fallback ladder would absorb a raise and retry elsewhere.

Disagreements are baselined in the ``transfer`` section of
``metrics_tpu_torch/analysis/baselines/hotlint_baseline.json`` (expected empty).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from collections import Counter
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "TransferResult",
    "check_transfer_case",
    "check_engine_contract",
    "diff_transfer_baseline",
    "transfer_cases",
    "main",
    "run_transfer_check",
]

Device = Union[str, torch.device]
_STEPS = 3  # steady-state guarded updates after the warm-up
_ENGINE_SESSIONS = 100  # the JAX package's fleet size for the engine leg

_SIZE_OPS = frozenset({"nonzero", "argwhere", "unique_dim", "_unique", "_unique2", "unique_consecutive",
                       "masked_select", "bincount", "equal"})
_COPY_OPS = frozenset({"_to_copy", "copy", "_copy_from", "_copy_from_and_resize"})
_MASK_DTYPES = (torch.bool, torch.uint8)


def _tensors(tree: Any) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _host_read(func: Any, args: Sequence[Any], kwargs: Dict[str, Any], out: Any) -> Optional[str]:
    """The name of the host read ``func`` makes on a CUDA device, or None."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]  # the in-place form reads as its op
    if name == "_local_scalar_dense":
        return "item"
    if name in _SIZE_OPS:
        return name
    if name == "repeat_interleave" and func._overloadname == "Tensor" and kwargs.get("output_size") is None:
        return "repeat_interleave"
    if name in ("index", "index_put"):
        indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if any(isinstance(i, torch.Tensor) and i.dtype in _MASK_DTYPES for i in indices or ()):
            return f"{name}(bool mask)"
    if name in _COPY_OPS:
        devices = {t.device for t in _tensors((args, kwargs)) + _tensors(out)}
        if len(devices) > 1:
            return "copy(" + "->".join(sorted(str(d) for d in devices)) + ")"
    return None


class HostReadRecorder(TorchDispatchMode):
    """Records every op (and Python-level read) that would make the host wait for the card, outside the
    sites that :meth:`allow` lifts; installed as the engine's transfer guard while it runs."""

    def __init__(self) -> None:
        super().__init__()
        self.reads: List[str] = []
        self.allowed: Counter = Counter()
        self._depth = 0
        self._saved: Dict[str, Any] = {}

    @contextlib.contextmanager
    def allow(self, site: str) -> Iterator[None]:
        self._depth += 1
        self.allowed[site] += 1
        try:
            yield
        finally:
            self._depth -= 1

    def note(self, what: str) -> None:
        if self._depth == 0:
            self.reads.append(what)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):  # noqa: ANN001
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth == 0:
            what = _host_read(func, args, kwargs, out)
            if what:
                self.reads.append(what)
        return out

    def __enter__(self):
        rec = self
        for meth in ("tolist", "numpy", "cpu"):
            real = getattr(torch.Tensor, meth)
            self._saved[meth] = real

            def wrapped(t, *a, _real=real, _meth=meth, **k):  # noqa: ANN001
                rec.note(_meth)
                return _real(t, *a, **k)

            setattr(torch.Tensor, meth, wrapped)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for meth, real in self._saved.items():
                setattr(torch.Tensor, meth, real)
            self._saved.clear()


def _site_of_warning() -> str:
    """The innermost package frame below the analysis harness: where a sync was called from."""
    import traceback

    frames = [f for f in traceback.extract_stack()[:-2]
              if "metrics_tpu_torch" in f.filename and "/analysis/" not in f.filename]
    return f"{frames[-1].filename.split('metrics_tpu_torch/')[-1]}:{frames[-1].lineno}" if frames else "?"


class CudaSyncGuard:
    """CUDA's sync debug mode for its extent; :meth:`allow` lifts it for an annotated site.

    ``mode="error"`` makes any synchronizing call raise (the class leg: an update's exception propagates).
    ``mode="warn"`` records where each one was called from and lets it run (the engine leg: the engine's
    fallback ladder would absorb a raise and retry elsewhere, so a raise would change what it measures).
    """

    def __init__(self, mode: str = "error") -> None:
        self.mode = mode
        self.allowed: Counter = Counter()
        self.reads: List[str] = []
        self._prev = 0
        self._warnings: Any = None

    @contextlib.contextmanager
    def allow(self, site: str) -> Iterator[None]:
        self.allowed[site] += 1
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    def __enter__(self) -> "CudaSyncGuard":
        import warnings

        torch.cuda.synchronize()
        if self.mode == "warn":
            self._warnings = warnings.catch_warnings()
            self._warnings.__enter__()
            warnings.simplefilter("always")

            def hook(message, category, filename, lineno, file=None, line=None):  # noqa: ANN001
                if "synchronizing" in str(message):
                    self.reads.append(_site_of_warning())

            warnings.showwarning = hook
        self._prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(self.mode)
        return self

    def __exit__(self, *exc: Any) -> None:
        torch.cuda.set_sync_debug_mode(self._prev)
        if self._warnings is not None:
            self._warnings.__exit__(*exc)
            self._warnings = None


@contextlib.contextmanager
def transfer_guard(device: Device, mode: str = "error") -> Iterator[Any]:
    """The runtime leg's guard for ``device`` (``mode`` on a CUDA device: see :class:`CudaSyncGuard`),
    installed as the engine's transfer guard while it runs."""
    import metrics_tpu_torch.engine.stream as stream_mod

    guard: Any = CudaSyncGuard(mode) if torch.device(device).type == "cuda" else HostReadRecorder()
    prev = stream_mod._TRANSFER_GUARD
    stream_mod._TRANSFER_GUARD = guard
    try:
        with guard:
            yield guard
    finally:
        stream_mod._TRANSFER_GUARD = prev


def _verdict(guard: Any, exc: Optional[BaseException]) -> Tuple[str, str]:
    if exc is not None:
        if "synchronizing" in str(exc):
            return "TRANSFER:sync", str(exc)[:200]
        return f"ERROR:{type(exc).__name__}", str(exc)[:200]
    if guard.reads:
        counts = Counter(guard.reads)
        return f"TRANSFER:{guard.reads[0]}", ", ".join(f"{k} x{v}" for k, v in counts.items())
    return "CLEAN", ""


@dataclasses.dataclass(frozen=True)
class TransferResult:
    name: str
    static_clean: bool
    static_detail: str  # hazard list when dirty
    declared: bool  # _jit_eligible
    runtime: str  # CLEAN | TRANSFER:<what> | ERROR:<why>
    agree: bool
    detail: str = ""

    def render(self) -> str:
        mark = "ok " if self.agree else "DISAGREE"
        return (
            f"{mark} {self.name}: static={'clean' if self.static_clean else 'hazard'} "
            f"declared={'eligible' if self.declared else 'ineligible'} runtime={self.runtime}"
            + (f" ({self.detail})" if self.detail else "")
        )


def transfer_cases() -> List[Any]:
    """The jit-eligible slice of the profile registry: no ``__jit_ineligible__`` class, no list state."""
    from metrics_tpu_torch.observe.costs import PROFILE_CASES

    cases = []
    for case in PROFILE_CASES:
        try:
            m = case.ctor("cpu")
        except Exception:  # noqa: BLE001 — a broken ctor is the profiler's problem
            continue
        if type(m).__jit_ineligible__ or m._has_list_state():
            continue
        cases.append(case)
    return cases


def _materialized_batches(case: Any, n: int, device: Device) -> List[Tuple[Any, ...]]:
    """Batches already on ``device``, built outside the guard: uploading the synthetic data is the
    fixture's transfer, not the subject's."""
    from metrics_tpu_torch.observe.costs import _rng

    rng = _rng(case)
    out = [tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in case.batch(rng)) for _ in range(n)]
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out


def _agreement(static_clean: bool, declared: bool, runtime: str) -> bool:
    if runtime.startswith("ERROR"):
        return False
    if not declared:
        return True  # an update that never runs batched may read the host
    if static_clean:
        return runtime == "CLEAN"
    return runtime.startswith("TRANSFER")


def check_transfer_case(case: Any, device: Device = "cuda") -> TransferResult:
    """One class through a warm-up update and a guarded steady state; never raises."""
    from metrics_tpu_torch.analysis.sync_rules import classify_transfers

    try:
        m = case.ctor(device)
        static_clean, static_detail = classify_transfers(type(m))
        batches = _materialized_batches(case, _STEPS + 1, device)
        declared = bool(m._jit_eligible(batches[0], {}))
        m.update(*batches[0])  # warm-up: per-device constants, first-use builds
        failure: Optional[BaseException] = None
        with transfer_guard(device) as guard:
            try:
                for batch in batches[1:]:
                    m.update(*batch)
            except Exception as exc:  # noqa: BLE001 — the guard's raise IS the verdict on the card
                failure = exc
        runtime, detail = _verdict(guard, failure)
    except Exception as exc:  # noqa: BLE001 — every failure is a reportable verdict
        return TransferResult(case.name, False, "", False, f"ERROR:{type(exc).__name__}", False, str(exc)[:200])
    return TransferResult(case.name, static_clean, static_detail, declared, runtime,
                          _agreement(static_clean, declared, runtime), detail)


# ----------------------------------------------------------------- engines
def _engine_case() -> Any:
    """The first registry case whose metric rides a fleet bucket."""
    for case in transfer_cases():
        try:
            m = case.ctor("cpu")
            if m._config_key() is not None and m._jit_eligible((), {}):
                return case
        except Exception:  # noqa: BLE001
            continue
    raise RuntimeError("no bucket-eligible profile case found for the engine contract")


def _engine_static_leg() -> Tuple[bool, str]:
    """The engines' static verdict is the hotlint pass over ``engine/`` itself, against its baseline."""
    from metrics_tpu_torch.analysis.contexts import SYNC_RULE_CODES
    from metrics_tpu_torch.analysis.engine import PACKAGE_DIR, REPO_ROOT, diff_against_baseline, lint_paths, load_baseline

    res = lint_paths([os.path.join(PACKAGE_DIR, "engine")], root=REPO_ROOT, rules=SYNC_RULE_CODES)
    new, _n, _stale = diff_against_baseline(res.violations, load_baseline(DEFAULT_BASELINE))
    if new:
        return False, "; ".join(v.render() for v in new[:5])
    return True, ""


def check_engine_contract(kind: str, device: Device = "cuda", sessions: int = _ENGINE_SESSIONS,
                          case: Any = None) -> TransferResult:
    """A fleet tick under the guard; never raises.

    ``kind`` is ``"StreamEngine"`` (a ``sessions``-session steady tick) or ``"ShardedStreamEngine"`` (a churn
    tick over 2 shards on ``device``: expiries, arrivals and submissions all inside the guard, so adoption,
    the expiry slice and wave assembly must run in their annotated scopes). The detail names the annotated
    sites the guarded tick went through.
    """
    name = f"engine:{kind}"
    try:
        static_clean, static_detail = _engine_static_leg()
        case = case or _engine_case()
        if kind == "StreamEngine":
            from metrics_tpu_torch.engine.stream import StreamEngine

            engine: Any = StreamEngine(name="xfer_contract")
            n = sessions
        else:
            from metrics_tpu_torch.engine.sharded import ShardedStreamEngine

            engine = ShardedStreamEngine(n_shards=2, name="xfer_contract", devices=[device, device])
            n = 16
        sids = [engine.add_session(case.ctor(device), session_id=f"s{i}") for i in range(n)]
        churn_metrics = [case.ctor(device) for _ in range(4)]  # built outside the guard: the fixture's upload
        batches = _materialized_batches(case, 2 * n + 4, device)
        bi = 0
        for sid in sids:
            engine.submit(sid, *batches[bi % len(batches)])
            bi += 1
        engine.tick()  # warm: builds the wave programs
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        failure: Optional[BaseException] = None
        with transfer_guard(device, mode="warn") as guard:
            try:
                if kind == "ShardedStreamEngine":
                    for sid in sids[:4]:
                        engine.expire(sid)
                    sids = sids[4:]
                    for i, m2 in enumerate(churn_metrics):
                        sids.append(engine.add_session(m2, session_id=f"churn{i}"))
                for sid in sids:
                    engine.submit(sid, *batches[bi % len(batches)])
                    bi += 1
                engine.tick()
            except Exception as exc:  # noqa: BLE001 — the guard's raise IS the verdict
                failure = exc
        runtime, detail = _verdict(guard, failure)
        sites = ", ".join(f"{k} x{v}" for k, v in sorted(guard.allowed.items())) or "none"
        detail = (detail + "; " if detail else "") + f"{len(sids)} sessions, annotated sites: {sites}"
    except Exception as exc:  # noqa: BLE001
        return TransferResult(name, False, "", False, f"ERROR:{type(exc).__name__}", False, str(exc)[:200])
    agree = (static_clean and runtime == "CLEAN") or (not static_clean and runtime.startswith("TRANSFER"))
    return TransferResult(name, static_clean, static_detail, True, runtime, agree, detail)


def collect_transfer_report(cases: Optional[Sequence[Any]] = None, device: Device = "cuda") -> List[TransferResult]:
    results = [check_transfer_case(c, device) for c in (cases if cases is not None else transfer_cases())]
    results.append(check_engine_contract("StreamEngine", device))
    results.append(check_engine_contract("ShardedStreamEngine", device))
    return results


# ------------------------------------------------------------------- baseline
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baselines", "hotlint_baseline.json")


def load_transfer_baseline(path: str) -> Dict[str, str]:
    from metrics_tpu_torch.analysis.engine import load_baseline_section

    return {str(k): str(v) for k, v in load_baseline_section(path, "transfer").items()}


def write_transfer_baseline(path: str, results: Sequence[TransferResult]) -> Dict[str, str]:
    from metrics_tpu_torch.analysis.engine import write_baseline_section

    transfer = {
        r.name: f"UNJUSTIFIED: static={r.static_clean} declared={r.declared} runtime={r.runtime}"
        for r in sorted(results, key=lambda r: r.name)
        if not r.agree
    }
    write_baseline_section(
        path, "transfer", transfer,  # type: ignore[arg-type]
        "hotlint baseline: static host-read exceptions under `entries` (path::rule::context -> count and "
        "reason), transfer cross-check disagreements under `transfer` (class -> justification; expected "
        "empty). Regenerate with `python -m metrics_tpu_torch.analysis.cli --pass hotlint --pass transfer "
        "--update-baseline`.",
        seed={"entries": {}},
    )
    return transfer


def diff_transfer_baseline(
    results: Sequence[TransferResult], baseline: Dict[str, str]
) -> Tuple[List[TransferResult], List[str]]:
    """Split into (failures, stale_baseline_keys): unbaselined disagreements fail."""
    failures = [r for r in results if not r.agree and r.name not in baseline]
    observed = {r.name for r in results}
    disagreeing = {r.name for r in results if not r.agree}
    stale = sorted(name for name in baseline if name not in disagreeing or name not in observed)
    return failures, stale


def run_transfer_check(
    root: str,
    baseline_path: Optional[str] = None,
    update_baseline: bool = False,
    quiet: bool = False,
    report: Optional[Dict[str, Any]] = None,
    device: Device = "cuda",
) -> int:
    """The ``transfer`` pass: guard, cross-check, verdict."""
    path = baseline_path or DEFAULT_BASELINE
    results = collect_transfer_report(device=device)
    if update_baseline:
        transfer = write_transfer_baseline(path, results)
        if not quiet:
            print(f"transfer: baseline written to {path} ({len(transfer)} disagreement(s))")
        return 0
    failures, stale = diff_transfer_baseline(results, load_transfer_baseline(path))
    if report is not None:
        report.update({
            "cases": len(results),
            "failures": [r.render() for r in failures],
            "baselined": sum(1 for r in results if not r.agree) - len(failures),
            "stale_baseline_keys": stale,
            "runtime_verdicts": {r.name: r.runtime for r in results},
        })
        return 1 if failures else 0
    for r in failures:
        print(f"transfer: {r.render()}")
    if not quiet:
        for key in stale:
            print(f"transfer: stale baseline entry: {key}")
        agreed = sum(1 for r in results if r.agree)
        clean = sum(1 for r in results if r.runtime == "CLEAN")
        print(f"transfer: {agreed}/{len(results)} cases agree ({clean} clean at runtime), "
              f"{len(failures)} failure(s), {len(stale)} stale")
    return 1 if failures else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="transfer-contracts", description=__doc__.splitlines()[0])
    p.add_argument("--baseline", default=None, help="hotlint baseline JSON path")
    p.add_argument("--update-baseline", action="store_true")
    p.add_argument("--device", default="cuda", help="where the metrics run (default: the card)")
    p.add_argument("-v", "--verbose", action="store_true", help="print every case verdict")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    if args.verbose:
        for r in collect_transfer_report(device=args.device):
            print(r.render())
    return run_transfer_check(os.getcwd(), baseline_path=args.baseline, update_baseline=args.update_baseline,
                              quiet=args.quiet, device=args.device)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
