"""Dynamic AOT round-trip harness: every registry class through the kernel-library build cache (counterpart of
``metrics_tpu/analysis/aot_contracts.py``).

The JAX package persists one compiled executable per metric program. The port compiles no program per class: its
persisted artifacts are the native libraries that :mod:`metrics_tpu_torch.ops._native` builds from ``csrc/``, each
with a validated manifest (:mod:`metrics_tpu_torch.aot.cache`). This harness holds that cache to the JAX package's
contract, per registry class, on the metrics' device:

1. **oracle** — a fresh instance updates twice and computes, recording the libraries it loads (B2 launches in
   ``UniversalImageQualityIndex``'s compute, not its update); in a fresh build directory the first class to
   need a library builds it there (a *cold* build, at most one per library per leg, shared by every case);
2. **reload** — the loaded libraries are dropped and a second instance replays the same batches and compute:
   every library must come back from its manifest with no build (anything else is ``NO_REUSE``), and its states
   must equal the oracle's bit for bit and its compute agree (``DIVERGED`` otherwise).

Verdicts:

* ``ROUNDTRIP`` — reloaded from the manifests with no build, bit-exact against the oracle;
* ``CLOSE`` — reloaded, states bit-exact, compute within float tolerance;
* ``INELIGIBLE`` — neither the update nor the compute loads a native library on this device (every class on the
  CPU but the ones that use the RLE codec; on the card every class that launches neither B1 nor B2);
* ``NO_REUSE`` — the reload rebuilt a library;
* ``DIVERGED`` — the reloaded states or compute disagree with the oracle's;
* ``ERROR:<why>`` — harness failure.

The JAX package's ``UNFINGERPRINTED`` (a config with no process-stable identity, hence no disk key) has no
target here: a library is keyed by the hash of its sources and flags, never by a class's configuration.

``NO_REUSE``/``DIVERGED``/``ERROR`` fail the pass unless baselined (with a justification) in the ``aot`` section
of ``metrics_tpu_torch/analysis/baselines/aot_baseline.json`` (expected empty). Runs as the ``aot`` pass of
``python -m metrics_tpu_torch.analysis.cli`` and as ``python -m metrics_tpu_torch.analysis.aot_contracts
[--device cpu]``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.analysis.fleet_contracts import _compare  # '' bit-identical, 'close', 'diverged'

__all__ = [
    "AotLeg",
    "AotResult",
    "check_aot_case",
    "collect_aot_report",
    "diff_aot_contract_baseline",
    "main",
    "run_aot_check",
]

Device = Union[str, torch.device]
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baselines", "aot_baseline.json")


@dataclasses.dataclass(frozen=True)
class AotResult:
    name: str
    verdict: str  # ROUNDTRIP | CLOSE | INELIGIBLE | NO_REUSE | DIVERGED | ERROR:<why>
    detail: str = ""
    libraries: Tuple[str, ...] = ()  # the native libraries the update and compute load on this device

    @property
    def ok(self) -> bool:
        return self.verdict in ("ROUNDTRIP", "CLOSE", "INELIGIBLE")

    def render(self) -> str:
        mark = "ok " if self.ok else "FAIL"
        libs = f" [{', '.join(self.libraries)}]" if self.libraries else ""
        return f"{mark} {self.name}: {self.verdict}{libs}" + (f" ({self.detail})" if self.detail else "")


@contextlib.contextmanager
def _recording_loads() -> Iterator[List[str]]:
    """The names of the native libraries loaded inside the block (every kernel and codec call loads through
    ``_native.load``)."""
    from metrics_tpu_torch.ops import _native

    names: List[str] = []
    real = _native.load

    def load(name: str) -> Any:
        names.append(name)
        return real(name)

    _native.load = load
    try:
        yield names
    finally:
        _native.load = real


class AotLeg:
    """One build directory for a run of cases: at most one cold build per library, shared by every case.

    ``directory`` None makes a fresh temporary directory, removed on exit; a given directory is kept (the card's
    aot leg passes the cache its cold process has just built). On entry the process's loaded libraries are set
    aside, so that the first load of each library goes through the directory's manifests; on exit they and the
    configured build directory are restored. ``builds`` counts, per library, how ``_native.build`` found it each
    time it looked (``hit``, ``built`` or ``refreshed``).
    """

    def __init__(self, directory: Optional[str] = None) -> None:
        self._given = directory
        self.directory = directory
        self.builds: Dict[str, Dict[str, int]] = {}

    def __enter__(self) -> "AotLeg":
        from metrics_tpu_torch.aot import cache as _cache
        from metrics_tpu_torch.ops import _native

        self._prev_dir = _cache.cache_dir()
        self._prev_loaded = dict(_native._loaded)
        if self.directory is None:
            self.directory = tempfile.mkdtemp(prefix="aot_leg_")
        _cache.set_cache_dir(self.directory)
        _native._loaded.clear()
        return self

    def __exit__(self, *exc: Any) -> None:
        from metrics_tpu_torch.aot import cache as _cache
        from metrics_tpu_torch.ops import _native

        _native._loaded.clear()
        _native._loaded.update(self._prev_loaded)
        _cache.set_cache_dir(self._prev_dir)
        if self._given is None and self.directory is not None:
            _cache.purge_cache(self.directory)
            shutil.rmtree(self.directory, ignore_errors=True)

    @property
    def cold_builds(self) -> int:
        """Libraries compiled because the directory had none."""
        return sum(n.get("built", 0) for n in self.builds.values())

    def _run(self, case: Any, batches: List[Tuple[Any, ...]],
             device: Device) -> Tuple[Any, Any, List[str], Dict[str, str]]:
        """A fresh instance through the batches and a compute: (instance, computed value, libraries loaded, build
        outcome of each library whose load went to the directory)."""
        from metrics_tpu_torch.ops import _native

        loaded_before = set(_native._loaded)
        m = case.ctor(device)
        with _recording_loads() as names:
            for args in batches:
                m.update(*args)
            value = m.compute()
        libraries = list(dict.fromkeys(names))
        # a library not loaded before the run went through _native.build, which recorded how it found it
        fresh = {n: _native.build_outcomes[n] for n in libraries if n not in loaded_before}
        for n, outcome in fresh.items():
            counts = self.builds.setdefault(n, {})
            counts[outcome] = counts.get(outcome, 0) + 1
        return m, value, libraries, fresh

    def check(self, case: Any, device: Device = "cuda") -> AotResult:
        """One class through oracle and reload; never raises (errors become verdicts)."""
        from metrics_tpu_torch.metric import Metric
        from metrics_tpu_torch.observe.costs import _rng
        from metrics_tpu_torch.ops import _native

        try:
            rng = _rng(case)
            batches = [tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in case.batch(rng))
                       for _ in range(2)]
            oracle, want, libraries, _ = self._run(case, batches, device)
            if not isinstance(oracle, Metric):
                return AotResult(case.name, "ERROR:ctor", f"{case.name} did not construct a Metric")
            if not libraries:
                return AotResult(case.name, "INELIGIBLE")
            libs = tuple(libraries)
            for name in libs:  # a new process: nothing loaded, every library from its manifest
                _native._loaded.pop(name, None)
            loaded, got, again, outcomes = self._run(case, batches, device)
            rebuilt = {n: o for n, o in outcomes.items() if o != "hit"}
            if rebuilt or set(outcomes) != set(libs):
                return AotResult(case.name, "NO_REUSE", f"reload: {outcomes or 'no library loaded'}", libs)
            if again != libraries:
                return AotResult(case.name, "DIVERGED", f"the reload loaded {again}, the oracle {libraries}", libs)
            for k in oracle._defaults:
                if _compare(loaded.metric_state[k], oracle.metric_state[k]):
                    return AotResult(case.name, "DIVERGED", f"state '{k}' differs from the oracle's", libs)
            cmp = _compare(got, want)
            if cmp == "diverged":
                return AotResult(case.name, "DIVERGED", "compute differs from the oracle's", libs)
            return AotResult(case.name, "CLOSE" if cmp else "ROUNDTRIP", "", libs)
        except Exception as exc:  # noqa: BLE001 — every failure is a reportable verdict
            return AotResult(case.name, f"ERROR:{type(exc).__name__}", str(exc)[:200])


def check_aot_case(case: Any, device: Device = "cuda", directory: Optional[str] = None) -> AotResult:
    """One class in a leg of its own (a fresh build directory unless ``directory`` names one)."""
    with AotLeg(directory) as leg:
        return leg.check(case, device)


def collect_aot_report(cases: Optional[Sequence[Any]] = None, device: Device = "cuda",
                       directory: Optional[str] = None) -> Tuple[List[AotResult], Dict[str, Dict[str, int]]]:
    """Every case in one leg: (results, how each library was found each time its load went to the directory)."""
    from metrics_tpu_torch.observe.costs import PROFILE_CASES

    with AotLeg(directory) as leg:
        results = [leg.check(c, device) for c in (cases if cases is not None else PROFILE_CASES)]
    return results, leg.builds


# ------------------------------------------------------------------- baseline
def load_aot_contract_baseline(path: str) -> Dict[str, str]:
    from metrics_tpu_torch.analysis.engine import load_baseline_section

    return {str(k): str(v) for k, v in load_baseline_section(path, "aot").items()}


def write_aot_contract_baseline(path: str, results: Sequence[AotResult]) -> Dict[str, str]:
    from metrics_tpu_torch.analysis.engine import write_baseline_section

    aot = {r.name: f"UNJUSTIFIED: {r.verdict}" for r in sorted(results, key=lambda r: r.name) if not r.ok}
    write_baseline_section(
        path, "aot", aot,  # type: ignore[arg-type]
        "aot-contract baseline: kernel-library manifest round-trip disagreements (class -> justification; "
        "expected empty). Regenerate with `python -m metrics_tpu_torch.analysis.cli --pass aot --update-baseline`.",
    )
    return aot


def diff_aot_contract_baseline(
    results: Sequence[AotResult], baseline: Dict[str, str]
) -> Tuple[List[AotResult], List[str]]:
    """Split into (failures, stale_baseline_keys): unbaselined disagreements fail."""
    failures = [r for r in results if not r.ok and r.name not in baseline]
    failing = {r.name for r in results if not r.ok}
    observed = {r.name for r in results}
    stale = sorted(name for name in baseline if name not in failing or name not in observed)
    return failures, stale


def run_aot_check(
    root: str,
    baseline_path: Optional[str] = None,
    update_baseline: bool = False,
    quiet: bool = False,
    report: Optional[Dict[str, Any]] = None,
    device: Device = "cuda",
) -> int:
    """The ``aot`` pass: round-trip every class in one leg, one verdict."""
    path = baseline_path or DEFAULT_BASELINE
    results, builds = collect_aot_report(device=device)
    if update_baseline:
        aot = write_aot_contract_baseline(path, results)
        if not quiet:
            print(f"aot: baseline written to {path} ({len(aot)} disagreement(s))")
        return 0
    failures, stale = diff_aot_contract_baseline(results, load_aot_contract_baseline(path))
    if report is not None:
        report.update({
            "cases": len(results),
            "failures": [r.render() for r in failures],
            "baselined": sum(1 for r in results if not r.ok) - len(failures),
            "stale_baseline_keys": stale,
            "verdicts": {r.name: r.verdict for r in results},
            "builds": builds,
        })
        return 1 if failures else 0
    for r in failures:
        print(f"aot: {r.render()}")
    if not quiet:
        for key in stale:
            print(f"aot: stale baseline entry: {key}")
        roundtrip = sum(1 for r in results if r.verdict in ("ROUNDTRIP", "CLOSE"))
        skipped = sum(1 for r in results if r.verdict == "INELIGIBLE")
        print(f"aot: {sum(1 for r in results if r.ok)}/{len(results)} classes agree ({roundtrip} reloaded from their "
              f"manifests bit-exactly, {skipped} load no library), {len(failures)} failure(s), {len(stale)} stale; "
              f"builds {builds}")
    return 1 if failures else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="aot-contracts", description=__doc__.splitlines()[0])
    p.add_argument("--baseline", default=None, help="aot baseline JSON path")
    p.add_argument("--update-baseline", action="store_true",
                   help="record current disagreements as the new baseline and exit 0")
    p.add_argument("--device", default="cuda", help="where the metrics live (default: the card)")
    p.add_argument("-q", "--quiet", action="store_true", help="suppress the summary line")
    args = p.parse_args(argv)
    return run_aot_check(os.getcwd(), baseline_path=args.baseline, update_baseline=args.update_baseline,
                         quiet=args.quiet, device=args.device)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
