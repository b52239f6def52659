"""Pre-build the kernel libraries and warm the registry (counterpart of ``metrics_tpu/aot/warm.py``).

``python -m metrics_tpu_torch.aot.warm --cache-dir <dir>`` builds every library of ``csrc/`` into the
directory (one compiler per source, in parallel), writes each one's validated manifest, then runs one update
of every profile case (:data:`metrics_tpu_torch.observe.costs.PROFILE_CASES`) on the device, so that their
first-use costs are paid. Idempotent: a second run over a warm directory finds every manifest valid and
builds nothing; a stale or corrupt manifest rebuilds its library once. Safe in-process: the configured
directory is restored on exit. ``--contract`` then runs the aot contract
(:mod:`metrics_tpu_torch.analysis.aot_contracts`) over the registry against the same directory, so that its
round trips reuse the libraries this run found or built and add no build of their own.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, Optional, Sequence

from metrics_tpu_torch.aot import cache as _cache

__all__ = ["main", "warm_registry"]


def _default_libraries(device: str) -> tuple:
    from metrics_tpu_torch.ops import _native

    # without a card there is nothing to run a CUDA library on (and, as a rule, no nvcc)
    return (_native.KERNEL_SOURCES if device.startswith("cuda") else ()) + _native.HOST_SOURCES


def warm_registry(
    cache_directory: Optional[str] = None,
    classes: Optional[Sequence[str]] = None,
    verbose: bool = False,
    device: str = "cuda",
    contract: bool = False,
) -> Dict[str, Any]:
    """Build and manifest every library ``device`` uses, then update each (matching) profile case once there.

    The summary maps each library to how ``_native.build`` found it: ``hit`` (its manifest validated: nothing
    built), ``built`` (no manifest) or ``refreshed`` (stale or corrupt manifest: library rebuilt), and each
    case to ``updated`` or ``error``; ``built_s`` is the wall time of the build step. ``classes`` filters
    case names by case-insensitive substring (an empty list runs no case). ``contract`` adds the aot contract's
    verdict per registry class (``contract``), its failures and how it found each library (``contract_builds``).
    """
    from metrics_tpu_torch.ops import _native

    directory = cache_directory if cache_directory is not None else _cache.cache_dir()
    names = _default_libraries(device)
    summary: Dict[str, Any] = {"directory": str(directory), "libraries": {}, "cases": {}}
    prev = _cache.cache_dir()
    try:
        _cache.set_cache_dir(directory)
        t0 = time.perf_counter()
        _native.build(names)
        summary["built_s"] = time.perf_counter() - t0
        summary["libraries"] = {name: _native.build_outcomes[name] for name in names}
        if verbose:
            for name, status in summary["libraries"].items():
                print(f"  library {name:20s} {status}")
        from metrics_tpu_torch.observe.costs import PROFILE_CASES, case_batch

        for case in PROFILE_CASES:
            if classes is not None and not any(s.lower() in case.name.lower() for s in classes):
                continue
            try:
                case.ctor(device).update(*case_batch(case, device))
                status, detail = "updated", ""
            except Exception as exc:  # noqa: BLE001 — the error text IS the result
                status, detail = "error", f"{type(exc).__name__}: {exc}"
            summary["cases"][case.name] = {"status": status, **({"detail": detail} if detail else {})}
            if verbose:
                print(f"  case {case.name:45s} {status}{(' — ' + detail) if detail else ''}")
        if contract:
            from metrics_tpu_torch.analysis.aot_contracts import collect_aot_report

            t0 = time.perf_counter()
            results, builds = collect_aot_report(device=device, directory=str(directory))
            summary.update({"contract": {r.name: r.verdict for r in results}, "contract_builds": builds,
                            "contract_failures": [r.render() for r in results if not r.ok],
                            "contract_s": time.perf_counter() - t0})
    finally:
        _cache.set_cache_dir(prev)
    statuses = list(summary["libraries"].values())
    summary.update({k: statuses.count(k) for k in ("hit", "built", "refreshed")})
    summary["error"] = sum(1 for c in summary["cases"].values() if c["status"] == "error")
    summary["stats"] = _cache.cache_stats(str(directory))
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="metrics_tpu_torch.aot.warm", description=__doc__.splitlines()[0])
    p.add_argument("--cache-dir", default=None, help=f"target directory (default: ${_cache.ENV_VAR} or _build/)")
    p.add_argument("--classes", default=None, help="comma-separated case-name substrings to update (default: all)")
    p.add_argument("--device", default="cuda", help="where the cases update (default: the card)")
    p.add_argument("--purge", action="store_true", help="delete the directory's libraries and manifests first")
    p.add_argument("--contract", action="store_true",
                   help="then run the aot contract over the registry against the same directory")
    p.add_argument("--json", action="store_true", help="print the summary as one JSON line")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    directory = args.cache_dir if args.cache_dir is not None else _cache.cache_dir()
    if args.purge:
        removed = _cache.purge_cache(str(directory))
        if not args.json:
            print(f"warm: purged {removed} files from {directory}")
    classes = [s.strip() for s in args.classes.split(",")] if args.classes is not None else None
    summary = warm_registry(str(directory), classes=classes, verbose=args.verbose, device=args.device,
                            contract=args.contract)
    if args.json:
        print(json.dumps(summary))
    else:
        print(f"warm: {summary['built']} built, {summary['refreshed']} refreshed, {summary['hit']} already warm "
              f"({summary['built_s']:.1f} s), {len(summary['cases'])} cases updated with {summary['error']} errors "
              f"— {summary['stats']['libraries']} libraries in {summary['stats']['directory']}")
    return 1 if summary["error"] or summary.get("contract_failures") else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
