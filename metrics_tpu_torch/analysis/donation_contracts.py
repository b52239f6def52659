"""Dynamic donation-contract harness: three sources of truth, zero tolerance (counterpart of
``metrics_tpu/analysis/donation_contracts.py``).

For every jit-eligible class of the profile registry this runs a 3-update loop on the metrics' device and
cross-checks three verdicts on the same question — *may this class's update take its state tensors as its
own?*

1. **static** — :func:`metrics_tpu_torch.analysis.mem_rules.classify_donation`, read off the class hierarchy's
   source (unconditional list states, ``donate_states=False`` opt-outs);
2. **costs** — ``observe/costs.py``'s ``_donation_eligible``, the predicate the cost profiler exports as
   ``donation_eligible``;
3. **runtime** — always ``EAGER``: the port donates nothing, an update replaces its tensor states. What the JAX
   package proves of a donated buffer has a torch form all the same, and the loop holds each class to it:

   * a ``metric_state`` read taken between updates keeps its values and its storage after the next update — an
     update that mutates an escaped state in place (``add_``, ``index_add_``, ``copy_``, ``+=``) changes the
     caller's tensor under it (``ERROR:latch-bypassed``);
   * no two states share storage (``untyped_storage().data_ptr()``; ``ERROR:aliased-states``);
   * after ``reset()`` no state shares storage with its default (``ERROR:reset-aliases-default``);
   * ``compute()`` materializes (``ERROR:<exception>``).

Agreement is the JAX package's rule with ``DONATED`` unreachable: an error never agrees, the static and costs
verdicts must be equal, and ``EAGER`` agrees with either. Disagreements are baselined in the ``donation``
section of ``metrics_tpu_torch/analysis/baselines/donlint_baseline.json`` (expected empty). Runs as the
``donation`` pass of ``python -m metrics_tpu_torch.analysis.cli`` and as
``python -m metrics_tpu_torch.analysis.donation_contracts [--device cpu]``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils._pytree import tree_leaves

__all__ = [
    "DonationResult",
    "check_donation_case",
    "diff_donation_baseline",
    "donation_cases",
    "main",
    "run_donation_check",
]

Device = Union[str, torch.device]
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baselines", "donlint_baseline.json")
_STEPS = 3


@dataclasses.dataclass(frozen=True)
class DonationResult:
    name: str
    static_eligible: bool
    static_detail: str  # blocker list when ineligible
    costs_eligible: bool
    runtime: str  # EAGER | ERROR:<why>
    agree: bool
    detail: str = ""

    def render(self) -> str:
        mark = "ok " if self.agree else "DISAGREE"
        return (
            f"{mark} {self.name}: static={'eligible' if self.static_eligible else 'ineligible'} "
            f"costs={'eligible' if self.costs_eligible else 'ineligible'} runtime={self.runtime}"
            + (f" ({self.detail})" if self.detail else "")
        )


def donation_cases() -> List[Any]:
    """The jit-eligible slice of the profile registry (the transfer contract's, costs.py's gate)."""
    from metrics_tpu_torch.analysis.transfer_contracts import transfer_cases

    return transfer_cases()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _tensors(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The non-empty tensor states (an empty tensor has no storage to share)."""
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor) and v.numel()}


def _lifecycle(m: Any, batches: List[Tuple[Any, ...]]) -> Tuple[str, str]:
    """The 3-update loop and its checks: ("EAGER", "") or ("ERROR:<why>", detail)."""
    m.update(*batches[0])
    held = _tensors(m.metric_state)  # a read between updates, as a caller takes one
    snapshot = {k: (v.clone(), _storage(v), tuple(v.shape)) for k, v in held.items()}
    m.update(*batches[1])
    changed = sorted(k for k, v in held.items()
                     if _storage(v) != snapshot[k][1] or tuple(v.shape) != snapshot[k][2]
                     or not torch.equal(v, snapshot[k][0]))
    if changed:
        return "ERROR:latch-bypassed", f"a metric_state read changed under its holder: {', '.join(changed)}"
    states = _tensors(m.metric_state)
    aliased = [f"{x}~{y}" for x in states for y in states if x < y and _storage(states[x]) == _storage(states[y])]
    if aliased:
        return "ERROR:aliased-states", f"states share storage: {', '.join(aliased)}"
    m.update(*batches[2])
    for leaf in tree_leaves(m.compute()):
        if isinstance(leaf, torch.Tensor):
            leaf.cpu()  # materializes: every launch behind it has run
    m.reset()
    defaults = _tensors(m._defaults)
    states = _tensors(m.metric_state)
    on_default = sorted(k for k, v in states.items() if k in defaults and _storage(v) == _storage(defaults[k]))
    if on_default:
        return "ERROR:reset-aliases-default", f"after reset, states on their default's storage: {', '.join(on_default)}"
    return "EAGER", ""


def check_donation_case(case: Any, device: Device = "cuda") -> DonationResult:
    """One class through the 3-update loop on ``device``; never raises (errors become verdicts)."""
    from metrics_tpu_torch.analysis.mem_rules import classify_donation
    from metrics_tpu_torch.observe.costs import _donation_eligible, _rng

    try:
        m = case.ctor(device=device)
        static_eligible, static_detail = classify_donation(type(m))
        costs_eligible = bool(_donation_eligible(m))
        rng = _rng(case)
        batches = [tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in case.batch(rng))
                   for _ in range(_STEPS)]
        runtime, detail = _lifecycle(m, batches)
    except Exception as exc:  # noqa: BLE001 — every failure is a reportable verdict
        return DonationResult(case.name, False, "", False, f"ERROR:{type(exc).__name__}", False, str(exc)[:200])
    agree = not runtime.startswith("ERROR") and static_eligible == costs_eligible
    return DonationResult(case.name, static_eligible, static_detail, costs_eligible, runtime, agree, detail)


def collect_donation_report(cases: Optional[Sequence[Any]] = None, device: Device = "cuda") -> List[DonationResult]:
    return [check_donation_case(c, device) for c in (cases if cases is not None else donation_cases())]


# ------------------------------------------------------------------- baseline
def load_donation_baseline(path: str) -> Dict[str, str]:
    from metrics_tpu_torch.analysis.engine import load_baseline_section

    return {str(k): str(v) for k, v in load_baseline_section(path, "donation").items()}


def write_donation_baseline(path: str, results: Sequence[DonationResult]) -> Dict[str, str]:
    from metrics_tpu_torch.analysis.engine import write_baseline_section

    donation = {
        r.name: f"UNJUSTIFIED: static={r.static_eligible} costs={r.costs_eligible} runtime={r.runtime}"
        for r in sorted(results, key=lambda r: r.name)
        if not r.agree
    }
    write_baseline_section(
        path, "donation", donation,  # type: ignore[arg-type]
        "donlint baseline: static escape/alias exceptions under `entries` (path::rule::context, each with its "
        "reason), donation cross-check disagreements under `donation` (class -> justification; expected empty). "
        "Regenerate with `python -m metrics_tpu_torch.analysis.cli --pass donlint --pass donation "
        "--update-baseline`.",
        seed={"entries": {}},
    )
    return donation


def diff_donation_baseline(
    results: Sequence[DonationResult], baseline: Dict[str, str]
) -> Tuple[List[DonationResult], List[str]]:
    """Split into (failures, stale_baseline_keys): unbaselined disagreements fail."""
    failures = [r for r in results if not r.agree and r.name not in baseline]
    observed = {r.name for r in results}
    disagreeing = {r.name for r in results if not r.agree}
    stale = sorted(name for name in baseline if name not in disagreeing or name not in observed)
    return failures, stale


def run_donation_check(
    root: str,
    baseline_path: Optional[str] = None,
    update_baseline: bool = False,
    quiet: bool = False,
    report: Optional[Dict[str, Any]] = None,
    device: Device = "cuda",
) -> int:
    """The ``donation`` pass: loop, cross-check, one verdict."""
    path = baseline_path or DEFAULT_BASELINE
    results = collect_donation_report(device=device)
    if update_baseline:
        donation = write_donation_baseline(path, results)
        if not quiet:
            print(f"donation: baseline written to {path} ({len(donation)} disagreement(s))")
        return 0
    failures, stale = diff_donation_baseline(results, load_donation_baseline(path))
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
        print(f"donation: {r.render()}")
    if not quiet:
        for key in stale:
            print(f"donation: stale baseline entry: {key}")
        agreed = sum(1 for r in results if r.agree)
        print(f"donation: {agreed}/{len(results)} classes agree (every runtime EAGER: the port donates nothing), "
              f"{len(failures)} failure(s), {len(stale)} stale")
    return 1 if failures else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="donation-contracts", description=__doc__.splitlines()[0])
    p.add_argument("--baseline", default=None, help="donlint baseline JSON path")
    p.add_argument("--update-baseline", action="store_true",
                   help="record current disagreements as the new baseline and exit 0")
    p.add_argument("--device", default="cuda", help="where the metrics live (default: the card)")
    p.add_argument("-v", "--verbose", action="store_true", help="print every class verdict")
    p.add_argument("-q", "--quiet", action="store_true", help="suppress the summary line")
    args = p.parse_args(argv)
    if args.verbose:
        for r in collect_donation_report(device=args.device):
            print(r.render())
    return run_donation_check(os.getcwd(), baseline_path=args.baseline, update_baseline=args.update_baseline,
                              quiet=args.quiet, device=args.device)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
