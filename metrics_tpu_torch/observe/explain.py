"""Recompile-cause attribution for compiled-program caches (counterpart of
``metrics_tpu/observe/explain.py``).

A compiled-program cache keys its entries on a tuple of static facts: metric
class, config items, row capacity, batch shapes and dtypes, argument structure,
the precision regime. A miss therefore always has a *cause*: some component of
the key differs from every entry that came before it. This module names that
component. In the JAX package every jit, fused, engine and AOT cache reports
its misses here; the eager port has no such cache yet, and the stream engine's
captured programs are the first that will (the module and its report are
ported now, so that they land on a tested base).

Call sites decompose their cache key into named ``(component, value)`` pairs
and report misses through :func:`metrics_tpu_torch.observe.recorder.note_compile_miss`,
which calls :func:`attribute` here. Attribution diffs the new key against the
*nearest* prior key of the same cache kind (fewest differing components, most
recent wins ties) held in a bounded per-kind history, and classifies:

* ``"first"`` — no prior key of this kind exists (cold process, expected);
* ``"rebuild"`` — an identical key missed again: the entry was evicted or
  the cache was cleared — capacity churn, not key churn;
* a single component name (``"config:num_classes"``, ``"capacity"``,
  ``"batch_avals"``, ``"x64"``, …) — the actionable case: exactly one thing
  changed;
* ``"multiple"`` — several components moved at once. Two collapse rules
  apply first: a precision-regime (``x64``) flip implies every aval-carrying
  component (``batch_avals`` / ``state_avals`` / ``call_signature``) changes
  with it, so those are dropped from the diff before counting; and a change
  to a fused key's member roster (``buckets`` / ``leaders``) implies every
  component that exists on only one side of the diff (a member joining or
  leaving brings its whole ``capacity[label]`` / ``batch_avals[label]`` /
  ``config[label]:…`` family with it), so one-sided components are dropped
  too. Both rules see through the per-member ``[label]`` suffix.

The history is dropped by ``Recorder.clear()`` (test/scope isolation).

Everything here is stdlib-only so :mod:`metrics_tpu_torch.observe.recorder`
can import it lazily. ``main`` renders the ``compile_explain`` events of a
snapshot JSON into a per-cache, per-cause report
(``python -m metrics_tpu_torch.observe.explain snapshot.json``).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "attribute",
    "clear_history",
    "history_depth",
    "main",
    "render_report",
]

# components whose values are derived from array avals: an x64-regime flip
# rewrites all of them, so they are implied (not independent causes) whenever
# "x64" itself is in the diff
_AVAL_COMPONENTS = frozenset({"batch_avals", "state_avals", "call_signature"})

# roster components: the member list of a fused key — "buckets" on the engine's
# fused-tick key, "leaders" on the fused collection key. A roster change
# implies every component that exists on only one side of the diff.
_ROSTER_COMPONENTS = frozenset({"buckets", "leaders"})

# the decomposed fused key suffixes each per-entry component with its bucket
# label: ``batch_avals[cls]``, ``config[cls]:k``. Collapse rules match on the
# base name so they keep working on fused multi-bucket keys.
_SUFFIX_RE = re.compile(r"\[[^\][]*\]")


def _component_base(name: str) -> str:
    """``batch_avals[cls]`` → ``batch_avals``; ``config[cls]:k`` → ``config:k``."""
    return _SUFFIX_RE.sub("", name, count=1)

_HISTORY_DEPTH = 128
_VALUE_CAP = 160  # rendered component values are bounded for the event log

_HISTORY: Dict[str, Deque[Dict[str, str]]] = {}
_LOCK = threading.Lock()


def _render(value: Any) -> str:
    """Bounded, deterministic rendering of one component value."""
    try:
        text = repr(value)
    except Exception:  # noqa: BLE001 — a broken repr must not kill the hot path
        text = f"<unreprable {type(value).__name__}>"
    if len(text) > _VALUE_CAP:
        text = text[: _VALUE_CAP - 1] + "…"
    return text


def _normalize(components: Sequence[Tuple[str, Any]]) -> Dict[str, str]:
    return {str(name): _render(value) for name, value in components}


def _diff(prior: Dict[str, str], now: Dict[str, str]) -> Tuple[str, ...]:
    """Names whose values differ, or that exist on only one side."""
    changed = [k for k in now if prior.get(k) != now[k]]
    changed += [k for k in prior if k not in now]
    return tuple(sorted(changed))


def attribute(
    kind: str, components: Sequence[Tuple[str, Any]]
) -> Tuple[str, Tuple[str, ...], Dict[str, Dict[str, Optional[str]]]]:
    """Classify one cache miss; returns ``(cause, changed, detail)``.

    ``components`` is the decomposed cache key: ordered ``(name, value)``
    pairs. ``detail`` maps each changed component to its prior/new rendered
    values (``None`` for a side where the component did not exist).
    """
    now = _normalize(components)
    with _LOCK:
        hist = _HISTORY.get(kind)
        if hist is None:
            hist = _HISTORY[kind] = deque(maxlen=_HISTORY_DEPTH)
        nearest: Optional[Dict[str, str]] = None
        nearest_diff: Tuple[str, ...] = ()
        for prior in reversed(hist):  # most recent first: wins diff-count ties
            d = _diff(prior, now)
            if nearest is None or len(d) < len(nearest_diff):
                nearest, nearest_diff = prior, d
                if not d:
                    break
        first = nearest is None
        hist.append(now)
    if first:
        return "first", (), {}
    if not nearest_diff:
        return "rebuild", (), {}
    assert nearest is not None
    changed = nearest_diff
    if len(changed) > 1 and any(r in changed for r in _ROSTER_COMPONENTS):
        # the fused key's member roster changed: every component that exists
        # on only one side of the diff was brought (or taken) by the
        # joining/leaving member itself, not independently changed
        collapsed = tuple(
            c for c in changed
            if c in _ROSTER_COMPONENTS or ((c in now) == (c in nearest))
        )
        if collapsed:
            changed = collapsed
    if "x64" in changed and len(changed) > 1:
        collapsed = tuple(c for c in changed if _component_base(c) not in _AVAL_COMPONENTS)
        if collapsed:
            changed = collapsed
    cause = changed[0] if len(changed) == 1 else "multiple"
    detail = {c: {"prior": nearest.get(c), "now": now.get(c)} for c in changed}
    return cause, changed, detail


def clear_history() -> None:
    """Drop all per-kind key history (``Recorder.clear()`` calls this)."""
    with _LOCK:
        _HISTORY.clear()


def history_depth(kind: str) -> int:
    with _LOCK:
        hist = _HISTORY.get(kind)
        return len(hist) if hist is not None else 0


# ------------------------------------------------------------------ reporting

def render_report(snap: Dict[str, Any], tail: int = 8) -> str:
    """Text report over a snapshot's ``compile_explain`` events + counters."""
    events = [e for e in snap.get("events", []) if e.get("kind") == "compile_explain"]
    by_cache = snap.get("counters", {}).get("compile_explain", {}) or {}
    by_cause = snap.get("counters", {}).get("compile_cause", {}) or {}
    total = sum(by_cache.values())
    lines: List[str] = []
    lines.append("== why recompile ==")
    if not total and not events:
        lines.append("no attributed compile misses recorded — was telemetry enabled?")
        return "\n".join(lines)
    lines.append(
        f"{total} attributed cache miss(es) across {len(by_cache)} cache(s)"
        f" ({len(events)} event(s) still in the ring)"
    )
    lines.append("")
    lines.append(f"{'cache':<14}{'misses':>8}")
    for cache, n in sorted(by_cache.items(), key=lambda kv: (-kv[1], kv[0])):
        lines.append(f"{cache:<14}{n:>8}")
    lines.append("")
    lines.append(f"{'cause':<28}{'misses':>8}")
    for cause, n in sorted(by_cause.items(), key=lambda kv: (-kv[1], kv[0])):
        lines.append(f"{cause:<28}{n:>8}")
    actionable = [e for e in events if e.get("cause") not in ("first", "rebuild")]
    show = (actionable or events)[-tail:]
    if show:
        lines.append("")
        lines.append(f"last {len(show)} attributed miss(es):")
        for e in show:
            parts = [f"[{e.get('cache')}] {e.get('label')}: {e.get('cause')}"]
            detail = e.get("detail") or {}
            for comp, change in sorted(detail.items()):
                parts.append(f"    {comp}: {change.get('prior')} -> {change.get('now')}")
            lines.extend(parts)
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``why-recompile``: explain every attributed cache miss in a snapshot.

    Reads one ``observe.snapshot()`` JSON file (``-`` for stdin) and renders
    the per-cache / per-cause miss report with the changed key components of
    the most recent events. Exit codes: 0 rendered, 2 usage/unreadable input.
    """
    p = argparse.ArgumentParser(
        prog="why_recompile",
        description="Explain recompiles: per-cache, per-cause report over the "
                    "compile_explain events of an observe.snapshot() JSON file.",
    )
    p.add_argument("snapshot", help="snapshot JSON path, or - for stdin")
    p.add_argument("--tail", type=int, default=8,
                   help="how many recent attributed misses to detail (default 8)")
    args = p.parse_args(argv)
    try:
        if args.snapshot == "-":
            snap = json.load(sys.stdin)
        else:
            with open(args.snapshot) as f:
                snap = json.load(f)
    except (OSError, ValueError) as exc:
        print(f"why_recompile: cannot read {args.snapshot}: {exc}", file=sys.stderr)
        return 2
    print(render_report(snap, tail=args.tail))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
