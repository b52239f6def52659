"""Flight-recorder spans: nested host-side phase timing with a bounded ring (counterpart of
``metrics_tpu/observe/tracing.py``).

The counters/timers in :mod:`metrics_tpu_torch.observe.recorder` answer *how
much*; spans answer *when* and *inside what*. A span is a ``with``-scoped
interval tagged ``(phase, label)`` — ``span("ckpt", "save")`` nested inside a
caller's own ``span("epoch", "eval")`` — recorded into a bounded ring on the
process-wide :data:`~metrics_tpu_torch.observe.recorder.RECORDER` and folded
into the per-phase DDSketch latency histograms of
:mod:`metrics_tpu_torch.observe.latency`. Each span also enters a
``torch.profiler.record_function`` range named ``phase:label`` while a
``torch.profiler.profile`` capture records, so that in the capture the host
phases enclose the kernels they launched.

Overhead contract (the JAX package's): while telemetry is disabled,
:func:`span` performs exactly one module-flag check and returns a preallocated
no-op singleton — zero allocations, nothing appended anywhere, no profiler
range entered. Spans time *host-side* sections: on a CUDA device that is the
time to enqueue the section's kernels; nothing here synchronizes with the card.

Export: :func:`timeline` renders the ring as Chrome-trace/Perfetto JSON
(``chrome://tracing``, https://ui.perfetto.dev); :func:`drain_spans` pops the
raw records for incremental export.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

from metrics_tpu_torch.observe import latency as _latency
from metrics_tpu_torch.observe import recorder as _recorder

__all__ = [
    "chrome_events",
    "drain_spans",
    "profiler_range",
    "record_complete",
    "span",
    "timeline",
]


class _NullSpan:
    """Shared no-op context manager returned while telemetry is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()

_LOCAL = threading.local()

# torch.profiler.record_function, resolved on the first *enabled* span so this
# module imports (and disabled mode runs) without importing the profiler, and
# entered only while a profiler records (a range outside a capture would cost
# an update about 14 us for nothing). None = not yet probed; False = probe
# failed (no profiler in this build).
_ANNOTATION: Any = None
_PROFILING: Any = None


def _annotation_cls() -> Any:
    global _ANNOTATION, _PROFILING
    if _ANNOTATION is None:
        try:
            from torch.autograd import _profiler_enabled
            from torch.profiler import record_function

            _ANNOTATION, _PROFILING = record_function, _profiler_enabled
        except ImportError:
            _ANNOTATION = False
    return _ANNOTATION if _ANNOTATION and _PROFILING() else None


def _stack() -> List["_Span"]:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def _record(phase: str, label: str, t0: float, t1: float, depth: int) -> None:
    rec = _recorder.RECORDER
    entry = {
        "phase": phase,
        "label": label,
        "t0": t0,
        "t1": t1,
        "depth": depth,
        "tid": threading.get_ident(),
    }
    with rec._lock:
        rec._span_total += 1
        rec.spans.append(entry)
    _latency.observe_duration(phase, label, t1 - t0)


class _Span:
    __slots__ = ("phase", "label", "t0", "t1", "depth", "_annot")

    def __init__(self, phase: str, label: str) -> None:
        self.phase = phase
        self.label = label
        self._annot: Any = None

    def __enter__(self) -> "_Span":
        st = _stack()
        self.depth = len(st)
        st.append(self)
        cls = _annotation_cls()
        if cls is not None:
            try:
                annot = cls(self.phase if not self.label else f"{self.phase}:{self.label}")
                annot.__enter__()
                self._annot = annot
            except Exception:
                self._annot = None
        self.t0 = _recorder.clock()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        self.t1 = _recorder.clock()
        if self._annot is not None:
            try:
                self._annot.__exit__(exc_type, exc, tb)
            except Exception:
                pass
            self._annot = None
        st = _stack()
        # exceptions can unwind spans out of order; tolerate both shapes
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        _record(self.phase, self.label, self.t0, self.t1, self.depth)
        return False


def span(phase: str, label: str = ""):
    """Open a flight-recorder span; no-op singleton while telemetry is off.

    Usage: ``with span("flush", bucket.label): ...``. Nested spans record
    their depth so :func:`timeline` renders proper parent/child tracks.
    """
    if not _recorder.ENABLED:
        return _NULL_SPAN
    return _Span(phase, label)


def profiler_range(phase: str, label: str = ""):
    """The ``torch.profiler.record_function`` range of the span ``(phase, label)``, for a call site that times
    itself and records with :func:`record_complete`; the no-op singleton while telemetry is off or no
    profiler records."""
    if not _recorder.ENABLED:
        return _NULL_SPAN
    cls = _annotation_cls()
    if cls is None:
        return _NULL_SPAN
    return cls(phase if not label else f"{phase}:{label}")


def record_complete(phase: str, label: str, t0: float, t1: float) -> None:
    """Record an already-measured ``[t0, t1]`` interval as a leaf span.

    For call sites that already bracket themselves with ``observe.clock()``
    (``metric.py``'s update/compute/merge/sync timers): one extra call, no
    second pair of clock reads, no context-manager overhead. Such a leaf span
    enters no profiler range (the interval is over when it is recorded);
    ``Metric`` opens the range itself around the call it times.
    """
    if not _recorder.ENABLED:
        return
    st = getattr(_LOCAL, "stack", None)
    _record(phase, label, t0, t1, len(st) if st else 0)


# ------------------------------------------------------------------ export
def chrome_events(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Render raw span records as Chrome-trace complete ("X") events.

    ``ts``/``dur`` are microseconds; ``ts`` is rebased so the earliest span in
    the batch sits at 0 (``perf_counter`` has an arbitrary epoch).
    """
    if not spans:
        return []
    base = min(s["t0"] for s in spans)
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    for s in spans:
        events.append(
            {
                "name": s["phase"] if not s["label"] else f'{s["phase"]}:{s["label"]}',
                "cat": s["phase"],
                "ph": "X",
                "ts": (s["t0"] - base) * 1e6,
                "dur": (s["t1"] - s["t0"]) * 1e6,
                "pid": pid,
                "tid": s["tid"],
                "args": {"label": s["label"], "depth": s["depth"]},
            }
        )
    # stable render order: per track, by start time, outermost (longest) first
    events.sort(key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    return events


def timeline() -> Dict[str, Any]:
    """The span ring as a Chrome-trace/Perfetto JSON object.

    ``json.dump(observe.timeline(), f)`` produces a file that loads directly
    in ``chrome://tracing`` or https://ui.perfetto.dev. The ring is bounded
    (``Recorder.max_spans``), so long runs keep the most recent spans;
    ``otherData.spans_total`` counts everything ever recorded.
    """
    rec = _recorder.RECORDER
    with rec._lock:
        spans = list(rec.spans)
        total = rec._span_total
    return {
        "traceEvents": chrome_events(spans),
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "metrics_tpu_torch.observe flight recorder",
            "spans_total": total,
            "spans_retained": len(spans),
        },
    }


def drain_spans() -> List[Dict[str, Any]]:
    """Pop and return every raw span record in the ring (oldest first).

    Latency sketches and the ``spans_total`` counter are untouched — draining
    is for incremental export, not a reset.
    """
    rec = _recorder.RECORDER
    with rec._lock:
        spans = list(rec.spans)
        rec.spans.clear()
    return spans
