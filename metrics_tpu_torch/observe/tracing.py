"""Flight-recorder spans: nested host-side phase timing with a bounded ring (counterpart of
``metrics_tpu/observe/tracing.py``).

The counters/timers in :mod:`metrics_tpu_torch.observe.recorder` answer *how
much*; spans answer *when* and *inside what*. A span is a ``with``-scoped
interval tagged ``(phase, label)`` — ``span("ckpt", "save")`` nested inside a
caller's own ``span("epoch", "eval")`` — recorded into a bounded ring on the
process-wide :data:`~metrics_tpu_torch.observe.recorder.RECORDER` and folded
into the per-phase DDSketch latency histograms of
:mod:`metrics_tpu_torch.observe.latency`. Each record carries its ``id`` and
the ``id`` of the span it was opened in (``parent``, None at the root), so a
span's self time is its duration less what its children cover.

The runtime's own phases are spans: ``Metric``'s ``update:``, ``compute:``,
``merge:`` and ``sync:`` (``<Class>``), the collectives' ``gather_all:<world>``
and ``allreduce:data``, each input validation that reads the card
(``validate:<task>``), each deliberate host read (``host_read:<site>``) and
each kernel wrapper's call (``kernel:<wrapper>``).

Profiler ranges: while a ``torch.profiler`` capture records, every span enters
a ``torch.profiler.record_function`` range named ``phase:label``, whether the
recorder is on or not, so that in the capture the program's phases enclose the
kernels they launched.

Overhead contract: while the recorder is off and no profiler records,
:func:`span` makes one module-flag check and one check of whether a profiler
records (``torch.autograd._profiler_enabled``), and returns a preallocated
no-op singleton — zero allocations, nothing appended anywhere. While a profiler
records and the recorder is off, it returns the bare profiler range: the
capture sees the phase, the ring, the timers and the latency sketches see
nothing. Spans time *host-side* sections: on a CUDA device that is the time to
enqueue the section's kernels; nothing here synchronizes with the card.

Clock: the hot path reads ``perf_counter``; :func:`~metrics_tpu_torch.observe.recorder.enable`
takes one anchor pair ``(perf_counter(), time_ns())``, and the export writes
``ts`` in Unix microseconds, the clock of a ``torch.profiler`` Chrome trace
(whose events read ``ts + baseTimeNanoseconds / 1000`` in the same unit): less
a trace's ``baseTimeNanoseconds / 1000``, the ring's events join the capture's
in one file, each span over the kernels it launched.

Export: :func:`timeline` renders the ring as Chrome-trace/Perfetto JSON
(``chrome://tracing``, https://ui.perfetto.dev); :func:`drain_spans` pops the
raw records for incremental export.
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Any, Dict, List, Optional

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

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
    """Shared no-op context manager returned while the recorder is off and no profiler records."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()

_LOCAL = threading.local()
_IDS = itertools.count(1)

profiling = _profiler_enabled
"""Whether a ``torch.profiler`` capture records in this process right now (a C function, about 80 ns)."""


def _range(phase: str, label: str) -> record_function:
    """A fresh ``record_function`` range named ``phase:label``."""
    return record_function(phase if not label else f"{phase}:{label}")


def _stack() -> List["_Span"]:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def _record(phase: str, label: str, t0: float, t1: float, depth: int, span_id: int, parent: Optional[int]) -> None:
    rec = _recorder.RECORDER
    entry = {
        "phase": phase,
        "label": label,
        "t0": t0,
        "t1": t1,
        "depth": depth,
        "id": span_id,
        "parent": parent,
        "tid": threading.get_ident(),
    }
    with rec._lock:
        rec._span_total += 1
        rec.spans.append(entry)
    _latency.observe_duration(phase, label, t1 - t0)


class _Span:
    """A recorded span: pushed on the thread's span stack for its extent, recorded into the ring on exit.

    A ``timed`` span is one of the runtime's timed calls: on a normal exit its duration also goes to the
    recorder's ``(phase, label)`` timer, and a call that raises records nothing (as the call's timer never
    counts it)."""

    __slots__ = ("phase", "label", "t0", "t1", "depth", "id", "parent", "timed", "_annot")

    def __init__(self, phase: str, label: str, timed: bool = False) -> None:
        self.phase = phase
        self.label = label
        self.timed = timed
        self._annot: Any = None

    def __enter__(self) -> "_Span":
        st = _stack()
        self.depth = len(st)
        self.parent = st[-1].id if st else None
        self.id = next(_IDS)
        st.append(self)
        if profiling():
            try:
                annot = _range(self.phase, self.label)
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
        if self.timed:
            if exc_type is not None:
                return False
            _recorder.RECORDER.add_time(self.phase, self.label, self.t1 - self.t0)
        _record(self.phase, self.label, self.t0, self.t1, self.depth, self.id, self.parent)
        return False


def span(phase: str, label: str = ""):
    """Open a flight-recorder span: recorded while the recorder is on, a bare profiler range while only a
    profiler records, else the no-op singleton.

    Usage: ``with span("flush", bucket.label): ...``. Nested spans record
    their depth and their parent's id, so :func:`timeline` renders proper
    parent/child tracks.
    """
    if _recorder.ENABLED:
        return _Span(phase, label)
    if profiling():
        return _range(phase, label)
    return _NULL_SPAN


def timed_span(phase: str, label: str) -> _Span:
    """A recorded span whose duration also goes to the recorder's ``(phase, label)`` timer; for the runtime's
    timed calls, which check that the recorder is on first."""
    return _Span(phase, label, timed=True)


def profiler_range(phase: str, label: str = ""):
    """The ``torch.profiler.record_function`` range of the span ``(phase, label)`` while a profiler records,
    the recorder on or off; else the no-op singleton. Nothing is recorded into the ring."""
    if not profiling():
        return _NULL_SPAN
    return _range(phase, label)


def record_complete(phase: str, label: str, t0: float, t1: float) -> None:
    """Record an already-measured ``[t0, t1]`` interval as a leaf span of the span open on this thread.

    For a caller that bracketed a section with ``observe.clock()`` itself: one
    extra call, no context-manager overhead. Such a leaf enters no profiler
    range (the interval is over when it is recorded). The port's own call sites
    open real spans instead, so that what runs inside them nests.
    """
    if not _recorder.ENABLED:
        return
    st = getattr(_LOCAL, "stack", None)
    _record(phase, label, t0, t1, len(st) if st else 0, next(_IDS), st[-1].id if st else None)


# ------------------------------------------------------------------ export
def chrome_events(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Render raw span records as Chrome-trace complete ("X") events.

    ``ts``/``dur`` are microseconds; ``ts`` is Unix microseconds, the clock of a
    ``torch.profiler`` trace. ``args`` carries
    each span's ``id``, ``parent``, depth and self time (``self_us``: its
    duration less what its children in ``spans`` cover).
    """
    if not spans:
        return []
    perf0, unix0_ns = _recorder.clock_anchor()
    offset_us = unix0_ns / 1000.0
    child_s: Dict[Any, float] = {}
    for s in spans:
        if s.get("parent") is not None:
            child_s[s["parent"]] = child_s.get(s["parent"], 0.0) + (s["t1"] - s["t0"])
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    for s in spans:
        dur_s = s["t1"] - s["t0"]
        events.append(
            {
                "name": s["phase"] if not s["label"] else f'{s["phase"]}:{s["label"]}',
                "cat": s["phase"],
                "ph": "X",
                "ts": (s["t0"] - perf0) * 1e6 + offset_us,
                "dur": dur_s * 1e6,
                "pid": pid,
                "tid": s["tid"],
                "args": {
                    "label": s["label"],
                    "depth": s["depth"],
                    "id": s.get("id"),
                    "parent": s.get("parent"),
                    "self_us": max(0.0, dur_s - child_s.get(s.get("id"), 0.0)) * 1e6,
                },
            }
        )
    # stable render order: per track, by start time, outermost (longest) first
    events.sort(key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    return events


def timeline() -> Dict[str, Any]:
    """The span ring as a Chrome-trace/Perfetto JSON object.

    ``json.dump(observe.timeline(), f)`` produces a file that loads directly
    in ``chrome://tracing`` or https://ui.perfetto.dev. ``ts`` is Unix
    microseconds: less a ``torch.profiler`` trace's ``baseTimeNanoseconds /
    1000`` it is on that trace's own ``ts`` scale, and the ``traceEvents`` of
    both can be concatenated into one file. The ring is
    bounded (``Recorder.max_spans``), so long runs keep the most recent spans;
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
            "clock": "ts is Unix microseconds",
            "merge_with_torch_profiler": "subtract the trace's baseTimeNanoseconds / 1000 from each ts",
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
