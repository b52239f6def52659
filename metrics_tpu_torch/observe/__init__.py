"""metrics_tpu_torch.observe — runtime telemetry (counterpart of ``metrics_tpu/observe``).

* **runtime half** (:mod:`metrics_tpu_torch.observe.recorder`) — near-zero-overhead
  counters/timers/structured events the runtime reports into: per-metric
  update/compute/merge/sync host wall time, rolled-back updates, sync retries
  and degraded merges, per-state sync bytes, checkpoint saves and restores,
  guard quarantines. Off by default; one flag check per counter hook when off.
* **flight recorder** (:mod:`metrics_tpu_torch.observe.tracing` +
  :mod:`metrics_tpu_torch.observe.latency`) — host-side spans in a bounded
  ring, each with its parent's id, folded into per-(phase, label) DDSketch
  latency histograms: the runtime's ``update:``/``compute:``/``merge:``/
  ``sync:``, the collectives, ``validate:``, ``host_read:`` and ``kernel:``.
  While a ``torch.profiler`` capture records, each span is also a
  ``record_function`` range, recorder on or off. Off, with no profiler, a span
  site costs one flag check and one profiler check and allocates nothing.
  Export as Chrome-trace JSON on the profiler's clock (:func:`timeline`),
  Prometheus quantile families (:func:`prometheus`), or fleet-merged
  quantiles (:func:`sync_telemetry`).
* **watchdog rung** (:mod:`metrics_tpu_torch.observe.watchdog` +
  :mod:`metrics_tpu_torch.observe.explain`) — host-side twins of the
  package's own metric designs (TimeDecayed rates, DDSketch quantiles, CUSUM,
  PSI) sampled over the recorder's counters, declarative :class:`SloRule`
  alerting, and recompile-cause attribution.
* **fleet meter** (:mod:`metrics_tpu_torch.observe.metering`) — host-side
  cost & memory attribution for shared dispatches: exact ledgers for the
  top-K tenants, a mergeable SpaceSaving sketch beyond, and an opt-in soft
  quota :class:`MeterPolicy`.

* **static half** (:mod:`metrics_tpu_torch.observe.costs` +
  :mod:`metrics_tpu_torch.observe.profile`) — the cost of one update of each
  profiled class (FLOPs, bytes of the ops it dispatches, peak memory on the
  card), ratcheted against ``metrics_tpu_torch/observe/perf_baseline.json``;
  :mod:`metrics_tpu_torch.observe.overhead` holds the telemetry budget. They
  load lazily.

Quick start::

    from metrics_tpu_torch import observe
    with observe.scope():                  # or observe.enable()
        ...  # run your eval loop
        print(observe.snapshot()["latency"])   # DDSketch p50/p99 per phase
        json.dump(observe.timeline(), open("trace.json", "w"))  # chrome://tracing

The names are those of ``metrics_tpu.observe.__all__``, in its order; the
submodules load lazily (PEP 562).
"""

from metrics_tpu_torch.observe.latency import sync_telemetry
from metrics_tpu_torch.observe.metering import (
    FleetMeter,
    MeterPolicy,
    SpaceSaving,
    install_meter,
    installed_meter,
    uninstall_meter,
)
from metrics_tpu_torch.observe.recorder import (
    RECORDER,
    SCHEMA_VERSION,
    Recorder,
    disable,
    enable,
    enabled,
    poke_watchdog,
    prometheus,
    record_event,
    reset,
    scope,
    snapshot,
    snapshot_json,
)
from metrics_tpu_torch.observe.tracing import drain_spans, record_complete, span, timeline
from metrics_tpu_torch.observe.watchdog import (
    DEFAULT_SLOS,
    SloRule,
    Watchdog,
    install_watchdog,
    installed_watchdog,
    uninstall_watchdog,
)

__all__ = [
    "DEFAULT_SLOS",
    "FleetMeter",
    "MeterPolicy",
    "RECORDER",
    "Recorder",
    "SCHEMA_VERSION",
    "SloRule",
    "SpaceSaving",
    "Watchdog",
    "disable",
    "drain_spans",
    "enable",
    "enabled",
    "install_meter",
    "install_watchdog",
    "installed_meter",
    "installed_watchdog",
    "poke_watchdog",
    "prometheus",
    "record_complete",
    "record_event",
    "reset",
    "scope",
    "snapshot",
    "snapshot_json",
    "span",
    "sync_telemetry",
    "timeline",
    "uninstall_meter",
    "uninstall_watchdog",
]

_LAZY_SUBMODULES = ("costs", "explain", "latency", "metering", "overhead", "profile", "recorder", "tracing", "watchdog")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib

        value = importlib.import_module(f"metrics_tpu_torch.observe.{name}")
        globals()[name] = value
        return value
    raise AttributeError(f"module 'metrics_tpu_torch.observe' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_SUBMODULES))
