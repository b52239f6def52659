"""The port's spans inside ``update()`` and ``compute()``: validation, host reads, kernel wrappers, on the
profiler's clock.

A collection of ``BinaryAUROC`` and ``BinaryAveragePrecision`` in one compute group beside
``BinaryCalibrationError`` (the Criteo evaluation's, at a test's size on the CPU) records, per update, one
``host_read`` span a group, each under its ``validate`` span under the leader's ``update`` span. Under
``torch.profiler`` with the recorder off the same phases are ranges of the capture and the ring stays empty;
with neither on nothing is recorded or allocated. The ring's export and the capture share one clock. Every
host read of the update (by ``analysis.transfer_contracts``' reading of the ops) happens inside a
``host_read`` span. The disabled overhead budget charges what a disabled update crosses, counted.
"""

from __future__ import annotations

import json
import time
import tracemalloc

import pytest
import torch

import metrics_tpu_torch.classification as tc
from metrics_tpu_torch import MetricCollection
from metrics_tpu_torch import observe as tobs
from metrics_tpu_torch.analysis import transfer_contracts as tca
from metrics_tpu_torch.observe import overhead
from metrics_tpu_torch.observe import recorder as trec
from metrics_tpu_torch.observe import tracing as ttracing

ROWS = 4000
UPDATES = 3


@pytest.fixture(autouse=True)
def _off():
    tobs.disable()
    tobs.reset()
    yield
    tobs.disable()
    tobs.reset()


def _criteo_collection(thresholds=200):
    return MetricCollection(
        {"auroc": tc.BinaryAUROC(thresholds=thresholds, device="cpu"),
         "ap": tc.BinaryAveragePrecision(thresholds=thresholds, device="cpu"),
         "ece": tc.BinaryCalibrationError(n_bins=15, norm="l1", device="cpu")},
        compute_groups=[["auroc", "ap"], ["ece"]],
    )


def _batches(n=UPDATES):
    g = torch.Generator().manual_seed(5)
    return [(torch.rand(ROWS, generator=g), (torch.rand(ROWS, generator=g) < 0.3).long()) for _ in range(n)]


def _range_names(prof):
    return [e.name for e in prof.events()]


def test_each_update_reads_the_host_once_a_group_under_its_validation_and_update():
    col = _criteo_collection()
    tobs.enable(reset=True)
    for preds, target in _batches():
        tobs.drain_spans()
        col.update(preds, target)
        spans = {s["id"]: s for s in tobs.drain_spans()}
        reads = [s for s in spans.values() if s["phase"] == "host_read"]
        assert sorted(s["label"] for s in reads) == ["binary_confusion_matrix.target",
                                                      "binary_precision_recall_curve.target"]
        for read in reads:
            validate = spans[read["parent"]]
            update = spans[validate["parent"]]
            assert validate["phase"] == "validate" and update["phase"] == "update"
            assert update["parent"] is None and (read["depth"], validate["depth"], update["depth"]) == (2, 1, 0)
            assert update["t0"] <= validate["t0"] <= read["t0"] <= read["t1"] <= validate["t1"] <= update["t1"]
        leaders = sorted(spans[spans[r["parent"]]["parent"]]["label"] for r in reads)
        assert leaders == ["BinaryAUROC", "BinaryCalibrationError"]
    assert trec.snapshot()["counters"]["explicit_transfer"] == {
        "binary_confusion_matrix.target": UPDATES, "binary_precision_recall_curve.target": UPDATES}
    events = tobs.timeline()["traceEvents"]
    assert events == []  # drained
    col.compute()
    timeline = tobs.timeline()
    by_name = {e["name"]: e for e in timeline["traceEvents"]}
    assert {"compute:BinaryAUROC", "compute:BinaryAveragePrecision", "compute:BinaryCalibrationError"} <= set(by_name)
    for e in timeline["traceEvents"]:
        assert set(e["args"]) == {"label", "depth", "id", "parent", "self_us"}
        assert 0.0 <= e["args"]["self_us"] <= e["dur"] + 1e-6


def test_a_span_s_self_time_leaves_out_its_children():
    tobs.enable(reset=True)
    with tobs.span("epoch", "eval"):
        with tobs.span("step", "a"):
            time.sleep(0.01)
        time.sleep(0.002)
    events = {e["name"]: e for e in tobs.timeline()["traceEvents"]}
    outer, inner = events["epoch:eval"], events["step:a"]
    assert inner["args"]["parent"] == outer["args"]["id"] and outer["args"]["parent"] is None
    assert outer["args"]["self_us"] == pytest.approx(outer["dur"] - inner["dur"], abs=1e-3)
    assert inner["args"]["self_us"] == pytest.approx(inner["dur"], abs=1e-3)


def test_the_profiler_sees_the_phases_with_the_recorder_off_and_the_ring_stays_empty():
    col = _criteo_collection()
    batches = _batches(2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for preds, target in batches:
            col.update(preds, target)
        col.compute()
    names = _range_names(prof)
    for expected in ("update:BinaryAUROC", "update:BinaryCalibrationError", "validate:binary_precision_recall_curve",
                     "validate:binary_confusion_matrix", "host_read:binary_precision_recall_curve.target",
                     "host_read:binary_confusion_matrix.target", "kernel:binned_counts", "compute:BinaryAUROC",
                     "compute:BinaryAveragePrecision", "compute:BinaryCalibrationError"):
        assert expected in names, expected
    assert names.count("host_read:binary_confusion_matrix.target") == 2
    assert names.count("kernel:binned_counts") == 2  # one call an update of the group's leader
    rec = trec.RECORDER
    assert len(rec.spans) == 0 and rec._span_total == 0 and rec.latency == {} and rec.counters == {}


def test_the_exact_curves_compute_reads_inside_host_read_ranges():
    col = _criteo_collection(thresholds=None)
    for preds, target in _batches(2):
        col.update(preds, target)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        col.compute()
    names = _range_names(prof)
    assert names.count("host_read:binary_clf_curve.distinct") == 2  # AUROC's curve and AP's
    assert "host_read:binary_roc.no_negatives" in names
    assert "host_read:binary_precision_recall_curve.any_positive" in names


def test_with_neither_on_an_update_records_nothing_and_allocates_nothing_in_observe():
    col = _criteo_collection()
    batches = _batches(4)
    col.update(*batches[0])
    files = [ttracing.__file__, trec.__file__]
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for preds, target in batches[1:]:
            col.update(preds, target)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = []
    for path in files:
        mine = tracemalloc.Filter(True, path)
        grown += [d for d in after.filter_traces([mine]).compare_to(before.filter_traces([mine]), "lineno")
                  if d.size_diff > 0]
    assert grown == []
    rec = trec.RECORDER
    assert len(rec.spans) == 0 and rec._span_total == 0 and rec.counters == {} and rec.timers == {}


def test_a_span_and_its_profiler_range_meet_on_one_clock(tmp_path):
    tobs.enable(reset=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.span("probe", "warm-up"):  # a capture's first range pays the profiler's set-up on entry
            pass
        with tobs.span("probe", "clock"):
            time.sleep(0.005)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    [captured] = [e for e in trace["traceEvents"] if e.get("name") == "probe:clock" and e.get("ph") == "X"]
    [mine] = [e for e in tobs.timeline()["traceEvents"] if e["name"] == "probe:clock"]
    base_us = trace["baseTimeNanoseconds"] / 1000
    assert abs(mine["ts"] - (captured["ts"] + base_us)) < 1000  # both Unix microseconds
    assert mine["dur"] == pytest.approx(captured["dur"], abs=1000)
    assert "baseTimeNanoseconds" in tobs.timeline()["otherData"]["merge_with_torch_profiler"]


class _ReadSites(tca.HostReadRecorder):
    """Each host read, as the transfer contract reads the ops, with the ``host_read`` span open at it."""

    def __init__(self) -> None:
        super().__init__()
        self.sites = []

    def note(self, what: str) -> None:
        open_read = next((s.label for s in reversed(ttracing._stack()) if s.phase == "host_read"), None)
        self.sites.append((what, open_read))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):  # noqa: ANN001
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        what = tca._host_read(func, args, kwargs, out)
        if what:
            self.note(what)
        return out


@pytest.mark.parametrize("thresholds", [200, None], ids=["binned", "exact"])
def test_every_host_read_of_an_update_is_inside_a_host_read_span(thresholds):
    col = _criteo_collection(thresholds)
    batches = _batches(2)
    col.update(*batches[0])
    tobs.enable(reset=True)
    with _ReadSites() as recorder:
        col.update(*batches[1])
    assert recorder.sites, "the update's validations read the host"
    assert [site for _, site in recorder.sites if site is None] == []
    assert {site for _, site in recorder.sites} == {"binary_precision_recall_curve.target",
                                                    "binary_confusion_matrix.target"}


def _disabled_update_sites(monkeypatch):
    """(spans, checks) one disabled ``MulticlassAccuracy.update`` of the overhead loop crosses, counted."""
    import metrics_tpu_torch.metric as tmetric

    calls = {"span": 0, "profiling": 0, "transfer": 0}
    real_span, real_profiling, real_note = ttracing.span, ttracing.profiling, trec.note_explicit_transfer

    def counting(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    metric = tc.MulticlassAccuracy(num_classes=8, device="cpu")
    preds, target = torch.arange(32) % 8, (torch.arange(32) + 1) % 8
    metric.update(preds, target)
    monkeypatch.setattr(ttracing, "span", counting("span", real_span))
    monkeypatch.setattr(ttracing, "profiling", counting("profiling", real_profiling))
    monkeypatch.setattr(trec, "note_explicit_transfer", counting("transfer", real_note))
    flag_reads = [0]

    class _Flag:
        def __getattr__(self, name):
            if name == "ENABLED":
                flag_reads[0] += 1
            return getattr(trec, name)

    monkeypatch.setattr(tmetric, "_observe", _Flag())
    metric.update(preds, target)
    # the update's own flag and profiler checks, and one flag check a counted host read; a null span makes its
    # own profiler check, charged with the span
    return calls["span"], flag_reads[0] + calls["profiling"] - calls["span"] + calls["transfer"]


def test_the_overhead_budget_charges_what_a_disabled_update_crosses(monkeypatch):
    spans, checks = _disabled_update_sites(monkeypatch)
    assert (spans, checks) == (overhead.SPANS_PER_STEP, overhead.CHECKS_PER_STEP)
