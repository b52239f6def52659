"""The readers of the program's own ranges, on synthetic traces: what each counts, and that each reads None
on the trace of a program that opens none of them."""

import pytest

from benchlib.cells import Cell
from benchlib.spans import overlap_us
from benchlib.trace import Trace


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def _launch(ts, corr):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr)


def _kernel(name, ts, dur, corr):
    return _ev("kernel", name, ts, dur, tid=7, correlation=corr)


class _View:
    def __init__(self, events, cell="criteo_ctr.exact_ddp4", **record):
        self.trace = Trace(events)
        self.cell = Cell(cell)
        self.record = {"traced_passes": 1, "update_units": [100, 50], **record}


def _reader(name, cell="criteo_ctr.exact_ddp4"):
    return Cell(cell).layer_reader(name)


# a traced pass of two updates and a compute, with no range of the program's: an older program's trace
BARE = [
    _ev("user_annotation", "bench.pass", 0, 300),
    _ev("user_annotation", "bench.update", 0, 100),
    _ev("user_annotation", "bench.update", 100, 100),
    _ev("user_annotation", "bench.compute", 200, 100),
    _launch(10, 1), _kernel("k", 20, 30, 1),
    _launch(210, 2), _kernel("k", 220, 30, 2),
]


def test_host_reads_are_counted_inside_the_updates_per_update():
    events = BARE + [
        _ev("user_annotation", "validate:binary_precision_recall_curve", 5, 20),
        _ev("user_annotation", "host_read:binary_precision_recall_curve.target", 10, 5),
        _ev("user_annotation", "host_read:binary_confusion_matrix.target", 40, 5),
        _ev("user_annotation", "host_read:binary_precision_recall_curve.target", 110, 5),
        _ev("user_annotation", "host_read:binary_confusion_matrix.target", 140, 5),
        _ev("user_annotation", "host_read:binary_clf_curve.distinct", 230, 5),  # at compute: not an update's
        _ev("user_annotation", "host_read:binary_confusion_matrix.target", 40, 5, tid=2),  # another thread
    ]
    reader = _reader("functional.host_reads_per_update.criteo")
    assert reader.measure(_View(events)) == 2.0
    assert reader.measure(_View(events, traced_passes=2)) == 1.0
    assert reader.combine([2.0, 3.0, 2.0]) == 3.0
    # a program that validates without reading the host reads 0, not nothing
    quiet = BARE + [_ev("user_annotation", "validate:binary_precision_recall_curve", 5, 20)]
    assert reader.measure(_View(quiet)) == 0.0


def test_idle_in_validation_is_the_device_idle_time_under_validate_ranges():
    events = BARE + [
        _ev("user_annotation", "validate:binary_precision_recall_curve", 0, 30),  # idle 0-20 (kernel 20-50)
        _ev("user_annotation", "validate:binary_confusion_matrix", 60, 30),       # idle throughout
    ]
    pct = _reader("device.idle_in_validate_pct.criteo").measure(_View(events))
    assert pct == pytest.approx(100.0 * (20 + 30) / 300)
    assert overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10


def test_ece_compute_leaves_out_its_sync():
    events = BARE + [
        _ev("user_annotation", "compute:BinaryCalibrationError", 200, 60),
        _ev("user_annotation", "sync:BinaryCalibrationError", 230, 20),
        _ev("user_annotation", "compute:BinaryAUROC", 260, 40),
        _launch(235, 3), _kernel("ncclDevKernel_AllGather", 240, 500, 3),
        _launch(262, 4), _kernel("radixSort", 280, 7, 4),
    ]
    ece = _reader("functional.ece_compute_device_ms.criteo").measure(_View(events))
    assert ece == pytest.approx(30e-3)  # the kernel of correlation 2, not the gather
    curve = _reader("functional.curve_compute_device_ms.criteo").measure(_View(events, traced_passes=2))
    assert curve == pytest.approx(3.5e-3)


def test_curves_compute_sums_both_members():
    events = BARE + [
        _ev("user_annotation", "compute:BinaryAUROC", 200, 50),
        _ev("user_annotation", "compute:BinaryAveragePrecision", 250, 50),
        _launch(255, 3), _kernel("gather", 260, 10, 3),
    ]
    assert _reader("functional.curve_compute_device_ms.criteo").measure(_View(events)) == pytest.approx(40e-3)


def test_b2_device_time_is_read_inside_its_wrapper_per_frame():
    events = BARE + [
        _ev("user_annotation", "kernel:ssim_window", 5, 10),
        _ev("user_annotation", "kernel:ssim_window", 105, 10),
        _launch(106, 3), _kernel("renamed_windowed_sum", 120, 60, 3),
    ]
    view = _View(events, cell="div2k_sr.hr_b4", traced_passes=2, update_units=[4, 4, 2])
    got = _reader("kernel.b2_device_ms_per_frame.div2k", "div2k_sr.hr_b4").measure(view)
    assert got == pytest.approx((30 + 60) / 1e3 / 20)


def test_b1_first_launch_is_the_program_s_own_reading(monkeypatch):
    from metrics_tpu_torch.ops import _native

    reader = _reader("kernel.b1_first_launch_s.criteo", "criteo_ctr.binned_16m")
    monkeypatch.setattr(_native, "first_launch_s", {"binned_hist": 5.6})
    assert reader.measure(None) == 5.6
    monkeypatch.setattr(_native, "first_launch_s", {})
    assert reader.measure(None) is None
    monkeypatch.delattr(_native, "first_launch_s")
    assert reader.measure(None) is None


@pytest.mark.parametrize("name,cell", [
    ("functional.host_reads_per_update.criteo", "criteo_ctr.binned_16m"),
    ("device.idle_in_validate_pct.criteo", "criteo_ctr.exact_16m"),
    ("functional.ece_compute_device_ms.criteo", "criteo_ctr.exact_16m"),
    ("functional.curve_compute_device_ms.criteo", "criteo_ctr.exact_16m"),
    ("kernel.b2_device_ms_per_frame.div2k", "div2k_sr.hr_b4"),
])
def test_a_program_without_the_ranges_reads_none(name, cell):
    reader = _reader(name, cell)
    assert "observe" not in getattr(reader, "NEEDS", ())
    assert reader.measure(_View(BARE, cell=cell)) is None
    view = _View(BARE, cell=cell)
    view.trace = None
    assert reader.measure(view) is None
