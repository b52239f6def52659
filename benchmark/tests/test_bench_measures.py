"""The arithmetic behind the metrics: rooflines from shapes, the p95 over every pass, idle shares."""

import math

import pytest

from benchlib import readers, roofline, stats, traffic
from benchlib.trace import Trace, breakdown, busy_idle, merge


def test_b1_bytes_follow_the_kernel_table():
    # the table's binary row: 2^22 scores x 200 thresholds, bound 0.01127 ms at 3.35 TB/s
    nbytes = roofline.binned_confusion_bytes(1 << 22, 200)
    assert nbytes == (1 << 22) * 9 + 200 * 16
    assert roofline.least_seconds(nbytes) * 1e3 == pytest.approx(0.01127, abs=5e-6)


def test_b2_bytes_follow_the_kernel_table():
    # the table's DIV2K row: 15 planes 1366 x 2050 -> 1356 x 2040, 11 x 11, bound 0.09970 ms
    nbytes = roofline.windowed_sum_bytes(15, 1366, 2050, 11, 11)
    assert nbytes == 15 * (1366 * 2050 + 1356 * 2040) * 4
    assert roofline.least_seconds(nbytes) * 1e3 == pytest.approx(0.09970, abs=5e-5)


def test_ssim_calls_of_the_div2k_batch():
    ssim = roofline.ssim_window_calls(4, 3, 1356, 2040, 11, 1)
    ms = roofline.ssim_window_calls(4, 3, 1356, 2040, 11, 5)
    assert ssim == [(60, 1366, 2050)]
    assert ms == [(60, 1366, 2050), (60, 688, 1030), (60, 349, 520), (60, 179, 265), (60, 94, 137)]


def test_schedule_of_each_mix():
    assert traffic.schedule(45_840_617, {"units_per_update": 1 << 24}) == [
        (0, 1 << 24), (1 << 24, 1 << 25), (1 << 25, 45_840_617)]
    ranks = [traffic.schedule(45_840_617, {"units_per_update": None}, r, 4) for r in range(4)]
    assert [e - s for [(s, e)] in ranks] == [11_460_155, 11_460_154, 11_460_154, 11_460_154]
    assert ranks[0][0][0] == 0 and ranks[3][0][1] == 45_840_617
    assert len(traffic.schedule(100, {"units_per_update": 4})) == 25


def test_compute_p95_is_over_every_pass():
    # 100 passes: 94 fast, 6 slow; the nearest-rank p95 is the 95th value, not a median of chunks
    times = [0.050, 0.060, 0.070, 0.080, 0.090, 0.100] + [0.010] * 94
    rec = {"passes": 100, "compute_s": times}
    assert readers.compute_p95_ms([rec]) == pytest.approx(50.0)
    assert stats.percentile(list(range(1, 21)), 95) == 19


def test_compute_p95_counts_the_slowest_rank_of_each_pass():
    a = {"passes": 3, "compute_s": [0.01, 0.02, 0.03]}
    b = {"passes": 3, "compute_s": [0.05, 0.01, 0.01]}
    assert readers.compute_p95_ms([a, b]) == pytest.approx(50.0)
    assert readers.compute_p95_ms([{"passes": 2, "compute_s": [0.01, math.nan]}]) is None


def test_units_per_s_counts_a_pass_once():
    recs = [{"units_per_pass": 1000, "passes": 10, "window_s": 2.0}, {"units_per_pass": 1000, "passes": 10,
                                                                       "window_s": 2.1}]
    assert readers.units_per_s(recs) == 5000.0


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1, "args": args}


def test_idle_share_of_a_synthetic_timeline():
    events = [
        _ev("user_annotation", "bench.pass", 0, 100),
        _ev("user_annotation", "bench.update", 0, 60),
        _ev("user_annotation", "bench.compute", 60, 40),
        _ev("kernel", "k1", 10, 20), _ev("kernel", "k2", 25, 15),  # overlapping: busy 10-40
        _ev("gpu_memcpy", "copy", 70, 10),                         # busy 70-80
        _ev("kernel", "late", 150, 10),                            # outside the window
    ]
    tr = Trace(events)
    lo, hi = tr.window()
    busy, gaps = busy_idle(tr.device_ops, lo, hi)
    assert (lo, hi, busy) == (0, 100, 40.0)
    assert gaps == [(0, 10), (40, 70), (80, 100)]
    bd = breakdown(tr)
    assert [k for k, _ in bd["idle_gaps"]] == ["update", "compute"]
    assert [v for _, v in bd["idle_gaps"]] == pytest.approx([40e-6, 20e-6])
    assert bd["device_ops"][0][0] == "k1" and bd["device_ops"][0][1] == pytest.approx(20e-6)
    assert merge([(5, 1)], 0, 10) == []


def test_kernels_inside_a_range_follow_their_launch():
    events = [
        _ev("user_annotation", "bench.compute", 100, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=7),
        _ev("cuda_runtime", "cudaLaunchKernel", 160, 2, correlation=8),
        _ev("kernel", "inside", 300, 5, correlation=7),
        _ev("kernel", "outside", 310, 5, correlation=8),
    ]
    assert [k["name"] for k in Trace(events).kernels_inside("bench.compute")] == ["inside"]


def test_compute_device_time_leaves_the_exchange_to_the_sync_layer():
    from benchlib.cells import Cell

    events = [
        _ev("user_annotation", "bench.compute", 100, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=7),
        _ev("cuda_runtime", "cudaLaunchKernel", 120, 2, correlation=8),
        _ev("kernel", "radixSort", 300, 5, correlation=7),
        _ev("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 310, 40, correlation=8),
    ]

    class View:
        trace = Trace(events)
        record = {"traced_passes": 1}

    reader = Cell("criteo_ctr.exact_ddp4").layer_reader("functional.compute_device_ms.criteo")
    assert reader.measure(View()) == pytest.approx(5e-3)


def test_idle_reader_needs_a_trace():
    class View:
        trace = None
        record = {}

    assert readers.idle_pct(View()) is None
