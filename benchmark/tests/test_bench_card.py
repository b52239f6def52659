"""On the card: the trace's reading of B1 agrees with CUDA events, and a traced run sees the device busy."""

import pytest
import torch
from conftest import tiny_cell

from benchlib import devtime, roofline
from benchlib.trace import Trace, named, total_us


@pytest.mark.cuda
def test_b1_trace_time_agrees_with_cuda_events(cuda_device, tmp_path):
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _binary_precision_recall_curve_update

    n, t = 1 << 24, 200
    g = torch.Generator(device=cuda_device)
    g.manual_seed(1)
    scores = torch.rand(n, generator=g, device=cuda_device)
    target = (torch.rand(n, generator=g, device=cuda_device) < 0.3).int()
    thr = torch.linspace(0, 1, t, device=cuda_device)
    call = lambda: _binary_precision_recall_curve_update(scores, target, thr)  # noqa: E731
    events_ms = devtime.time_ms(call, reps=10)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    b1 = named(Trace.load(tmp_path / "t.json").kernels, ("binned_counts_kernel",))
    assert len(b1) == 10
    kernel_ms = total_us(b1) / 10 / 1e3
    assert kernel_ms <= events_ms * 1.05
    share = roofline.least_seconds(roofline.binned_confusion_bytes(n, t)) * 1e3 / kernel_ms
    assert 0 < share <= 1.0


@pytest.mark.cuda
def test_a_traced_run_sees_the_device_busy(cuda_device):
    import time

    import run as run_mod
    from benchlib.launch import run_cell

    cell = tiny_cell("criteo_ctr.binned_16m")
    records = run_cell(cell, 5, 0.5, True, "cuda", time.perf_counter())
    out = run_mod.result_line(cell, True, records, cell.driver().judge(cell, 5, cuda_device, records))
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["kernel.b1_roofline_pct"]["value"] <= 100
