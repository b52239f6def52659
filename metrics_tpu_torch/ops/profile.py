"""Device time of each GPU kernel behind the port's two kernel wrappers, by name.

Runs each wrapper at the main path's shapes under ``torch.profiler`` and prints,
for every CUDA kernel or memset it launched, the mean device time per call. It
also runs the binned counts on skewed scores (every score inside one threshold
step), where the shared-memory atomics of a block all hit a few cells, the
(N, C) mode at the multilabel curve's 80 labels (two class chunks), and the
binned counts' labels mode at the multiclass curve's shape.

    python -m metrics_tpu_torch.ops.profile

Needs a CUDA device. The module also holds the cold-L2 CUDA-event timer that
``chip_smoke.py`` and :mod:`metrics_tpu_torch.ops.variants` measure with, and
:func:`kernels_inside`, which reads a ``torch.profiler`` Chrome trace for the
kernels launched inside a telemetry span's ``record_function`` range.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

REPS = 10


def flush_buffer() -> torch.Tensor:
    """256 MB on the card, five times the H100's L2: zeroing it before a timed call leaves the L2 cold."""
    return torch.empty(64 << 20, dtype=torch.float32, device="cuda")


def time_ms(fn, reps: int = 20, flush: torch.Tensor = None) -> float:
    """Mean device time of ``fn`` with a cold L2 (``flush`` zeroed first), from CUDA events around each call.

    A sleep kernel first holds the stream while the host queues every call, so
    the host's launch overhead never opens a gap between the events.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    if hasattr(torch.cuda, "_sleep"):
        torch.cuda._sleep(50_000_000)
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def _profile(fn) -> list:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        device_us = getattr(ev, "self_device_time_total", 0.0)
        if device_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"kernel": ev.key[:90], "calls": ev.count // REPS, "us_per_call": device_us / REPS})
    return sorted(rows, key=lambda r: -r["us_per_call"])


_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def kernels_inside(trace: dict, range_name: str) -> list:
    """Names of the GPU kernels launched inside a CPU range named ``range_name`` (a ``record_function`` range,
    ``user_annotation`` in the trace) of a ``torch.profiler`` Chrome trace (the JSON that
    ``export_chrome_trace`` writes, loaded): a kernel counts when the runtime or driver call that launched it,
    the event with its ``correlation`` id, starts within the range on the range's thread."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    ranges = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == range_name]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in _LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    out = []
    for kernel in events:
        if kernel.get("cat") != "kernel":
            continue
        launch = launches.get(kernel.get("args", {}).get("correlation"))
        if launch is not None and any(
            r["pid"] == launch["pid"] and r["tid"] == launch["tid"] and r["ts"] <= launch["ts"] <= r["ts"] + r["dur"]
            for r in ranges
        ):
            out.append(kernel["name"])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
    from metrics_tpu_torch.functional.image.ssim import _gaussian_taps_np
    from metrics_tpu_torch.ops.binned_hist import binned_counts, binned_counts_labels
    from metrics_tpu_torch.ops.ssim_window import ssim_window

    rng = np.random.default_rng(0)
    cuda = torch.device("cuda")
    thresholds = _adjust_threshold_arg(200, cuda)
    cases = {}
    for label, n, c, skew in [("binary", 1 << 22, 1, False), ("multiclass", 1 << 20, 10, False),
                              ("multilabel", 1 << 18, 80, False), ("binary-skewed", 1 << 22, 1, True)]:
        scores = rng.random((n, c), dtype=np.float32)
        if skew:
            scores = (0.5 + 0.004 * scores).astype(np.float32)  # all inside one threshold step
        args = [torch.from_numpy(scores).to(cuda), torch.from_numpy(rng.integers(0, 2, (n, c), dtype=np.int32)).to(cuda),
                torch.ones((n, c), dtype=torch.bool, device=cuda), thresholds]
        cases[f"binned_counts[{label}]"] = _profile(lambda: binned_counts(*args))
    preds = torch.from_numpy(rng.random((1 << 20, 10), dtype=np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 10, 1 << 20, dtype=np.int32)).to(cuda)
    cases["binned_counts_labels[multiclass]"] = _profile(lambda: binned_counts_labels(preds, labels, thresholds))
    taps = _gaussian_taps_np(11, 1.5)
    x = torch.from_numpy(rng.random((300, 266, 266), dtype=np.float32)).to(cuda)
    cases["ssim_window[300x266x266]"] = _profile(lambda: ssim_window(x, taps, taps))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for name, rows in cases.items():
        print(name)
        for row in rows:
            print(f"  {row['us_per_call']:10.2f} us  x{row['calls']}  {row['kernel']}")
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
