#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is skipped:

1. print the card's name and power limit (``nvidia-smi``); no CUDA device -> exit 1;
2. build the kernel libraries from ``metrics_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
3. hold each kernel against its plain PyTorch version on the card: the binned
   counts integer-equal, the SSIM window within ``SSIM_RTOL``/``SSIM_ATOL``;
4. the main path through the public classes on ``device="cuda"``, each result
   checked against the same inputs run through the port on the CPU, with every
   kernel's launch count set to 0 before and read after;
5. time each kernel, its plain version and (for the window) one library call
   with CUDA events at the main path's shapes, beside the least time the card
   could take (``bound_ms``);
6. print the kernels' JSON line and, last, the device JSON line.

Inputs come from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SSIM_RTOL, SSIM_ATOL = 1e-5, 1e-6  # window sums of values in [0, 1]; the kernel keeps the plain order of roundings
ACC_BATCH, ACC_CLASSES, ACC_STEPS = 1 << 20, 10, 50
PRC_THRESHOLDS, BIN_N, MC_N, PRC_STEPS = 200, 1 << 22, 1 << 20, 3
SSIM_SHAPE, SSIM_STEPS = (20, 3, 256, 256), 3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _flush_buffer() -> torch.Tensor:
    return torch.empty(64 << 20, dtype=torch.float32, device="cuda")  # 256 MB, five times the L2


def time_ms(fn, reps: int = 20, flush: torch.Tensor = None) -> float:
    """Mean device time of ``fn`` with a cold L2, from CUDA events around each call.

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


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------------- phase 3
def check_kernels(rng: np.random.Generator) -> dict:
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
    from metrics_tpu_torch.functional.image.ssim import _gaussian_taps_np
    from metrics_tpu_torch.ops.binned_hist import binned_counts, binned_counts_plain
    from metrics_tpu_torch.ops.ssim_window import ssim_window, ssim_window_plain

    def binned_args(n, c, t):
        return [
            torch.from_numpy(rng.random((n, c), dtype=np.float32)).cuda(),
            torch.from_numpy(rng.integers(0, 2, (n, c), dtype=np.int32)).cuda(),
            torch.from_numpy(rng.random((n, c)) > 0.1).cuda(),
            _adjust_threshold_arg(t, torch.device("cuda")),
        ]

    nan, inf = float("nan"), float("inf")
    edge = [
        torch.tensor([[0.0], [0.25], [0.5], [0.5], [1.0], [nan], [0.75], [inf], [-inf]]).cuda(),
        torch.tensor([[0], [1], [1], [0], [1], [1], [1], [1], [0]], dtype=torch.int32).cuda(),
        torch.tensor([[True]] * 6 + [[False]] + [[True]] * 2).cuda(),
        torch.tensor([0.0, 0.25, 0.5, 0.5, 1.0, nan]).cuda(),
    ]
    # the shapes of tests/test_binned_hist_kernel.py, the edge cases, one too wide for shared memory, full size
    cases = [binned_args(*s) for s in [(100, 1, 5), (257, 3, 17), (1000, 4, 100), (50, 2, 129), (8, 1, 1),
                                       (4096, 300, 200), (BIN_N, 1, PRC_THRESHOLDS), (MC_N, 10, PRC_THRESHOLDS)]]
    binned_err = 0
    for args in cases + [edge]:
        got = binned_counts(*args)
        for g, w in zip(got, binned_counts_plain(*args)):
            binned_err = max(binned_err, int((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):
                fail(f"binned_counts differs from its plain version at shape {tuple(args[0].shape)}")
    torch.cuda.synchronize()
    log(f"binned_counts: integer-equal to the plain version on {len(cases) + 1} cases")

    taps = _gaussian_taps_np(11, 1.5)
    ssim_err = 0.0
    for shape, kh, kw in [((12, 42, 74), taps, taps), ((6, 20, 40), taps, _gaussian_taps_np(5, 0.8)),
                          ((5 * SSIM_SHAPE[0] * SSIM_SHAPE[1], SSIM_SHAPE[2] + 10, SSIM_SHAPE[3] + 10), taps, taps)]:
        x = torch.from_numpy(rng.random(shape, dtype=np.float32)).cuda()
        got, want = ssim_window(x, kh, kw), ssim_window_plain(x, kh, kw)
        if not torch.allclose(got, want, rtol=SSIM_RTOL, atol=SSIM_ATOL):
            fail(f"ssim_window differs from its plain version at shape {shape}")
        ssim_err = max(ssim_err, float((got - want).abs().max()))
    torch.cuda.synchronize()
    log(f"ssim_window: allclose (rtol {SSIM_RTOL}, atol {SSIM_ATOL}); max |err| {ssim_err}")
    return {"binned_counts": float(binned_err), "ssim_window": ssim_err}


# ----------------------------------------------------------------------------- phase 4
def _same_counts(name, port, ref):
    for key in port.metric_state:
        a, b = getattr(port, key), getattr(ref, key)
        if not torch.equal(a.cpu(), b):
            fail(f"{name}: state {key} on the card differs from the CPU run")


def main_path(seed: int) -> dict:
    from metrics_tpu_torch.classification import (
        BinaryPrecisionRecallCurve,
        MulticlassAccuracy,
        MulticlassPrecisionRecallCurve,
    )
    from metrics_tpu_torch.image import StructuralSimilarityIndexMeasure

    out = {}
    rng = np.random.default_rng(seed)

    def run(name, make, batches):
        gpu, cpu = make("cuda"), make("cpu")
        update_ms = []
        for a, b in batches():
            a_gpu, b_gpu = a.cuda(), b.cuda()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gpu.update(a_gpu, b_gpu)
            torch.cuda.synchronize()
            update_ms.append(1000 * (time.perf_counter() - t0))
            cpu.update(a, b)
        got, want = gpu.compute(), cpu.compute()
        torch.cuda.synchronize()
        # the first update also pays one-time costs (e.g. the first use of an operator), so it is kept apart
        out[name] = {"updates": gpu.update_count, "first_update_ms": update_ms[0],
                     "later_update_ms_median": float(np.median(update_ms[1:]))}
        return gpu, cpu, got, want

    def acc_batches():
        for _ in range(ACC_STEPS):
            yield (torch.from_numpy(rng.random((ACC_BATCH, ACC_CLASSES), dtype=np.float32)),
                   torch.from_numpy(rng.integers(0, ACC_CLASSES, ACC_BATCH)))

    gpu, cpu, got, want = run("MulticlassAccuracy", lambda d: MulticlassAccuracy(
        num_classes=ACC_CLASSES, average="micro", device=d), acc_batches)
    _same_counts("MulticlassAccuracy", gpu, cpu)
    if not (torch.isfinite(got) and float(got) == float(want)):
        fail(f"MulticlassAccuracy {float(got)} on the card, {float(want)} on the CPU")
    out["MulticlassAccuracy"]["value"] = float(got)

    def prc_batches(n, c):
        def gen():
            for _ in range(PRC_STEPS):
                shape = (n,) if c == 1 else (n, c)
                yield (torch.from_numpy(rng.random(shape, dtype=np.float32)),
                       torch.from_numpy(rng.integers(0, 2 if c == 1 else c, n)))
        return gen

    for name, make, n, c in [
        ("BinaryPrecisionRecallCurve", lambda d: BinaryPrecisionRecallCurve(thresholds=PRC_THRESHOLDS, device=d),
         BIN_N, 1),
        ("MulticlassPrecisionRecallCurve", lambda d: MulticlassPrecisionRecallCurve(
            num_classes=10, thresholds=PRC_THRESHOLDS, device=d), MC_N, 10),
    ]:
        gpu, cpu, got, want = run(name, make, prc_batches(n, c))
        _same_counts(name, gpu, cpu)
        for g, w in zip(got, want):
            if g.shape != w.shape or not bool(torch.isfinite(g).all()) or not torch.allclose(g.cpu(), w, rtol=1e-6):
                fail(f"{name}: curve on the card differs from the CPU run")
        out[name]["curve_shape"] = list(got[0].shape)

    def ssim_batches():
        for _ in range(SSIM_STEPS):
            a = rng.random(SSIM_SHAPE, dtype=np.float32)
            b = (0.75 * a + 0.25 * rng.random(SSIM_SHAPE, dtype=np.float32)).astype(np.float32)
            yield torch.from_numpy(a), torch.from_numpy(b)

    gpu, cpu, got, want = run("StructuralSimilarityIndexMeasure",
                              lambda d: StructuralSimilarityIndexMeasure(data_range=1.0, device=d), ssim_batches)
    if not (bool(torch.isfinite(got)) and abs(float(got) - float(want)) <= 1e-5):
        fail(f"SSIM {float(got)} on the card, {float(want)} on the CPU")
    out["StructuralSimilarityIndexMeasure"]["value"] = float(got)
    out["StructuralSimilarityIndexMeasure"]["abs_diff_vs_cpu"] = abs(float(got) - float(want))
    return out


# ----------------------------------------------------------------------------- phase 5
def measure(rng: np.random.Generator) -> dict:
    import torch.nn.functional as F

    from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
    from metrics_tpu_torch.functional.image.ssim import _gaussian_taps_np
    from metrics_tpu_torch.ops.binned_hist import binned_counts, binned_counts_plain
    from metrics_tpu_torch.ops.ssim_window import ssim_window, ssim_window_plain

    flush = _flush_buffer()
    res = {}
    for label, n, c in [("binary", BIN_N, 1), ("multiclass", MC_N, 10)]:
        t = PRC_THRESHOLDS
        args = [
            torch.from_numpy(rng.random((n, c), dtype=np.float32)).cuda(),
            torch.from_numpy(rng.integers(0, 2, (n, c), dtype=np.int32)).cuda(),
            torch.ones((n, c), dtype=torch.bool, device="cuda"),
            _adjust_threshold_arg(t, torch.device("cuda")),
        ]
        moved = n * c * (4 + 4 + 1) + 4 * t + 4 * (2 * c * t + 2 * c)
        ops = n * c * math.ceil(math.log2(t + 1))
        res[f"binned_counts[{label}]"] = {
            "shape": [n, c, t],
            "ms": time_ms(lambda: binned_counts(*args), flush=flush),
            "plain_ms": time_ms(lambda: binned_counts_plain(*args), reps=5, flush=flush),
            "bound_ms": 1000 * max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S),
            "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations",
            "library_ms": None,
        }

    b, ch, h, w = SSIM_SHAPE
    k = _gaussian_taps_np(11, 1.5)
    planes = 5 * b * ch
    x = torch.from_numpy(rng.random((planes, h + 10, w + 10), dtype=np.float32)).cuda()
    weight = torch.from_numpy(np.outer(k, k).astype(np.float32)).reshape(1, 1, 11, 11).cuda()
    x4 = x.unsqueeze(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_err = float((F.conv2d(x4, weight)[:, 0] - ssim_window_plain(x, k, k)).abs().max())
    moved = 4 * planes * ((h + 10) * (w + 10) + h * w)
    ops = 2 * planes * (11 * h * (w + 10) + 11 * h * w)
    res["ssim_window"] = {
        "shape": [planes, h + 10, w + 10, 11, 11],
        "ms": time_ms(lambda: ssim_window(x, k, k), flush=flush),
        "plain_ms": time_ms(lambda: ssim_window_plain(x, k, k), reps=5, flush=flush),
        "bound_ms": 1000 * max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S),
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations",
        "library_ms": time_ms(lambda: F.conv2d(x4, weight), reps=10, flush=flush),
        "library_max_abs_err_vs_plain": lib_err,
    }
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    seed = parser.parse_args().seed

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script measures the port on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from metrics_tpu_torch.ops import _native
    from metrics_tpu_torch.ops.binned_hist import binned_counts
    from metrics_tpu_torch.ops.ssim_window import ssim_window

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({torch.cuda.device_count()} visible); torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    _native.build()
    build_s = time.perf_counter() - t0
    log(f"built {len(_native.KERNEL_SOURCES)} kernel libraries in {build_s:.1f} s")

    rng = np.random.default_rng(seed)
    errs = check_kernels(rng)

    binned_counts.launches = ssim_window.launches = 0
    t0 = time.perf_counter()
    path = main_path(seed)
    launches = {"binned_counts": binned_counts.launches, "ssim_window": ssim_window.launches}
    log(f"main path in {time.perf_counter() - t0:.1f} s: {json.dumps(path)}")
    log(f"kernel launches on the main path: {launches}")
    for name, count in launches.items():
        if count < 1:
            fail(f"the main path never launched {name}")

    timing = measure(rng)
    for name, row in timing.items():
        log(f"{name}: {json.dumps(row)}")

    sources = {"binned_counts": ("metrics_tpu_torch/csrc/binned_hist.cu", "metrics_tpu/ops/binned_hist.py:151",
                                 "binned_counts[binary]"),
               "ssim_window": ("metrics_tpu_torch/csrc/ssim_window.cu", "metrics_tpu/ops/ssim_window.py:60",
                               "ssim_window")}
    kernels = []
    for name, (source, replaces, key) in sources.items():
        row = timing[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })

    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
