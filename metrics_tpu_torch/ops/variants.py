"""Variants of the two CUDA kernels, timed in turns at the main path's shapes: what bounds each kernel.

Each variant is the committed source under ``csrc/`` with named constants set
to other values, or with one line replaced (the SSIM window's loads and
stores skipped to time its arithmetic alone, for instance). Each is built with
``nvcc`` into ``metrics_tpu_torch/_build/variants/``, put in place of the
committed library for the public wrapper, checked against the plain version
where its result should be unchanged, and timed with the cold-L2 timer of
:mod:`metrics_tpu_torch.ops.profile` in two rounds, the second in reverse
order. Reference rows time a trivial kernel, a 16-byte memset and
``torch.sum`` over the binary and the multilabel curves' scores the same way.

    python -m metrics_tpu_torch.ops.variants [--out FILE.json]

Needs a CUDA device and ``nvcc``. The variants are measurements only: the
wrappers always load the committed sources.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch

from metrics_tpu_torch.ops import _native

_VERT = "for (int c = vert_walk.fast, s = vert_walk.slow; s < kStripsV; vert_walk.step(c, s)) {"
_HORZ = "for (int item = threadIdx.x; item < kTileH * kStripsH; item += kThreads) {"
_LOADS = "issue_tile_loads<kPair>(x, g, ahead,"
_STORE = "if (r < rows && c < cols) op["
_ATOMIC = "atomicAdd(&cells[((1 - y) * cc + ci) * bw + static_cast<int>(local)], 1);"
_NO_LOADS = {_LOADS: "if (false) " + _LOADS, _STORE: "if (r < rows && c < -1) op["}
_NO_MATH = {_VERT: _VERT.replace("s = vert_walk.slow", "s = kStripsV"),
            _HORZ: _HORZ.replace("item < kTileH", "item < 0 * kTileH")}

# name -> (substitutions, whether the result must still equal the plain version's)
SSIM = {
    "committed": ({}, True),
    "arithmetic only (no loads or stores)": (_NO_LOADS, False),
    "loads and stores only (no arithmetic)": (_NO_MATH, False),
    "8-output horizontal strips": ({"kStripH": 8}, True),
    "three input buffers, 2 blocks per SM": ({"kStages": 3, "kBlocksPerSm": 2}, True),
    "32-row tiles, 6 blocks per SM": ({"kTileH": 32, "kBlocksPerSm": 6}, True),
    "32 x 128 tiles": ({"kTileH": 32, "kTileW": 128}, True),
    "128 threads": ({"kThreads": 128}, True),
    "320 threads, 16-row vertical strips": ({"kThreads": 320, "kStripV": 16}, True),
}
BINNED = {
    "committed": ({}, True),
    "no counting": ({_ATOMIC: "if (ci == -5) " + _ATOMIC}, False),
    "256 threads, 3 blocks per SM": ({"kThreads": 256, "kBlocksPerSm": 3}, True),
    "128 threads, 6 blocks per SM": ({"kThreads": 128, "kBlocksPerSm": 6}, True),
    "16 loads per thread before another cluster": ({"kMinUnitsPerThread": 16}, True),
}


def variant_source(name: str, subs: dict) -> str:
    """``csrc/<name>.cu`` with each ``kConstant`` set, or each other key's text replaced; every key must match."""
    src = (_native.CSRC / f"{name}.cu").read_text()
    for key, value in subs.items():
        if re.fullmatch(r"k\w+", key):
            src, found = re.subn(rf"(constexpr int {key} = )[^;]+;", rf"\g<1>{value};", src)
        else:
            found = src.count(key)
            src = src.replace(key, value)
        if not found:
            raise ValueError(f"variant of csrc/{name}.cu: {key!r} not found")
    return src


def build(kernel: str, table: dict) -> dict:
    """One library per variant, all ``nvcc`` runs at once; returns name -> loaded library."""
    nvcc = _native._nvcc()
    running = []
    for i, (vname, (subs, _)) in enumerate(table.items()):
        out = _native.BUILD_DIR / "variants" / f"{kernel}-{i}"
        out.mkdir(parents=True, exist_ok=True)
        (out / "common.cuh").write_text((_native.CSRC / "common.cuh").read_text())
        (out / f"{kernel}.cu").write_text(variant_source(kernel, subs))
        cmd = [nvcc, *_native.NVCC_FLAGS, "-I", str(out), "-o", str(out / "lib.so"), str(out / f"{kernel}.cu")]
        running.append((vname, out / "lib.so", subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                               text=True)))
    libs = {}
    for vname, path, proc in running:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {kernel} variant {vname!r}:\n{text}")
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[vname] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None, help="also write the results to this JSON file")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 1
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
    from metrics_tpu_torch.functional.image.ssim import _gaussian_taps_np
    from metrics_tpu_torch.ops.binned_hist import (
        binned_counts,
        binned_counts_labels,
        binned_counts_labels_plain,
        binned_counts_plain,
    )
    from metrics_tpu_torch.ops.profile import flush_buffer, time_ms
    from metrics_tpu_torch.ops.ssim_window import ssim_window, ssim_window_plain

    cuda = torch.device("cuda")
    rng = np.random.default_rng(0)
    flush = flush_buffer()
    thr = _adjust_threshold_arg(200, cuda)

    def nc_case(n, c):
        return [torch.from_numpy(rng.random((n, c), dtype=np.float32)).to(cuda),
                torch.from_numpy(rng.integers(0, 2, (n, c), dtype=np.int32)).to(cuda),
                torch.ones((n, c), dtype=torch.bool, device=cuda), thr]

    labels = [torch.from_numpy(rng.random((1 << 20, 10), dtype=np.float32)).to(cuda),
              torch.from_numpy(rng.integers(0, 10, 1 << 20, dtype=np.int32)).to(cuda), thr]
    binned_cases = {"binary 2^22 x 1": (binned_counts, binned_counts_plain, nc_case(1 << 22, 1)),
                    "(N, C) 2^20 x 10": (binned_counts, binned_counts_plain, nc_case(1 << 20, 10)),
                    # 80 labels: two class chunks, so the one-element-at-a-time loop
                    "(N, C) 2^18 x 80": (binned_counts, binned_counts_plain, nc_case(1 << 18, 80)),
                    "labels 2^20 x 10": (binned_counts_labels, binned_counts_labels_plain, labels),
                    "binary 1,024 x 1": (binned_counts, binned_counts_plain, nc_case(1024, 1))}
    taps = _gaussian_taps_np(11, 1.5)
    planes = torch.from_numpy(rng.random((300, 266, 266), dtype=np.float32)).to(cuda)
    ssim_cases = {"300 planes 266^2, 11 x 11": (ssim_window, ssim_window_plain, [planes, taps, taps])}

    runs = []
    for kernel, table, cases in (("ssim_window", SSIM, ssim_cases), ("binned_hist", BINNED, binned_cases)):
        libs = build(kernel, table)
        for case, (fn, plain, args) in cases.items():
            want = plain(*args)
            for vname, (_, exact) in table.items():
                runs.append((kernel, vname, case, libs[vname], fn, args, want if exact else None))
    committed = {name: _native.load(name) for name in _native.KERNEL_SOURCES}
    times = {}
    try:
        for order in (runs, runs[::-1]):
            for kernel, vname, case, lib, fn, args, want in order:
                _native._loaded[kernel] = lib  # the wrapper binds and launches this variant
                got = fn(*args)
                if want is not None:
                    same = all(torch.equal(g, w) for g, w in zip(got, want)) if isinstance(got, tuple) \
                        else torch.equal(got, want)
                    if not same:
                        raise RuntimeError(f"{kernel} variant {vname!r} differs from the plain version on {case}")
                times.setdefault((kernel, case, vname), []).append(time_ms(lambda: fn(*args), flush=flush))
    finally:
        _native._loaded.update(committed)

    small = torch.zeros(1, device=cuda)
    ticket = torch.empty(4, dtype=torch.int32, device=cuda)
    scores = binned_cases["binary 2^22 x 1"][2][0]
    ml_scores = binned_cases["(N, C) 2^18 x 80"][2][0]
    reference = {"trivial kernel (add_ on one float)": lambda: small.add_(1),
                 "16-byte memset": lambda: ticket.zero_(),
                 "torch.sum over the binary scores (16.8 MB)": lambda: scores.sum(),
                 "torch.sum over the multilabel scores (83.9 MB)": lambda: ml_scores.sum()}
    for name, fn in reference.items():
        times[("reference", "", name)] = [time_ms(fn, flush=flush) for _ in range(2)]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    rows = [{"kernel": k, "case": c, "variant": v, "ms": ms} for (k, c, v), ms in times.items()]
    for row in rows:
        print(f"{row['kernel']:12s} {row['case']:26s} {row['variant']:45s} " + " ".join(f"{t:.5f}" for t in row["ms"]))
    print(f"nvidia-smi: {smi}")
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump({"device": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
