"""Run one cell of the port's benchmark once and print its result as the last line of standard output.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by name from ``BENCHMARK.json``
(see ``benchlib/cells.py``). With ``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, the device's busy time and a breakdown of the traced passes. Every
run checks each pass in the window against the float64 reference after the window and prints each
compared number beside its limit, last on standard error and last in the line.

It needs as many CUDA devices as the cell asks for and exits with 2, printing no result, without them.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _environment() -> None:
    """Every cache the program or torch may build goes under the checkout, at a fixed path."""
    cache = ROOT / ".bench_cache"
    os.environ["METRICS_TPU_TORCH_KERNEL_CACHE"] = str(ROOT / "metrics_tpu_torch" / "_build")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["NCCL_SHM_DISABLE"] = "1"
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_loaded(records: list) -> dict:
    """Each rank's forbidden top-level names, where it loaded any: this process (rank 0) as it is now, after
    the reference, and every other rank as its record says at the close of its window."""
    from benchlib.isolation import forbidden_modules

    found = {r["rank"]: r.get("forbidden", []) for r in records[1:]}
    found[0] = forbidden_modules()
    return {rank: names for rank, names in sorted(found.items()) if names}


def power_limits(count: int):
    """Each used card's power limit as ``nvidia-smi`` reads it: the rooflines' peak assumes the full 700 W."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return [line.strip() for line in out.stdout.splitlines()[:count]] or None


def _number(x):
    return x if x is None or math.isfinite(x) else None


def result_line(cell, trace: bool, records: list, compared: list) -> dict:
    """The contract's result: correct, attempted, failed, metrics, device, breakdown, and compared last."""
    failed = sum(r["failed"] for r in records)
    attempted = records[0]["passes"]
    correct = attempted > 0 and failed == 0 and all(v is not None and v <= lim for _, v, lim in compared)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        if trace:
            reader = cell.layer_reader(m["name"])
            found = [r["layer"][m["name"]] for r in records if r["layer"].get(m["name"]) is not None]
            value = (getattr(reader, "combine", None) or (lambda v: sum(v) / len(v)))(found) if found else None
        else:
            value = cell.e2e_reader(m["name"]).read(records, cell)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": records[0].get("device_kind"), "count": len(records),
              "memory_peak_bytes": max(r.get("peak_bytes", 0) for r in records)}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    # the libraries compiled in this run: its setup_s then holds their build (the checkout's first run)
    out["built"] = sorted(set().union(*(r.get("built", ()) for r in records)))
    if trace and all("busy_s" in r for r in records):
        device["busy_s"] = sum(r["busy_s"] for r in records) / len(records)
        device["window_s"] = sum(r["trace_window_s"] for r in records) / len(records)
        out["breakdown"] = records[0]["breakdown"]
    out["compared"] = {name: {"value": _number(v), "limit": lim} for name, v, lim in compared}
    return out


def report(out: dict, records: list) -> None:
    """The errors of failed passes, then each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output."""
    for r in records:
        for err in r["errors"]:
            print(f"rank {r['rank']} failed pass: {err}", file=sys.stderr)
    if out["built"]:
        print(f"built {out['built']}: setup_s includes their build", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()

    import torch

    from benchlib.cells import Cell
    from benchlib.launch import run_cell

    cell = Cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run: {args.workload} needs {cell.chips} CUDA device(s), found {have}; no result", file=sys.stderr)
        return 2
    import metrics_tpu_torch  # noqa: F401  the program under test; without it there is nothing to measure

    seed = args.seed % (1 << 63)
    records = run_cell(cell, seed, args.seconds, bool(args.trace), "cuda", _T0)
    compared = cell.driver().judge(cell, seed, torch.device("cuda", 0), records)
    found = forbidden_loaded(records)
    if found:
        print(f"run: ranks loaded {found} (rank: modules), which the benchmark must never load; no result",
              file=sys.stderr)
        return 3
    out = result_line(cell, bool(args.trace), records, compared)
    out["device"]["power_limit"] = power_limits(len(records))
    report(out, records)
    return 0


if __name__ == "__main__":
    sys.exit(main())
