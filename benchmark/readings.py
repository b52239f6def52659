"""The two readings each compared number's limit is set from, at a cell's own size, on the card.

    python benchmark/readings.py --workload <name> --seeds 1 2 ... --control-seeds 1 2 3

For each seed it makes the cell's inputs, drives one pass of the port's collection through the timed
path's own pass (``drivers/eval_loop.py``), and prints one JSON line with each number's gap to the
float64 reference (the program's reading); for each control seed it also prints the gap of the
reference computed in bfloat16, the control put in the program's place (the control's reading). The
last line sums them up: the largest program reading and the smallest control reading of each number.
Single-rank: a cell of many ranks shares its reference with its one-rank sibling.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent), str(BENCH)]

import torch  # noqa: E402

from benchlib import traffic  # noqa: E402
from benchlib.cells import Cell  # noqa: E402


def _numbers(limits, ref, values, counts):
    out = {}
    for name in limits:
        if name == "counts":
            out[name] = None if counts is None else float((counts.cpu() - ref["counts"].cpu()).abs().max())
        else:
            out[name] = abs(values[name] - ref["values"][name])
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    if cell.ranks != 1:
        print("readings: single-rank cells only", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    b, cfg, mix = cell.builder(), cell.config, cell.mix
    pass_cls = cell.driver()._Pass
    limits = cfg["limits"][b.path(mix)]
    lower, upper = {}, {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        data = b.make_data(cfg, seed, device)
        line = {"seed": seed}
        if seed in args.seeds:
            batches = [b.take(data, s, e) for s, e in traffic.schedule(cfg["units_per_pass"], mix)]
            values, state, _ = pass_cls(b, b.make_collection(cfg, mix, device), batches, mix).run(False)
            state = None if state is None else state.clone()
            del batches
            torch.cuda.empty_cache()
            ref = b.reference(cfg, mix, data, torch.float64)
            line["program"] = _numbers(limits, ref, values, state)
            for k, v in line["program"].items():
                lower[k] = max(lower.get(k, 0.0), v)
        if seed in args.control_seeds:
            ref = ref if seed in args.seeds else b.reference(cfg, mix, data, torch.float64)
            ctl = b.reference(cfg, mix, data, torch.bfloat16)
            line["control"] = _numbers(limits, ref, ctl["values"], ctl["counts"])
            for k, v in line["control"].items():
                upper[k] = min(upper.get(k, float("inf")), v)
        del data
        torch.cuda.empty_cache()
        line["s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "device": torch.cuda.get_device_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
