"""The closed evaluation loop: one evaluator folds a pass of updates, computes, reads every value on the
host as a logger does, resets, and starts the next pass at once.

Each rank runs :func:`run_rank` and returns its record; rank 0 judges every rank's passes with
:func:`judge`. The configuration's builder (``configs/<name>.py``) makes the inputs, the port's
collection and the reference; the mix (``mixes/<traffic>.json``) says how a pass is cut into updates.
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from benchlib import traffic
from benchlib.trace import Trace, breakdown, busy_idle


class _Pass:
    """One pass over the rank's updates, timed on the host; ``ranges`` opens the profiler's ranges."""

    def __init__(self, builder, collection, batches, mix) -> None:
        self.b, self.coll, self.batches, self.mix = builder, collection, batches, mix

    def run(self, ranges: bool, update_s: Optional[List[float]] = None):
        rng = torch.profiler.record_function if ranges else (lambda _name: contextlib.nullcontext())
        clock = time.perf_counter
        with rng("bench.pass"):
            for args in self.batches:
                t0 = clock()
                with rng("bench.update"):
                    self.coll.update(*args)
                if update_s is not None:
                    update_s.append(clock() - t0)
            t0 = clock()
            with rng("bench.compute"):
                result = self.coll.compute()
            with rng("bench.read_values"):
                values = self.b.read_values(result)
            compute_s = clock() - t0
            state = self.b.pass_state(self.coll, self.mix)
            with rng("bench.reset"):
                self.coll.reset()
        return values, state, compute_s


def _host_syncs(fn) -> int:
    """Host synchronizations of ``fn()`` under CUDA's sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rank(ctx) -> Dict[str, Any]:
    """Set up, warm up with one pass, run passes for ``ctx.seconds``, and return this rank's record."""
    cell, device = ctx.cell, ctx.device
    b, cfg, mix = cell.builder(), cell.config, cell.mix
    sched = traffic.schedule(cfg["units_per_pass"], mix, ctx.rank, ctx.world)
    data = b.make_data(cfg, ctx.seed, device)
    if ctx.world > 1:
        lo, hi = sched[0][0], sched[-1][1]
        data = b.restrict(data, lo, hi)
        sched = [(s - lo, e - lo) for s, e in sched]
    batches = [b.take(data, s, e) for s, e in sched]
    collection = ctx.prepare_collection(b.make_collection(cfg, mix, device))
    one = _Pass(b, collection, batches, mix)
    needs = (cell.layer_needs() | {"profile"}) if ctx.trace else set()
    rec: Dict[str, Any] = {"rank": ctx.rank, "units_per_pass": cfg["units_per_pass"],
                           "update_units": [e - s for s, e in sched], "errors": [], "failed": 0}

    def attempt(ranges: bool = False, update_s=None):
        try:
            return one.run(ranges, update_s)
        except Exception as exc:  # a failed pass is counted and reported, and the loop goes on
            rec["failed"] += 1
            if len(rec["errors"]) < 3:
                rec["errors"].append(f"{type(exc).__name__}: {exc}"[:500])
            collection.reset()
            return None

    attempt()  # warm-up: every shape of the cell, every kernel built and loaded
    if "sync_debug" in needs and device.type == "cuda":
        # a second pass, before the window, with every update's host syncs counted
        orig, syncs = collection.update, [0]

        def counting_update(*args, **kwargs):
            syncs[0] += _host_syncs(lambda: orig(*args, **kwargs))

        collection.update = counting_update
        try:
            attempt()
        finally:
            collection.update = orig
        rec["syncs_per_update"] = syncs[0] / len(batches)
    if "observe" in needs:
        from metrics_tpu_torch import observe

        observe.enable(reset=True)
    _synchronize(device)
    ctx.barrier()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rec["setup_s"] = time.perf_counter() - ctx.t0

    prof = None
    trace_passes = int(mix.get("trace_passes", 1)) if "profile" in needs else 0
    if trace_passes:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    values: List[Optional[Dict[str, float]]] = []
    states: list = []
    compute_s: List[float] = []
    update_s: List[float] = []
    passes = traced = 0
    t_start = time.perf_counter()
    while True:
        tracing = prof is not None and passes < trace_passes
        out = attempt(ranges=tracing, update_s=None if tracing else update_s)
        passes += 1
        if out is None:
            values.append(None)
            states.append(None)
            compute_s.append(math.nan)
        else:
            values.append(out[0])
            states.append(out[1])
            compute_s.append(out[2])
        if tracing and passes == trace_passes:
            _synchronize(device)
            prof.stop()
            traced = passes
        if not ctx.agree(time.perf_counter() - t_start < ctx.seconds):
            break
    rec["window_s"] = time.perf_counter() - t_start
    if prof is not None and not traced:
        _synchronize(device)
        prof.stop()
        traced = passes
    _synchronize(device)
    rec.update(passes=passes, compute_s=compute_s, update_host_s=update_s, values=values, traced_passes=traced)
    rec["input_bytes"] = b.data_bytes(data)
    if device.type == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        rec["device_kind"] = torch.cuda.get_device_name(device)
    if "observe" in needs:
        from metrics_tpu_torch import observe

        rec["observe"] = observe.snapshot()
        observe.disable()
    rec["states"] = [None if s is None else s.cpu().tolist() for s in states]
    del one, collection, batches, data, states
    if device.type == "cuda":
        torch.cuda.empty_cache()

    trace = None
    if prof is not None:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace = Trace.load(Path(path))
        finally:
            os.unlink(path)
        lo, hi = trace.window()
        busy_us, _ = busy_idle(trace.device_ops, lo, hi)
        rec.update(busy_s=busy_us * 1e-6, trace_window_s=(hi - lo) * 1e-6, breakdown=breakdown(trace))
    rec["layer"] = {}
    for m in cell.per_layer:
        reader = cell.layer_reader(m["name"])
        rec["layer"][m["name"]] = reader.measure(LayerView(cell, rec, trace))
    return rec


class LayerView:
    """What a per-layer reader sees on one rank: the cell, the rank's record and its trace (or None)."""

    def __init__(self, cell, record: Dict[str, Any], trace: Optional[Trace]) -> None:
        self.cell, self.record, self.trace = cell, record, trace


def _gap(program: Optional[float], reference: float) -> Optional[float]:
    if program is None:
        return None
    gap = abs(program - reference)
    return gap if math.isfinite(gap) else None


def judge(cell, seed: int, device: torch.device, records: List[Dict[str, Any]]) -> List[tuple]:
    """(name, number, limit) of every compared number: each value's widest gap to the float64 reference over
    every pass of every rank, and the binned counts' widest difference."""
    b = cell.builder()
    limits = cell.config["limits"][b.path(cell.mix)]
    data = b.make_data(cell.config, seed, device)
    ref = b.reference(cell.config, cell.mix, data, torch.float64)
    del data
    counts = None if ref["counts"] is None else ref["counts"].cpu()
    gaps: Dict[str, List[Optional[float]]] = {name: [] for name in limits}
    for rec in records:
        for values, state in zip(rec["values"], rec["states"]):
            for name in limits:
                if name == "counts":
                    gap = None if state is None else float((torch.tensor(state) - counts).abs().max())
                else:
                    gap = None if values is None else _gap(values.get(name), ref["values"][name])
                gaps[name].append(gap)
    return [(name, None if not g or None in g else max(g), limits[name]) for name, g in gaps.items()]
