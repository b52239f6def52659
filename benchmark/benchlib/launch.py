"""Run a cell's ranks: one process on one device, or a world of processes (one per chip) that this process
starts as rank 0, rendezvousing through a file under ``TMPDIR``."""

from __future__ import annotations

import multiprocessing as mp
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from benchlib.cells import Cell
from benchlib.isolation import built_libraries, forbidden_modules

THREADS = 4  # intra-op threads a rank keeps: the work is on the card


class RankContext:
    """What a driver's ``run_rank`` is given: the cell, the run's arguments, its place in the world."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float,
                 rank: int = 0, world: int = 1, prepare: Optional[Callable] = None) -> None:
        self.cell, self.seed, self.seconds, self.trace, self.device = cell, seed, seconds, trace, device
        self.t0, self.rank, self.world = t0, rank, world
        self._prepare = prepare

    def prepare_collection(self, collection):
        """The program's collection as the loop will drive it (a test may break it here)."""
        return collection if self._prepare is None else self._prepare(collection)

    def barrier(self) -> None:
        if self.world > 1:
            _barrier(self.device)

    def agree(self, go: bool) -> bool:
        """Whether every rank goes on to another pass (each rank's own clock; all stop together)."""
        if self.world == 1:
            return go
        flag = torch.tensor([1 if go else 0], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())


def _barrier(device: torch.device) -> None:
    if device.type == "cuda":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()


def _cpulist(text: str) -> List[int]:
    out: List[int] = []
    for part in text.strip().split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def _pin(rank: int, world: int) -> None:
    """Keep this rank's process on CPU cores beside its card (the cards' local cores, split evenly between the
    ranks whose cards share them) with a few intra-op threads, so that the ranks neither cross sockets nor
    crowd each other. Without the topology (no NVIDIA device under /sys) nothing changes."""
    pci = Path("/sys/bus/pci/devices")
    try:
        cards = sorted(d for d in pci.iterdir() if (d / "vendor").read_text().strip() == "0x10de"
                       and (d / "class").read_text().startswith("0x03"))
        local = [_cpulist((d / "local_cpulist").read_text()) for d in cards]
    except OSError:
        return
    if len(local) < world:
        return
    sharing = [r for r in range(world) if local[r] == local[rank]]
    allowed = [c for c in local[rank] if c in os.sched_getaffinity(0)]
    share = len(allowed) // len(sharing)
    mine = allowed[sharing.index(rank) * share:(sharing.index(rank) + 1) * share]
    if mine:
        os.sched_setaffinity(0, mine)
        torch.set_num_threads(min(THREADS, len(mine)))


def _device(device_type: str, rank: int, world: int) -> torch.device:
    if device_type == "cuda":
        _pin(rank, world)
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    return torch.device(device_type)


def _sealed(rec: Dict[str, Any]) -> Dict[str, Any]:
    """A rank's record with what its process loaded once its window closed: forbidden modules, libraries built."""
    rec["forbidden"] = forbidden_modules()
    rec["built"] = built_libraries()
    return rec


def _rank(cell: Cell, seed: int, seconds: float, trace: bool, device_type: str, t0: float,
          rank: int, world: int, init: str, prepare: Optional[Callable]) -> List[Dict[str, Any]]:
    device = _device(device_type, rank, world)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        ctx = RankContext(cell, seed, seconds, trace, device, t0, rank, world, prepare)
        rec = _sealed(cell.driver().run_rank(ctx))
        records: List[Any] = [None] * world
        dist.all_gather_object(records, rec)
        _barrier(device)
    finally:
        dist.destroy_process_group()
    return records


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device_type: str, t0: float,
             prepare: Optional[Callable] = None, join_timeout: float = 180.0) -> List[Dict[str, Any]]:
    """Every rank's record, in rank order (this process is rank 0)."""
    world = cell.ranks
    if world == 1:
        ctx = RankContext(cell, seed, seconds, trace, _device(device_type, 0, 1), t0, prepare=prepare)
        return [_sealed(cell.driver().run_rank(ctx))]
    rdv = tempfile.mkdtemp(prefix="bench_rdv_")
    init = "file://" + os.path.join(rdv, "store")
    spawn = mp.get_context("spawn")
    args = (cell, seed, seconds, trace, device_type, t0)
    children = [spawn.Process(target=_rank, args=args + (r, world, init, prepare)) for r in range(1, world)]
    for p in children:
        p.start()
    try:
        records = _rank(*args, 0, world, init, prepare)
    finally:
        deadline = time.monotonic() + join_timeout
        for p in children:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in children:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(rdv, ignore_errors=True)
    bad = [p.exitcode for p in children if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return records
