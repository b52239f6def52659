"""The port's sync over real ``torch.distributed`` gloo groups of 2, 3 and 4 processes on the CPU.

One spawn per world size runs every case of ``tests/_torch_sync_workers.py``
in each rank (a ``file://`` store under the test's temporary directory, so no
port is opened); each case is then one test here, passing when every rank
held its synced result against the single-stream run: integer states equal,
float states and scores within rtol 1e-5, Pearson and Spearman within 1e-4.
The world of 4 is laid out as (model 2, data 2) for the subgroup case, each
rank syncing over its data row's ``dist.new_group`` only.
Every child is joined under a timeout, so a hung collective fails its tests
instead of stalling the suite. Port only: the JAX package has no process
groups.
"""

from __future__ import annotations

import pickle

import pytest
import torch.multiprocessing as mp

import _torch_sync_workers as workers

JOIN_TIMEOUT_S = 120


def _spawn(world, directory):
    ctx = mp.get_context("spawn")
    store = directory / "store"
    procs = [ctx.Process(target=workers.run, args=(rank, world, str(store), str(directory)), daemon=True)
             for rank in range(world)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(JOIN_TIMEOUT_S)
    hung = [rank for rank, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    results = {}
    for rank in range(world):
        path = directory / f"{rank}.pkl"
        results[rank] = pickle.loads(path.read_bytes()) if path.exists() else {}
    return {"hung": hung, "exitcodes": [proc.exitcode for proc in procs], "results": results}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {world: _spawn(world, tmp_path_factory.mktemp(f"gloo{world}")) for world in (2, 3, 4)}


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("case", workers.case_names())
def test_sync_over_gloo(runs, world, case):
    run = runs[world]
    assert not run["hung"], f"ranks {run['hung']} did not finish within {JOIN_TIMEOUT_S} s"
    assert run["exitcodes"] == [0] * world, run["exitcodes"]
    for rank in range(world):
        assert run["results"][rank].get(case) == "ok", f"rank {rank}:\n{run['results'][rank].get(case)}"
