"""A run with the timed path broken underneath reports ``correct`` false: once for each fault a cell can have."""

import bench_faults
import pytest
from conftest import run_tiny, tiny_cell

ONE_RANK = ["criteo_ctr.binned_16m", "criteo_ctr.exact_16m", "div2k_sr.hr_b4"]


@pytest.mark.parametrize("name", ONE_RANK)
def test_sound_run_is_correct(name):
    out, _ = run_tiny(tiny_cell(name))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "compared" and out["built"] == []


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", ONE_RANK)
def test_fault_is_not_correct(name, fault):
    out, _ = run_tiny(tiny_cell(name), prepare=getattr(bench_faults, fault))
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("fault", [None, "exchange_left_out"])
def test_four_rank_cell_without_the_exchange_is_not_correct(fault):
    """Two gloo ranks stand in for the four NCCL ranks; without the gather each rank scores its own rows."""
    prepare = None if fault is None else getattr(bench_faults, fault)
    out, records = run_tiny(tiny_cell("criteo_ctr.exact_ddp4", ranks=2), seconds=0.2, prepare=prepare)
    assert len(records) == 2 and out["device"]["count"] == 2
    assert out["correct"] is (fault is None), out["compared"]
