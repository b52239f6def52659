"""The port's runtime contracts against the JAX package's on the CPU: merge classifications, fleet verdicts,
and the transfer contract's three legs, with the CPU host-read recorder the card's verdict is predicted by
(the precision contract is in ``test_torch_analysis_precision.py``)."""

from __future__ import annotations

import json
import os

import pytest
import torch

from metrics_tpu_torch.analysis import fleet_contracts, merge_contracts, precision_contracts, transfer_contracts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _by_name(cases):
    return {c.name: c for c in cases}


# ---------------------------------------------------------------------------------------- merge
def test_every_merge_classification_is_the_jax_package_s(capsys):
    """All 73 cases classify as the JAX package's checked-in ``merge`` section says (an absent class is
    MERGE_SOUND), the time-shifted merges hold, and the pass passes against the port's baseline."""
    ref = json.load(open(os.path.join(ROOT, "tools", "distlint_baseline.json")))["merge"]
    report: dict = {}
    assert merge_contracts.run_merge_check(ROOT, report=report, device="cpu") == 0
    assert len(report["classifications"]) == len(merge_contracts.MERGE_CASES) == 73
    assert {k: v for k, v in report["classifications"].items() if v != "MERGE_SOUND"} == ref
    assert report["regressions"] == [] and report["stale_baseline_keys"] == [] and report["time_shift_failures"] == []
    assert merge_contracts.load_merge_baseline(merge_contracts.DEFAULT_BASELINE) == ref


def test_merge_baseline_ratchet():
    case = merge_contracts.MERGE_CASES[0]
    sound = merge_contracts.MergeResult(case, "MERGE_SOUND")
    worse = merge_contracts.MergeResult(case, "CAT_ORDER_SENSITIVE")
    assert merge_contracts.diff_merge_baseline([worse], {}) == ([worse], [])
    assert merge_contracts.diff_merge_baseline([sound], {case.name: "CAT_ORDER_SENSITIVE"}) == ([], [case.name])


# ---------------------------------------------------------------------------------------- fleet
@pytest.mark.parametrize("name", ["MulticlassAccuracy", "BinaryAUROC", "MeanSquaredError"])
def test_fleet_verdict_is_the_jax_package_s(name):
    """The churning 4-slot bucket gives the JAX package's verdict; the port donates nothing, so its donation
    leg reports that it does not apply."""
    from metrics_tpu.analysis.fleet_contracts import check_fleet_case
    from metrics_tpu.observe.costs import PROFILE_CASES

    want = check_fleet_case(_by_name(PROFILE_CASES)[name])
    got = fleet_contracts.check_fleet_case(_by_name(fleet_contracts.fleet_cases())[name], "cpu")
    assert got.ok and got.verdict == want.verdict, got.render()
    assert got.donation == "n/a"


@pytest.mark.parametrize("name", ["PeakSignalNoiseRatio", "CUSUM"])
def test_eager_and_vmapped_updates_are_bit_identical_on_the_cpu(name):
    """The witness behind the card's float-state tolerance reads 0.0 here, where the fleet contract holds
    every state bit-exact; a class that forms no bucket has nothing to witness."""
    from metrics_tpu_torch.observe.costs import PROFILE_CASES

    gaps = fleet_contracts.eager_vs_bucket_gap(_by_name(fleet_contracts.fleet_cases())[name], "cpu")
    assert len(gaps) == 4 and {g for tick in gaps.values() for g in tick.values()} == {0.0}, gaps
    with pytest.raises(ValueError, match="forms no bucket"):
        fleet_contracts.eager_vs_bucket_gap(_by_name(PROFILE_CASES)["BinaryCalibrationError"], "cpu")


def test_fleet_cases_are_the_jit_eligible_slice():
    names = [c.name for c in fleet_contracts.fleet_cases()]
    assert len(names) == 65 and "CatMetric" not in names and "UniversalImageQualityIndex" not in names


# ---------------------------------------------------------------------------------------- transfer
def test_the_recorder_names_each_host_read():
    """The CPU leg records what would read the card on the host, and nothing else; an annotated site lifts it."""
    x = torch.rand(16)
    recorder = transfer_contracts.HostReadRecorder()
    with recorder:
        _ = x.sum().item()
        _ = torch.unique(x)
        _ = x[x > 0.5]
        _ = torch.nonzero(x)
        _ = torch.bincount((x * 4).long(), minlength=4)
        _ = torch.repeat_interleave(torch.tensor([1, 2]))
        _ = x.tolist()
        _ = bool(x.sum() > 0)
        y = torch.where(x > 0.5, x, torch.zeros_like(x)).cumsum(0) * 2
        with recorder.allow("test"):
            _ = y.max().item()
    assert recorder.reads == ["item", "_unique2", "index(bool mask)", "nonzero", "bincount", "repeat_interleave",
                              "tolist", "item"]
    assert dict(recorder.allowed) == {"test": 1}
    assert torch.Tensor.tolist is not None and "wrapped" not in torch.Tensor.tolist.__name__


@pytest.mark.parametrize("name,runtime,clean", [("MeanSquaredError", "CLEAN", True),
                                                ("StreamingAUROC", "CLEAN", True),
                                                ("BinaryAccuracy", "TRANSFER:_unique2", False),
                                                ("MeanMetric", "TRANSFER:item", False)])
def test_transfer_case_reaches_three_way_agreement(name, runtime, clean):
    r = transfer_contracts.check_transfer_case(_by_name(transfer_contracts.transfer_cases())[name], "cpu")
    assert r.agree and r.declared and r.static_clean is clean and r.runtime == runtime, r.render()


@pytest.mark.slow
def test_full_registry_transfer_agreement():
    results = [transfer_contracts.check_transfer_case(c, "cpu") for c in transfer_contracts.transfer_cases()]
    assert [r.render() for r in results if not r.agree] == []


@pytest.mark.parametrize("kind", ["StreamEngine", "ShardedStreamEngine"])
def test_engine_tick_reads_only_at_annotated_sites(kind):
    """A steady 100-session tick and a sharded churn tick read nothing outside ``_transfer_scope``; the
    sites they went through are named."""
    r = transfer_contracts.check_engine_contract(kind, "cpu")
    assert r.agree and r.runtime == "CLEAN", r.render()
    assert "wave_assembly" in r.detail
    if kind == "ShardedStreamEngine":
        assert "adopt_state x4" in r.detail and "expire_slice x4" in r.detail


def test_checked_in_contract_baselines_are_empty():
    from metrics_tpu_torch.analysis import chaos_contracts

    assert transfer_contracts.load_transfer_baseline(transfer_contracts.DEFAULT_BASELINE) == {}
    assert precision_contracts.load_precision_baseline(precision_contracts.DEFAULT_BASELINE) == {}
    assert fleet_contracts.load_fleet_contract_baseline(fleet_contracts.DEFAULT_BASELINE) == {}
    for section in ("chaos", "fleet", "shard", "serve"):
        assert chaos_contracts.load_chaos_baseline(chaos_contracts.DEFAULT_BASELINE, section) == {}
