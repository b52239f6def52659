"""The port's cost profiles, perf ratchet and telemetry-overhead budget (``observe/costs.py``, ``profile.py``,
``overhead.py``) against the JAX package's registry and baselines.

The registry has the JAX package's cases in its order, with the same seeded batches (values equal) and the
same cases profiled (the port's list-state and jit-ineligible marks equal the JAX package's); ``shareable`` and
``donation_eligible`` equal the JAX package's committed baseline. On the CPU this file profiles a handful of
cases (the thresholded binary AUROC and multiclass AUROC on the binned-counts op, SSIM on the window op, a
stat-score, a regression and a windowed case); ``chip_smoke.py`` profiles every case on the card. The
committed baseline round-trips and passes; an update whose counted bytes are doubled by a planted extra op
fails the ratchet.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from metrics_tpu.observe import costs as jcosts
from metrics_tpu_torch.observe import costs as tcosts
from metrics_tpu_torch.observe import overhead, profile

HANDFUL = ("BinaryAUROC", "MulticlassAUROC", "StructuralSimilarityIndexMeasure", "MulticlassAccuracy",
           "MeanSquaredError", "TimeDecayed", "UniversalImageQualityIndex")
JAX_BASELINE = "tools/perf_baseline.json"


def _cases(names):
    by = {c.name: c for c in tcosts.PROFILE_CASES}
    return [by[n] for n in names]


def test_the_registry_is_the_reference_s_with_the_same_batches():
    port, ref = list(tcosts.PROFILE_CASES), list(jcosts.PROFILE_CASES)
    assert [c.name for c in port] == [c.name for c in ref] and len(port) == 75
    for p, r in zip(port, ref):
        got = p.batch(tcosts._rng(p))
        want = r.batch(jcosts._rng(r))
        assert len(got) == len(want), p.name
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=p.name)
            assert str(g.dtype).replace("torch.", "") == str(np.asarray(w).dtype), p.name


def test_the_profiled_cases_and_their_flags_are_the_reference_s():
    """A case is profiled in the port exactly when the JAX package's baseline holds it (the others have a list
    state or a host-side update in both), with the JAX package's ``shareable`` and ``donation_eligible``."""
    with open(JAX_BASELINE, encoding="utf-8") as fh:
        ref = json.load(fh)["cost"]
    for case in tcosts.PROFILE_CASES:
        m = case.ctor(device="cpu")
        ok = not (type(m).__jit_ineligible__ or m._has_list_state())
        assert ok == (case.name in ref), case.name
        if ok:
            assert (m._config_key() is not None) == ref[case.name]["shareable"], case.name
            assert tcosts._donation_eligible(m) == ref[case.name]["donation_eligible"], case.name


def test_a_handful_of_cases_profile_on_the_cpu_as_the_baseline_pins():
    results = tcosts.collect_cost_report(_cases(HANDFUL), device="cpu")
    by = {r.case.name: r for r in results}
    assert not by["UniversalImageQualityIndex"].ok
    assert by["UniversalImageQualityIndex"].error == "not jit-eligible (list state or host-side update)"
    baseline = profile.load_cost_baseline(profile._DEFAULT_BASELINE)
    for name in HANDFUL[:-1]:
        r = by[name]
        assert r.ok, (name, r.error)
        assert r.cost == baseline[name], name
        assert r.cost["bytes_accessed"] > 0 and "peak_memory_bytes" not in r.cost  # no memory analysis here
        assert (r.cost["compile_count"], r.cost["cache_hits"], r.cost["aot_cacheable"],
                r.cost["cold_start_compile_count"]) == (0, 0, False, 0)
    regressions, stale, new = profile.diff_cost_baseline(results, baseline)
    assert regressions == new == [] and len(stale) == len(baseline) - 6  # the cases not profiled here
    assert all(line.endswith("in baseline but not profiled (class removed or now ineligible)") for line in stale)


def test_the_kernels_count_as_one_op_on_either_device():
    """Under the byte count the binned-counts and window kernels are their custom ops on the CPU too."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func.name())
            return func(*args, **(kwargs or {}))

    for name, op in (("BinaryAUROC", "metrics_tpu_torch::binned_counts"),
                     ("MulticlassAUROC", "metrics_tpu_torch::binned_counts_labels"),
                     ("StructuralSimilarityIndexMeasure", "metrics_tpu_torch::ssim_window")):
        (case,) = _cases([name])
        m = case.ctor(device="cpu")
        seen.clear()
        with tcosts._kernels_as_ops(), Spy():
            m._functional_update(m._fresh_state(), *tcosts.case_batch(case, "cpu"))
        assert seen.count(op) == 1, (name, seen)


def test_the_baseline_round_trips_and_a_doubled_byte_count_fails(tmp_path, monkeypatch):
    cases = _cases(("MeanSquaredError", "BinaryAUROC"))
    results = tcosts.collect_cost_report(cases, device="cpu", dynamic=False)
    path = str(tmp_path / "perf_baseline.json")
    written = profile.write_cost_baseline(path, results)
    assert profile.load_cost_baseline(path) == written == profile.report_to_dict(results)
    assert profile.diff_cost_baseline(results, written) == ([], [], [])

    # a planted extra op: the squared error is computed twice, so the update's counted bytes double
    import metrics_tpu_torch.regression as treg

    update = treg.MeanSquaredError.update

    def heavier(self, preds, target):
        for _ in range(3):
            update(self, preds, target)
        self.sum_squared_error = self.sum_squared_error / 3
        self.total = self.total // 3

    monkeypatch.setattr(treg.MeanSquaredError, "update", heavier)
    heavy = tcosts.collect_cost_report(cases[:1], device="cpu", dynamic=False)
    assert heavy[0].cost["bytes_accessed"] > 1.5 * written["MeanSquaredError"]["bytes_accessed"]
    regressions, _, _ = profile.diff_cost_baseline(heavy, written)
    assert len(regressions) == 1 and regressions[0].startswith("MeanSquaredError: bytes_accessed")
    rc = profile.main(["--device", "cpu", "--baseline", path, "--classes", "MeanSquaredError", "-q"])
    assert rc == 1


def test_the_committed_baseline_passes_the_cli_on_the_cpu(capsys):
    rc = profile.main(["--device", "cpu", "--classes", ",".join(HANDFUL), "--static-only"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "6/7 classes profiled, 0 regression(s)" in out


def test_the_telemetry_overhead_stays_under_its_budget_on_the_cpu(tmp_path):
    assert (overhead.MAX_OVERHEAD_PCT, overhead.SPANS_PER_STEP, overhead.CHECKS_PER_STEP) == (2.0, 1, 2)
    report = {}
    path = str(tmp_path / "telemetry_baseline.json")
    rc = overhead.run_telemetry_check(str(tmp_path), baseline_path=path, update_baseline=True, quiet=True,
                                      report=report, device="cpu")
    assert rc == 0, report
    for section in ("disabled_mode", "enabled_watchdog", "enabled_metering"):
        assert report[section]["overhead_pct"] < overhead.MAX_OVERHEAD_PCT
    with open(path, encoding="utf-8") as fh:
        assert json.load(fh)["telemetry"]["disabled_mode"]["step_us"] == report["disabled_mode"]["step_us"]
    if not torch.cuda.is_available():  # the step loop runs on the card unless the caller names the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            overhead.measure_step_cost(steps=1, repeats=1)
