"""The port's chaos contracts against the JAX package's on the CPU: the faults each suite injects (the JAX
package's less the two an eager update has no target for), every contract holding, and the baseline
arithmetic."""

from __future__ import annotations

import pytest

from metrics_tpu_torch.analysis import chaos_contracts

CLASSES = ["BinaryAccuracy", "BinaryAUROC", "StructuralSimilarityIndexMeasure"]


def _case(name):
    return next(c for c in chaos_contracts.chaos_cases() if c.name == name)


def _jax_case(name):
    from metrics_tpu.observe.costs import PROFILE_CASES

    return next(c for c in PROFILE_CASES if c.name == name)


@pytest.mark.parametrize("name", CLASSES)
def test_metric_faults_are_the_jax_package_s_less_the_compiled_ones(name):
    """The metric suite injects the JAX package's faults but ``exc_trace`` and ``dispatch_death``, which it
    reports as skipped with the reason, and every contract holds (BinaryAUROC through B1's plain version,
    SSIM through B2's)."""
    from metrics_tpu.analysis.chaos_contracts import check_chaos_case

    want = check_chaos_case(_jax_case(name))
    got = chaos_contracts.check_chaos_case(_case(name), "cpu")
    assert got.ok and want.ok, got.render()
    compiled = {"exc_trace", "dispatch_death[probation]", "dispatch_death[steady]"}
    assert got.ran == tuple(f for f in want.ran if f not in compiled)
    assert [s.split(":")[0] for s in got.skipped] == list(chaos_contracts.SKIPPED_FAULTS)
    assert all(":" in s for s in got.skipped)


@pytest.mark.parametrize("suite", ["fleet", "shard"])
def test_fleet_and_sharded_scenarios_are_the_jax_package_s(suite):
    import metrics_tpu.analysis.chaos_contracts as jchaos

    check = {"fleet": "check_fleet_chaos_case", "shard": "check_shard_chaos_case"}[suite]
    want = getattr(jchaos, check)(_jax_case("BinaryAccuracy"))
    got = getattr(chaos_contracts, check)(_case("BinaryAccuracy"), "cpu")
    assert got.ok and want.ok, got.render()
    assert got.ran == want.ran and got.skipped == want.skipped


@pytest.mark.parametrize("name", CLASSES[1:])
def test_fleet_recovery_holds_for_the_kernel_classes(name):
    r = chaos_contracts.check_fleet_chaos_case(_case(name), "cpu")
    assert r.ok and len(r.ran) == 7, r.render()


def test_front_door_scenarios_hold():
    r = chaos_contracts.check_serve_chaos_case(_case("BinaryAccuracy"), "cpu")
    assert r.ok, r.render()
    assert r.ran == ("serve_kill[mid_frame]", "serve_torn[boundary]", "serve_dup[replay]", "serve_race[expire]")


def test_a_swallowed_fault_is_a_violation(monkeypatch):
    """A broken transactional update (the state changed by a failed update stays changed) is reported."""
    from metrics_tpu_torch.metric import Metric

    real = Metric._update_transactional

    def leaky(self, args, kwargs):
        try:
            real(self, args, kwargs)
        except Exception:
            self._update_count += 1  # the count survives the failure: no rollback
            raise

    monkeypatch.setattr(Metric, "_update_transactional", leaky)
    r = chaos_contracts.check_chaos_case(_case("BinaryAccuracy"), "cpu")
    assert not r.ok and any("_update_count" in v for v in r.violations)


def test_chaos_baseline_diff():
    ok = chaos_contracts.ChaosResult("A", ("x",), (), ())
    bad = chaos_contracts.ChaosResult("B", ("x",), (), ("x: broke",))
    assert chaos_contracts.diff_chaos_baseline([ok, bad], {}) == ([bad], [])
    assert chaos_contracts.diff_chaos_baseline([ok, bad], {"B": "why", "A": "old"}) == ([], ["A"])
