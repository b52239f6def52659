"""The port's abstract, donation, aot and interleaving contracts against the JAX package's: every functional
kernel's fake-tensor trace against ``jax.eval_shape``, the three-way donation verdicts, the kernel-library
manifests' round trip through the RLE codec, and 1,100 schedules of the real server, engine, producer and
autonomic stack."""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest
import torch

from metrics_tpu_torch.analysis import abstract_contracts as tabs
from metrics_tpu_torch.analysis import aot_contracts as taot
from metrics_tpu_torch.analysis import donation_contracts as tdon
from metrics_tpu_torch.analysis import interleave_contracts as til

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------------------------ abstract contracts
def _jax_results():
    from metrics_tpu.analysis.abstract_contracts import verify_contracts

    return verify_contracts()


@pytest.fixture(scope="module")
def both_traces():
    """(JAX result, port result) per contract, in table order; both traced once for the file."""
    return list(zip(_jax_results(), tabs.verify_contracts(device="cpu")))


def test_the_table_is_the_jax_package_s():
    from metrics_tpu.analysis import abstract_contracts as jabs

    assert (tabs._N, tabs._C, tabs._L) == (jabs._N, jabs._C, jabs._L)
    assert [(c.name, c.kwargs) for c in tabs.CONTRACTS] == [(c.name, c.kwargs) for c in jabs.CONTRACTS]
    for t, j in zip(tabs.CONTRACTS, jabs.CONTRACTS):
        shapes = [(tuple(a.shape), str(a.dtype)) if hasattr(a, "dtype") else a for a in j.args]
        assert [(a.shape, str(a.dtype).replace("torch.", "")) if isinstance(a, tabs.TensorSpec) else a
                for a in t.args] == shapes, t.name


def test_every_contract_traces_to_the_jax_package_s_shapes(both_traces):
    """Every kernel traces cleanly on fake tensors, to the JAX package's output shapes; dtypes are equal but
    where the port's int64 counters stand for int32."""
    import jax

    assert len(both_traces) == len(tabs.CONTRACTS) >= 79
    widened = []
    for j, t in both_traces:
        assert j.ok and t.ok, (t.contract.name, t.contract.kwargs, t.error)
        jl = [(tuple(x.shape), str(x.dtype)) for x in jax.tree_util.tree_leaves(j.outputs)]
        from torch.utils._pytree import tree_leaves

        tl = [(x.shape, str(x.dtype).replace("torch.", "")) for x in tree_leaves(t.outputs)
              if isinstance(x, tabs.TensorSpec)]
        assert [s for s, _ in tl] == [s for s, _ in jl], t.contract.name
        for (_, jd), (_, td) in zip(jl, tl):
            assert td == jd or (jd, td) == ("int32", "int64"), (t.contract.name, jd, td)
            widened += [t.contract.name] if td != jd else []
    assert set(widened) <= {"stat_scores", "confusion_matrix", "sketches.ddsketch_delta",
                            "sketches.score_hist_delta", "sketches.calibration_delta"}


def test_a_shape_trace_leaves_no_fake_constant_behind(both_traces):
    """The per-device constants a kernel builds once (the decay polynomial, the calibration bin edges) are built
    afresh, and not kept, under a fake trace: the next real call on the device gets real tensors."""
    from torch._subclasses.fake_tensor import FakeTensor

    from metrics_tpu_torch.functional.sketches.ecdf import _edges_f32
    from metrics_tpu_torch.ops.decay import _poly_f64

    cpu = torch.device("cpu")
    assert not any(isinstance(t, FakeTensor) for t in _poly_f64(cpu))
    assert not isinstance(_edges_f32(10, torch.get_default_dtype(), cpu), FakeTensor)


def test_a_planted_host_read_fails_the_trace():
    """Negative control: a kernel that branches on its data cannot trace."""
    import metrics_tpu_torch.functional as F

    def bad_kernel(x):
        if bool(torch.sum(x) > 0):  # jitlint: disable=JL001 (deliberate fixture)
            return x
        return -x

    F._bad_kernel_for_contract_test = bad_kernel
    try:
        result = tabs.trace_contract(tabs.KernelContract("_bad_kernel_for_contract_test", (tabs.f32(4),)))
    finally:
        del F._bad_kernel_for_contract_test
    assert not result.ok and "DataDependent" in result.error


def test_an_unknown_kernel_is_a_failure():
    result = tabs.trace_contract(tabs.KernelContract("no_such_kernel_xyz", (tabs.f32(4),)))
    assert not result.ok and "AttributeError" in result.error


def test_outputs_are_specs_and_a_float64_leaf_fails_under_float32():
    result = tabs.trace_contract(tabs.KernelContract("mean_squared_error", (tabs.f32(8), tabs.f32(8))))
    assert result.ok and result.outputs == tabs.TensorSpec((), torch.float32)
    import metrics_tpu_torch.functional as F

    F._wide_kernel_for_contract_test = lambda x: x.double()
    try:
        result = tabs.trace_contract(tabs.KernelContract("_wide_kernel_for_contract_test", (tabs.f32(4),)))
    finally:
        del F._wide_kernel_for_contract_test
    assert not result.ok and "float64" in result.error


def test_the_kernel_ops_answer_through_their_fake_implementations():
    """B1's two ops and B2's give their output shapes on fake tensors and count no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from metrics_tpu_torch.ops import binned_hist as b1
    from metrics_tpu_torch.ops import ssim_window as b2

    before = (b1.binned_counts.launches, b1.binned_counts_labels.launches, b2.ssim_window.launches)
    with FakeTensorMode():
        preds, thr = torch.empty(12, 4), torch.empty(16)
        out = b1.binned_counts(preds, torch.empty(12, 4, dtype=torch.int32), torch.empty(12, 4, dtype=torch.bool), thr)
        lab = b1.binned_counts_labels(preds, torch.empty(12, dtype=torch.int32), thr)
        win = b2.ssim_window(torch.empty(6, 26, 26), [0.1] * 11, [0.1] * 11)
    assert [tuple(t.shape) for t in out] == [tuple(t.shape) for t in lab] == [(4, 16), (4, 16), (4,), (4,)]
    assert {t.dtype for t in out + lab} == {torch.int32}
    assert tuple(win.shape) == (6, 16, 16) and win.dtype == torch.float32
    assert (b1.binned_counts.launches, b1.binned_counts_labels.launches, b2.ssim_window.launches) == before


def test_a_fake_tensor_is_traced_and_eager_validation_still_raises():
    """Value checks skip on fake tensors as under vmap; on real tensors they still run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from metrics_tpu_torch.functional.classification import binary_accuracy
    from metrics_tpu_torch.functional.image.perceptual import _validate_lpips_images
    from metrics_tpu_torch.utils.checks import _is_traced

    with FakeTensorMode():
        x = torch.empty(4)
        assert _is_traced(x)
        assert tuple(binary_accuracy(torch.empty(12), torch.empty(12, dtype=torch.int32)).shape) == ()
        _validate_lpips_images(torch.empty(2, 3, 8, 8), torch.empty(2, 3, 8, 8), normalize=True)
    assert not _is_traced(torch.zeros(4))
    with pytest.raises(RuntimeError, match="Detected the following values"):
        binary_accuracy(torch.tensor([0.2, 0.9]), torch.tensor([0, 2]))
    with pytest.raises(ValueError, match="normalized tensors"):
        _validate_lpips_images(torch.full((1, 3, 4, 4), 2.0), torch.zeros(1, 3, 4, 4), normalize=True)


# ------------------------------------------------------------------------------------ donation
@pytest.fixture(scope="module")
def donation_report():
    return {r.name: r for r in tdon.collect_donation_report(device="cpu")}


def test_donation_verdicts_agree_three_ways(donation_report):
    """For every shared registry case: the port's static verdict equals the JAX package's classify_donation of
    the counterpart class, the costs verdict equals the static one, and the runtime is EAGER."""
    from metrics_tpu.analysis.donation_contracts import donation_cases as jcases
    from metrics_tpu.analysis.mem_rules import classify_donation as jclassify

    jax_verdicts = {c.name: jclassify(type(c.ctor()))[0] for c in jcases()}
    shared = set(jax_verdicts) & set(donation_report)
    assert len(shared) >= 60 and len(donation_report) == len(tdon.donation_cases())
    for name, r in donation_report.items():
        assert r.agree and r.runtime == "EAGER", r.render()
        assert r.costs_eligible == r.static_eligible, r.render()
        if name in shared:
            assert r.static_eligible == jax_verdicts[name], name


def _planted_case(update_in_place: bool):
    from metrics_tpu_torch.metric import Metric
    from metrics_tpu_torch.observe.costs import ProfileCase

    class Planted(Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            if update_in_place:
                self.total.add_(x.sum())  # donlint: disable=ML001 (deliberate fixture)
            else:
                self.total = self.total + x.sum()

        def compute(self):
            return self.total

    return ProfileCase("Planted", lambda device: Planted(device=device),
                       lambda r: (torch.from_numpy(r.rand(8).astype(np.float32)),))


def test_an_in_place_update_fails_the_held_read_check():
    bad = tdon.check_donation_case(_planted_case(True), "cpu")
    assert not bad.agree and bad.runtime == "ERROR:latch-bypassed", bad.render()
    good = tdon.check_donation_case(_planted_case(False), "cpu")
    assert good.agree and good.runtime == "EAGER", good.render()


def test_reset_binds_a_fresh_copy_of_each_default():
    from metrics_tpu_torch import SumMetric

    m = SumMetric(device="cpu")
    m.update(torch.ones(3))
    m.reset()
    state = m.metric_state["sum_value"]
    assert torch.equal(state, m._defaults["sum_value"])
    assert state.untyped_storage().data_ptr() != m._defaults["sum_value"].untyped_storage().data_ptr()


def test_the_donation_pass_and_its_baseline(tmp_path):
    baseline = tmp_path / "donlint.json"
    tdon.write_donation_baseline(str(baseline), [])
    assert tdon.load_donation_baseline(str(baseline)) == {}
    results = [tdon.DonationResult("A", True, "", True, "EAGER", True),
               tdon.DonationResult("B", True, "", False, "EAGER", False)]
    assert [r.name for r in tdon.diff_donation_baseline(results, {"Gone": "x"})[0]] == ["B"]
    assert tdon.diff_donation_baseline(results, {"B": "why", "Gone": "x"}) == ([], ["Gone"])


# ------------------------------------------------------------------------------------ aot
def _masks(rng, n, h, w):
    yy, xx = np.mgrid[:h, :w]
    cx, cy, r = rng.rand(n) * w, rng.rand(n) * h, 2 + rng.rand(n) * 4
    return ((xx[None] - cx[:, None, None]) ** 2 + (yy[None] - cy[:, None, None]) ** 2) <= r[:, None, None] ** 2


def _segm_batch(rng):
    gm = _masks(rng, 3, 16, 16)
    dm = gm ^ (rng.rand(3, 16, 16) < 0.05)
    lab = torch.from_numpy(rng.randint(0, 2, 3))
    return ([{"masks": torch.from_numpy(dm), "scores": torch.from_numpy(rng.rand(3).astype(np.float32)),
              "labels": lab}], [{"masks": torch.from_numpy(gm), "labels": lab}])


def test_aot_round_trips_the_rle_codec_and_refreshes_a_damaged_manifest(tmp_path):
    """Mask MAP loads the RLE codec on the CPU: ROUNDTRIP from its manifest with no build after the leg's one
    cold build; a damaged manifest gives NO_REUSE on the next reload (the refresh rebuilds it) and ROUNDTRIP
    after; a plain class is INELIGIBLE."""
    import metrics_tpu_torch.detection as td
    from metrics_tpu_torch.observe.costs import PROFILE_CASES, ProfileCase

    segm = ProfileCase("MeanAveragePrecision[segm]",
                       lambda device: td.MeanAveragePrecision(iou_type="segm", device=device), _segm_batch)
    plain = next(c for c in PROFILE_CASES if c.name == "BinaryAccuracy")
    with taot.AotLeg(str(tmp_path)) as leg:
        first = leg.check(segm, "cpu")
        assert first.verdict == "ROUNDTRIP" and first.libraries == ("rle_codec",), first.render()
        assert leg.builds == {"rle_codec": {"built": 1, "hit": 1}} and leg.cold_builds == 1
        assert leg.check(plain, "cpu").verdict == "INELIGIBLE"
        (manifest,) = glob.glob(os.path.join(str(tmp_path), "*.aotx"))
        data = bytearray(open(manifest, "rb").read())
        data[-1] ^= 0xFF
        open(manifest, "wb").write(bytes(data))
        damaged = leg.check(segm, "cpu")
        assert damaged.verdict == "NO_REUSE" and "refreshed" in damaged.detail, damaged.render()
        again = leg.check(segm, "cpu")
        assert again.verdict == "ROUNDTRIP", again.render()
    assert leg.cold_builds == 1 and leg.builds["rle_codec"] == {"built": 1, "hit": 2, "refreshed": 1}


def test_the_aot_pass_over_the_registry_and_its_baseline(tmp_path, monkeypatch):
    """On the CPU no registry class loads a native library: every one INELIGIBLE, nothing built; the baseline
    diff splits failures from stale keys."""
    results, builds = taot.collect_aot_report(device="cpu")
    assert {r.verdict for r in results} == {"INELIGIBLE"} and builds == {}
    baseline = tmp_path / "aot.json"
    taot.write_aot_contract_baseline(str(baseline), [])
    assert taot.load_aot_contract_baseline(str(baseline)) == {}
    rs = [taot.AotResult("Good", "ROUNDTRIP"), taot.AotResult("Bad", "DIVERGED"), taot.AotResult("Known", "NO_REUSE")]
    failures, stale = taot.diff_aot_contract_baseline(rs, {"Known": "why", "Gone": "was"})
    assert [r.name for r in failures] == ["Bad"] and stale == ["Gone"]


# ------------------------------------------------------------------------------------ interleaving
@pytest.fixture(autouse=False)
def _scoped():
    from metrics_tpu_torch import observe

    with observe.scope(reset=True):
        yield


def test_the_schedule_set_is_the_jax_package_s():
    from metrics_tpu.analysis import interleave_contracts as jil

    assert til.DEFAULT_TARGET_SCHEDULES == jil.DEFAULT_TARGET_SCHEDULES == 1100
    assert til._schedules(til.DEFAULT_TARGET_SCHEDULES) == jil._schedules(jil.DEFAULT_TARGET_SCHEDULES)


def test_full_exploration_zero_violations(tmp_path):
    """1,100 distinct schedules across the serve/tick/autonomic invariants, zero violations, and the baseline's
    section empty."""
    report = {}
    rc = til.run_interleave_check(ROOT, report=report, device="cpu")
    assert report["schedules_explored"] == 1100
    assert report["violations"] == {}, "\n".join(report["details"])
    assert report["new"] == {} and rc == 0 and report["stale_baseline_keys"] == []


def test_the_probe_flags_overlapping_segments():
    probe = til._SerializationProbe()
    tick = probe.wrap("tick", lambda: None)
    step = probe.wrap("autonomic", lambda: tick())
    step()
    assert probe.violations and "tick" in probe.violations[0]


def test_the_harness_catches_a_wal_that_drops_appends(tmp_path, monkeypatch, _scoped):
    from metrics_tpu_torch.engine.durability import IngestWAL

    monkeypatch.setattr(IngestWAL, "append", lambda self, *a, **k: 0)
    violations = til._run_schedule(("ingest", "poll", "pump", "kill"), str(tmp_path), "cpu")
    assert "acked-durable" in {v.split(":", 1)[0] for v in violations}, violations


def test_the_harness_catches_a_lying_aggregate(tmp_path, monkeypatch, _scoped):
    from metrics_tpu_torch.engine.stream import StreamEngine

    real = StreamEngine.compute_all

    def skewed(self):
        out = dict(real(self))
        return {k: float(v) + 1000.0 for k, v in out.items()} if out else out

    monkeypatch.setattr(StreamEngine, "compute_all", skewed)
    violations = til._run_schedule(("ingest", "poll", "tick", "aggregate"), str(tmp_path), "cpu")
    assert "aggregate-oracle" in {v.split(":", 1)[0] for v in violations}, violations


def test_resume_refuses_while_the_recovered_prefix_is_resending(tmp_path, _scoped):
    rig = til._Rig(str(tmp_path), "cpu")
    try:
        for seg in ("ingest", "poll", "pump", "ingest"):
            rig.segment(seg)
        rig.segment("kill")
        assert rig.producer.outstanding > 0
        with pytest.raises(Exception, match="unacked"):
            rig.producer.resume_from_watermark()
        assert rig.violations == []
    finally:
        rig.close()


def test_resume_after_quiesce_is_seq_safe_and_exactly_once(tmp_path, _scoped):
    rig = til._Rig(str(tmp_path), "cpu")
    try:
        for seg in ("ingest", "poll", "pump", "ingest"):
            rig.segment(seg)
        rig.segment("kill")
        rig.producer.flush(10.0)
        acked = rig.producer.acked
        rig.producer.resume_from_watermark()
        pseq = rig.producer.submit("s0", 99.0)
        rig.values[pseq] = 99.0
        assert pseq > acked
        rig.finish()
        assert rig.violations == [], rig.violations
    finally:
        rig.close()


# ------------------------------------------------------------------------------------ the command line
def test_a_dynamic_pass_with_a_report_prints_nothing(tmp_path, capsys):
    """With ``--format json`` the command line owns stdout (one JSON document): the telemetry pass, like every
    dynamic pass, fills its report and prints nothing."""
    from metrics_tpu_torch.observe.overhead import run_telemetry_check

    report: dict = {}
    assert run_telemetry_check(str(tmp_path), report=report, device="cpu") == 0
    assert capsys.readouterr().out == "" and "disabled_mode" in report
