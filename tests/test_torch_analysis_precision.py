"""The port's precision contract against the JAX package's on the CPU: the float32 probe against the JAX
package's x32 stream, the float64 oracle against a stream under ``jax.enable_x64(True)``, and the adversarial
regimes."""

from __future__ import annotations

import numpy as np
import pytest

from metrics_tpu_torch.analysis import precision_contracts


def _by_name(cases):
    return {c.name: c for c in cases}


# ---------------------------------------------------------------------------------------- precision
def _jax_stream(name, batches, x64):
    """The JAX package's stream of ``batches``: its jitted x32 update, or its eager update under
    ``jax.enable_x64(True)`` with the float batches widened (its oracle)."""
    import jax
    import jax.numpy as jnp

    import metrics_tpu.metric as metric_mod
    from metrics_tpu.observe.costs import PROFILE_CASES

    case = _by_name(PROFILE_CASES)[name]
    saved = metric_mod._JIT_UPDATE_DEFAULT
    try:
        metric_mod._JIT_UPDATE_DEFAULT = not x64
        with jax.enable_x64(x64):
            m = case.ctor()
            for b in batches:
                b = precision_contracts._widen_batch(b) if x64 else b
                m.update(*(jnp.asarray(a) if hasattr(a, "shape") else a for a in b))
            return [np.asarray(v) for v in jax.tree_util.tree_leaves(m.compute())]
    finally:
        metric_mod._JIT_UPDATE_DEFAULT = saved


# classes whose whole stream is float64 in the float64 regime in both packages; the others keep float32
# intermediates in both (MSE's float32 differences, the aggregators' float32 inputs), which torch and XLA sum
# in another order, so their oracles agree only to float32 rounding (ROADMAP.md section C)
@pytest.mark.parametrize("name", ["BinaryAccuracy", "MulticlassCohenKappa", "KLDivergence", "PSI",
                                  "NormalizedRootMeanSquaredError", "GeneralizedDiceScore"])
def test_precision_streams_are_the_jax_package_s(name):
    """The probe's float32 result equals the JAX package's x32 stream within 1e-6 relative, and the float64
    oracle a JAX stream under ``jax.enable_x64(True)`` within 1e-12."""
    case = _by_name(precision_contracts.precision_cases())[name]
    batches = precision_contracts._host_batches(case, precision_contracts._STEPS)
    probe = precision_contracts._run_stream(case.ctor, batches, x64=False, device="cpu")
    oracle = precision_contracts._run_stream(case.ctor, batches, x64=True, device="cpu")
    assert all(np.asarray(v).dtype == np.float64 for v in oracle if np.asarray(v).dtype.kind == "f")
    np.testing.assert_allclose(np.concatenate([np.ravel(v) for v in probe]).astype(np.float64),
                               np.concatenate([np.ravel(v) for v in _jax_stream(name, batches, False)]), rtol=1e-6)
    np.testing.assert_allclose(np.concatenate([np.ravel(v) for v in oracle]),
                               np.concatenate([np.ravel(v) for v in _jax_stream(name, batches, True)]),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("regime", ["regime:mean_large_offset", "regime:sum_long_horizon",
                                    "regime:variance_cancellation", "regime:counter_overflow"])
def test_regime_reaches_three_way_agreement(regime):
    """Each adversarial regime is stable and agrees; the compensated mean beats the plain fold by >= 10^3x."""
    r = precision_contracts.check_regime(regime, device="cpu")
    assert r.agree and r.runtime == "STABLE", r.render()
    if regime == "regime:mean_large_offset":
        ratio = float(r.detail.split("ratio=")[1])
        compensated = float(r.detail.split("compensated=")[1].split()[0])
        assert ratio >= 1e3 or compensated < 1e-7


@pytest.mark.slow
def test_compensated_decay_fold_tracks_oracle():
    verdict, detail = precision_contracts._REGIMES["regime:decay_long_horizon"]("cpu")
    assert verdict == "STABLE", detail


@pytest.mark.slow
def test_full_registry_precision_agreement():
    results = [precision_contracts.check_precision_case(c, "cpu") for c in precision_contracts.precision_cases()]
    assert [r.render() for r in results if not r.agree] == []
