"""The port's ``BootStrapper`` against the JAX package's.

Both packages draw the resampling indices from numpy's global random state,
one draw per copy in copy order, so one seed gives both the same rows: the
sampler's indices must be equal, and the mean, std, quantiles and raw values
within rtol 1e-6 (the copies' scores are float32 quotients of equal counts;
the mean and std are float32 reductions over 5-20 values). The per-rank fan-in
of the copies is held against the ``merge_state`` fan-in, as the JAX
package's dryrun does.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.regression as jreg
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.regression as treg
from metrics_tpu.wrappers import BootStrapper as RefBootStrapper
from metrics_tpu.wrappers.bootstrapping import _bootstrap_sampler as ref_sampler
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.parallel import allreduce_over_mesh
from metrics_tpu_torch.wrappers import BootStrapper
from metrics_tpu_torch.wrappers.bootstrapping import _bootstrap_sampler

RTOL = 1e-6

BASES = {
    "accuracy": (lambda: tc.MulticlassAccuracy(num_classes=5, average="micro", device="cpu"),
                 lambda: jc.MulticlassAccuracy(num_classes=5, average="micro"), "labels"),
    "f1_macro": (lambda: tc.MulticlassF1Score(num_classes=5, average="macro", device="cpu"),
                 lambda: jc.MulticlassF1Score(num_classes=5, average="macro"), "labels"),
    "mse": (lambda: treg.MeanSquaredError(device="cpu"), lambda: jreg.MeanSquaredError(), "values"),
}


def _batches(kind, seed=0, n_batches=3, n=48):
    rng = np.random.RandomState(seed)
    if kind == "labels":
        return [(rng.randint(0, 5, n), rng.randint(0, 5, n)) for _ in range(n_batches)]
    return [(rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)) for _ in range(n_batches)]


def _both(base, seed=0, **kw):
    make_port, make_ref, kind = BASES[base]
    batches = _batches(kind, seed)
    np.random.seed(1234)
    ref = RefBootStrapper(make_ref(), **kw)
    for p, t in batches:
        ref.update(jnp.asarray(p), jnp.asarray(t))
    np.random.seed(1234)
    port = BootStrapper(make_port(), **kw)
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    return port, ref


def _agree(port, ref):
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key].dtype == torch.float32, key
        np.testing.assert_allclose(port[key].numpy(), np.asarray(ref[key]), rtol=RTOL, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("strategy", ["multinomial", "poisson"])
@pytest.mark.parametrize("size", [1, 17, 256])
def test_sampler_draws_the_reference_indices(strategy, size):
    np.random.seed(size)
    want = ref_sampler(size, strategy)
    np.random.seed(size)
    np.testing.assert_array_equal(_bootstrap_sampler(size, strategy), want)
    rng_a, rng_b = np.random.RandomState(5), np.random.RandomState(5)
    np.testing.assert_array_equal(_bootstrap_sampler(size, strategy, rng_a), ref_sampler(size, strategy, rng_b))


@pytest.mark.parametrize("strategy", ["multinomial", "poisson"])
@pytest.mark.parametrize("base", sorted(BASES))
def test_bootstrap_matches_reference(base, strategy):
    port, ref = _both(base, num_bootstraps=8, quantile=[0.05, 0.5, 0.95], raw=True, sampling_strategy=strategy)
    _agree(port.compute(), ref.compute())


@pytest.mark.parametrize("kw", [{}, {"mean": False, "std": False, "raw": True}, {"quantile": 0.25},
                                {"num_bootstraps": 20, "std": False}],
                         ids=["default", "raw_only", "one_quantile", "twenty"])
def test_bootstrap_options_match_reference(kw):
    port, ref = _both("accuracy", seed=1, **kw)
    _agree(port.compute(), ref.compute())


def test_default_sampling_is_multinomial_and_forward_matches_reference():
    port = BootStrapper(BASES["accuracy"][0]())
    assert port.sampling_strategy == RefBootStrapper(BASES["accuracy"][1]()).sampling_strategy == "multinomial"
    p, t = _batches("labels", 2)[0]
    np.random.seed(9)
    got = port(torch.from_numpy(p), torch.from_numpy(t))
    np.random.seed(9)
    ref = RefBootStrapper(BASES["accuracy"][1]())
    _agree(got, ref(jnp.asarray(p), jnp.asarray(t)))


def test_keyword_inputs_and_errors_match_reference():
    p, t = _batches("labels", 3)[0]
    np.random.seed(4)
    port = BootStrapper(BASES["accuracy"][0](), num_bootstraps=4)
    port.update(preds=torch.from_numpy(p), target=torch.from_numpy(t))
    np.random.seed(4)
    ref = RefBootStrapper(BASES["accuracy"][1](), num_bootstraps=4)
    ref.update(preds=jnp.asarray(p), target=jnp.asarray(t))
    _agree(port.compute(), ref.compute())
    with pytest.raises(ValueError, match="sampling_strategy"):
        BootStrapper(BASES["accuracy"][0](), sampling_strategy="jackknife")
    with pytest.raises(ValueError, match="base metric"):
        BootStrapper(lambda x: x)
    with pytest.raises(ValueError, match="no bootstrapping"):
        port.update(1, 2)


def test_reset_and_state_dict_follow_the_reference():
    port, ref = _both("accuracy", num_bootstraps=3)
    port.persistent(True)
    ref.persistent(True)
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    port.reset()
    assert all(m.update_count == 0 for m in port.metrics) and port.update_count == 0


def test_reference_replicas_load_into_the_port():
    port, ref = _both("accuracy", num_bootstraps=5)
    ref.persistent(True)
    loaded = load_reference_state(BootStrapper(BASES["accuracy"][0](), num_bootstraps=5), ref.state_dict())
    for got, want in zip(loaded.metrics, port.metrics):
        for key, value in want.metric_state.items():
            assert torch.equal(got.metric_state[key], value), key
    _agree(loaded.compute(), ref.compute())


def test_rank_replicates_folded_equal_the_merge_state_fan_in():
    """The JAX package's dryrun check: each copy's states from uneven ranks, folded by the fan-in, equal the
    copies merged one rank after another with ``merge_state``."""
    rng = np.random.RandomState(6)
    base = BASES["accuracy"][0]()
    ranks = []
    for size in (3, 5, 7, 9):
        bs = BootStrapper(base, num_bootstraps=3)
        bs.update(torch.from_numpy(rng.randint(0, 5, size)), torch.from_numpy(rng.randint(0, 5, size)))
        ranks.append(bs)
    for j in range(3):
        merged = allreduce_over_mesh([bs.metrics[j].metric_state for bs in ranks], ranks[0].metrics[j]._reductions)
        via_fan_in = base.clone()
        via_fan_in.reset()
        via_fan_in.load_merged_state(merged)
        offline = ranks[0].metrics[j].clone()
        for bs in ranks[1:]:
            offline.merge_state(bs.metrics[j])
        torch.testing.assert_close(via_fan_in.compute(), offline.compute(), rtol=RTOL, atol=0)
