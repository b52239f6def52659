"""The port's group-fairness metrics against the JAX package's.

The same seeded numpy inputs go through both packages. Per-group counts must
be equal (the port counts exactly in int64; the JAX package's float32 counts
are exact below 2^24 per group, and every group here stays far below), rates
and ratios within rtol 1e-6 (both float32, quotients of equal counts).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.functional.classification as jf
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.functional.classification as tf
from metrics_tpu.functional.classification.group_fairness import (
    _binary_groups_stat_scores_tensor as ref_counts,
)
from metrics_tpu_torch.functional.classification.group_fairness import (
    _binary_groups_stat_scores_tensor as port_counts,
)
from metrics_tpu_torch.interop import load_reference_state

RTOL = 1e-6


def _close(port, ref):
    assert sorted(port) == sorted(ref)
    for key in ref:
        got, want = port[key], np.asarray(ref[key])
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, key
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, equal_nan=True)


def _inputs(seed, n=300, num_groups=5, logits=False, ignore=False, shape=None):
    rng = np.random.RandomState(seed)
    shape = shape or (n,)
    preds = rng.randn(*shape).astype(np.float32) if logits else rng.rand(*shape).astype(np.float32)
    target = rng.randint(0, 2, shape)
    if ignore:
        target[rng.rand(*shape) < 0.1] = -1
    groups = rng.randint(0, num_groups, shape[0])
    return preds, target, groups


def _both(fn_name, *args, **kwargs):
    port = getattr(tf, fn_name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args], **kwargs)
    ref = getattr(jf, fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args], **kwargs)
    return port, ref


@pytest.mark.parametrize(("logits", "ignore", "threshold"), [(False, False, 0.5), (True, False, 0.5),
                                                             (False, True, 0.3), (True, True, 0.7)])
def test_group_counts_match_reference(logits, ignore, threshold):
    preds, target, groups = _inputs(1, logits=logits, ignore=ignore)
    kwargs = {"threshold": threshold, "ignore_index": -1 if ignore else None}
    got = port_counts(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups), 5, **kwargs)
    want = ref_counts(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups), 5, **kwargs)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("num_groups", [2, 5])
@pytest.mark.parametrize("ignore", [False, True])
def test_binary_groups_stat_rates_matches_reference(num_groups, ignore):
    preds, target, groups = _inputs(2, num_groups=num_groups, ignore=ignore)
    kwargs = {"ignore_index": -1} if ignore else {}
    _close(*_both("binary_groups_stat_rates", preds, target, groups, num_groups, **kwargs))


def test_empty_group_rates_are_zero_in_the_functional():
    preds, target, groups = _inputs(3, num_groups=2)
    _close(*_both("binary_groups_stat_rates", preds, target, groups, 4))


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_demographic_parity_and_equal_opportunity_match_reference(seed):
    preds, target, groups = _inputs(seed, logits=seed == 5)
    _close(*_both("demographic_parity", preds, groups))
    _close(*_both("equal_opportunity", preds, target, groups))


@pytest.mark.parametrize("task", ["demographic_parity", "equal_opportunity", "all"])
def test_binary_fairness_functional_matches_reference(task):
    preds, target, groups = _inputs(7)
    _close(*_both("binary_fairness", preds, target, groups, task=task))
    preds, target, groups = _inputs(7, shape=(120, 3))  # one group id per row of three predictions
    with pytest.raises(ValueError, match="[Ii]ncompatible shapes"):
        tf.binary_fairness(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups), task=task)
    with pytest.raises(ValueError, match="[Ii]ncompatible shapes"):
        jf.binary_fairness(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups), task=task)


@pytest.mark.parametrize("task", ["demographic_parity", "equal_opportunity", "all"])
def test_binary_fairness_class_matches_reference(task):
    port, ref = tc.BinaryFairness(num_groups=5, task=task, device="cpu"), jc.BinaryFairness(num_groups=5, task=task)
    for seed in range(8, 11):
        preds, target, groups = _inputs(seed)
        tgt_t = None if task == "demographic_parity" else torch.from_numpy(target)
        tgt_j = None if task == "demographic_parity" else jnp.asarray(target)
        port.update(torch.from_numpy(preds), tgt_t, torch.from_numpy(groups))
        ref.update(jnp.asarray(preds), tgt_j, jnp.asarray(groups))
    _close(port.compute(), ref.compute())


def test_binary_group_stat_rates_class_matches_reference():
    port, ref = tc.BinaryGroupStatRates(num_groups=5, device="cpu"), jc.BinaryGroupStatRates(num_groups=5)
    for seed in range(11, 14):
        preds, target, groups = _inputs(seed)
        port.update(*[torch.from_numpy(a) for a in (preds, target, groups)])
        ref.update(*[jnp.asarray(a) for a in (preds, target, groups)])
    for key in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(port, key).numpy(), np.asarray(getattr(ref, key)))
    _close(port.compute(), ref.compute())


def test_demographic_parity_task_warns_on_a_target():
    port = tc.BinaryFairness(num_groups=2, task="demographic_parity", device="cpu")
    preds, target, groups = _inputs(14, num_groups=2)
    with pytest.warns(UserWarning, match="does not require a target"):
        port.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups))


def test_argument_errors_match_reference():
    preds, target, groups = _inputs(15, num_groups=3)
    for package, fn_pkg, array in ((tc, tf, torch.from_numpy), (jc, jf, jnp.asarray)):
        kw = {"device": "cpu"} if package is tc else {}
        with pytest.raises(ValueError, match="num_groups"):
            package.BinaryFairness(num_groups=1, **kw)
        with pytest.raises(ValueError, match="task"):
            package.BinaryFairness(num_groups=2, task="parity", **kw)
        with pytest.raises(ValueError, match="larger than the specified number of groups"):
            fn_pkg.binary_groups_stat_rates(array(preds), array(target), array(groups), 2)
        with pytest.raises(ValueError, match="Expected dtype of argument groups to be int"):
            fn_pkg.binary_groups_stat_rates(array(preds), array(target), array(groups.astype(np.float32)), 3)
        with pytest.raises(ValueError, match="Expected argument `task`"):
            fn_pkg.binary_fairness(array(preds), array(target), array(groups), task="x")


def test_exports_follow_the_reference_order():
    import metrics_tpu.classification as jcls
    import metrics_tpu.functional.classification as jfun

    for port, ref, names in ((tc, jcls, ["BinaryFairness", "BinaryGroupStatRates"]),
                             (tf, jfun, ["binary_fairness", "binary_groups_stat_rates", "demographic_parity",
                                         "equal_opportunity"])):
        assert [n for n in port.__all__ if n in names] == [n for n in ref.__all__ if n in names] == names
        before = ref.__all__[ref.__all__.index(names[0]) - 1]
        assert port.__all__[port.__all__.index(names[0]) - 1] == before


def test_reference_state_loads_into_the_port():
    ref = jc.BinaryFairness(num_groups=5)
    port = tc.BinaryFairness(num_groups=5, device="cpu")
    batches = [_inputs(seed) for seed in range(16, 19)]
    for preds, target, groups in batches[:2]:
        ref.update(*[jnp.asarray(a) for a in (preds, target, groups)])
    ref.persistent(True)
    load_reference_state(port, ref.state_dict())
    assert port.tp.dtype == torch.int64
    preds, target, groups = batches[2]
    ref.update(*[jnp.asarray(a) for a in (preds, target, groups)])
    port.update(*[torch.from_numpy(a) for a in (preds, target, groups)])
    _close(port.compute(), ref.compute())


NEG_PREDS, NEG_TARGET, NEG_GROUPS = [1, 0, 1, 1], [1, 0, 0, 1], [0, 1, -1, 1]


@pytest.mark.parametrize("validate_args", [True, False])
@pytest.mark.parametrize("fn_name", ["binary_groups_stat_rates", "demographic_parity", "equal_opportunity"])
def test_negative_group_id_drops_the_sample_as_the_reference_does(fn_name, validate_args):
    """A group id of -1 leaves its sample out of every group, in both packages: the same rates as the
    three-sample input without it."""
    preds, target, groups = (np.asarray(x) for x in (NEG_PREDS, NEG_TARGET, NEG_GROUPS))
    args = {"binary_groups_stat_rates": (preds, target, groups, 2), "demographic_parity": (preds, groups),
            "equal_opportunity": (preds, target, groups)}[fn_name]
    port, ref = _both(fn_name, *args, validate_args=validate_args)
    _close(port, ref)
    keep = groups >= 0
    dropped = {"binary_groups_stat_rates": (preds[keep], target[keep], groups[keep], 2),
               "demographic_parity": (preds[keep], groups[keep]),
               "equal_opportunity": (preds[keep], target[keep], groups[keep])}[fn_name]
    _close(port, _both(fn_name, *dropped, validate_args=validate_args)[1])


@pytest.mark.parametrize("validate_args", [True, False])
def test_negative_group_id_in_the_class_matches_reference(validate_args):
    port = tc.BinaryFairness(num_groups=2, task="all", validate_args=validate_args, device="cpu")
    ref = jc.BinaryFairness(num_groups=2, task="all", validate_args=validate_args)
    port.update(*(torch.tensor(x) for x in (NEG_PREDS, NEG_TARGET, NEG_GROUPS)))
    ref.update(*(jnp.asarray(x) for x in (NEG_PREDS, NEG_TARGET, NEG_GROUPS)))
    _close(port.compute(), ref.compute())
