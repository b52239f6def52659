"""The port's clustering metrics against the JAX package's, on the same seeded numpy inputs.

Contingency matrices are equal (int64 counts cast to the float type, exact below 2^24 per cell). The label
scores are float32 sums over the matrix taken in another order: within ``LABEL_RTOL``. AMI's expected mutual
information is a blocked float64 sum on the device where the JAX package loops on the host: AMI within
``AMI_RTOL`` (the labels are drawn to agree in part, so that AMI stays away from 0, where ``mi - emi`` would
cancel). The embedding scores (Calinski-Harabasz, Davies-Bouldin, Dunn) sum centroids and distances in
another order: within ``INTRINSIC_RTOL``. In the float64 regime (``jax.enable_x64(True)`` against the port
under a float64 default) every score is within ``X64_RTOL``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.clustering as jcm
import metrics_tpu.functional.clustering as jc
import metrics_tpu_torch.clustering as tcm
import metrics_tpu_torch.functional.clustering as tc
from metrics_tpu.functional.clustering import extrinsic as jx
from metrics_tpu_torch import MetricCollection
from metrics_tpu_torch.functional.clustering import extrinsic as tx
from metrics_tpu_torch.interop import load_reference_state

LABEL_RTOL = 1e-6
AMI_RTOL = 1e-5
INTRINSIC_RTOL = 1e-5
X64_RTOL = 1e-9

LABEL_FNS = ["adjusted_mutual_info_score", "adjusted_rand_score", "completeness_score", "fowlkes_mallows_index",
             "homogeneity_score", "mutual_info_score", "normalized_mutual_info_score", "rand_score",
             "v_measure_score"]
EMBEDDING_FNS = ["calinski_harabasz_score", "davies_bouldin_score", "dunn_index"]
LABEL_CLASSES = ["AdjustedMutualInfoScore", "AdjustedRandScore", "CompletenessScore", "FowlkesMallowsIndex",
                 "HomogeneityScore", "MutualInfoScore", "NormalizedMutualInfoScore", "RandScore", "VMeasureScore"]
EMBEDDING_CLASSES = ["CalinskiHarabaszScore", "DaviesBouldinScore", "DunnIndex"]
AVERAGE_METHODS = ["min", "geometric", "arithmetic", "max"]


def _labels(seed, n=300, k_target=6, k_preds=8, agree=0.6):
    """Cluster labels that agree with the target on about ``agree`` of the samples; neither set is
    contiguous or starts at 0 (both packages compact them)."""
    rng = np.random.RandomState(seed)
    target = rng.randint(0, k_target, n)
    preds = np.where(rng.rand(n) < agree, target % k_preds, rng.randint(0, k_preds, n))
    return preds * 3 + 7, target - 2


def _embeddings(seed, n=240, d=12, k=5):
    """Gaussian blobs around ``k`` centres, labels not contiguous."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, k, n)
    centres = 4 * rng.randn(k, d)
    data = (centres[labels] + rng.randn(n, d)).astype(np.float32)
    return data, labels * 2 + 1


def _rtol(name):
    return AMI_RTOL if "adjusted_mutual" in name or "AdjustedMutual" in name else LABEL_RTOL


def _close(port, ref, rtol, atol=0.0):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (port.dtype, ref.dtype)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("as_float", [False, True])
def test_contingency_matrix_equals_reference(seed, as_float):
    p, t = _labels(seed)
    if as_float:
        p, t = p.astype(np.float64) / 4, t.astype(np.float64) / 4
    got = tx.calculate_contingency_matrix(torch.from_numpy(p), torch.from_numpy(t))
    want = jx.calculate_contingency_matrix(jnp.asarray(p), jnp.asarray(t))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", LABEL_FNS)
def test_label_function_matches_reference(name, seed):
    p, t = _labels(seed, n=200 + 50 * seed, k_target=4 + seed, k_preds=9 - seed)
    got = getattr(tc, name)(torch.from_numpy(p), torch.from_numpy(t))
    want = getattr(jc, name)(jnp.asarray(p), jnp.asarray(t))
    _close(got, want, _rtol(name))


@pytest.mark.parametrize("method", AVERAGE_METHODS)
@pytest.mark.parametrize("name", ["normalized_mutual_info_score", "adjusted_mutual_info_score"])
def test_every_average_method_matches_reference(name, method):
    p, t = _labels(5, n=400, k_target=7, k_preds=5)
    got = getattr(tc, name)(torch.from_numpy(p), torch.from_numpy(t), average_method=method)
    want = getattr(jc, name)(jnp.asarray(p), jnp.asarray(t), average_method=method)
    _close(got, want, _rtol(name))


def test_unknown_average_method_raises_in_both():
    p, t = _labels(0)
    with pytest.raises(ValueError, match="average method"):
        jc.normalized_mutual_info_score(jnp.asarray(p), jnp.asarray(t), average_method="harmonic")
    with pytest.raises(ValueError, match="average method"):
        tc.normalized_mutual_info_score(torch.from_numpy(p), torch.from_numpy(t), average_method="harmonic")


@pytest.mark.parametrize("beta", [0.5, 2.0])
def test_v_measure_beta_matches_reference(beta):
    p, t = _labels(3)
    got = tc.v_measure_score(torch.from_numpy(p), torch.from_numpy(t), beta=beta)
    want = jc.v_measure_score(jnp.asarray(p), jnp.asarray(t), beta=beta)
    _close(got, want, LABEL_RTOL)


@pytest.mark.parametrize("name", LABEL_FNS)
def test_single_cluster_matches_reference(name):
    _, t = _labels(4)
    p = np.full_like(t, 3)
    got = getattr(tc, name)(torch.from_numpy(p), torch.from_numpy(t))
    want = getattr(jc, name)(jnp.asarray(p), jnp.asarray(t))
    _close(got, want, LABEL_RTOL)


@pytest.mark.parametrize("name", EMBEDDING_FNS)
def test_single_cluster_embeddings_match_reference(name):
    """One cluster: Davies-Bouldin is -inf and Dunn +inf in both; Calinski-Harabasz's between-cluster sum is the
    rounding of ``centroid - mean``, so it is held to an absolute 1e-9."""
    data, _ = _embeddings(6)
    labels = np.zeros(len(data), dtype=np.int64)
    got = getattr(tc, name)(torch.from_numpy(data), torch.from_numpy(labels))
    want = getattr(jc, name)(jnp.asarray(data), jnp.asarray(labels))
    _close(got, want, INTRINSIC_RTOL, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_expected_mutual_info_matches_reference(seed):
    p, t = _labels(seed, n=400, k_target=7, k_preds=9)
    got = tx._expected_mutual_info(tx.calculate_contingency_matrix(torch.from_numpy(p), torch.from_numpy(t)))
    want = jx._expected_mutual_info(jx.calculate_contingency_matrix(jnp.asarray(p), jnp.asarray(t)))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("budget", [1, 7, 64])
def test_expected_mutual_info_in_small_blocks_equals_one_block(monkeypatch, budget):
    """Blocks of one cell (a budget below the longest range), of a few cells, and of many give the sum of one
    block; the float64 sums are taken in another order, which the float32 result does not see beyond 1 ulp."""
    p, t = _labels(2, n=500, k_target=10, k_preds=8)
    c = tx.calculate_contingency_matrix(torch.from_numpy(p), torch.from_numpy(t))
    whole = tx._expected_mutual_info(c)
    monkeypatch.setattr(tx, "_CPU_EMI_BLOCK_TERMS", budget)
    _close(tx._expected_mutual_info(c), whole.numpy(), 1.2e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", EMBEDDING_FNS)
def test_embedding_function_matches_reference(name, seed):
    data, labels = _embeddings(seed, n=200 + 40 * seed, k=3 + seed)
    got = getattr(tc, name)(torch.from_numpy(data), torch.from_numpy(labels))
    want = getattr(jc, name)(jnp.asarray(data), jnp.asarray(labels))
    _close(got, want, INTRINSIC_RTOL)


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0])
def test_dunn_index_norms_match_reference(p):
    data, labels = _embeddings(9)
    got = tc.dunn_index(torch.from_numpy(data), torch.from_numpy(labels), p=p)
    want = jc.dunn_index(jnp.asarray(data), jnp.asarray(labels), p=p)
    _close(got, want, INTRINSIC_RTOL)


@pytest.mark.parametrize("name", LABEL_FNS + EMBEDDING_FNS)
def test_float64_regime_matches_reference(name):
    if name in EMBEDDING_FNS:
        a, b = _embeddings(11)
    else:
        a, b = _labels(11)
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        got = getattr(tc, name)(torch.from_numpy(a), torch.from_numpy(b))
    finally:
        torch.set_default_dtype(previous)
    with jax.enable_x64(True):
        want = np.asarray(getattr(jc, name)(jnp.asarray(a), jnp.asarray(b)))
    assert want.dtype == np.float64
    # AMI's EMI is float32 in both packages, so its score keeps float32's agreement
    _close(got, want, AMI_RTOL if "adjusted_mutual" in name else (INTRINSIC_RTOL if name in EMBEDDING_FNS
                                                                   else X64_RTOL))


def _pair(name, **kwargs):
    return getattr(tcm, name)(device="cpu", **kwargs), getattr(jcm, name)(**kwargs)


def _batches(name, seed, n_batches=3):
    if name in EMBEDDING_CLASSES:
        data, labels = _embeddings(seed, n=60 * n_batches)
        return [(data[i::n_batches], labels[i::n_batches]) for i in range(n_batches)]
    p, t = _labels(seed, n=90 * n_batches)
    return [(p[i::n_batches], t[i::n_batches]) for i in range(n_batches)]


CLASS_CASES = [(n, {}) for n in LABEL_CLASSES + EMBEDDING_CLASSES] + [
    ("VMeasureScore", {"beta": 0.5}), ("NormalizedMutualInfoScore", {"average_method": "geometric"}),
    ("AdjustedMutualInfoScore", {"average_method": "max"}), ("DunnIndex", {"p": 1.0}),
]
CLASS_IDS = [f"{n}{kw}" if kw else n for n, kw in CLASS_CASES]


@pytest.mark.parametrize(("name", "kwargs"), CLASS_CASES, ids=CLASS_IDS)
def test_class_matches_reference(name, kwargs):
    port, ref = _pair(name, **kwargs)
    for a, b in _batches(name, 20):
        port.update(torch.from_numpy(a), torch.from_numpy(b))
        ref.update(jnp.asarray(a), jnp.asarray(b))
    rtol = INTRINSIC_RTOL if name in EMBEDDING_CLASSES else _rtol(name)
    _close(port.compute(), ref.compute(), rtol)


@pytest.mark.parametrize("name", ["AdjustedRandScore", "MutualInfoScore", "DaviesBouldinScore"])
def test_forward_returns_the_batch_value_as_reference(name):
    port, ref = _pair(name)
    for a, b in _batches(name, 21):
        _close(port(torch.from_numpy(a), torch.from_numpy(b)), ref(jnp.asarray(a), jnp.asarray(b)),
               INTRINSIC_RTOL)
    _close(port.compute(), ref.compute(), INTRINSIC_RTOL)


@pytest.mark.parametrize("name", LABEL_CLASSES + EMBEDDING_CLASSES)
def test_class_defaults_to_cuda_and_raises_without_one(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(tcm, name)()


def test_bad_arguments_raise_as_in_reference():
    for mod in (tcm, jcm):
        kwargs = {"device": "cpu"} if mod is tcm else {}
        with pytest.raises(ValueError, match="beta"):
            mod.VMeasureScore(beta=0, **kwargs)
        with pytest.raises(ValueError, match="average_method"):
            mod.NormalizedMutualInfoScore(average_method="harmonic", **kwargs)


@pytest.mark.parametrize("name", ["AdjustedMutualInfoScore", "RandScore", "CalinskiHarabaszScore", "DunnIndex"])
def test_state_carried_from_reference_continues_as_reference(name):
    port, ref = _pair(name)
    first, *rest = _batches(name, 22)
    ref.update(jnp.asarray(first[0]), jnp.asarray(first[1]))
    ref.persistent(True)
    load_reference_state(port, ref.state_dict())
    for a, b in rest:
        port.update(torch.from_numpy(a), torch.from_numpy(b))
        ref.update(jnp.asarray(a), jnp.asarray(b))
    assert port.update_count == ref.update_count == 3
    _close(port.compute(), ref.compute(), INTRINSIC_RTOL if name in EMBEDDING_CLASSES else _rtol(name))


def test_collection_equals_its_members_and_reference():
    names = ["MutualInfoScore", "AdjustedRandScore", "NormalizedMutualInfoScore", "FowlkesMallowsIndex"]
    coll = MetricCollection({n: getattr(tcm, n)(device="cpu") for n in names})
    alone = {n: getattr(tcm, n)(device="cpu") for n in names}
    ref = {n: getattr(jcm, n)() for n in names}
    for a, b in _batches("RandScore", 23):
        coll.update(torch.from_numpy(a), torch.from_numpy(b))
        for n in names:
            alone[n].update(torch.from_numpy(a), torch.from_numpy(b))
            ref[n].update(jnp.asarray(a), jnp.asarray(b))
    got = coll.compute()
    for n in names:
        assert torch.equal(got[n], alone[n].compute())
        _close(got[n], ref[n].compute(), LABEL_RTOL)


def _fake_sync(peer_states):
    """A dist_sync_fn handing back each (list) state beside the peer's, in rank order."""
    def sync_fn(states, group):
        return [[local, [peer_states[i]]] for i, local in enumerate(states)]
    return sync_fn


@pytest.mark.parametrize("name", ["AdjustedMutualInfoScore", "VMeasureScore", "DaviesBouldinScore"])
def test_cat_sync_of_two_ranks_equals_single_stream(name):
    """Two ranks' list states concatenated by the sync give the value of one metric fed both ranks' batches,
    in both packages."""
    batches = _batches(name, 24, n_batches=4)
    port, ref = _pair(name)
    peer, ref_peer = _pair(name)
    for a, b in batches[:2]:
        port.update(torch.from_numpy(a), torch.from_numpy(b))
        ref.update(jnp.asarray(a), jnp.asarray(b))
    for a, b in batches[2:]:
        peer.update(torch.from_numpy(a), torch.from_numpy(b))
        ref_peer.update(jnp.asarray(a), jnp.asarray(b))
    peer_states = [torch.cat(v) for v in peer.metric_state.values()]
    ref_peer_states = [jnp.concatenate(v) for v in ref_peer.metric_state.values()]
    port.sync(dist_sync_fn=_fake_sync(peer_states), distributed_available=True)
    ref.sync(dist_sync_fn=_fake_sync(ref_peer_states), distributed_available=True)
    single, _ = _pair(name)
    for a, b in batches:
        single.update(torch.from_numpy(a), torch.from_numpy(b))
    got = port._compute_impl()
    assert torch.equal(got, single.compute())
    rtol = INTRINSIC_RTOL if name in EMBEDDING_CLASSES else _rtol(name)
    _close(got, ref._compute_impl(), rtol)
    port.unsync()
