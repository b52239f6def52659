"""The port's namespaces against the JAX package's.

Each ``__all__`` of the port must be the JAX package's ``__all__`` restricted
to the names that the port has, in the same order; every name of the JAX list
that the port's domain module has must be exported; and each exported name
must be the very object that its domain module defines.
"""

from __future__ import annotations

import importlib
import types

import pytest

import metrics_tpu
import metrics_tpu_torch

PAIRS = [
    ("metrics_tpu", "metrics_tpu_torch"),
    ("metrics_tpu.functional", "metrics_tpu_torch.functional"),
    ("metrics_tpu.retrieval", "metrics_tpu_torch.retrieval"),
    ("metrics_tpu.functional.retrieval", "metrics_tpu_torch.functional.retrieval"),
    ("metrics_tpu.detection", "metrics_tpu_torch.detection"),
    ("metrics_tpu.functional.detection", "metrics_tpu_torch.functional.detection"),
    ("metrics_tpu.wrappers", "metrics_tpu_torch.wrappers"),
    ("metrics_tpu.regression", "metrics_tpu_torch.regression"),
    ("metrics_tpu.functional.regression", "metrics_tpu_torch.functional.regression"),
    ("metrics_tpu.image", "metrics_tpu_torch.image"),
    ("metrics_tpu.functional.image", "metrics_tpu_torch.functional.image"),
    ("metrics_tpu.segmentation", "metrics_tpu_torch.segmentation"),
    ("metrics_tpu.functional.segmentation", "metrics_tpu_torch.functional.segmentation"),
    ("metrics_tpu.functional.classification", "metrics_tpu_torch.functional.classification"),
    ("metrics_tpu.functional.pairwise", "metrics_tpu_torch.functional.pairwise"),
    ("metrics_tpu.clustering", "metrics_tpu_torch.clustering"),
    ("metrics_tpu.functional.clustering", "metrics_tpu_torch.functional.clustering"),
    ("metrics_tpu.nominal", "metrics_tpu_torch.nominal"),
    ("metrics_tpu.functional.nominal", "metrics_tpu_torch.functional.nominal"),
    ("metrics_tpu.shape", "metrics_tpu_torch.shape"),
    ("metrics_tpu.functional.shape", "metrics_tpu_torch.functional.shape"),
    ("metrics_tpu.utils", "metrics_tpu_torch.utils"),
    ("metrics_tpu.sketches", "metrics_tpu_torch.sketches"),
    ("metrics_tpu.functional.sketches", "metrics_tpu_torch.functional.sketches"),
    ("metrics_tpu.windows", "metrics_tpu_torch.windows"),
    ("metrics_tpu.drift", "metrics_tpu_torch.drift"),
    ("metrics_tpu.text", "metrics_tpu_torch.text"),
    ("metrics_tpu.functional.text", "metrics_tpu_torch.functional.text"),
    ("metrics_tpu.audio", "metrics_tpu_torch.audio"),
    ("metrics_tpu.functional.audio", "metrics_tpu_torch.functional.audio"),
    ("metrics_tpu.observe", "metrics_tpu_torch.observe"),
    ("metrics_tpu.resilience", "metrics_tpu_torch.resilience"),
    ("metrics_tpu.engine", "metrics_tpu_torch.engine"),
    ("metrics_tpu.multimodal", "metrics_tpu_torch.multimodal"),
    ("metrics_tpu.functional.multimodal", "metrics_tpu_torch.functional.multimodal"),
    ("metrics_tpu.analysis", "metrics_tpu_torch.analysis"),
    ("metrics_tpu.aot", "metrics_tpu_torch.aot"),
]


def _port_name(module_name: str) -> str:
    return "metrics_tpu_torch" + module_name[len("metrics_tpu"):]


def _domain(ref_module: str, obj) -> str:
    """The JAX package's domain module of an exported object: its package below ``functional`` or the root."""
    module = obj.__name__ if isinstance(obj, types.ModuleType) else getattr(obj, "__module__", None)
    if module is None:  # a module-level constant (a str, int or tuple) lives where it is exported
        return ref_module
    parts = module.split(".")
    depth = 3 if parts[1] == "functional" and len(parts) > 3 else 2
    return ".".join(parts[:depth]) if len(parts) > depth else ref_module


def _ported(ref_name: str):
    """(name, JAX domain module) of every name in the JAX list whose port domain module has it."""
    ref = importlib.import_module(ref_name)
    out = []
    for name in ref.__all__:
        if name == "__version__":
            out.append((name, ref_name))
            continue
        obj = getattr(ref, name)
        if isinstance(obj, types.ModuleType):
            try:
                importlib.import_module(_port_name(obj.__name__))
            except ImportError:
                continue
            out.append((name, obj.__name__))
            continue
        domain = _domain(ref_name, obj)
        try:
            port_domain = importlib.import_module(_port_name(domain))
        except ImportError:
            continue
        if hasattr(port_domain, name):
            out.append((name, domain))
    return out


@pytest.mark.parametrize(("ref_name", "port_name"), PAIRS)
def test_all_is_the_reference_order_restricted_to_ported_names(ref_name, port_name):
    ref, port = importlib.import_module(ref_name), importlib.import_module(port_name)
    assert [n for n in ref.__all__ if n in set(port.__all__)] == list(port.__all__)
    assert not set(port.__all__) - set(ref.__all__)


@pytest.mark.parametrize(("ref_name", "port_name"), PAIRS)
def test_every_ported_name_is_exported(ref_name, port_name):
    port = importlib.import_module(port_name)
    assert [name for name, _ in _ported(ref_name)] == list(port.__all__)


@pytest.mark.parametrize(("ref_name", "port_name"), PAIRS)
def test_exported_names_are_their_domain_modules_objects(ref_name, port_name):
    port = importlib.import_module(port_name)
    for name, domain in _ported(ref_name):
        obj = getattr(port, name)
        if name == "__version__":
            assert isinstance(obj, str)
        elif isinstance(obj, types.ModuleType):
            assert obj is importlib.import_module(_port_name(domain)), name
        else:
            assert obj is getattr(importlib.import_module(_port_name(domain)), name), name


def test_top_level_imports_of_the_ported_classes():
    from metrics_tpu_torch import AUROC, Accuracy, BootStrapper, MeanSquaredError, RetrievalMAP  # noqa: F401
    from metrics_tpu_torch import (  # noqa: F401
        ModifiedPanopticQuality,
        MultiScaleStructuralSimilarityIndexMeasure,
        PanopticQuality,
        PeakSignalNoiseRatio,
    )
    from metrics_tpu_torch import (  # noqa: F401
        ClasswiseWrapper,
        ConcordanceCorrCoef,
        CosineSimilarity,
        CriticalSuccessIndex,
        ExplainedVariance,
        KendallRankCorrCoef,
        KLDivergence,
        LogCoshError,
        MeanAbsolutePercentageError,
        MeanSquaredLogError,
        MetricTracker,
        MinkowskiDistance,
        MinMaxMetric,
        MultioutputWrapper,
        MultitaskWrapper,
        NormalizedRootMeanSquaredError,
        R2Score,
        RelativeSquaredError,
        SymmetricMeanAbsolutePercentageError,
        TweedieDevianceScore,
        WeightedMeanAbsolutePercentageError,
    )
    from metrics_tpu_torch.functional import accuracy, retrieval_average_precision  # noqa: F401
    from metrics_tpu_torch.functional import (  # noqa: F401
        concordance_corrcoef,
        cosine_similarity,
        critical_success_index,
        explained_variance,
        kendall_rank_corrcoef,
        kl_divergence,
        log_cosh_error,
        mean_absolute_percentage_error,
        mean_squared_log_error,
        minkowski_distance,
        normalized_root_mean_squared_error,
        r2_score,
        relative_squared_error,
        symmetric_mean_absolute_percentage_error,
        tweedie_deviance_score,
        weighted_mean_absolute_percentage_error,
    )
    from metrics_tpu_torch.wrappers import (  # noqa: F401
        BinaryTargetTransformer,
        LambdaInputTransformer,
        MetricInputTransformer,
    )
    from metrics_tpu_torch.functional import (  # noqa: F401
        modified_panoptic_quality,
        multiscale_structural_similarity_index_measure,
        panoptic_quality,
        peak_signal_noise_ratio,
    )

    assert set(metrics_tpu_torch.__all__) == set(metrics_tpu.__all__)


def test_the_regression_domain_and_the_slice_s_wrappers_are_whole():
    """Every class and function of the JAX package's regression domain, and every wrapper, is ported: the
    wrappers' ``__all__`` is the JAX package's, in its order."""
    import metrics_tpu.functional.regression as jf
    import metrics_tpu.regression as jr
    import metrics_tpu.wrappers as jw
    import metrics_tpu_torch.functional.regression as tf
    import metrics_tpu_torch.regression as tr
    import metrics_tpu_torch.wrappers as tw

    assert tr.__all__ == jr.__all__ and len(tr.__all__) == 20
    assert tf.__all__ == jf.__all__ and len(tf.__all__) == 20
    assert sorted(set(jw.__all__) - set(tw.__all__)) == []
    assert tw.__all__ == jw.__all__


def test_the_replicated_wrapper_is_exported():
    """``ReplicatedWrapper`` is exported by ``wrappers`` as the JAX package exports it, as the class the
    port's replica engine defines."""
    import metrics_tpu_torch.wrappers as tw
    import metrics_tpu_torch.wrappers.replicated as replicated

    assert tw.ReplicatedWrapper is replicated.ReplicatedWrapper
    assert "ReplicatedWrapper" in tw.__all__


def test_image_beyond_the_models_and_segmentation_are_whole():
    """Every image class and function, the model-based ones (FID, KID, IS, MiFID, LPIPS, PPL) included, and the
    whole segmentation domain, are ported; ``generalized_dice_score`` is also in the classification namespace."""
    import metrics_tpu.functional.classification as jfc
    import metrics_tpu.functional.image as jfi
    import metrics_tpu.functional.segmentation as jfs
    import metrics_tpu.image as ji
    import metrics_tpu.segmentation as js
    import metrics_tpu_torch.functional.classification as tfc
    import metrics_tpu_torch.functional.image as tfi
    import metrics_tpu_torch.functional.segmentation as tfs
    import metrics_tpu_torch.image as ti
    import metrics_tpu_torch.segmentation as ts

    assert sorted(set(ji.__all__) - set(ti.__all__)) == []
    assert sorted(set(jfi.__all__) - set(tfi.__all__)) == []
    assert ti.__all__ == ji.__all__ and tfi.__all__ == jfi.__all__
    for name in ("FrechetInceptionDistance", "InceptionScore", "KernelInceptionDistance",
                 "LearnedPerceptualImagePatchSimilarity", "MemorizationInformedFrechetInceptionDistance",
                 "PerceptualPathLength"):
        assert getattr(ti, name).__module__.startswith("metrics_tpu_torch.image.")
    for name in ("learned_perceptual_image_patch_similarity", "perceptual_path_length"):
        assert getattr(tfi, name).__module__ == "metrics_tpu_torch.functional.image.perceptual"
    assert ts.__all__ == js.__all__ and tfs.__all__ == jfs.__all__
    assert tfc.__all__ == jfc.__all__
    assert tfc.generalized_dice_score is tfs.generalized_dice_score
    from metrics_tpu_torch import (  # noqa: F401
        ErrorRelativeGlobalDimensionlessSynthesis,
        RelativeAverageSpectralError,
        RootMeanSquaredErrorUsingSlidingWindow,
        SpectralAngleMapper,
        SpectralDistortionIndex,
        TotalVariation,
        UniversalImageQualityIndex,
        segmentation,
    )
    from metrics_tpu_torch.functional import image_gradients, segmentation as fseg, total_variation  # noqa: F401


def test_pairwise_clustering_nominal_and_shape_are_whole():
    """Every class and function of the pairwise, clustering, nominal and shape domains is ported, and the top
    level and ``functional`` export the JAX package's names of them: the five nominal classes and the three
    submodules; the five pairwise and nine nominal functions and the four submodules."""
    import metrics_tpu.functional as jf

    for domain in ("clustering", "nominal", "shape", "functional.pairwise", "functional.clustering",
                   "functional.nominal", "functional.shape"):
        ref = importlib.import_module(f"metrics_tpu.{domain}")
        port = importlib.import_module(f"metrics_tpu_torch.{domain}")
        assert port.__all__ == ref.__all__, domain
    new_top = ["CramersV", "FleissKappa", "PearsonsContingencyCoefficient", "TheilsU", "TschuprowsT", "clustering",
               "nominal", "shape"]
    assert [n for n in metrics_tpu.__all__ if n in new_top] == [n for n in metrics_tpu_torch.__all__ if n in new_top]
    assert set(new_top) < set(metrics_tpu_torch.__all__)
    new_functional = [n for n in jf.__all__ if n.startswith(("pairwise", "cramers", "fleiss", "pearsons_contingency",
                                                              "theils", "tschuprows"))
                      or n in ("clustering", "nominal", "shape")]
    assert len(new_functional) == 18
    assert [n for n in metrics_tpu_torch.functional.__all__ if n in new_functional] == new_functional


def test_the_streaming_slice_and_utils_are_whole():
    """The sketch, window and drift domains and ``utils`` export every name of the JAX package's, and the top
    level and ``functional`` the slice's seventeen and one names, in the JAX package's order."""
    import metrics_tpu.functional as jf

    for domain in ("utils", "sketches", "windows", "drift", "functional.sketches"):
        ref = importlib.import_module(f"metrics_tpu.{domain}")
        port = importlib.import_module(f"metrics_tpu_torch.{domain}")
        assert port.__all__ == ref.__all__, domain
    assert len(metrics_tpu_torch.utils.__all__) == 25 and len(metrics_tpu_torch.functional.sketches.__all__) == 18
    new_top = ["CUSUM", "DDSketch", "DecayedDDSketch", "DecayedHLL", "HyperLogLog", "KSDistance", "MetricLogbook",
               "PSI", "ReservoirSample", "StreamingAUROC", "StreamingCalibrationError", "TimeDecayed",
               "TumblingWindow", "drift", "integration", "sketches", "windows"]
    assert [n for n in metrics_tpu.__all__ if n in new_top] == [n for n in metrics_tpu_torch.__all__ if n in new_top]
    assert set(new_top) < set(metrics_tpu_torch.__all__)
    assert "sketches" in jf.__all__ and "sketches" in metrics_tpu_torch.functional.__all__
    from metrics_tpu_torch.utils import bincount, class_reduce, reduce  # noqa: F401


def test_observe_and_resilience_are_whole():
    """``observe`` and ``resilience`` export the JAX package's 30 and 12 names, in its order, and join the top
    level, which (with ``multimodal`` and ``aot`` since) lacks no name."""
    for domain, count in (("observe", 30), ("resilience", 12)):
        ref = importlib.import_module(f"metrics_tpu.{domain}")
        port = importlib.import_module(f"metrics_tpu_torch.{domain}")
        assert port.__all__ == ref.__all__ and len(port.__all__) == count, domain
        assert getattr(metrics_tpu_torch, domain) is port and domain in metrics_tpu_torch.__all__
    assert [n for n in metrics_tpu.__all__ if n not in metrics_tpu_torch.__all__] == []
    from metrics_tpu_torch.observe import explain, latency, metering, recorder, tracing, watchdog  # noqa: F401
    from metrics_tpu_torch.resilience import checkpoint, guards  # noqa: F401
    from metrics_tpu_torch.utils import io  # noqa: F401

    for name in ("FleetMeter", "SessionLedger", "SpaceSaving", "MeterPolicy", "install_meter"):
        assert hasattr(metering, name)
    assert [n for n in importlib.import_module("metrics_tpu.observe.metering").__all__
            if not hasattr(metering, n)] == []
    assert checkpoint.__all__ == importlib.import_module("metrics_tpu.resilience.checkpoint").__all__
    assert io.__all__ == importlib.import_module("metrics_tpu.utils.io").__all__
    assert guards.__all__ == importlib.import_module("metrics_tpu.resilience.guards").__all__


def test_the_engine_is_whole_and_joins_the_top_level():
    """``engine`` exports the JAX package's ten names in its order; ``StreamEngine``, ``ShardedStreamEngine`` and
    ``engine`` join the top level, in the JAX package's order."""
    ref = importlib.import_module("metrics_tpu.engine")
    port = importlib.import_module("metrics_tpu_torch.engine")
    assert port.__all__ == ref.__all__ and len(port.__all__) == 10
    assert metrics_tpu_torch.engine is port
    new = ["ShardedStreamEngine", "StreamEngine", "engine"]
    assert [n for n in metrics_tpu.__all__ if n in new] == [n for n in metrics_tpu_torch.__all__ if n in new] == new
    assert metrics_tpu_torch.StreamEngine is port.StreamEngine
    assert metrics_tpu_torch.ShardedStreamEngine is port.ShardedStreamEngine
    from metrics_tpu_torch.engine import core, durability, sharded, smoke, stream  # noqa: F401
    extra = {"core": {"VmapRefusalError"}}  # the port's refusal type, the counterpart of the JAX tracer errors
    for mod in ("core", "durability", "sharded", "smoke", "stream"):
        ref_names = set(importlib.import_module(f"metrics_tpu.engine.{mod}").__all__)
        assert set(importlib.import_module(f"metrics_tpu_torch.engine.{mod}").__all__) == ref_names | extra.get(
            mod, set()), mod


def test_serve_exports_the_jax_package_s_nineteen_names():
    """``serve`` exports the JAX package's 19 names in its order; like the JAX package's, it is not a name of the
    top level."""
    import metrics_tpu.serve as js
    import metrics_tpu_torch.serve as ts

    assert ts.__all__ == js.__all__ and len(ts.__all__) == 19
    for sub in ("protocol", "admission", "autonomic", "server"):
        ref = importlib.import_module(f"metrics_tpu.serve.{sub}")
        port = importlib.import_module(f"metrics_tpu_torch.serve.{sub}")
        assert port.__all__ == ref.__all__, sub
    assert "serve" not in metrics_tpu.__all__ and "serve" not in metrics_tpu_torch.__all__


def test_models_exports_the_jax_package_s_thirteen_names():
    """``models`` exports the JAX package's 13 names in its order and joins the top level; ``functional`` then
    has every name (``multimodal`` joined it later)."""
    import metrics_tpu.functional as jf
    import metrics_tpu.models as jm
    import metrics_tpu_torch.models as tm

    assert tm.__all__ == jm.__all__ and len(tm.__all__) == 13
    assert metrics_tpu_torch.models is tm and "models" in metrics_tpu_torch.__all__
    assert [n for n in jf.__all__ if n not in metrics_tpu_torch.functional.__all__] == []
    for sub in ("hub", "inception_v3", "lpips_nets", "simple_cnn"):
        importlib.import_module(f"metrics_tpu_torch.models.{sub}")


def test_text_and_multimodal_are_whole_and_the_top_level_lacks_only_aot():
    """``text`` and ``functional.text`` export the JAX package's 16 names each, ``multimodal`` and
    ``functional.multimodal`` its two, in its order; ``multimodal`` joins both top levels in its place, and
    with ``aot`` the top level lacks nothing."""
    import metrics_tpu.functional as jf

    for domain, count in (("text", 16), ("functional.text", 16), ("multimodal", 2), ("functional.multimodal", 2)):
        ref = importlib.import_module(f"metrics_tpu.{domain}")
        port = importlib.import_module(f"metrics_tpu_torch.{domain}")
        assert port.__all__ == ref.__all__ and len(port.__all__) == count, domain
    assert [n for n in metrics_tpu.__all__ if n not in metrics_tpu_torch.__all__] == []
    assert [n for n in metrics_tpu_torch.__all__ if n in metrics_tpu.__all__] == metrics_tpu_torch.__all__
    assert metrics_tpu_torch.multimodal.__name__ == "metrics_tpu_torch.multimodal"
    assert metrics_tpu_torch.functional.__all__ == [n for n in jf.__all__ if n in metrics_tpu_torch.functional.__all__]
    assert set(jf.__all__) <= set(metrics_tpu_torch.functional.__all__)
    from metrics_tpu_torch.functional.text import model_based  # noqa: F401
    from metrics_tpu_torch.observe import costs, overhead, profile

    for mod, ref in ((costs, "costs"), (overhead, "overhead"), (profile, "profile")):
        assert mod.__all__ == importlib.import_module(f"metrics_tpu.observe.{ref}").__all__, ref


# JAX-only names (ROADMAP.md section A, "JAX-only, no counterpart"), each with its reason
JAX_ONLY = {
    # the compiled-update machinery: PyTorch runs eagerly, so there is no shared jit cache to clear and
    # nothing to jit or donate (``jit_update=``/``donate_states=`` are accepted and kept)
    "metrics_tpu.metric": {"clear_jit_cache", "donate_updates_enabled", "jit_update_enabled"},
    # the compiled caches' recorder hooks: no port update compiles, so nothing would call them (the engines
    # report their compiles and hits through ``note_engine_compile``/``note_engine_hit``)
    "metrics_tpu.observe.recorder": {"note_fused_compile", "note_fused_fallback", "note_jit_cache_cleared",
                                     "note_jit_cache_hit", "note_jit_compile", "note_jit_eviction",
                                     "note_replica_compile", "note_replica_hit"},
    # jitted forms of the matching functions: the port's ``match_units``/``batched_box_iou`` are eager
    "metrics_tpu.functional.detection.map_matching": {"match_units_jit", "batched_box_iou_jit"},
    # the Pallas entry points and their planners; their CUDA counterparts are ``binned_counts``/``ssim_window``
    "metrics_tpu.ops": {"ssim_window_pallas", "use_pallas_window"},
    "metrics_tpu.ops.binned_hist": {"binned_counts_pallas", "binned_kernel_plan", "pallas_binned_fits",
                                    "use_pallas_binned"},
    "metrics_tpu.ops.ssim_window": {"ssim_window_pallas", "use_pallas_window"},
    # device meshes: the port's ranks are a torch.distributed group, a subgroup takes a mesh axis's place
    "metrics_tpu.parallel": {"build_mesh", "shard_map_compat"},
    "metrics_tpu.parallel.sync": {"build_mesh", "shard_map_compat"},
    # the per-program AOT dispatcher: no port update traces or compiles a program, so nothing dispatches
    # through a loaded executable (the port's aot is its kernel-library build cache)
    "metrics_tpu.aot": {"AotBinding"},
    "metrics_tpu.aot.runtime": {"AotBinding"},
}

# names of shared modules still to port (ROADMAP.md section A): none — the analysis slice landed the last of
# them; a name the JAX package adds must be ported or listed here
PENDING: dict = {}
# JAX analysis modules with no port module yet: none
PENDING_MODULES: list = []


def _shared_modules():
    import pkgutil

    for info in pkgutil.walk_packages(metrics_tpu.__path__, "metrics_tpu."):
        port = _port_name(info.name)
        try:
            if importlib.util.find_spec(port) is None:
                continue
        except ModuleNotFoundError:
            continue
        yield info.name, port


def test_every_shared_module_has_the_reference_public_names():
    """Every module path in both packages (the top level aside: it lacks ``aot``, above): the JAX module's
    ``__all__``, or else the public names it defines itself, exist in the port's module, but the JAX-only ones."""
    checked, missing = 0, {}
    for ref_name, port_name in _shared_modules():
        ref = importlib.import_module(ref_name)
        port = importlib.import_module(port_name)
        names = list(ref.__all__) if hasattr(ref, "__all__") else [
            n for n, o in vars(ref).items() if not n.startswith("_") and getattr(o, "__module__", None) == ref_name]
        gap = [n for n in names if not hasattr(port, n) and n not in JAX_ONLY.get(ref_name, ())
               and n not in PENDING.get(ref_name, ())]
        if gap:
            missing[ref_name] = gap
        checked += 1
    assert missing == {} and checked > 200


def test_the_pending_analysis_names_are_exactly_the_gap():
    """Every name of ``PENDING`` is still missing from its port module (a ported name must leave the map),
    and the JAX analysis modules with no port module are exactly ``PENDING_MODULES``."""
    for ref_name, names in PENDING.items():
        port = importlib.import_module(_port_name(ref_name))
        ref = importlib.import_module(ref_name)
        assert sorted(n for n in ref.__all__ if not hasattr(port, n)) == sorted(names), ref_name
    import metrics_tpu.analysis as ja

    missing = [info.name for info in __import__("pkgutil").iter_modules(ja.__path__)
               if importlib.util.find_spec(f"metrics_tpu_torch.analysis.{info.name}") is None]
    assert sorted(missing) == PENDING_MODULES
    assert not set(PENDING) & set(JAX_ONLY)
