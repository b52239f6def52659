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
]


def _port_name(module_name: str) -> str:
    return "metrics_tpu_torch" + module_name[len("metrics_tpu"):]


def _domain(ref_module: str, obj) -> str:
    """The JAX package's domain module of an exported object: its package below ``functional`` or the root."""
    parts = obj.__name__.split(".") if isinstance(obj, types.ModuleType) else obj.__module__.split(".")
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

    assert set(metrics_tpu_torch.__all__) < set(metrics_tpu.__all__)


def test_the_regression_domain_and_the_slice_s_wrappers_are_whole():
    """Every class and function of the JAX package's regression domain, and every wrapper but the vmapped replica
    engine and the feature-sharing pair, is ported."""
    import metrics_tpu.functional.regression as jf
    import metrics_tpu.regression as jr
    import metrics_tpu.wrappers as jw
    import metrics_tpu_torch.functional.regression as tf
    import metrics_tpu_torch.regression as tr
    import metrics_tpu_torch.wrappers as tw

    assert tr.__all__ == jr.__all__ and len(tr.__all__) == 20
    assert tf.__all__ == jf.__all__ and len(tf.__all__) == 20
    assert sorted(set(jw.__all__) - set(tw.__all__)) == ["FeatureShare", "NetworkCache", "ReplicatedWrapper"]


def test_image_beyond_the_models_and_segmentation_are_whole():
    """Every image class and function but the model-based ones (FID, KID, IS, MiFID, LPIPS, PPL), and the whole
    segmentation domain, are ported; ``generalized_dice_score`` is also in the classification namespace."""
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

    assert sorted(set(ji.__all__) - set(ti.__all__)) == [
        "FrechetInceptionDistance", "InceptionScore", "KernelInceptionDistance",
        "LearnedPerceptualImagePatchSimilarity", "MemorizationInformedFrechetInceptionDistance",
        "PerceptualPathLength",
    ]
    assert sorted(set(jfi.__all__) - set(tfi.__all__)) == [
        "learned_perceptual_image_patch_similarity", "perceptual_path_length",
    ]
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
