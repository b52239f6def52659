"""Builder of the Criteo CTR evaluation: its rows from the seed, the port's collection, and its reference.

The rows are the latent-logit click model of the port's smoke script (``criteo_batch``), copied here
so that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from benchlib.cells import load_module


def criteo_rows(g: torch.Generator, n: int, model: Dict[str, float], device: torch.device):
    """(score, click): a CTR model's float32 scores and int64 clicks drawn from a latent logit."""
    z = model["logit_mu"] + model["logit_sd"] * torch.randn(n, generator=g, device=device)
    click = (torch.rand(n, generator=g, device=device) < torch.sigmoid(z)).to(torch.int64)
    score = torch.sigmoid(z + model["score_noise"] * torch.randn(n, generator=g, device=device))
    return score, click


def make_data(config: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    score, click = criteo_rows(g, config["units_per_pass"], config["score_model"], device)
    return {"scores": score, "clicks": click}


def restrict(data: Dict[str, torch.Tensor], start: int, stop: int) -> Dict[str, torch.Tensor]:
    return {k: v[start:stop].clone() for k, v in data.items()}


def take(data: Dict[str, torch.Tensor], start: int, stop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return data["scores"][start:stop], data["clicks"][start:stop]


def data_bytes(data: Dict[str, torch.Tensor]) -> int:
    return sum(v.numel() * v.element_size() for v in data.values())


def make_collection(config: Dict[str, Any], mix: Dict[str, Any], device: torch.device):
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.classification import BinaryAUROC, BinaryAveragePrecision, BinaryCalibrationError

    thresholds = mix["metric_options"]["thresholds"]
    return MetricCollection(
        {
            "auroc": BinaryAUROC(thresholds=thresholds, device=device),
            "ap": BinaryAveragePrecision(thresholds=thresholds, device=device),
            "ece": BinaryCalibrationError(n_bins=config["ece_bins"], norm="l1", device=device),
        },
        compute_groups=config["metrics"]["compute_groups"],
    )


def read_values(result: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in result.items()}


def pass_state(collection, mix: Dict[str, Any]) -> Optional[torch.Tensor]:
    """The binned (T, 2, 2) counts of the pass (the state tensor itself: updates replace it, never change
    it in place, so holding it costs nothing)."""
    if mix["metric_options"]["thresholds"] is None:
        return None
    return collection["auroc"].metric_state["confmat"]


def path(mix: Dict[str, Any]) -> str:
    return "exact" if mix["metric_options"]["thresholds"] is None else "binned"


def reference(config: Dict[str, Any], mix: Dict[str, Any], data: Dict[str, torch.Tensor],
              dtype: torch.dtype = torch.float64) -> Dict[str, Any]:
    evaluate = load_module(Path(__file__).with_name("criteo_ctr_eval_reference.py")).evaluate
    return evaluate(data["scores"], data["clicks"], mix["metric_options"]["thresholds"], config["ece_bins"], dtype)
