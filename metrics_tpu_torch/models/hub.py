"""Local-weights backbone hub: resolve named pretrained models without egress (counterpart of
``metrics_tpu/models/hub.py``).

Nothing is ever downloaded: :func:`load_feature_extractor` resolves a name against a local weights directory
(the ``weights_dir`` argument or the ``METRICS_TPU_WEIGHTS`` environment variable) and returns a ready
function. On-disk forms, read with ``torch.load(weights_only=True)``:

============================  =====================================================
name                          files searched in the weights dir
============================  =====================================================
``inception_v3_fid``          ``pt_inception*.pth`` / ``inception_v3_fid.pth`` / ``inception*.pth``
                              (a torch-fidelity state dict)
``vgg16_lpips`` /             torchvision ``vgg16*.pth`` / ``alexnet*.pth`` / ``squeezenet1_1*.pth`` + LPIPS
``alexnet_lpips`` …           ``lpips_vgg.pth`` / ``lpips_alex.pth`` / ``lpips_squeeze.pth``
``clip-vit-base-patch16`` …   a Hugging Face checkpoint directory of that name (``transformers``' CLIP)
``bert-*`` / ``roberta-*`` …  a Hugging Face checkpoint directory of that name (``transformers``' AutoModel)
============================  =====================================================

The JAX package's flax form (``inception_v3_fid.msgpack``) is not read: this package imports no flax, so a
directory that holds only that form raises ``ModuleNotFoundError`` naming the ``.pth`` form. Every
model-based metric also accepts an injected function, so nothing here is needed to use the metric math.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.models._backbone import DeviceLike, exact_fp32

__all__ = ["load_clip", "load_feature_extractor", "load_lpips", "load_text_encoder", "resolve_weights_dir"]

_INCEPTION_FEATURES = (64, 192, 768, 2048, "logits_unbiased", "logits")


def resolve_weights_dir(weights_dir: Optional[str] = None) -> Optional[str]:
    return weights_dir or os.environ.get("METRICS_TPU_WEIGHTS")


def _missing(name: str, looked_for: str) -> ModuleNotFoundError:
    return ModuleNotFoundError(
        f"Pretrained backbone {name!r} needs local weights ({looked_for}) in the directory given by"
        " `weights_dir` or the METRICS_TPU_WEIGHTS env var. This offline build never downloads;"
        " model-based metrics also accept any injected callable instead."
    )


def _load_torch_sd(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def _find(weights_dir: str, *candidates: str) -> Optional[str]:
    for c in candidates:
        hits = sorted(glob.glob(os.path.join(weights_dir, c)))
        if hits:
            return hits[0]
    return None


def load_feature_extractor(
    name: str, weights_dir: Optional[str] = None, feature: Any = 2048, device: DeviceLike = None
) -> Callable:
    """Resolve a named image backbone into an ``images → features`` function on ``device`` (the card unless
    named)."""
    weights_dir = resolve_weights_dir(weights_dir)
    if name in ("inception_v3_fid", "inception-v3-compat", "inception_v3"):
        from metrics_tpu_torch.models.inception_v3 import convert_torch_state_dict, make_feature_extractor

        if feature not in _INCEPTION_FEATURES:
            raise ValueError(
                f"Integer `feature` must be one of {_INCEPTION_FEATURES} for the FID InceptionV3,"
                f" but got {feature!r}."
            )
        looked_for = "pt_inception*.pth or inception_v3_fid.pth"
        if not weights_dir:
            raise _missing(name, looked_for)
        pth = _find(weights_dir, "pt_inception*.pth", "inception_v3_fid.pth", "inception*.pth")
        if pth:
            from metrics_tpu_torch.metric import resolve_device

            return make_feature_extractor(
                convert_torch_state_dict(_load_torch_sd(pth)), feature, device=resolve_device(device))
        if _find(weights_dir, "inception_v3_fid.msgpack"):
            raise ModuleNotFoundError(
                f"{weights_dir} holds the InceptionV3 weights only in the JAX package's flax form"
                " (inception_v3_fid.msgpack), which metrics_tpu_torch does not read (it imports no flax)."
                f" Put the torch form ({looked_for}: a torch-fidelity state dict) beside it."
            )
        raise _missing(name, looked_for)
    if name in ("vgg16_lpips", "alexnet_lpips", "squeeze_lpips", "vgg", "alex", "squeeze"):
        raise ValueError(
            f"{name!r} is an LPIPS scorer, not an image→features extractor — use"
            " metrics_tpu_torch.models.load_lpips(net_type) instead (its callable takes TWO image batches)."
        )
    if name == "simple_cnn":
        from metrics_tpu_torch.models.simple_cnn import SimpleFeatureCNN

        return SimpleFeatureCNN().bind_apply(device=device)
    raise ValueError(f"Unknown backbone name {name!r}")


def load_lpips(net_type: str, weights_dir: Optional[str] = None, device: DeviceLike = None) -> Callable:
    """Resolve an LPIPS scorer ``(img1, img2, normalize=False) → (N,)`` for vgg/alex/squeeze on ``device``."""
    from metrics_tpu_torch.models.lpips_nets import build_lpips, convert_torch_backbone, convert_torch_lin

    weights_dir = resolve_weights_dir(weights_dir)
    if not weights_dir:
        raise _missing(f"{net_type}_lpips", f"{net_type}*.pth + lpips_{net_type}.pth")
    backbone_name = {"vgg": "vgg16", "alex": "alexnet", "squeeze": "squeezenet1_1"}[net_type]
    backbone_pth = _find(weights_dir, f"{backbone_name}*.pth", f"{net_type}_backbone.pth")
    lin_pth = _find(weights_dir, f"lpips_{net_type}.pth", f"{net_type}_lin.pth", f"{net_type}.pth")
    if not backbone_pth or not lin_pth:
        raise _missing(f"{net_type}_lpips", f"{net_type} backbone .pth + lin .pth")
    variables = convert_torch_backbone(_load_torch_sd(backbone_pth), net_type)
    lin = convert_torch_lin(_load_torch_sd(lin_pth))
    return build_lpips(net_type, variables, lin, device=device)


def _local_checkpoint(model_name_or_path: str, weights_dir: Optional[str], what: str) -> str:
    path = model_name_or_path
    if os.path.isdir(path):
        return path
    weights_dir = resolve_weights_dir(weights_dir)
    candidate = os.path.join(weights_dir, os.path.basename(model_name_or_path)) if weights_dir else None
    if candidate and os.path.isdir(candidate):
        return candidate
    raise _missing(model_name_or_path, what)


def _projected(out: Any, name: str) -> torch.Tensor:
    """The projected embeddings of ``get_image_features``/``get_text_features``: the tensor itself where
    ``transformers`` returns one, else the output's ``name`` or ``pooler_output`` field (a model output)."""
    if isinstance(out, torch.Tensor):
        return out
    for field in (name, "pooler_output"):
        value = getattr(out, field, None)
        if isinstance(value, torch.Tensor):
            return value
    raise TypeError(f"CLIP features of an unknown form: {type(out).__name__}")


def load_clip(
    model_name_or_path: str, weights_dir: Optional[str] = None, device: DeviceLike = None
) -> Tuple[Callable, Callable]:
    """Resolve a local Hugging Face CLIP checkpoint into (image_encoder, text_encoder) functions.

    A LOCAL directory only (``<weights_dir>/<basename>`` or a path), loaded through ``transformers``' torch
    CLIP classes on ``device`` (the card unless named); without ``transformers`` this raises
    ``ModuleNotFoundError``.
    """
    path = _local_checkpoint(model_name_or_path, weights_dir, "a local HF CLIP checkpoint directory")
    from transformers import AutoProcessor, CLIPModel

    from metrics_tpu_torch.metric import resolve_device

    dev = resolve_device(device)
    model = CLIPModel.from_pretrained(path, local_files_only=True).to(dev).eval()
    processor = AutoProcessor.from_pretrained(path, local_files_only=True)

    def image_encoder(images: Any) -> torch.Tensor:
        arr = [np.asarray(i.detach().cpu() if isinstance(i, torch.Tensor) else i) for i in images]
        inputs = processor(images=arr, return_tensors="pt")
        with torch.inference_mode(), exact_fp32():
            return _projected(model.get_image_features(pixel_values=inputs["pixel_values"].to(dev)), "image_embeds")

    def text_encoder(texts: Any) -> torch.Tensor:
        inputs = processor(text=list(texts), return_tensors="pt", padding=True, truncation=True)
        with torch.inference_mode(), exact_fp32():
            return _projected(model.get_text_features(
                input_ids=inputs["input_ids"].to(dev), attention_mask=inputs["attention_mask"].to(dev)), "text_embeds")

    return image_encoder, text_encoder


def load_text_encoder(
    model_name_or_path: str, weights_dir: Optional[str] = None, device: DeviceLike = None
) -> Callable:
    """Resolve a local Hugging Face encoder checkpoint into a ``texts → list[(L_i, D)]`` function.

    The BERTScore default path through ``transformers``' torch AutoModel; each text's embeddings are trimmed
    to its real (non-padding) tokens. Without ``transformers`` this raises ``ModuleNotFoundError``.
    """
    path = _local_checkpoint(model_name_or_path, weights_dir, "a local HF encoder checkpoint directory")
    from transformers import AutoModel, AutoTokenizer

    from metrics_tpu_torch.metric import resolve_device

    dev = resolve_device(device)
    model = AutoModel.from_pretrained(path, local_files_only=True).to(dev).eval()
    tokenizer = AutoTokenizer.from_pretrained(path, local_files_only=True)

    def encoder(texts: Any) -> list:
        batch = tokenizer(list(texts), return_tensors="pt", padding=True, truncation=True)
        with torch.inference_mode(), exact_fp32():
            out = model(**{k: batch[k].to(dev) for k in ("input_ids", "attention_mask")}).last_hidden_state
        mask = batch["attention_mask"].to(torch.bool)
        return [out[i, mask[i].to(dev)] for i in range(out.shape[0])]

    return encoder
