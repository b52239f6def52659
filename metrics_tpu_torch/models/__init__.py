"""Model backbones for model-based metrics, local weights only (counterpart of ``metrics_tpu/models``).

Every backbone is an ``nn.Module`` whose parameter names are torch-fidelity's,
torchvision's or LPIPS's own, and a zero-egress loader hub resolves them:

* :class:`InceptionV3FID`: the full FID InceptionV3 (taps 64/192/768/2048/logits)
  for FID/KID/IS/MiFID, with the torch-fidelity state-dict converter;
* :class:`VGG16Features` / :class:`AlexNetFeatures` (and SqueezeNet) + the LPIPS heads;
* Hugging Face CLIP / text encoders (``transformers``' torch classes) resolved
  from local checkpoint directories;
* :func:`load_feature_extractor` / :func:`load_lpips` / :func:`load_clip` /
  :func:`load_text_encoder`: the local-weights resolution layer.

Each module also carries the JAX package's flax variables across
(``from_flax_variables``), for the tests that hold the two forwards together.

Every model-based metric also accepts injected callables, so the metric math is
usable with any user model.
"""

from metrics_tpu_torch.models.hub import (
    load_clip,
    load_feature_extractor,
    load_lpips,
    load_text_encoder,
)
from metrics_tpu_torch.models.inception_v3 import (
    InceptionV3FID,
    convert_torch_state_dict,
    init_inception_params,
    make_feature_extractor,
)
from metrics_tpu_torch.models.lpips_nets import (
    AlexNetFeatures,
    VGG16Features,
    build_lpips,
    init_lpips,
)
from metrics_tpu_torch.models.simple_cnn import SimpleFeatureCNN

__all__ = [
    "AlexNetFeatures",
    "InceptionV3FID",
    "SimpleFeatureCNN",
    "VGG16Features",
    "build_lpips",
    "convert_torch_state_dict",
    "init_inception_params",
    "init_lpips",
    "load_clip",
    "load_feature_extractor",
    "load_lpips",
    "load_text_encoder",
    "make_feature_extractor",
]
