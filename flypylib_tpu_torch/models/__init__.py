from flypylib_tpu_torch.models.zoo import (
    ModelSpec,
    ConvStack,
    UNetValid,
    baseline_model,
    vgg_like,
    unet,
    params_from_flax,
    MODEL_ZOO,
)

__all__ = [
    "ModelSpec",
    "ConvStack",
    "UNetValid",
    "baseline_model",
    "vgg_like",
    "unet",
    "params_from_flax",
    "MODEL_ZOO",
]
