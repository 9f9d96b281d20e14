from flypylib_tpu_torch.models.zoo import (
    ModelSpec,
    ConvStack,
    UNetValid,
    baseline_model,
    vgg_like,
    unet,
    BatchNorm,
    params_from_flax,
    flax_from_params,
    MODEL_ZOO,
)

__all__ = [
    "ModelSpec",
    "ConvStack",
    "UNetValid",
    "baseline_model",
    "vgg_like",
    "unet",
    "BatchNorm",
    "params_from_flax",
    "flax_from_params",
    "MODEL_ZOO",
]
