from flypylib_tpu_torch.models.zoo import (
    ModelSpec,
    ConvStack,
    baseline_model,
    vgg_like,
    params_from_flax,
    MODEL_ZOO,
)

__all__ = [
    "ModelSpec",
    "ConvStack",
    "baseline_model",
    "vgg_like",
    "params_from_flax",
    "MODEL_ZOO",
]
