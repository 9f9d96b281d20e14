from flypylib_tpu_torch.infer.tiled import (
    TiledInference,
    infer_volume,
    tiling_regime,
    default_tiling,
)

__all__ = ["TiledInference", "infer_volume", "tiling_regime", "default_tiling"]
