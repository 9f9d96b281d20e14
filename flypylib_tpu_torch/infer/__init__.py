from flypylib_tpu_torch.infer.tiled import (
    TiledInference,
    infer_volume,
    tiling_regime,
    default_tiling,
    grid_tiling_min_cost,
)
from flypylib_tpu_torch.infer.pipeline import DetectPipeline
from flypylib_tpu_torch.infer.roi_queue import (
    ROI,
    ROIQueue,
    grid_rois,
    stream_rois,
    dvid_source,
    dvid_sink,
)
from flypylib_tpu_torch.infer.large import (
    array_reader,
    detect_h5,
    detect_staged,
    detect_streaming,
    dvid_reader,
    h5_reader,
    make_stream_plan,
    stage_volume,
    stage_volume_chunked,
)

__all__ = [
    "TiledInference",
    "infer_volume",
    "tiling_regime",
    "default_tiling",
    "grid_tiling_min_cost",
    "DetectPipeline",
    "ROI",
    "ROIQueue",
    "grid_rois",
    "stream_rois",
    "dvid_source",
    "dvid_sink",
    "array_reader",
    "detect_h5",
    "detect_staged",
    "detect_streaming",
    "dvid_reader",
    "h5_reader",
    "make_stream_plan",
    "stage_volume",
    "stage_volume_chunked",
]
