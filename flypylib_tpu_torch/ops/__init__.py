from flypylib_tpu_torch.ops.conv import conv3d_bias_relu, conv3d_reference
from flypylib_tpu_torch.ops.nms import nms, nms_device, candidate_mask
from flypylib_tpu_torch.ops.components import label_components, components_device
from flypylib_tpu_torch.ops.tail import (packed_tail, packed_tail2, tail_reference,
                                         tail2_reference)
from flypylib_tpu_torch.ops.matching import (
    evaluate,
    match_detections,
    obj_pr,
    obj_pr_curve,
    voxel_pr,
)
from flypylib_tpu_torch.ops.augment import augment_patch, AUGMENT_GROUP_SIZE

__all__ = [
    "conv3d_bias_relu",
    "conv3d_reference",
    "nms",
    "nms_device",
    "candidate_mask",
    "label_components",
    "components_device",
    "packed_tail",
    "packed_tail2",
    "tail_reference",
    "tail2_reference",
    "evaluate",
    "match_detections",
    "obj_pr",
    "obj_pr_curve",
    "voxel_pr",
    "augment_patch",
    "AUGMENT_GROUP_SIZE",
]
