from flypylib_tpu_torch.ops.conv import conv3d_bias_relu, conv3d_reference
from flypylib_tpu_torch.ops.nms import nms, nms_device, candidate_mask
from flypylib_tpu_torch.ops.components import label_components, components_device

__all__ = [
    "conv3d_bias_relu",
    "conv3d_reference",
    "nms",
    "nms_device",
    "candidate_mask",
    "label_components",
    "components_device",
]
