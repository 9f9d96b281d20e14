"""flypylib_tpu_torch — the PyTorch/CUDA port of flypylib_tpu.

A second package beside the JAX one (``flypylib_tpu``, which stays the
reference).  It imports torch, numpy and scipy, never jax, flax or
``flypylib_tpu``.  Modules keep the reference's paths and public names;
volumes are (z, y, x), activations NDHWC, conv weights DHWIO.

It covers ``FplNetwork("baseline" | "vgg_like" | "unet").train / infer /
nms / components / detect / detect_large / evaluate / evaluate_voxels /
save / restore``, each model through its packed engine by default, as in
the reference, or plain with ``packed=False``, BatchNorm stacks
(``ConvStack(use_batchnorm=True)``) included; Keras HDF5 weights
(``io/keras_import.py``), HDF5 volumes, DVID and resumable multi-ROI
streaming (``infer/roi_queue.py``, ``infer/elastic.py``), and the
multi-device layer (``parallel/``: meshes of device slots, volume-sharded
infer / NMS / CC with halo exchange, data-parallel training, the
``detect_large(devices=)`` fan-out).  Every Pallas kernel of
the reference has a hand-written CUDA counterpart for Hopper under
``csrc/`` (K1 ``conv3d_bias_relu``, K2/K3 ``packed_tail``, K4
``wino_conv``, K5 ``parity_split``), launched on a CUDA device; on the CPU
each wrapper runs its plain PyTorch version.
"""

from flypylib_tpu_torch.network import FplNetwork
from flypylib_tpu_torch.ops.nms import nms
from flypylib_tpu_torch.ops.components import label_components
from flypylib_tpu_torch.ops.matching import (
    evaluate,
    obj_pr,
    obj_pr_curve,
    voxel_pr,
    voxel_pr_device,
    voxel_pr_streaming,
)
from flypylib_tpu_torch.io.synapses import (
    Tbars,
    load_from_json,
    save_to_json,
    tbars_to_volume,
)
from flypylib_tpu_torch.parallel import (
    ShardedMap,
    batch_sharded,
    ensure_initialized,
    local_batch_size,
    make_dp_train_step,
    make_mesh,
    make_mesh_2d,
    make_mesh_3d,
    replicated,
    sharded_components,
    sharded_infer,
    sharded_nms,
)

# flypylib's name for the NMS verb, as the reference exports it
obj_candidates = nms

__version__ = "0.1.0"

__all__ = [
    "FplNetwork",
    "nms",
    "obj_candidates",
    "label_components",
    "evaluate",
    "obj_pr",
    "obj_pr_curve",
    "voxel_pr",
    "voxel_pr_device",
    "voxel_pr_streaming",
    "Tbars",
    "load_from_json",
    "save_to_json",
    "tbars_to_volume",
    "ShardedMap",
    "batch_sharded",
    "ensure_initialized",
    "local_batch_size",
    "make_dp_train_step",
    "make_mesh",
    "make_mesh_2d",
    "make_mesh_3d",
    "replicated",
    "sharded_components",
    "sharded_infer",
    "sharded_nms",
]
