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
streaming (``infer/roi_queue.py``, ``infer/elastic.py``).  Every Pallas kernel of
the reference has a hand-written CUDA counterpart for Hopper under
``csrc/`` (K1 ``conv3d_bias_relu``, K2/K3 ``packed_tail``, K4
``wino_conv``, K5 ``parity_split``), launched on a CUDA device; on the CPU
each wrapper runs its plain PyTorch version.
"""

from flypylib_tpu_torch.network import FplNetwork
from flypylib_tpu_torch.ops.nms import nms
from flypylib_tpu_torch.ops.components import label_components
from flypylib_tpu_torch.io.synapses import Tbars

__version__ = "0.1.0"

__all__ = ["FplNetwork", "nms", "label_components", "Tbars"]
