"""flypylib_tpu_torch — the PyTorch/CUDA port of flypylib_tpu.

A second package beside the JAX one (``flypylib_tpu``, which stays the
reference).  It imports torch, numpy and scipy, never jax, flax or
``flypylib_tpu``.  Modules keep the reference's paths and public names;
volumes are (z, y, x), activations NDHWC, conv weights DHWIO.

This slice covers ``FplNetwork("baseline" | "vgg_like").infer / nms /
components / detect``.  The body convolutions run a hand-written CUDA
kernel for Hopper (``csrc/conv3d_bias_relu.cu``, the port of the Pallas
kernel ``ops/pallas_conv.py::conv3d_bias_relu``) on a CUDA device, and its
plain PyTorch version on the CPU.
"""

from flypylib_tpu_torch.network import FplNetwork
from flypylib_tpu_torch.ops.nms import nms
from flypylib_tpu_torch.ops.components import label_components
from flypylib_tpu_torch.io.synapses import Tbars

__version__ = "0.1.0"

__all__ = ["FplNetwork", "nms", "label_components", "Tbars"]
