"""One module per model architecture, found by a configuration's ``"arch"``.

``archs/<arch>.py`` holds everything of the benchmark that depends on the
architecture, each function taking the configuration ``cfg`` first:

- ``param_shapes(cfg)``: ``(name, kernel shape, fan-in)`` of every layer, in
  the JAX package's creation order and names (``Conv_i``,
  ``ConvTranspose_j``; DHWIO kernels);
- ``forward(cfg, params, x, q, logits=True)``: the plain forward of an f32
  ``(N, 1, D, H, W)`` input, ``q`` rounding every conv's and matmul's
  operands (``reference.operand``); with ``logits=False`` the features the
  logits layer reads;
- ``context(cfg)``: the voxels a valid forward loses on each face;
- ``grid(cfg)``: ``(mult, off)``: a valid forward takes an input extent
  ``s`` with ``s % mult == off``, and a volume is cut into slabs whose
  starts are multiples of ``mult`` (``(1, 0)``: any extent, any cut);
  ``reference.volume_logits`` takes only a grid whose output extents,
  ``s - 2 context(cfg)``, are multiples of ``mult``;
- ``train_patch(cfg, patch_size, engine)``: the patch the training engine
  (``"packed"`` or ``"plain"``) samples for ``patch_size``;
- ``layer_macs(cfg, out)``: ``(name, multiply-adds)`` of every layer of one
  monolithic valid forward whose output extent is ``out``, each layer at
  its own resolution, the layer that reads the input first;
- ``flax_name(cfg, name)``: the JAX package's ``Conv_i/kernel`` name of the
  port's parameter ``name``;
- ``logits_layer(cfg)``: the name of the logits layer.

Arch modules import only ``torch``, ``numpy``, ``scipy`` and the reference's
own helpers: nothing of the port, of ``jax`` or of ``flypylib_tpu``.
"""

from __future__ import annotations

import importlib


def of(cfg: dict):
    """The module of ``cfg["arch"]``."""
    return importlib.import_module(f"{__name__}.{cfg['arch']}")
