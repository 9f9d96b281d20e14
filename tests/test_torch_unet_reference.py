"""The benchmark's plain U-Net reference (``gpubench/archs/unet.py``) against
the port's U-Net on the CPU, in f32 with exact operands.

- ``forward`` against ``FplNetwork("unet", packed=False)`` (the plain
  ``UNetValid``) and against the packed engine (``PackedUNet``, its
  ConvTransposes folded into the decoder's first convs), to 1e-4 of the
  largest |logit| (f32 sums in other orders, ten layers deep);
- a case whose ConvTranspose kernels have one tap each, where the
  reference with ``F.conv_transpose3d``'s orientation (the unflipped
  kernel) lies far outside that tolerance: a flipped tap fails;
- ``reference.volume_logits`` cut into z-slabs on the arch's grid equals
  the monolithic forward bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flypylib_tpu_torch import FplNetwork
from flypylib_tpu_torch.models import zoo
from gpubench import inputs, reference
from gpubench.archs import unet as arch

TOL = 1e-4


def cfg(base: int) -> dict:
    return {"arch": "unet", "base_features": base, "levels": 2,
            "convs_per_stage": 2, "assumed": {"bias_std": 0.05}}


def one_tap(params: dict) -> dict:
    """Each ConvTranspose kernel kept at its tap (0, 0, 0) alone, scaled up
    so that the up path carries the decoder: a kernel whose flip moves
    every output voxel's source."""
    out = dict(params)
    for name, p in params.items():
        if name.startswith("ConvTranspose"):
            k = torch.zeros_like(p["kernel"])
            k[0, 0, 0] = p["kernel"][0, 0, 0] * 8.0
            out[name] = {"kernel": k, "bias": p["bias"]}
    return out


def port_logits(c: dict, params: dict, x: torch.Tensor, packed: bool):
    spec = zoo.unet(base_features=c["base_features"], levels=c["levels"],
                    convs_per_stage=c["convs_per_stage"], dtype=torch.float32)
    net = FplNetwork(spec, device="cpu", packed=packed)
    net.load_flax_params(inputs.flax_variables(params))
    assert net.infer_spec.metadata.get("packed", False) == packed
    with torch.no_grad():
        return net.infer_spec.module(x[..., None])[..., 0]


def rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("weights", ["drawn", "one_tap"])
@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("base,size", [(4, 44), (4, 52), (24, 44), (24, 52)])
def test_reference_matches_the_port(base, size, packed, weights):
    c = cfg(base)
    params = inputs.make_params(c, 17 + base, "cpu")
    if weights == "one_tap":
        params = one_tap(params)
    x = torch.rand((2, size, size, size),
                   generator=torch.Generator().manual_seed(size))
    with torch.no_grad(), reference.exact_f32():
        want = reference.forward(c, params, x[:, None])[:, 0]
    got = port_logits(c, params, x, packed)
    out = size - 2 * arch.context(c)
    assert got.shape == want.shape == (2, out, out, out)
    assert rel_gap(got.numpy(), want.numpy()) < TOL


def test_an_unflipped_convtranspose_fails(monkeypatch):
    """The one-tap case read with ``F.conv_transpose3d``'s own orientation:
    the gap to the port is far outside the tolerance."""
    c = cfg(4)
    params = one_tap(inputs.make_params(c, 21, "cpu"))
    x = torch.rand((1, 52, 52, 52), generator=torch.Generator().manual_seed(2))
    got = port_logits(c, params, x, packed=False)

    def unflipped(x, p, q):
        w = p["kernel"].permute(3, 4, 0, 1, 2)
        return (F.conv_transpose3d(q(x), q(w), stride=2)
                + p["bias"].view(1, -1, 1, 1, 1))

    monkeypatch.setattr(arch, "up", unflipped)
    with torch.no_grad():
        wrong = reference.forward(c, params, x[:, None])[:, 0]
    assert rel_gap(got.numpy(), wrong.numpy()) > 100 * TOL


@pytest.mark.parametrize("slab", [4, 8, 10])
def test_volume_logits_slabs_equal_the_whole(slab):
    """Slabs start on the grid (10 rounds down to 8), so each pools the
    blocks the monolithic forward pools."""
    c = cfg(4)
    assert arch.grid(c) == (4, 0)
    params = inputs.make_params(c, 5, "cpu")
    vol = inputs.blob_volume(24, 3, torch.Generator().manual_seed(8), "cpu")
    whole = reference.volume_logits(c, params, vol, reference.U8_SCALE,
                                    slab=24)
    got = reference.volume_logits(c, params, vol, reference.U8_SCALE,
                                  slab=slab)
    assert torch.equal(got, whole)
