"""The port's Winograd F(2,3)^3 conv (``flypylib_tpu_torch.ops.wino_conv``:
the plain version of K4 and its weight transform) against the JAX
package's ``wino_conv3d_bias_relu`` in interpret mode, on the same inputs.

Tolerances:
- f32: rtol = atol = 1e-4, the JAX package's own test's
  (``tests/test_wino_conv.py``): both sum the tap products in f32, in
  different orders;
- bf16: the port carries the JAX kernel's rounding points (the transform
  rounded to bf16 after each axis, U rounded once, f32 sums), so on the
  same U it stays within one bf16 ulp of it; against the bf16 direct conv,
  the JAX test's 0.05 of the largest output;
- the weight transform: 1e-6 of the largest weight (the port sums in f64
  and rounds once, the JAX einsum sums in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from flypylib_tpu.ops.wino_conv import wino_conv3d_bias_relu as j_wino
from flypylib_tpu.ops.wino_conv import wino_transform_weights as j_transform
from flypylib_tpu_torch.ops import wino_conv as twino
from flypylib_tpu_torch.ops.conv import conv3d_reference

torch.set_num_threads(1)


def _inputs(rng, shape, w_std=0.5, b_std=0.5):
    n, d, h, w, ci, co = shape
    x = rng.normal(0, 1, (n, d, h, w, ci)).astype(np.float32)
    wgt = rng.normal(0, w_std, (3, 3, 3, ci, co)).astype(np.float32)
    b = rng.normal(0, b_std, (co,)).astype(np.float32)
    return x, wgt, b


@pytest.mark.parametrize("shape,block", [
    ((1, 8, 8, 8, 3, 5), (4, 4)),
    ((2, 10, 12, 14, 4, 6), (4, 6)),
    ((1, 18, 16, 20, 8, 16), (8, 8)),
    ((3, 6, 6, 6, 1, 2), (8, 16)),
    ((1, 6, 22, 8, 2, 3), (2, 4)),
])
def test_wino_reference_matches_jax(rng, shape, block):
    x, wgt, b = _inputs(rng, shape)
    u = twino.wino_transform_weights(torch.from_numpy(wgt))
    want = np.asarray(j_wino(jnp.asarray(x), jnp.asarray(u.numpy()),
                             jnp.asarray(b), block=block, interpret=True))
    before = twino.wino_conv3d_bias_relu.launches
    got = twino.wino_conv3d_bias_relu(torch.from_numpy(x), u, torch.from_numpy(b))
    assert twino.wino_conv3d_bias_relu.launches == before  # the plain version
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    direct = conv3d_reference(torch.from_numpy(x), torch.from_numpy(wgt),
                              torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-4, atol=1e-4)


def test_wino_reference_past_128_channels_matches_jax(rng):
    """Ci = 136 into Co = 192: the reference takes any Ci and Co, and so
    does the port (on the card each route runs them in blocks of output
    channels and a K loop; here the plain version).  The sums are 136 x 64
    terms long: the same rtol = atol = 1e-4, at weights scaled to keep the
    outputs at unit size."""
    x, wgt, b = _inputs(rng, (1, 6, 6, 8, 136, 192), w_std=(27 * 136) ** -0.5)
    u = twino.wino_transform_weights(torch.from_numpy(wgt))
    want = np.asarray(j_wino(jnp.asarray(x), jnp.asarray(u.numpy()),
                             jnp.asarray(b), block=(2, 4), interpret=True))
    got = twino.wino_conv3d_bias_relu(torch.from_numpy(x), u, torch.from_numpy(b))
    assert got.shape == want.shape == (1, 4, 4, 6, 192)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    direct = conv3d_reference(torch.from_numpy(x), torch.from_numpy(wgt),
                              torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-4, atol=1e-4)


def test_wino_reference_without_relu(rng):
    x, wgt, _ = _inputs(rng, (1, 8, 8, 8, 4, 4))
    b = np.zeros(4, np.float32)
    u = twino.wino_transform_weights(torch.from_numpy(wgt))
    want = np.asarray(j_wino(jnp.asarray(x), jnp.asarray(u.numpy()),
                             jnp.asarray(b), relu=False, interpret=True))
    got = twino.wino_reference(torch.from_numpy(x), u, torch.from_numpy(b),
                               relu=False)
    assert float(got.min()) < 0  # relu really off
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_wino_reference_bf16(rng):
    x32, wgt, b = _inputs(rng, (1, 12, 12, 12, 8, 8), w_std=0.3, b_std=0.1)
    u = twino.wino_transform_weights(torch.from_numpy(wgt))
    got = twino.wino_reference(torch.from_numpy(x32).bfloat16(), u,
                               torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    want = j_wino(jnp.asarray(x32, jnp.bfloat16), jnp.asarray(u.numpy()),
                  jnp.asarray(b), interpret=True).astype(jnp.float32)
    want = torch.from_numpy(np.array(want))
    err, ok = chip_smoke.conv_check(got, want.bfloat16())
    assert ok, f"max |err| {err}"
    direct = conv3d_reference(torch.from_numpy(x32).bfloat16(),
                              torch.from_numpy(wgt), torch.from_numpy(b)).float()
    scale = float(direct.abs().max())
    assert float((got.float() - direct).abs().max()) < 0.05 * scale


def test_transform_weights_match_jax(rng):
    wgt = rng.normal(0, 0.5, (3, 3, 3, 6, 7)).astype(np.float32)
    got = twino.wino_transform_weights(torch.from_numpy(wgt))
    want = np.asarray(j_transform(jnp.asarray(wgt)))
    assert got.shape == (64, 6, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(wgt).max())


def test_wino_rejects_odd_and_small_extents():
    u, b = torch.zeros((64, 2, 2)), torch.zeros(2)
    with pytest.raises(ValueError, match="even"):
        twino.wino_conv3d_bias_relu(torch.zeros((1, 7, 8, 8, 2)), u, b)
    with pytest.raises(ValueError, match="smaller"):
        twino.wino_conv3d_bias_relu(torch.zeros((1, 2, 8, 8, 2)), u, b)
    with pytest.raises(ValueError, match="u must be"):
        twino.wino_conv3d_bias_relu(torch.zeros((1, 8, 8, 8, 3)), u, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_chip_smoke_wino_check_on_cpu(dtype):
    """chip_smoke's K4 check on the CPU (the wrapper runs the plain version):
    sound passes, a dropped tap and a zeroed channel are refused."""
    from flypylib_tpu_torch.models.zoo import Conv3BiasReLU

    gen = torch.Generator().manual_seed(0)
    conv = Conv3BiasReLU(8, 16, 1)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) / 15)
        conv.bias.copy_(0.1 * torch.randn(16, generator=gen))
    x = torch.relu(torch.randn((2, 10, 12, 14, 8), generator=gen)).to(dtype)
    u = twino.wino_transform_weights(conv.weight.detach())
    r = chip_smoke.wino_readings(x, u, conv.bias.detach())
    assert r["sound"][2] and r["sound"][0] == 0
    assert not r["tap dropped"][2] and not r["channel zeroed"][2]
