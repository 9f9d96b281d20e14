"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These need an NVIDIA card: each test carries the ``cuda`` marker and skips
without one.  The file imports no jax (the machine with the card has none),
and uses no conftest fixture, so on the card it runs alone as

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances are ``chip_smoke.conv_check``'s: f32 max |err| <= 1e-4 max |ref|,
bf16 one bf16 ulp.  Shapes cover both bf16 gathers of the tensor-core path
(16-byte runs when Ci and Co are multiples of 8 and the data is 16-byte
aligned, single elements otherwise), both tile widths (Co <= 32, Co > 32),
the Ci = 1 kernel and every dilation the wrapper takes.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from flypylib_tpu_torch.ops.conv import conv3d_bias_relu, conv3d_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, ci, co, batch, seed=0):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(0, 1, (batch, *shape, ci)), 0).astype(np.float32)
    w = rng.normal(0, (27 * ci) ** -0.5, (3, 3, 3, ci, co)).astype(np.float32)
    b = rng.normal(0, 0.1, co).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)


def _check(x, w, b, d):
    before = conv3d_bias_relu.launches
    got = conv3d_bias_relu(x, w, b, d)
    torch.cuda.synchronize()
    assert conv3d_bias_relu.launches == before + 1
    ref = conv3d_reference(x, w, b, d)
    assert got.shape == ref.shape and got.dtype == x.dtype
    err, ok = chip_smoke.conv_check(got.cpu(), ref.cpu())
    assert ok, f"max |err| {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ci,co,d", [
    (1, 24, 1), (1, 7, 2),                     # the Ci = 1 kernel
    (24, 32, 1), (32, 48, 2), (48, 64, 2),     # the baseline's layers
    (64, 96, 4), (96, 128, 1),                 # vgg_like widths, Co = 128
    (5, 7, 1), (8, 20, 2), (16, 33, 4),        # Ci or Co not a multiple of 8
])
def test_kernel_matches_plain(cuda, ci, co, d, dtype):
    x, w, b = _inputs((13, 17, 22), ci, co, batch=2)
    _check(x.to(dtype).to(cuda), w.to(cuda), b.to(cuda), d)


def test_unaligned_input_takes_the_element_gather(cuda):
    # a contiguous view 2 bytes past a 16-byte boundary
    x, w, b = _inputs((11, 12, 13), 8, 16, batch=1)
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    flat[1:] = x.reshape(-1).to(cuda, torch.bfloat16)
    xv = flat[1:].view(x.shape)
    assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
    _check(xv, w.to(cuda), b.to(cuda), 1)


def test_empty_batch_and_rejections(cuda):
    x, w, b = _inputs((9, 9, 9), 4, 8, batch=1)
    x, w, b = x.to(cuda), w.to(cuda), b.to(cuda)
    before = conv3d_bias_relu.launches
    assert conv3d_bias_relu(x[:0], w, b).shape == (0, 7, 7, 7, 8)
    assert conv3d_bias_relu.launches == before
    with pytest.raises(TypeError):
        conv3d_bias_relu(x.half(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        conv3d_bias_relu(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="dilation"):
        conv3d_bias_relu(torch.zeros((1, 9, 9, 9, 4), device=cuda), w, b, 3)
    with pytest.raises(ValueError, match="same device"):
        conv3d_bias_relu(x, w.cpu(), b)
    big_w = torch.zeros((3, 3, 3, 4, 129), device=cuda)
    with pytest.raises(ValueError, match="Co"):
        conv3d_bias_relu(x, big_w, torch.zeros(129, device=cuda))
