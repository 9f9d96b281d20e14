"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These need an NVIDIA card: each test carries the ``cuda`` marker and skips
without one.  The file imports no jax (the machine with the card has none),
and uses no conftest fixture, so on the card it runs alone as

    python -m pytest --noconftest -q tests/test_torch_cuda.py

K1's tolerances are ``chip_smoke.conv_check``'s: f32 max |err| <= 1e-4
max |ref|, bf16 one bf16 ulp.  Shapes cover both bf16 gathers of the
tensor-core path (16-byte runs when Ci and Co are multiples of 8 and the
data is 16-byte aligned, single elements otherwise), both tile widths
(Co <= 32, Co > 32), the Ci = 1 kernel and every dilation the wrapper takes.

K2 and K3 (``packed_tail``, ``packed_tail2``) are held by
``chip_smoke.tail_check``: f32 1e-4 max |ref|; bf16 one ulp at each of a
stage's two rounding points for single stages, rtol = atol = 2e-2 for
chains.  Cases cover the main path's widths (Ci 240, or 192 + 48, into
192), one and two stages, with and without logits, both dtypes, batch 2,
channel counts off the multiples of 8 (the element gather) and Co <= 32.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from flypylib_tpu_torch.ops import tail
from flypylib_tpu_torch.ops.conv import (conv3d_bias_relu, conv3d_f32,
                                         conv3d_reference)

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


TAIL_CASES = {
    # label: (ca, cb, co, stages after the first, logits)
    "K2-240-192": (240, 0, 192, 0, False),
    "K2-240-192-192-logits": (240, 0, 192, 1, True),
    "K2-240-192-192": (240, 0, 192, 1, False),
    "K3-192+48-192": (192, 48, 192, 0, False),
    "K3-192+48-192-192-logits": (192, 48, 192, 1, True),
    "K3-20+12-40-logits": (20, 12, 40, 1, True),   # the element gather
    "K2-16-24-24-logits": (16, 0, 24, 1, True),    # Co <= 32
}


def _tail_args(ca, cb, co, n_after, logits, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    shape = (2, 9, 10, 11)  # batch 2
    xa = t(np.maximum(rng.normal(0, 1, (*shape, ca)), 0)).to(dtype)
    xb = t(np.maximum(rng.normal(0, 1, (*shape, cb)), 0)).to(dtype)
    k = 8 * (ca + cb)
    stage0 = (t(rng.normal(0, k ** -0.5, (2, 2, 2, ca, co))),
              t(rng.normal(0, k ** -0.5, (2, 2, 2, cb, co))),
              t(rng.normal(0, 0.1, co)))
    stages = [(t(rng.normal(0, (8 * co) ** -0.5, (2, 2, 2, co, co))),
               t(rng.normal(0, 0.1, co))) for _ in range(n_after)]
    lg = None
    if logits:
        lg = (t(rng.normal(0, co ** -0.5, (co, 16))), t(rng.normal(0, 1, 8)))
    return xa, xb, stage0, stages, lg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(TAIL_CASES))
def test_tail_kernels_match_plain(cuda, case, dtype):
    ca, cb, co, n_after, logits = TAIL_CASES[case]
    xa, xb, (wa, wb, b0), stages, lg = _tail_args(ca, cb, co, n_after, logits,
                                                 dtype, cuda)
    if cb:
        before = tail.packed_tail2.launches
        got = tail.packed_tail2(xa, xb, (wa, wb, b0), stages, lg)
        torch.cuda.synchronize()
        assert tail.packed_tail2.launches == before + 1
        ref = tail.tail2_reference(xa, xb, (wa, wb, b0), stages, lg)
        pre = conv3d_f32(xa, wa.to(dtype)) + conv3d_f32(xb, wb.to(dtype))
    else:
        before = tail.packed_tail.launches
        got = tail.packed_tail(xa, [(wa, b0)] + stages, lg)
        torch.cuda.synchronize()
        assert tail.packed_tail.launches == before + 1
        ref = tail.tail_reference(xa, [(wa, b0)] + stages, lg)
        pre = conv3d_f32(xa, wa.to(dtype))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    single = not stages and lg is None
    err, ok = chip_smoke.tail_check(got.cpu(), ref.cpu(), dtype,
                                    pre.to(dtype).cpu() if single else None)
    assert ok, f"max |err| {err}"


def test_tail_kernels_empty_batch_and_rejections(cuda):
    xa, xb, s0, stages, lg = _tail_args(8, 8, 16, 1, True, torch.float32, cuda)
    before = (tail.packed_tail.launches, tail.packed_tail2.launches)
    assert tail.packed_tail2(xa[:0], xb[:0], s0, stages, lg).shape == (
        0, 7, 8, 9, 8)
    assert tail.packed_tail(xa[:0], [(s0[0], s0[2])]).shape == (0, 8, 9, 10, 16)
    assert (tail.packed_tail.launches, tail.packed_tail2.launches) == before
    with pytest.raises(TypeError):
        tail.packed_tail(xa.half(), [(s0[0], s0[2])])
    with pytest.raises(ValueError, match="contiguous"):
        tail.packed_tail(xa.transpose(1, 2), [(s0[0], s0[2])])
    with pytest.raises(ValueError, match="same device"):
        tail.packed_tail(xa, [(s0[0].cpu(), s0[2])])
    with pytest.raises(TypeError, match="dtype"):
        tail.packed_tail2(xa, xb.bfloat16(), s0)


@pytest.mark.parametrize("tail_impl", ["pallas", "pallas_fold", "pallas2",
                                       "pallas_fold2"])
def test_packed_unet_kernel_tails_match_the_cpu(cuda, tail_impl):
    """The packed U-Net with a kernel tail, batch 2, f32: the card against
    the CPU's plain versions (f32 summation order only)."""
    from flypylib_tpu_torch.models.zoo import unet
    from flypylib_tpu_torch.ops.packed_unet import packed_unet_spec

    spec = packed_unet_spec(unet(base_features=8, dtype=torch.float32),
                            tail_impl=tail_impl)
    x = np.random.default_rng(0).random((2, 52, 52, 52, 1)).astype(np.float32)
    with torch.no_grad():
        want = spec.module(torch.from_numpy(x))
        name = "packed_tail2" if tail_impl.endswith("2") else "packed_tail"
        before = getattr(tail, name).launches
        got = spec.module.to(cuda)(torch.from_numpy(x).to(cuda))
        torch.cuda.synchronize()
    assert getattr(tail, name).launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
