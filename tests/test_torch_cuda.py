"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These need an NVIDIA card: each test carries the ``cuda`` marker and skips
without one.  The file imports no jax (the machine with the card has none),
and uses no conftest fixture, so on the card it runs alone as

    python -m pytest --noconftest -q tests/test_torch_cuda.py

K1's tolerances are ``chip_smoke.conv_check``'s: f32 max |err| <= 1e-4
max |ref|, bf16 one bf16 ulp.  Every case asserts the route ``k1_route``
names and that its count rose by one.  The bf16 calls with Ci and Co
multiples of 8 and a 16-byte-aligned input take the wgmma/TMA kernel: the
main path's widths at every dilation, Ci = 96 into Co = 96 and 128, the
16-channel last slice (Ci % 32 <= 16), ragged extents and batch 2.  The
f32 calls with Ci a multiple of 4, a 16-byte-aligned input and d <= 7 take
the f32 kernel ("simt"): d = 1-5, Co = 8 to 264 in one to five channel
blocks, ``relu=False``, a zeroed tap that must fail, two launches bit for
bit and sub-windows bit for bit the full output's overlap.  The
others pin the old kernels: the element gather of the WMMA kernel (widths
off the multiples of 8, an input 2 bytes off a 16-byte boundary), both its
tile widths, the f32 FMA kernel (Ci off the multiples of 4, an input 4
bytes off a 16-byte boundary) and the Ci = 1 kernel (d = 1, 2, 3 and a
dilation whose halo it cannot stage; Co = 7, 24, 32, 129, 136, 192; a box
wider than the rows; a zeroed tap that must fail).  Every route takes any
dilation and any Co, as the reference does: cases at d = 3 and at Co = 136,
192 and 264 run on each.

K5 (``parity_split_kernel``) is a copy: bitwise equal to its plain
version, at every unit width the kernel picks (16-byte runs down to 2-byte
elements).  K4 (``wino_conv3d_bias_relu``) is held against its plain version,
``wino_reference``, which carries the same rounding points: f32 rtol = atol
= 1e-4 (the JAX package's own test's), bf16 ``chip_smoke.wino_check``.
Every case asserts the route ``wino_route`` names: bf16 with Ci and Co
multiples of 8 takes the wgmma/TMA kernel (``chip_smoke``'s small cases run
here too: ragged tiles, Ci = 24, a 16-channel rest, Ci = Co = 136), the
others pin the kernels of ``wino_conv.cu``: both WMMA row tilings (16 and
32 rows), the ReLU off, channels off the multiples of 16, several x-chunks
per row, f32.  Every route takes any Ci and Co, as the reference does: Ci =
136 into Co = 129 and 192 run on each.  A dropped tap and a zeroed channel
must fail the check.

K2 and K3 (``packed_tail``, ``packed_tail2``) are held by
``chip_smoke.tail_check``: f32 1e-4 max |ref|; bf16 one ulp at each of a
stage's two rounding points for single stages, rtol = atol = 2e-2 for
chains.  Cases cover the main path's widths (Ci 240, or 192 + 48, into
192), one and two stages, with and without logits, both dtypes, batch 2,
channel counts off the multiples of 8 (the element gather) and Co <= 32.
Every case asserts the route of its stages (``tail_route``): bf16 with
channel counts in multiples of 8 takes the wgmma/TMA kernel, whose last
stage computes the logits in its epilogue; f32 with Ca and Cb multiples of
4 and aligned operands takes the f32 kernel of ``conv3d_f32.cu`` ("simt"),
and off that rule (channels, a view 4 bytes off a 16-byte boundary) the
first-version FMA kernel; the f32 kernel gives the same bits in a second
launch and on sub-windows, and a zeroed tap fails the check.
``chip_smoke``'s small cases (ragged boxes, odd extents, a 16-channel
rest, batch 3, more logits than the epilogue takes, f32 in one to six
channel blocks) run here too.

The staged engine (``FplNetwork.detect_large``) runs on the card in roi and
shared modes, and its lists must equal ``detect``'s on the scaled volume at
the same tiling, exactly (the map is the same function of the same
values).

K1 with ``relu=False`` (a BatchNorm layer's conv) runs on every route
against ``conv3d_reference(relu=False)`` under the same limits, and an
output clamped anyway must fail them.  A BatchNorm ``ConvStack`` (f32,
plain and packed) on the card matches the CPU's to 1e-4, and
``TiledInference.infer(host_stream=True)`` gives the device sweep's map bit
for bit (tile batch 1, many batches; f32 and uint8).

The packed engines' conv + bias + ReLU at inference (``packed_conv_relu``
on a bf16 card tensor without grad) is one launch of K2's wgmma stage
kernel (``stage_bias_relu``), Co past 192 in output-channel slices: at the
baseline's stage-A layers (batch 16) and the U-Net's eight widths it is
within ``chip_smoke.tail_check``'s one-stage limit of the library path
(cuDNN rounded to bf16, then ``_epilogue``) and exactly 0 where that
path's pre-activation lies below a rounding; its output on sub-windows and
on part of the batch is bit for bit the whole call's overlap; the tracer
counts ``packed_conv_fused`` 8 a U-Net forward and 2 a baseline forward;
``torch.profiler`` counts its kernel's and K5's device time in the ranges
open around the call (their launches are the operators
``fpl::stage_bias_relu`` and ``fpl::parity_split``).

The packed engine's convs under grad (``PackedConv``): at the b32 step's
three convs with an input gradient, that gradient (a forward conv) is
within one bf16 rounding of an f32 ``conv3d_input``, and a profiled default
step launches no cuDNN grouped direct kernel.

The multi-device layer on repeated cuda:0 slots: ``sharded_infer`` over
1-, 2- and 3-D meshes gives ``TiledInference``'s map bit for bit where the
tile grids coincide, with the host reference's lists from the sharded
NMS and CC; ``detect_large(devices=)`` staged and streamed gives the
single-device lists bit for bit.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from flypylib_tpu_torch.ops import tail
from flypylib_tpu_torch.ops import wino_conv as wino
from flypylib_tpu_torch.ops.split import (parity_split_kernel,
                                          parity_split_reference)
from flypylib_tpu_torch.ops.conv import (conv3d_bias_relu, conv3d_f32,
                                         conv3d_reference, k1_route)

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


def _route(x, ci, co, d=1):
    """The route the rule of ``k1_route`` gives, written out."""
    if ci == 1:
        return "ci1"
    if x.dtype == torch.float32:
        on_rule = ci % 4 == 0 and x.data_ptr() % 16 == 0 and d <= 7
        return "simt" if on_rule else "fma"
    aligned = ci % 8 == 0 and co % 8 == 0 and x.data_ptr() % 16 == 0
    return "wgmma" if aligned else "wmma"


def _check(x, w, b, d, relu=True):
    route = _route(x, x.shape[-1], w.shape[-1], d)
    assert k1_route(x, w, d) == route
    before = conv3d_bias_relu.launches
    routes = dict(conv3d_bias_relu.routes)
    got = conv3d_bias_relu(x, w, b, d, relu)
    torch.cuda.synchronize()
    assert conv3d_bias_relu.launches == before + 1
    routes[route] += 1
    assert conv3d_bias_relu.routes == routes
    ref = conv3d_reference(x, w, b, d, relu)
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


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("ci,co", [(24, 32), (32, 48), (48, 64), (64, 96)])
def test_wgmma_route_main_path_widths(cuda, ci, co, d):
    x, w, b = _inputs((12, 14, 19), ci, co, batch=1)
    _check(x.to(torch.bfloat16).to(cuda), w.to(cuda), b.to(cuda), d)


@pytest.mark.parametrize("shape,batch,ci,co,d", [
    ((13, 17, 22), 2, 96, 96, 1),     # three 32-channel slices
    ((13, 17, 22), 1, 96, 128, 2),    # the widest N tile
    ((15, 14, 21), 2, 48, 48, 4),     # 16-channel last slice, ragged boxes
    ((11, 12, 30), 2, 16, 24, 1),     # only a 16-channel slice, Co = 24
    ((13, 17, 22), 1, 40, 56, 2),     # Co between the N tiles: masked columns
    ((75, 9, 10), 1, 32, 32, 1),      # an output box taller than wide
])
def test_wgmma_route_other_widths_and_extents(cuda, shape, batch, ci, co, d):
    x, w, b = _inputs(shape, ci, co, batch=batch)
    _check(x.to(torch.bfloat16).to(cuda), w.to(cuda), b.to(cuda), d)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no-relu"])
@pytest.mark.parametrize("co", [8, 24, 48, 64, 96, 136])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_simt_route_dilations_and_widths(cuda, d, co, relu):
    """The f32 kernel at d = 1-4 and Co in one to three channel blocks
    (136 = 48 + 48 + 40), ragged boxes, batch 2, with and without ReLU."""
    x, w, b = _inputs((11 + 2 * d, 10 + 2 * d, 13 + 2 * d), 12, co, batch=2,
                      seed=d * co)
    _check(x.to(cuda), w.to(cuda), b.to(cuda), d, relu)


def test_simt_is_deterministic_and_blind_to_the_window(cuda):
    """Two launches give the same bits, and the output of a sub-window of
    the input (another box grid, every voxel at another place in its box)
    is bit for bit the overlap of the full output."""
    x, w, b = _inputs((30, 29, 41), 32, 48, batch=2)
    x, w, b = x.to(cuda), w.to(cuda), b.to(cuda)
    full = conv3d_bias_relu(x, w, b, 2)
    assert torch.equal(conv3d_bias_relu(x, w, b, 2), full)
    for z, y, xx in ((3, 5, 7), (1, 0, 9), (6, 2, 0)):
        sub = x[:, z:, y:, xx:].contiguous()
        part = conv3d_bias_relu(sub, w, b, 2)
        assert k1_route(sub, w, 2) == "simt"
        assert torch.equal(part, full[:, z:, y:, xx:])


def test_simt_zeroed_tap_fails_the_check(cuda):
    x, w, b = _inputs((13, 17, 22), 24, 32, batch=2)
    x, w, b = x.to(cuda), w.to(cuda), b.to(cuda)
    ref = conv3d_reference(x, w, b, 1)
    w[1, 1, 1] = 0
    got = conv3d_bias_relu(x, w, b, 1)
    assert k1_route(x, w) == "simt"
    assert not chip_smoke.conv_check(got.cpu(), ref.cpu())[1]


def test_f32_off_the_rule_takes_the_fma_kernel(cuda):
    # a contiguous view 4 bytes past a 16-byte boundary, and Ci = 6
    x, w, b = _inputs((11, 12, 13), 8, 16, batch=1)
    flat = torch.zeros(x.numel() + 1, dtype=torch.float32, device=cuda)
    flat[1:] = x.reshape(-1).to(cuda)
    xv = flat[1:].view(x.shape)
    assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
    _check(xv, w.to(cuda), b.to(cuda), 1)
    x, w, b = _inputs((11, 12, 13), 6, 16, batch=2)
    _check(x.to(cuda), w.to(cuda), b.to(cuda), 2)


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
        conv3d_bias_relu(x, w, b, 0)
    with pytest.raises(ValueError, match="same device"):
        conv3d_bias_relu(x, w.cpu(), b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ci,co,d", [
    (32, 48, 3), (24, 32, 5),       # dilations outside {1, 2, 4}
    (96, 192, 1), (64, 136, 2),     # Co past 128: two N blocks (96 + 96, 72 + 64)
    (32, 264, 3),                   # three N blocks of 88
    (1, 192, 3), (1, 129, 1),       # the Ci = 1 kernel in two launches
    (12, 136, 3), (5, 200, 1),      # off the multiples of 8: N blocks of the
])                                  # WMMA (bf16) and f32 (simt, fma) kernels
def test_any_dilation_and_any_co(cuda, ci, co, d, dtype):
    x, w, b = _inputs((15, 16, 21), ci, co, batch=2)
    _check(x.to(dtype).to(cuda), w.to(cuda), b.to(cuda), d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,co,d", [
    ((9, 40, 41), 32, 1),     # chunks of 16 channels, a box of whole rows
    ((15, 16, 70), 136, 2),   # two launches: 128 + 8 channels
    ((13, 17, 22), 48, 3),    # two chunks of 24
    ((45, 46, 47), 24, 20),   # a halo past shared memory: read through L1
])
def test_ci1_kernel_boxes_chunks_and_dilations(cuda, shape, co, d, dtype):
    x, w, b = _inputs(shape, 1, co, batch=2)
    _check(x.to(dtype).to(cuda), w.to(cuda), b.to(cuda), d)


def test_ci1_kernel_zeroed_tap_fails_the_check(cuda):
    x, w, b = _inputs((13, 17, 22), 1, 24, batch=2)
    x, w, b = x.bfloat16().to(cuda), w.to(cuda), b.to(cuda)
    ref = conv3d_reference(x, w, b, 1)
    w[1, 1, 1] = 0
    _, ok = chip_smoke.conv_check(conv3d_bias_relu(x, w, b, 1).cpu(), ref.cpu())
    assert not ok


@pytest.mark.parametrize("make", [
    lambda zoo: zoo.baseline_model(dilations=(1, 1, 3, 3), dtype=torch.float32),
    lambda zoo: zoo.unet(levels=3, dtype=torch.float32),  # bottleneck Co 192
], ids=["baseline-d3", "unet-levels3"])
def test_models_past_the_old_caps_match_the_cpu(cuda, make):
    """A baseline at dilation 3 (no packed engine takes it) and the plain
    three-level U-Net, f32, on the card against the CPU's plain versions."""
    from flypylib_tpu_torch.models import zoo

    spec = make(zoo)
    s = spec.valid_size(spec.min_size + 4)
    x = np.random.default_rng(0).random((1, s, s, s, 1)).astype(np.float32)
    with torch.no_grad():
        want = spec.module(torch.from_numpy(x))
        before = conv3d_bias_relu.launches
        got = spec.module.to(cuda)(torch.from_numpy(x).to(cuda))
        torch.cuda.synchronize()
    assert conv3d_bias_relu.launches == before + len(spec.module.convs)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


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


def _tail_route(dtype, ca, cb, co):
    """The route the rule of ``tail_route`` gives aligned operands, written
    out."""
    if dtype == torch.float32:
        return "simt" if ca % 4 == 0 and cb % 4 == 0 else "fma"
    on_rule = ca % 8 == 0 and cb % 8 == 0 and co % 8 == 0 and co <= 192
    return "wgmma" if on_rule else "wmma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(TAIL_CASES))
def test_tail_kernels_match_plain(cuda, case, dtype):
    ca, cb, co, n_after, logits = TAIL_CASES[case]
    xa, xb, (wa, wb, b0), stages, lg = _tail_args(ca, cb, co, n_after, logits,
                                                 dtype, cuda)
    route = _tail_route(dtype, ca, cb, co)
    assert tail.tail_route(xa, xb if cb else None, wa) == route
    wrapper = tail.packed_tail2 if cb else tail.packed_tail
    before = wrapper.launches
    routes = dict(wrapper.routes)
    if cb:
        got = tail.packed_tail2(xa, xb, (wa, wb, b0), stages, lg)
        ref = tail.tail2_reference(xa, xb, (wa, wb, b0), stages, lg)
        pre = conv3d_f32(xa, wa.to(dtype)) + conv3d_f32(xb, wb.to(dtype))
    else:
        got = tail.packed_tail(xa, [(wa, b0)] + stages, lg)
        ref = tail.tail_reference(xa, [(wa, b0)] + stages, lg)
        pre = conv3d_f32(xa, wa.to(dtype))
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    routes[route] += 1  # one count per stage launched, each by its widths
    routes[_tail_route(dtype, co, 0, co)] += n_after
    assert wrapper.routes == routes
    assert got.shape == ref.shape and got.dtype == ref.dtype
    single = not stages and lg is None
    err, ok = chip_smoke.tail_check(got.cpu(), ref.cpu(), dtype,
                                    pre.to(dtype).cpu() if single else None)
    assert ok, f"max |err| {err}"


def test_tail_small_cases_of_the_smoke_run(cuda):
    """``chip_smoke``'s small K2 / K3 cases, each on the route it names."""
    chip_smoke.check_tail_small("test")


def test_tail_unaligned_operand_takes_the_wmma_kernel(cuda):
    # xb a contiguous view 2 bytes past a 16-byte boundary
    xa, xb, s0, stages, lg = _tail_args(16, 8, 24, 1, True, torch.bfloat16, cuda)
    flat = torch.zeros(xb.numel() + 1, dtype=torch.bfloat16, device=cuda)
    flat[1:] = xb.reshape(-1)
    off = flat[1:].view(xb.shape)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    assert tail.tail_route(xa, off, s0[0]) == "wmma"
    assert tail.tail_route(xa, xb, s0[0]) == "wgmma"
    routes = dict(tail.packed_tail2.routes)
    got = tail.packed_tail2(xa, off, s0, stages, lg)
    torch.cuda.synchronize()
    routes["wmma"] += 1   # stage 0; the next stage's input is aligned again
    routes["wgmma"] += 1
    assert tail.packed_tail2.routes == routes
    ref = tail.tail2_reference(xa, xb, s0, stages, lg)
    err, ok = chip_smoke.tail_check(got.cpu(), ref.cpu(), torch.bfloat16)
    assert ok, f"max |err| {err}"


def test_tail_f32_off_the_rule_takes_the_fma_kernel(cuda):
    """f32 stages off the rule run the first-version FMA kernel: channels
    off the multiples of 4 (both stages), and xa 4 bytes off a 16-byte
    boundary (stage 0; the stage after it reads an aligned output)."""
    xa, xb, s0, stages, lg = _tail_args(18, 10, 42, 1, True, torch.float32,
                                        cuda)
    assert tail.tail_route(xa, xb, s0[0]) == "fma"
    routes = dict(tail.packed_tail2.routes)
    got = tail.packed_tail2(xa, xb, s0, stages, lg)
    torch.cuda.synchronize()
    routes["fma"] += 2
    assert tail.packed_tail2.routes == routes
    ref = tail.tail2_reference(xa, xb, s0, stages, lg)
    err, ok = chip_smoke.tail_check(got.cpu(), ref.cpu(), torch.float32)
    assert ok, f"max |err| {err}"
    xa, xb, s0, stages, lg = _tail_args(16, 8, 24, 1, True, torch.float32,
                                        cuda)
    flat = torch.zeros(xa.numel() + 1, dtype=torch.float32, device=cuda)
    flat[1:] = xa.reshape(-1)
    off = flat[1:].view(xa.shape)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    assert tail.tail_route(off, xb, s0[0]) == "fma"
    routes = dict(tail.packed_tail2.routes)
    got = tail.packed_tail2(off, xb, s0, stages, lg)
    torch.cuda.synchronize()
    routes["fma"] += 1
    routes["simt"] += 1
    assert tail.packed_tail2.routes == routes
    ref = tail.tail2_reference(xa, xb, s0, stages, lg)
    err, ok = chip_smoke.tail_check(got.cpu(), ref.cpu(), torch.float32)
    assert ok, f"max |err| {err}"


def test_tail_simt_is_deterministic_and_blind_to_the_window(cuda):
    """The f32 stage kernel: two launches give the same bits, and the
    output of a sub-window of both operands (another box grid, every voxel
    at another place in its box) is bit for bit the full output's
    overlap."""
    rng = np.random.default_rng(7)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    xa = t(np.maximum(rng.normal(0, 1, (2, 20, 21, 30, 48)), 0))
    xb = t(np.maximum(rng.normal(0, 1, (2, 20, 21, 30, 16)), 0))
    s0 = (t(rng.normal(0, 512 ** -0.5, (2, 2, 2, 48, 64))),
          t(rng.normal(0, 512 ** -0.5, (2, 2, 2, 16, 64))),
          t(rng.normal(0, 0.1, 64)))
    full = tail.packed_tail2(xa, xb, s0)
    assert torch.equal(tail.packed_tail2(xa, xb, s0), full)
    for z, y, x in ((3, 5, 7), (1, 0, 9), (6, 2, 0)):
        sa = xa[:, z:, y:, x:].contiguous()
        sb = xb[:, z:, y:, x:].contiguous()
        assert tail.tail_route(sa, sb, s0[0]) == "simt"
        assert torch.equal(tail.packed_tail2(sa, sb, s0), full[:, z:, y:, x:])


def test_tail_simt_zeroed_tap_fails_the_check(cuda):
    xa, _, s0, _, _ = _tail_args(24, 0, 40, 0, False, torch.float32, cuda)
    ref = tail.tail_reference(xa, [(s0[0], s0[2])])
    w = s0[0].clone()
    w[1, 0, 1] = 0
    assert tail.tail_route(xa, None, w) == "simt"
    got = tail.packed_tail(xa, [(w, s0[2])])
    assert not chip_smoke.tail_check(got.cpu(), ref.cpu(), torch.float32)[1]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [
    (2, 5, 6, 7, 256),    # the main path's c = 32: 16-byte runs
    (1, 3, 4, 5, 8),      # c = 1: 2- or 4-byte units
    (3, 2, 3, 9, 24),     # c = 3
    (2, 4, 4, 4, 384),    # vgg_like's c = 48
])
def test_split_kernel_is_the_plain_copy(cuda, shape, dtype):
    x = torch.randn(shape, device=cuda).to(dtype)
    before = parity_split_kernel.launches
    got = parity_split_kernel(x)
    torch.cuda.synchronize()
    assert parity_split_kernel.launches == before + 1
    assert torch.equal(got, parity_split_reference(x))


def test_split_kernel_odd_alignment_and_rejections(cuda):
    # a contiguous bf16 view 2 bytes past a 16-byte boundary: 2-byte units
    flat = torch.randn(2 * 3 * 4 * 5 * 64 + 1, device=cuda).bfloat16()
    x = flat[1:].view(2, 3, 4, 5, 64)
    assert x.data_ptr() % 16 != 0
    assert torch.equal(parity_split_kernel(x), parity_split_reference(x))
    assert parity_split_kernel(x[:0]).shape == (0, 3, 4, 5, 8)
    with pytest.raises(TypeError):
        parity_split_kernel(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        parity_split_kernel(x.transpose(1, 2))
    with pytest.raises(ValueError, match="multiple of 8"):
        parity_split_kernel(torch.zeros((1, 2, 2, 2, 12), device=cuda))


WINO_CASES = {
    # label: (N, D, H, W, Ci, Co)
    "stage-B-like": (2, 12, 10, 36, 32, 48),   # 17 x-blocks: 32-row tiles
    "Co-64": (1, 10, 8, 34, 48, 64),          # 16 x-blocks: 16-row tiles
    "Co-96": (1, 8, 8, 20, 64, 96),           # Co > 64: 16-row tiles
    "wide": (1, 6, 6, 70, 128, 128),          # shared memory: short x runs
    "odd-widths": (2, 8, 10, 12, 5, 7),       # Ci, Co off the multiples of 16
    "past-128": (1, 8, 8, 10, 136, 129),      # two K passes, two Co blocks
    "past-128-by-8": (1, 8, 8, 10, 136, 192),  # wgmma: 5 slices, 3 Co blocks
}


def _wino_route(dtype, ci, co):
    """The route the rule of ``wino_route`` gives an aligned x, written out."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if ci % 8 == 0 and co % 8 == 0 else "wmma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(WINO_CASES))
def test_wino_kernel_matches_plain(cuda, case, dtype):
    n, d, h, w, ci, co = WINO_CASES[case]
    x, wgt, b = _inputs((d, h, w), ci, co, batch=n)
    x, b = x.to(cuda).to(dtype), b.to(cuda)
    u = wino.wino_transform_weights(wgt.to(cuda))
    route = _wino_route(dtype, ci, co)
    assert wino.wino_route(x, u) == route
    before = wino.wino_conv3d_bias_relu.launches
    routes = dict(wino.wino_conv3d_bias_relu.routes)
    got = wino.wino_conv3d_bias_relu(x, u, b)
    torch.cuda.synchronize()
    assert wino.wino_conv3d_bias_relu.launches == before + 1
    routes[route] += 1
    assert wino.wino_conv3d_bias_relu.routes == routes
    ref = wino.wino_reference(x, u, b)
    assert got.shape == ref.shape and got.dtype == dtype
    err, ok = chip_smoke.wino_check(got, ref)
    assert ok, f"max |err| {err}"


def test_wino_small_cases_of_the_smoke_run(cuda):
    """``chip_smoke``'s small K4 cases, each on the route it names."""
    chip_smoke.check_wino_small("test")


def test_wino_unaligned_input_takes_the_wmma_kernel(cuda):
    x, wgt, b = _inputs((8, 8, 10), 16, 24, batch=1)
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    flat[1:] = x.reshape(-1).to(cuda, torch.bfloat16)
    xv = flat[1:].view(x.shape)
    u = wino.wino_transform_weights(wgt.to(cuda))
    assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
    assert wino.wino_route(xv, u) == "wmma"
    got = wino.wino_conv3d_bias_relu(xv, u, b.to(cuda))
    err, ok = chip_smoke.wino_check(got, wino.wino_reference(xv, u, b.to(cuda)))
    assert ok, f"max |err| {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wino_broken_outputs_fail_the_check(cuda, dtype):
    x, wgt, b = _inputs((10, 12, 14), 32, 48, batch=2)
    u = wino.wino_transform_weights(wgt.to(cuda))
    r = chip_smoke.wino_readings(x.to(cuda).to(dtype), u, b.to(cuda))
    assert r["sound"][2]
    assert not r["tap dropped"][2] and not r["channel zeroed"][2]


def test_wino_kernel_without_relu_and_rejections(cuda):
    x, wgt, b = _inputs((8, 8, 8), 8, 16, batch=1)
    x, b = x.to(cuda) - 0.5, b.to(cuda)
    u = wino.wino_transform_weights(wgt.to(cuda))
    got = wino.wino_conv3d_bias_relu(x, u, b, relu=False)
    assert float(got.min()) < 0
    err, ok = chip_smoke.wino_check(got, wino.wino_reference(x, u, b, relu=False))
    assert ok, f"max |err| {err}"
    assert wino.wino_conv3d_bias_relu(x[:0], u, b).shape == (0, 6, 6, 6, 16)
    with pytest.raises(ValueError, match="even"):
        wino.wino_conv3d_bias_relu(x[:, :7], u, b)
    with pytest.raises(TypeError):
        wino.wino_conv3d_bias_relu(x.half(), u, b)
    # no cap on the channels: Co = 129 runs (in two blocks) and is the bias
    wide = wino.wino_conv3d_bias_relu(x, torch.zeros((64, 8, 129), device=cuda),
                                      torch.arange(129.0, device=cuda),
                                      relu=False)
    assert wide.shape == (1, 6, 6, 6, 129)
    assert torch.equal(wide[0, 0, 0, 0], torch.arange(129.0, device=cuda))
    with pytest.raises(ValueError, match="same device"):
        wino.wino_conv3d_bias_relu(x, u.cpu(), b)


@pytest.mark.parametrize("name", ["baseline", "vgg_like"])
def test_packed_convstack_on_the_card_matches_the_cpu(cuda, name):
    """The packed ConvStack (f32, narrow widths, batch 2) on the card, K5 at
    its boundary, against the CPU's plain versions; one K5 launch per
    forward."""
    from flypylib_tpu_torch.models.zoo import MODEL_ZOO
    from flypylib_tpu_torch.ops.packed_conv import packed_spec

    kw = {"baseline": dict(features=(8, 16, 16, 24)),
          "vgg_like": dict(features=(8, 8, 16, 16, 16, 24, 24))}[name]
    spec = packed_spec(MODEL_ZOO[name](dtype=torch.float32, **kw))
    s = spec.valid_size(spec.min_size + 8)
    x = np.random.default_rng(0).random((2, s, s, s, 1)).astype(np.float32)
    with torch.no_grad():
        want = spec.module(torch.from_numpy(x))
        before = parity_split_kernel.launches
        got = spec.module.to(cuda)(torch.from_numpy(x).to(cuda))
        torch.cuda.synchronize()
    assert parity_split_kernel.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("packed", [False, "auto"], ids=["plain", "packed"])
def test_detect_large_on_the_card_equals_detect(cuda, packed):
    """``detect_large`` on a 64^3 uint8 volume, roi and shared, every
    method, against ``detect`` on ``vol * f32(1/255)`` at the same tile and
    batch; K1 (plain) or K5 (packed) launched on the way."""
    from flypylib_tpu_torch import FplNetwork
    from flypylib_tpu_torch.infer.tiled import default_tiling

    net = FplNetwork("baseline", device="cuda", seed=0, packed=packed)
    vol = chip_smoke.make_volume_u8(64, 4, seed=2)
    scaled = chip_smoke.scaled(vol)
    tiling = default_tiling(net.infer_spec, vol.shape)
    prob = net.infer(scaled, *tiling, keep_on_device=True)
    thr = float(torch.topk(prob.reshape(-1), 300).values[-1])
    want = {"nms": net.nms(prob, window=5, threshold=thr),
            "components": net.components(prob, threshold=thr)}
    kernel = conv3d_bias_relu if packed is False else parity_split_kernel
    for forward in ("roi", "shared"):
        for method in ("nms", "components", "both"):
            before = kernel.launches
            got = net.detect_large(vol, threshold=thr, method=method,
                                   forward=forward, tile_out=tiling[0],
                                   tile_batch=tiling[1])
            assert kernel.launches > before
            got = chip_smoke.by_method(got, method)
            for m, dets in got.items():
                assert len(dets) > 0
                assert len(dets) == len(want[m])
                np.testing.assert_array_equal(dets.locs, want[m].locs)
                np.testing.assert_array_equal(dets.conf, want[m].conf)


@pytest.mark.parametrize("packed", [False, "auto"], ids=["plain", "packed"])
def test_streaming_on_the_card_equals_the_cpu(cuda, packed):
    """``detect_large(staged=False)`` (out-of-core streaming, roi, shared
    and bands of one ROI row) of a small f32 stack on a 48^3 uint8 volume,
    on the card and on the CPU's plain path with the same weights: the same
    detections (locations exactly, centroids within 1e-5, conf within
    1e-4; compared in location order, since conf ties closer than the two
    maps' f32 gap may sort either way) at a threshold in a gap of the CPU
    map wider than 1e-4; K1 (plain) or K5 (packed) launched on the way."""
    from flypylib_tpu_torch import FplNetwork
    from flypylib_tpu_torch.infer import large

    kw = dict(seed=0, packed=packed, dtype=torch.float32,
              features=(8, 16, 16, 24), head_features=16)
    nets = {d: FplNetwork("baseline", device=d, **kw) for d in ("cpu", "cuda")}
    nets["cuda"].module.load_state_dict(nets["cpu"].module.state_dict())
    vol = chip_smoke.make_volume_u8(48, 3, seed=4)
    top = np.sort(nets["cpu"].infer(chip_smoke.scaled(vol), 24, 2)
                  .reshape(-1))[::-1][:2000]
    k = 200 + int(np.argmax(top[199:1999] - top[200:2000] > 1e-4))
    thr = float((top[k - 1] + top[k]) / 2)
    shape, read = large.array_reader(vol)
    kernel = conv3d_bias_relu if packed is False else parity_split_kernel
    got = {}
    for dev, net in nets.items():
        plan = large.make_stream_plan(net.infer_spec, None, shape, core=16,
                                      tile_out=24, tile_batch=2, window=5,
                                      threshold=thr, method="both")
        before = kernel.launches
        got[dev] = [net.detect_large(vol, staged=False, plan=plan,
                                     threshold=thr, method="both",
                                     forward=f) for f in ("roi", "shared")]
        got[dev].append(large._detect_streaming_shared(plan, read, 1))
        assert (kernel.launches > before) == (dev == "cuda")
    def by_location(dets):
        order = np.lexsort(dets.locs.T[::-1])
        return dets.locs[order], dets.conf[order]

    for card, cpu in zip(got["cuda"], got["cpu"]):
        for c, p, tol in zip(card, cpu, (0.0, 1e-5)):
            assert len(c) > 0 and len(c) == len(p)
            (cl, cc), (pl, pc) = by_location(c), by_location(p)
            np.testing.assert_allclose(cl, pl, rtol=0, atol=tol)
            np.testing.assert_allclose(cc, pc, rtol=0, atol=1e-4)
    for run in got["cuda"][1:]:  # one tiling: the card's modes bit for bit
        for c, r in zip(run, got["cuda"][0]):
            np.testing.assert_array_equal(c.locs, r.locs)
            np.testing.assert_array_equal(c.conf, r.conf)


# -- training: the autograd Functions of K1 and K5, one step card vs CPU ----
@pytest.mark.parametrize("xs,ws", [
    ((32, 16, 16, 16, 192), (2, 2, 2, 192, 256)),  # stage A, layer 1
    ((256, 15, 15, 15, 32), (3, 3, 3, 32, 48)),    # stage B, layer 2 (*)
    ((256, 13, 13, 13, 48), (3, 3, 3, 48, 64)),    # stage B, layer 3
], ids=["a1", "b2", "b3"])
def test_packed_conv_input_gradient_by_fprop(cuda, xs, ws):
    """``PackedConv`` at the packed baseline's convs of a b32 step (patch
    34), bf16: the forward bit for bit the engine's call without grad, the
    input gradient (a forward conv of the padded output gradient) against
    ``torch.nn.grad.conv3d_input`` in f32 of the same values (TF32 off),
    within ``chip_smoke.conv_check``'s bf16 limit (one rounding).  (*)
    is the conv whose library input gradient is cuDNN's grouped direct
    kernel; the engine routes the 2^3 conv (a1) to autograd's gradients,
    and the Function holds there too."""
    from flypylib_tpu_torch.ops.packed_conv import PackedConv, _fprop

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(xs, generator=gen, device=cuda).bfloat16()
    w = (torch.randn(ws, generator=gen, device=cuda)
         / float(np.sqrt(np.prod(ws[:4])))).bfloat16()
    ys = (xs[0], *(xs[i] - ws[i - 1] + 1 for i in (1, 2, 3)), ws[4])
    dy = torch.randn(ys, generator=gen, device=cuda).bfloat16()
    xg = x.clone().requires_grad_(True)
    y = PackedConv.apply(xg, w)
    y.backward(dy)
    assert torch.equal(y.detach(), _fprop(x, w))
    ref = torch.nn.grad.conv3d_input(
        (xs[0], xs[4], *xs[1:4]), w.float().permute(4, 3, 0, 1, 2),
        dy.float().permute(0, 4, 1, 2, 3))
    err, ok = chip_smoke.conv_check(xg.grad, ref.permute(0, 2, 3, 4, 1))
    assert xg.grad.dtype == torch.bfloat16 and ok, err


def test_packed_b32_step_launches_no_grouped_direct_kernel(cuda):
    """The default training step (``TrainConfig()``: batch 32, the packed
    engine), profiled: the card runs cuDNN's convs, and none of them is the
    grouped direct input-gradient kernel the library picks for stage B's
    layer 2."""
    from torch.profiler import ProfilerActivity, profile

    from flypylib_tpu_torch import FplNetwork
    from flypylib_tpu_torch.train.trainer import (TrainConfig, TrainData,
                                                  make_train_step,
                                                  resolve_engine)

    net = FplNetwork("baseline", device=cuda, seed=0,
                     train_config=TrainConfig())
    assert resolve_engine(net.spec, net.trainer.cfg) == "packed"
    step, _, patch = make_train_step(net.spec, net.trainer.cfg)
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (64, 64, 64), dtype=np.uint8)
    labels = (rng.random((64, 64, 64)) > 0.99).astype(np.float32)
    data = TrainData.build(image, labels, np.ones_like(labels), patch,
                           device=cuda)
    state = net.trainer.init_state()
    for _ in range(2):
        step(state, net.trainer.generator, data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, net.trainer.generator, data)
        torch.cuda.synchronize()
    names = {k.name for e in prof.events() for k in e.kernels}
    assert any("fprop" in n for n in names), sorted(names)
    assert not [n for n in names if "grouped_direct" in n]
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ci,co,d", [(1, 24, 1), (24, 32, 1), (32, 48, 2)])
def test_k1_function_gradients_match_autograd_of_plain(cuda, ci, co, d,
                                                       dtype, tol):
    """K1's Function (the kernel forward, library conv gradients backward)
    against autograd through ``conv3d_reference`` on the same card tensors:
    per tensor max |err| <= tol max |ref| (f32: both sum in f32 in other
    orders; bf16: the Function's backward convs round to bf16 once, the
    plain version's autograd runs f32 convs)."""
    from flypylib_tpu_torch.ops.conv import Conv3dBiasReLU

    x, w, b = _inputs((11, 12, 13), ci, co, batch=2, seed=ci + co)
    x = x.to(dtype).to(cuda)
    dy = torch.randn((2, 11 - 2 * d, 12 - 2 * d, 13 - 2 * d, co),
                     generator=torch.Generator().manual_seed(0)).to(dtype)
    res = []
    for fn in (Conv3dBiasReLU.apply, conv3d_reference):
        xs = x.clone().requires_grad_(ci > 1)
        ws = w.to(cuda).requires_grad_(True)
        bs = b.to(cuda).requires_grad_(True)
        before = conv3d_bias_relu.launches
        y = fn(xs, ws, bs, d)
        y.backward(dy.to(cuda))
        torch.cuda.synchronize()
        res.append((conv3d_bias_relu.launches - before, xs.grad, ws.grad,
                    bs.grad))
    (n1, *got), (n0, *want) = res
    assert (n1, n0) == (1, 0)  # the kernel forward, no launch backward
    for g, r in zip(got, want):
        assert (g is None) == (r is None)
        if r is not None:
            err = float((g.float() - r.float()).abs().max())
            assert err <= tol * float(r.float().abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k5_function_backward_on_the_card(cuda, dtype):
    """``parity_batch`` with grad enabled: K5 forward (one launch), the
    inverse permutation backward, bit for bit the CPU's."""
    from flypylib_tpu_torch.ops.packed_conv import parity_batch, parity_unbatch

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (2, 6, 5, 7, 64)).astype(
        np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(0, 1, (16, 6, 5, 7, 8)).astype(
        np.float32)).to(dtype)
    xs = x.to(cuda).requires_grad_(True)
    before = parity_split_kernel.launches
    y = parity_batch(xs)
    y.backward(g.to(cuda))
    torch.cuda.synchronize()
    assert parity_split_kernel.launches == before + 1
    assert torch.equal(y.detach().cpu(), parity_split_reference(x))
    assert torch.equal(xs.grad.cpu(), parity_unbatch(g))


@pytest.mark.parametrize("model,engine", [("baseline", "plain"),
                                          ("baseline", "packed"),
                                          ("unet", "plain"),
                                          ("unet", "packed")])
def test_one_train_step_on_the_card_matches_the_cpu(cuda, model, engine):
    """One step's loss and gradients (f32, narrow widths) on the card
    against the CPU's plain path with the same weights and batch, by
    ``chip_smoke.case_ok`` (gradients within ``GRAD_TOL``, the plain
    engines' CPU step on the card's ReLU masks and pool choices); every
    parameter has a gradient, and the step launched K1 on every conv
    (plain) or K5 once (packed baseline)."""
    from flypylib_tpu_torch.models.zoo import baseline_model, unet

    make = {"baseline": lambda: baseline_model(
                features=(8, 16, 16, 24), head_features=16,
                dtype=torch.float32),
            "unet": lambda: unet(base_features=8, dtype=torch.float32)}[model]
    cpu, gpu = make(), make()
    gpu.module.to(cuda)
    patch = 26 if model == "baseline" else chip_smoke.grad_patch("unet",
                                                                cpu)[0]
    batch = chip_smoke.grad_batch(2, 2, patch, cpu.context)
    res = chip_smoke.card_vs_cpu(cpu, gpu, engine, batch, own=False)
    assert all(g is not None for g in res["grads_card"].values())
    assert chip_smoke.case_ok(res, torch.float32), res["errs"]
    want = chip_smoke.grad_launch_want(model, engine, torch.float32)
    assert res["launches"] == {k: want.get(k, 0) for k in res["launches"]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ci,co,d", [
    (1, 24, 1), (1, 136, 2),                   # the Ci = 1 kernel
    (24, 32, 1), (48, 64, 2), (96, 192, 1),    # wgmma (bf16) / simt (f32)
    (5, 7, 1), (16, 33, 3),                    # wmma (bf16) / fma, simt (f32)
])
def test_kernel_without_relu_matches_plain(cuda, ci, co, d, dtype):
    """``relu=False`` on every route against ``conv3d_reference(relu=
    False)``; the output has negative values, and the kernel's output
    with the clamp (``relu=True``) must fail the same check."""
    x, w, b = _inputs((13, 17, 22), ci, co, batch=2, seed=ci + co)
    x, w, b = x.to(dtype).to(cuda), w.to(cuda), b.to(cuda)
    _check(x, w, b, d, relu=False)
    ref = conv3d_reference(x, w, b, d, relu=False)
    assert bool((ref < 0).any())
    clamped = conv3d_bias_relu(x, w, b, d)
    torch.cuda.synchronize()
    assert not chip_smoke.conv_check(clamped.cpu(), ref.cpu())[1]


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_batchnorm_stack_on_the_card_matches_the_cpu(cuda, packed):
    """An f32 BatchNorm ``ConvStack`` with non-trivial statistics, eval
    mode, on the card (K1 with relu=False, or the packed engine's folded
    BatchNorm and K5) against the CPU's plain versions, 1e-4."""
    from flypylib_tpu_torch.models import zoo
    from flypylib_tpu_torch.ops.packed_conv import packed_spec

    module = zoo.ConvStack(features=(8, 16, 16, 24), dilations=(1, 1, 2, 2),
                           head_features=16, dtype=torch.float32,
                           use_batchnorm=True)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for norm in module.norms:
            for t, lo, hi in ((norm.scale, 0.5, 1.5), (norm.bias, -0.3, 0.3),
                              (norm.mean, -0.3, 0.3), (norm.var, 0.5, 2.0)):
                t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=g))
    spec = zoo.ModelSpec(name="bn", module=module, context=6, min_size=13)
    if packed:
        spec = packed_spec(spec)
    s = spec.valid_size(spec.min_size + 8)
    x = np.random.default_rng(0).random((2, s, s, s, 1)).astype(np.float32)
    with torch.no_grad():
        want = spec.module(torch.from_numpy(x))
        k1, k5 = conv3d_bias_relu.launches, parity_split_kernel.launches
        got = spec.module.to(cuda)(torch.from_numpy(x).to(cuda))
        torch.cuda.synchronize()
    if packed:
        assert parity_split_kernel.launches == k5 + 1
    else:
        assert conv3d_bias_relu.launches == k1 + 4
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("dtype", ["f32", "uint8"])
@pytest.mark.parametrize("packed", [False, "auto"], ids=["plain", "packed"])
def test_host_stream_on_the_card_equals_the_device_sweep(cuda, packed, dtype):
    """``infer(host_stream=True)`` (pinned buffers, a copy stream, events)
    against the whole-volume upload, bitwise, at tile batch 1 (one batch
    per tile, so the two buffers turn over many times) and 3."""
    from flypylib_tpu_torch import FplNetwork
    from flypylib_tpu_torch.infer.tiled import TiledInference

    net = FplNetwork("baseline", device="cuda", packed=packed,
                     features=(8, 16, 16, 24))
    vol = np.random.default_rng(1).random((60, 52, 44)).astype(np.float32)
    if dtype == "uint8":
        vol = (vol * 255).astype(np.uint8)
    for tile_batch in (1, 3):
        eng = TiledInference(net.infer_spec, tile_out=16,
                             tile_batch=tile_batch)
        assert eng.n_batches(vol.shape) >= 12
        want = eng.infer(vol)
        got = eng.infer(vol, host_stream=True)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["1-D", "2-D", "3-D"])
def test_sharded_infer_on_cuda_slots_equals_tiled(cuda, kind):
    """``sharded_infer`` over a mesh of repeated cuda:0 slots at a tile
    grid that coincides with ``TiledInference``'s (shard extents multiples
    of the tile): the map bit for bit, K5 once per shard's tile batch, and
    the sharded lists equal the host reference's on it."""
    from flypylib_tpu_torch import FplNetwork
    from flypylib_tpu_torch.ops.host_reference import components_host, nms_host

    port = chip_smoke.import_port()
    label, dims, axes = {m[0]: m for m in chip_smoke.SHARD_MESHES}[kind]
    net = FplNetwork("baseline", device="cuda", seed=0)
    vol = chip_smoke.make_volume_u8(64, 4, seed=2)
    want = net.infer(vol, 16, 4)
    mesh = chip_smoke.mesh_of(port, dims, axes, ["cuda:0"] * int(np.prod(dims)))
    before = parity_split_kernel.launches
    prob = port.sharded_infer(net.infer_spec, None, vol, mesh, axis=axes,
                              tile_out=16, tile_batch=4)
    torch.cuda.synchronize()
    assert parity_split_kernel.launches - before == \
        chip_smoke.shard_tile_batches(prob, 16, 4)
    np.testing.assert_array_equal(np.asarray(prob), want)
    thr = float(np.sort(want.reshape(-1))[-300])
    for got, ref in ((port.sharded_nms(prob, mesh, axes, 5, thr),
                      nms_host(want, window=5, threshold=thr)),
                     (port.sharded_components(prob, mesh, axes, thr),
                      components_host(want, threshold=thr))):
        assert len(ref) > 0
        np.testing.assert_array_equal(got.locs, ref.locs)
        np.testing.assert_array_equal(got.conf, ref.conf)


@pytest.mark.parametrize("forward", ["roi", "shared"])
def test_detect_large_devices_on_cuda_slots(cuda, forward):
    """``detect_large(devices=[cuda:0] * n)``, staged (n = 1, 2, 3) and
    streamed (n = 2): the lists bit for bit the single-device call's."""
    from flypylib_tpu_torch import FplNetwork
    from flypylib_tpu_torch.infer.large import make_stream_plan

    net = FplNetwork("baseline", device="cuda", seed=0)
    vol = chip_smoke.make_volume_u8(64, 4, seed=2)
    prob = net.infer(chip_smoke.scaled(vol), keep_on_device=True)
    thr = float(torch.topk(prob.reshape(-1), 300).values[-1])
    plan = make_stream_plan(net.infer_spec, None, vol.shape, core=16,
                            tile_out=16, tile_batch=4, window=5,
                            threshold=thr, method="both")
    kw = dict(threshold=thr, method="both", forward=forward, plan=plan)
    for staged, ns in ((True, (1, 2, 3)), (False, (2,))):
        want = net.detect_large(vol, staged=staged, **kw)
        for n in ns:
            got = net.detect_large(vol, staged=staged,
                                   devices=[torch.device("cuda", 0)] * n, **kw)
            for g, w in zip(got, want):
                assert len(g) == len(w) > 0
                np.testing.assert_array_equal(g.locs, w.locs)
                np.testing.assert_array_equal(g.conf, w.conf)


# -- the packed engines' conv + bias + ReLU on K2's wgmma stage kernel --------
FUSED_CASES = {
    # label: (batch, packed input extent, Ci, Co), both on the packed lattice
    "baseline-L0": (16, 38, 8, 192),
    "baseline-L1": (16, 37, 192, 256),
    "unet-8-192": (1, 14, 8, 192),
    "unet-192-192": (1, 13, 192, 192),
    "unet-192-384": (1, 12, 192, 384),
    "unet-384-384": (1, 11, 384, 384),
    "unet-384-768": (1, 10, 384, 768),
    "unet-768-768": (1, 9, 768, 768),
}


def _library_path(x, conv):
    """The call the route replaces: cuDNN's conv rounded to bf16 (``pre``),
    then ``_epilogue``; and the pre-activation ``pre + b`` in bf16."""
    from flypylib_tpu_torch.ops.packed_conv import (_epilogue, _fprop,
                                                    pack_weight_d1)

    pre = _fprop(x, pack_weight_d1(conv.weight.to(torch.bfloat16)))
    act = pre + conv.bias.to(torch.bfloat16).repeat(8)
    return _epilogue(pre, conv, tile=8), pre, act


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_route_matches_the_library_path(cuda, case):
    """``packed_conv_relu`` without grad takes the route (one launch, one
    ``packed_conv_fused``), within one rounding at each of the stage's two
    rounding points of cuDNN + ``_epilogue``, and exactly 0 wherever the
    library's pre-activation lies below minus one rounding of its conv."""
    from flypylib_tpu_torch.ops.packed_conv import (fused_route,
                                                    packed_conv_relu)
    from flypylib_tpu_torch.utils import metrics

    batch, s, ci, co = FUSED_CASES[case]
    x, conv = chip_smoke.fused_operands(batch, s, ci, co)
    with torch.no_grad():
        assert fused_route(x, co)
        before = tail.stage_bias_relu.launches
        metrics.enable()
        try:
            got = packed_conv_relu(x, conv)
            torch.cuda.synchronize()
        finally:
            rec = metrics.disable()
        assert tail.stage_bias_relu.launches == before + 1
        assert sum(c.get("packed_conv_fused", 0)
                   for c in rec["counters"].values()) == 1
        ref, pre, act = _library_path(x, conv)
    assert got.shape == ref.shape == (batch, *(s - 1,) * 3, co)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    err, ok = chip_smoke.tail_check(got, ref, torch.bfloat16, pre)
    assert ok, f"max |err| {err}"
    p = pre.float().abs()
    margin = chip_smoke.bf16_ulp(
        torch.clamp(p, min=chip_smoke.BF16_FLOOR * float(p.max())))
    clipped = act.float() < -margin
    assert 0.2 < float(clipped.float().mean()) < 0.8
    assert not got[clipped].any()


def test_fused_route_broken_weight_fails_the_check(cuda):
    """A tap of the packed weight zeroed in the kept images fails the same
    check: the test can see a wrong sum."""
    from flypylib_tpu_torch.ops.packed_conv import (_stage_operands,
                                                    packed_conv_relu)

    x, conv = chip_smoke.fused_operands(1, 12, 192, 384)
    with torch.no_grad():
        ref, pre, _ = _library_path(x, conv)
        sw = _stage_operands(conv, x.device)
        sw.w32[:, 3].zero_()  # every slice's tap 3 (z = 0, y = 1, x = 1)
        got = packed_conv_relu(x, conv)
    assert not chip_smoke.tail_check(got, ref, torch.bfloat16, pre)[1]


def test_fused_route_tiled_equals_monolithic_bitwise(cuda):
    """The route's output on sub-windows of the input (other box grids,
    every voxel at another place in its box) and on one batch entry is bit
    for bit the whole call's overlap, at one slice and at four: what a
    tiled map needs to equal the monolithic one."""
    from flypylib_tpu_torch.ops.packed_conv import packed_conv_relu

    for ci, co in ((8, 192), (384, 768)):
        x, conv = chip_smoke.fused_operands(2, 15, ci, co, seed=1)
        with torch.no_grad():
            full = packed_conv_relu(x, conv)
            assert torch.equal(packed_conv_relu(x, conv), full)
            assert torch.equal(packed_conv_relu(x[1:].contiguous(), conv),
                               full[1:])
            for z, y, w in ((3, 5, 7), (1, 0, 9), (6, 2, 0)):
                sub = x[:, z:, y:, w:].contiguous()
                assert torch.equal(packed_conv_relu(sub, conv),
                                   full[:, z:, y:, w:])


def test_fused_route_counts_per_forward(cuda):
    """One packed forward takes the route once per conv it covers: 8 in
    the U-Net (four encoder convs, two bottleneck convs, each decoder
    level's second conv), 2 in the baseline (stage A); under grad, none."""
    from flypylib_tpu_torch.models.zoo import baseline_model, unet
    from flypylib_tpu_torch.ops.packed_conv import packed_spec
    from flypylib_tpu_torch.ops.packed_unet import packed_unet_spec
    from flypylib_tpu_torch.utils import metrics

    for spec, want in ((packed_unet_spec(unet()), 8),
                       (packed_spec(baseline_model()), 2)):
        module = spec.module.to(cuda)
        s = spec.valid_size(spec.min_size + 4)
        x = torch.rand((2, s, s, s, 1), device=cuda)
        for grad in (False, True):
            before = tail.stage_bias_relu.launches
            metrics.enable()
            try:
                with torch.set_grad_enabled(grad):
                    module(x)
                torch.cuda.synchronize()
            finally:
                rec = metrics.disable()
            n = sum(c.get("packed_conv_fused", 0)
                    for c in rec["counters"].values())
            assert n == (0 if grad else want), (spec.name, grad, n)
            assert tail.stage_bias_relu.launches == before + n


def test_fused_route_kernel_time_falls_in_its_ranges(cuda):
    """The route's kernel and K5's are tied to the operators that launch
    them (``fpl::stage_bias_relu``, ``fpl::parity_split``), so
    ``torch.profiler`` counts their device time in every range open around
    the call, as it counts a PyTorch kernel's: what a reader of a forward's
    device time sees."""
    from torch.autograd import DeviceType

    from flypylib_tpu_torch.ops.packed_conv import packed_conv_relu
    from flypylib_tpu_torch.ops.split import parity_split_kernel
    from flypylib_tpu_torch.utils.metrics import span

    x, conv = chip_smoke.fused_operands(2, 24, 192, 384)
    rf = torch.autograd.profiler.record_function
    with torch.no_grad():
        y = packed_conv_relu(x, conv)
        parity_split_kernel(y)
        torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            with rf("outer"):
                packed_conv_relu(x, conv)  # right under the range
                with span("inner", device=cuda):  # under a span inside it
                    parity_split_kernel(packed_conv_relu(x, conv))
            torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and ("tail_wgmma_kernel" in e.name()
                    or "parity_split_kernel" in e.name())]
    assert len(kernels) == 3
    assert all(e.linked_correlation_id() > 0 for e in kernels)
    kernel_us = [e.duration_ns() / 1e3 for e in kernels]
    ranges = {e.name: e.device_time_total for e in prof.events()
              if e.device_type == DeviceType.CPU
              and e.name in ("outer", "fpl.inner")}
    assert ranges["outer"] >= 0.999 * sum(kernel_us), (ranges, kernel_us)
    assert ranges["fpl.inner"] >= 0.999 * sum(kernel_us[1:]), (ranges,
                                                               kernel_us)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    assert names.count("fpl::stage_bias_relu") == 2
    assert names.count("fpl::parity_split") == 1
