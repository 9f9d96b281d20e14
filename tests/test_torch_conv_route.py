"""K1's route rule and the kernels' host-side layouts, on the CPU.

``conv3d_bias_relu`` on a CUDA tensor picks one of five kernels by a rule
on shape, dtype, alignment and dilation (``k1_route``).  The wgmma kernel
reads the weights from images the wrapper lays out (``wgmma_weights``) and
one output box per block (``wgmma_box``); these are plain PyTorch and
Python, so they are held here, as is the output box and run plan the
Ci = 1 kernel is handed (``ci1_plan``) and the f32 kernel's box, channel
blocks, shared memory and weight image (``simt_plan``, ``simt_weights``).
The f32 kernel sums each output in one order (slice of 4 channels, tap,
channel, on FMAs); ``_simt_model`` spells that order out in numpy from the
weight image and is held against the JAX package's Pallas kernel in
interpret mode, so the reordering is tested here and not first on the card.
The kernels themselves run in ``tests/test_torch_cuda.py`` on the card.
"""

import itertools
import math

import numpy as np
import pytest
import torch

import chip_smoke
from flypylib_tpu_torch.ops.conv import (CI1_SMEM_FLOATS, CI1_VOXELS,
                                         K1_ROUTES, SIMT_MAX_DILATION,
                                         SIMT_SLICE, SIMT_SMEM, SIMT_VOXELS,
                                         SIMT_WIDEST, WGMMA_KC, WGMMA_N_TILES,
                                         WGMMA_ROWS, ci1_plan,
                                         conv3d_bias_relu, conv3d_reference,
                                         k1_route, simt_plan, simt_smem_bytes,
                                         simt_weights, simt_width, wgmma_box,
                                         wgmma_slices, wgmma_tile,
                                         wgmma_weights)


def _x(ci, dtype=torch.bfloat16, shape=(2, 9, 10, 11)):
    return torch.zeros((*shape, ci), dtype=dtype)


def _w(ci, co):
    return torch.zeros((3, 3, 3, ci, co))


@pytest.mark.parametrize("ci,co", [(24, 32), (32, 48), (48, 64), (64, 96),
                                   (96, 96), (96, 128), (48, 24), (8, 8)])
def test_aligned_bf16_main_path_shapes_take_wgmma(ci, co):
    assert k1_route(_x(ci), _w(ci, co)) == "wgmma"


@pytest.mark.parametrize("ci,co", [(5, 8), (12, 32), (24, 20), (16, 33)])
def test_widths_off_the_multiples_of_8_take_wmma(ci, co):
    assert k1_route(_x(ci), _w(ci, co)) == "wmma"


def test_a_view_off_a_16_byte_boundary_takes_wmma():
    n = 2 * 9 * 10 * 11 * 32
    flat = torch.zeros(n + 8, dtype=torch.bfloat16)
    xv = flat[1:n + 1].view(2, 9, 10, 11, 32)
    assert xv.is_contiguous() and xv.data_ptr() % 16 == 2
    assert k1_route(xv, _w(32, 48)) == "wmma"
    assert k1_route(flat[8:].view(2, 9, 10, 11, 32), _w(32, 48)) == "wgmma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ci1_and_f32_routes(dtype):
    assert k1_route(_x(1, dtype), _w(1, 24)) == "ci1"
    if dtype == torch.float32:
        assert k1_route(_x(48, dtype), _w(48, 64)) == "simt"
        assert k1_route(_x(6, dtype), _w(6, 64)) == "fma"


@pytest.mark.parametrize("ci,co", [(24, 32), (32, 48), (48, 64), (64, 96),
                                   (96, 48), (4, 7), (12, 136), (8, 20)])
def test_f32_with_ci_a_multiple_of_4_takes_simt(ci, co):
    """Ci % 4 == 0 (a slice is one 16-byte record a voxel); any Co."""
    assert k1_route(_x(ci, torch.float32), _w(ci, co)) == "simt"


@pytest.mark.parametrize("ci", [2, 3, 5, 6, 7, 10, 25, 50])
def test_f32_with_ci_off_the_multiples_of_4_takes_fma(ci):
    assert k1_route(_x(ci, torch.float32), _w(ci, 32)) == "fma"


def test_f32_view_off_a_16_byte_boundary_takes_fma():
    n = 2 * 9 * 10 * 11 * 32
    flat = torch.zeros(n + 8, dtype=torch.float32)
    xv = flat[1:n + 1].view(2, 9, 10, 11, 32)
    assert xv.is_contiguous() and xv.data_ptr() % 16 == 4
    assert k1_route(xv, _w(32, 48)) == "fma"
    assert k1_route(flat[4:n + 4].view(2, 9, 10, 11, 32), _w(32, 48)) == "simt"


def test_f32_dilation_past_the_halo_limit_takes_fma():
    """SIMT_MAX_DILATION is the largest dilation whose halo fits the f32
    kernel's smallest box (1 x 1 x 8) with its widest channel block."""
    x, w = _x(32, torch.float32), _w(32, 64)
    for d in range(1, SIMT_MAX_DILATION + 1):
        assert k1_route(x, w, d) == "simt"
    assert k1_route(x, w, SIMT_MAX_DILATION + 1) == "fma"
    assert simt_smem_bytes((1, 1, 8), SIMT_MAX_DILATION, SIMT_WIDEST) <= SIMT_SMEM
    assert simt_smem_bytes((1, 1, 8), SIMT_MAX_DILATION + 1,
                           SIMT_WIDEST) > SIMT_SMEM


@pytest.mark.parametrize("ci,co,d", [(32, 48, 1), (48, 64, 2), (1, 24, 9)])
def test_bf16_and_ci1_routes_ignore_the_dilation(ci, co, d):
    assert k1_route(_x(ci), _w(ci, co), d) == k1_route(_x(ci), _w(ci, co))
    assert k1_route(_x(1, torch.float32), _w(1, co), 20) == "ci1"


def test_cpu_calls_count_no_route():
    before = dict(conv3d_bias_relu.routes)
    assert set(before) == set(K1_ROUTES)
    conv3d_bias_relu(_x(32, shape=(1, 5, 5, 5)), _w(32, 48), torch.zeros(48))
    assert conv3d_bias_relu.routes == before


@pytest.mark.parametrize("ci", [8, 16, 24, 32, 40, 48, 56, 64, 96, 112])
def test_weight_images_hold_w_and_zeros_elsewhere(ci):
    co = 40
    w = torch.from_numpy(np.random.default_rng(ci).normal(
        0, 1, (3, 3, 3, ci, co)).astype(np.float32))
    n_tile = wgmma_tile(co)
    assert n_tile == 48
    n_full, c0 = wgmma_slices(ci)
    w32, w16 = wgmma_weights(w, n_tile)
    assert w32.shape == (27, n_full, n_tile, WGMMA_KC)
    assert w32.dtype == torch.bfloat16 and w32.is_contiguous()
    assert (w16 is not None) == (c0 is not None)
    # what the K steps sum for each (tap, c, o), tap = 9 tz + 3 ty + tx:
    # every weight of w exactly once (the weights are nonzero, so a channel
    # held by two slices would count twice), zero past Ci and Co
    got = torch.zeros((27, max(ci, n_full * WGMMA_KC), n_tile))
    for s in range(n_full):
        got[:, WGMMA_KC * s:WGMMA_KC * (s + 1)] += w32[:, s].float().transpose(1, 2)
    half = WGMMA_KC // 2
    if c0 is not None:
        assert w16.shape == (27, n_tile, half) and w16.is_contiguous()
        n = min(half, ci - c0)
        assert not w16[:, :, n:].any()  # channels past Ci
        got[:, c0:c0 + n] += w16[:, :, :n].float().transpose(1, 2)
        # a rest of at most 16 channels: one 16-channel slice ending at Ci
        assert 0 < ci % WGMMA_KC <= half and c0 == max(ci - half, 0)
    else:
        assert ci % WGMMA_KC == 0 or ci % WGMMA_KC > half
    want = w.to(torch.bfloat16).float().reshape(27, ci, co)
    assert torch.equal(got[:, :ci, :co], want)
    assert not got[:, ci:].any() and not got[..., co:].any()
    # the steps move Ci rounded up to a multiple of 16
    moved = n_full * WGMMA_KC + (0 if c0 is None else half)
    assert moved == -(-ci // half) * half


def test_n_tile():
    assert [wgmma_tile(co) for co in (8, 24, 32, 40, 48, 64, 96, 128)] == [
        24, 24, 32, 48, 48, 64, 96, 128]
    assert WGMMA_N_TILES[-1] == 128
    with pytest.raises(ValueError, match="Co"):
        wgmma_tile(136)


@pytest.mark.parametrize("extents,rows", [
    ((72, 72, 72), 256), ((68, 68, 68), 256), ((64, 64, 64), 256),
    ((64, 64, 64), 128), ((69, 69, 69), 128), ((258, 258, 258), 256),
    ((11, 13, 12), 256), ((1, 1, 300), 128), ((3, 2, 1), 256),
])
def test_box_fits_the_block_and_covers_in_the_fewest_blocks(extents, rows):
    bz, by, bx = wgmma_box(extents, rows)
    assert bz * by * bx <= rows and max(bz, by, bx) <= 256
    blocks = math.prod(-(-e // b) for e, b in zip(extents, (bz, by, bx)))
    # no box of at most `rows` rows needs fewer blocks
    fewest = min(
        math.prod(-(-e // b) for e, b in zip(extents, (z, y, min(rows // (z * y), 256))))
        for z, y in itertools.product(range(1, rows + 1), repeat=2)
        if z * y <= rows and y <= 256 and z <= 256)
    assert blocks == fewest


def test_main_path_boxes_waste_little():
    """The masked ragged edge (rows computed and not stored) at the plain
    baseline's and vgg_like's output extents."""
    for extent in (72, 68, 64):
        box = wgmma_box((extent,) * 3)
        blocks = math.prod(-(-extent // b) for b in box)
        assert blocks * WGMMA_ROWS / extent**3 - 1 < 0.05


def test_any_co_runs_in_blocks_of_output_channels():
    """K1's domain is the reference's: no cap on Co or on the dilation.  The
    wgmma kernel takes a layer wider than its widest N tile in equal blocks
    of output channels, each a multiple of 8 that an N tile holds."""
    from flypylib_tpu_torch.ops import conv

    assert not hasattr(conv, "MAX_CO") and not hasattr(conv, "DILATIONS")
    assert conv.wgmma_chunks(64) == [(0, 64)]
    assert conv.wgmma_chunks(128) == [(0, 128)]
    assert conv.wgmma_chunks(192) == [(0, 96), (96, 96)]
    assert conv.wgmma_chunks(136) == [(0, 72), (72, 64)]
    for co in range(8, 1025, 8):
        chunks = conv.wgmma_chunks(co)
        assert [c0 for c0, _ in chunks] == [
            sum(n for _, n in chunks[:i]) for i in range(len(chunks))]
        assert sum(n for _, n in chunks) == co
        assert all(n % 8 == 0 and wgmma_tile(n) >= n for _, n in chunks)
        assert len(chunks) == -(-co // WGMMA_N_TILES[-1])
    assert k1_route(_x(96), _w(96, 192)) == "wgmma"


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("out_dhw", [(74, 74, 74), (92, 92, 92), (13, 17, 22),
                                     (15, 15, 15), (1, 1, 5), (3, 70, 41),
                                     (5, 5, 300)])
def test_ci1_plan_covers_the_output_once(out_dhw, d):
    """The Ci = 1 kernel's blocks and runs, as the kernel indexes them:
    thread t of 256 owns box voxels t, t + 256, t + 512, t + 768, voxel v
    at (v // bx // by, v // bx % by, v % bx) of the box, masked past the box
    and past the output.  Every output voxel is computed exactly once."""
    bz, by, bx, staged = ci1_plan(out_dhw, d)
    assert bz * by * bx <= CI1_VOXELS
    assert bx >= min(out_dhw[2], 32)  # a warp's voxels run along x
    assert all(b <= e for b, e in zip((bz, by, bx), out_dhw))
    halo = (bz + 2 * d) * (by + 2 * d) * (bx + 2 * d)
    assert staged == (halo <= CI1_SMEM_FLOATS)
    seen = np.zeros(out_dhw, np.int32)
    v = np.arange(CI1_VOXELS)  # thread t's run j is voxel t + 256 j
    xx, yy, zz = v % bx, v // bx % by, v // bx // by
    for z0, y0, x0 in itertools.product(*(range(0, e, b) for e, b in
                                          zip(out_dhw, (bz, by, bx)))):
        live = ((zz < bz) & (z0 + zz < out_dhw[0]) & (y0 + yy < out_dhw[1])
                & (x0 + xx < out_dhw[2]))
        np.add.at(seen, (z0 + zz[live], y0 + yy[live], x0 + xx[live]), 1)
    assert (seen == 1).all()


def test_ci1_plan_at_the_main_shapes_and_past_shared_memory():
    """Baseline L0 (74^3 out), vgg_like L0 (92^3) and U-Net conv 0 (294^3)
    stage their halo; a dilation of 20 does not fit and reads through L1."""
    for size in (74, 92, 294):
        bz, by, bx, staged = ci1_plan((size,) * 3, 1)
        tiles = math.prod(-(-size // b) for b in (bz, by, bx))
        assert staged and bx >= 32
        assert size ** 3 / (tiles * CI1_VOXELS) > 0.8  # the runs are filled
    assert ci1_plan((40, 40, 40), 20)[3] is False


# K1's f32 calls with Ci > 1 on the main paths, (output extent, Co): the
# baseline's layers 1-3 and vgg_like's layers 1-6 at default_tiling's tile
# for a 256^3 volume, the plain U-Net's convs 1-9 (one covering tile), then
# chip_smoke's wide cases
SIMT_SHAPES = [
    ((72,) * 3, 32), ((68,) * 3, 48), ((64,) * 3, 64),
    ((90,) * 3, 32), ((88,) * 3, 48), ((84,) * 3, 48), ((80,) * 3, 64),
    ((72,) * 3, 64), ((64,) * 3, 96),
    ((292,) * 3, 24), ((144,) * 3, 48), ((142,) * 3, 48), ((69,) * 3, 96),
    ((67,) * 3, 96), ((132,) * 3, 48), ((130,) * 3, 48), ((258,) * 3, 24),
    ((256,) * 3, 24),
] + [((size - 2 * d,) * 3, co) for _, _, size, ci, co, d
     in chip_smoke.WIDE_CONV_CASES if ci > 1]


def _lanes_cover_once(out_dhw, box):
    """Every output voxel is computed and stored exactly once, as the f32
    kernel indexes its blocks: lane l of a warp holds box voxels l + 32 j
    (j < 8, x fastest), masked past the box and past the output."""
    bz, by, bx = box
    seen = np.zeros(out_dhw, np.int32)
    v = np.arange(SIMT_VOXELS)
    xx, yy, zz = v % bx, v // bx % by, v // bx // by
    for z0, y0, x0 in itertools.product(*(range(0, e, b) for e, b in
                                          zip(out_dhw, box))):
        live = ((zz < bz) & (z0 + zz < out_dhw[0]) & (y0 + yy < out_dhw[1])
                & (x0 + xx < out_dhw[2]))
        np.add.at(seen, (z0 + zz[live], y0 + yy[live], x0 + xx[live]), 1)
    return bool((seen == 1).all())


@pytest.mark.parametrize("d", [1, 2, 3, 4, SIMT_MAX_DILATION])
@pytest.mark.parametrize("out_dhw,co", [((13, 17, 22), 32), ((5, 5, 300), 8),
                                        ((1, 1, 5), 64), ((3, 70, 41), 136),
                                        ((20, 19, 18), 96)])
def test_simt_plan_covers_the_output_once(out_dhw, co, d):
    bz, by, bx, width, smem = simt_plan(out_dhw, d, co)
    assert bz * by * bx <= SIMT_VOXELS
    assert bz <= out_dhw[0] and by <= out_dhw[1]
    assert bx <= max(-(-out_dhw[2] // 8) * 8, 8)
    # a quarter-warp's 8 lanes read 8 neighbouring records of one row
    assert bx % 8 == 0 or bx == out_dhw[2] < 8
    assert max(bz, by, bx) + 2 * d <= 256  # TMA's box
    assert smem == simt_smem_bytes((bz, by, bx), d, width) <= SIMT_SMEM
    assert width == simt_width(co)
    assert _lanes_cover_once(out_dhw, (bz, by, bx))


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_simt_plan_fits_shared_memory_at_the_main_shapes(d):
    """Shared memory of a block <= 227 KB (the most an H100 block may take,
    with the kernel's static barriers) at every main-path shape and wide
    case, d = 1-4; at the main shapes the masked lanes (past the box or the
    output) are at most 15% of the blocks' 256 a block."""
    for out_dhw, co in SIMT_SHAPES:
        bz, by, bx, width, smem = simt_plan(out_dhw, d, co)
        assert smem <= SIMT_SMEM < 227 * 1024
        if min(out_dhw) >= 64:
            tiles = math.prod(-(-e // b) for e, b in zip(out_dhw, (bz, by, bx)))
            assert math.prod(out_dhw) / (tiles * SIMT_VOXELS) > 0.85


def test_simt_plan_at_the_baseline_layers():
    """The boxes the f32 kernel runs the baseline's layers 1-3 in (a tile
    batch at 256^3): 4 x 8 x 8, one block of Co (32, 48, 64); shared
    memory 49, 79 and 91 KB, so two blocks of 48 channels share an SM."""
    assert simt_plan((72,) * 3, 1, 32) == (4, 8, 8, 32, 49 * 1024)
    assert simt_plan((68,) * 3, 2, 48) == (4, 8, 8, 48, 79 * 1024)
    assert simt_plan((64,) * 3, 2, 64) == (4, 8, 8, 64, 91 * 1024)


@pytest.mark.parametrize("co,want", [(8, [8]), (20, [20]), (24, [24]),
                                     (64, [64]), (72, [40, 32]),
                                     (96, [48, 48]), (136, [48, 48, 40]),
                                     (192, [64, 64, 64])])
def test_simt_channel_blocks(co, want):
    """Co in the fewest blocks of at most 64, of one width (a multiple of
    8), the last narrower: wgmma_chunks' rule at a widest block of 64."""
    from flypylib_tpu_torch.ops.conv import wgmma_chunks

    width = simt_width(co)
    blocks = [min(width, co - c0) for c0 in range(0, co, width)]
    assert blocks == want
    assert blocks == [n for _, n in wgmma_chunks(co, SIMT_WIDEST)]
    assert width % 8 == 0 and width <= SIMT_WIDEST


@pytest.mark.parametrize("ci,co", [(4, 8), (12, 20), (24, 72), (48, 136)])
def test_simt_weight_image_holds_w_and_zeros_elsewhere(ci, co):
    w = torch.from_numpy(np.random.default_rng(ci * co).normal(
        0, 1, (3, 3, 3, ci, co)).astype(np.float32))
    width = simt_width(co)
    img = simt_weights(w, width)
    n_cb = -(-co // width)
    assert img.shape == (n_cb, ci // SIMT_SLICE, 27, width // 8, SIMT_SLICE, 8)
    assert img.dtype == torch.float32 and img.is_contiguous()
    # img[cb, s, tap, g, c, k] = w[tap, 4 s + c, cb * width + 8 g + k]
    back = img.permute(2, 1, 4, 0, 3, 5).reshape(27, ci, n_cb * width)
    assert torch.equal(back[..., :co], w.reshape(27, ci, co))
    assert not back[..., co:].any()


def _simt_model(x, w, b, d, relu=True, drop_tap=None):
    """K1 on ``x`` (B, D, H, W, Ci) in the f32 kernel's order of sums, in
    numpy: every output channel's f32 accumulator takes acc = fma(x, w,
    acc) slice by slice (4 channels), tap by tap (tz, ty, tx), channel by
    channel, with the weights read from ``simt_weights``' image (an FMA
    modelled as the exact f64 product plus acc, rounded once to f32); then
    the f32 bias and ReLU.  ``drop_tap`` leaves that tap's weights out."""
    B, D, H, W, ci = x.shape
    co = w.shape[-1]
    Do, Ho, Wo = D - 2 * d, H - 2 * d, W - 2 * d
    width = simt_width(co)
    img = simt_weights(torch.from_numpy(w), width).numpy().astype(np.float64)
    acc = np.zeros((B, Do, Ho, Wo, img.shape[0] * width), np.float32)
    for s in range(ci // SIMT_SLICE):
        for tap in range(27):
            if tap == drop_tap:
                continue
            tz, ty, tx = tap // 9, tap // 3 % 3, tap % 3
            win = x[:, tz * d:tz * d + Do, ty * d:ty * d + Ho,
                    tx * d:tx * d + Wo].astype(np.float64)
            for c in range(SIMT_SLICE):
                wv = img[:, s, tap, :, c, :].reshape(-1)  # cb * width + 8 g + k
                acc = (win[..., SIMT_SLICE * s + c, None] * wv
                       + acc).astype(np.float32)
    y = acc[..., :co] + b
    return np.maximum(y, np.float32(0)) if relu else y


@pytest.mark.parametrize("ci,co,d", [(8, 12, 1), (12, 20, 2), (16, 72, 1)])
def test_simt_sum_order_matches_the_jax_kernel(ci, co, d):
    """The f32 kernel's order of sums against the JAX package's Pallas
    kernel (interpret mode, as tests/test_pallas_conv.py runs it) within
    chip_smoke's f32 limit (1e-4 of max |ref|); the limit still refuses the
    centre tap dropped in this order."""
    import jax.numpy as jnp

    from flypylib_tpu.ops.pallas_conv import conv3d_bias_relu as jax_k1

    rng = np.random.default_rng(ci + co + d)
    x = np.maximum(rng.normal(0, 1, (2, 10 + 2 * d, 9 + 2 * d, 11 + 2 * d, ci)),
                   0).astype(np.float32)
    w = rng.normal(0, (27 * ci) ** -0.5, (3, 3, 3, ci, co)).astype(np.float32)
    b = rng.normal(0, 0.1, co).astype(np.float32)
    ref = np.stack([np.asarray(jax_k1(jnp.asarray(xi), jnp.asarray(w),
                                      jnp.asarray(b), dilation=d,
                                      interpret=True)) for xi in x])
    got = _simt_model(x, w, b, d)
    assert got.shape == ref.shape and got.dtype == np.float32
    err, ok = chip_smoke.conv_check(torch.from_numpy(got), torch.from_numpy(ref))
    assert ok, f"max |err| {err}"
    _, bad = chip_smoke.conv_check(
        torch.from_numpy(_simt_model(x, w, b, d, drop_tap=13)),
        torch.from_numpy(ref))
    assert not bad


def test_simt_sum_order_without_relu_matches_the_plain_version():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (1, 12, 11, 13, 8)).astype(np.float32)
    w = rng.normal(0, 27 ** -0.5 / 3, (3, 3, 3, 8, 24)).astype(np.float32)
    b = rng.normal(0, 0.1, 24).astype(np.float32)
    ref = conv3d_reference(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), 2, relu=False)
    assert bool((ref < 0).any())
    got = torch.from_numpy(_simt_model(x, w, b, 2, relu=False))
    err, ok = chip_smoke.conv_check(got, ref)
    assert ok, f"max |err| {err}"
