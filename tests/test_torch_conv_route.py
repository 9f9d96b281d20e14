"""K1's route rule and the wgmma kernel's host-side layout, on the CPU.

``conv3d_bias_relu`` on a CUDA tensor picks one of four kernels by a rule
on shape, dtype and alignment (``k1_route``).  The wgmma kernel reads the
weights from images the wrapper lays out (``wgmma_weights``) and one output
box per block (``wgmma_box``); these are plain PyTorch and Python, so they
are held here, as is the output box and run plan the Ci = 1 kernel is
handed (``ci1_plan``).  The kernels themselves run in
``tests/test_torch_cuda.py`` on the card.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from flypylib_tpu_torch.ops.conv import (CI1_SMEM_FLOATS, CI1_VOXELS,
                                         K1_ROUTES, WGMMA_KC, WGMMA_N_TILES,
                                         WGMMA_ROWS, ci1_plan,
                                         conv3d_bias_relu, k1_route,
                                         wgmma_box, wgmma_slices, wgmma_tile,
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
        assert k1_route(_x(48, dtype), _w(48, 64)) == "fma"


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
