"""K4's route rule and the wgmma kernel's host-side layout and schedule, on
the CPU.

``wino_conv3d_bias_relu`` on a CUDA tensor picks one of three kernels by a
rule on dtype, widths and alignment (``wino_route``).  The wgmma kernel
reads U from K-major images (``wino_images``: ``weight_images`` with 64
taps, a step's four taps side by side), owns one tile
of 2^3 output blocks per block (``wino_box``) and one block of output
channels per launch (``wgmma_chunks``); these are plain PyTorch and Python,
so they are held here.  The kernel also sums in f32 in another order than
the plain version: per 16-channel K step and pair (A, B) of z and y
transform rows it forms p0 = V0 U0 + V1 U1 + V2 U2 and p1 = V1 U1 - V2 U2
- V3 U3 (the x axis of the inverse transform), then folds p0 and p1 into
the eight phase sums.  ``_schedule_model`` spells that order out with the
plain version's own transform and is held against ``wino_reference``
within ``chip_smoke.wino_check`` (bf16: 2 bf16 ulps; f32: 1e-4 (1 +
|ref|)): both round at the same points and differ only in the order of
the f32 sums, so the reordering is tested here and not first on the card.
The kernels themselves run in ``tests/test_torch_cuda.py`` on the card.
"""

import itertools
import math

import numpy as np
import pytest
import torch

import chip_smoke
from flypylib_tpu_torch.ops import wino_conv as wino
from flypylib_tpu_torch.ops.conv import (WGMMA_KC, matmul_f32, weight_images,
                                         wgmma_chunks, wgmma_slices)


def _x(ci, dtype=torch.bfloat16, shape=(2, 8, 10, 12)):
    return torch.zeros((*shape, ci), dtype=dtype)


def _u(ci, co):
    return torch.zeros((64, ci, co))


@pytest.mark.parametrize("ci,co", [(32, 48), (48, 64), (24, 32), (48, 24),
                                   (8, 8), (136, 136), (40, 200)])
def test_aligned_bf16_takes_wgmma(ci, co):
    assert wino.wino_route(_x(ci), _u(ci, co)) == "wgmma"


@pytest.mark.parametrize("ci,co", [(5, 8), (12, 32), (24, 20), (16, 129)])
def test_widths_off_the_multiples_of_8_take_wmma(ci, co):
    assert wino.wino_route(_x(ci), _u(ci, co)) == "wmma"


@pytest.mark.parametrize("ci,co", [(32, 48), (5, 7), (136, 129)])
def test_f32_takes_fma(ci, co):
    assert wino.wino_route(_x(ci, torch.float32), _u(ci, co)) == "fma"


def test_a_view_off_a_16_byte_boundary_takes_wmma():
    n = 2 * 8 * 10 * 12 * 32
    flat = torch.zeros(n + 8, dtype=torch.bfloat16)
    xv = flat[1:n + 1].view(2, 8, 10, 12, 32)
    assert xv.is_contiguous() and xv.data_ptr() % 16 == 2
    assert wino.wino_route(xv, _u(32, 48)) == "wmma"
    assert wino.wino_route(flat[8:].view(2, 8, 10, 12, 32), _u(32, 48)) == "wgmma"


def test_cpu_calls_count_no_route():
    before = dict(wino.wino_conv3d_bias_relu.routes)
    assert set(before) == set(wino.WINO_ROUTES)
    wino.wino_conv3d_bias_relu(_x(8), _u(8, 8), torch.zeros(8))
    assert wino.wino_conv3d_bias_relu.routes == before


@pytest.mark.parametrize("ci,co,n_tile", [(24, 32, 48), (48, 64, 64),
                                          (32, 48, 48), (40, 24, 48),
                                          (136, 40, 48), (8, 8, 48)])
def test_u_images_hold_every_tap_slice(ci, co, n_tile):
    """Each tap slice of the images is u[t] transposed (K-major) and
    zero-padded; the 16-channel rest sits in its own image, at the channels
    the 32-channel slices do not hold (Ci = 48: 32-47; Ci = 40: 32-39 of a
    slice that starts at 24; Ci = 24: none, one zero-filled 32-slice)."""
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.normal(0, 1, (64, ci, co)).astype(np.float32))
    u = u.bfloat16()
    u32, u16 = wino.wino_images(u, n_tile)
    n_full, c0 = wgmma_slices(ci)
    # one box per step (A, B) and slice holds the step's four taps C
    assert u32.shape == (16, n_full, 4, n_tile, WGMMA_KC)
    assert u32.is_contiguous()
    w32, w16 = weight_images(u, n_tile)
    for ab, s, C in itertools.product(range(16), range(n_full), range(4)):
        assert torch.equal(u32[ab, s, C], w32[4 * ab + C, s])
    u32 = w32
    assert (u16 is None and w16 is None) or torch.equal(u16, w16)
    assert (u16 is None) == (c0 is None)
    assert (n_full, c0) == {24: (1, None), 48: (1, 32), 32: (1, None),
                            40: (1, 24), 136: (4, 120), 8: (0, 0)}[ci]
    held = min(ci, n_full * WGMMA_KC)  # channels the 32-channel slices hold
    ut = u.transpose(1, 2)                                 # (64, Co, Ci)
    # what the kernel multiplies channel by channel: slice s holds channels
    # 32 s .. 32 s + 31, the rest's image channels c0 .. c0 + 15
    width = max(n_full * WGMMA_KC, 0 if c0 is None else c0 + 16)
    eff = torch.zeros((64, n_tile, width), dtype=torch.float32)
    for s in range(n_full):
        eff[:, :, s * WGMMA_KC:(s + 1) * WGMMA_KC] += u32[:, s].float()
    if u16 is not None:
        assert u16.shape == (64, n_tile, 16)
        assert not u16[:, :, :held - c0].any()  # a 32-channel slice has them
        assert torch.equal(u16[:, :co, held - c0:ci - c0], ut[:, :, held:ci])
        eff[:, :, c0:c0 + 16] += u16.float()
    assert torch.equal(eff[:, :co, :ci], ut.float())
    assert not eff[:, co:].any() and not eff[:, :, ci:].any()


@pytest.mark.parametrize("blocks", [(16, 16, 16), (17, 17, 17), (5, 4, 17),
                                    (3, 3, 3), (1, 1, 100), (2, 3, 5),
                                    (7, 1, 9), (64, 1, 1), (1, 40, 2)])
def test_tiles_cover_the_block_grid_once(blocks):
    mz, my, mx = wino.wino_box(blocks)
    assert mz * my * mx <= wino.WINO_ROWS
    assert (2 * mz + 2) * (2 * my + 2) * (2 * mx + 2) <= wino.WINO_HALO_VOXELS
    assert mz <= blocks[0] and my <= blocks[1] and mx <= blocks[2]
    seen = np.zeros(blocks, np.int32)
    tiles = [range(0, e, m) for e, m in zip(blocks, (mz, my, mx))]
    for z0, y0, x0 in itertools.product(*tiles):
        # the kernel's rows: r -> (iz, iy, ix), masked past the tile and grid
        for r in range(wino.WINO_ROWS):
            ix, iy, iz = r % mx, (r // mx) % my, r // (mx * my)
            z, y, x = z0 + iz, y0 + iy, x0 + ix
            if iz < mz and z < blocks[0] and y < blocks[1] and x < blocks[2]:
                seen[z, y, x] += 1
    assert (seen == 1).all()


def test_stage_b_tiles_fill_the_gemm_rows():
    """The packed baseline's stage-B outputs: 32^3 voxels (16^3 blocks) fill
    all 64 rows of every tile; 34^3 (17^3 blocks, a prime) 71% of them."""
    assert wino.wino_box((16, 16, 16)) == (4, 4, 4)
    box = wino.wino_box((17, 17, 17))
    tiles = math.prod(-(-17 // m) for m in box)
    assert 17 ** 3 / (tiles * wino.WINO_ROWS) > 0.7


@pytest.mark.parametrize("co,widest,unit,want", [
    (64, 64, 8, [(0, 64)]),
    (136, 64, 8, [(0, 48), (48, 48), (96, 40)]),
    (192, 64, 8, [(0, 64), (64, 64), (128, 64)]),
    (72, 64, 8, [(0, 40), (40, 32)]),
    (129, 128, 16, [(0, 80), (80, 49)]),
    (7, 128, 16, [(0, 7)]),
])
def test_output_channel_blocks(co, widest, unit, want):
    got = wgmma_chunks(co, widest, unit)
    assert got == want
    assert all(n <= widest and c0 % unit == 0 for c0, n in got)
    assert sum(n for _, n in got) == co
    if widest == wino.WINO_N_TILES[-1]:  # each block fits one of the N tiles
        assert all(any(t >= n for t in wino.WINO_N_TILES) for _, n in got)


def _schedule_model(x, u, b, relu=True):
    """``wino_reference`` with the f32 sums in the wgmma kernel's order."""
    N, Do, Ho, Wo, Co = wino._check(x, u, b)
    dt, ci = x.dtype, x.shape[-1]
    md, mh, mw = Do // 2, Ho // 2, Wo // 2
    ud = u.to(dt)
    # the K steps of 16 channels, slice by slice; the 16-channel rest takes
    # only the channels no 32-channel slice holds
    n_full, c0 = wgmma_slices(ci)
    steps = [[(s * 32 + k, min(s * 32 + k + 16, ci)) for k in (0, 16)
              if s * 32 + k < ci] for s in range(n_full)]
    if c0 is not None:
        steps.append([(min(ci, n_full * 32), ci)])
    acc = [torch.zeros((N, md, mh, mw, Co)) for _ in range(8)]
    t1 = wino._bt(x, 1, md)
    for sl in steps:
        for A in range(4):
            t2 = wino._bt(t1[A], 2, mh)
            for B in range(4):
                v = wino._bt(t2[B], 3, mw)
                p0 = torch.zeros_like(acc[0])
                p1 = torch.zeros_like(acc[0])
                for lo, hi in sl:
                    m = [matmul_f32(v[C][..., lo:hi],
                                    ud[(A * 4 + B) * 4 + C][lo:hi])
                         for C in range(4)]
                    p0 = p0 + m[0]
                    p1 = p1 + m[1]
                    p0 = p0 + m[1]
                    p1 = p1 - m[2]
                    p0 = p0 + m[2]
                    p1 = p1 - m[3]
                for gz, sz in wino._AT_TERMS[A]:
                    for gy, sy in wino._AT_TERMS[B]:
                        g = (gz * 2 + gy) * 2
                        acc[g] = acc[g] + float(sz * sy) * p0
                        acc[g + 1] = acc[g + 1] + float(sz * sy) * p1
    y = torch.stack([a + b.to(dt).float() for a in acc])
    if relu:
        y = torch.relu(y)
    y = y.to(dt).reshape(2, 2, 2, N, md, mh, mw, Co)
    return y.permute(3, 4, 0, 5, 1, 6, 2, 7).reshape(N, Do, Ho, Wo, Co)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ci,co", [(32, 48), (48, 64), (24, 16), (40, 8),
                                   (72, 24)])
def test_kernel_sum_order_matches_the_plain_version(ci, co, dtype):
    rng = np.random.default_rng(ci + co)
    x = torch.from_numpy(np.maximum(rng.normal(0, 1, (2, 8, 10, 12, ci)), 0)
                         .astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(0, (27 * ci) ** -0.5, (3, 3, 3, ci, co))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, co).astype(np.float32))
    u = wino.wino_transform_weights(w)
    ref = wino.wino_reference(x, u, b)
    got = _schedule_model(x, u, b)
    assert got.shape == ref.shape and got.dtype == dtype
    err, ok = chip_smoke.wino_check(got, ref)
    assert ok, f"max |err| {err}"
    # the check still refuses a dropped tap in this order of sums
    u_drop = u.clone()
    u_drop[21] = 0
    _, bad = chip_smoke.wino_check(_schedule_model(x, u_drop, b), ref)
    assert not bad
