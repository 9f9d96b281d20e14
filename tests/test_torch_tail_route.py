"""The decoder tail's route rule and the wgmma stage kernel's host-side
layout, on the CPU.

``packed_tail`` / ``packed_tail2`` on a CUDA tensor pick one of three stage
kernels by a rule on dtype, channel counts and alignment (``tail_route``).
The wgmma kernel walks K in (tap, channel slice) steps (``tail_slices``),
reads the weights from images the wrapper lays out (``tail_weights``) and
owns one output box per tile (``tail_box``); these are plain PyTorch and
Python, so they are held here.  The kernels themselves run in
``tests/test_torch_cuda.py`` on the card.
"""

import math

import numpy as np
import pytest
import torch

from flypylib_tpu_torch.ops import tail
from flypylib_tpu_torch.ops.tail import (TAIL_N_TILES, TAIL_ROUTES, TAIL_ROWS,
                                         packed_tail, packed_tail2, tail_box,
                                         tail_route, tail_slices, tail_tile,
                                         tail_weights)


def _x(c, dtype=torch.bfloat16, shape=(2, 5, 6, 7)):
    return torch.zeros((*shape, c), dtype=dtype)


def _w(ci, co):
    return torch.zeros((2, 2, 2, ci, co))


@pytest.mark.parametrize("ca,cb,co", [
    (240, 0, 192), (192, 48, 192), (192, 0, 192),   # the main path's stages
    (8, 0, 8), (16, 8, 24), (40, 24, 56), (64, 0, 128),
])
def test_aligned_bf16_multiples_of_8_take_wgmma(ca, cb, co):
    xb = _x(cb) if cb else None
    assert tail_route(_x(ca), xb, _w(ca, co)) == "wgmma"


@pytest.mark.parametrize("ca,cb,co", [
    (20, 12, 40),    # Ca, Cb off the multiples of 8
    (16, 0, 20),     # Co off the multiples of 8
    (16, 4, 16),     # Cb alone off
    (64, 0, 200),    # Co past the widest N tile
    (64, 0, 256),
])
def test_other_bf16_stages_take_wmma(ca, cb, co):
    xb = _x(cb) if cb else None
    assert tail_route(_x(ca), xb, _w(ca, co)) == "wmma"


def test_f32_takes_fma_whatever_the_widths():
    for ca, cb, co in ((240, 0, 192), (192, 48, 192), (5, 3, 7)):
        xb = _x(cb, torch.float32) if cb else None
        assert tail_route(_x(ca, torch.float32), xb, _w(ca, co)) == "fma"


def test_an_operand_off_a_16_byte_boundary_takes_wmma():
    n = 2 * 5 * 6 * 7 * 16
    flat = torch.zeros(n + 8, dtype=torch.bfloat16)
    off = flat[1:n + 1].view(2, 5, 6, 7, 16)
    on = flat[8:].view(2, 5, 6, 7, 16)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    assert tail_route(off, None, _w(16, 16)) == "wmma"
    assert tail_route(on, None, _w(16, 16)) == "wgmma"
    assert tail_route(on, off, _w(16, 16)) == "wmma"
    assert tail_route(on, _x(16), _w(16, 16)) == "wgmma"


def test_cpu_calls_count_no_route():
    before = (dict(packed_tail.routes), dict(packed_tail2.routes))
    assert set(before[0]) == set(before[1]) == set(TAIL_ROUTES)
    x, b = _x(8, torch.float32), torch.zeros(8)
    packed_tail(x, [(_w(8, 8), b)])
    packed_tail2(x, x, (_w(8, 8), _w(8, 8), b))
    assert (packed_tail.routes, packed_tail2.routes) == before


def test_slice_plans_of_the_main_path():
    # K3's stage 0: six 32-channel slices of xa, a 32- and a 16-channel
    # slice of xb
    assert tail_slices(192, 48) == [
        *(("a", 32 * i, 32) for i in range(6)), ("b", 0, 32), ("b", 32, 16)]
    # K2's stage 0: seven slices and a 16-channel rest
    assert tail_slices(240) == [*(("a", 32 * i, 32) for i in range(7)),
                                ("a", 224, 16)]
    assert tail_slices(192) == [("a", 32 * i, 32) for i in range(6)]


@pytest.mark.parametrize("ca,cb", [(8, 0), (16, 8), (24, 0), (40, 24),
                                   (48, 48), (56, 16), (192, 48), (240, 0)])
def test_slices_cover_every_channel(ca, cb):
    """Each operand's channels all lie in a slice; a rest of 1-16 channels
    is one 16-channel slice ending at C, a rest of 17-31 one more 32-channel
    slice; the steps move C rounded up to a multiple of 16."""
    steps = tail_slices(ca, cb)
    for name, c in (("a", ca), ("b", cb)):
        mine = [(c0, n) for op, c0, n in steps if op == name]
        covered = set()
        for c0, n in mine:
            covered |= set(range(c0, c0 + n))
        assert set(range(c)) <= covered
        assert sum(n for _, n in mine) == -(-c // 16) * 16
        halves = [(c0, n) for c0, n in mine if n == 16]
        assert len(halves) == (0 < c % 32 <= 16)
        assert all(c0 == max(c - 16, 0) for c0, _ in halves)
    assert [op for op, _, _ in steps] == sorted(op for op, _, _ in steps)


@pytest.mark.parametrize("ca,cb,co", [(192, 48, 192), (240, 0, 192),
                                      (192, 0, 192), (40, 24, 56), (8, 8, 8),
                                      (16, 0, 24), (48, 16, 40)])
def test_weight_images_hold_wa_wb_and_zeros_elsewhere(ca, cb, co):
    rng = np.random.default_rng(ca + cb)
    wa = torch.from_numpy(rng.normal(0, 1, (2, 2, 2, ca, co)).astype(np.float32))
    wb = torch.from_numpy(rng.normal(0, 1, (2, 2, 2, cb, co)).astype(np.float32))
    n_tile = tail_tile(co)
    w32, w16 = tail_weights(wa, wb if cb else None, n_tile)
    steps = tail_slices(ca, cb)
    n32 = sum(n == 32 for _, _, n in steps)
    n16 = sum(n == 16 for _, _, n in steps)
    assert (w32 is None) == (n32 == 0) and (w16 is None) == (n16 == 0)
    if w32 is not None:
        assert w32.shape == (8, n32, n_tile, 32)
        assert w32.dtype == torch.bfloat16 and w32.is_contiguous()
    if w16 is not None:
        assert w16.shape == (8, n16, n_tile, 16)
        assert w16.dtype == torch.bfloat16 and w16.is_contiguous()
    # what the K steps sum for each (tap, operand, channel, o), tap = 4 tz +
    # 2 ty + tx: every weight exactly once (the weights are nonzero, so a
    # channel held by two slices would count twice), zero past C and Co
    got = {"a": torch.zeros((8, ca + 32, n_tile)),
           "b": torch.zeros((8, cb + 32, n_tile))}
    i32 = i16 = 0
    for op, c0, n in steps:
        if n == 32:
            img, i32 = w32[:, i32], i32 + 1
        else:
            img, i16 = w16[:, i16], i16 + 1
        got[op][:, c0:c0 + n] += img.float().transpose(1, 2)
    for op, w, c in (("a", wa, ca), ("b", wb, cb)):
        want = w.to(torch.bfloat16).float().reshape(8, c, co)
        assert torch.equal(got[op][:, :c, :co], want)
        assert not got[op][:, c:].any() and not got[op][..., co:].any()
    # the same through an einsum of the stacked [wa; wb] against one-hot
    # channels: the image row of (tap, o) dotted with a unit input
    stacked = torch.cat([wa, wb], dim=3).to(torch.bfloat16).float()
    total = torch.cat([got["a"][:, :ca, :co], got["b"][:, :cb, :co]], dim=1)
    eye = torch.eye(ca + cb)
    assert torch.equal(torch.einsum("kc,tco->tko", eye, total),
                       stacked.reshape(8, ca + cb, co))


def test_n_tile():
    assert [tail_tile(co) for co in (8, 32, 40, 64, 72, 96, 128, 136, 192)] == [
        32, 32, 64, 64, 96, 96, 128, 192, 192]
    assert TAIL_N_TILES[-1] == 192
    with pytest.raises(ValueError, match="Co"):
        tail_tile(200)


@pytest.mark.parametrize("extents", [(131, 131, 131), (130, 130, 130),
                                     (129, 131, 130), (66, 66, 66),
                                     (8, 9, 10), (1, 1, 300), (300, 1, 1),
                                     (3, 2, 1), (1, 1, 1), (5, 7, 200)])
def test_box_fits_the_tile_and_wastes_little(extents):
    bz, by, bx = tail_box(extents)
    assert bz * by * bx <= TAIL_ROWS and max(bz, by, bx) <= 256
    tiles = math.prod(-(-e // b) for e, b in zip(extents, (bz, by, bx)))
    if min(extents) >= 129:  # the main path: the masked ragged edge
        assert tiles * TAIL_ROWS / math.prod(extents) - 1 < 0.06


def test_rows_per_block_is_one_the_kernel_builds():
    assert TAIL_ROWS == 192  # three m64 row blocks
    assert tail.TAIL_MAX_LOGITS == 8
