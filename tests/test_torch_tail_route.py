"""The decoder tail's route rule and the stage kernels' host-side layouts,
on the CPU.

``packed_tail`` / ``packed_tail2`` on a CUDA tensor pick one of four stage
kernels by a rule on dtype, channel counts and alignment (``tail_route``).
The wgmma kernel walks K in (tap, channel slice) steps (``tail_slices``),
reads the weights from images the wrapper lays out (``tail_weights``) and
owns one output box per tile (``tail_box``); the f32 kernel ("simt") is
handed its box and channel block by ``tail_simt_plan`` and its weights by
``tail_simt_weights`` (xa's slices, then xb's).  These are plain PyTorch
and Python, so they are held here; the f32 kernel's order of sums is held
against the JAX package in ``tests/test_torch_tail.py``.  The kernels
themselves run in ``tests/test_torch_cuda.py`` on the card.
"""

import math

import numpy as np
import pytest
import torch

from flypylib_tpu_torch.ops import tail
from flypylib_tpu_torch.ops.conv import (SIMT_SLICE, SIMT_SMEM, SIMT_VOXELS,
                                         simt_smem_bytes, simt_width)
from flypylib_tpu_torch.ops.tail import (TAIL_N_TILES, TAIL_ROUTES, TAIL_ROWS,
                                         TAIL_SIMT_STAGES, TAIL_SIMT_WIDEST,
                                         packed_tail,
                                         packed_tail2, tail_box, tail_route,
                                         tail_simt_plan, tail_simt_weights,
                                         tail_slices, tail_tile, tail_weights)


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


def _f32_view(c, off, shape=(2, 5, 6, 7)):
    """An f32 (*shape, c) tensor ``off`` elements past a 16-byte boundary."""
    n = math.prod(shape) * c
    flat = torch.zeros(n + 4, dtype=torch.float32)
    view = flat[off:off + n].view(*shape, c)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * off
    return view


@pytest.mark.parametrize("ca,cb,co,a_off,b_off,want", [
    (240, 0, 192, 0, 0, "simt"),   # K2's stage 0 on the main path
    (192, 48, 192, 0, 0, "simt"),  # K3's stage 0
    (192, 0, 192, 0, 0, "simt"),   # the stage after it
    (4, 0, 7, 0, 0, "simt"),       # one slice; any Co
    (20, 12, 44, 0, 0, "simt"),    # off the multiples of 8, on those of 4
    (5, 3, 7, 0, 0, "fma"),        # Ca and Cb off the multiples of 4
    (18, 0, 24, 0, 0, "fma"),      # Ca off
    (16, 6, 24, 0, 0, "fma"),      # Cb alone off
    (16, 8, 24, 1, 0, "fma"),      # xa 4 bytes off a 16-byte boundary
    (16, 8, 24, 0, 3, "fma"),      # xb 12 bytes off
])
def test_f32_route_rule(ca, cb, co, a_off, b_off, want):
    """f32 takes the f32 kernel ("simt") with Ca and Cb multiples of 4 and
    both operands on 16-byte boundaries (the TMA map's rules), else the
    first-version FMA kernel."""
    xa = _f32_view(ca, a_off)
    xb = _f32_view(cb, b_off) if cb else None
    assert tail_route(xa, xb, _w(ca, co)) == want


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


def _cover_count(out_dhw, box):
    """How often the f32 kernel's lanes write each output voxel: lane j*32
    + l of the block at (z0, y0, x0) holds box voxel i = j*32 + l, x
    fastest, masked past the box and the output."""
    bz, by, bx = box
    seen = np.zeros(out_dhw, np.int64)
    v = np.arange(SIMT_VOXELS)
    xx, yy, zz = v % bx, v // bx % by, v // bx // by
    for z0 in range(0, out_dhw[0], bz):
        for y0 in range(0, out_dhw[1], by):
            for x0 in range(0, out_dhw[2], bx):
                live = ((zz < bz) & (z0 + zz < out_dhw[0])
                        & (y0 + yy < out_dhw[1]) & (x0 + xx < out_dhw[2]))
                np.add.at(seen, (z0 + zz[live], y0 + yy[live], x0 + xx[live]),
                          1)
    return seen


@pytest.mark.parametrize("in_dhw,co", [
    ((9, 10, 11), 192), ((7, 12, 19), 192), ((5, 6, 37), 56), ((9, 9, 9), 8),
    ((4, 5, 6), 136), ((3, 3, 70), 10), ((2, 2, 2), 24), ((30, 3, 300), 64)])
def test_simt_plan_covers_every_output_voxel_once(in_dhw, co):
    """The f32 kernel's boxes for a stage: at most 256 voxels, bx a
    multiple of 8 (or the whole row below 8), the halo (one voxel past the
    box on each axis) within TMA's box and the ring within shared memory;
    every output voxel written by exactly one lane of one block."""
    out_dhw = tuple(e - 1 for e in in_dhw)
    bz, by, bx, width, smem = tail_simt_plan(in_dhw, co)
    assert bz * by * bx <= SIMT_VOXELS
    assert bz <= out_dhw[0] and by <= out_dhw[1]
    assert bx % 8 == 0 or bx == out_dhw[2] < 8
    assert max(bz, by, bx) + 1 <= 256
    assert smem == simt_smem_bytes((bz, by, bx), 1, width, 2,
                                   TAIL_SIMT_STAGES) <= SIMT_SMEM
    assert width == simt_width(co, TAIL_SIMT_WIDEST) <= TAIL_SIMT_WIDEST
    assert (_cover_count(out_dhw, (bz, by, bx)) == 1).all()


def test_simt_plan_at_the_main_path():
    """The 256^3 covering tile: stage 0 (132^3 cells in) and stage 1 (131^3)
    run 4 x 8 x 8 boxes, six blocks of 32 channels, a ring of four stages
    of 6.3 KB of halo and 4 KB of weights in 45 KB (three blocks an SM);
    the masked lanes are under 12% of a launch's."""
    for s in (132, 131):
        bz, by, bx, width, smem = tail_simt_plan((s,) * 3, 192)
        assert (bz, by, bx, width, smem) == (4, 8, 8, 32, 45 * 1024)
        tiles = math.prod(-(-(s - 1) // b) for b in (bz, by, bx))
        assert (s - 1) ** 3 / (tiles * SIMT_VOXELS) > 0.88


@pytest.mark.parametrize("ca,cb,co", [(240, 0, 192), (192, 48, 192),
                                      (4, 0, 8), (20, 12, 44), (48, 16, 136),
                                      (8, 4, 10)])
def test_simt_weight_image_holds_wa_then_wb_and_zeros_past_co(ca, cb, co):
    rng = np.random.default_rng(ca + cb + co)
    wa = torch.from_numpy(rng.normal(0, 1, (2, 2, 2, ca, co)).astype(np.float32))
    wb = torch.from_numpy(rng.normal(0, 1, (2, 2, 2, cb, co)).astype(np.float32))
    width = simt_width(co, TAIL_SIMT_WIDEST)
    img = tail_simt_weights(wa, wb if cb else None, width)
    n_cb = -(-co // width)
    k = (ca + cb) // SIMT_SLICE
    assert img.shape == (n_cb, k, 8, width // 8, SIMT_SLICE, 8)
    assert img.dtype == torch.float32 and img.is_contiguous()
    # img[cb, s, tap, g, c, k] = [wa; wb][tap, 4 s + c, cb * width + 8 g + k]
    back = img.permute(2, 1, 4, 0, 3, 5).reshape(8, ca + cb, n_cb * width)
    assert torch.equal(back[:, :ca, :co], wa.reshape(8, ca, co))
    assert torch.equal(back[:, ca:, :co], wb.reshape(8, cb, co))
    assert not back[..., co:].any()


# -- one stage for any Co: the packed engines' conv + bias + ReLU -----------
@pytest.mark.parametrize("co,want", [
    (192, (1, 192, 192)),   # the U-Net's level 0, the baseline's L0
    (256, (2, 128, 128)),   # the baseline's stage-A L1
    (384, (2, 192, 192)),   # the U-Net's level 1
    (768, (4, 192, 192)),   # the U-Net's bottleneck
    (8, (1, 8, 32)), (200, (2, 104, 128)), (776, (5, 160, 192)),
])
def test_stage_slice_plan(co, want):
    """ceil(Co / 192) slices of Co / n rounded up to a multiple of 8, each
    on the smallest N tile that holds it; the slices cover Co, the last
    one holding the rest."""
    n, width, n_tile = tail.stage_slices(co)
    assert (n, width, n_tile) == want
    assert n == -(-co // TAIL_N_TILES[-1]) and width % 8 == 0
    assert n_tile == tail_tile(width) and (n - 1) * width < co <= n * width


def _stage_operands(ci, co, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0, (8 * ci) ** -0.5, (2, 2, 2, ci, co))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, co).astype(np.float32))
    return w, b


def _slice_weight(sw, s, ci):
    """Slice ``s``'s (2, 2, 2, Ci, n_tile) weight, read back from its
    images the way the kernel's K steps sum them (:func:`tail_slices`)."""
    got = torch.zeros((8, ci + 32, sw.n_tile))
    i32 = i16 = 0
    for _, c0, n in tail_slices(ci):
        if n == 32:
            img, i32 = sw.w32[s, :, i32], i32 + 1
        else:
            img, i16 = sw.w16[s, :, i16], i16 + 1
        got[:, c0:c0 + n] += img.float().transpose(1, 2)
    return got[:, :ci].reshape(2, 2, 2, ci, sw.n_tile)


@pytest.mark.parametrize("ci,co", [(8, 192), (192, 256), (192, 384),
                                   (384, 768), (24, 200), (48, 776)])
def test_each_slice_image_is_the_whole_images_rows(ci, co):
    """The stacked images of :func:`stage_weights`: slice s's rows are the
    whole weight's image rows of output channels s * width onwards (one
    N tile that holds all of Co, :func:`tail_weights`' layout), zero past
    the slice's channels; the bias is the bf16 bias."""
    w, b = _stage_operands(ci, co)
    sw = tail.stage_weights(w, b)
    n, width, n_tile = tail.stage_slices(co)
    whole = tail_weights(w, None, co)
    for img, full in zip((sw.w32, sw.w16), whole):
        assert (img is None) == (full is None)
        if img is None:
            continue
        assert img.shape == (n, *full.shape[:2], n_tile, full.shape[3])
        assert img.dtype == torch.bfloat16 and img.is_contiguous()
        for s in range(n):
            cs = min(width, co - s * width)
            assert torch.equal(img[s, :, :, :cs],
                               full[:, :, s * width:s * width + cs])
            assert not img[s, :, :, cs:].any()
    assert sw.b.dtype == torch.bfloat16 and torch.equal(sw.b,
                                                        b.to(torch.bfloat16))
    assert torch.equal(sw.w, w.to(torch.bfloat16))


@pytest.mark.parametrize("ci,co", [(8, 256), (192, 256), (16, 384),
                                   (24, 200)])
def test_sliced_stage_equals_the_unsliced_bit_for_bit(ci, co):
    """Each slice as the kernel reads it (its images summed back into a
    weight), run through :func:`tail_reference` with its part of the bias,
    and the slices' outputs laid side by side: bit for bit the unsliced
    stage, as is :func:`stage_bias_relu`'s plain version."""
    w, b = _stage_operands(ci, co, seed=co)
    x = torch.from_numpy(np.maximum(np.random.default_rng(ci).normal(
        0, 1, (2, 4, 5, 3, ci)), 0).astype(np.float32)).to(torch.bfloat16)
    sw = tail.stage_weights(w, b)
    n, width, _ = tail.stage_slices(co)
    whole = tail.tail_reference(x, [(w, b)])
    parts = []
    for s in range(n):
        cs = min(width, co - s * width)
        ws = _slice_weight(sw, s, ci)[..., :cs]
        parts.append(tail.tail_reference(
            x, [(ws, sw.b[s * width:s * width + cs])]))
    assert torch.equal(torch.cat(parts, dim=-1), whole)
    before = tail.stage_bias_relu.launches
    assert torch.equal(tail.stage_bias_relu(x, sw), whole)
    assert tail.stage_bias_relu.launches == before  # the CPU launches none


def test_stage_bias_relu_checks_its_operands():
    w, b = _stage_operands(16, 24)
    sw = tail.stage_weights(w, b)
    with pytest.raises(ValueError, match="channels"):
        tail.stage_bias_relu(_x(8), sw)
    with pytest.raises(ValueError, match="chain depth"):
        tail.stage_bias_relu(_x(16, shape=(1, 1, 4, 4)), sw)


def test_card_launches_are_operators():
    """The card's launches of K2's stage kernel and of K5 are the operators
    ``fpl::stage_bias_relu`` and ``fpl::parity_split``, so ``torch.profiler``
    ties their kernels to the ranges around the call; each is registered
    for CUDA alone (a CPU tensor runs the reference)."""
    import flypylib_tpu_torch.ops.split  # noqa: F401  (fpl::parity_split)

    has = torch._C._dispatch_has_kernel_for_dispatch_key
    for op in ("fpl::stage_bias_relu", "fpl::parity_split"):
        assert has(op, "CUDA") and not has(op, "CPU"), op
