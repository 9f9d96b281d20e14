"""The packed U-Net's helpers and decoder-tail kernels in the port
(``flypylib_tpu_torch.ops.packed_conv`` / ``packed_unet`` / ``tail``)
against the JAX package, on the same inputs.

- Pack helpers are permutations, crops and maxima: equal bitwise.
- K2 (``packed_tail``) and K3 (``packed_tail2``): on the CPU the port's
  wrappers run their plain versions, held against the JAX kernels in
  interpret mode (as ``tests/test_pallas_tail.py`` runs them) and against
  JAX's ``tail_reference``.  Tolerance rtol = atol = 2e-2 in bf16 (the JAX
  test's: the f32 sums round to bf16 at stage boundaries in different
  orders) and 1e-5 in f32 (f32 summation order only).
- The f32 stage kernel ("simt", ``csrc/conv3d_f32.cu``) sums in its own
  order (slice of 4 channels, xa's then xb's, tap, channel, on FMAs);
  ``_simt_stage_model`` spells that order out in numpy from the weight
  image the wrapper lays out and is held against the plain versions and
  the JAX kernels in interpret mode within ``chip_smoke``'s f32 limit
  (1e-4 of max |ref|), which must still refuse a tap dropped in that
  order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from flypylib_tpu.ops import packed_conv as j_pc
from flypylib_tpu.ops import packed_unet as j_pu
from flypylib_tpu.ops import pallas_tail as j_tail
from flypylib_tpu_torch.ops import packed_conv as t_pc
from flypylib_tpu_torch.ops import packed_unet as t_pu
from flypylib_tpu_torch.ops import tail as t_tail
from flypylib_tpu_torch.ops.conv import SIMT_SLICE

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
BLOCK = (1, 1, 1 << 30)  # the fastest block in interpret mode on a CPU


def _both(a, jdt, tdt):
    """numpy f32 -> (jax array, torch tensor), both rounded to the dtype."""
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


# -- pack helpers: bitwise ----------------------------------------------------
def _volumes(rng, shape):
    a = rng.random(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _pack_cases(rng):
    jx, tx = _volumes(rng, (2, 8, 10, 12, 24))
    return [(j_pc.pack_volume(jx), t_pc.pack_volume(tx)),
            (j_pc.pack_volume_iv(jx), t_pc.pack_volume(tx))]


def _unpack_cases(rng):
    jx, tx = _volumes(rng, (2, 4, 6, 8, 24))
    return [(j_pc.unpack_volume(jx), t_pc.unpack_volume(tx)),
            (j_pc.unpack_volume_iv(jx), t_pc.unpack_volume(tx))]


def _pool_cases(rng):
    jx, tx = _volumes(rng, (2, 8, 10, 12, 24))
    return [(j_pu.parity_group_max(jx), t_pu.parity_group_max(tx)),
            (j_pu.pool_pack(jx), t_pu.pool_pack(tx)),
            (j_pu.pool_pack(jx, grad_exact=True), t_pu.pool_pack(tx))]


def _weight_cases(rng):
    w = rng.normal(size=(3, 3, 3, 5, 7)).astype(np.float32)
    k = rng.normal(size=(2, 2, 2, 6, 5)).astype(np.float32)
    cases = [(j_pu.convT_packed_weight(jnp.asarray(k)),
              t_pu.convT_packed_weight(torch.from_numpy(k)))]
    for jdt, tdt, _ in DTYPES.values():
        jw, tw = _both(w, jdt, tdt)
        cases.append((j_pc.pack_weight_d1(jw), t_pc.pack_weight_d1(tw)))
    return cases


HELPERS = {"pack_volume": _pack_cases, "unpack_volume": _unpack_cases,
           "pool_pack": _pool_cases, "weights": _weight_cases}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_pack_helpers_equal_jax_bitwise(rng, name):
    for want, got in HELPERS[name](rng):
        assert tuple(got.shape) == want.shape
        assert got.dtype == {jnp.float32: torch.float32,
                             jnp.bfloat16: torch.bfloat16}[want.dtype.type]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("starts,sizes", [
    ((2, 4, 0), (8, 6, 10)),   # even starts
    ((1, 3, 5), (8, 6, 4)),    # odd starts (parity swap)
    ((1, 2, 3), (10, 8, 6)),   # mixed
], ids=["even", "odd", "mixed"])
def test_crop_packed_equals_jax_bitwise(rng, starts, sizes):
    full = rng.random((2, 12, 14, 16, 3)).astype(np.float32)
    jx = j_pc.pack_volume(jnp.asarray(full))
    tx = t_pc.pack_volume(torch.from_numpy(full))
    got = t_pu.crop_packed(tx, starts, sizes)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_pu.crop_packed(jx, starts, sizes)))
    # and it is the unpack -> crop -> repack it stands for
    sl = tuple(slice(s, s + n) for s, n in zip(starts, sizes))
    want = t_pc.pack_volume(t_pc.unpack_volume(tx)[(slice(None), *sl)])
    assert torch.equal(got, want)


def test_pack_helpers_reject_what_jax_rejects():
    x = torch.zeros((1, 8, 9, 8, 2))
    with pytest.raises(ValueError, match="even"):
        t_pc.pack_volume(x)
    with pytest.raises(ValueError, match="even"):
        t_pu.pool_pack(torch.zeros((1, 4, 3, 4, 16)))
    with pytest.raises(ValueError, match="even"):
        t_pu.crop_packed(torch.zeros((1, 4, 4, 4, 8)), (0, 0, 0), (3, 4, 4))
    with pytest.raises(ValueError, match="outside"):
        t_pu.crop_packed(torch.zeros((1, 4, 4, 4, 8)), (1, 0, 0), (8, 4, 4))


# -- K2 and K3: plain versions against the JAX kernels ------------------------
CHAINS = {
    # the cases of tests/test_pallas_tail.py
    "logits-24-32-32": ((12, 13, 14), (24, 32, 32), True),
    "logits-8-16-8": ((10, 10, 18), (8, 16, 8), True),
    "logits-8-8-8": ((9, 9, 9), (8, 8, 8), True),
    "no-logits-3-stages": ((11, 12, 13), (16, 24, 16, 8), False),
    "single-stage": ((6, 7, 8), (8, 8), False),
}


def _chain(rng, chans, logits, jdt, tdt):
    stages_j, stages_t = [], []
    for ci, co in zip(chans[:-1], chans[1:]):
        w = rng.normal(0, 0.1, (2, 2, 2, ci, co)).astype(np.float32)
        b = rng.normal(0, 0.1, (co,)).astype(np.float32)
        (jw, tw), (jb, tb) = _both(w, jdt, tdt), _both(b, jdt, tdt)
        stages_j.append((jw, jb))
        stages_t.append((tw, tb))
    if not logits:
        return stages_j, stages_t, None, None
    wl = rng.normal(0, 0.1, (chans[-1], 16)).astype(np.float32)
    bl = rng.normal(0, 1, 8).astype(np.float32)
    jwl, twl = _both(wl, jdt, tdt)
    return (stages_j, stages_t, (jwl, jnp.asarray(bl)),
            (twl, torch.from_numpy(bl)))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CHAINS))
def test_packed_tail_plain_matches_jax(rng, case, dt):
    shape, chans, with_logits = CHAINS[case]
    jdt, tdt, tol = DTYPES[dt]
    x = rng.normal(0, 1, (*shape, chans[0])).astype(np.float32)
    jx, tx = _both(x, jdt, tdt)
    sj, st, lj, lt = _chain(rng, chans, with_logits, jdt, tdt)
    before = t_tail.packed_tail.launches
    got = t_tail.packed_tail(tx[None], st, lt)
    assert t_tail.packed_tail.launches == before  # the CPU launches nothing
    n = len(st)
    want_dtype = torch.float32 if with_logits else tdt
    assert got.dtype == want_dtype
    assert got.shape == (1, *(s - n for s in shape),
                         8 if with_logits else chans[-1])
    assert torch.equal(got, t_tail.tail_reference(tx[None], st, lt))
    for want in (j_tail.packed_tail(jx, sj, lj, block=BLOCK, interpret=True),
                 j_tail.tail_reference(jx, sj, lj)):
        np.testing.assert_allclose(got[0].float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("n_after,with_logits", [(0, False), (1, True), (2, False)],
                         ids=["fold", "fold-stage-logits", "fold-2-stages"])
def test_packed_tail2_plain_matches_jax(rng, n_after, with_logits, dt):
    jdt, tdt, tol = DTYPES[dt]
    shape, ca, cb, co = (9, 10, 11), 16, 8, 24
    xa = rng.normal(0, 1, (*shape, ca)).astype(np.float32)
    xb = rng.normal(0, 1, (*shape, cb)).astype(np.float32)
    wa = rng.normal(0, 0.1, (2, 2, 2, ca, co)).astype(np.float32)
    wb = rng.normal(0, 0.1, (2, 2, 2, cb, co)).astype(np.float32)
    b0 = rng.normal(0, 0.1, (co,)).astype(np.float32)
    (jxa, txa), (jxb, txb) = _both(xa, jdt, tdt), _both(xb, jdt, tdt)
    s0j, s0t = zip(*(_both(a, jdt, tdt) for a in (wa, wb, b0)))
    sj, st, lj, lt = _chain(rng, (co,) * (n_after + 1), with_logits, jdt, tdt)
    before = t_tail.packed_tail2.launches
    got = t_tail.packed_tail2(txa[None], txb[None], s0t, st, lt)
    assert t_tail.packed_tail2.launches == before
    assert torch.equal(got, t_tail.tail2_reference(txa[None], txb[None], s0t,
                                                   st, lt))
    want = j_tail.packed_tail2(jxa, jxb, s0j, sj, lj, block=BLOCK,
                               interpret=True)
    assert tuple(got.shape[1:]) == want.shape
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)
    # K3 is K2 on the concat with the stacked weights
    cat = t_tail.packed_tail(
        torch.cat([txa, txb], -1)[None],
        [(torch.cat([s0t[0], s0t[1]], 3), s0t[2])] + st, lt)
    np.testing.assert_allclose(got.float().numpy(), cat.float().numpy(),
                               rtol=tol, atol=tol)


def _errors(x, stages, logits):
    """(jax error type or None, port error type or None)."""
    out = []
    for fn in (lambda: j_tail.packed_tail(jnp.asarray(x), stages[0], logits[0],
                                          interpret=True),
               lambda: t_tail.packed_tail(torch.from_numpy(x)[None], stages[1],
                                          logits[1])):
        try:
            fn()
            out.append(None)
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            out.append(type(e))
    return out


@pytest.mark.parametrize("case", ["bad-kernel-shape", "too-small-input",
                                  "bad-logits-shape"])
def test_packed_tail_rejects_what_jax_rejects(rng, case):
    x = rng.normal(size=(8, 8, 8, 8)).astype(np.float32)
    w = rng.normal(size=(2, 2, 2, 8, 8)).astype(np.float32)
    b = np.zeros(8, np.float32)
    stages = ([(jnp.asarray(w), jnp.asarray(b))],
              [(torch.from_numpy(w), torch.from_numpy(b))])
    logits = (None, None)
    if case == "bad-kernel-shape":
        w3 = rng.normal(size=(3, 3, 3, 8, 8)).astype(np.float32)
        stages = ([(jnp.asarray(w3), jnp.asarray(b))],
                  [(torch.from_numpy(w3), torch.from_numpy(b))])
    elif case == "too-small-input":
        x = x[:2]
        stages = (stages[0] * 2, stages[1] * 2)
    else:
        wl = np.zeros((8, 12), np.float32)
        logits = ((jnp.asarray(wl), jnp.zeros(8, jnp.float32)),
                  (torch.from_numpy(wl), torch.zeros(8)))
    assert _errors(x, stages, logits) == [ValueError, ValueError]


def test_packed_tail2_rejections():
    z = torch.zeros
    xa, xb = z((1, 5, 5, 5, 8)), z((1, 5, 5, 5, 4))
    s0 = (z((2, 2, 2, 8, 6)), z((2, 2, 2, 4, 6)), z(6))
    with pytest.raises(ValueError, match="2\\^3"):
        t_tail.packed_tail2(xa, xb, (z((3, 3, 3, 8, 6)), s0[1], s0[2]))
    with pytest.raises(ValueError, match="output width"):
        t_tail.packed_tail2(xa, xb, (s0[0], z((2, 2, 2, 4, 5)), s0[2]))
    with pytest.raises(ValueError, match="operand shapes differ"):
        t_tail.packed_tail2(xa, z((1, 5, 5, 4, 4)), s0)
    with pytest.raises(ValueError, match="chain depth"):
        t_tail.packed_tail2(xa[:, :2], xb[:, :2], s0, [(z((2, 2, 2, 6, 6)), z(6))])
    with pytest.raises(ValueError, match="channels"):
        t_tail.packed_tail2(xa, xb, s0, [(z((2, 2, 2, 5, 6)), z(6))])
    assert t_tail.packed_tail2(xa, xb, s0).shape == (1, 4, 4, 4, 6)


# -- the f32 stage kernel's order of sums ----------------------------------------
def _simt_stage_model(xa, xb, wa, wb, b, drop_tap=None):
    """One f32 stage on ``xa`` (B, D, H, W, Ca) [and ``xb``] in the f32
    kernel's order of sums, in numpy: every output channel's f32
    accumulator takes acc = fma(x, w, acc) slice by slice (4 channels, xa's
    then xb's), tap by tap (tz, ty, tx), channel by channel, with the
    weights read from ``tail_simt_weights``' image (an FMA modelled as the
    exact f64 product plus acc, rounded once to f32); then the f32 bias and
    ReLU.  ``drop_tap`` leaves that tap's weights out."""
    B, D, H, W, _ = xa.shape
    co = wa.shape[-1]
    width = t_tail.tail_simt_plan((D, H, W), co)[3]
    img = t_tail.tail_simt_weights(
        torch.from_numpy(wa), None if xb is None else torch.from_numpy(wb),
        width).numpy().astype(np.float64)
    x = xa if xb is None else np.concatenate([xa, xb], axis=-1)
    acc = np.zeros((B, D - 1, H - 1, W - 1, img.shape[0] * width), np.float32)
    for s in range(img.shape[1]):
        for tap in range(8):
            if tap == drop_tap:
                continue
            tz, ty, tx = tap // 4, tap // 2 % 2, tap % 2
            win = x[:, tz:tz + D - 1, ty:ty + H - 1,
                    tx:tx + W - 1].astype(np.float64)
            for c in range(SIMT_SLICE):
                wv = img[:, s, tap, :, c, :].reshape(-1)  # cb * width + 8 g + k
                acc = (win[..., SIMT_SLICE * s + c, None] * wv
                       + acc).astype(np.float32)
    return np.maximum(acc[..., :co] + b, np.float32(0))


SIMT_CHAINS = {
    # label: (shape, Ca, Cb, channels of the stages after the first, logits)
    "K2-12-16-8-logits": ((7, 8, 9), 12, 0, (16, 8), True),
    "K2-8-20": ((6, 7, 8), 8, 0, (20,), False),
    "K3-16+8-24-24-logits": ((9, 10, 11), 16, 8, (24, 24), True),
    "K3-8+4-10": ((6, 7, 9), 8, 4, (10,), False),
}


@pytest.mark.parametrize("case", sorted(SIMT_CHAINS))
def test_simt_sum_order_matches_jax(rng, case):
    """K2 / K3 chains in f32, every stage in the f32 kernel's order of sums
    (the logits as the port's plain version sums them), against the port's
    plain version and the JAX kernel in interpret mode, within chip_smoke's
    f32 limit; stage 0 with its centre tap dropped must fail it."""
    shape, ca, cb, chans, with_logits = SIMT_CHAINS[case]
    xa = np.maximum(rng.normal(0, 1, (1, *shape, ca)), 0).astype(np.float32)
    xb = (np.maximum(rng.normal(0, 1, (1, *shape, cb)), 0).astype(np.float32)
          if cb else None)
    k = 8 * (ca + cb)
    wa = rng.normal(0, k ** -0.5, (2, 2, 2, ca, chans[0])).astype(np.float32)
    wb = (rng.normal(0, k ** -0.5, (2, 2, 2, cb, chans[0])).astype(np.float32)
          if cb else None)
    b0 = rng.normal(0, 0.1, chans[0]).astype(np.float32)
    stages = [(rng.normal(0, (8 * ci) ** -0.5, (2, 2, 2, ci, co))
               .astype(np.float32), rng.normal(0, 0.1, co).astype(np.float32))
              for ci, co in zip(chans[:-1], chans[1:])]
    lg = None
    if with_logits:
        lg = (rng.normal(0, chans[-1] ** -0.5, (chans[-1], 16))
              .astype(np.float32), rng.normal(0, 1, 8).astype(np.float32))
    assert t_tail.tail_route(torch.from_numpy(xa),
                             None if xb is None else torch.from_numpy(xb),
                             torch.from_numpy(wa)) == "simt"

    def model(drop_tap=None):
        cur = _simt_stage_model(xa, xb, wa, wb, b0, drop_tap)
        for w, b in stages:
            cur = _simt_stage_model(cur, None, w, None, b)
        if lg is None:
            return torch.from_numpy(cur)
        return t_tail.logits_reference(torch.from_numpy(cur),
                                       *map(torch.from_numpy, lg))

    t = torch.from_numpy
    st = [(t(w), t(b)) for w, b in stages]
    lt = None if lg is None else (t(lg[0]), t(lg[1]))
    sj = [(jnp.asarray(w), jnp.asarray(b)) for w, b in stages]
    lj = None if lg is None else (jnp.asarray(lg[0]), jnp.asarray(lg[1]))
    if xb is None:
        plain = t_tail.tail_reference(t(xa), [(t(wa), t(b0))] + st, lt)
        jax_out = j_tail.packed_tail(jnp.asarray(xa[0]),
                                     [(jnp.asarray(wa), jnp.asarray(b0))] + sj,
                                     lj, block=BLOCK, interpret=True)
    else:
        plain = t_tail.tail2_reference(t(xa), t(xb), (t(wa), t(wb), t(b0)),
                                       st, lt)
        jax_out = j_tail.packed_tail2(
            jnp.asarray(xa[0]), jnp.asarray(xb[0]),
            (jnp.asarray(wa), jnp.asarray(wb), jnp.asarray(b0)), sj, lj,
            block=BLOCK, interpret=True)
    got = model()
    for ref in (plain, torch.from_numpy(np.array(jax_out, np.float32))[None]):
        assert got.shape == ref.shape and got.dtype == torch.float32
        err, ok = chip_smoke.tail_check(got, ref, torch.float32)
        assert ok, f"max |err| {err}"
    _, bad = chip_smoke.tail_check(model(drop_tap=7), plain, torch.float32)
    assert not bad
