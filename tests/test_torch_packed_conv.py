"""The port's packed ConvStack engine (``flypylib_tpu_torch.ops.packed_conv``:
the parity relayouts, ``PackedConvStack``, ``packed_spec``; and K5's plain
version in ``ops.split``) against the JAX package on the same params and
inputs.

Tolerances:
- the parity relayouts and K5's plain version are copies: bitwise equal;
- ``PackedConvStack`` vs the JAX ``PackedConvStack.apply`` in f32: rtol
  1e-4, atol 1e-5 (f32 summation order; the JAX engine's split-weight
  logits are exact in f32, its ``lo`` half being 0);
- ``PackedConvStack`` vs the port's plain ``ConvStack`` in f32: 2e-4, the
  reference's own packed-vs-plain tolerance (``tests/test_packed_conv.py``);
- ``PackedConv`` (stage B's convs under grad, input gradient by a forward
  conv): its forward, and every forward without grad, bitwise the call the
  engine made before it; its gradients those of autograd through that call,
  to f32 summation order (rtol 1e-5 of the largest) in f32, to one rounding
  (one bf16 ulp of the largest) in bf16, and exact algebra by an f64
  ``gradcheck`` with the f32 conv swapped for an f64 one.
The JAX Pallas split runs in interpret mode, as the JAX package's own test
runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
import flypylib_tpu_torch as tpt
from flypylib_tpu.models import zoo as jzoo
from flypylib_tpu.ops import packed_conv as jpc
from flypylib_tpu.ops.pallas_split import parity_split_pallas, parity_split_xla
from flypylib_tpu_torch.models import zoo as tzoo
from flypylib_tpu_torch.ops import packed_conv as tpc
from flypylib_tpu_torch.ops import split as tsplit

torch.set_num_threads(1)

MODELS = {
    # the three model shapes of tests/test_packed_conv.py
    "baseline": ("baseline", {}),
    "mixed_d1_d2": ("baseline", dict(features=(6, 8), dilations=(1, 2),
                                     head_features=12)),
    "vgg_d124": ("vgg_like", dict(features=(4, 6, 6, 8),
                                  dilations=(1, 1, 2, 4), head_features=8)),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_parity_split_and_merge_equal_jax_and_invert(rng):
    x = rng.normal(size=(2, 8, 6, 4, 3)).astype(np.float32)
    s = tpc.parity_split(_t(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jpc.parity_split(x)))
    np.testing.assert_array_equal(tpc.parity_merge(s).numpy(), x)
    np.testing.assert_array_equal(
        tpc.parity_merge(_t(np.asarray(s))).numpy(),
        np.asarray(jpc.parity_merge(jnp.asarray(s.numpy()))))
    with pytest.raises(ValueError, match="even"):
        tpc.parity_split(torch.zeros((1, 3, 4, 4, 1)))


def test_parity_batch_and_unbatch_equal_jax_and_invert(rng):
    x = rng.normal(size=(3, 5, 4, 6, 16)).astype(np.float32)
    b = tpc.parity_batch(_t(x))
    assert b.shape == (24, 5, 4, 6, 2)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jpc.parity_batch(x)))
    np.testing.assert_array_equal(
        tpc.parity_unbatch(b).numpy(),
        np.asarray(jpc._parity_unbatch_impl(jnp.asarray(b.numpy()))))
    np.testing.assert_array_equal(tpc.parity_unbatch(b).numpy(), x)
    np.testing.assert_array_equal(tpc.parity_batch(tpc.parity_unbatch(b)), b)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 4, 4, 4, 8), (3, 6, 5, 7, 16),
                                   (2, 3, 3, 3, 256)])
def test_split_reference_equals_pallas_and_xla(rng, shape, dtype):
    """K5's plain version == the Pallas kernel (interpret mode) and the
    reference's XLA spelling, bitwise (the shapes of test_pallas_split.py)."""
    x = jnp.asarray(rng.random(shape).astype(np.float32), dtype)
    xt = _t(np.asarray(x.astype(jnp.float32)))
    if dtype == jnp.bfloat16:
        xt = xt.bfloat16()  # exact: the values are bf16 already
    got = tsplit.parity_split_reference(xt).float().numpy()
    for want in (parity_split_pallas(x, interpret=True), parity_split_xla(x)):
        np.testing.assert_array_equal(got, np.asarray(want.astype(jnp.float32)))


def test_split_wrapper_runs_the_plain_version_on_the_cpu(rng):
    x = _t(rng.random((2, 3, 4, 5, 24)).astype(np.float32))
    before = tsplit.parity_split_kernel.launches
    assert torch.equal(tsplit.parity_split_kernel(x),
                       tsplit.parity_split_reference(x))
    assert tsplit.parity_split_kernel.launches == before
    with pytest.raises(ValueError, match="multiple of 8"):
        tsplit.parity_split_kernel(torch.zeros((1, 2, 2, 2, 12)))
    with pytest.raises(ValueError, match="8c"):
        tsplit.parity_split_kernel(torch.zeros((2, 2, 2, 16)))


def _models(name, rng):
    """The JAX spec and f32 params (random biases), the port's spec holding
    the same params, and a valid packed input size."""
    zoo_name, kw = MODELS[name]
    jspec = jzoo.MODEL_ZOO[zoo_name](dtype=jnp.float32, **kw)
    params = jax.tree_util.tree_map(
        np.array, jspec.init(jax.random.PRNGKey(0), jspec.min_size))["params"]
    for layer in params.values():
        layer["bias"] = rng.normal(0, 0.1, layer["bias"].shape).astype(np.float32)
    tspec = tzoo.MODEL_ZOO[zoo_name](dtype=torch.float32, **kw)
    tspec.module.load_state_dict(tzoo.params_from_flax({"params": params}))
    return jspec, params, tspec


@pytest.mark.parametrize("name", sorted(MODELS))
def test_packed_convstack_matches_jax_and_plain(rng, name):
    jspec, params, tspec = _models(name, rng)
    pspec = tpc.packed_spec(tspec)
    assert isinstance(pspec.module, tpc.PackedConvStack)
    assert pspec.module.inner is tspec.module and pspec.context == tspec.context
    s = pspec.valid_size(tspec.min_size + 7)
    x = rng.normal(size=(2, s, s, s, 1)).astype(np.float32)
    want = np.asarray(jpc.PackedConvStack(jspec.module).apply(
        {"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pspec.module(_t(x))
        plain = tspec.module(_t(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == plain.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["baseline", "vgg_like"])
def test_packed_geometry_equals_jax_probe(name):
    """The shape walk's geometry == JAX ``packed_spec``'s ``eval_shape``
    probe (~10 s a spec here; other tests build JAX specs from the port's
    geometry instead)."""
    t = tpc.packed_spec(tzoo.MODEL_ZOO[name]())
    j = jpc.packed_spec(jzoo.MODEL_ZOO[name]())
    for attr in ("name", "context", "size_multiple", "size_offset",
                 "min_size", "metadata"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert (t.size_multiple, t.size_offset) == {"baseline": (2, 0),
                                                "vgg_like": (4, 2)}[name]


def test_packed_spec_rejects_what_it_cannot_run():
    assert tpc.packed_spec(tzoo.unet(base_features=2)) is None
    odd = tzoo.baseline_model(features=(4, 4), dilations=(1, 3))
    assert tpc.packed_spec(odd) is None
    falling = tzoo.baseline_model(features=(4, 4), dilations=(2, 1))
    assert tpc.packed_spec(falling) is None
    with pytest.raises(ValueError, match="does not support"):
        tpt.FplNetwork(odd, device="cpu", packed=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_packed_tiled_equals_monolithic_bitwise(rng, dtype):
    net = tpt.FplNetwork("baseline", device="cpu", dtype=dtype,
                         features=(4, 6), dilations=(1, 2), head_features=8)
    assert isinstance(net.infer_spec.module, tpc.PackedConvStack)
    vol = rng.integers(0, 256, (21, 19, 17), dtype=np.uint8)
    mono = net.infer(vol, tile_out=32, tile_batch=1)
    tiled = net.tiled_inference(vol.shape, tile_out=8, tile_batch=3)
    assert tiled.n_batches(vol.shape) == 9 and tiled.align == 2
    got = net.infer(vol, tile_out=8, tile_batch=3)
    assert got.dtype == np.float32 and got.shape == vol.shape
    np.testing.assert_array_equal(got, mono)


def test_stage_a_hands_k5_a_contiguous_operand(monkeypatch):
    """The CUDA kernel takes only contiguous NDHWC input: on the CPU nothing
    checks that, so assert it of what the engine hands it, for both zoo
    stacks, once per forward."""
    seen = []
    real = tpc.parity_split_kernel

    def keep(x):
        seen.append((tuple(x.shape), x.is_contiguous()))
        return real(x)

    monkeypatch.setattr(tpc, "parity_split_kernel", keep)
    for name, s in (("baseline", 20), ("vgg_like", 38)):
        pspec = tpc.packed_spec(tzoo.MODEL_ZOO[name](dtype=torch.float32))
        with torch.no_grad():
            out = pspec.module(torch.zeros((2, s, s, s, 1)))
        assert out.shape == (2, *(s - 2 * pspec.context,) * 3, 1)
    assert [c for _, c in seen] == [True, True]
    assert seen[0][0] == (2, 8, 8, 8, 256) and seen[1][0] == (2, 16, 16, 16, 384)


def test_chip_smoke_packed_rehearsal_on_cpu():
    """chip_smoke's packed path on the CPU at narrow widths: the plain
    versions count no launch, the lists equal the host reference, and the
    tile batch K4's operands come from is the one the engine runs."""
    net = tpt.FplNetwork("baseline", device="cpu", dtype=torch.bfloat16,
                         features=(4, 6), dilations=(1, 2), head_features=8)
    vol = chip_smoke.make_volume_u8(32, 3, seed=0)
    res = chip_smoke.run_main_path(net, vol, n_cand=100)
    chip_smoke.require_launches(res, {}, "packed baseline on the CPU")
    assert res["n_nms"] > 0
    ti = net.tiled_inference(vol.shape)
    tiles = chip_smoke.first_tile_batch(net.infer_spec, vol, "cpu")
    assert tiles.shape == (ti.tile_batch, *(ti.tile_in,) * 3, 1)
    assert tiles.dtype == torch.uint8


# -- PackedConv: the packed convs under grad --------------------------------
KS = pytest.mark.parametrize("k", [2, 3, 1], ids=["k2", "k3", "k1"])
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])


def _old_conv(x, w):
    """``_conv`` as it was before ``PackedConv``: the library's gradients."""
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                     w.to(x.dtype).permute(4, 3, 0, 1, 2))
        return y.permute(0, 2, 3, 4, 1)
    return tpc.conv3d_f32(x, w.to(x.dtype)).to(x.dtype)


def _operands(k, dtype, ci=6, co=10, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 7, 6, 5, ci), generator=g).to(dtype)
    w = (torch.randn((k, k, k, ci, co), generator=g) / (k ** 1.5)).to(dtype)
    dy = torch.randn((2, 8 - k, 7 - k, 6 - k, co), generator=g).to(dtype)
    return x, w, dy


def _grads(conv, x, w, dy, wants=(True, True)):
    xs, ws = (t.clone().requires_grad_(n) for t, n in zip((x, w), wants))
    y = conv(xs, ws)
    y.backward(dy)
    return y.detach(), xs.grad, ws.grad


@KS
@DTYPES
def test_packed_conv_gradients_equal_autograd_of_the_call(k, dtype):
    """``PackedConv``'s input and weight gradients (the input's a forward
    conv of the padded output gradient against the flipped kernel) against
    autograd through the conv it replaces, on the same operands; with only
    one operand needing a gradient, only that one is computed."""
    x, w, dy = _operands(k, dtype)
    _, gx, gw = _grads(tpc.PackedConv.apply, x, w, dy)
    _, rx, rw = _grads(_old_conv, x, w, dy)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for got, want in ((gx, rx), (gw, rw)):
        assert got.dtype == want.dtype == dtype
        assert got.shape == want.shape
        err = float((got.float() - want.float()).abs().max())
        assert err <= rtol * float(want.float().abs().max()), err
    _, gx1, gw1 = _grads(tpc.PackedConv.apply, x, w, dy, (True, False))
    assert gw1 is None and torch.equal(gx1, gx)
    _, gx2, gw2 = _grads(tpc.PackedConv.apply, x, w, dy, (False, True))
    assert gx2 is None and torch.equal(gw2, gw)


@KS
@DTYPES
def test_packed_conv_f64_gradcheck(monkeypatch, k, dtype):
    """The gradients' algebra exact (flip, Ci/Co swap, padding by k - 1 on
    each side of each axis), by ``gradcheck`` in f64 on small extents with
    the engine's f32 conv swapped for the same conv in f64; the dtype case
    holds the same operands' values rounded to it first."""

    def conv64(x, w, dilation=1, padding=0):
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                     padding=padding, dilation=dilation)
        return y.permute(0, 2, 3, 4, 1)

    monkeypatch.setattr(tpc, "conv3d_f32", conv64)
    g = torch.Generator().manual_seed(k)
    x = torch.randn((1, k + 2, k + 1, k + 3, 3), generator=g).to(dtype)
    w = torch.randn((k, k, k, 3, 2), generator=g).to(dtype)
    x, w = (t.double().requires_grad_(True) for t in (x, w))
    assert torch.autograd.gradcheck(tpc.PackedConv.apply, (x, w))


@KS
@DTYPES
def test_packed_conv_forward_is_the_call_it_replaces(k, dtype):
    """Under grad and without, ``_conv`` gives bitwise the output of the
    call the engine made before, for weights in the model dtype and in f32
    (the U-Net's folds pass f32 weights); under grad it goes through
    ``PackedConv`` exactly when ``x`` needs a gradient and the kernel is
    3^3 (stage B), else through autograd's own conv gradients."""
    x, w, _ = _operands(k, dtype, seed=1)
    want = _old_conv(x, w)
    for wk in (w, w.float()):
        with torch.no_grad():
            assert torch.equal(tpc._conv(x, wk), want)
        for xg in (False, True):
            y = tpc._conv(x.clone().requires_grad_(xg),
                          wk.clone().requires_grad_(True))
            packed = "PackedConv" in type(y.grad_fn).__name__
            assert packed == (xg and k == 3)
            assert y.dtype == dtype and torch.equal(y.detach(), want)


@DTYPES
@pytest.mark.parametrize("name", ["baseline", "vgg_d124", "unet"])
def test_packed_forward_without_grad_is_bitwise_unchanged(monkeypatch, name,
                                                          dtype):
    """``PackedConvStack.forward`` (and the packed U-Net's) under
    ``torch.no_grad()`` is bitwise the forward with ``_conv`` as it was, and
    so is ``forward_train``'s output under grad (through ``PackedConv``)."""
    from flypylib_tpu_torch.ops import packed_unet as tpu

    if name == "unet":
        spec = tpu.packed_unet_spec(tzoo.unet(base_features=4, dtype=dtype))
    else:
        zoo_name, kw = MODELS[name]
        kw = {**kw, "features": (4, 6, 6, 8), "head_features": 8} \
            if name == "baseline" else kw
        spec = tpc.packed_spec(tzoo.MODEL_ZOO[zoo_name](dtype=dtype, **kw))
    module = spec.module
    s = spec.valid_size(spec.min_size + 3)
    x = torch.from_numpy(np.random.default_rng(5).random(
        (2, s, s, s, 1), dtype=np.float32))
    with torch.no_grad():
        got = module(x)
    train = module.forward_train(x)
    with monkeypatch.context() as m:
        m.setattr(tpc, "_conv", _old_conv)
        m.setattr(tpu, "_conv", _old_conv)
        with torch.no_grad():
            want = module(x)
        want_train = module.forward_train(x)
    assert torch.equal(got, want)
    assert torch.equal(train.detach(), want_train.detach())


# -- the inference route onto K2's wgmma stage kernel ------------------------
def _bf16_view(c, off=0, shape=(2, 5, 6, 7)):
    """A bf16 (*shape, c) tensor ``off`` elements past a 16-byte boundary."""
    n = int(np.prod(shape)) * c
    flat = torch.zeros(n + 8, dtype=torch.bfloat16)
    view = flat[off:off + n].view(*shape, c)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2 * off
    return view


@pytest.mark.parametrize("case,want", [
    ("bf16", True),
    ("f32", False),             # the f32 engine keeps cuDNN
    ("grad", False),            # training under grad keeps autograd's path
    ("batchnorm", False),       # a folded BatchNorm keeps _epilogue
    ("ci_off_8", False),        # Ci off the multiples of 8
    ("co_off_8", False),        # Co off the multiples of 8
    ("unaligned", False),       # x 2 bytes past a 16-byte boundary
    ("strided", False),         # x not contiguous
    ("co_768", True),           # past the widest N tile: slices
])
def test_fused_route_rule(case, want):
    """The rule :func:`fused_route` reads on a call of
    ``packed_conv_relu`` (the device aside: a CPU tensor never takes it)."""
    x, co, norm = _bf16_view(192), 256, None
    grad = case == "grad"
    if case == "f32":
        x = x.float()
    elif case == "batchnorm":
        norm = tzoo.BatchNorm(32)
    elif case == "ci_off_8":
        x = _bf16_view(12)
    elif case == "co_off_8":
        co = 260
    elif case == "unaligned":
        x = _bf16_view(192, off=1)
    elif case == "strided":
        x = x.transpose(1, 2)
    elif case == "co_768":
        co = 768
    with torch.set_grad_enabled(grad):
        assert tpc.fused_route(x, co, norm) is want


def test_cpu_packed_conv_relu_takes_the_library_path():
    """On the CPU the route is never taken: the tracer counts no
    ``packed_conv_fused`` and no launch is counted, and the output is bit
    for bit the plain conv's followed by ``_epilogue``."""
    from flypylib_tpu_torch.ops import tail
    from flypylib_tpu_torch.utils import metrics

    conv = tzoo.Conv3BiasReLU(3, 4, 1)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        conv.weight.normal_(generator=g)
        conv.bias.normal_(generator=g)
    x = torch.randn((1, 4, 5, 4, 24), generator=g).to(torch.bfloat16)
    before = tail.stage_bias_relu.launches
    metrics.enable()
    try:
        with torch.no_grad():
            got = tpc.packed_conv_relu(x, conv)
    finally:
        rec = metrics.disable()
    want = tpc._epilogue(tpc._fprop(x, tpc.pack_weight_d1(
        conv.weight.to(torch.bfloat16))), conv, tile=8)
    assert torch.equal(got, want)
    assert not any("packed_conv_fused" in c for c in rec["counters"].values())
    assert tail.stage_bias_relu.launches == before


def test_stage_operands_are_built_once_per_weight_version():
    """The packed weight and its images are kept per conv and device
    and rebuilt only after an in-place write, a ``.data`` swap or a new
    parameter, and hold the packed weight and the 8-fold bias."""
    conv = tzoo.Conv3BiasReLU(2, 3, 1)
    with torch.no_grad():
        conv.weight.normal_()
        conv.bias.normal_()
    cpu = torch.device("cpu")
    first = tpc._stage_operands(conv, cpu)
    assert tpc._stage_operands(conv, cpu) is first
    assert torch.equal(first.w, tpc.pack_weight_d1(
        conv.weight.to(torch.bfloat16)))
    assert torch.equal(first.b, conv.bias.to(torch.bfloat16).repeat(8))
    with torch.no_grad():
        conv.weight.mul_(2)
    second = tpc._stage_operands(conv, cpu)
    assert second is not first and torch.equal(second.w, 2 * first.w)
    conv.bias.data = conv.bias.data + 1
    third = tpc._stage_operands(conv, cpu)
    assert third is not second and torch.equal(third.b, (
        conv.bias.to(torch.bfloat16)).repeat(8))
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone())
    assert tpc._stage_operands(conv, cpu) is not third


def test_stage_operands_stay_off_copies_of_the_module():
    """A deep copy of a conv (a replica made for another device) carries
    none of the original's images and builds its own, and the images go
    with the conv that holds them."""
    import copy

    conv = tzoo.Conv3BiasReLU(2, 3, 1)
    cpu = torch.device("cpu")
    first = tpc._stage_operands(conv, cpu)
    twin = copy.deepcopy(conv)
    assert conv in tpc._STAGE_OPERANDS and twin not in tpc._STAGE_OPERANDS
    assert "_stage_operands" not in vars(twin)
    again = tpc._stage_operands(twin, cpu)
    assert again is not first and torch.equal(again.w, first.w)
    n = len(tpc._STAGE_OPERANDS)
    del conv
    assert len(tpc._STAGE_OPERANDS) == n - 1
