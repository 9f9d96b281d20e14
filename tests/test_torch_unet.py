"""The port's valid-conv U-Net (``flypylib_tpu_torch``: ``UNetValid``,
``PackedUNet`` with every ``tail_impl``, geometry, ``FplNetwork``) against
the JAX package on the same params and inputs.

Tolerances:
- plain ``UNetValid`` vs Flax in f32: max |Δlogit| <= 1e-4 (f32 summation
  order through 11 layers);
- in bf16: 5e-3 on logits of magnitude up to 0.15.  At base 4, seeds 7-9,
  the gap read 6.1e-4, 1.5e-3 and 8.1e-4, the size of the gap between
  Flax's own bf16 and f32 forwards (6.1e-4, 1.6e-3, 8.9e-4): the port's
  K1 adds the conv bias in f32 before its one rounding where Flax rounds
  the conv to bf16 first, so values differ by a bf16 ulp here and there;
- ``PackedUNet`` vs the JAX ``PackedUNet`` with the same ``tail_impl``, in
  f32: rtol 1e-4 / atol 1e-5 (``tests/test_packed_unet.py``'s).
The JAX Pallas tails run in interpret mode (the JAX package picks it off
the TPU), as the JAX package's own tests run them.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import flypylib_tpu_torch as tpt
from flypylib_tpu.models import zoo as jzoo
from flypylib_tpu.network import FplNetwork as JaxNetwork
from flypylib_tpu.ops import packed_unet as jpu
from flypylib_tpu.train.trainer import TrainState
from flypylib_tpu_torch.models import zoo as tzoo
from flypylib_tpu_torch.ops import packed_unet as tpu
from flypylib_tpu_torch.ops.packed_conv import packed_spec
from flypylib_tpu_torch.ops import tail as ttail
from flypylib_tpu_torch.ops.host_reference import components_host, nms_host
from tests.conftest import make_blob_volume

torch.set_num_threads(1)

S = 44  # min_size of the (base, 2, 2) U-Net, plain and packed


def _params(rng, base, levels=2, cps=2):
    """Random f32 U-Net params in Flax's tree: lecun-scaled kernels,
    non-zero biases."""
    jm = jzoo.UNetValid(base_features=base, levels=levels,
                        convs_per_stage=cps, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, S, S, S, 1)))["params"]
    params = {}
    for name, layer in shapes.items():
        k = layer["kernel"].shape
        params[name] = {
            "kernel": rng.normal(0, np.prod(k[:-1]) ** -0.5, k).astype(np.float32),
            "bias": rng.normal(0, 0.1, layer["bias"].shape).astype(np.float32),
        }
    return {"params": params}


def _port_unet(variables, base, dtype=torch.float32):
    m = tzoo.UNetValid(base_features=base, dtype=dtype)
    m.load_state_dict(tzoo.params_from_flax(variables))
    return m.eval()


@pytest.fixture(scope="module")
def base4():
    rng = np.random.default_rng(7)
    v = _params(rng, 4)
    x = rng.random((1, S, S, S, 1)).astype(np.float32)
    return v, x


@pytest.mark.parametrize("base", [4, 24])
def test_unet_matches_flax_f32(rng, base):
    v = _params(rng, base)
    x = rng.random((1, S, S, S, 1)).astype(np.float32)
    jm = jzoo.UNetValid(base_features=base, dtype=jnp.float32)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_unet(v, base)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (1, 4, 4, 4, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_unet_matches_flax_bf16(base4):
    v, x = base4
    jm = jzoo.UNetValid(base_features=4)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_unet(v, 4, torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-3)


def test_convtranspose_orientation_is_flax(rng):
    """out[2r+p] = x[r] @ K[1-p]: a single-voxel input lights each output
    parity with the flipped tap."""
    k = rng.normal(size=(2, 2, 2, 3, 2)).astype(np.float32)
    up = tzoo.ConvTranspose2(3, 2)
    with torch.no_grad():
        up.weight.copy_(torch.from_numpy(k))
        x = torch.zeros((1, 1, 1, 1, 3))
        x[..., 1] = 1.0
        y = up(x, torch.float32)[0]
    for pz, py, px in np.ndindex(2, 2, 2):
        np.testing.assert_array_equal(y[pz, py, px].numpy(),
                                      k[1 - pz, 1 - py, 1 - px, 1])


@pytest.mark.parametrize("tail_impl", tpu.TAIL_IMPLS)
def test_packed_unet_matches_jax(base4, tail_impl, monkeypatch):
    v, x = base4
    jm = jzoo.UNetValid(base_features=4, dtype=jnp.float32)
    japply = jax.jit(jpu.PackedUNet(jm, tail_impl=tail_impl).apply)
    want = np.asarray(japply(v, jnp.asarray(x)))
    pm = tpu.PackedUNet(_port_unet(v, 4), tail_impl=tail_impl)
    launches = (ttail.packed_tail.launches, ttail.packed_tail2.launches)
    seen = []  # the tensors the engine hands the tail wrappers

    def keep(wrapper):
        def call(*args):
            seen.append([a for a in args[:2] if isinstance(a, torch.Tensor)])
            return wrapper(*args)
        return call

    monkeypatch.setattr(tpu, "packed_tail", keep(ttail.packed_tail))
    monkeypatch.setattr(tpu, "packed_tail2", keep(ttail.packed_tail2))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
        # batch 2: the port's kernel tails take every batch (JAX falls back
        # to its XLA tail there)
        x2 = np.concatenate([x, x + 0.25])
        got2 = pm(torch.from_numpy(x2))
        one = pm(torch.from_numpy(x2[1:]))
    assert (ttail.packed_tail.launches, ttail.packed_tail2.launches) == launches
    assert all(a.is_contiguous() for call in seen for a in call), (
        "the CUDA tail wrappers take only contiguous operands")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got2[:1], got) and torch.equal(got2[1:], one)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX's batch>1 fallback warning
        want2 = np.asarray(japply(v, jnp.asarray(x2)))
    np.testing.assert_allclose(got2.numpy(), want2, rtol=1e-4, atol=1e-5)
    # and the packed engine is the plain module re-associated
    with torch.no_grad():
        plain = pm.inner(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)


def test_packed_unet_rejections():
    with pytest.raises(ValueError, match="tail_impl"):
        tpu.PackedUNet(tzoo.UNetValid(base_features=2), tail_impl="bogus")
    assert tpu.packed_unet_spec(tzoo.baseline_model()) is None


@pytest.mark.parametrize("tail_impl", ["xla", "pallas2", "plain"])
def test_tiled_equals_monolithic_bitwise(rng, tail_impl):
    spec = tzoo.unet(base_features=4, dtype=torch.float32, seed=3)
    with torch.no_grad():  # non-zero biases, as trained weights have
        for p in spec.module.parameters():
            if p.dim() == 1:
                p.normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
    if tail_impl != "plain":
        spec = tpu.packed_unet_spec(spec, tail_impl=tail_impl)
    net = tpt.FplNetwork(spec, device="cpu")
    vol = rng.integers(0, 256, (40, 36, 34), dtype=np.uint8)
    mono = net.infer(vol, tile_out=48, tile_batch=1)
    assert net.tiled_inference(vol.shape).n_batches(vol.shape) == 1
    tiled = net.tiled_inference(vol.shape, tile_out=16, tile_batch=3)
    assert tiled.n_batches(vol.shape) > 2  # several batches, the last padded
    got = net.infer(vol, tile_out=16, tile_batch=3)
    np.testing.assert_array_equal(got, mono)


def _jax_net(variables, engine):
    """The JAX ``FplNetwork`` on ``variables`` for an engine.  Its specs
    take the port's geometry, which ``tests/test_torch_models.py`` holds
    equal to JAX's probe (the probe costs ~15 s a spec here)."""
    t = tzoo.unet(base_features=4)
    module = jzoo.UNetValid(base_features=4, dtype=jnp.float32)
    spec = jzoo.ModelSpec(name="unet", module=module, context=t.context,
                          size_multiple=t.size_multiple,
                          size_offset=t.size_offset, min_size=t.min_size,
                          metadata=t.metadata)
    if engine != "plain":
        tp = tpu.packed_unet_spec(t)
        spec = jzoo.ModelSpec(
            name="unet+packed",
            module=jpu.PackedUNet(module, tail_impl="xla" if engine == "auto"
                                  else engine),
            context=tp.context, size_multiple=tp.size_multiple,
            size_offset=tp.size_offset, min_size=tp.min_size,
            metadata=tp.metadata)
    jnet = JaxNetwork(spec, packed=False)
    jnet.trainer.state = TrainState.create(variables, jnet.trainer.tx)
    return jnet


@pytest.mark.parametrize("engine", ["plain", "auto", "pallas2"])
def test_network_matches_jax_end_to_end(base4, engine):
    v, _ = base4
    jnet = _jax_net(v, engine)
    if engine == "pallas2":
        net = tpt.FplNetwork(tpu.packed_unet_spec(
            tzoo.unet(base_features=4, dtype=torch.float32), tail_impl="pallas2"),
            device="cpu")
    else:
        net = tpt.FplNetwork("unet", device="cpu", dtype=torch.float32,
                             base_features=4, packed=engine == "auto")
    net.load_flax_params(v)
    assert isinstance(net.infer_spec.module, tpu.PackedUNet) == (engine != "plain")
    vol, _ = make_blob_volume((30, 28, 26), centers=[(8, 9, 10), (20, 18, 16)],
                              sigma=2.0)
    vol = (vol * 200 + np.random.default_rng(0).random(vol.shape) * 20).astype(
        np.uint8)
    want = np.asarray(jnet.infer(vol))
    got = net.infer(vol)
    assert got.shape == vol.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    thr = float(np.quantile(got, 0.97))
    dets = net.detect(vol, threshold=thr)
    assert len(dets) > 0
    for got_d, want_d in ((dets, nms_host(got, window=5, threshold=thr)),
                          (net.detect(vol, threshold=thr, method="components"),
                           components_host(got, threshold=thr))):
        assert len(got_d) == len(want_d)
        np.testing.assert_array_equal(got_d.locs, want_d.locs)
        np.testing.assert_allclose(got_d.conf, want_d.conf, rtol=0, atol=1e-6)


def test_network_packed_option():
    unet = tpt.FplNetwork("unet", device="cpu", base_features=2)
    assert unet.infer_spec.name == "unet+packed"
    assert unet.infer_spec.module.inner is unet.module
    assert unet.variables.keys() == unet.module.state_dict().keys()
    plain = tpt.FplNetwork("unet", device="cpu", base_features=2, packed=False)
    assert plain.infer_spec is plain.spec
    # the conv stacks: packed by default and with packed=True, as the JAX
    # package; packed=False is the plain stack
    for packed in ("auto", True):
        base = tpt.FplNetwork("baseline", device="cpu", packed=packed)
        assert base.infer_spec.name == "baseline+packed"
        assert base.infer_spec.module.inner is base.module is base.spec.module
    base = tpt.FplNetwork("baseline", device="cpu", packed=False)
    assert base.infer_spec is base.spec
    ready = packed_spec(tzoo.vgg_like())
    net = tpt.FplNetwork(ready, device="cpu", packed=True)
    assert net.infer_spec is ready and net.module is ready.module.inner
    ready = tpu.packed_unet_spec(tzoo.unet(base_features=2), tail_impl="pallas")
    net = tpt.FplNetwork(ready, device="cpu", packed=True)
    assert net.infer_spec is ready and net.module is ready.module.inner


def test_chip_smoke_unet_rehearsal_on_cpu():
    """chip_smoke's U-Net path on the CPU: full width, a 24^3 volume."""
    net = chip_smoke.unet_net(tpt, "pallas2", "cpu", torch.float32)
    assert net.infer_spec.module.tail_impl == "pallas2"
    vol = chip_smoke.make_volume_u8(24, 2, seed=0)
    res = chip_smoke.run_main_path(net, vol, n_cand=50)
    chip_smoke.require_launches(res, {}, "unet pallas2 on the CPU")
    assert res["n_batches"] == 1 and res["n_nms"] > 0
    plain = chip_smoke.unet_net(tpt, "plain", "cpu", torch.float32)
    assert plain.infer_spec is plain.spec and len(plain.module.convs) == 10


@pytest.mark.parametrize("broken", [False, True], ids=["sound", "stage_high"])
def test_chip_smoke_tail_stagewise_check_on_cpu(monkeypatch, broken):
    """chip_smoke's launch-by-launch K2/K3 check, on the CPU, on the
    operands a small bf16 packed U-Net hands its tails: the plain versions
    pass it; a stage whose every output is 1/16 high (about eight bf16
    ulps) is refused."""
    seen = {}
    for impl, name in (("pallas", "packed_tail"), ("pallas2", "packed_tail2")):
        spec = tpu.packed_unet_spec(tzoo.unet(base_features=4), tail_impl=impl)
        wrapper = getattr(tpu, name)

        def keep(*args, _name=name, _wrapper=wrapper):
            seen[_name] = args
            return _wrapper(*args)

        monkeypatch.setattr(tpu, name, keep)
        vol = chip_smoke.make_volume_u8(S, 2, seed=0)
        with torch.no_grad():
            spec.module(torch.from_numpy(vol)[None, ..., None])
    if broken:
        real = ttail.packed_tail

        def high(x, stages, logits=None):
            y = real(x, stages, logits)
            return y if logits is not None else (y.float() * 1.0625).to(y.dtype)

        monkeypatch.setattr(ttail, "packed_tail", high)
        with pytest.raises(RuntimeError, match="K2 stage 0 bfloat16"):
            chip_smoke.check_tail_stagewise(seen, torch.bfloat16, S, "cpu")
    else:
        chip_smoke.check_tail_stagewise(seen, torch.bfloat16, S, "cpu")
