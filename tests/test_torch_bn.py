"""BatchNorm models in the port (``ConvStack(use_batchnorm=True)``, K1 with
``relu=False``, the packed engine's folded BatchNorm, BatchNorm training)
against the JAX package's, on the CPU.

Tolerances (f32 unless stated):

- eval logits against Flax ``apply``: max |err| <= 1e-4 x max |logit|
  (f32 convs summed in other orders, ``rsqrt`` of two libraries);
- train-mode output and the updated ``batch_stats`` against Flax with
  ``mutable=["batch_stats"]``: 1e-5 relative (the statistics are means of
  f32 values reduced in other orders);
- one train step against the JAX package's ``make_loss_fn`` on the same
  batch: the loss to 1e-4 relative, every gradient within 1e-4 of its max
  |g|, the new running statistics to 1e-4 relative.  A body conv's bias
  feeds a train-mode BatchNorm, which subtracts any per-channel constant,
  so its gradient is 0 in exact arithmetic and both sides hold rounding:
  there both must be within 1e-4 of the max |g| of that conv's kernel;
- the packed engine against the JAX ``PackedConvStack``: 1e-4 of max
  |logit|;
- bf16 logits against JAX's bf16 logits: ``BF16_LOGIT_TOL`` of max
  |logit|, set from the gap ``python -m tests.test_torch_bn`` prints
  (measured 0.0077 plain, 4.3e-07 packed): the plain stack's K1 rounds
  conv + bias once where Flax's conv rounds the sum and then adds the bf16
  bias, while the packed engines round at the same points;
- ``Conv3dBiasReLU(relu=False)`` against autograd of its plain version:
  the output exactly, the gradients within 1e-6 of their max |g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flypylib_tpu.models import zoo as jzoo
from flypylib_tpu.ops import packed_conv as jpc
from flypylib_tpu.train import trainer as jtr
from flypylib_tpu_torch import FplNetwork
from flypylib_tpu_torch.models import zoo as tzoo
from flypylib_tpu_torch.ops import packed_conv as tpc
from flypylib_tpu_torch.ops.conv import Conv3dBiasReLU, conv3d_reference
from flypylib_tpu_torch.train import trainer as ttr
from flypylib_tpu_torch.train import TrainConfig
from tests.test_torch_train import synthetic_task

torch.set_num_threads(1)

CPU = "cpu"
BN = dict(features=(6, 8, 8), dilations=(1, 2, 2), head_features=8)
CTX = sum(BN["dilations"])
BF16_LOGIT_TOL = {"plain": 0.02, "packed": 1e-5}  # of max |logit|


def _modules(dtype=jnp.float32, tdtype=torch.float32, seed=0):
    """(Flax ConvStack, its variables with every leaf redrawn, the port's
    ConvStack holding the same) for the BatchNorm stack ``BN``; running
    variances stay positive."""
    jm = jzoo.ConvStack(dtype=dtype, use_batchnorm=True, **BN)
    s = 2 * CTX + 4
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, s, 1)), train=False)
    rng = np.random.default_rng(seed)
    params = {
        name: {k: (rng.normal(0, np.prod(a.shape[:-1]) ** -0.5, a.shape)
                   if k == "kernel" else
                   1.0 + rng.normal(0, 0.2, a.shape) if k == "scale" else
                   rng.normal(0, 0.2, a.shape)).astype(np.float32)
               for k, a in layer.items()}
        for name, layer in v["params"].items()}
    stats = {name: {"mean": rng.normal(0, 0.3, layer["mean"].shape
                                       ).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, layer["var"].shape
                                       ).astype(np.float32)}
             for name, layer in v["batch_stats"].items()}
    variables = {"params": params, "batch_stats": stats}
    tm = tzoo.ConvStack(dtype=tdtype, use_batchnorm=True, **BN)
    tm.load_state_dict(tzoo.params_from_flax(variables))
    return jm, variables, tm


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol * scale, f"{what}: max |err| {err} > {tol} x {scale}"
    return err / scale


def _x(rng, n=2, s=2 * CTX + 8):
    return rng.normal(0, 1, (n, s, s, s, 1)).astype(np.float32)


def test_bn_eval_logits_match_flax():
    jm, v, tm = _modules()
    assert not tm.training  # built in eval mode, as Flax's train=False
    x = _x(np.random.default_rng(1))
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    got = tm(torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, 1e-4, "eval logits")


def test_bn_train_mode_output_and_stats_match_flax():
    jm, v, tm = _modules()
    x = _x(np.random.default_rng(2))
    want, upd = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    with ttr.train_mode(tm):
        got = tm(torch.from_numpy(x))
    assert not tm.training  # the mode before is restored
    _close(got, want, 1e-5, "train-mode logits")
    new = tzoo.flax_from_params(tm.state_dict())["batch_stats"]
    for name, layer in upd["batch_stats"].items():
        for leaf in ("mean", "var"):
            _close(new[name][leaf], layer[leaf], 1e-5, f"{name}.{leaf}")
    # eval mode leaves the buffers alone
    before = {k: b.clone() for k, b in tm.named_buffers()}
    tm(torch.from_numpy(x))
    for k, b in tm.named_buffers():
        assert torch.equal(b, before[k]), k


def test_bn_running_variance_is_the_biased_one():
    """The running variance takes the biased batch variance, as Flax's:
    after one step from var = 1, ``var = 0.99 + 0.01 * E[(x - E x)^2]``."""
    norm = tzoo.BatchNorm(3)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        1, 2, (4, 5, 3)).astype(np.float32))
    norm.train()
    norm(x)
    xs = x.reshape(-1, 3).double()
    biased = ((xs - xs.mean(0)) ** 2).mean(0)
    np.testing.assert_allclose(norm.var.numpy(),
                               (0.99 + 0.01 * biased).numpy(), rtol=1e-6)
    np.testing.assert_allclose(norm.mean.numpy(),
                               (0.01 * xs.mean(0)).numpy(), rtol=1e-6)


def test_bn_train_step_matches_jax_make_loss_fn():
    """One f32 step through each package's ``make_loss_fn``: the JAX one
    samples its batch from ``TrainData`` with a key; the port's loss gets
    the same patches (the corners from JAX's ``_sample_batch`` on the key
    JAX splits, no augmentation)."""
    jm, v, tm = _modules()
    image, labels, mask, _ = synthetic_task(size=28, seed=4)
    patch, n = 2 * CTX + 6, 4
    jspec = jzoo.ModelSpec(name="bn", module=jm, context=CTX,
                           min_size=2 * CTX + 1)
    tspec = tzoo.ModelSpec(name="bn", module=tm, context=CTX,
                           min_size=2 * CTX + 1)
    jcfg = jtr.TrainConfig(patch_size=patch, batch_size=n, augment=False)
    tcfg = TrainConfig(patch_size=patch, batch_size=n, augment=False)
    assert jtr.resolve_engine(jspec, jcfg) == "plain"
    assert ttr.resolve_engine(tspec, tcfg) == "plain"

    jloss_fn, jpatch = jtr.make_loss_fn(jspec, jcfg)
    jd = jtr.TrainData.build(image, labels, mask, jpatch)
    key = jax.random.PRNGKey(11)
    (jloss, (_, new_bs)), jgrads = jax.value_and_grad(
        jloss_fn, has_aux=True)(v["params"], v["batch_stats"], key, jd)
    want = tzoo.params_from_flax({"params": jgrads, "batch_stats": new_bs})

    tloss_fn, _, tpatch = ttr.make_loss_fn(tspec, tcfg)
    assert tpatch == jpatch == patch
    k_corner, _ = jax.random.split(key)
    vidx, corners = (torch.from_numpy(np.array(a)).long() for a in
                     jtr._sample_batch(k_corner, n, jd, patch, jcfg))
    td = ttr.TrainData.build(image, labels, mask, patch, device=CPU)
    out = patch - 2 * CTX
    x = ttr._gather(td.images, vidx, corners, patch)
    y = ttr._gather(td.labels, vidx, corners + CTX, out)
    m = ttr._gather(td.masks, vidx, corners + CTX, out)
    tm.zero_grad(set_to_none=True)
    loss, _ = tloss_fn(x, y, m, None)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * abs(float(jloss))
    for name, p in tm.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        if name.startswith("convs.") and name.endswith(".bias"):
            kernel = float(want[name[:-4] + "weight"].abs().max())
            for g in (p.grad, want[name]):
                assert float(g.abs().max()) <= 1e-4 * kernel, name
            continue
        _close(p.grad, want[name].numpy(), 1e-4, name)
    for name, b in tm.named_buffers():  # the running stats, updated once
        _close(b, want[name].numpy(), 1e-4, name)
    assert not tm.training


def test_packed_bn_inference_matches_jax_packed():
    jm, v, tm = _modules()
    spec = tzoo.ModelSpec(name="bn", module=tm, context=CTX,
                          min_size=2 * CTX + 1)
    pspec = tpc.packed_spec(spec)
    assert pspec is not None and pspec.module.inner is tm
    s = pspec.valid_size(2 * CTX + 8)
    x = _x(np.random.default_rng(5), s=s)
    want = np.asarray(jpc.PackedConvStack(jm).apply(v, jnp.asarray(x)))
    got = pspec.module(torch.from_numpy(x))
    _close(got, want, 1e-4, "packed BN logits")
    # and the plain module's logits, the same function
    _close(got, np.asarray(jm.apply(v, jnp.asarray(x))), 1e-4, "vs plain")


def bf16_gaps() -> dict:
    """max |logit gap| / max |logit| of the port's bf16 BatchNorm stack,
    plain and packed, against JAX's on the same weights and input."""
    jm, v, tm = _modules(jnp.bfloat16, torch.bfloat16)
    spec = tzoo.ModelSpec(name="bn", module=tm, context=CTX,
                          min_size=2 * CTX + 1)
    pspec = tpc.packed_spec(spec)
    s = pspec.valid_size(2 * CTX + 8)
    x = _x(np.random.default_rng(6), s=s)
    gaps = {}
    for name, jfwd, tfwd in (
            ("plain", lambda: jm.apply(v, jnp.asarray(x)), tm),
            ("packed", lambda: jpc.PackedConvStack(jm).apply(v, jnp.asarray(x)),
             pspec.module)):
        want = np.asarray(jfwd(), np.float32)
        got = tfwd(torch.from_numpy(x)).detach().float().numpy()
        gaps[name] = float(np.abs(got - want).max() / np.abs(want).max())
    return gaps


def test_bn_bf16_maps_against_jax():
    for name, gap in bf16_gaps().items():
        assert gap <= BF16_LOGIT_TOL[name], f"{name}: {gap}"


def test_packed_forward_train_raises_and_auto_is_plain():
    _, _, tm = _modules()
    spec = tzoo.ModelSpec(name="bn", module=tm, context=CTX,
                          min_size=2 * CTX + 1)
    pspec = tpc.packed_spec(spec)
    x = torch.zeros(1, 18, 18, 18, 1)
    with pytest.raises(ValueError, match="use_batchnorm"):
        pspec.module.forward_train(x)
    for s in (spec, pspec):  # a packed spec of a BN stack too
        assert ttr.resolve_engine(s, TrainConfig(batch_size=8)) == "plain"
    packed = TrainConfig(patch_size=18, batch_size=2, engine="packed")
    assert ttr.resolve_engine(spec, packed) == "packed"
    loss_fn, _, patch = ttr.make_loss_fn(spec, packed)
    out = patch - 2 * CTX
    with pytest.raises(ValueError, match="use_batchnorm"):
        loss_fn(torch.zeros(2, patch, patch, patch),
                torch.zeros(2, out, out, out), torch.ones(2, out, out, out),
                None)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("ci", [1, 3])
def test_k1_relu_false_gradient_equals_autograd_of_plain(ci, d):
    rng = np.random.default_rng(ci + d)
    x = torch.from_numpy(rng.normal(0, 1, (2, 9, 10, 11, ci)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.3, (3, 3, 3, ci, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, 5).astype(np.float32))
    dy = torch.from_numpy(rng.normal(0, 1, (2, 9 - 2 * d, 10 - 2 * d,
                                            11 - 2 * d, 5)).astype(np.float32))
    grads = []
    for fn in (Conv3dBiasReLU.apply, conv3d_reference):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
        y = fn(xs, ws, bs, d, False)
        y.backward(dy)
        grads.append((y.detach(), xs.grad, ws.grad, bs.grad))
    (y1, *g1), (y0, *g0) = grads
    assert torch.equal(y1, y0)
    assert bool((y1 < 0).any())  # no ReLU: negative outputs stay
    assert torch.equal(conv3d_reference(x, w, b, d),
                       torch.relu(y0))  # relu=True is the clamp of it
    for got, want, what in zip(g1, g0, ("dx", "dw", "db")):
        _close(got, want.numpy(), 1e-6, what)


@pytest.mark.parametrize("model", ["bn", "baseline", "unet"])
def test_params_from_flax_and_flax_from_params_round_trip(model):
    if model == "bn":
        _, v, tm = _modules()
    else:
        tm = (tzoo.baseline_model(features=(4, 6), dilations=(1, 2),
                                  head_features=8, seed=3).module
              if model == "baseline" else
              tzoo.unet(base_features=4, levels=2, convs_per_stage=1,
                        seed=3).module)
        v = None
    sd = tm.state_dict()
    tree = tzoo.flax_from_params(sd)
    assert bool(tree["batch_stats"]) == (model == "bn")
    back = tzoo.params_from_flax(tree)
    assert back.keys() == sd.keys()
    for k, t in sd.items():
        assert torch.equal(back[k], t.float()), k
    if v is not None:  # the Flax tree itself comes back
        for coll in ("params", "batch_stats"):
            for name, layer in v[coll].items():
                for leaf, a in layer.items():
                    np.testing.assert_array_equal(tree[coll][name][leaf], a)
    # the JAX package's own init tree for the same topology loads as is
    jm = (jzoo.ConvStack(use_batchnorm=True, **BN) if model == "bn" else
          jzoo.ConvStack(features=(4, 6), dilations=(1, 2), head_features=8)
          if model == "baseline" else
          jzoo.UNetValid(base_features=4, levels=2, convs_per_stage=1))
    s = 22 if model == "unet" else 16
    jv = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, s, 1)), train=False))
    assert tzoo.params_from_flax(jv).keys() == sd.keys()
    assert jax.tree_util.tree_structure(
        {k: jv.get(k, {}) for k in ("params", "batch_stats")}
    ) == jax.tree_util.tree_structure(tree)


def test_bn_network_trains_detects_and_round_trips(tmp_path):
    """``FplNetwork`` on a BatchNorm ``ModelSpec``: trains on the plain
    engine (the running statistics move), validates in eval mode, detects
    through the packed and the plain engine with the same map, and
    ``save`` / ``restore`` bring parameters and statistics back bit for
    bit."""
    _, _, tm = _modules(seed=7)
    spec = tzoo.ModelSpec(name="bn", module=tm, context=CTX,
                          min_size=2 * CTX + 1)
    image, labels, mask, tb = synthetic_task(size=28, seed=0)
    cfg = TrainConfig(patch_size=2 * CTX + 6, batch_size=4,
                      steps_per_epoch=3, learning_rate=3e-3)
    net = FplNetwork(spec, device=CPU, train_config=cfg)
    assert net.infer_spec.name == "bn+packed"
    before = {k: b.clone() for k, b in tm.named_buffers()}
    hist = net.train(image, labels, mask, epochs=1,
                     val_data=(image, labels, mask))
    assert np.isfinite(hist[0]["loss"]) and "val_loss" in hist[0]
    assert not tm.training
    assert all(not torch.equal(b, before[k]) for k, b in tm.named_buffers())
    plain = FplNetwork(spec, device=CPU, packed=False)
    packed_map = net.infer(image, tile_out=12)
    np.testing.assert_allclose(plain.infer(image, tile_out=12), packed_map,
                               rtol=0, atol=1e-5)
    assert len(net.detect(image, threshold=0.0 + float(np.median(packed_map)))) > 0

    path = str(tmp_path / "bn.pt")
    net.save(path)
    other = FplNetwork(tzoo.ModelSpec(
        name="bn", module=_modules(seed=9)[2], context=CTX,
        min_size=2 * CTX + 1), device=CPU)
    other.restore(path)
    for (k, a), (_, b) in zip(net.module.state_dict().items(),
                              other.module.state_dict().items()):
        assert torch.equal(a, b), k
    np.testing.assert_array_equal(other.infer(image, tile_out=12), packed_map)


if __name__ == "__main__":
    print({k: f"{v:.3g}" for k, v in bf16_gaps().items()})
