"""The port's training (``flypylib_tpu_torch.train``, the gradients of K1
and K5, ``forward_train`` of both packed engines, ``FplNetwork.train``)
against the JAX package's, on the CPU.

Tolerances:

- the autograd Functions of K1 and K5 against autograd through their plain
  versions: K5 exact (a permutation), K1 max |err| <= 1e-6 max |ref| per
  tensor (f32; the library's conv gradients on both sides, summed in
  other orders);
- one step of an f32 model against JAX's on the same parameters and the
  same numpy batch ``(x, y, m, codes)``: the loss to rel 1e-5, every
  parameter's gradient within 1e-4 of that gradient's max |g| (f32 convs
  summed in other orders through up to six layers);
- Adam against ``optax.adam`` from the same gradients: rel 1e-5 after one
  and two steps;
- packed against plain training (same init, same sampling stream): the
  reference's own test's, loss within 1e-3, params rtol 2e-3, atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flypylib_tpu.models import zoo as jzoo
from flypylib_tpu.ops import packed_conv as jpc
from flypylib_tpu.ops import packed_unet as jpu
from flypylib_tpu.ops.augment import augment_patch as j_augment_patch
from flypylib_tpu.train import trainer as jtr
from flypylib_tpu_torch import FplNetwork
from flypylib_tpu_torch.io.synapses import Tbars, make_training_volumes
from flypylib_tpu_torch.models import zoo as tzoo
from flypylib_tpu_torch.ops import packed_conv as tpc
from flypylib_tpu_torch.ops import packed_unet as tpu
from flypylib_tpu_torch.ops.conv import Conv3dBiasReLU, conv3d_reference
from flypylib_tpu_torch.ops.split import parity_split_reference
from flypylib_tpu_torch.train import trainer as ttr
from flypylib_tpu_torch.train import TrainConfig, Trainer
from tests.conftest import make_blob_volume

torch.set_num_threads(1)

CPU = "cpu"
CONV = dict(features=(8, 8, 8, 8), dilations=(1, 1, 2, 2), head_features=16)
UNET = dict(base_features=4, levels=2, convs_per_stage=1)
GRAD_TOL = 1e-4  # of each gradient's max |g|
LOSS_RTOL = 1e-5


def _close(got, want, tol, what=""):
    """max |got - want| <= tol * max |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |err| {err} > {tol} x {scale}"


# -- the autograd Functions -------------------------------------------------
@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("x_grad", [False, True], ids=["layer0", "inner"])
def test_k1_function_backward_equals_autograd_of_plain(d, x_grad):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(0, 1, (2, 9, 10, 11, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.3, (3, 3, 3, 3, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, 5).astype(np.float32))
    dy = torch.from_numpy(rng.normal(0, 1, (2, 9 - 2 * d, 10 - 2 * d,
                                            11 - 2 * d, 5)).astype(np.float32))
    grads = []
    for fn in (Conv3dBiasReLU.apply, conv3d_reference):
        xs, ws, bs = (t.clone().requires_grad_(r)
                      for t, r in ((x, x_grad), (w, True), (b, True)))
        y = fn(xs, ws, bs, d)
        y.backward(dy)
        grads.append((y.detach(), xs.grad, ws.grad, bs.grad))
    (y1, dx1, dw1, db1), (y0, dx0, dw0, db0) = grads
    assert torch.equal(y1, y0)
    assert (dx1 is None) == (not x_grad)
    for got, want, what in ((dw1, dw0, "dw"), (db1, db0, "db"),
                            (dx1, dx0, "dx")):
        if want is not None:
            assert got.shape == want.shape and got.dtype == want.dtype
            _close(got, want.numpy(), 1e-6, what)


def test_k5_function_backward_is_the_inverse_permutation():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 4, 5, 24)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (16, 3, 4, 5, 3)).astype(np.float32))
    xs = x.clone().requires_grad_(True)
    y = tpc.parity_batch(xs)
    assert y.grad_fn is not None and "ParityBatch" in type(y.grad_fn).__name__
    y.backward(g)
    x0 = x.clone().requires_grad_(True)
    parity_split_reference(x0).backward(g)
    assert torch.equal(xs.grad, x0.grad)
    assert torch.equal(xs.grad, tpc.parity_unbatch(g))
    with torch.no_grad():  # a direct call under no_grad
        assert tpc.parity_batch(x).grad_fn is None


def _tie_input():
    """One 2^3 pooling window whose max (1.0) appears twice, at window
    positions 3 = (0, 1, 1) and 5 = (1, 0, 1)."""
    x = np.zeros((1, 2, 2, 2, 1), np.float32)
    x[0, 0, 1, 1, 0] = x[0, 1, 0, 1, 0] = 1.0
    return x


def test_pool_tie_gradients_are_flax_max_pool():
    import flax.linen as nn

    x = _tie_input()
    want = np.asarray(jax.grad(lambda v: nn.max_pool(
        v, (2, 2, 2), strides=(2, 2, 2)).sum())(jnp.asarray(x)))
    assert want.ravel().tolist() == [0, 0, 0, 1, 0, 0, 0, 0]  # first wins
    xs = torch.from_numpy(x).requires_grad_(True)
    tzoo._max_pool2(xs).sum().backward()
    np.testing.assert_array_equal(xs.grad.numpy(), want)
    # the packed pool on the packed tensor: the same voxel gets it
    xp = tpc.pack_volume(torch.from_numpy(np.tile(x, (1, 2, 2, 2, 1))))
    for exact in (True, False):
        xq = xp.clone().requires_grad_(True)
        tpu.pool_pack(xq, grad_exact=exact).sum().backward()
        g = tpc.unpack_volume(xq.grad)[:, :2, :2, :2].numpy()
        if exact:
            np.testing.assert_array_equal(g, want)
        else:  # amax splits the tie, as the reference's grad_exact form
            assert g.ravel()[[3, 5]].tolist() == [0.5, 0.5]


# -- one step against JAX ---------------------------------------------------
def _flax_params(module, rng, patch, tie=False):
    """Random f32 params in Flax's tree (lecun-scaled kernels, non-zero
    biases).  ``tie``: the first conv keeps only its centre tap, with
    dyadic weights and bias, so that on integer inputs its outputs are
    exact in every engine and positive ties reach the first pool."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, patch, patch, patch, 1)))["params"]
    params = {}
    for name, layer in shapes.items():
        k = layer["kernel"].shape
        params[name] = {
            "kernel": rng.normal(0, np.prod(k[:-1]) ** -0.5, k).astype(np.float32),
            "bias": rng.normal(0, 0.1, layer["bias"].shape).astype(np.float32),
        }
    if tie:
        k = np.zeros_like(params["Conv_0"]["kernel"])
        k[1, 1, 1, 0] = np.asarray([0.5, 0.25, 0.75, 1.0])[: k.shape[-1]]
        params["Conv_0"] = {"kernel": k,
                            "bias": np.full(k.shape[-1], 0.25, np.float32)}
    return params


def _models(kind, rng, patch, tie=False):
    """(JAX forwards by engine, Flax params, the port's spec) on the same
    f32 params."""
    if kind == "conv":
        jm = jzoo.ConvStack(dtype=jnp.float32, **CONV)
        jpacked = jpc.PackedConvStack(jm)
        tspec = tzoo.baseline_model(dtype=torch.float32, **CONV)
    else:
        kw = UNET if not tie else dict(base_features=4, levels=1,
                                       convs_per_stage=1)
        jm = jzoo.UNetValid(dtype=jnp.float32, **kw)
        jpacked = jpu.PackedUNet(jm)
        tspec = tzoo.unet(dtype=torch.float32, **kw)
    params = _flax_params(jm, rng, patch, tie)
    tspec.module.load_state_dict(tzoo.params_from_flax({"params": params}))
    fwd = {"plain": lambda v, x: jm.apply(v, x, train=True),
           "packed": jpacked.forward_train}
    return fwd, params, tspec


def _batch(rng, n, patch, ctx, integer=False):
    out = patch - 2 * ctx
    if integer:
        x = rng.integers(0, 4, (n, patch, patch, patch)).astype(np.float32)
    else:
        x = rng.random((n, patch, patch, patch)).astype(np.float32)
    y = (rng.random((n, out, out, out)) > 0.7).astype(np.float32)
    m = (rng.random((n, out, out, out)) > 0.1).astype(np.float32)
    codes = rng.integers(0, 16, n).astype(np.int32)
    return x, y, m, codes


def _jax_step(fwd, params, batch):
    x, y, m, codes = (jnp.asarray(a) for a in batch)

    def loss(p):
        aug = jax.vmap(j_augment_patch)
        xa, ya, ma = aug(x, codes), aug(y, codes), aug(m, codes)
        logits = fwd({"params": p}, xa[..., None])[..., 0]
        return jtr.masked_bce_loss(logits, ya, ma)

    val, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(val), tzoo.params_from_flax({"params": grads})


def _port_step(spec, engine, batch, patch):
    cfg = TrainConfig(patch_size=patch, batch_size=len(batch[0]),
                      engine=engine)
    loss_fn, _, p = ttr.make_loss_fn(spec, cfg)
    assert p == patch
    module = spec.module
    module.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(*(torch.from_numpy(a) for a in batch))
    loss.backward()
    grads = {n: q.grad for n, q in module.named_parameters()}
    assert float(metrics["loss"]) == float(loss.detach())
    return float(loss.detach()), grads


@pytest.mark.parametrize("engine", ["plain", "packed"])
@pytest.mark.parametrize("kind,patch,n", [("conv", 18, 4), ("unet", 30, 4)])
def test_loss_and_gradients_match_jax(kind, patch, n, engine):
    rng = np.random.default_rng(5)
    fwd, params, tspec = _models(kind, rng, patch)
    batch = _batch(rng, n, patch, tspec.context)
    want_loss, want = _jax_step(fwd[engine], params, batch)
    got_loss, got = _port_step(tspec, engine, batch, patch)
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert got.keys() == want.keys()
    for name, g in got.items():
        assert g is not None and torch.isfinite(g).all(), name
        _close(g, want[name].numpy(), GRAD_TOL, name)


@pytest.mark.parametrize("engine", ["plain", "packed"])
def test_positive_pool_ties_match_jax_plain(engine):
    """Positive ties in the first pool, on both U-Net engines: the
    gradients are those of the Flax ``UNetValid`` (``nn.max_pool``: the
    first maximum in window order takes it all).  The JAX packed engine's
    reduce-max splits such ties, so it misses these gradients by more than
    the tolerance: the case bites."""
    patch = 18
    rng = np.random.default_rng(9)
    fwd, params, tspec = _models("unet", rng, patch, tie=True)
    batch = _batch(rng, 4, patch, tspec.context, integer=True)
    want_loss, want = _jax_step(fwd["plain"], params, batch)
    got_loss, got = _port_step(tspec, engine, batch, patch)
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    for name, g in got.items():
        _close(g, want[name].numpy(), GRAD_TOL, name)
    _, split = _jax_step(fwd["packed"], params, batch)
    w0, s0 = want["convs.0.weight"].numpy(), split["convs.0.weight"].numpy()
    assert np.abs(w0 - s0).max() > 10 * GRAD_TOL * np.abs(w0).max()


def test_adam_matches_optax():
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(0, 1, (3, 4)).astype(np.float32),
              "b": rng.normal(0, 0.1, 4).astype(np.float32)}
    grads = [{k: rng.normal(0, s, v.shape).astype(np.float32)
              for k, v in params.items()} for s in (1.0, 1e-3)]
    lr = 1e-3
    tx = optax.adam(lr)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()})
    state = ttr.TrainState.create(module, lr)
    for g in grads:
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k])
        state.optimizer.step()
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-8)


# -- sampling against JAX ---------------------------------------------------
def test_corners_from_the_same_draws_equal_jax():
    rng = np.random.default_rng(3)
    shapes = [(24, 26, 22), (30, 20, 28)]
    images = [rng.integers(0, 256, s).astype(np.uint8) for s in shapes]
    labels = [(rng.random(s) > 0.995).astype(np.float32) for s in shapes]
    masks = [np.ones(s, np.float32) for s in shapes]
    patch, n = 14, 64
    for pos_cap in (65536, 40):  # 40: subsampled by default_rng(0)
        jd = jtr.TrainData.build(images, labels, masks, patch, pos_cap)
        td = ttr.TrainData.build(images, labels, masks, patch, pos_cap,
                                 device=CPU)
        np.testing.assert_array_equal(td.pos_locs.numpy(), np.asarray(jd.pos_locs))
        np.testing.assert_array_equal(td.corner_max.numpy(),
                                      np.asarray(jd.corner_max))
        assert td.n_pos == int(jd.n_pos) and td.images.dtype == torch.uint8
        cfg = jtr.TrainConfig(patch_size=patch, batch_size=n)
        key = jax.random.PRNGKey(pos_cap)
        k_v, k_u, k_p, k_j, k_mix = jax.random.split(key, 5)
        draws = {  # the reference's draws, as _sample_batch makes them
            "vidx_u": jax.random.randint(k_v, (n,), 0, len(images)),
            "u": jax.random.uniform(k_u, (n, 3)),
            "pidx": jax.random.randint(k_p, (n,), 0, max(td.n_pos, 1)),
            "jitter": jax.random.randint(k_j, (n, 3), -cfg.pos_jitter,
                                         cfg.pos_jitter + 1),
            "mix": jax.random.uniform(k_mix, (n,)),
        }
        draws = {k: torch.from_numpy(np.array(v)).to(
            torch.float32 if v.dtype == jnp.float32 else torch.int64)
            for k, v in draws.items()}
        vidx, corners = ttr._corners(draws, td, patch, TrainConfig(
            patch_size=patch, batch_size=n))
        j_vidx, j_corners = jtr._sample_batch(key, n, jd, patch, cfg)
        np.testing.assert_array_equal(vidx.numpy(), np.asarray(j_vidx))
        np.testing.assert_array_equal(corners.numpy(), np.asarray(j_corners))
        assert 0 < int(np.asarray(draws["mix"] < 0.5).sum()) < n  # both kinds
        got = ttr._gather(td.images, vidx, corners, patch)
        want = jax.vmap(lambda v, c: jtr._gather(jd.images, v, c, patch))(
            j_vidx, j_corners)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_batches_stay_in_their_volumes():
    rng = np.random.default_rng(4)
    image = rng.random((20, 22, 24)).astype(np.float32)
    labels = (rng.random(image.shape) > 0.99).astype(np.float32)
    cfg = TrainConfig(patch_size=12, batch_size=32, engine="plain")
    spec = tzoo.baseline_model(dtype=torch.float32, **CONV)
    _, sample_fn, patch = ttr.make_loss_fn(spec, cfg)
    td = ttr.TrainData.build(image, labels, np.ones_like(labels), patch,
                             device=CPU)
    gen = torch.Generator().manual_seed(0)
    vidx, corners = ttr._sample_batch(gen, 256, td, patch, cfg)
    assert (corners >= 0).all() and (corners <= td.corner_max[vidx]).all()
    x, y, m, codes = sample_fn(gen, td)
    out = patch - 2 * spec.context
    assert x.shape == (32, patch, patch, patch) and x.dtype == torch.float32
    assert y.shape == m.shape == (32, out, out, out)
    assert codes.shape == (32,) and int(codes.min()) >= 0 and int(codes.max()) < 16


# -- behaviour (tests/test_train.py's, on the port) -------------------------
def synthetic_task(size=32, n_pts=5, seed=0):
    """Bright Gaussian blobs on noise; labels = balls at blob centres."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(6, size - 6, (n_pts, 3))
    image, _ = make_blob_volume((size,) * 3, centers=centers, sigma=2.0)
    image = image + rng.normal(0, 0.05, image.shape).astype(np.float32)
    tb = Tbars(locs=centers.astype(np.float64))
    labels, mask = make_training_volumes(tb, size, radius=2, radius_ign=4)
    return image.astype(np.float32), labels, mask, tb


def small_spec(seed=0):
    return tzoo.baseline_model(features=(8, 8), dilations=(1, 2),
                               head_features=16, dtype=torch.float32,
                               seed=seed)


def _params(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def test_loss_decreases():
    image, labels, mask, _ = synthetic_task()
    cfg = TrainConfig(patch_size=14, batch_size=8, steps_per_epoch=15,
                      learning_rate=3e-3)
    hist = Trainer(small_spec(), cfg, seed=0, device=CPU).fit(
        image, labels, mask, epochs=2)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert {"loss", "pos_frac", "pred_mean", "epoch"} <= hist[0].keys()


def test_same_seed_same_history_and_params():
    image, labels, mask, _ = synthetic_task()
    cfg = TrainConfig(patch_size=13, batch_size=4, steps_per_epoch=3,
                      engine="plain")
    runs = []
    for _ in range(2):
        tr = Trainer(small_spec(), cfg, seed=7, device=CPU)
        runs.append((tr.fit(image, labels, mask), _params(tr.module)))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
    other = Trainer(small_spec(), cfg, seed=8, device=CPU).fit(
        image, labels, mask)
    assert other[0]["loss"] != runs[0][0][0]["loss"]


def test_masked_loss_ignores_masked_voxels():
    logits = torch.tensor([[10.0, -10.0]])
    labels = torch.tensor([[0.0, 0.0]])
    # first voxel badly wrong but masked out -> loss ~ 0
    assert float(ttr.masked_bce_loss(logits, labels,
                                     torch.tensor([[0.0, 1.0]]))) < 1e-3
    assert float(ttr.masked_bce_loss(logits, labels,
                                     torch.tensor([[1.0, 1.0]]))) > 1.0
    rng = np.random.default_rng(0)  # the reference's formula
    lg = rng.normal(0, 5, (3, 4, 5)).astype(np.float32)
    lb = (rng.random(lg.shape) > 0.5).astype(np.float32)
    mk = (rng.random(lg.shape) > 0.3).astype(np.float32)
    want = float(jtr.masked_bce_loss(jnp.asarray(lg), jnp.asarray(lb),
                                     jnp.asarray(mk)))
    got = float(ttr.masked_bce_loss(*(torch.from_numpy(a) for a in (lg, lb, mk))))
    assert abs(got - want) <= LOSS_RTOL * abs(want)


def test_checkpoint_roundtrip(tmp_path):
    image, labels, mask, _ = synthetic_task()
    cfg = TrainConfig(patch_size=13, batch_size=4, steps_per_epoch=2)
    tr = Trainer(small_spec(), cfg, seed=0, device=CPU)
    tr.fit(image, labels, mask)
    path = str(tmp_path / "ckpt.pt")
    tr.save(path)
    tr2 = Trainer(small_spec(seed=1), cfg, seed=1, device=CPU)
    tr2.init_state()
    before = _params(tr2.module)
    tr2.restore(path)
    after = _params(tr2.module)
    for k, v in _params(tr.module).items():
        assert torch.equal(after[k], v), k
    assert any(not torch.equal(before[k], after[k]) for k in after)


def test_multi_volume_and_uint8_training():
    imgs, labs, msks = [], [], []
    for seed, size in [(0, 28), (1, 34)]:
        im, lb, mk, _ = synthetic_task(size=size, seed=seed)
        imgs.append(im)
        labs.append(lb)
        msks.append(mk)
    cfg = TrainConfig(patch_size=13, batch_size=8, steps_per_epoch=6,
                      learning_rate=3e-3)
    hist = Trainer(small_spec(), cfg, seed=0, device=CPU).fit(
        imgs, labs, msks, epochs=2)
    assert np.isfinite(hist[-1]["loss"])
    assert hist[-1]["loss"] < hist[0]["loss"] * 1.5  # runs without blow-up
    img8 = [(np.clip(im, 0, 1) * 255).astype(np.uint8) for im in imgs]
    tr = Trainer(small_spec(), cfg, seed=0, device=CPU)
    hist8 = tr.fit(img8, labs, msks, epochs=1)
    assert np.isfinite(hist8[0]["loss"])
    # uint8 stays uint8 on the device; the step scales it by 1/255
    _, sample_fn, patch = ttr.make_loss_fn(tr.spec, cfg)
    data = ttr.TrainData.build(img8, labs, msks, patch, device=CPU)
    assert data.images.dtype == torch.uint8
    x = sample_fn(torch.Generator().manual_seed(0), data)[0]
    assert float(x.max()) <= 1.0 and x.dtype == torch.float32


def test_fit_validation_metrics_and_val_every(tmp_path):
    from flypylib_tpu_torch.utils.metrics import MetricsLog

    image, labels, mask, _ = synthetic_task(size=28, n_pts=4, seed=0)
    v_img, v_lab, v_mask, v_tb = synthetic_task(size=28, n_pts=4, seed=1)
    cfg = TrainConfig(patch_size=13, batch_size=4, steps_per_epoch=3,
                      learning_rate=3e-3)
    tr = Trainer(small_spec(), cfg, seed=0, device=CPU)
    log = MetricsLog(str(tmp_path / "metrics.jsonl"))
    hist = tr.fit(image, labels, mask, epochs=3,
                  val_data=(v_img, v_lab, v_mask), val_tbars=v_tb,
                  val_every=2, metrics_log=log)
    for key in ("val_loss", "val_voxel_precision", "val_voxel_recall",
                "val_obj_precision", "val_obj_recall"):
        assert key in hist[0] and np.isfinite(hist[0][key]), key
    assert "val_loss" not in hist[1] and "val_loss" in hist[2]
    assert len(log.records) == 3 and "val_loss" in log.records[0]


def test_validation_engine_cached_at_infer_spec_tiling(monkeypatch):
    import flypylib_tpu_torch.infer.tiled as tiled_mod
    from flypylib_tpu_torch.infer.tiled import default_tiling

    calls = []
    real = tiled_mod.TiledInference

    class Counting(real):
        def __init__(self, *a, **kw):
            calls.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(tiled_mod, "TiledInference", Counting)
    net = FplNetwork(tzoo.unet(base_features=4, levels=1, convs_per_stage=1,
                               dtype=torch.float32), device=CPU,
                     train_config=TrainConfig(patch_size=14, batch_size=2,
                                              steps_per_epoch=1))
    tr = net.trainer
    assert tr.infer_spec is net.infer_spec and tr.infer_spec is not tr.spec
    n = net.infer_spec.valid_size(2 * net.infer_spec.context + 12)
    rng = np.random.default_rng(0)
    img = rng.random((n, n, n)).astype(np.float32)
    lab = np.zeros((n, n, n), np.float32)
    tr.fit(img, lab, np.ones_like(lab), epochs=3,
           val_data=(img, lab, np.ones_like(lab)))
    assert len(calls) == 1  # one engine, three validation epochs
    assert tr._val_engine_key == default_tiling(net.infer_spec, (n, n, n))
    assert tr._val_engine.spec is net.infer_spec
    assert tr._val_engine.tile_out >= n - 2 * net.infer_spec.context


def test_packed_engine_matches_plain():
    """The same objective: with an f32 model, the same init and the same
    sampling stream, the packed and plain trajectories match to
    re-association tolerance."""
    image, labels, mask, _ = synthetic_task()
    p = 18
    histories, params = [], []
    for engine in ("plain", "packed"):
        spec = tzoo.baseline_model(features=(8, 8), dilations=(1, 2),
                                   head_features=16, dtype=torch.float32)
        assert spec.valid_size(p) == tpc.packed_spec(spec).valid_size(p) == p
        cfg = TrainConfig(patch_size=p, batch_size=8, steps_per_epoch=6,
                          engine=engine)
        tr = Trainer(spec, cfg, seed=3, device=CPU)
        histories.append(tr.fit(image, labels, mask, epochs=2))
        params.append(_params(tr.module))
    for a, b in zip(*histories):
        assert abs(a["loss"] - b["loss"]) < 1e-3
    for k, v in params[0].items():
        np.testing.assert_allclose(v.numpy(), params[1][k].numpy(),
                                   rtol=2e-3, atol=2e-4)


def test_auto_engine_resolution():
    spec = small_spec()
    assert TrainConfig().engine == "auto"
    assert ttr._PACKED_BATCH_CROSSOVER == jtr._PACKED_BATCH_CROSSOVER == 96
    assert ttr.resolve_engine(spec, TrainConfig(batch_size=32)) == "packed"
    assert ttr.resolve_engine(spec, TrainConfig(batch_size=96)) == "plain"
    assert ttr.resolve_engine(
        spec, TrainConfig(batch_size=128, engine="packed")) == "packed"
    assert ttr.resolve_engine(
        spec, TrainConfig(batch_size=8, engine="plain")) == "plain"
    tiny = tzoo.unet(base_features=4, levels=1, convs_per_stage=1)
    assert ttr.resolve_engine(tiny, TrainConfig(batch_size=8)) == "packed"
    odd = tzoo.baseline_model(dilations=(1, 1, 3, 3))  # no packed engine
    assert ttr.resolve_engine(odd, TrainConfig(batch_size=8)) == "plain"
    # a packed spec trains through its forward_train; a kernel tail through
    # its unfused twin (its kernels have no backward)
    kspec = tpu.packed_unet_spec(tiny, tail_impl="pallas2")
    tspec = ttr.resolve_train_spec(kspec, TrainConfig(batch_size=8))
    assert tspec.module.tail_impl == "xla" and tspec.module.inner is tiny.module
    with pytest.raises(ValueError, match="no backward"):
        kspec.module.forward_train(torch.zeros(1, 18, 18, 18, 1))


def test_unknown_and_unsupported_engines_raise():
    image, labels, mask, _ = synthetic_task(size=20)
    with pytest.raises(ValueError, match="unknown engine"):
        Trainer(small_spec(), TrainConfig(engine="fast"), device=CPU).fit(
            image, labels, mask)
    odd = tzoo.baseline_model(dilations=(1, 1, 3, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="ConvStack or UNetValid"):
        Trainer(odd, TrainConfig(engine="packed"), device=CPU).fit(
            image, labels, mask)


def test_network_train_evaluate_save_restore(tmp_path):
    """``FplNetwork(..., device="cpu")``: train on T-bars, then evaluate
    the map and the voxels on both routes, and a checkpoint round trip."""
    image, _, _, tb = synthetic_task(size=32, n_pts=5, seed=2)
    cfg = TrainConfig(patch_size=14, batch_size=8, steps_per_epoch=10,
                      learning_rate=3e-3)
    net = FplNetwork("baseline", device=CPU, dtype=torch.float32,
                     features=(8, 8), dilations=(1, 2), head_features=16,
                     train_config=cfg)
    hist = net.train(image, tbars=tb, epochs=2, radius=2.0)
    assert len(hist) == 2 and hist[-1]["loss"] < hist[0]["loss"]
    assert net._tiled is None
    prob = net.infer(image)
    curve = net.evaluate(prob, tb, dist_thresh=4.0)
    assert curve["num_gt"] == len(tb) and np.isfinite(curve["precision"]).all()
    lab, msk = make_training_volumes(tb, image.shape, radius=2.0,
                                     border=net.context)
    small = net.evaluate_voxels(image, lab, msk)
    streamed = net.evaluate_voxels(image, lab, msk, slab=8)
    from flypylib_tpu_torch.ops.matching import voxel_pr

    ref = voxel_pr(prob, lab, msk)
    for k in ref:
        np.testing.assert_array_equal(small[k], ref[k])
        np.testing.assert_array_equal(streamed[k], ref[k])
    path = str(tmp_path / "net.pt")
    net.save(path)
    other = FplNetwork("baseline", device=CPU, seed=5, dtype=torch.float32,
                       features=(8, 8), dilations=(1, 2), head_features=16)
    other.restore(path)
    np.testing.assert_array_equal(other.infer(image), prob)
