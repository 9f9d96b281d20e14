"""Two real processes on the CPU (gloo): the counterpart of
``tests/test_distributed.py`` for the port, and the CPU rehearsal of
``chip_smoke.py`` phase 14(d), whose worker it runs
(``chip_smoke.dist_worker``, each rank a subprocess with a timeout on a
free localhost port).

Both ranks join one world through ``ensure_initialized``, sum a value over
it and read ``local_batch_size``; ``sharded_infer`` / ``sharded_nms`` /
``sharded_components`` over a 1-D (4 slots) and a 2-D (2 x 2) mesh that
span both ranks give ``TiledInference``'s map bit for bit at the same tile
and batch, and the host reference's lists; the data-parallel step (rows
split over the ranks, gradients summed over gloo) equals the single-process
step on the same global batch within the reference's limits (gradients
per tensor within 1e-4, a BatchNorm stack's against an f64 truth), for the
packed stack and a BatchNorm stack, on both ranks with one loss; and the
two broken controls (local mask counts, per-rank BatchNorm moments) fail
that check.

The same two-rank DP steps are held against the reference's
``make_dp_train_step`` on conftest's virtual CPU devices: rank 0 writes its
starting weights, the augmented global batch, and the step's loss,
gradients and parameters, and JAX runs its DP step over a 2-device data
axis from those weights on that batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
import flypylib_tpu_torch as tpt
from flypylib_tpu.models import zoo as jzoo
from flypylib_tpu.parallel import make_dp_train_step, make_mesh
from flypylib_tpu.train import trainer as jtr
from flypylib_tpu_torch.models import zoo as tzoo
from flypylib_tpu_torch.ops.host_reference import components_host, nms_host

SMALL = dict(features=(4, 6), dilations=(1, 2), head_features=8,
             dtype=torch.float32)
VOLUME = 32
TILING = (8, 4)
# the reference's DP limits (tests/test_parallel.py): loss rtol, parameters
# atol; gradients per tensor relative to its max |g| (12(a)'s f32 limit)
LOSS_RTOL, PARAM_ATOL, GRAD_TOL = 1e-5, 1e-5, 1e-4


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One run of two gloo ranks: their JSON lines, the directory rank 0
    wrote to, the monolithic map and its threshold."""
    out = tmp_path_factory.mktemp("gloo")
    net = tpt.FplNetwork("baseline", device="cpu", seed=0, **SMALL)
    vol = chip_smoke.make_volume_u8(VOLUME, VOLUME // 16, seed=0)
    want = net.infer(vol, *TILING)
    thr = float(np.quantile(want, 0.97))
    ranks = chip_smoke.run_dist_workers({
        "device": "cpu", "backend": "gloo", "small": True, "volume": VOLUME,
        "threshold": thr, "tiling": list(TILING),
        "meshes": [list(m) for m in chip_smoke.DIST_MESHES],
        "out": str(out), "dump": True,
        "dp": ["baseline", "bn", "local_count", "local_moments"]}, world=2)
    return ranks, out, want, thr


def test_two_gloo_ranks(two_ranks):
    ranks, out, want, thr = two_ranks
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["psum"] == 3.0 and r["local_batch"] == 4
        assert r["dp"]["baseline"]["loss"] == ranks[0]["dp"]["baseline"]["loss"]
        assert r["dp"]["baseline"]["loss"] > 0
        for case in ("baseline", "bn"):
            assert chip_smoke.dp_ok(r["dp"][case]), (case, r["dp"][case])
        assert r["dp"]["bn"]["truth"] is not None
        for case in ("local_count", "local_moments"):
            assert not chip_smoke.dp_ok(r["dp"][case]), (case, r["dp"][case])
    nms = nms_host(want, window=chip_smoke.NMS_WINDOW, threshold=thr)
    cc = components_host(want, threshold=thr)
    assert len(nms) > 0 and len(cc) > 0
    for label, _, _ in chip_smoke.DIST_MESHES:
        np.testing.assert_array_equal(np.load(out / f"{label}.npy"), want)
        lists = np.load(out / f"{label}_lists.npz")
        for key, ref in (("nms", nms), ("cc", cc)):
            np.testing.assert_array_equal(lists[f"{key}_locs"], ref.locs)
            np.testing.assert_array_equal(lists[f"{key}_conf"], ref.conf)


def _jax_spec(bn: bool):
    kw = {k: v for k, v in SMALL.items() if k != "dtype"}
    if not bn:
        return jzoo.baseline_model(dtype=jnp.float32, **kw)
    return jzoo.ModelSpec(name="baseline_bn", context=sum(kw["dilations"]),
                          min_size=2 * sum(kw["dilations"]) + 1,
                          module=jzoo.ConvStack(dtype=jnp.float32,
                                                use_batchnorm=True, **kw))


@pytest.mark.parametrize("case", ["baseline", "bn"])
def test_two_gloo_rank_dp_step_equals_jax(two_ranks, monkeypatch, case):
    """The two-rank DP step (packed for the plain stack, plain with
    BatchNorm) against the reference's ``make_dp_train_step`` over two
    virtual CPU devices, from the same weights on the same augmented global
    batch (the reference's sampler returns that batch; augmentation off on
    its side): the loss, every gradient and every parameter and running
    statistic after the Adam step.  With BatchNorm both packages' f32
    gradients are held to an f64 truth on that batch, as 13(c) holds them
    (the reference's own lies up to 1.3e-4 of a tensor's max |g| from it
    here): the port's within max(1e-4, 2 x the reference's distance).  A
    body conv's bias before BatchNorm has a true gradient of 0, so its
    gradient is held to its kernel's scale, and an element whose gradient
    is 0 up to the gradients' limit is left out of the parameter check
    (Adam's first step moves it by about lr either way)."""
    _, out, _, _ = two_ranks
    got = np.load(out / f"dp_{case}.npz")
    part = {p: {k[len(p):]: got[k] for k in got.files if k.startswith(p)}
            for p in ("w0:", "grad:", "after:")}
    x, y, m = got["x"], got["y"], got["m"]
    n, patch = x.shape[:2]
    ctx = (patch - y.shape[1]) // 2
    spec = _jax_spec(case == "bn")
    cfg = jtr.TrainConfig(patch_size=patch, batch_size=n, augment=False,
                          engine="packed" if case == "baseline" else "plain")
    assert jtr.resolve_engine(spec, cfg) == cfg.engine
    data = jtr.TrainData.build(list(x), [np.pad(a, ctx) for a in y],
                               [np.pad(a, ctx) for a in m], patch)
    monkeypatch.setattr(jtr, "_sample_batch", lambda key, k, *a: (
        jnp.arange(k), jnp.zeros((k, 3), jnp.int32)))
    variables = tzoo.flax_from_params(
        {k: torch.from_numpy(v) for k, v in part["w0:"].items()})
    tx = optax.adam(cfg.learning_rate)
    state = jtr.TrainState.create(variables, tx)
    key = jax.random.PRNGKey(0)
    loss_fn, _ = jtr.make_loss_fn(spec, cfg)
    (_, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params, state.batch_stats, key, data)
    step, _, _ = make_dp_train_step(spec, cfg, make_mesh(2, axis="data"))
    new, metrics = step(state, key, data)

    want_loss = float(metrics["loss"])
    assert abs(float(got["loss"]) - want_loss) <= LOSS_RTOL * abs(want_loss)
    grads = tzoo.params_from_flax({"params": jgrads,
                                   "batch_stats": state.batch_stats})
    after = tzoo.params_from_flax({"params": new.params,
                                   "batch_stats": new.batch_stats})
    assert set(part["after:"]) == set(after)
    limits = dict.fromkeys(part["grad:"], GRAD_TOL)
    if case == "bn":
        g64 = chip_smoke.bn_f64_grads(
            {k: torch.from_numpy(v) for k, v in part["w0:"].items()},
            (x, y, m, np.zeros(n, np.int64)), None, SMALL["dilations"])
        mine = chip_smoke.bn_truth_errors(
            {k: torch.from_numpy(v) for k, v in part["grad:"].items()}, g64)
        ref = chip_smoke.bn_truth_errors(grads, g64)
        limits = {k: max(GRAD_TOL, chip_smoke.BN_TRUTH_RATIO * ref[k])
                  for k in limits}
        for k in limits:
            assert mine[k] <= limits[k], (k, mine[k], ref[k])
    for k, g in part["grad:"].items():
        jg = grads[k].numpy()
        before_bn = case == "bn" and k.startswith("convs.") and \
            k.endswith(".bias")
        ref = grads[k.replace(".bias", ".weight")].numpy() if before_bn \
            else jg
        scale = float(np.abs(ref).max())
        if case != "bn":
            assert np.abs(g - jg).max() <= GRAD_TOL * scale, k
        live = np.abs(jg) > limits[k] * scale
        np.testing.assert_allclose(part["after:"][k][live],
                                   after[k].numpy()[live], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    for k in set(after) - set(part["grad:"]):  # BatchNorm's running stats
        np.testing.assert_allclose(part["after:"][k], after[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
