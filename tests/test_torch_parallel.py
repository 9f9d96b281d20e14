"""The port's multi-device layer (``flypylib_tpu_torch/parallel/``) on
virtual CPU meshes (``devices=["cpu"] * k``) against the port's own
monolithic results, the host reference and the JAX package's
``flypylib_tpu/parallel`` on conftest's 8 virtual CPU devices.

- Mesh helpers: shapes, slots, placements, one module copy per distinct
  device.
- ``sharded_infer`` over 1-, 2- and 3-D meshes (non-divisible, thin,
  ``tile_z``, ``tile_out``, the packed spec, uint8): bitwise the port's
  monolithic map in f32 (``TiledInference``'s at the same tile and batch
  for ``tile_out``), JAX's ``sharded_infer`` on the same weights to 1e-4
  on the logits.
- ``sharded_nms`` / ``sharded_components``: seams, a plateau across a
  seam, a component through every shard, random volumes; lists equal
  ``nms_host`` / ``components_host`` and JAX's exactly (centroids to
  1e-12), from numpy and from a ``ShardedMap`` left where it lies.
- The data-parallel step equals the single step (same seed; BatchNorm
  included) and, on a fixed batch, JAX's step with optax's Adam: loss to
  rtol 1e-5, parameters to atol 1e-5.
Sizes are those of the JAX tests conftest does not mark slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flypylib_tpu import parallel as jpar
from flypylib_tpu.models import zoo as jzoo
from flypylib_tpu.ops.augment import augment_patch as j_augment_patch
from flypylib_tpu.train import trainer as jtr
from flypylib_tpu_torch import parallel as tpar
from flypylib_tpu_torch.infer.tiled import TiledInference
from flypylib_tpu_torch.models import zoo as tzoo
from flypylib_tpu_torch.ops.host_reference import components_host, nms_host
from flypylib_tpu_torch.ops.packed_conv import packed_spec
from flypylib_tpu_torch.parallel import halo as thalo
from flypylib_tpu_torch.parallel import train as tptrain
from flypylib_tpu_torch.train import TrainConfig, TrainData
from flypylib_tpu_torch.train import trainer as ttr
from tests.test_torch_detect import assert_same_list

torch.set_num_threads(1)
SMALL = dict(features=(4, 6), dilations=(1, 2), head_features=8)
AX2 = ("spacez", "spacey")
AX3 = ("spacez", "spacey", "spacex")
LOGIT_TOL = 1e-4


def cpu_mesh(kind):
    """The port's mesh of CPU slots for ``kind``: 4 or 8 on a 1-D "space"
    axis, (4, 2) on ``AX2``, (2, 2, 2) on ``AX3``."""
    if kind in (4, 8):
        return tpar.make_mesh(kind, axis="space", devices=["cpu"] * kind)
    if kind == "2d":
        return tpar.make_mesh_2d((4, 2), axes=AX2, devices=["cpu"] * 8)
    return tpar.make_mesh_3d((2, 2, 2), devices=["cpu"] * 8)


def jax_mesh(kind):
    if kind in (4, 8):
        return jpar.make_mesh(kind, axis="space")
    if kind == "2d":
        return jpar.make_mesh_2d((4, 2), axes=AX2)
    return jpar.make_mesh_3d((2, 2, 2))


AXIS = {4: "space", 8: "space", "2d": AX2, "3d": AX3}


@pytest.fixture(scope="module")
def model():
    """The small conv stack in f32 with JAX's weights (scaled up so that
    the map is not flat): ``(port spec, JAX spec, JAX variables)``."""
    jspec = jzoo.baseline_model(dtype=jnp.float32, **SMALL)
    variables = jspec.init(jax.random.PRNGKey(0), 16)
    leaves, treedef = jax.tree.flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    variables = jax.tree.unflatten(
        treedef, [0.5 * jax.random.normal(k, l.shape, l.dtype)
                  for k, l in zip(keys, leaves)])
    tspec = tzoo.baseline_model(dtype=torch.float32, **SMALL)
    tspec.module.load_state_dict(tzoo.params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)))
    return tspec, jspec, variables


@torch.no_grad()
def monolithic(spec, vol):
    """The port's whole-volume map: one forward over the reflect-padded
    volume (uint8 fed as it is, as ``TiledInference``), every sigmoid on
    the CPU kernel's vector path (``halo.probabilities``)."""
    c = spec.context
    x = torch.from_numpy(np.pad(vol, c, mode="reflect"))
    return thalo.probabilities(spec.module(x[None, ..., None])[0, ..., 0]
                               ).numpy()


def logits(p):
    p = np.asarray(p, np.float64)
    return np.log(p) - np.log1p(-p)


# -- mesh helpers --------------------------------------------------------------
def test_mesh_helpers():
    mesh = tpar.make_mesh(4, axis="data", devices=["cpu"] * 4)
    assert mesh.shape["data"] == 4 and mesh.slots.size == 4
    assert [s.rank for s in mesh.slots] == [0] * 4
    assert {s.device for _, s in mesh.local()} == {torch.device("cpu")}
    assert len(mesh.local()) == 4
    mesh2 = tpar.make_mesh_2d((2, 4), axes=("data", "space"),
                              devices=["cpu"] * 8)
    assert mesh2.shape == {"data": 2, "space": 4}
    assert tpar.make_mesh(devices=["cpu"] * 3).shape == {"data": 3}
    r, b = tpar.replicated(mesh), tpar.batch_sharded(mesh)
    assert r.is_fully_replicated and not b.is_fully_replicated
    x = torch.arange(32.0).reshape(8, 4)
    parts = b.place(x)
    assert sorted(parts) == [(0,), (1,), (2,), (3,)]
    assert torch.equal(torch.cat([parts[(i,)] for i in range(4)]), x)
    reps = r.place(x)
    assert all(t is reps[(0,)] for t in reps.values())  # one copy per device
    with pytest.raises(ValueError, match="does not split"):
        b.place(torch.zeros(6, 2))
    with pytest.raises(ValueError, match="slots"):
        tpar.make_mesh(5, devices=["cpu"] * 4)
    module = torch.nn.Linear(2, 2)
    copies = tpar.mesh.per_device(module, ["cpu"] * 8)
    cpu = torch.device("cpu")
    assert list(copies) == [cpu] and copies[cpu] is module
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            tpar.make_mesh(2)
    assert tpar.local_batch_size(8) == 8 and not tpar.ensure_initialized()


# -- sharded_infer ---------------------------------------------------------------
INFER_CASES = [  # (mesh kind, volume shape, compare with JAX)
    (4, (32, 20, 20), True),
    (4, (30, 16, 16), False),
    (8, (8, 16, 16), False),  # thinner than 8 shards x context 3
    ("2d", (24, 20, 18), True),
    ("2d", (27, 15, 14), False),
    ("3d", (20, 18, 16), True),
    ("3d", (21, 15, 13), False),
]


@pytest.mark.parametrize("kind,shape,vs_jax", INFER_CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}"
                              for k, s, _ in INFER_CASES])
def test_sharded_infer_equals_monolithic_and_jax(model, rng, kind, shape,
                                                 vs_jax):
    tspec, jspec, variables = model
    vol = rng.random(shape).astype(np.float32)
    got = tpar.sharded_infer(tspec, None, vol, cpu_mesh(kind),
                             axis=AXIS[kind])
    assert isinstance(got, tpar.ShardedMap) and got.shape == shape
    np.testing.assert_array_equal(np.asarray(got), monolithic(tspec, vol))
    if vs_jax:
        want = np.asarray(jpar.sharded_infer(jspec, variables, vol,
                                             jax_mesh(kind), axis=AXIS[kind]))
        np.testing.assert_allclose(logits(np.asarray(got)), logits(want),
                                   rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("kind,tile_z", [(4, 2), (4, 4), (4, 8), ("2d", 3)])
def test_sharded_infer_tile_z(model, rng, kind, tile_z):
    tspec = model[0]
    shape = (32, 18, 18) if kind == 4 else (24, 20, 18)
    vol = rng.random(shape).astype(np.float32)
    got = tpar.sharded_infer(tspec, None, vol, cpu_mesh(kind),
                             axis=AXIS[kind], tile_z=tile_z)
    np.testing.assert_array_equal(np.asarray(got), monolithic(tspec, vol))


@pytest.mark.parametrize("kind,shape,tile,batch", [
    (4, (32, 20, 20), 8, 4), ("2d", (30, 22, 17), 12, 3),
    ("3d", (32, 32, 32), 8, 3)])
def test_sharded_infer_tile_out(model, rng, kind, shape, tile, batch):
    """The batched tile sweep: bitwise the monolithic map and
    ``TiledInference``'s at the same tile and batch (the tile starts of
    both grids coincide when the shard extents are multiples of the tile,
    as in the 3-D case)."""
    tspec = model[0]
    vol = rng.random(shape).astype(np.float32)
    got = np.asarray(tpar.sharded_infer(tspec, None, vol, cpu_mesh(kind),
                                        axis=AXIS[kind], tile_out=tile,
                                        tile_batch=batch))
    np.testing.assert_array_equal(got, monolithic(tspec, vol))
    np.testing.assert_array_equal(
        got, TiledInference(tspec, tile_out=tile, tile_batch=batch).infer(vol))


@pytest.mark.parametrize("kind,tile", [("2d", None), ("3d", None), ("2d", 8)])
def test_sharded_infer_packed_spec(model, rng, kind, tile):
    """The packed engine (size_multiple 2) keeps its phase in every shard:
    equal to the plain monolithic map to the reference's 2e-4 and to the
    packed ``TiledInference`` map bitwise at the same tile and batch."""
    tspec = model[0]
    pspec = packed_spec(tspec)
    vol = rng.random((20, 18, 16)).astype(np.float32)
    got = np.asarray(tpar.sharded_infer(pspec, None, vol, cpu_mesh(kind),
                                        axis=AXIS[kind], tile_out=tile,
                                        tile_batch=4))
    np.testing.assert_allclose(got, monolithic(tspec, vol), rtol=2e-4,
                               atol=2e-4)
    if tile is not None:
        # shard extents (10, 10) are not tile multiples: compare with the
        # packed monolithic forward instead
        np.testing.assert_array_equal(got, monolithic(pspec, vol))


def test_sharded_infer_uint8_wire(model, rng):
    """uint8 stays uint8 from the host through the exchange into the
    module (which casts it), bitwise the monolithic uint8 map."""
    tspec = model[0]
    vol8 = (rng.random((32, 20, 20)) * 255).astype(np.uint8)
    seen = []
    hook = tspec.module.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].dtype))
    try:
        got = tpar.sharded_infer(tspec, None, vol8, cpu_mesh(4))
    finally:
        hook.remove()
    assert seen == [torch.uint8] * 4
    np.testing.assert_array_equal(np.asarray(got), monolithic(tspec, vol8))


def test_sharded_infer_validation(model):
    tspec = model[0]
    mesh = cpu_mesh(4)
    vol = np.zeros((32, 16, 16), np.float32)
    with pytest.raises(ValueError, match="divide"):
        tpar.sharded_infer(tspec, None, vol, mesh, tile_z=3)
    with pytest.raises(ValueError, match="not both"):
        tpar.sharded_infer(tspec, None, vol, mesh, tile_z=8, tile_out=8)
    with pytest.raises(ValueError, match="multiple"):
        tpar.sharded_infer(packed_spec(tspec), None, vol, mesh, tile_out=7)
    with pytest.raises(ValueError, match="1-3 mesh axes"):
        tpar.sharded_infer(tspec, None, vol, mesh, axis=())
    with pytest.raises(ValueError, match="variables must be None"):
        tpar.sharded_infer(tspec, {"params": {}}, vol, mesh)


# -- sharded_nms / sharded_components -----------------------------------------
def _peaks(shape, peaks):
    vol = np.zeros(shape, np.float32)
    for z, y, x, v in peaks:
        vol[z, y, x] = v
    return vol


def _nms_volume(case, rng):
    """``(mesh kind, volume, window, threshold)`` of the reference's NMS
    cases."""
    if case == "seams":
        return 4, _peaks((32, 16, 16), [
            (7, 4, 4, 0.9), (8, 8, 8, 0.8), (15, 12, 12, 0.95),
            (16, 4, 12, 0.7), (24, 12, 4, 0.85), (23, 12, 4, 0.84)]), 3, 0.5
    if case == "plateau":
        vol = np.zeros((32, 16, 16), np.float32)
        vol[7:10, 8, 8] = 0.9  # a plateau across the z = 8 seam
        return 4, vol, 3, 0.5
    if case == "random":
        return 8, rng.random((40, 24, 24)).astype(np.float32), 3, 0.85
    if case == "2d-seams":
        return "2d", _peaks((24, 20, 16), [
            (5, 4, 4, 0.9), (6, 14, 8, 0.8), (12, 9, 4, 0.95),
            (12, 10, 12, 0.7), (17, 9, 8, 0.85), (18, 10, 8, 0.84)]), 3, 0.5
    if case == "2d-random":
        return "2d", rng.random((25, 21, 17)).astype(np.float32), 5, 0.85
    if case == "3d-seams":
        return "3d", _peaks((16, 16, 16), [
            (7, 4, 4, 0.9), (8, 12, 4, 0.8), (4, 7, 4, 0.95),
            (4, 8, 12, 0.7), (4, 12, 7, 0.85), (12, 4, 8, 0.84),
            (7, 8, 7, 0.99), (8, 7, 8, 0.98)]), 3, 0.5
    return "3d", rng.random((19, 17, 15)).astype(np.float32), 5, 0.85


NMS_CASES = ["seams", "plateau", "random", "2d-seams", "2d-random",
             "3d-seams", "3d-random"]


@pytest.mark.parametrize("case", NMS_CASES)
def test_sharded_nms_equals_host_and_jax(rng, case):
    kind, vol, window, thr = _nms_volume(case, rng)
    host = nms_host(vol, window=window, threshold=thr)
    got = tpar.sharded_nms(vol, cpu_mesh(kind), axis=AXIS[kind],
                           window=window, threshold=thr, max_per_shard=16)
    want = jpar.sharded_nms(vol, jax_mesh(kind), axis=AXIS[kind],
                            window=window, threshold=thr, max_per_shard=256)
    assert len(host) > 0
    assert_same_list(got, host)
    assert_same_list(got, want)
    # a torch tensor is sharded the same way
    assert_same_list(tpar.sharded_nms(torch.from_numpy(vol), cpu_mesh(kind),
                                      axis=AXIS[kind], window=window,
                                      threshold=thr), host)


def _cc_volume(case, rng):
    if case == "seams":
        vol = np.zeros((32, 16, 16), np.float32)
        vol[6:11, 8, 8] = [0.6, 0.7, 0.9, 0.7, 0.6]
        vol[14:18, 4, 4] = 0.8
        vol[20, 12, 12] = 0.75
        vol[7, 3, 3] = 0.65
        return 4, vol, 0.5
    if case == "column":  # one component through every shard
        vol = np.zeros((32, 8, 8), np.float32)
        vol[:, 4, 4] = 0.9
        return 4, vol, 0.5
    if case == "random":
        return 8, (rng.random((40, 12, 12)) > 0.8).astype(np.float32), 0.5
    if case == "2d":
        vol = np.zeros((24, 20, 16), np.float32)
        vol[4:8, 8:12, 8] = 0.8
        vol[11:14, 5, 5] = 0.9
        vol[12, 9, 3] = 0.6
        vol[13, 10, 4] = 0.7  # diagonal across the seam: two components
        return "2d", vol, 0.5
    if case == "2d-random":
        return "2d", (rng.random((25, 19, 14)) > 0.75).astype(np.float32), 0.5
    if case == "3d":
        vol = np.zeros((16, 16, 16), np.float32)
        vol[6:10, 8, 8] = 0.8
        vol[8, 6:10, 3] = 0.9
        vol[3, 8, 6:10] = 0.7
        vol[6:10, 6:10, 6:10] = 0.6
        vol[7, 7, 3] = 0.5
        vol[8, 8, 4] = 0.55
        return "3d", vol, 0.45
    return "3d", (rng.random((19, 17, 14)) > 0.75).astype(np.float32), 0.5


CC_CASES = ["seams", "column", "random", "2d", "2d-random", "3d",
            "3d-random"]


@pytest.mark.parametrize("case", CC_CASES)
def test_sharded_components_equal_host_and_jax(rng, case):
    kind, vol, thr = _cc_volume(case, rng)
    host = components_host(vol, threshold=thr)
    got = tpar.sharded_components(vol, cpu_mesh(kind), axis=AXIS[kind],
                                  threshold=thr, max_components=8)
    want = jpar.sharded_components(vol, jax_mesh(kind), axis=AXIS[kind],
                                   threshold=thr, max_components=1024)
    assert len(host) > 0
    assert_same_list(got, host, loc_tol=1e-12)
    assert_same_list(got, want, loc_tol=1e-12)


@pytest.mark.parametrize("kind", [4, "2d", "3d"])
def test_lists_from_a_sharded_map_where_it_lies(model, rng, kind,
                                                monkeypatch):
    """NMS and CC take ``sharded_infer``'s blocks in place (no gather, the
    grid beyond the volume masked), or gather a map of another layout; the
    lists equal the host reference's on the monolithic map."""
    tspec = model[0]
    vol = rng.random((21, 19, 17)).astype(np.float32)
    mesh = cpu_mesh(kind)
    prob = tpar.sharded_infer(tspec, None, vol, mesh, axis=AXIS[kind])
    mono = monolithic(tspec, vol)
    thr = float(np.quantile(mono, 0.97))
    gathered = []
    real = thalo.ShardedMap.gather
    monkeypatch.setattr(thalo.ShardedMap, "gather",
                        lambda self: gathered.append(1) or real(self))
    for window in (3, 5):
        assert_same_list(tpar.sharded_nms(prob, mesh, AXIS[kind], window,
                                          thr),
                         nms_host(mono, window=window, threshold=thr))
    assert_same_list(tpar.sharded_components(prob, mesh, AXIS[kind], thr),
                     components_host(mono, threshold=thr), loc_tol=1e-12)
    assert gathered == []
    other = cpu_mesh(8)
    assert_same_list(tpar.sharded_nms(prob, other, "space", 3, thr),
                     nms_host(mono, window=3, threshold=thr))
    assert gathered == [1]


# -- the data-parallel step ---------------------------------------------------
def _task(seed=0, size=24):
    rng = np.random.default_rng(seed)
    image = rng.random((size,) * 3).astype(np.float32)
    labels = (rng.random((size,) * 3) > 0.9).astype(np.float32)
    return image, labels, np.ones((size,) * 3, np.float32)


def _dp_spec(bn=False, seed=0):
    """The reference DP tests' one-layer stack in f32, with BatchNorm or
    without."""
    if not bn:
        return tzoo.baseline_model(features=(4,), dilations=(1,),
                                   head_features=8, dtype=torch.float32,
                                   seed=seed)
    module = tzoo.ConvStack(features=(4,), dilations=(1,), head_features=8,
                            dtype=torch.float32, use_batchnorm=True,
                            generator=torch.Generator().manual_seed(seed))
    return tzoo.ModelSpec(name="baseline_bn", module=module, context=1,
                          min_size=3)


def _params(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("bn", [False, True], ids=["baseline", "batchnorm"])
def test_dp_step_equals_the_single_step(bn):
    """Same seed, same start: ``make_dp_train_step`` over a one-process
    mesh of 4 CPU slots gives the single step's loss and parameters
    (BatchNorm's running statistics included).  One process holds every
    row of the data axis and no world, so this runs the step's world-less
    path, the single step on the mesh's rows; the split batch, the global
    mask count, the summed BatchNorm moments and the gradient bucket run in
    ``tests/test_torch_distributed.py``'s two gloo ranks, held there
    against this single step and against the reference's DP step."""
    cfg = TrainConfig(patch_size=9, batch_size=8, augment=True)
    image, labels, mask = _task()
    out = []
    for dp in (False, True):
        spec = _dp_spec(bn)
        if dp:
            step, _, patch = tpar.make_dp_train_step(
                spec, cfg, tpar.make_mesh(4, devices=["cpu"] * 4))
        else:
            step, _, patch = ttr.make_train_step(spec, cfg)
        data = TrainData.build(image, labels, mask, patch, device="cpu")
        state = ttr.TrainState.create(spec.module, cfg.learning_rate)
        gen = torch.Generator().manual_seed(3)
        m = [step(state, gen, data) for _ in range(2)]
        out.append((float(m[-1]["loss"]), _params(spec.module)))
    (l1, p1), (l2, p2) = out
    assert abs(l1 - l2) <= 1e-5 * abs(l1)
    for k in p1:
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_dp_step_equals_jax_on_one_batch(monkeypatch):
    """On a fixed batch and the same f32 weights, ``make_dp_train_step``
    over a one-process mesh of 4 CPU slots (the world-less path: the
    single step on all rows) equals JAX's loss, gradients and optax Adam
    update.  The two-rank DP step is held against the reference's
    ``make_dp_train_step`` in ``tests/test_torch_distributed.py``."""
    cfg = TrainConfig(patch_size=12, batch_size=8, augment=True,
                      engine="plain")
    jm = jzoo.ConvStack(features=(4, 6), dilations=(1, 2), head_features=8,
                        dtype=jnp.float32)
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 12, 12, 12, 1)))["params"]
    params = {n: {"kernel": rng.normal(0, np.prod(l["kernel"].shape[:-1])
                                       ** -0.5, l["kernel"].shape
                                       ).astype(np.float32),
                  "bias": rng.normal(0, 0.1, l["bias"].shape
                                     ).astype(np.float32)}
              for n, l in shapes.items()}
    spec = tzoo.baseline_model(dtype=torch.float32, **SMALL)
    spec.module.load_state_dict(tzoo.params_from_flax({"params": params}))
    out = 12 - 2 * spec.context
    x = rng.random((8, 12, 12, 12)).astype(np.float32)
    y = (rng.random((8, out, out, out)) > 0.7).astype(np.float32)
    m = (rng.random((8, out, out, out)) > 0.1).astype(np.float32)
    codes = rng.integers(0, 16, 8)
    batch = tuple(torch.from_numpy(a) for a in (x, y, m, codes))
    real = tptrain.make_loss_fn

    def fixed_batch(*a):
        loss_fn, _, patch = real(*a)
        return loss_fn, lambda gen, data: batch, patch

    monkeypatch.setattr(tptrain, "make_loss_fn", fixed_batch)
    step, _, _ = tpar.make_dp_train_step(
        spec, cfg, tpar.make_mesh(4, devices=["cpu"] * 4))
    state = ttr.TrainState.create(spec.module, cfg.learning_rate)
    data = TrainData.build(*_task(size=16), 12, device="cpu")
    got_loss = float(step(state, torch.Generator(), data)["loss"])

    def loss(p):
        aug = jax.vmap(j_augment_patch)
        xa, ya, ma = (aug(jnp.asarray(a), jnp.asarray(codes))
                      for a in (x, y, m))
        logit = jm.apply({"params": p}, xa[..., None], train=True)[..., 0]
        return jtr.masked_bce_loss(logit, ya, ma)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want_loss, grads = jax.value_and_grad(loss)(jp)
    tx = optax.adam(cfg.learning_rate)
    upd, _ = tx.update(grads, tx.init(jp), jp)
    want = tzoo.params_from_flax({"params": optax.apply_updates(jp, upd)})
    assert abs(got_loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for k, v in spec.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_dp_step_rejections():
    spec = _dp_spec()
    with pytest.raises(ValueError, match="not divisible"):
        tpar.make_dp_train_step(spec, TrainConfig(batch_size=6),
                                tpar.make_mesh(4, devices=["cpu"] * 4))
    mesh = tpar.make_mesh_2d((2, 2), axes=("data", "space"),
                             devices=["cpu"] * 4)
    assert tptrain.rank_rows(mesh, "data", 8) == (slice(0, 8),
                                                  torch.device("cpu"))


def test_fit_with_a_mesh_equals_fit_without(rng):
    """``Trainer.fit(mesh=)`` runs the DP steps: same seed, same history and
    parameters as the single-device fit."""
    image, labels, mask = _task(seed=2, size=20)
    cfg = TrainConfig(patch_size=9, batch_size=4, steps_per_epoch=3)
    out = []
    for mesh in (None, tpar.make_mesh(2, devices=["cpu"] * 2)):
        spec = _dp_spec(seed=1)
        tr = ttr.Trainer(spec, cfg, seed=5, device="cpu")
        hist = tr.fit(image, labels, mask, epochs=2, mesh=mesh)
        out.append(([h["loss"] for h in hist], _params(spec.module)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    for k in out[0][1]:
        np.testing.assert_allclose(out[1][1][k].numpy(),
                                   out[0][1][k].numpy(), rtol=0, atol=1e-5)
