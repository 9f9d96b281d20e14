"""The port's ``DetectPipeline`` (``flypylib_tpu_torch/infer/pipeline.py``)
and its helpers against the JAX package's, on the same inputs and weights.

The model is the JAX tests' small baseline (features (4, 6), dilations
(1, 2), head 8, f32) with every parameter redrawn from a normal (so the
untrained map varies in space), carried across with ``params_from_flax``.
Tolerances: the forward map f32 1e-5 (summation order); on one map the
lists, the quantile threshold and the CC of a candidate set exactly;
the port's own forms (staged, full, tiled, uint8 against the scaled f32
volume) bit for bit.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flypylib_tpu_torch as tpt
from flypylib_tpu.infer import pipeline as jpipe
from flypylib_tpu.infer import tiled as jtiled
from flypylib_tpu.models import zoo as jzoo
from flypylib_tpu.ops import components as jcomp
from flypylib_tpu_torch.infer.pipeline import (DetectPipeline, U8_SCALE,
                                               reflect_pad, to_host,
                                               zero_extend)
from flypylib_tpu_torch.infer.tiled import grid_tiling_min_cost
from flypylib_tpu_torch.models import zoo as tzoo
from flypylib_tpu_torch.ops import components as tcomp
from flypylib_tpu_torch.ops.host_reference import components_host, nms_host
from tests.conftest import make_blob_volume
from tests.test_torch_detect import assert_same_list

torch.set_num_threads(1)
SMALL = dict(features=(4, 6), dilations=(1, 2), head_features=8)


@pytest.fixture(scope="module")
def model():
    """(JAX spec, JAX variables, port spec) with the same weights."""
    spec = jzoo.baseline_model(dtype=jnp.float32, **SMALL)
    variables = spec.init(jax.random.PRNGKey(0), 16)
    leaves, treedef = jax.tree.flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    variables = jax.tree.unflatten(
        treedef, [0.5 * jax.random.normal(k, l.shape, l.dtype)
                  for k, l in zip(keys, leaves)])
    tspec = tzoo.baseline_model(dtype=torch.float32, **SMALL)
    tspec.module.load_state_dict(tzoo.params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)))
    return spec, variables, tspec


def _volume(rng, shape, dtype):
    vol = rng.random(shape).astype(np.float32)
    return (vol * 255).astype(np.uint8) if dtype == "uint8" else vol


@pytest.mark.parametrize("dtype", ["f32", "uint8"])
@pytest.mark.parametrize("shape,tile_out,tile_batch", [
    ((24, 20, 18), 12, 2),   # grid extension on y and x
    ((30, 14, 21), 8, 4),    # several slabs, a padded last batch
])
def test_forward_map_matches_jax(model, rng, shape, tile_out, tile_batch,
                                 dtype):
    """The forward map against JAX's, f32 to 1e-5, for f32 and uint8
    volumes (uint8 enters both models as x * f32(1/255)); and the port's
    map of the uint8 volume is, bit for bit, its tiled map of the scaled
    f32 volume."""
    spec, variables, tspec = model
    vol = _volume(rng, shape, dtype)
    jp = jpipe.DetectPipeline(spec, variables, shape, tile_out=tile_out,
                              tile_batch=tile_batch, window=3)
    tp = DetectPipeline(tspec, None, shape, tile_out=tile_out,
                        tile_batch=tile_batch, window=3)
    assert tp.padded_shape == jp.padded_shape
    assert tp._out_shape == jp._out_shape
    want = np.asarray(jp.forward(vol))[:shape[0], :shape[1], :shape[2]]
    got = tp.forward(vol)
    assert got.dtype == torch.float32 and tuple(got.shape) == tp._out_shape
    got = got[:shape[0], :shape[1], :shape[2]].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if dtype == "uint8":
        scaled = vol.astype(np.float32) * np.float32(1.0 / 255.0)
        assert float(np.float32(1.0 / 255.0)) == U8_SCALE
        tiled = tpt.FplNetwork(tspec, device="cpu", packed=False).infer(
            scaled, tile_out=tile_out, tile_batch=tile_batch)
        np.testing.assert_array_equal(got, tiled)


@pytest.mark.parametrize("region", ["whole", "inner"])
@pytest.mark.parametrize("run_cc", [True, False])
def test_postprocess_lists_match_jax(model, region, run_cc):
    """On one map (with planted plateaus and an edge maximum), the NMS and
    CC lists of the port's postprocess equal JAX's exactly, over the whole
    map and over an in-bounds region (-inf outside)."""
    spec, variables, tspec = model
    shape = (26, 22, 20)
    prob, _ = make_blob_volume(shape, centers=[(6, 6, 6), (18, 15, 12)],
                               sigma=2.0)
    prob[3, 15, 4:7] = 0.9       # a plateau
    prob[20, 3:5, 14:16] = 0.9   # another, the same value
    prob[0, 0, 0] = 0.7          # a corner maximum
    lo, hi = ((None, None) if region == "whole"
              else ((2, 1, 3), (24, 20, 17)))
    kw = dict(tile_out=16, tile_batch=1, window=5, threshold=0.3,
              run_cc=run_cc)
    jp = jpipe.DetectPipeline(spec, variables, shape, **kw)
    tp = DetectPipeline(tspec, None, shape, **kw)
    out = np.zeros(jp._out_shape, np.float32)
    out[:shape[0], :shape[1], :shape[2]] = prob
    jn, jc = jp.postprocess(jnp.asarray(out), lo, hi)
    tn, tc = tp.postprocess(torch.from_numpy(out), lo, hi)
    assert len(tn) > 3
    assert_same_list(tn, jn)
    if run_cc:
        assert len(tc) > 1
        assert_same_list(tc, jc, loc_tol=1e-5)
        inb = np.full(shape, -np.inf, np.float32)
        sl = tuple(slice(a, b) for a, b in zip(lo or (0, 0, 0), hi or shape))
        inb[sl] = prob[sl]
        assert_same_list(tc, components_host(inb, threshold=0.3))
    else:
        assert tc is None


def _jax_quantile(prob, inb, q):
    """The reference's in-graph quantile (``pipeline.py:239-251``), jitted
    as there."""
    @jax.jit
    def f(prob, inb):
        stride = max(1, prob.size // (1 << 20))
        sub = jnp.sort(prob[::stride].reshape(-1))
        n_sub = sub.shape[0]
        n_in = jnp.maximum(jnp.sum(inb[::stride], dtype=jnp.int32), 1)
        pos = q * (n_in - 1).astype(jnp.float32)
        lo = jnp.floor(pos).astype(jnp.int32)
        frac = pos - lo.astype(jnp.float32)
        base = n_sub - n_in
        v0 = sub[jnp.minimum(base + lo, n_sub - 1)]
        v1 = sub[jnp.minimum(base + lo + 1, n_sub - 1)]
        return v0 * (1.0 - frac) + v1 * frac

    return float(f(jnp.asarray(prob), jnp.asarray(inb)))


@pytest.mark.parametrize("q", [0.97, 0.9993])
@pytest.mark.parametrize("shape", [(30, 24, 22), (160, 96, 80)])
def test_threshold_quantile_matches_jax(model, rng, shape, q):
    """The plane-subsampled in-bounds quantile equals the reference's
    exactly on one map (the larger shape subsamples planes), and the
    lists at that threshold equal JAX's."""
    spec, variables, tspec = model
    prob = rng.random(shape).astype(np.float32)
    lo, hi = (1, 2, 0), (shape[0] - 1, shape[1], shape[2] - 3)
    kw = dict(tile_out=max(shape), window=3, threshold_quantile=q)
    tp = DetectPipeline(tspec, None, shape, **kw)
    from flypylib_tpu_torch.ops.nms import mask_valid_region

    masked, inb = mask_valid_region(torch.from_numpy(prob), lo, hi)
    got = float(tp.quantile_threshold(masked, inb))
    assert got == _jax_quantile(masked.numpy(), inb.numpy(), q)
    if shape[0] < 100:
        jp = jpipe.DetectPipeline(spec, variables, shape, **kw)
        jn, jc = jp.postprocess(jnp.asarray(prob), lo, hi)
        tn, tc = tp.postprocess(torch.from_numpy(prob), lo, hi)
        assert len(tn) > 0
        assert_same_list(tn, jn)
        assert_same_list(tc, jc, loc_tol=1e-5)


@pytest.mark.parametrize("packed", [False, "auto"], ids=["plain", "packed"])
@pytest.mark.parametrize("dtype", ["f32", "uint8"])
def test_stage_and_forward_forms_are_bitwise(model, rng, packed, dtype):
    """stage / forward_staged, stage_full / forward_full, forward and
    forward_from at an origin inside a larger staged volume give one map,
    bit for bit; the staged volume is np.pad's; and the whole pipeline's
    lists are the host reference's on that map."""
    _, _, tspec = model
    net = tpt.FplNetwork(tspec, device="cpu", packed=packed)
    shape = (21, 17, 19)
    vol = _volume(rng, shape, dtype)
    pipe = DetectPipeline(net.infer_spec, None, shape, tile_out=8,
                          tile_batch=3, window=5, threshold=0.5)
    staged = pipe.stage(vol)
    assert staged.dtype == torch.from_numpy(vol).dtype
    c = net.infer_spec.context
    host = np.pad(np.pad(vol, c, mode="reflect"),
                  [(0, p - s - 2 * c) for p, s in zip(pipe.padded_shape,
                                                      shape)])
    np.testing.assert_array_equal(staged.numpy(), host)
    a = pipe.forward_staged(staged)
    b = pipe.forward_full(pipe.stage_full(vol))
    d = pipe.forward(vol)
    big = zero_extend(torch.from_numpy(np.pad(host, [(3, 0), (1, 0), (2, 0)])),
                      [p + 3 for p in pipe.padded_shape])
    e = pipe.forward_from(big, (3, 1, 2))
    for m in (b, d, e):
        assert torch.equal(a, m)
    prob = a[:shape[0], :shape[1], :shape[2]].numpy()
    thr = float(np.quantile(prob, 0.9))
    pipe.threshold = thr
    nms_det, cc_det = pipe(vol)
    assert len(nms_det) > 0
    assert_same_list(nms_det, nms_host(prob, window=5, threshold=thr))
    assert_same_list(cc_det, components_host(prob, threshold=thr))


def test_stage_rejections_and_host_pad_fallback(model, rng):
    _, _, tspec = model
    c = tspec.context
    pipe = DetectPipeline(tspec, None, (12, 12, 12), tile_out=8)
    with pytest.raises(ValueError, match="must have shape"):
        pipe.stage(np.zeros((12, 12, 11), np.float32))
    pre = DetectPipeline(tspec, None, (12, 12, 12), tile_out=8,
                         pre_padded=True)
    with pytest.raises(ValueError, match="pre_padded"):
        pre.stage(np.zeros((12, 12, 12), np.float32))
    padded = rng.random((12 + 2 * c,) * 3).astype(np.float32)
    np.testing.assert_array_equal(
        pre.stage(padded)[:12 + 2 * c, :12 + 2 * c, :12 + 2 * c].numpy(),
        padded)
    # an extent <= context reflects more than once: padded on the host
    tiny = rng.random((c, 9, 10)).astype(np.float32)
    tp = DetectPipeline(tspec, None, tiny.shape, tile_out=8)
    got = tp.stage(tiny).numpy()
    want = np.pad(tiny, c, mode="reflect")
    np.testing.assert_array_equal(got[:want.shape[0], :want.shape[1],
                                      :want.shape[2]], want)
    with pytest.raises(ValueError, match="reflect pad"):
        reflect_pad(torch.zeros(3, 8, 8), 3)
    # other dtypes are cast to f32 before the upload, as the reference
    vol16 = (rng.random((12, 12, 12)) * 1000).astype(np.int16)
    assert pipe.stage(vol16).dtype == torch.float32


def test_to_host_is_one_exact_copy():
    idx = torch.tensor([0, 2**40 + 3, 5], dtype=torch.int64)
    conf = torch.tensor([0.1, 0.7, 1e-30], dtype=torch.float32)
    mask = torch.tensor([[True, False], [False, True]])
    a, b, m = to_host(idx, conf, mask)
    assert a.astype(np.int64).tolist() == idx.tolist()
    assert np.array_equal(b.astype(np.float32), conf.numpy())
    assert m.shape == (2, 2) and m.astype(bool).tolist() == mask.tolist()
    assert to_host() == []


@pytest.mark.parametrize("shape,density", [
    ((13, 11, 9), 0.02), ((13, 11, 9), 0.3), ((40, 7, 33), 0.08),
    ((5, 64, 3), 0.5), ((1, 1, 50), 0.4)])
def test_components_from_candidates_matches_the_original(rng, shape,
                                                         density):
    """The copied sparse CC against the JAX package's original (and the
    host reference) on random sparse candidate sets, seams of every axis
    included; the copy's source is the original's."""
    assert (inspect.getsource(tcomp.components_from_candidates)
            == inspect.getsource(jcomp.components_from_candidates))
    mask = rng.random(shape) < density
    prob = np.where(mask, rng.random(shape), 0).astype(np.float32)
    flat = np.flatnonzero(mask)
    vals = prob.reshape(-1)[flat]
    got = tcomp.components_from_candidates(flat, vals, shape)
    want = jcomp.components_from_candidates(flat, vals, shape)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.locs, want.locs)
    np.testing.assert_array_equal(got.conf, want.conf)
    host = components_host(np.where(mask, prob, -1.0), threshold=0.0)
    np.testing.assert_array_equal(got.locs, host.locs)
    assert len(tcomp.components_from_candidates(flat[:0], vals[:0],
                                                shape)) == 0


def test_compact_true_indices_is_ascending_int64(rng):
    mask = rng.random((9, 13, 7)) < 0.2
    got = tcomp.compact_true_indices(torch.from_numpy(mask))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.flatnonzero(mask))


def _jax_spec_like(tspec, module):
    """A JAX ``ModelSpec`` around ``module`` with the port spec's geometry
    (``tests/test_torch_models.py`` holds the two geometries equal; JAX's
    probe costs ~15 s a U-Net spec)."""
    return jzoo.ModelSpec(name=tspec.name, module=module,
                          context=tspec.context,
                          size_multiple=tspec.size_multiple,
                          size_offset=tspec.size_offset,
                          min_size=tspec.min_size, metadata=tspec.metadata)


@pytest.mark.parametrize("shape", [(1024,) * 3, (256,) * 3, (300, 200, 96),
                                   (64, 64, 64), (30, 40, 50)])
def test_grid_tiling_min_cost_is_the_reference_choice(shape):
    pairs = [(tzoo.baseline_model(), jzoo.baseline_model())]
    t = tzoo.unet()
    pairs.append((t, _jax_spec_like(t, jzoo.UNetValid())))
    from flypylib_tpu_torch.ops.packed_unet import packed_unet_spec

    tp = packed_unet_spec(t)
    pairs.append((tp, _jax_spec_like(tp, jzoo.UNetValid())))
    for ts, js in pairs:
        assert grid_tiling_min_cost(ts, shape) == \
            jtiled.grid_tiling_min_cost(js, shape)
    assert grid_tiling_min_cost(tp, (1024,) * 3) == (388 - 40, 1)
