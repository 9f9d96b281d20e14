"""The port's evaluation (``flypylib_tpu_torch.ops.matching``,
``utils/metrics.py`` and the tiling engine's ``pad_mode``) against the JAX
package's on the same numpy inputs.

Every comparison here is exact: the host functions are copies, the device
counts are integers, and the streaming path re-slices the same
probability map, so its counts equal the monolithic map's.
"""

import json

import numpy as np
import pytest
import torch

from flypylib_tpu.io.synapses import Tbars as JTbars
from flypylib_tpu.ops import matching as jm
from flypylib_tpu.utils import metrics as jmetrics
from flypylib_tpu_torch.infer.large import array_reader
from flypylib_tpu_torch.infer.tiled import TiledInference
from flypylib_tpu_torch.io.synapses import Tbars
from flypylib_tpu_torch.models import zoo as tzoo
from flypylib_tpu_torch.ops import matching as tm
from flypylib_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)


def _points(rng, n, size=40.0, quant=None):
    locs = rng.random((n, 3)) * size
    if quant:  # integer grid: exact distance ties
        locs = np.floor(locs / quant) * quant
    return locs


def _pair(rng, n_pred, n_gt, quant=None):
    """(port pred, port gt, JAX pred, JAX gt) on the same points, with
    confidence ties."""
    p = _points(rng, n_pred, quant=quant)
    g = _points(rng, n_gt, quant=quant)
    conf = np.round(rng.random(n_pred), 1)  # ties in confidence
    return (Tbars(locs=p, conf=conf), Tbars(locs=g),
            JTbars(locs=p, conf=conf), JTbars(locs=g))


@pytest.mark.parametrize("n_pred,n_gt,quant", [
    (0, 5, None), (7, 0, None), (60, 50, None), (60, 50, 4.0),
    (2100, 2000, 2.0),  # n_pred * n_gt > 4e6: the cKDTree matcher
])
def test_match_detections_equals_jax(n_pred, n_gt, quant):
    rng = np.random.default_rng(n_pred + n_gt)
    tp_, tg, jp, jg = _pair(rng, n_pred, n_gt, quant)
    for d in (3.0, 10.0):
        t_tp, t_idx, t_sorted = tm.match_detections(tp_, tg, d)
        j_tp, j_idx, j_sorted = jm.match_detections(jp, jg, d)
        np.testing.assert_array_equal(t_tp, j_tp)
        np.testing.assert_array_equal(t_idx, j_idx)
        np.testing.assert_array_equal(t_sorted.locs, j_sorted.locs)
        np.testing.assert_array_equal(t_sorted.conf, j_sorted.conf)


def test_obj_pr_and_curve_equal_jax():
    rng = np.random.default_rng(3)
    tp_, tg, jp, jg = _pair(rng, 80, 60, quant=3.0)
    t_curve = tm.obj_pr_curve(tp_, tg, 6.0)
    j_curve = jm.obj_pr_curve(jp, jg, 6.0)
    assert t_curve.keys() == j_curve.keys()
    for k in t_curve:
        np.testing.assert_array_equal(t_curve[k], j_curve[k])
    for conf in (None, 0.5):
        assert tm.obj_pr(tp_, tg, 6.0, conf) == jm.obj_pr(jp, jg, 6.0, conf)


def _vpr_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


def _vpr_inputs(seed=7, shape=(20, 18, 17)):
    rng = np.random.default_rng(seed)
    prob = rng.random(shape).astype(np.float32)
    labels = (rng.random(shape) > 0.9).astype(np.float32)
    mask = (rng.random(shape) > 0.2).astype(np.float32)
    prob.flat[::97] = np.float32(0.5)  # exact-threshold ties: >= semantics
    return prob, labels, mask


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("thresholds", [None, [0.25, 0.5, 0.75]],
                         ids=["default", "custom"])
def test_voxel_pr_equals_jax(masked, thresholds):
    prob, labels, mask = _vpr_inputs()
    m = mask if masked else None
    thr = None if thresholds is None else np.asarray(thresholds, np.float32)
    ref = jm.voxel_pr(prob, labels, m, thresholds=thr)
    _vpr_equal(tm.voxel_pr(prob, labels, m, thresholds=thr), ref)
    # the device counter on a CPU tensor, bitwise the host's and JAX's
    got = tm.voxel_pr_device(torch.from_numpy(prob), torch.from_numpy(labels),
                             None if m is None else torch.from_numpy(m),
                             thresholds=thr)
    _vpr_equal(got, ref)
    _vpr_equal(got, jm.voxel_pr_device(prob, labels, m, thresholds=thr))
    # numpy and uint8 inputs count the same
    _vpr_equal(tm.voxel_pr_device(prob, labels.astype(np.uint8), m,
                                  thresholds=thr), ref)


def _small_spec(kind):
    if kind == "conv":
        # the packed engine: size_multiple 2, so slabs carry a phase
        from flypylib_tpu_torch.ops.packed_conv import packed_spec

        return packed_spec(tzoo.baseline_model(
            features=(3, 4), dilations=(1, 2), head_features=4,
            dtype=torch.float32, seed=1))
    # size_multiple 4, context 10
    return tzoo.unet(base_features=2, levels=2, convs_per_stage=1,
                     dtype=torch.float32, seed=2)


@pytest.mark.parametrize("kind,shape,slab", [
    ("conv", (29, 22, 20), 8),    # Z not a multiple of the slab
    ("conv", (29, 22, 20), 7),    # 7 -> 6, a multiple of size_multiple
    ("unet", (37, 30, 26), 16),   # odd Z: the tail slab overshoots
    ("unet", (37, 30, 26), 10),   # 10 -> 8, a multiple of size_multiple
])
def test_voxel_pr_streaming_equals_monolithic(kind, shape, slab):
    spec = _small_spec(kind)
    assert spec.size_multiple > 1
    rng = np.random.default_rng(11)
    vol = rng.random(shape).astype(np.float32)
    labels = (rng.random(shape) > 0.9).astype(np.float32)
    mask = (rng.random(shape) > 0.1).astype(np.float32)
    prob = TiledInference(spec, tile_out=12, tile_batch=2).infer(vol)
    # thresholds at map values: each count is exact or this fails
    thr = np.sort(prob.ravel()[rng.integers(0, prob.size, 9)])
    ref = tm.voxel_pr(prob, labels, mask, thresholds=thr)
    got = tm.voxel_pr_streaming(spec, None, vol, labels, mask, thresholds=thr,
                                slab=slab, tile_out=12, tile_batch=2)
    _vpr_equal(got, ref)
    # unmasked, every input a (shape, read_fn) reader
    got2 = tm.voxel_pr_streaming(spec, None, array_reader(vol),
                                 array_reader(labels), thresholds=thr,
                                 slab=slab, tile_out=12, tile_batch=2)
    _vpr_equal(got2, tm.voxel_pr(prob, labels, thresholds=thr))


def test_voxel_pr_streaming_rejects_variables_and_mismatch():
    spec = _small_spec("conv")
    vol = np.zeros((20, 20, 20), np.float32)
    with pytest.raises(ValueError, match="variables"):
        tm.voxel_pr_streaming(spec, {"params": {}}, vol, vol)
    with pytest.raises(ValueError, match="shape mismatch"):
        tm.voxel_pr_streaming(spec, None, vol, vol[:-1])


@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["f32", "u8"])
def test_pad_mode_none_takes_a_prepadded_window(dtype):
    spec = _small_spec("unet")
    rng = np.random.default_rng(5)
    vol = (rng.random((30, 26, 28)) * 255).astype(dtype)
    c = spec.context
    want = TiledInference(spec, tile_out=12, tile_batch=2).infer(vol)
    eng = TiledInference(spec, tile_out=12, tile_batch=2, pad_mode="none")
    got = eng.infer(np.pad(vol, c, mode="reflect"))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="smaller than 2"):
        eng.infer(np.zeros((2 * c, 40, 40), np.float32))


@pytest.mark.parametrize("as_list", [False, True], ids=["map", "tbars"])
def test_evaluate_equals_jax(blob_volume, as_list):
    prob, centers = blob_volume
    gt = centers + np.asarray([[1.0, 0.0, 0.0]] * len(centers))
    if as_list:
        from flypylib_tpu_torch.ops.nms import nms

        t_in = nms(prob, window=3, threshold=0.5)
        j_in = JTbars(locs=t_in.locs, conf=t_in.conf)
    else:
        t_in = j_in = prob
    got = tm.evaluate(t_in, Tbars(locs=gt), dist_thresh=2.0)
    want = jm.evaluate(j_in, JTbars(locs=gt), dist_thresh=2.0)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["recall"][-1] == 1.0


@pytest.mark.parametrize("suffix", [".json", ".csv"])
def test_pr_curve_dump_equals_jax(tmp_path, blob_volume, suffix):
    prob, centers = blob_volume
    curve = tm.evaluate(prob, Tbars(locs=centers))
    a, b = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    tmetrics.dump_pr_curve(curve, str(a))
    jmetrics.dump_pr_curve(curve, str(b))
    assert a.read_text() == b.read_text()
    if suffix == ".json":
        back = tmetrics.load_pr_curve(str(a))
        for k, v in curve.items():
            np.testing.assert_array_equal(back[k], v)


def test_metrics_log_writes_jsonl(tmp_path):
    path = tmp_path / "m.jsonl"
    log = tmetrics.MetricsLog(str(path))
    log.log({"epoch": 0, "loss": 0.5})
    log.log({"epoch": 1, "loss": 0.25})
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["loss"] for r in rows] == [0.5, 0.25]
    assert log.records[1]["epoch"] == 1 and "ts" in log.records[0]


def test_pad_mode_takes_reflect_or_none_only():
    spec = _small_spec("unet")
    with pytest.raises(ValueError, match="pad_mode"):
        TiledInference(spec, tile_out=12, tile_batch=2, pad_mode="edge")
