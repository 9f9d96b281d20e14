"""The port's out-of-core engine (``flypylib_tpu_torch/infer/large.py``:
``detect_streaming`` in roi and shared z-band modes, the readers,
``detect_h5``, ``cc_impl="device"`` with its seam merge, ``fused_impl=
"nbr"``) and ``FplNetwork.detect_large``'s dispatch, against the JAX package
and the host reference, on the CPU.

- Every streaming list (roi, shared, forced bands of 1 and 2 ROI rows;
  sparse and device CC; filter and nbr; f32 and uint8 readers) equals
  ``nms_host`` / ``components_host`` on the port's whole-volume map
  (centroids within 1e-5), and roi equals shared bit for bit.
- Given the same probability maps, the postprocess lists (device CC, nbr)
  equal the JAX plan's.
- Band windows (``_band_read`` then ``_band_window``) equal JAX's
  ``_band_window_np`` bit for bit, and the band geometry JAX's, on plans of
  equal geometry (the plain conv stack and a U-Net).
- The copied ``merge_component_fragments`` / ``SeamUnionFind`` equal the
  reference's on random fragment sets.
Volumes stay at or under 48^3.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flypylib_tpu_torch as tpt
from flypylib_tpu.infer import large as jlarge
from flypylib_tpu.ops import components as jcomponents
from flypylib_tpu_torch.infer import large as tlarge
from flypylib_tpu_torch.ops import components as tcomponents
from flypylib_tpu_torch.ops.host_reference import components_host, nms_host
from tests.test_torch_detect import assert_same_list
from tests.test_torch_large import (  # noqa: F401 (specs: a fixture)
    _same_pipe, _scaled, _shell, specs)

torch.set_num_threads(1)
SHAPE = (40, 33, 37)
CORE = (16, 24, 20)  # three z-rows: bands of 1 row, and of 2 (the last shifted)
TILING = dict(tile_out=8, tile_batch=3)
METHODS = ("nms", "components", "both")
CENTROID_TOL = 1e-5


def _by_method(result, method):
    names = ("nms", "components") if method == "both" else (method,)
    return dict(zip(names, result if method == "both" else (result,)))


def _bitwise(got, want):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.locs, want.locs)
    np.testing.assert_array_equal(got.conf, want.conf)


def _equal_host(got: dict, want: dict):
    for name, dets in got.items():
        assert len(dets) > 0
        assert_same_list(dets, want[name],
                         0.0 if name == "nms" else CENTROID_TOL)


@pytest.fixture(scope="module")
def net(specs):
    """The small conv stack on its default (packed) engine, on the CPU."""
    return tpt.FplNetwork(specs["conv"][0], device="cpu")


@pytest.fixture(scope="module")
def cases(net):
    """Per input dtype: the volume, the threshold (the 0.99 quantile of the
    port's whole-volume map) and the host reference's lists on that map."""
    rng = np.random.default_rng(3)
    out = {}
    for dtype in ("f32", "uint8"):
        vol = rng.random(SHAPE).astype(np.float32)
        if dtype == "uint8":
            vol = (vol * 255).astype(np.uint8)
        prob = net.infer(_scaled(vol) if dtype == "uint8" else vol,
                         tile_out=48, tile_batch=1)
        thr = float(np.quantile(prob, 0.99))
        out[dtype] = (vol, thr, {
            "nms": nms_host(prob, window=5, threshold=thr),
            "components": components_host(prob, threshold=thr)})
    return out


def _plan(net, thr, method, **kw):
    return tlarge.make_stream_plan(net.infer_spec, None, SHAPE, core=CORE,
                                   window=5, threshold=thr, method=method,
                                   **TILING, **kw)


def _streaming_runs(net, plan, vol, method):
    """The plan through roi, shared (one band of every row: the host has
    the memory) and forced bands of 1 and 2 rows; the lists per run."""
    shape, read = tlarge.array_reader(vol)
    kw = dict(plan=plan, threshold=plan.threshold, method=method,
              cc_impl=plan.cc_impl)
    runs = {f: tlarge.detect_streaming(net.infer_spec, None, shape, read,
                                       forward=f, **kw)
            for f in ("roi", "shared")}
    for rpb in (1, 2):
        runs[f"rpb{rpb}"] = tlarge._detect_streaming_shared(plan, read, rpb)
    return {k: _by_method(v, method) for k, v in runs.items()}


@pytest.mark.parametrize("cc_impl", ["sparse", "device"])
@pytest.mark.parametrize("method", METHODS)
def test_streaming_modes_equal_the_host_reference(net, cases, method,
                                                  cc_impl):
    vol, thr, want = cases["f32"]
    plan = _plan(net, thr, method, cc_impl=cc_impl)
    assert plan._band_starts(1) == [0, 16, 32]
    assert plan._band_starts(2) == [0, 16]  # the last band shifted down
    runs = _streaming_runs(net, plan, vol, method)
    for name, got in runs.items():
        _equal_host(got, want)
        for m in got:
            _bitwise(got[m], runs["roi"][m])
    # progress: one call per box, each with the box's own NMS count
    calls = []
    shape, read = tlarge.array_reader(vol)
    tlarge.detect_streaming(net.infer_spec, None, shape, read, plan=plan,
                            threshold=thr, method=method, cc_impl=cc_impl,
                            forward="roi",
                            progress=lambda c, n: calls.append((c, n)))
    assert [c for c, _ in calls] == [c for _, c in plan.grid]
    assert sum(n for _, n in calls) == (len(want["nms"])
                                        if method != "components" else 0)
    assert plan.fetch_seconds["read"] > 0


@pytest.mark.parametrize("dtype", ["f32", "uint8"])
def test_nbr_and_uint8_reader_equal_the_host_reference(net, cases, dtype):
    """``fused_impl="nbr"`` (roi: each candidate's neighbourhood gathered;
    shared falls back to the filter) on f32 and uint8 readers; a uint8
    volume enters the model as ``x * f32(1/255)``."""
    vol, thr, want = cases[dtype]
    plan = _plan(net, thr, "both", fused_impl="nbr")
    runs = _streaming_runs(net, plan, vol, "both")
    for got in runs.values():
        _equal_host(got, want)
        for m in got:
            _bitwise(got[m], runs["roi"][m])


def _roi_maps(plan, vol, outside=1.0):
    """Per ROI, the map a forward would give: the whole-volume map ``vol``
    at the ROI's window, ``outside`` (above threshold) where the window
    leaves the volume, so the masking is under test."""
    P = max(plan.pipe._out_shape) + plan.h
    big = np.full([s + 2 * P for s in vol.shape], outside, np.float32)
    big[P:P + vol.shape[0], P:P + vol.shape[1], P:P + vol.shape[2]] = vol
    out_shape = plan.pipe._out_shape
    for key, corner in plan.grid:
        lo_want, vlo, vhi = plan.region(corner)
        r0 = [P + c - plan.h for c in corner]
        out = big[tuple(slice(r, r + o) for r, o in zip(r0, out_shape))]
        yield key, corner, np.ascontiguousarray(out), lo_want, vlo, vhi


@pytest.mark.parametrize("mode,cc_impl,fused_impl,method", [
    ("roi", "sparse", "filter", "both"), ("roi", "sparse", "nbr", "both"),
    ("roi", "device", "filter", "both"), ("shared", "device", "filter", "both"),
    ("shared", "device", "filter", "components")])
def test_postprocess_equals_jax_on_the_same_map(specs, mode, cc_impl,
                                                fused_impl, method):
    """The same probability maps (per ROI, or one shell with planted
    plateaus) through the port's and the JAX plan's postprocess: equal
    lists, and equal to the host reference's on the volume."""
    tspec, jspec, variables = specs["conv"]
    kw = dict(core=(16, 12, 20), window=5, threshold=0.45, method=method,
              cc_impl=cc_impl, fused_impl=fused_impl)
    tp = tlarge.make_stream_plan(tspec, None, SHAPE, **kw)
    jp = jlarge.make_stream_plan(jspec, variables, SHAPE, **kw)
    tp.shared_box_target = jp.shared_box_target = 24
    shell, vol = _shell(tp, np.random.default_rng(5))
    if mode == "shared":
        got = tp.consume_shared(torch.from_numpy(shell))
        want = jp.consume_shared(jnp.asarray(shell))
    else:
        got = tp.consume((k, c, torch.from_numpy(o), vlo, vhi)
                         for k, c, o, _, vlo, vhi in _roi_maps(tp, vol))
        want = jp.consume((k, c, jnp.asarray(o), lw, vlo, vhi)
                          for k, c, o, lw, vlo, vhi in _roi_maps(tp, vol))
    got, want = _by_method(got, method), _by_method(want, method)
    hosts = {"nms": nms_host(vol, window=5, threshold=0.45),
             "components": components_host(vol, threshold=0.45)}
    for m in got:
        assert len(got[m]) > 2
        assert_same_list(got[m], want[m], 0.0 if m == "nms" else 1e-12)
        assert_same_list(got[m], hosts[m],
                         0.0 if m == "nms" else CENTROID_TOL)
    if cc_impl == "device":  # integer sums: centroids exactly scipy's
        _bitwise(got["components"], hosts["components"])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("kind", ["conv", "unet"])
def test_band_windows_and_geometry_equal_jax(specs, kind, dtype):
    """On plans of equal geometry (the plain conv stack; a U-Net with the
    pooled round-up): band starts, partitions, pipes and shell shapes equal
    JAX's, and every band window (read on the host, padded on the tensor's
    device) equals JAX's ``_band_window_np`` bit for bit (the full
    fetch-halo reflect, then zeros)."""
    tspec, jspec, variables = specs[kind]
    rng = np.random.default_rng(11)
    shape = (48, 46, 47)  # every extent past the U-Net's fetch halo (44)
    vol = rng.random(shape).astype(np.float32)
    if dtype == np.uint8:
        vol = (vol * 255).astype(np.uint8)
    _, read = tlarge.array_reader(vol)
    kw = dict(core=(12, 20, 16), window=5, method="nms")
    tp = tlarge.make_stream_plan(tspec, None, shape, **kw)
    jp = jlarge.make_stream_plan(jspec, variables, shape, **kw)
    assert min(shape) > tp.fetch_halo
    n_rows = len({c[0] for _, c in tp.grid})
    assert n_rows > 2
    for n in range(1, n_rows + 2):
        assert tp._band_partition(n) == jp._band_partition(n)
    for rpb in (1, 2, n_rows):
        assert tp._band_starts(rpb) == jp._band_starts(rpb)
        tfp, jfp = tp.band_pipe(rpb), jp.band_pipe(rpb)
        assert tp.band_pipe(rpb) is tfp
        _same_pipe(tfp, jfp)
        assert tuple(tp._band_shell_shape(tfp)) == \
            tuple(jp._band_shell_shape(jfp))
        for b0 in tp._band_starts(rpb):
            block, pads = tlarge._band_read(tp, tfp, read, b0)
            got = tlarge._band_window(tfp, torch.from_numpy(block), pads)
            want = jlarge._band_window_np(jp, jfp, read, b0)
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)


def _fragments(rng, core=(4, 5, 6), grid=(2, 2, 2)):
    """A random fragment set in ``merge_component_fragments``' format: per
    block a few components (some invalid) whose roots mark random face
    voxels, so seams link some of them."""
    cz, cy, cx = core
    sentinel = cz * cy * cx
    shapes = [(cy, cx), (cy, cx), (cz, cx), (cz, cx), (cz, cy), (cz, cy)]
    blocks = {}
    for key in np.ndindex(*grid):
        K = int(rng.integers(1, 7))
        uniq = np.sort(rng.choice(sentinel, K, replace=False)).astype(np.int64)
        faces = []
        for shp in shapes:
            f = np.full(shp, sentinel, np.int32)
            hit = rng.random(shp) < 0.3
            f[hit] = rng.choice(uniq, int(hit.sum()))
            faces.append(f)
        count = rng.integers(1, 30, K).astype(np.int64)
        corner = np.asarray(key) * np.asarray(core)
        blocks[tuple(int(k) for k in key)] = {
            "uniq": uniq,
            "sums": (rng.integers(0, 40, (K, 3)) * count[:, None]
                     + corner * count[:, None]),
            "count": count,
            "conf": rng.random(K).astype(np.float32),
            "valid": rng.random(K) < 0.9,
            "faces": faces,
        }
    return blocks, sentinel


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_copied_merge_and_union_find_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    blocks, sentinel = _fragments(rng)
    got = tcomponents.merge_component_fragments(blocks, sentinel)
    want = jcomponents.merge_component_fragments(blocks, sentinel)
    assert len(got) > 0
    _bitwise(got, want)
    tu, ju = tcomponents.SeamUnionFind(), jcomponents.SeamUnionFind()
    nodes = [(int(a), int(b)) for a, b in rng.integers(0, 12, (40, 2))]
    for i, j in rng.integers(0, len(nodes), (25, 2)):
        tu.union(nodes[i], nodes[j])
        ju.union(nodes[i], nodes[j])
    assert [tu.find(n) for n in nodes] == [ju.find(n) for n in nodes]
    assert tu.parent == ju.parent


def test_h5_reader_and_detect_h5_round_trip(net, cases, tmp_path):
    h5py = pytest.importorskip("h5py")
    vol, thr, want = cases["f32"]
    path = tmp_path / "vol.h5"
    with h5py.File(path, "w") as f:
        f["a_noise"] = np.zeros((4, 4, 4), np.float32)
        f["main"] = vol
    shape, read = tlarge.h5_reader(str(path))  # the default dataset
    assert shape == SHAPE
    np.testing.assert_array_equal(read((1, 2, 3), (5, 7, 9)),
                                  vol[1:5, 2:7, 3:9])
    got = tlarge.detect_h5(net.infer_spec, None, str(path), core=CORE,
                           threshold=thr, method="both", **TILING)
    _equal_host(_by_method(got, "both"), want)
    other = tmp_path / "other.h5"
    with h5py.File(other, "w") as f:
        f["raw"] = vol[:8]
        f["seg"] = np.ones((2, 2, 2), np.uint8)
    assert tlarge.h5_reader(str(other))[0] == (8, 33, 37)  # the first
    assert tlarge.h5_reader(str(other), "seg")[0] == (2, 2, 2)


class _FakeDvid:
    """``get_gray3d`` of a DVID client, over an in-RAM volume."""

    def __init__(self, vol):
        self.vol = vol
        self.calls = []

    def get_gray3d(self, instance, size, offset):
        self.calls.append((instance, size, offset))
        return self.vol[tuple(slice(o, o + s) for o, s in zip(offset, size))]


def test_dvid_reader_through_a_fake_client(net, cases):
    vol, thr, want = cases["uint8"]
    off = (3, 2, 5)
    big = np.zeros([s + o + 4 for s, o in zip(SHAPE, off)], np.uint8)
    big[off[0]:off[0] + SHAPE[0], off[1]:off[1] + SHAPE[1],
        off[2]:off[2] + SHAPE[2]] = vol
    client = _FakeDvid(big)
    shape, read = tlarge.dvid_reader(client, "grayscale", SHAPE, offset=off)
    assert shape == SHAPE
    np.testing.assert_array_equal(read((1, 2, 3), (4, 6, 8)),
                                  vol[1:4, 2:6, 3:8])
    assert client.calls[-1] == ("grayscale", (3, 4, 5), (4, 4, 8))
    got = net.detect_large((shape, read), core=CORE, threshold=thr,
                           method="both", forward="roi", **TILING)
    _equal_host(_by_method(got, "both"), want)


@pytest.mark.parametrize("form", ["path", "reader", "unstaged", "too_big"])
def test_detect_large_dispatch(net, cases, form, tmp_path, monkeypatch):
    """An HDF5 path, a (shape, read_fn) pair, ``staged=False`` and a volume
    that does not fit the device stream (``detect_streaming``); the lists
    equal the staged engine's and the host reference's."""
    vol, thr, want = cases["f32"]
    kw = dict(core=CORE, threshold=thr, method="both", **TILING)
    streamed = []
    real = tlarge.detect_streaming
    monkeypatch.setattr(tlarge, "detect_streaming",
                        lambda *a, **k: streamed.append(1) or real(*a, **k))
    staged = net.detect_large(vol, staged=True, **kw)
    assert streamed == []
    if form == "path":
        h5py = pytest.importorskip("h5py")
        with h5py.File(tmp_path / "v.h5", "w") as f:
            f["main"] = vol
        got = net.detect_large(str(tmp_path / "v.h5"), **kw)
    elif form == "reader":
        got = net.detect_large(tlarge.array_reader(vol), **kw)
    elif form == "unstaged":
        got = net.detect_large(vol, staged=False, **kw)
    else:
        monkeypatch.setattr(tlarge, "memory_bytes",
                            lambda device: (1 << 10, 1 << 10))
        assert not tlarge.staged_fits(vol, "cpu")
        got = net.detect_large(vol, forward="roi", **kw)
    assert streamed == [1]
    for g, s in zip(got, staged):
        _bitwise(g, s)
    _equal_host(_by_method(got, "both"), want)


@pytest.mark.parametrize("forward", ["roi", "shared"])
def test_fetch_error_surfaces_on_the_consumer_side(net, cases, forward):
    """A read that fails in the prefetch thread raises RuntimeError in the
    caller, chained to the read's own error; the thread ends."""
    vol, thr, _ = cases["f32"]
    shape, read = tlarge.array_reader(vol)
    n = {"reads": 0}

    def flaky(lo, hi):
        if np.prod([b - a for a, b in zip(lo, hi)]) > 1:  # not the probe
            n["reads"] += 1
            if n["reads"] == 2:
                raise OSError("disk gone")
        return read(lo, hi)

    before = threading.active_count()
    plan = _plan(net, thr, "nms")
    fn = (tlarge.detect_streaming if forward == "roi" else
          lambda *a, **k: tlarge._detect_streaming_shared(plan, flaky, 1))
    with pytest.raises(RuntimeError, match="fetch failed") as err:
        fn(net.infer_spec, None, shape, flaky, plan=plan, threshold=thr,
           forward=forward)
    assert isinstance(err.value.__cause__, OSError)
    assert threading.active_count() == before


def test_band_rpb_follows_the_memory_and_the_cost_gate(net, cases,
                                                       monkeypatch):
    vol, thr, want = cases["f32"]
    shape, read = tlarge.array_reader(vol)
    plan = _plan(net, thr, "nms")
    assert plan.band_rpb(cost_gate=False) == 3  # every row: the host's memory
    gate = plan._shared_cost_ok(plan.band_pipe(3))
    assert plan.band_rpb() == (3 if gate else None)
    calls = []
    real = tlarge._detect_streaming_shared
    monkeypatch.setattr(tlarge, "_detect_streaming_shared",
                        lambda *a: calls.append(a[2]) or real(*a))
    got = tlarge.detect_streaming(net.infer_spec, None, shape, read,
                                  plan=plan, threshold=thr)  # auto
    assert calls == ([3] if gate else [])
    assert_same_list(got, want["nms"])
    # memory for bands of one row only (a tenth over their own peak)
    fp1 = plan.band_pipe(1)
    z_top = max(zs for zs, _ in fp1._slabs) + fp1._tin
    one = (2 * 4 * int(np.prod(plan._band_shell_shape(fp1)))
           + 2 * 4 * z_top * fp1.padded_shape[1] * fp1.padded_shape[2]
           + plan._act_bytes(fp1) + plan._post_bytes())
    monkeypatch.setattr(tlarge, "memory_bytes",
                        lambda device: (int(one * 1.12), int(one * 1.12)))
    assert plan.band_rpb(cost_gate=False) == 1
    got = tlarge.detect_streaming(net.infer_spec, None, shape, read,
                                  plan=plan, threshold=thr, forward="shared")
    assert calls[-1] == 1
    assert_same_list(got, want["nms"])
    monkeypatch.setattr(tlarge, "memory_bytes", lambda device: (1 << 10,) * 2)
    assert plan.band_rpb(cost_gate=False) is None
    with pytest.raises(ValueError, match="does not fit"):
        tlarge.detect_streaming(net.infer_spec, None, shape, read, plan=plan,
                                threshold=thr, forward="shared")
