"""The port's staged whole-volume engine (``flypylib_tpu_torch/infer/
large.py``: ``make_stream_plan``, ``detect_staged``, the staging helpers)
and ``FplNetwork.detect_large`` against the JAX package and the host
reference, on the CPU.

- Plan geometry equals the JAX ``_StreamPlan``'s exactly, for the plain
  conv stack and a small U-Net (the pooled round-up).
- On one shell, ``consume_shared``'s lists equal JAX's exactly.
- ``detect_staged`` in roi, shared and chunked forms gives exactly
  ``nms_host`` / ``components_host`` of the port's monolithic map.
- The packed engines' ROI forwards keep the whole-volume phase, so their
  maps equal the monolithic map bit for bit (the port rounds the halo to
  ``size_multiple`` for them; the reference only for pooling models).
Volumes stay at or under 48^3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flypylib_tpu_torch as tpt
from flypylib_tpu.infer import large as jlarge
from flypylib_tpu.models import zoo as jzoo
from flypylib_tpu_torch.infer import large as tlarge
from flypylib_tpu_torch.infer.pipeline import zero_extend
from flypylib_tpu_torch.models import zoo as tzoo
from flypylib_tpu_torch.ops.host_reference import components_host, nms_host
from tests.conftest import make_blob_volume
from tests.test_torch_detect import assert_same_list

torch.set_num_threads(1)
SMALL = dict(features=(4, 6), dilations=(1, 2), head_features=8)
METHODS = ("nms", "components", "both")


@pytest.fixture(scope="module")
def specs():
    """Port and JAX specs with one geometry each: the small conv stack
    (random weights, as the JAX tests draw them) and a base-4 U-Net."""
    jconv = jzoo.baseline_model(dtype=jnp.float32, **SMALL)
    variables = jconv.init(jax.random.PRNGKey(0), 16)
    leaves, treedef = jax.tree.flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    variables = jax.tree.unflatten(
        treedef, [0.5 * jax.random.normal(k, l.shape, l.dtype)
                  for k, l in zip(keys, leaves)])
    tconv = tzoo.baseline_model(dtype=torch.float32, **SMALL)
    tconv.module.load_state_dict(tzoo.params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)))
    tunet = tzoo.unet(base_features=4, dtype=torch.float32)
    junet = jzoo.ModelSpec(
        name="unet", module=jzoo.UNetValid(base_features=4),
        context=tunet.context, size_multiple=tunet.size_multiple,
        size_offset=tunet.size_offset, min_size=tunet.min_size,
        metadata=tunet.metadata)
    return {"conv": (tconv, jconv, variables), "unet": (tunet, junet, None)}


def _slabs(pipe):
    """A pipeline's tile batches as ``[(zs, [[corner, ...], ...])]``."""
    if isinstance(pipe, tlarge.DetectPipeline):
        return [(zs, [[tuple(c) for c in b] for b in batches])
                for zs, batches in pipe._slabs]
    return [(zs, [[tuple(int(v) for v in c) for c in b]
                  for b in np.asarray(local)])
            for zs, local in pipe._slabs]


def _same_pipe(tp, jp):
    assert tp._tin == jp._tin
    assert tp._tiled.tile_out == jp._tiled.tile_out
    assert tp._tiled.tile_batch == jp._tiled.tile_batch
    assert tp.vol_shape == jp.vol_shape
    assert tuple(tp._out_shape) == tuple(jp._out_shape)
    assert tp.padded_shape == jp.padded_shape
    assert _slabs(tp) == _slabs(jp)


@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("shape", [(40, 33, 37), (48, 20, 45)])
@pytest.mark.parametrize("core", [16, (12, 20, 16)], ids=["int", "aniso"])
@pytest.mark.parametrize("kind", ["conv", "unet"])
def test_plan_geometry_equals_jax(specs, kind, core, shape, window):
    tspec, jspec, variables = specs[kind]
    for method in ("nms", "components"):
        kw = dict(core=core, window=window, threshold=0.5, method=method)
        tp = tlarge.make_stream_plan(tspec, None, shape, **kw)
        jp = jlarge.make_stream_plan(jspec, variables, shape, **kw)
        assert tp.grid == jp.grid
        assert list(tp.core_dims) == list(jp.core_dims)
        assert (tp.h, tp.ctx, tp.fetch_halo) == (jp.h, jp.ctx, jp.fetch_halo)
        for _, corner in tp.grid:
            assert tp.region(corner) == jp.region(corner)
        assert tp._shared_boxes() == jp._shared_boxes()
        assert tuple(tp._shell_shape()) == tuple(jp._shell_shape())
        assert tp._shell_ext() == jp._shell_ext()
        _same_pipe(tp.pipe, jp.pipe)
        _same_pipe(tp.full_pipe(), jp.full_pipe())
    # an explicit tile and batch flow into both pipes, as in the reference
    kw = dict(core=core, window=window, tile_out=tspec.size_multiple * 6,
              tile_batch=2)
    tp = tlarge.make_stream_plan(tspec, None, shape, **kw)
    jp = jlarge.make_stream_plan(jspec, variables, shape, **kw)
    _same_pipe(tp.pipe, jp.pipe)
    _same_pipe(tp.full_pipe(), jp.full_pipe())


@pytest.mark.parametrize("shape", [(48, 48, 48), (1024,) * 3, (300, 96, 200)])
def test_default_core_and_tile_equal_jax(specs, shape):
    for kind in ("conv", "unet"):
        tspec, jspec, _ = specs[kind]
        for window in (3, 5):
            assert tlarge._default_core(tspec, window, 256, shape) == \
                jlarge._default_core(jspec, window, 256, shape)
        for ext in (40, 128, 176, 300, 528, 1040):
            assert tlarge._default_tile(ext, tspec) == \
                jlarge._default_tile(ext, jspec)


def _shell(plan, rng):
    """A shell as ``shared_prob`` leaves it: blobs, noise and planted
    plateaus on the volume, -inf around it."""
    shape = plan.shape
    vol, _ = make_blob_volume(shape, centers=[(5, 6, 7), (20, 15, 25),
                                              (33, 28, 12)], sigma=2.5)
    vol = vol + 0.05 * rng.random(shape).astype(np.float32)
    vol[15, 15:18, 15] = 0.8   # a plateau across a core seam
    vol[30, 2, 30:32] = 0.8    # the same value elsewhere
    shell = np.full(plan._shell_shape(), -np.inf, np.float32)
    h = plan.h
    shell[h:h + shape[0], h:h + shape[1], h:h + shape[2]] = vol
    return shell, vol


@pytest.mark.parametrize("method", METHODS)
def test_consume_shared_equals_jax_on_one_shell(specs, rng, method):
    tspec, jspec, variables = specs["conv"]
    shape = (40, 33, 37)
    kw = dict(core=(16, 12, 20), window=5, threshold=0.45, method=method)
    tp = tlarge.make_stream_plan(tspec, None, shape, **kw)
    jp = jlarge.make_stream_plan(jspec, variables, shape, **kw)
    tp.shared_box_target = jp.shared_box_target = 24  # coarsen some boxes
    assert tp._shared_boxes() == jp._shared_boxes()
    shell, vol = _shell(tp, rng)
    got = tp.consume_shared(torch.from_numpy(shell))
    want = jp.consume_shared(jnp.asarray(shell))
    got = got if method == "both" else (got,)
    want = want if method == "both" else (want,)
    hosts = {"nms": nms_host(vol, window=5, threshold=0.45),
             "components": components_host(vol, threshold=0.45)}
    names = ("nms", "components") if method == "both" else (method,)
    for g, w, name in zip(got, want, names):
        assert len(g) > 2
        assert_same_list(g, w, loc_tol=0.0 if name == "nms" else 1e-12)
        assert_same_list(g, hosts[name])


def _scaled(vol):
    return vol.astype(np.float32) * np.float32(1.0 / 255.0)


@pytest.fixture(scope="module")
def net(specs):
    """The small conv stack on its default (packed) engine, on the CPU."""
    return tpt.FplNetwork(specs["conv"][0], device="cpu")


@pytest.mark.parametrize("dtype", ["f32", "uint8"])
@pytest.mark.parametrize("method", METHODS)
def test_detect_staged_modes_equal_the_host_reference(net, rng, method,
                                                      dtype):
    """roi, shared, and both over a chunk-staged volume: every list is the
    host reference's on the port's monolithic map (the scaled volume's for
    uint8)."""
    shape = (40, 33, 37)
    vol = rng.random(shape).astype(np.float32)
    if dtype == "uint8":
        vol = (vol * 255).astype(np.uint8)
    prob = net.infer(_scaled(vol) if dtype == "uint8" else vol, tile_out=48,
                     tile_batch=1)
    thr = float(np.quantile(prob, 0.99))
    want = {"nms": nms_host(prob, window=5, threshold=thr),
            "components": components_host(prob, threshold=thr)}
    plan = tlarge.make_stream_plan(net.infer_spec, None, shape,
                                   core=(16, 24, 20), tile_out=8, tile_batch=3,
                                   window=5, threshold=thr, method=method)
    chunked = tlarge.stage_volume_chunked(vol, plan=plan, chunk=12)
    assert isinstance(chunked, tlarge._StagedChunks)
    assert chunked.chunks[0].dtype == torch.from_numpy(vol).dtype
    names = ("nms", "components") if method == "both" else (method,)
    for forward, staged in (("roi", None), ("shared", None),
                            ("roi", chunked), ("shared", chunked)):
        got = tlarge.detect_staged(net.infer_spec, None, vol, plan=plan,
                                   threshold=thr, window=5, method=method,
                                   forward=forward, staged=staged)
        got = got if method == "both" else (got,)
        for g, name in zip(got, names):
            assert len(g) > 0
            assert_same_list(g, want[name])


@pytest.mark.parametrize("name,packed", [
    ("baseline", False), ("baseline", "auto"), ("vgg_like", "auto")],
    ids=["baseline-plain", "baseline-packed", "vgg_like-packed"])
def test_roi_forwards_equal_the_monolithic_map_bitwise(rng, name, packed):
    """Each ROI's map is the monolithic map's, bit for bit, on the plain
    and the packed engines: the packed ones only because the halo is
    rounded to ``size_multiple``.  At an odd phase a packed conv sums in
    another order: maps read 1.2e-7 apart in f32 and 1.8e-4 in bf16 (the
    small baseline of this test, shifted by one voxel)."""
    kw = {"baseline": dict(features=(4, 6, 6, 8), head_features=8),
          "vgg_like": dict(features=(4, 4, 4, 6, 6, 6, 6),
                           head_features=8)}[name]
    n = tpt.FplNetwork(name, device="cpu", packed=packed, dtype=torch.float32,
                       **kw)
    mult = n.infer_spec.size_multiple
    vol = (rng.random((28, 25, 30)) * 255).astype(np.uint8)
    prob = n.infer(_scaled(vol), tile_out=16, tile_batch=3)
    for method in ("nms", "components"):
        plan = tlarge.make_stream_plan(n.infer_spec, None, vol.shape,
                                       core=(16, 28, 32), tile_out=32,
                                       tile_batch=4, window=5, method=method)
        assert plan.h % mult == 0 and all(c % mult == 0 for _, corner
                                          in plan.grid for c in corner)
        big, _ = tlarge.stage_volume(vol, plan=plan, device="cpu")
        big = zero_extend(big, [s + 64 for s in big.shape])
        for _, corner in plan.grid:
            lo_want, vlo, vhi = plan.region(corner)
            out = plan.pipe.forward_from(big, corner).numpy()
            r0 = [v + plan.ctx for v in lo_want]
            np.testing.assert_array_equal(
                out[tuple(slice(a, b) for a, b in zip(vlo, vhi))],
                prob[tuple(slice(r + a, r + b)
                           for r, a, b in zip(r0, vlo, vhi))])


def test_pad_on_the_device_is_np_pad(rng):
    """stage_volume's device pad and every chunked window are np.pad's
    (reflect, then zeros), bit for bit, for uint8 and f32, including the
    host fallback for volumes with an extent <= the halo."""
    for dtype in (np.uint8, np.float32):
        vol = rng.random((20, 17, 23)).astype(np.float32)
        if dtype == np.uint8:
            vol = (vol * 255).astype(np.uint8)
        ref = np.pad(vol, 7, mode="reflect")
        big, h = tlarge.stage_volume(vol, halo=7, device="cpu")
        assert h == 7 and big.dtype == torch.from_numpy(vol).dtype
        np.testing.assert_array_equal(big.numpy(), ref)
        ch = tlarge.stage_volume_chunked(vol, halo=7, chunk=6, device="cpu")
        assert [c.shape[0] for c in ch.chunks] == [6, 6, 6, 2]
        ext = np.pad(ref, [(0, 12)] * 3)
        for start, size in (((0, 0, 0), (34, 31, 37)), ((5, 3, 9), (9, 8, 7)),
                            ((13, 20, 30), (20, 11, 7)),
                            ((33, 30, 36), (4, 4, 4)), ((40, 0, 0), (3, 3, 3))):
            got = ch.window(start, size).numpy()
            np.testing.assert_array_equal(
                got, ext[tuple(slice(s, s + n) for s, n in zip(start, size))])
    tiny = rng.random((5, 12, 12)).astype(np.float32)
    for stage in (tlarge.stage_volume, tlarge.stage_volume_chunked):
        big, h = stage(tiny, halo=7, device="cpu")  # 5 <= 7: on the host
        np.testing.assert_array_equal(big.numpy(),
                                      np.pad(tiny, 7, mode="reflect"))


def test_check_plan_and_staging_rejections(net, rng):
    vol = rng.random((40, 33, 37)).astype(np.float32)
    spec = net.infer_spec
    plan = tlarge.make_stream_plan(spec, None, vol.shape, core=20, tile_out=20,
                                   threshold=0.5)
    for kw, match in ((dict(core=32), "core"), (dict(tile_out=24), "tile_out"),
                      (dict(tile_batch=3), "tile_batch"),
                      (dict(window=3), "window"),
                      (dict(method="components"), "method")):
        with pytest.raises(ValueError, match=match):
            tlarge.detect_staged(spec, None, vol, plan=plan, **kw)
    with pytest.raises(ValueError, match="plan shape"):
        tlarge.detect_staged(spec, None, vol[:30], plan=plan)
    # omitted arguments defer to the plan, and the threshold is retargeted
    got = tlarge.detect_staged(spec, None, vol, plan=plan, threshold=0.6,
                               forward="roi")
    prob = net.infer(vol, tile_out=48, tile_batch=1)
    assert_same_list(got, nms_host(prob, window=5, threshold=0.6))
    for stage in (tlarge.stage_volume, tlarge.stage_volume_chunked):
        with pytest.raises(ValueError, match="plan .*or .*halo"):
            stage(vol)
    small, _ = tlarge.stage_volume(vol, halo=plan.fetch_halo - 1,
                                   device="cpu")
    with pytest.raises(ValueError, match="staged halo"):
        tlarge.detect_staged(spec, None, vol, plan=plan, staged=(small,
                             plan.fetch_halo - 1))
    with pytest.raises(ValueError, match="forward mode"):
        tlarge.detect_staged(spec, None, vol, plan=plan, forward="band")
    for kw, match in ((dict(method="watershed"), "method"),
                      (dict(cc_impl="dense"), "cc_impl"),
                      (dict(fused_impl="gather"), "fused_impl"),
                      (dict(tile_out=1), "size_multiple"),
                      (dict(tile_batch=0), "tile_batch")):
        with pytest.raises(ValueError, match=match):
            tlarge.make_stream_plan(spec, None, vol.shape, **kw)


def test_detect_large_equals_detect_on_the_scaled_volume(net, rng):
    """FplNetwork.detect_large on a uint8 volume (roi, shared, auto; a
    staged upload reused) equals detect on vol * f32(1/255), whose map is
    the one the staged engine computes."""
    vol = (rng.random((36, 30, 33)) * 255).astype(np.uint8)
    scaled = _scaled(vol)
    prob = net.infer(scaled)
    thr = float(np.quantile(prob, 0.985))
    want = {"nms": net.detect(scaled, threshold=thr),
            "components": net.detect(scaled, threshold=thr,
                                     method="components")}
    for forward in ("roi", "shared", "auto"):
        got = net.detect_large(vol, threshold=thr, method="both", core=16,
                               forward=forward)
        assert_same_list(got[0], want["nms"])
        assert_same_list(got[1], want["components"])
    plan = tlarge.make_stream_plan(net.infer_spec, None, vol.shape, core=16,
                                   threshold=thr, method="nms")
    staged = tlarge.stage_volume_chunked(vol, plan=plan)
    for _ in range(2):
        assert_same_list(net.detect_large(vol, threshold=thr, staged=staged,
                                          plan=plan), want["nms"])
    assert_same_list(net.detect_large(vol, threshold=thr, staged=True,
                                      method="components"),
                     want["components"])


def test_forward_auto_follows_the_memory_test(net, rng, monkeypatch):
    vol = rng.random((24, 24, 24)).astype(np.float32)
    plan = tlarge.make_stream_plan(net.infer_spec, None, vol.shape, core=12,
                                   threshold=0.9)
    assert plan.shared_auto(0)  # a few MB against the host's memory
    calls = []
    real = plan.shared_prob
    monkeypatch.setattr(plan, "shared_prob",
                        lambda s: calls.append(1) or real(s))
    a = tlarge.detect_staged(net.infer_spec, None, vol, plan=plan,
                             threshold=0.9)
    assert calls == [1]
    monkeypatch.setattr(tlarge, "memory_bytes", lambda device: (1 << 17,) * 2)
    assert not plan.shared_auto(0)
    b = tlarge.detect_staged(net.infer_spec, None, vol, plan=plan,
                             threshold=0.9)
    assert calls == [1]
    assert_same_list(a, b)
    assert not tlarge.staged_fits(vol, "cpu")


def _same_lists_bitwise(got, want):
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        np.testing.assert_array_equal(g.locs, w.locs)
        np.testing.assert_array_equal(g.conf, w.conf)


FANOUT_SHAPE = (40, 33, 37)
FANOUT_CORE = (12, 24, 20)  # four z-rows of ROIs: bands for 2 and 3 slots


@pytest.fixture(scope="module")
def fanout_case(net):
    """A uint8 volume, its threshold and a ``method="both"`` plan (small
    tiles, three to a batch)."""
    rng = np.random.default_rng(3)
    vol = (rng.random(FANOUT_SHAPE) * 255).astype(np.uint8)
    prob = net.infer(_scaled(vol), tile_out=48, tile_batch=1)
    thr = float(np.quantile(prob, 0.99))
    plan = tlarge.make_stream_plan(net.infer_spec, None, FANOUT_SHAPE,
                                   core=FANOUT_CORE, tile_out=8, tile_batch=3,
                                   window=5, threshold=thr, method="both")
    return vol, thr, plan


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("forward", ["roi", "shared"])
def test_detect_staged_devices_equal_one_device(net, fanout_case, forward, n,
                                                monkeypatch):
    """``detect_staged(devices=)`` on repeated CPU slots, from a whole and a
    chunked upload: the lists are bit for bit the single-device call's.  A
    list of one device runs the single-device path (as the reference's
    ``multi = len(devices) > 1``); longer lists run the same sweep over
    their slots, the shared one with one band per slot (two here: four rows
    in bands of two)."""
    vol, thr, plan = fanout_case
    kw = dict(plan=plan, threshold=thr, window=5, method="both",
              forward=forward)
    want = tlarge.detect_staged(net.infer_spec, None, vol, **kw)
    sweep = {"roi": "_detect_staged_roi",
             "shared": "_detect_staged_shared"}[forward]
    real = getattr(tlarge, sweep)
    slots = []
    monkeypatch.setattr(tlarge, sweep, lambda plan, staged, devs, *a:
                        slots.append(list(devs)) or real(plan, staged, devs,
                                                         *a))
    for staged in (None, tlarge.stage_volume_chunked(vol, plan=plan,
                                                     chunk=12)):
        got = tlarge.detect_staged(net.infer_spec, None, vol, staged=staged,
                                   devices=["cpu"] * n, **kw)
        _same_lists_bitwise(got, want)
    assert slots == [[torch.device("cpu")] * n] * 2
    if forward == "shared" and n > 1:
        assert plan._band_partition(n)[:2] == (2, 2)


@pytest.mark.parametrize("forward", ["roi", "shared"])
def test_detect_streaming_devices_equal_one_device(net, fanout_case,
                                                   forward):
    """``detect_streaming(devices=)`` on two CPU slots: ROI windows and
    bands round-robin over them, the lists bit for bit the single-device
    call's and the staged call's; shared bands split so that each slot gets
    one."""
    vol, thr, plan = fanout_case
    shape, read = tlarge.array_reader(vol)
    assert shape == vol.shape and np.array_equal(read((1, 2, 3), (4, 5, 6)),
                                                 vol[1:4, 2:5, 3:6])
    kw = dict(plan=plan, threshold=thr, window=5, method="both",
              forward=forward)
    want = tlarge.detect_streaming(net.infer_spec, None, shape, read, **kw)
    _same_lists_bitwise(want, tlarge.detect_staged(net.infer_spec, None, vol,
                                                   **kw))
    got = tlarge.detect_streaming(net.infer_spec, None, shape, read,
                                  devices=["cpu", "cpu"], **kw)
    _same_lists_bitwise(got, want)
    _same_lists_bitwise(net.detect_large(vol, staged=False,
                                         devices=["cpu", "cpu"], **kw), want)


def test_fanout_memory_rules(net, fanout_case, monkeypatch):
    """``shared_auto`` over several devices sizes one band shell per device
    (the reference's rule) and, given the list, as many as repeated slots
    put on one; ``staged_fits`` divides the f32 shell among distinct
    devices, and repeated slots of one device hold all of it;
    ``consume(ahead=)`` keeps grid order."""
    vol, thr, plan = fanout_case
    assert plan.shared_auto(0, n_devices=2, devices=["cpu", "cpu"])
    rpb, nb, _ = plan._band_partition(2)
    fp = plan.band_pipe(rpb)
    shell = 4 * int(np.prod(plan._band_shell_shape(fp)))
    rest = plan._act_bytes(fp) + plan._post_bytes()
    avail = (shell + rest) / 0.9 + 1  # one band shell fits, two do not
    monkeypatch.setattr(tlarge, "memory_bytes", lambda d: (avail, avail))
    assert plan.shared_auto(0, n_devices=2)
    assert not plan.shared_auto(0, n_devices=2, devices=["cpu", "cpu"])
    big = np.zeros((100, 100, 100), np.uint8)  # 1 MB + a 4 MB shell
    monkeypatch.setattr(tlarge, "memory_bytes",
                        lambda d: (0, int(3.1e6 / 0.6)))
    assert not tlarge.staged_fits(big, "cpu")
    assert tlarge.staged_fits(big, "cpu", devices=["cpu", "meta"])
    assert not tlarge.staged_fits(big, "cpu", devices=["cpu", "cpu"])
    assert tlarge.staged_fits(big, "cpu",
                              devices=["cpu", "cpu", "meta", "meta"])
    assert not tlarge.staged_fits(big, "cpu",
                                  devices=["cpu", "cpu", "cpu", "meta"])
    items = [((i,), (0, 0, 0), None, None, None) for i in range(5)]
    seen = []
    monkeypatch.setattr(plan, "_dispatch", lambda key, *a: {"key": key})
    monkeypatch.setattr(plan, "_collect", lambda rec, p: seen.append(rec["key"]))
    monkeypatch.setattr(plan, "_finalize", lambda: None)
    plan.consume(iter(items), ahead=3)
    assert seen == [(i,) for i in range(5)]
