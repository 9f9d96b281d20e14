"""The port's detection path (``flypylib_tpu_torch``: NMS, connected
components, tiled inference, ``FplNetwork``) against the JAX package and
the host reference, on the same inputs.

Detection lists must be equal: the same locations in the same (canonical)
order, with conf within 1e-6; CC centroids within 1e-5 of the JAX
package's (which computes them in f32) and exactly the host reference's.
"""

import importlib
import inspect
import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import chip_smoke
import flypylib_tpu_torch as tpt
from flypylib_tpu.io import synapses as j_syn
from flypylib_tpu.models.zoo import ModelSpec as j_ModelSpec
from flypylib_tpu.models.zoo import baseline_model as j_baseline
from flypylib_tpu.network import FplNetwork as JaxNetwork
from flypylib_tpu.ops import host_reference as j_host
from flypylib_tpu.ops.components import label_components as j_label
from flypylib_tpu.ops.packed_conv import PackedConvStack as j_PackedConvStack
from flypylib_tpu.utils import core as j_core
from flypylib_tpu_torch.infer.tiled import TiledInference, default_tiling
from flypylib_tpu_torch.io import synapses as t_syn
from flypylib_tpu_torch.models.zoo import baseline_model
from flypylib_tpu_torch.ops import host_reference as t_host
from flypylib_tpu_torch.ops.components import components_device
from flypylib_tpu_torch.ops.nms import (mask_valid_region, max_filter,
                                        nms_device)
from flypylib_tpu_torch.ops.packed_conv import PackedConvStack, packed_spec
from flypylib_tpu_torch.utils import core as t_core
from tests.conftest import make_blob_volume

torch.set_num_threads(1)
# the package's ``ops`` exports a function ``nms`` over the module's name
j_nms = importlib.import_module("flypylib_tpu.ops.nms")

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(features=(4, 6), dilations=(1, 2), head_features=8)


def assert_same_list(got, want, loc_tol=0.0):
    """Same length, same order; locations within ``loc_tol`` (0: equal)."""
    assert len(got) == len(want)
    if loc_tol == 0.0:
        np.testing.assert_array_equal(got.locs, want.locs)
    else:
        np.testing.assert_allclose(got.locs, want.locs, rtol=0, atol=loc_tol)
    np.testing.assert_allclose(got.conf, want.conf, rtol=0, atol=1e-6)


def _plateau_volume():
    """Blobs plus planted equal-value plateaus, inside one component and
    across components, so both the tie order and the CC grouping matter."""
    vol, _ = make_blob_volume((32, 30, 28), centers=[(8, 8, 8), (20, 22, 18)],
                              sigma=2.0)
    vol[3, 20, 5:8] = 0.9          # a 3-voxel plateau
    vol[26, 4:6, 20:22] = 0.9      # a 2x2 plateau, the same value
    vol[14, 14, 3] = 0.9           # a single voxel, the same value again
    vol[0, 0, 0] = 0.75            # corner maximum (-inf outside)
    return vol


VOLUMES = {
    "blobs": lambda: make_blob_volume((40, 36, 32), sigma=2.5,
                                      centers=[(10, 10, 10), (25, 30, 20),
                                               (35, 8, 25)])[0],
    "plateaus": _plateau_volume,
}


@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("kind", sorted(VOLUMES))
def test_nms_equals_jax_and_host(kind, window):
    vol = VOLUMES[kind]()
    got = tpt.nms(vol, window=window, threshold=0.5)
    assert len(got) > 0
    assert_same_list(got, j_host.nms_host(vol, window=window, threshold=0.5))
    assert_same_list(got, j_nms.nms(vol, window=window, threshold=0.5))


@pytest.mark.parametrize("kind", sorted(VOLUMES))
def test_components_equal_jax_and_host(kind):
    vol = VOLUMES[kind]()
    got = tpt.label_components(vol, threshold=0.5)
    assert len(got) > 0
    assert_same_list(got, j_host.components_host(vol, threshold=0.5))
    assert_same_list(got, j_label(vol, threshold=0.5), loc_tol=1e-5)


def test_components_on_a_torch_tensor_and_when_empty():
    vol = _plateau_volume()
    assert_same_list(tpt.label_components(torch.from_numpy(vol), 0.5),
                     j_host.components_host(vol, 0.5))
    cents, conf = components_device(torch.from_numpy(vol), threshold=2.0)
    assert cents.shape == (0, 3) and conf.shape == (0,)
    assert len(tpt.label_components(vol, threshold=2.0)) == 0
    assert len(tpt.nms(vol, threshold=2.0)) == 0


def test_components_snake_needs_many_sweeps():
    # one long 6-connected path: labels must travel its whole length
    vol = np.zeros((3, 12, 12), np.float32)
    vol[1, ::2, :] = 0.8
    for r in range(0, 10, 2):
        vol[1, r + 1, 11 if (r // 2) % 2 == 0 else 0] = 0.8
    vol[1, 10, 4] = 0.95
    got = tpt.label_components(vol, threshold=0.5)
    assert len(got) == 1 and got.conf[0] == np.float32(0.95)
    assert_same_list(got, j_host.components_host(vol, threshold=0.5))


@pytest.mark.parametrize("window", [3, 5, (3, 5, 1)])
def test_max_filter_is_scipy_with_minus_inf_padding(rng, window):
    vol = rng.random((9, 11, 10)).astype(np.float32)
    want = ndimage.maximum_filter(vol, size=t_core.to3d(window),
                                  mode="constant", cval=-np.inf)
    got = max_filter(torch.from_numpy(vol), window)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask_valid_region_equals_jax(rng):
    vol = rng.random((7, 8, 9)).astype(np.float32)
    lo, hi = (1, 0, 2), (6, 5, 9)
    got, inb = mask_valid_region(torch.from_numpy(vol), lo, hi)
    want, winb = j_nms.mask_valid_region(jnp.asarray(vol), jnp.asarray(lo),
                                         jnp.asarray(hi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(inb.numpy(), np.asarray(winb))


def test_nms_device_slots_and_cap_warning(rng):
    vol = rng.random((16, 16, 16)).astype(np.float32)
    full = tpt.nms(vol, window=3, threshold=0.7)
    n = len(full)
    assert n > 4
    locs, conf, valid = nms_device(torch.from_numpy(vol), 3, 0.7)
    assert bool(valid.all()) and locs.shape == (n, 3)
    np.testing.assert_array_equal(locs.numpy(), full.locs)
    locs, conf, valid = nms_device(torch.from_numpy(vol), 3, 0.7,
                                   max_detections=n + 5)
    assert int(valid.sum()) == n and bool(torch.isinf(conf[n:]).all())
    with pytest.warns(UserWarning, match="max_detections"):
        capped = tpt.nms(vol, window=3, threshold=0.7, max_detections=4)
    assert_same_list(capped, t_syn.Tbars(full.locs[:4], full.conf[:4]))


def test_nms_explicit_cap_not_reached_does_not_warn(rng, recwarn):
    vol = rng.random((12, 12, 12)).astype(np.float32)
    n = len(tpt.nms(vol, threshold=0.7))
    tpt.nms(vol, threshold=0.7, max_detections=n)
    assert not [w for w in recwarn if "max_detections" in str(w.message)]


def _small_net(dtype=torch.float32, seed=0):
    """The plain stack (K1 on every conv); ``tests/test_torch_packed_conv.py``
    holds the packed engine, the default, to the same invariants."""
    return tpt.FplNetwork(baseline_model(dtype=dtype, seed=seed, **SMALL),
                          device="cpu", packed=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tiled_equals_monolithic_bitwise(rng, dtype):
    net = _small_net(dtype)
    vol = rng.integers(0, 256, (21, 19, 17), dtype=np.uint8)
    mono = net.infer(vol, tile_out=32, tile_batch=1)
    tiled = net.tiled_inference(vol.shape, tile_out=8, tile_batch=3)
    assert tiled.n_batches(vol.shape) == 9  # 3 * 3 * 3 tiles in batches of 3
    got = net.infer(vol, tile_out=8, tile_batch=3)
    assert got.dtype == np.float32 and got.shape == vol.shape
    np.testing.assert_array_equal(got, mono)
    dev = net.infer(vol, tile_out=8, tile_batch=3, keep_on_device=True)
    assert isinstance(dev, torch.Tensor) and torch.equal(dev,
                                                         torch.from_numpy(got))


def test_default_tiling_is_the_reference_choice():
    from flypylib_tpu.infer.tiled import default_tiling as j_default_tiling
    from flypylib_tpu.infer.tiled import tiling_regime as j_tiling_regime
    from flypylib_tpu.models.zoo import MODEL_ZOO as J_ZOO
    from flypylib_tpu.ops.packed_unet import packed_unet_spec as j_packed
    from flypylib_tpu_torch.infer.tiled import tiling_regime
    from flypylib_tpu_torch.ops.packed_unet import packed_unet_spec

    pairs = [(tpt.models.MODEL_ZOO[n](), J_ZOO[n]())
             for n in ("baseline", "vgg_like", "unet")]
    pairs.append((packed_unet_spec(pairs[-1][0]), j_packed(pairs[-1][1])))
    # the packed conv stacks, the JAX specs with the port's geometry
    pairs += [(packed_spec(t), _jax_packed(j)) for t, j in pairs[:2]]
    for t, j in pairs:
        # the U-Net's (24, 2, 2) geometry, plain and packed, as JAX probes it
        for attr in ("name", "context", "size_multiple", "size_offset",
                     "min_size", "metadata"):
            assert getattr(t, attr) == getattr(j, attr), attr
        assert tiling_regime(t) == j_tiling_regime(j)
        for shape in [(24,) * 3, (48,) * 3, (64,) * 3, (100, 70, 30),
                      (256,) * 3, (1024,) * 3]:
            assert default_tiling(t, shape) == j_default_tiling(j, shape)
    tiled = TiledInference(tpt.models.baseline_model(), 64, 8)
    assert tiled.tile_in == 76 and tiled.n_batches((256,) * 3) == 8
    # the U-Net covers 256^3 in one tile; 1024^3 is above the 428 cap
    unet, packed = pairs[2][0], pairs[3][0]
    assert default_tiling(unet, (256,) * 3) == (256, 1)
    assert TiledInference(unet, 256, 1).tile_in == 296
    assert TiledInference(packed, 256, 1).tile_in == 300
    assert default_tiling(packed, (1024,) * 3) == (428 - 40, 1)
    # the packed conv stacks tile as the plain ones: 64 out, batch 8
    for t, tin in ((pairs[4][0], 76), (pairs[5][0], 94)):
        assert default_tiling(t, (256,) * 3) == (64, 8)
        assert TiledInference(t, 64, 8).tile_in == tin


def _jax_packed(spec):
    """The JAX ``packed_spec(spec)``, with the port's geometry in place of
    the JAX probe (``tests/test_torch_packed_conv.py`` holds the two equal
    for the zoo; the probe costs ~10 s a spec here)."""
    t = tpt.models.MODEL_ZOO[spec.name](**{
        k: spec.metadata[k] for k in ("features", "dilations")})
    tp = packed_spec(t)
    return j_ModelSpec(name=tp.name, module=j_PackedConvStack(spec.module),
                       context=tp.context, size_multiple=tp.size_multiple,
                       size_offset=tp.size_offset, min_size=tp.min_size,
                       metadata={**spec.metadata, "packed": True})


@pytest.mark.parametrize("packed", [False, "auto"], ids=["plain", "default"])
def test_network_matches_jax_end_to_end(rng, packed):
    """The port's engine against the JAX package's: ``packed=False`` (the
    plain stack, K1) against JAX ``packed=False``, and the default (the
    packed engine, K5) against JAX's default."""
    spec = j_baseline(dtype=jnp.float32, **SMALL)
    jnet = JaxNetwork(spec if packed is False else _jax_packed(spec),
                      packed=False)
    params = jax.tree_util.tree_map(np.array, jnet.variables)
    for layer in params["params"].values():
        layer["bias"] = rng.normal(0, 0.05, layer["bias"].shape).astype(
            np.float32)
    jnet.trainer.state = jnet.trainer.state.replace(params=params["params"])
    net = tpt.FplNetwork("baseline", device="cpu", dtype=torch.float32,
                         packed=packed, **SMALL)
    net.load_flax_params(params)
    assert isinstance(net.infer_spec.module, PackedConvStack) == bool(packed)
    assert net.infer_spec.name == jnet.infer_spec.name

    vol, _ = make_blob_volume((24,) * 3, centers=[(6, 7, 8), (16, 15, 17)],
                              sigma=2.0)
    vol = (vol * 200 + rng.random(vol.shape) * 20).astype(np.uint8)
    want = np.asarray(jnet.infer(vol))
    got = net.infer(vol)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    thr = float(np.quantile(want, 0.97))
    assert_same_list(net.detect(vol, threshold=thr),
                     jnet.detect(vol, threshold=thr))
    assert_same_list(net.detect(vol, threshold=thr, method="components"),
                     jnet.detect(vol, threshold=thr, method="components"),
                     loc_tol=1e-5)


def test_verbs_keep_the_reference_defaults():
    for verb in ("__init__", "infer", "nms", "components", "detect",
                 "detect_large"):
        mine = inspect.signature(getattr(tpt.FplNetwork, verb)).parameters
        ref = inspect.signature(getattr(JaxNetwork, verb)).parameters
        for name, p in mine.items():
            if name in ref:
                assert p.default == ref[name].default, (verb, name)
    for verb in (tpt.FplNetwork.detect, tpt.FplNetwork.detect_large):
        assert inspect.signature(verb).parameters["window"].default == 5
    assert inspect.signature(tpt.FplNetwork).parameters[
        "packed"].default == "auto"


def test_network_verbs_and_rejections(rng):
    net = _small_net()
    vol = rng.integers(0, 256, (20, 20, 20), dtype=np.uint8)
    prob = net.infer(vol)
    thr = float(np.quantile(prob, 0.95))
    assert_same_list(net.nms(prob, threshold=thr),
                     t_host.nms_host(prob, window=3, threshold=thr))
    assert_same_list(net.components(prob, threshold=thr),
                     t_host.components_host(prob, threshold=thr))
    assert_same_list(net.detect(vol, threshold=thr),
                     t_host.nms_host(prob, window=5, threshold=thr))
    with pytest.raises(ValueError, match="unknown method"):
        net.detect(vol, method="watershed")


def test_cuda_network_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpt.FplNetwork("baseline")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpt.FplNetwork("baseline", device="cuda")


def test_chip_smoke_main_path_rehearsal_on_cpu():
    net = _small_net(torch.bfloat16)
    vol = chip_smoke.make_volume_u8(32, 3, seed=0)
    res = chip_smoke.run_main_path(net, vol, n_cand=100)
    # the CPU runs the plain versions, which count no launch
    assert not any(res["launches"].values()) and res["n_batches"] == 1
    assert res["above_threshold"] >= 100 and res["n_nms"] > 0


COPIES = [
    (j_core, t_core, ["to3d", "ceil_div", "round_up", "block_starts",
                      "pad_to_multiple", "crop_center"]),
    (j_syn, t_syn, ["Tbars", "load_from_json", "save_to_json",
                    "_ball_offsets", "tbars_to_volume",
                    "make_training_volumes"]),
    (j_host, t_host, ["sort_detections", "nms_host", "components_host"]),
]


@pytest.mark.parametrize("orig,copy,names", COPIES,
                         ids=["utils.core", "io.synapses",
                              "ops.host_reference"])
def test_copied_modules_equal_their_originals(orig, copy, names):
    for name in names:
        assert inspect.getsource(getattr(copy, name)) == inspect.getsource(
            getattr(orig, name)), name


def test_copied_detection_helpers_agree(tmp_path):
    vol = _plateau_volume()
    for fn in ("nms_host", "components_host"):
        a = getattr(t_host, fn)(vol, threshold=0.5)
        b = getattr(j_host, fn)(vol, threshold=0.5)
        assert_same_list(a, b)
    tb = t_syn.Tbars(locs=[[1, 2, 3], [4, 5, 6]], conf=[0.5, 0.9])
    path = tmp_path / "tbars.json"
    t_syn.save_to_json(tb, str(path))
    back = j_syn.load_from_json(str(path))
    assert_same_list(t_syn.Tbars(back.locs, back.conf), tb)
    assert json.loads(path.read_text())


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'flypylib_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pkgutil, importlib, flypylib_tpu_torch\n"
        "for m in pkgutil.walk_packages(flypylib_tpu_torch.__path__,\n"
        "                               'flypylib_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_no_jax_import_lines_in_the_port():
    pat = re.compile(r"^\s*(import|from) (jax|flax|flypylib_tpu)\b")
    files = sorted((ROOT / "flypylib_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for ln in f.read_text().splitlines():
            assert not pat.match(ln), f"{f.name}: {ln}"
    mods = [m.name for m in pkgutil.walk_packages(tpt.__path__,
                                                  "flypylib_tpu_torch.")]
    assert "flypylib_tpu_torch.ops._build" in mods
