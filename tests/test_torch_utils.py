"""The port's utilities (``utils/metrics.py``: ``StageTimer``,
``profile_trace``, ``plot_pr_curve``; ``utils/debug.py``: the NaN/Inf
checks) and ``TiledInference.infer(host_stream=True)``, on the CPU.

``host_stream`` must give the device sweep's map bit for bit (the
reference's ``test_host_stream_equals_device_path``): the same tiles, in
the same batches, through the same forward.  It is checked at two volume
shapes, for a conv stack (packed and plain) and the U-Net's covering tile,
with ``tile_batch`` 1 (many batches) and more; ``StageTimer`` against the
reference's on the same stages.
"""

import json
import os

import numpy as np
import pytest
import torch

from flypylib_tpu.utils import metrics as jmetrics
from flypylib_tpu_torch import FplNetwork
from flypylib_tpu_torch.infer.tiled import TiledInference, stream_tiles
from flypylib_tpu_torch.models import zoo as tzoo
from flypylib_tpu_torch.utils import debug
from flypylib_tpu_torch.utils.metrics import (StageTimer, plot_pr_curve,
                                              profile_trace)

torch.set_num_threads(1)


def test_stage_timer():
    t, ref = StageTimer(), jmetrics.StageTimer()
    for timer in (t, ref):
        for _ in range(2):
            with timer.stage("infer", voxels=1_000_000):
                pass
        with pytest.raises(KeyError):
            with timer.stage("nms"):
                raise KeyError("inside")  # still counted, then re-raised
    r, want = t.report(), ref.report()
    assert r.keys() == want.keys() == {"infer", "nms"}
    for name in r:
        assert r[name].keys() == want[name].keys()
        assert r[name]["calls"] == want[name]["calls"]
        assert r[name]["voxels"] == want[name]["voxels"]
    assert r["infer"]["calls"] == 2 and r["infer"]["voxels"] == 2_000_000
    assert "mvox_per_s" in r["infer"] and "mvox_per_s" not in r["nms"]
    t.log()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    net = FplNetwork(tzoo.baseline_model(features=(4,), dilations=(1,),
                                         head_features=8, dtype=torch.float32),
                     device="cpu", packed=False)
    with profile_trace(log_dir) as prof:
        net.infer(np.zeros((10, 10, 10), np.float32), tile_out=8)
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("conv" in n for n in names), sorted(names)[:20]
    assert len(prof.key_averages()) > 0


def test_plot_pr_curve(tmp_path):
    pytest.importorskip("matplotlib")
    curve = {"precision": np.array([1.0, 0.9, 0.8]),
             "recall": np.array([0.3, 0.6, 0.9])}
    p = str(tmp_path / "pr.png")
    assert plot_pr_curve({"run A": curve, "run B": curve}, p) == p
    assert os.path.getsize(p) > 1000
    q = str(tmp_path / "one.png")
    plot_pr_curve(curve, q)  # a single curve
    assert os.path.getsize(q) > 1000


def test_nan_checks_raise_and_switch_off():
    x = torch.ones(4)
    with debug.nan_checks():
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.zeros(4) / torch.zeros(4)
        with pytest.raises(FloatingPointError, match="Inf"):
            x / 0.0
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.log(-x)  # a method and a function alike
        assert torch.equal(x + 1, torch.full((4,), 2.0))  # finite passes
        torch.empty(8)  # uninitialised memory is not checked
    assert torch.isnan(torch.zeros(1) / 0.0).all()  # off on exit
    debug.enable_nan_checks(infs=False)
    try:
        assert torch.isinf(x / 0.0).all()  # Inf allowed
        with pytest.raises(FloatingPointError):
            torch.sqrt(-x)
    finally:
        debug.disable_nan_checks()
    assert torch.isnan(torch.sqrt(-x)).all()
    with pytest.raises(FloatingPointError):  # the context ends on an error
        with debug.nan_checks():
            torch.sqrt(-x)
    assert torch.isnan(torch.sqrt(-x)).all()


def _engines():
    small = dict(features=(4, 6), dilations=(1, 2), head_features=8,
                 dtype=torch.float32, seed=1)
    return {
        "packed": FplNetwork(tzoo.baseline_model(**small), device="cpu"),
        "plain": FplNetwork(tzoo.baseline_model(**small), device="cpu",
                            packed=False),
        "unet": FplNetwork(tzoo.unet(base_features=4, levels=1,
                                     convs_per_stage=1, dtype=torch.float32),
                           device="cpu"),
    }


@pytest.mark.parametrize("shape", [(20, 17, 23), (9, 30, 12)])
@pytest.mark.parametrize("tile_batch", [1, 3])
@pytest.mark.parametrize("dtype", ["f32", "uint8"])
def test_host_stream_equals_device_path(shape, tile_batch, dtype):
    rng = np.random.default_rng(sum(shape) + tile_batch)
    vol = rng.random(shape).astype(np.float32)
    if dtype == "uint8":
        vol = (vol * 255).astype(np.uint8)
    for name, net in _engines().items():
        tile = 8 if name != "unet" else max(shape)
        eng = TiledInference(net.infer_spec, tile_out=tile,
                             tile_batch=tile_batch)
        if name != "unet":
            assert eng.n_batches(shape) > 2  # several batches in flight
        want = eng.infer(vol)
        got = eng.infer(vol, host_stream=True)
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got, want)
        dev = eng.infer(vol, keep_on_device=True, host_stream=True)
        assert isinstance(dev, torch.Tensor)
        np.testing.assert_array_equal(dev.numpy(), want)


def test_stream_tiles_yields_the_batches_in_order():
    padded = np.arange(12 * 13 * 14, dtype=np.float32).reshape(12, 13, 14)
    batches = [[(0, 0, 0), (2, 3, 4)], [(5, 1, 0), (5, 1, 0)]]
    got = list(stream_tiles(padded, batches, 6, torch.device("cpu")))
    assert len(got) == 2
    for cs, tiles in zip(batches, got):
        assert tiles.shape == (2, 6, 6, 6) and tiles.dtype == torch.float32
        for (z, y, x), t in zip(cs, tiles):
            np.testing.assert_array_equal(t.numpy(),
                                          padded[z:z + 6, y:y + 6, x:x + 6])
    assert list(stream_tiles(padded, [], 6, torch.device("cpu"))) == []
