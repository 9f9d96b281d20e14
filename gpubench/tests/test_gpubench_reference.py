"""The reference against the port's CPU path at tiny sizes, and the
control (the reference in fp8) against the reference."""

import numpy as np
import pytest
import torch

from gpubench import compare, inputs, reference
from gpubench.harness import Catalog, import_port

CAT = Catalog()


def rel_gap(got, want) -> float:
    """max |got - want| against max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def port_module(port, cfg, params, dtype):
    """The port's plain module of ``cfg`` with ``params`` loaded, f32 or
    bf16, on the CPU."""
    from flypylib_tpu_torch.models.zoo import baseline_model

    spec = baseline_model(features=tuple(cfg["features"]),
                          dilations=tuple(cfg["dilations"]),
                          head_features=cfg["head_features"], dtype=dtype)
    net = port.FplNetwork(spec, device="cpu", packed=False)
    net.load_flax_params(inputs.flax_variables(params))
    return net


@pytest.mark.parametrize("size", [20, 27])
def test_forward_matches_port_f32(size):
    port = import_port()
    cfg = CAT.config("baseline")
    params = inputs.make_params(cfg, 7, "cpu")
    net = port_module(port, cfg, params, torch.float32)
    g = torch.Generator().manual_seed(3)
    x = torch.rand((2, size, size, size), generator=g)
    with torch.no_grad():
        got = net.module(x[..., None])[..., 0]
        want = reference.forward(cfg, params, x[:, None])[:, 0]
    assert got.shape == want.shape
    assert rel_gap(got.numpy(), want.numpy()) < 1e-5


@pytest.mark.parametrize("size", [24, 31])
def test_volume_logits_match_port_infer(size):
    """The whole-volume reference map (reflect pad, valid forward in
    z-slabs) against the port's tiled f32 inference on the same volume."""
    port = import_port()
    cfg = CAT.config("baseline")
    params = inputs.make_params(cfg, 11, "cpu")
    net = port_module(port, cfg, params, torch.float32)
    vol = inputs.blob_volume(size, 2, torch.Generator().manual_seed(5), "cpu")
    got = net.infer(vol.numpy())
    want = torch.sigmoid(reference.volume_logits(cfg, params, vol, None,
                                                slab=7)).numpy()
    assert np.max(np.abs(got - want)) < 1e-5


def test_detection_lists_match_port():
    port = import_port()
    g = torch.Generator().manual_seed(1)
    prob = torch.rand((20, 22, 24), generator=g)
    prob[3:6, 4:9, 5:7] = 0.97  # a plateau and a component
    thr = 0.9
    idx, conf = reference.nms(prob, 5, thr)
    want = port.nms(prob.numpy(), window=5, threshold=thr)
    assert sorted(compare.flat_index(want.locs, prob.shape)) == sorted(idx)
    cent, best = reference.components(prob, thr)
    cc = port.label_components(prob.numpy(), threshold=thr)
    key = lambda c: tuple(np.round(c, 9))  # noqa: E731
    assert sorted(map(key, cent)) == sorted(map(key, cc.locs))
    assert sorted(best) == pytest.approx(sorted(cc.conf))


def test_sampling_matches_the_trainer():
    """The reference's batch is the trainer's, voxel for voxel, from the
    same generator seed (the packed engine's patch)."""
    port = import_port()
    from flypylib_tpu_torch.train.trainer import (TrainConfig, TrainData,
                                                  make_loss_fn)

    cfg = CAT.config("baseline")
    wl = CAT.workload("baseline.train_b32")
    tc = {**wl["train"], "batch_size": 6}
    image, labels, mask = inputs.train_volume(40, 8, 2, wl["regions"], 9, "cpu")
    net = port.FplNetwork("baseline", device="cpu")
    loss_fn, sample_fn, patch = make_loss_fn(net.spec, TrainConfig(**tc))
    data = TrainData.build(image.numpy(), labels.numpy(), mask.numpy(), patch,
                           device="cpu")
    x, y, m, codes = sample_fn(torch.Generator().manual_seed(21), data)
    from flypylib_tpu_torch.ops.augment import augment_batch

    x, y, m = (augment_batch(v, codes) for v in (x, y, m))
    rd = reference.TrainData(image, labels, mask, patch)
    rx, ry, rm = reference.sample(torch.Generator().manual_seed(21), rd, tc,
                                  patch, reference.context(cfg))
    assert torch.equal(x, rx) and torch.equal(y, ry) and torch.equal(m, rm)


def test_fp8_control_reads_far_from_f32():
    cfg = CAT.config("baseline")
    params = inputs.make_params(cfg, 2, "cpu")
    x = torch.rand((1, 1, 24, 24, 24), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        a = reference.forward(cfg, params, x)
        b = reference.forward(cfg, params, x, "fp8")
    assert 1e-3 < rel_gap(b.numpy(), a.numpy()) < 0.5


@pytest.mark.parametrize("engine,patch", [("packed", 33), ("packed", 34),
                                          ("packed", 13), ("packed", 20),
                                          ("plain", 33), ("plain", 13)])
def test_train_patch_matches_the_trainer(engine, patch):
    """The patch the reference works out for an engine is the one the
    trainer samples."""
    port = import_port()
    from flypylib_tpu_torch.train.trainer import TrainConfig, make_loss_fn

    cfg = CAT.config("baseline")
    net = port.FplNetwork("baseline", device="cpu")
    _, _, got = make_loss_fn(net.spec, TrainConfig(patch_size=patch,
                                                   batch_size=4, engine=engine))
    assert reference.train_patch(cfg, patch, engine) == got
