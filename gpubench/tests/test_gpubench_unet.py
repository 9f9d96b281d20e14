"""The ``unet`` architecture (``archs/unet.py``) and its cell
``unet.volume_1k``: the weight layout against the port's state dict, the
counts against counts made by hand, the geometry against the port's probes,
and runs of a tiny copy of the cell on the CPU that a sound program passes
and a broken one fails."""

import json

import pytest

from gpubench import archs, compare, counts, harness, reference
from gpubench.tests.test_gpubench_faults import SEED, broken, half_left_out
from gpubench.tests.tiny import tiny_catalog

CAT = harness.Catalog()
CELL = "unet.volume_1k"
TINY = {"size": 40, "blobs": 4, "pool": 2, "probe": 24, "quantile": 0.99,
        "warmup": 1, "trace_calls": 1}


@pytest.fixture(scope="module")
def cfg():
    return CAT.config("unet")


def test_the_cell_is_in_the_benchmark(cfg):
    man = harness.manifest()
    entry = harness.cell_entry(man, CELL)
    assert entry["config"] == "unet" and entry["chips"] == 1
    assert archs.of(cfg).__name__ == "gpubench.archs.unet"
    assert cfg["reduced"] == [] and (cfg["base_features"], cfg["levels"],
                                     cfg["convs_per_stage"]) == (24, 2, 2)
    e2e = {m["name"] for m in harness.end_to_end_for(man, CELL)}
    assert e2e == {"setup_s", "volume_mvox_s"}
    assert len(harness.per_layer_for(man, CELL)) == 12


def test_shapes_match_the_ports_state_dict(cfg):
    from flypylib_tpu_torch.models.zoo import UNetValid

    arch = archs.of(cfg)
    shapes = {n: s for n, s, _ in reference.param_shapes(cfg)}
    assert list(shapes) == [f"Conv_{k}" for k in range(6)] + [
        "ConvTranspose_0", "Conv_6", "Conv_7", "ConvTranspose_1", "Conv_8",
        "Conv_9", "Conv_10"]
    assert arch.logits_layer(cfg) == "Conv_10"
    sd = UNetValid(base_features=24, levels=2, convs_per_stage=2).state_dict()
    seen = set()
    for key, t in sd.items():
        layer, leaf = arch.flax_name(cfg, key).split("/")
        want = shapes[layer] if leaf == "kernel" else (shapes[layer][-1],)
        if key == "logits.weight":  # the port keeps a 1x1x1 kernel as (ci, co)
            want = want[-2:]
        assert tuple(t.shape) == want, key
        seen.add(layer)
    assert seen == set(shapes)
    fans = {n: f for n, _, f in reference.param_shapes(cfg)}
    assert fans["ConvTranspose_0"] == 8 * 96 and fans["Conv_6"] == 27 * 96
    assert fans["Conv_10"] == 24


def hand_macs(out: int) -> list:
    """One valid forward of output ``out``, extents walked by hand: input
    out + 40; each 3^3 conv loses 2; a pool halves; a ConvTranspose
    doubles (one tap a voxel of its output)."""
    s = out + 40
    e0, e1 = s - 2, s - 4           # level 0
    a = e1 // 2
    e2, e3 = a - 2, a - 4           # level 1
    b = e3 // 2
    e4, e5 = b - 2, b - 4           # bottleneck
    u0 = 2 * e5
    e6, e7 = u0 - 2, u0 - 4
    u1 = 2 * e7
    e8, e9 = u1 - 2, u1 - 4
    assert e9 == out
    return [27 * 1 * 24 * e0**3, 27 * 24 * 24 * e1**3,
            27 * 24 * 48 * e2**3, 27 * 48 * 48 * e3**3,
            27 * 48 * 96 * e4**3, 27 * 96 * 96 * e5**3,
            96 * 48 * u0**3, 27 * 96 * 48 * e6**3, 27 * 48 * 48 * e7**3,
            48 * 24 * u1**3, 27 * 48 * 24 * e8**3, 27 * 24 * 24 * e9**3,
            24 * out**3]


@pytest.mark.parametrize("out", [4, 8])
def test_layer_macs_by_hand(cfg, out):
    got = archs.of(cfg).layer_macs(cfg, out)
    assert [m for _, m in got] == hand_macs(out)
    assert [n for n, _ in got] == [n for n, _, _ in reference.param_shapes(cfg)]
    assert counts.forward_flops(cfg, out) == 2.0 * sum(hand_macs(out))


def test_counts_at_1024(cfg):
    flops = counts.forward_flops(cfg, 1024)
    assert flops == 2.0 * sum(hand_macs(1024))
    # ~109 k multiply-adds an output voxel (105 k at the layers' own
    # extents less the halo each layer computes beyond the output)
    assert flops / 2 / 1024**3 == pytest.approx(109166.85, rel=1e-6)
    t, what = counts.forward_bound_s(cfg, 1024)
    assert what == "operations" and t == pytest.approx(flops / 989e12)


def test_geometry_matches_the_ports_probes(cfg):
    from flypylib_tpu_torch.models.zoo import _unet_geometry, _unet_out_size
    from flypylib_tpu_torch.ops.packed_unet import _packed_out_size

    arch = archs.of(cfg)
    ctx, mult, off, _ = _unet_geometry(2, 2)
    assert (arch.context(cfg), arch.grid(cfg)) == (ctx, (mult, off)) == (20, (4, 0))
    for s in range(8, 300):
        e = arch.extents(cfg, s)
        want = _unet_out_size(s, 2, 2)
        if e is not None:  # the arch refuses floor-pooled extents too
            assert e[-1][1] == want, s
        elif want is not None:
            assert s % 4, s
        assert arch.packed_extent(cfg, s) == _packed_out_size(s, 2, 2), s
    # the volume and the probe, padded by the context or not
    for s, out in ((1064, 1024), (296, 256), (1024, 984), (256, 216)):
        assert arch.extents(cfg, s)[-1][1] == out


@pytest.mark.parametrize("engine", ["plain", "packed"])
@pytest.mark.parametrize("patch", [13, 33, 44, 45, 50, 61])
def test_train_patch_matches_the_trainer(cfg, engine, patch):
    port = harness.import_port()
    from flypylib_tpu_torch.train.trainer import TrainConfig, make_loss_fn

    net = port.FplNetwork("unet", device="cpu")
    _, _, got = make_loss_fn(net.spec, TrainConfig(patch_size=patch,
                                                   batch_size=2, engine=engine))
    assert reference.train_patch(cfg, patch, engine) == got


# -- the cell at a tiny size on the CPU ------------------------------------

@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    dest = tmp_path_factory.mktemp("bench")
    cat = tiny_catalog(dest)
    wl = {**CAT.workload(CELL), **TINY}  # the cell's limits kept
    (dest / "workloads" / f"{CELL}.json").write_text(json.dumps(wl))
    return cat


def run(catalog, cell_cls=None):
    port = harness.import_port()
    line, _ = harness.run_cell(port, harness.manifest(), CELL, SEED, 0.3,
                               False, device="cpu", catalog=catalog,
                               cell_cls=cell_cls)
    return line


def test_sound_run_is_correct(catalog):
    line = run(catalog)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1


def test_a_skip_cropped_a_voxel_off_is_caught(catalog, monkeypatch):
    """Each decoder level's skip cut one voxel further along every axis
    than its centre: the detections move off the reference's."""
    from flypylib_tpu_torch.ops import packed_unet

    real = packed_unet.crop_packed

    def off_by_one(x, starts, sizes):
        return real(x, [s + 1 for s in starts], sizes)

    monkeypatch.setattr(packed_unet, "crop_packed", off_by_one)
    line = run(catalog)
    assert not line["correct"], line["checks"]


def test_half_a_tile_batch_left_out_is_caught(catalog):
    line = run(catalog, broken("volume", half_left_out))
    assert not line["correct"], line["checks"]


def test_control_fails(catalog):
    """The reference computed in fp8, put in the program's place."""
    from gpubench import control

    port = harness.import_port()
    wl = catalog.workload(CELL)
    cell = harness.kind_driver("volume")(port, catalog.config("unet"), wl,
                                         SEED, "cpu")
    cell.setup(False)
    cell.window(0.0, False)
    cell.release()
    got = dict(control.controls(cell, "volume"))["fp8"]
    assert not compare.passed(compare.judge(got, wl["limits"])), got
