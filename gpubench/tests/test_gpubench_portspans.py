"""The readers of the port's own spans and counters (``gpubench/portspans.py``
and the metrics that use it), on synthetic records and on records the port
makes on the CPU under ``torch.profiler``; ``idle_unspanned_s`` on a
synthetic event list."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from gpubench import harness, portspans
from gpubench.observe import Obs, Spans

MAN = harness.manifest()
CAT = harness.Catalog()


def span(name, id_, root, start, end, stream=None, parent=None):
    return {"name": name, "id": id_, "parent": root if parent is None
            else parent, "root": root, "thread": 1, "start_ns": start,
            "end_ns": end, "host_ms": (end - start) / 1e6,
            "stream_ms": stream, "attrs": {}}


def obs_with(spans, counters=None):
    obs = Obs(Spans(), {}, {})
    obs.trace = {"spans": spans, "counters": counters or {}}
    return obs


def two_calls():
    """Two ``detect`` roots (ids 1 and 10) with one of each layer's spans."""
    out, counters = [], {}
    for root in (1, 10):
        out.append(span("detect", root, root, 0, 10_000_000, 100.0, 0))
        for k, (name, stream) in enumerate([
                ("detect.stage", 2.0), ("detect.forward", 50.0),
                ("forward.gather", 1.0), ("forward.module", 47.0),
                ("forward.scatter", 1.5), ("box.filter", 3.0),
                ("box.copy", None), ("box.merge", None),
                ("detect.finalize", None)]):
            out.append(span(name, root + k + 1, root, 1_000_000 * k,
                            1_000_000 * k + 500_000, stream))
        counters[root] = {"d2h_bytes": 4_000_000, "h2d_bytes": 2_000_000}
    return out, counters


def two_steps():
    """Two ``train.step`` roots (ids 1 and 10; the first 3 ms of host time,
    the second 9) with one of each part."""
    out = []
    for root, (t0, t1) in ((10, (5_000_000, 14_000_000)), (1, (0, 3_000_000))):
        out.append(span("train.step", root, root, t0, t1, 40.0, 0))
        for k, name in enumerate(["train.sample", "train.forward",
                                  "train.loss", "train.backward",
                                  "train.adam"]):
            out.append(span(name, root + k + 1, root, 0, 1, float(k + 1)))
    return out


VOLUME = {"stage_stream_ms.volume": 2.0, "forward_stream_ms.volume": 50.0,
          "tile_io_stream_ms.volume": 2.5, "box_stream_ms.volume": 3.0,
          "d2h_wait_ms.volume": 0.5, "host_post_ms.volume": 1.0,
          "d2h_mb.volume": 4.0, "h2d_mb.volume": 2.0}
TRAIN = {"sample_stream_ms": 1.0, "forward_stream_ms": 2.0,
         "backward_stream_ms": 7.0, "adam_stream_ms": 5.0,
         "step_host_ms": 3.0}
EXPECT = {**VOLUME, **{f"{k}.{c}": v for k, v in TRAIN.items()
                       for c in ("train", "train_b128")}}


def test_every_new_metric_is_declared_with_its_cell():
    declared = {m["name"]: m for m in MAN["per_layer"]}
    for name in EXPECT:
        m = declared[name]
        cell = {"volume": "baseline.volume_1k", "train": "baseline.train_b32",
                "train_b128": "baseline.train_b128"}[name.split(".")[1]]
        assert m["workloads"] == [cell]


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_reads_a_mean_a_call(name):
    recs = two_calls() if name.endswith(".volume") else (two_steps(), {})
    got = CAT.reader(name)(obs_with(*recs))
    assert got == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_gives_none_without_its_spans(name, monkeypatch):
    read = CAT.reader(name)
    assert read(obs_with([])) is None
    other = two_steps() if name.endswith(".volume") else two_calls()[0]
    assert read(obs_with(other)) is None
    # a port without the tracer (the parent's), and no records on the Obs
    from flypylib_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "take")
    assert read(Obs(Spans(), {}, {})) is None


def test_stream_readers_need_events():
    spans, counters = two_calls()
    for s in spans:
        s["stream_ms"] = None  # spans made on the CPU carry no events
    obs = obs_with(spans, counters)
    assert CAT.reader("forward_stream_ms.volume")(obs) is None
    assert CAT.reader("d2h_wait_ms.volume")(obs) == pytest.approx(0.5)


def test_readers_take_the_ports_records_once():
    """Records the port makes under ``torch.profiler`` (on the CPU: host
    clocks only) reach every reader of one ``Obs``."""
    from flypylib_tpu_torch import FplNetwork
    from flypylib_tpu_torch.models import zoo
    from flypylib_tpu_torch.utils import metrics

    metrics.take()
    net = FplNetwork(zoo.baseline_model(features=(4,), dilations=(1,),
                                        head_features=8, dtype=torch.float32),
                     device="cpu", packed=False)
    vol = np.random.default_rng(0).integers(0, 256, (24, 24, 24), np.uint8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            net.detect_large(vol, core=16, method="both", threshold=0.5,
                             tile_out=8, tile_batch=2)
    obs = Obs(Spans(), {}, {})
    post = CAT.reader("host_post_ms.volume")(obs)
    mb = CAT.reader("d2h_mb.volume")(obs)
    up = CAT.reader("h2d_mb.volume")(obs)
    assert post > 0 and mb > 0 and up == pytest.approx(vol.nbytes / 1e6)
    assert CAT.reader("stage_stream_ms.volume")(obs) is None  # no events
    assert len([s for s in obs.trace["spans"] if s["name"] == "detect"]) == 2
    assert metrics.take()["spans"] == []  # taken once, kept on the Obs


def event(name, start, end, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_idle_unspanned_counts_only_gaps_no_fpl_range_covers():
    cuda = DeviceType.CUDA
    events = [
        event("gpubench.window", 0, 100),
        event("kernel_a", 0, 20, cuda),
        event("kernel_b", 50, 60, cuda),
        event("kernel_c", 90, 100, cuda),
        event("fpl.detect.forward", 55, 95, cuda, annotation=True),
        # idle 20-50 and 60-90; an fpl range covers 25-50 and 60-80
        event("fpl.box.copy", 25, 50),
        event("fpl.detect.finalize", 60, 80),
        event("aten::copy_", 0, 100),
    ]
    assert portspans.idle_unspanned_s(events) == pytest.approx(15e-6)
    with pytest.raises(RuntimeError):
        portspans.idle_unspanned_s(events[1:])
