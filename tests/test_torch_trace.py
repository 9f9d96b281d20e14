"""The port's tracer (``flypylib_tpu_torch/utils/metrics.py``: ``span``,
``timed``, ``count``, ``enable`` / ``take``) and its spans in the staged and
streamed detection paths and the training step, on the CPU.

- Off: no records, and ``span`` hands out one shared no-op.
- On: one ``detect`` root a ``detect_large`` call, its layers under it
  inside its host interval; ``d2h_bytes`` is 8 bytes an element copied;
  ``fetch.read`` runs on the prefetch thread under the call's root and still
  fills ``fetch_seconds``; a train step's spans in order under
  ``train.step``.
- Tracing changes no result (lists and parameters bitwise) and waits for
  nothing (no ``torch.cuda.synchronize``).
- Under ``torch.profiler`` the spans record by themselves and sit in the
  trace as ``fpl.*`` ranges.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from flypylib_tpu_torch import FplNetwork
from flypylib_tpu_torch.infer import large as tlarge
from flypylib_tpu_torch.models import zoo
from flypylib_tpu_torch.train import trainer as ttr
from flypylib_tpu_torch.utils import metrics as tm

torch.set_num_threads(1)
SHAPE = (36, 33, 40)
CORE = 16
LAYERS = ("detect.stage", "detect.forward", "detect.boxes", "detect.finalize")


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and no records."""
    tm.disable()
    yield
    tm.disable()


@pytest.fixture(scope="module")
def net():
    spec = zoo.baseline_model(features=(4, 6), dilations=(1, 2),
                              head_features=8, dtype=torch.float32)
    return FplNetwork(spec, device="cpu", packed=False)


@pytest.fixture(scope="module")
def vol():
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, SHAPE).astype(np.uint8)


def _detect(net, vol, mode):
    """One ``detect_large(method="both")`` call in ``mode`` (shared, roi, or
    streaming: the volume read through ``array_reader``)."""
    kw = dict(core=CORE, method="both", threshold=0.5, tile_out=8,
              tile_batch=3)
    if mode == "streaming":
        return net.detect_large(vol, staged=False, forward="roi", **kw)
    return net.detect_large(vol, staged=True, forward=mode, **kw)


def _same_lists(a, b):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x.locs, y.locs)
        np.testing.assert_array_equal(x.conf, y.conf)


def _train(steps=3):
    """``steps`` default-engine training steps of a small conv stack on a
    random labelled volume; returns the parameters after them."""
    spec = zoo.baseline_model(features=(4,), dilations=(1,), head_features=8,
                              dtype=torch.float32)
    cfg = ttr.TrainConfig(patch_size=13, batch_size=4)
    tr = ttr.Trainer(spec, cfg, seed=0, device="cpu")
    step, _, patch = ttr.make_train_step(spec, cfg)
    rng = np.random.default_rng(3)
    image = rng.random((28, 28, 28), dtype=np.float32)
    labels = (rng.random((28, 28, 28)) > 0.97).astype(np.float32)
    data = ttr.TrainData.build(image, labels, np.ones_like(labels), patch,
                               device="cpu")
    state = tr.init_state()
    for _ in range(steps):
        step(state, tr.generator, data)
    return {k: v.detach().clone() for k, v in state.module.state_dict().items()}


def test_off_records_nothing_and_hands_out_one_noop(net, vol):
    assert tm.span("a") is tm.span("b", device="cpu", x=1)
    with tm.span("a") as s:
        s.set(mode="x")
        tm.count("n", 3)
    _detect(net, vol, "shared")
    _train(1)
    assert tm.take() == {"spans": [], "counters": {}}
    with tm.timed("clock") as t:  # times with the tracer off too
        pass
    assert t.seconds >= 0 and tm.take()["spans"] == []


@pytest.mark.parametrize("mode", ["shared", "roi", "streaming"])
def test_one_detect_root_a_call_with_its_layers_inside(net, vol, mode):
    tm.enable()
    for _ in range(2):
        _detect(net, vol, mode)
    rec = tm.take()
    spans = rec["spans"]
    roots = [s for s in spans if s["name"] == "detect"]
    assert len(roots) == 2
    for root in roots:
        assert root["parent"] == 0 and root["root"] == root["id"]
        assert root["attrs"] == {"mode": mode, "voxels": int(np.prod(SHAPE))}
        mine = [s for s in spans if s["root"] == root["id"] and s is not root]
        names = Counter(s["name"] for s in mine)
        want = LAYERS if mode == "shared" else LAYERS[:2] + LAYERS[3:]
        assert all(names[n] >= 1 for n in want), names
        assert names["detect.finalize"] == 1
        assert names["forward.module"] == names["forward.scatter"] >= 1
        for s in mine:
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= root["end_ns"], s["name"]
            assert s["stream_ms"] is None  # no events on the CPU
        by_id = {s["id"]: s for s in spans}
        for s in mine:
            if s["name"] in LAYERS:
                assert s["parent"] == root["id"]
            if s["name"].startswith("forward."):
                assert by_id[s["parent"]]["name"] == "detect.forward"
            if s["name"].startswith("box."):
                assert by_id[s["parent"]]["name"] in (
                    ("detect.boxes",) if mode == "shared" else ("detect",))
    assert set(rec["counters"]) == {r["id"] for r in roots}


def test_d2h_bytes_count_what_to_host_copied(net, vol, monkeypatch):
    copied = []
    real = tlarge.to_host

    def spy(*tensors, **kw):
        copied.append(sum(t.numel() for t in tensors))
        return real(*tensors, **kw)

    monkeypatch.setattr(tlarge, "to_host", spy)
    tm.enable()
    _detect(net, vol, "shared")
    rec = tm.take()
    (root,) = [s for s in rec["spans"] if s["name"] == "detect"]
    counters = rec["counters"][root["id"]]
    assert len(copied) == sum(s["name"] == "box.copy" for s in rec["spans"])
    assert counters["d2h_bytes"] == 8 * sum(copied)
    assert counters["h2d_bytes"] == vol.nbytes


def test_fetch_spans_fill_fetch_seconds_on_the_prefetch_thread(net, vol):
    kw = dict(core=CORE, method="both", threshold=0.5, tile_out=8,
              tile_batch=3)
    plan = tlarge.make_stream_plan(net.infer_spec, None, SHAPE, **kw)
    shape, read = tlarge.array_reader(vol)
    tm.enable()
    tlarge.detect_streaming(net.infer_spec, None, shape, read, plan=plan,
                            forward="roi", **kw)
    spans = tm.take()["spans"]
    (root,) = [s for s in spans if s["name"] == "detect"]
    reads = [s for s in spans if s["name"] == "fetch.read"]
    assert len(reads) == len(plan.grid)
    assert all(s["root"] == root["id"] and s["parent"] == root["id"]
               and s["thread"] != root["thread"] for s in reads)
    assert plan.fetch_seconds["read"] == pytest.approx(
        sum(s["host_ms"] for s in reads) / 1e3, rel=1e-9)
    assert plan.fetch_seconds["read"] > 0


def test_train_step_spans_in_order_under_the_step():
    tm.enable()
    _train(2)
    spans = tm.take()["spans"]
    steps = [s for s in spans if s["name"] == "train.step"]
    assert len(steps) == 2
    for step in steps:
        kids = sorted((s for s in spans if s["parent"] == step["id"]),
                      key=lambda s: s["start_ns"])
        assert [s["name"] for s in kids] == [
            "train.sample", "train.forward", "train.loss", "train.backward",
            "train.adam"]
        assert all(s["root"] == step["id"] for s in kids)
        for a, b in zip(kids, kids[1:]):
            assert a["end_ns"] <= b["start_ns"]
        assert step["start_ns"] <= kids[0]["start_ns"]
        assert kids[-1]["end_ns"] <= step["end_ns"]


@pytest.mark.parametrize("mode", ["shared", "roi", "streaming"])
def test_tracing_changes_no_list(net, vol, mode):
    off = _detect(net, vol, mode)
    tm.enable()
    on = _detect(net, vol, mode)
    assert tm.take()["spans"]
    _same_lists(off, on)


def test_tracing_changes_no_parameter():
    off = _train()
    tm.enable()
    on = _train()
    assert tm.take()["spans"]
    assert off.keys() == on.keys()
    assert all(torch.equal(off[k], on[k]) for k in off)


def test_traced_runs_never_synchronise(net, vol, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    tm.enable()
    _detect(net, vol, "shared")
    _detect(net, vol, "streaming")
    _train(1)
    assert tm.take()["spans"] and calls == []


def test_spans_record_under_the_profiler_as_fpl_ranges(net, vol):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _detect(net, vol, "shared")
        _train(1)
    rec = tm.take()  # recorded with the tracer itself off
    names = Counter(s["name"] for s in rec["spans"])
    ranges = Counter(e.name[4:] for e in prof.events()
                     if e.name.startswith("fpl."))
    assert names["detect"] == 1 and names["train.step"] == 1
    assert ranges == names
    # and nothing once the profiler has stopped
    _detect(net, vol, "shared")
    assert tm.take()["spans"] == []


def test_the_profilers_store_keeps_only_the_newest(monkeypatch):
    """What a profiler's stretch records and nobody takes stays bounded."""
    monkeypatch.setattr(tm, "_PROFILED", tm._Trace(limit=3))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for k in range(5):
            with tm.span(f"s{k}"):
                tm.count("n", k)
    rec = tm.take()
    kept = [s["name"] for s in rec["spans"]]
    assert kept == ["s2", "s3", "s4"]
    assert {r: c["n"] for r, c in rec["counters"].items()} == {
        s["id"]: k + 2 for k, s in enumerate(rec["spans"])}
    assert tm.take() == {"spans": [], "counters": {}}
    assert tm.PROFILED_LIMIT >= 4096  # room for a profiled stretch


def test_counters_outside_spans_and_threads_attach():
    tm.enable()
    tm.count("loose", 2)
    with tm.span("outer") as outer:
        tm.count("bytes", 5)
        tm.count("bytes", 6)
        inside = tm.current_span()
    assert inside is outer and tm.current_span() is None
    with tm.attach(outer):
        with tm.span("inner"):
            pass
    with tm.attach(None):
        pass
    rec = tm.take()
    out, inner = rec["spans"]  # in the order they ended
    assert inner["parent"] == out["id"] == inner["root"]
    assert rec["counters"] == {0: {"loose": 2}, out["id"]: {"bytes": 11}}


def test_stage_timer_opens_a_span_of_its_name():
    timer = tm.StageTimer()
    tm.enable()
    with timer.stage("infer", voxels=8):
        with tm.span("inside"):
            pass
    inner, stage = tm.take()["spans"]
    assert stage["name"] == "infer" and inner["parent"] == stage["id"]
    assert timer.report()["infer"]["calls"] == 1
