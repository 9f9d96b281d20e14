"""The port's queue and I/O layer (``io/dvid.py``, ``io/hdf5.py``,
``infer/roi_queue.py``, ``infer/elastic.py``): the cases of
``tests/test_dvid.py``, ``tests/test_roi_queue.py`` and
``tests/test_elastic.py`` on the port's copies, and the copies against the
originals (``read_h5`` / ``write_h5`` and ``grid_rois`` equal, and
``stream_rois`` through the port's ``DetectPipeline`` equal to JAX's
``stream_rois`` through JAX's on the same weights).

Every server is an in-process mock on 127.0.0.1.  Tolerances: lists across
packages have equal locations and confidences within 1e-5 (the f32 maps
differ by summation order, tests/test_torch_pipeline.py); everything else
is exact.  Elastic workers are threads with explicit ids; leases are a
second or more where a live worker must keep its claim.
"""

import json
import threading
import time
import urllib.error
from http.server import HTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flypylib_tpu.infer import pipeline as jpipe
from flypylib_tpu.infer import roi_queue as jrq
from flypylib_tpu.models import zoo as jzoo
from flypylib_tpu_torch.infer import (ROI, DetectPipeline, ROIQueue,
                                      dvid_sink, dvid_source, grid_rois,
                                      stream_rois)
from flypylib_tpu_torch.infer.elastic import (SharedROIQueue,
                                              default_worker_id,
                                              stream_rois_elastic)
from flypylib_tpu_torch.infer.large import (array_reader, detect_streaming,
                                            dvid_reader)
from flypylib_tpu_torch.io import DVIDClient, Tbars, read_h5, write_h5
from flypylib_tpu_torch.models import zoo as tzoo
from flypylib_tpu_torch.ops.host_reference import nms_host
from tests.conftest import make_blob_volume
from tests.test_dvid import FlakyDVID, GzipDVID, MockDVID, StatefulDVID
from tests.test_torch_detect import assert_same_list

torch.set_num_threads(1)


def _serve(handler):
    srv = HTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"127.0.0.1:{srv.server_port}"


@pytest.fixture
def mock_server():
    MockDVID.volume = np.random.default_rng(0).integers(
        0, 256, (16, 20, 24)).astype(np.uint8)
    MockDVID.posted = []
    srv, addr = _serve(MockDVID)
    yield addr, MockDVID
    srv.shutdown()


# -- DVIDClient (tests/test_dvid.py's cases) --------------------------------
def test_get_gray3d(mock_server):
    addr, mock = mock_server
    cut = DVIDClient(addr, "abc123").get_gray3d(
        "grayscale", size=(8, 10, 12), offset=(2, 3, 4))
    assert cut.shape == (8, 10, 12) and cut.dtype == np.uint8
    np.testing.assert_array_equal(cut, mock.volume[2:10, 3:13, 4:16])


def test_get_annotations(mock_server):
    addr, _ = mock_server
    tb = DVIDClient(addr, "abc123").get_annotations(
        "synapses", size=(16, 20, 24), offset=(0, 0, 0))
    assert isinstance(tb, Tbars) and len(tb) == 1
    np.testing.assert_array_equal(tb.locs[0], [1, 2, 3])  # zyx of Pos [3,2,1]
    assert tb.conf[0] == 0.75


def test_post_annotations(mock_server):
    addr, mock = mock_server
    DVIDClient(addr, "abc123").post_annotations(
        "synapses", Tbars(locs=[[5, 6, 7]], conf=[0.5]))
    assert len(mock.posted) == 1
    el = mock.posted[0][0]
    assert el["Kind"] == "PreSyn" and el["Pos"] == [7, 6, 5]


def test_post_annotations_partner_roundtrip():
    StatefulDVID.elements = []
    srv, addr = _serve(StatefulDVID)
    try:
        client = DVIDClient(addr, "abc123")
        tb = Tbars(locs=[[5, 6, 7], [9, 9, 9]], conf=[0.5, 0.75],
                   partners=[[[5, 6, 10], [8, 6, 7]], np.zeros((0, 3))])
        client.post_annotations("synapses", tb)
        back = client.get_annotations("synapses", size=(16, 16, 16),
                                      offset=(0, 0, 0))
        np.testing.assert_array_equal(back.locs, tb.locs)
        np.testing.assert_allclose(back.conf, tb.conf)
        np.testing.assert_array_equal(back.partners[0], tb.partners[0])
        assert back.partners[1].shape == (0, 3)
    finally:
        srv.shutdown()


def test_retry_on_transient_5xx():
    FlakyDVID.volume = np.random.default_rng(1).integers(
        0, 256, (8, 8, 8)).astype(np.uint8)
    FlakyDVID.posted, FlakyDVID.failures = [], [2]
    srv, addr = _serve(FlakyDVID)
    try:
        client = DVIDClient(addr, "abc123", retries=3, backoff=0.01)
        cut = client.get_gray3d("grayscale", size=(4, 4, 4), offset=(0, 0, 0))
        np.testing.assert_array_equal(cut, FlakyDVID.volume[:4, :4, :4])
        assert FlakyDVID.failures == [0]
        # too few retries: the transient errors exhaust them
        FlakyDVID.failures = [3]
        with pytest.raises(IOError, match="after 2 attempts"):
            DVIDClient(addr, "abc123", retries=1, backoff=0.01).get_gray3d(
                "grayscale", size=(4, 4, 4), offset=(0, 0, 0))
    finally:
        srv.shutdown()


def test_no_retry_on_permanent_404(mock_server):
    addr, _ = mock_server
    client = DVIDClient(addr, "abc123", retries=3, backoff=0.01)
    with pytest.raises(urllib.error.HTTPError):
        client._get(client._url("nope", "bogus/endpoint"))


def test_gzip_transfer():
    srv, addr = _serve(GzipDVID)
    try:
        tb = DVIDClient(addr, "abc123").get_annotations(
            "synapses", size=(8, 8, 8), offset=(0, 0, 0))
        assert len(tb) == 1 and tb.conf[0] == 0.5
    finally:
        srv.shutdown()


def test_dvid_reader_streaming_detection(mock_server):
    """detect_streaming straight from a DVID node (dvid_reader) == the same
    detection on the in-RAM array."""
    addr, mock = mock_server
    spec = tzoo.baseline_model(features=(4,), dilations=(1,),
                               head_features=8, dtype=torch.float32)
    client = DVIDClient(addr, "abc123")
    shape, read = dvid_reader(client, "grayscale", mock.volume.shape)
    common = dict(core=8, tile_out=8, window=3, threshold=0.6)
    got = detect_streaming(spec, None, shape, read, **common)
    ashape, aread = array_reader(mock.volume)
    want = detect_streaming(spec, None, ashape, aread, **common)
    assert_same_list(got, want)
    shape2, read2 = dvid_reader(client, "grayscale", (8, 10, 12),
                                offset=(2, 3, 4))
    np.testing.assert_array_equal(read2((0, 0, 0), shape2),
                                  mock.volume[2:10, 3:13, 4:16])


# -- ROIQueue / stream_rois (tests/test_roi_queue.py's cases) ---------------
def fake_pipeline(vol):
    return nms_host(vol.astype(np.float32), window=3, threshold=0.5), None


def _source_of(vol):
    def source(roi):
        return vol[tuple(slice(o, o + s) for o, s in zip(roi.offset, roi.size))]

    return source


def test_grid_rois_cover():
    covered = np.zeros((40, 40, 40), dtype=bool)
    for r in grid_rois((40, 40, 40), 16):
        covered[tuple(slice(o, o + s) for o, s in zip(r.offset, r.size))] = True
    assert covered.all()


def test_stream_and_resume(tmp_path):
    vol = np.random.default_rng(0).random((32, 16, 16)).astype(np.float32)
    rois = grid_rois(vol.shape, (16, 16, 16))
    assert len(rois) == 2
    state = str(tmp_path / "state.json")
    calls = []
    res = stream_rois(fake_pipeline, rois, _source_of(vol), state_path=state,
                      progress=lambda r, i: calls.append(r.key))
    assert len(res) == 2 and len(calls) == 2
    assert stream_rois(fake_pipeline, rois, _source_of(vol),
                       state_path=state) == {}
    q = ROIQueue(rois, state)
    q.state[rois[0].key]["status"] = "pending"
    q._persist()
    res3 = stream_rois(fake_pipeline, rois, _source_of(vol), state_path=state)
    assert list(res3) == [rois[0].key]


def test_fetch_error_surfaces():
    def bad_source(roi):
        raise IOError("boom")

    with pytest.raises(RuntimeError, match="fetch failed"):
        stream_rois(fake_pipeline, [ROI(offset=(0, 0, 0), size=(4, 4, 4))],
                    bad_source)


def test_sink_receives_global_coords():
    vol = np.zeros((8, 8, 8), dtype=np.float32)
    vol[2, 3, 4] = 0.9
    got = []

    class FakeClient:
        def post_annotations(self, instance, tbars):
            got.append((instance, tbars))

    stream_rois(fake_pipeline, [ROI(offset=(100, 200, 300), size=(8, 8, 8))],
                lambda r: vol, sink=dvid_sink(FakeClient(), "syn"))
    assert len(got) == 1 and got[0][0] == "syn"
    np.testing.assert_array_equal(got[0][1].locs[0], [102, 203, 304])


def test_grid_rois_ownership_partition():
    owned = np.zeros((100, 64, 70), dtype=np.int32)
    for r in grid_rois((100, 64, 70), 64):
        lo, hi = r.owned()
        owned[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] += 1
    assert (owned == 1).all()


def test_stream_rois_no_duplicates_in_overlap():
    vol = np.zeros((100, 16, 16), dtype=np.float32)
    vol[50, 8, 8] = 0.9  # inside both z ROIs' fetch boxes
    vol[10, 4, 4] = 0.8
    vol[90, 4, 4] = 0.7
    rois = grid_rois(vol.shape, (64, 16, 16))
    assert len(rois) == 2
    res = stream_rois(fake_pipeline, rois, _source_of(vol))
    assert sum(len(v) for v in res.values()) == 3


# -- the copies against the originals ---------------------------------------
@pytest.mark.parametrize("args", [
    ((40, 40, 40), 16, (0, 0, 0)),
    ((100, 64, 70), 64, (5, 0, 7)),
    ((512, 512, 512), 256, (0, 0, 0)),
    ((33, 20, 17), (16, 20, 8), (1, 2, 3)),
])
def test_grid_rois_equal_the_reference(args):
    assert [vars(r) for r in grid_rois(*args)] == \
        [vars(r) for r in jrq.grid_rois(*args)]


def test_hdf5_equals_the_reference(tmp_path):
    pytest.importorskip("h5py")
    from flypylib_tpu.io import hdf5 as jh5

    vol = np.random.default_rng(2).integers(0, 256, (20, 33, 70)).astype(np.uint8)
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    write_h5(ours, vol)
    jh5.write_h5(theirs, vol)
    for path in (ours, theirs):
        for read in (read_h5, jh5.read_h5):
            np.testing.assert_array_equal(read(path), vol)
            roi = ((2, 9), slice(5, 30), (60, 70))
            np.testing.assert_array_equal(read(path, roi=roi),
                                          vol[2:9, 5:30, 60:70])
    import h5py

    with h5py.File(ours) as a, h5py.File(theirs) as b:
        assert a["main"].chunks == b["main"].chunks == (20, 33, 64)
        assert a["main"].compression == b["main"].compression == "gzip"
    prob = np.random.default_rng(3).random((5, 6, 7)).astype(np.float32)
    write_h5(ours, prob, dataset="prob", compression=None)
    np.testing.assert_array_equal(jh5.read_h5(ours), prob)


def test_stream_rois_through_detect_pipeline_equals_jax(tmp_path):
    """The port's small f32 ``DetectPipeline`` through ``stream_rois`` with
    ``dvid_source`` / ``dvid_sink`` on a mock DVID server, against JAX's
    ``stream_rois`` through JAX's pipeline on the same weights and ROIs:
    the same lists ROI by ROI, and the sink got exactly the port's lists
    in global coordinates."""
    shape = (36, 28, 28)
    vol, _ = make_blob_volume(shape, centers=[(6, 6, 6), (20, 14, 20),
                                              (30, 22, 8), (12, 24, 16)],
                              sigma=2.5)
    MockDVID.volume = (vol * 255).astype(np.uint8)
    MockDVID.posted = []
    srv, addr = _serve(MockDVID)
    try:
        small = dict(features=(4, 6), dilations=(1, 2), head_features=8)
        jspec = jzoo.baseline_model(dtype=jnp.float32, **small)
        jv = jspec.init(jax.random.PRNGKey(0), 16)
        jv = jax.tree_util.tree_map(np.asarray, jv)
        tspec = tzoo.baseline_model(dtype=torch.float32, **small)
        tspec.module.load_state_dict(tzoo.params_from_flax(jv))
        rois = grid_rois(shape, (20, 16, 16))
        assert len(rois) == 8
        roi_shape = rois[0].size
        kw = dict(tile_out=8, tile_batch=2, window=3, threshold=0.4)
        client = DVIDClient(addr, "abc123")
        src = dvid_source(client, "grayscale")
        state = str(tmp_path / "state.json")
        got = stream_rois(DetectPipeline(tspec, None, roi_shape, **kw), rois,
                          src, sink=dvid_sink(client, "synapses"),
                          state_path=state)
        want = jrq.stream_rois(jpipe.DetectPipeline(jspec, jv, roi_shape, **kw),
                               rois, src)
        assert list(got) == list(want) == [r.key for r in rois]
        for key in got:
            assert len(got[key]) == len(want[key])
            np.testing.assert_array_equal(got[key].locs, want[key].locs)
            np.testing.assert_allclose(got[key].conf, want[key].conf,
                                       rtol=0, atol=1e-5)
        assert sum(len(t) for t in got.values()) > 4
        posted = [el for batch in MockDVID.posted for el in batch]
        glob = np.concatenate([got[r.key].locs + np.asarray(r.offset)
                               for r in rois])
        assert sorted(tuple(el["Pos"][::-1]) for el in posted) == \
            sorted(map(tuple, glob.astype(int).tolist()))
        with open(state) as f:
            assert all(s["status"] == "done" for s in json.load(f).values())
    finally:
        srv.shutdown()


# -- SharedROIQueue / stream_rois_elastic (tests/test_elastic.py's cases) ---
def elastic_pipeline(counter=None, crash_after=None, sleep=0.0):
    """(volume) -> (Tbars, None): one detection at the block centre;
    counts calls, raises after ``crash_after`` of them, sleeps ``sleep``."""
    lock = threading.Lock()

    def run(vol):
        if counter is not None:
            with lock:
                counter[0] += 1
                if crash_after is not None and counter[0] > crash_after:
                    raise RuntimeError("worker died")
        time.sleep(sleep)
        c = [s // 2 for s in vol.shape]
        return Tbars(locs=np.asarray([c], np.float64),
                     conf=np.asarray([float(vol.max())])), None

    return run


def _elastic_source(size):
    return _source_of(np.random.default_rng(0).random(
        (size, size, size)).astype(np.float32))


def _workers(fn, n=2, timeout=60):
    results = {}

    def run(i):
        results[i] = fn(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)
    return results


def test_two_workers_disjoint_exactly_once(tmp_path):
    rois = grid_rois(64, 16)  # 64 ROIs
    source = _elastic_source(64)
    state = str(tmp_path / "q")
    counters = [[0], [0]]
    results = _workers(lambda i: stream_rois_elastic(
        elastic_pipeline(counters[i]), rois, source, state_dir=state,
        worker_id=f"w{i}", n_workers_hint=2))
    keys0, keys1 = set(results[0]), set(results[1])
    assert keys0.isdisjoint(keys1) and len(keys0 | keys1) == len(rois)
    assert counters[0][0] + counters[1][0] == len(rois)
    assert len(SharedROIQueue(state, worker_id="check").summary()) == len(rois)


def test_crash_recovery_lease_steal(tmp_path):
    rois = grid_rois(48, 16)  # 27 ROIs
    source = _elastic_source(48)
    state = str(tmp_path / "q")
    counter = [0]
    with pytest.raises(RuntimeError, match="died"):
        stream_rois_elastic(elastic_pipeline(counter, crash_after=5), rois,
                            source, state_dir=state, worker_id="wA",
                            n_workers_hint=1)
    q = SharedROIQueue(state, worker_id="check")
    done = set(q.summary())
    assert len(done) == 5
    # a live lease of wA is respected by wB; an expired one is stolen
    res = stream_rois_elastic(elastic_pipeline(), rois, source,
                              state_dir=state, worker_id="wB", lease_s=60.0,
                              n_workers_hint=1)
    assert len(res) == len(rois) - 6 and done.isdisjoint(res)
    res = stream_rois_elastic(elastic_pipeline(), rois, source,
                              state_dir=state, worker_id="wC", lease_s=0.0,
                              n_workers_hint=1)
    assert len(res) == 1  # wA's orphaned ROI
    assert len(q.summary()) == len(rois)


def test_resume_skips_done(tmp_path):
    rois = grid_rois(32, 16)  # 8 ROIs
    source = _elastic_source(32)
    state = str(tmp_path / "q")
    first = stream_rois_elastic(elastic_pipeline(), rois, source,
                                state_dir=state, worker_id="w0",
                                n_workers_hint=1)
    assert len(first) == len(rois)
    assert stream_rois_elastic(elastic_pipeline(), rois, source,
                               state_dir=state, worker_id="w0",
                               n_workers_hint=1) == {}


def test_ownership_filtering(tmp_path):
    rois = grid_rois(24, 16)  # overlapping edge ROIs, owned boxes disjoint

    def pipe(vol):
        locs = np.asarray([[0, 0, 0], [15, 15, 15], [8, 8, 8]], np.float64)
        return Tbars(locs=locs, conf=np.asarray([0.5, 0.6, 0.7])), None

    res = stream_rois_elastic(pipe, rois, _elastic_source(24),
                              state_dir=str(tmp_path / "q"), worker_id="w0",
                              n_workers_hint=1)
    total = [tuple(loc) for roi in rois
             for loc in res[roi.key].locs + np.asarray(roi.offset, np.float64)]
    assert len(total) == len(set(total))


def test_heartbeat_prevents_steal_of_live_worker(tmp_path):
    """A live worker processing an ROI for 2.5 leases (of 1 s) keeps its
    claim through the heartbeat: no steal, no duplicate work."""
    rois = grid_rois((32, 32, 16), 16)  # 4 ROIs
    source = _elastic_source(32)
    state = str(tmp_path / "q")
    counters = [[0], [0]]
    results = _workers(lambda i: stream_rois_elastic(
        elastic_pipeline(counters[i], sleep=2.5), rois, source,
        state_dir=state, worker_id=f"w{i}", lease_s=1.0, n_workers_hint=2))
    assert counters[0][0] + counters[1][0] == len(rois)
    assert set(results[0]).isdisjoint(set(results[1]))
    assert len(set(results[0]) | set(results[1])) == len(rois)
    assert default_worker_id().startswith("pid")  # no process group here
