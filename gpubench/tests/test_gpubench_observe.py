"""The busy time of the card as ``observe`` reduces it, and the training
rate by the host's clock that a traced run hands its reader."""

import numpy as np
import pytest

from gpubench import harness, observe
from gpubench.observe import Obs, Spans

CAT = harness.Catalog()


@pytest.mark.parametrize("seed", range(6))
def test_union_is_the_merged_intervals(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 40))
    starts = rng.integers(0, 2000, n)
    ends = starts + rng.integers(1, 200, n)
    merged = observe._merge([[int(s), int(e)] for s, e in zip(starts, ends)])
    want = sum(e - s for s, e in merged)
    assert observe.union_ns(starts.tolist(), ends.tolist()) == want


def test_union_of_nested_and_touching_intervals():
    assert observe.union_ns([], []) == 0
    assert observe.union_ns([0, 2, 10, 5], [10, 4, 12, 6]) == 12
    assert observe.union_ns([5, 0], [10, 5]) == 10


def test_rate_reader_reads_the_host_rate():
    read = CAT.reader("rate_mvox_s.train")
    assert read(Obs(Spans(), {}, {"rate_mvox_s": 123.5})) == 123.5
    assert read(Obs(Spans(), {}, {"rate_mvox_s": None})) is None
    assert read(Obs(Spans(), {}, {})) is None


def test_device_rate_cell_names_its_stretches():
    """A cell whose rate is over the card's busy time profiles the window
    in stretches, and its traced runs time a stretch by the host's clock."""
    man = harness.manifest()
    for w in man["workloads"]:
        wl = CAT.workload(w["name"])
        if "device_rate_metric" not in wl:
            continue
        assert 0 < wl["stretch_seconds"] <= 5
        assert 0 < wl["rate_seconds"] < man["run_seconds"]
        e2e = {m["name"]: m for m in harness.end_to_end_for(man, w["name"])}
        assert e2e[wl["device_rate_metric"]]["source"] == "device_trace"
