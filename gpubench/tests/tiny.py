"""Tiny copies of the benchmark's cells, for runs on the CPU in the tests:
the same kinds, configurations and limits at sizes a test run can hold."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from gpubench import harness

TINY = {
    "baseline.volume_1k": {"size": 40, "blobs": 4, "pool": 2, "probe": 24,
                           "quantile": 0.99, "warmup": 1, "trace_calls": 1},
    "baseline.train_b32": {"volume": 40, "warmup": 3, "trace_calls": 1,
                           "train": {"batch_size": 4}},
    "baseline.train_b128": {"volume": 40, "warmup": 3, "trace_calls": 1,
                            "train": {"batch_size": 4}},
}


def tiny_catalog(dest: Path) -> harness.Catalog:
    """A copy of the benchmark's files under ``dest`` with every cell's
    workload cut to its :data:`TINY` size (limits kept)."""
    src = harness.BENCH_DIR
    for folder in ("configs", "metrics"):
        shutil.copytree(src / folder, dest / folder)
    (dest / "workloads").mkdir()
    cat = harness.Catalog(src)
    for name, cut in TINY.items():
        wl = cat.workload(name)
        for k, v in cut.items():
            wl[k] = {**wl[k], **v} if isinstance(v, dict) else v
        (dest / "workloads" / f"{name}.json").write_text(json.dumps(wl))
    return harness.Catalog(dest)
