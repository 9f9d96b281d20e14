"""Metric logs and PR-curve dumps.

Counterpart of ``flypylib_tpu/utils/metrics.py``: ``MetricsLog`` (the
per-epoch records ``Trainer.fit`` writes), ``dump_pr_curve`` and
``load_pr_curve``, copied (numpy and the standard library only).
``StageTimer`` and ``profile_trace`` are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import csv
import json
import logging
import time

import numpy as np

logger = logging.getLogger("flypylib_tpu_torch")


def dump_pr_curve(curve: dict, path: str) -> None:
    """Write an obj_pr_curve dict as JSON (.json) or CSV (.csv)."""
    serializable = {
        k: (v.tolist() if isinstance(v, np.ndarray) else float(v))
        for k, v in curve.items()
    }
    if path.endswith(".csv"):
        keys = [k for k, v in serializable.items() if isinstance(v, list)]
        rows = zip(*(serializable[k] for k in keys))
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(keys)
            w.writerows(rows)
    else:
        with open(path, "w") as f:
            json.dump(serializable, f)


def load_pr_curve(path: str) -> dict:
    with open(path) as f:
        obj = json.load(f)
    return {
        k: (np.asarray(v) if isinstance(v, list) else v)
        for k, v in obj.items()
    }


class MetricsLog:
    """Append-only JSONL metrics log (per-epoch / per-volume records)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list[dict] = []

    def log(self, record: dict) -> None:
        record = dict(record, ts=time.time())
        self.records.append(record)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        logger.info("metrics %s", record)
