"""Observability: stage timing, metric logs, PR-curve dumps and plots, a
profiler trace.

Counterpart of ``flypylib_tpu/utils/metrics.py``.  ``StageTimer``,
``MetricsLog``, ``dump_pr_curve``, ``load_pr_curve`` and ``plot_pr_curve``
are copies (numpy and the standard library; ``plot_pr_curve`` imports
matplotlib inside).  ``profile_trace`` is the ``torch.profiler`` counterpart
of the reference's ``jax.profiler`` trace: a Chrome trace file.

``StageTimer`` reads the host clock, as the reference's: work queued on a
card is timed only if the caller synchronises inside the stage
(``torch.cuda.synchronize()``).
"""

from __future__ import annotations

import contextlib
import csv
import json
import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

logger = logging.getLogger("flypylib_tpu_torch")


@dataclass
class StageTimer:
    """Accumulates per-stage wall clock + voxel counts -> Mvox/s."""

    stages: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, voxels: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self.stages.setdefault(
                name, {"seconds": 0.0, "voxels": 0, "calls": 0}
            )
            s["seconds"] += dt
            s["voxels"] += voxels
            s["calls"] += 1

    def report(self) -> dict:
        out = {}
        for name, s in self.stages.items():
            r = dict(s)
            if s["voxels"] and s["seconds"]:
                r["mvox_per_s"] = round(s["voxels"] / s["seconds"] / 1e6, 3)
            out[name] = r
        return out

    def log(self, level=logging.INFO):
        for name, r in self.report().items():
            logger.log(level, "stage %-20s %s", name, r)


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


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` over the block (the host, and the card when CUDA
    is available); on exit the Chrome trace is written to
    ``log_dir/trace.json`` (``chrome://tracing`` or Perfetto reads it).
    Yields the profiler, whose ``key_averages()`` sums time by op."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def plot_pr_curve(curves, path: str, title: str = "precision-recall"):
    """Render one or more PR curves to an image file.

    ``curves``: a single obj_pr_curve dict or ``{label: curve}`` mapping.
    Uses matplotlib if available; raises ImportError otherwise.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(curves, dict) and "precision" in curves:
        curves = {"detections": curves}
    fig, ax = plt.subplots(figsize=(5, 4))
    for label, c in curves.items():
        ax.plot(c["recall"], c["precision"], marker=".", markersize=3,
                linewidth=1, label=str(label))
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_xlim(0, 1.02)
    ax.set_ylim(0, 1.02)
    ax.grid(True, alpha=0.3)
    ax.legend(loc="lower left", fontsize=8)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
