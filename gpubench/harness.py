"""The harness: finds a cell's files by name, runs it, prints its line.

Everything that belongs to one configuration, cell or per-layer metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration as it is run; its ``arch``
  names the module ``archs/<arch>.py`` that holds the architecture's
  reference forward, weight layout and operation counts;
- ``workloads/<cell>.json``: the cell's traffic (its ``kind`` names the
  general driver in ``kinds/<kind>.py`` that reads it) and the limits its
  check holds the numbers to;
- ``metrics/<metric>.py``: a reader ``read(obs)`` of one per-layer metric,
  returning a number or None when it finds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

from gpubench import compare

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that may not be loaded by a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "flypylib_tpu")


class Catalog:
    """The benchmark's files under ``root`` (by default this directory)."""

    def __init__(self, root: Path = BENCH_DIR):
        self.root = Path(root)

    def config(self, name: str) -> dict:
        return json.loads((self.root / "configs" / f"{name}.json").read_text())

    def workload(self, name: str) -> dict:
        return json.loads((self.root / "workloads" / f"{name}.json").read_text())

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.root / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"gpubench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def names(self, folder: str) -> list[str]:
        """The names of the files in ``folder``, without their suffix."""
        suffix = ".py" if folder == "metrics" else ".json"
        return sorted(p.name[:-len(suffix)]
                      for p in (self.root / folder).glob(f"*{suffix}"))


def manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell_entry(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def end_to_end_for(man: dict, cell: str) -> list[dict]:
    """The end-to-end metrics ``cell`` reports."""
    return [m for m in man["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_for(man: dict, cell: str) -> list[dict]:
    """The per-layer metrics ``cell`` reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(man, cell)}
    return [m for m in man["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e)]


def kind_driver(kind: str):
    """``kinds/<kind>.py``'s ``Cell`` class."""
    return importlib.import_module(f"gpubench.kinds.{kind}").Cell


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def import_port():
    """``flypylib_tpu_torch`` from this checkout, and only from it."""
    if str(ROOT) not in sys.path[:1]:
        sys.path.insert(0, str(ROOT))
    import flypylib_tpu_torch

    where = Path(flypylib_tpu_torch.__file__).resolve().parent.parent
    if where != ROOT:
        raise RuntimeError(f"flypylib_tpu_torch imported from {where}, not "
                           f"from the checkout {ROOT}")
    return flypylib_tpu_torch


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0].strip() if out.strip() else "unknown"


def device_info(device, chips: int, peak: int) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(peak),
            "power_limit": power_limit()}


def run_cell(port, man: dict, name: str, seed: int, seconds: float,
             trace: bool, device="cuda", t0: float | None = None,
             catalog: Catalog | None = None, cell_cls=None):
    """Run cell ``name`` once: set-up, the window, the check.  Returns
    ``(result line, checks)``.  ``cell_cls`` replaces the kind's driver
    (a test's)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    catalog = catalog or Catalog()
    entry = cell_entry(man, name)
    wl = catalog.workload(name)
    cfg = catalog.config(entry["config"])
    cls = cell_cls or kind_driver(wl["kind"])
    cell = cls(port, cfg, wl, seed, device)
    cell.setup(trace)
    setup_s = time.perf_counter() - t0
    cuda = torch.device(device).type == "cuda"
    out = cell.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    cell.release()
    numbers, failed = cell.check()
    checks = compare.judge(numbers, wl["limits"])
    correct = compare.passed(checks) and failed == 0
    if trace:
        metrics = {}
        for m in per_layer_for(man, name):
            v = catalog.reader(m["name"])(out["obs"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **out["metrics"]}
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in end_to_end_for(man, name)}
    device_d = device_info(device, entry["chips"], peak)
    line = {"correct": bool(correct), "attempted": int(out["attempted"]),
            "failed": int(failed), "metrics": metrics, "device": device_d}
    if trace:
        prof = out["obs"].profile
        device_d["busy_s"] = prof["busy_s"]
        device_d["window_s"] = prof["window_s"]
        line["breakdown"] = prof["breakdown"]
    line["checks"] = checks
    return line, checks
