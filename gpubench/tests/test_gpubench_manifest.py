"""BENCHMARK.json against the benchmark contract's form, the files it names,
and the discovery of configurations, cells and metrics by name."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_form():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "gpubench/run.py"]
    assert MAN["paths"] == ["gpubench"]
    assert all(PATH.match(p) for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    # a full check with 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["why"]) and line_ok(c["source"])
        assert c["file"].startswith("gpubench/") and PATH.match(c["file"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        names.append(w["name"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"])
        names.append(m["name"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(names) == len(set(names))


def test_cells_report_what_they_move():
    cells = [w["name"] for w in MAN["workloads"]]
    assert cells == ["baseline.volume_1k", "baseline.train_b32",
                     "baseline.train_b128"]
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "workloads" not in e2e["setup_s"] and e2e["setup_s"]["bound"] <= 0.25
    for cell in cells:
        reported = {m["name"] for m in harness.end_to_end_for(MAN, cell)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.per_layer_for(MAN, cell)
        assert layer
        for m in layer:
            assert m["moves"] in reported
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", ()):
            assert cell in cells
    layers = {}
    for m in MAN["per_layer"]:  # one layer, one name, letter for letter
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_files_named_exist():
    cat = harness.Catalog()
    for c in MAN["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in MAN["workloads"]:
        wl = cat.workload(w["name"])
        assert (harness.BENCH_DIR / "kinds" / f"{wl['kind']}.py").is_file()
        assert set(wl["limits"])
    for m in MAN["per_layer"]:
        assert callable(cat.reader(m["name"]))
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


def test_discovery_of_dropped_in_files(tmp_path):
    """A configuration, a cell and a metric added as files are found by
    name, and a run of the cell reports the metric, with no edit to any
    file that is already there."""
    for folder in ("configs", "workloads", "metrics"):
        (tmp_path / folder).mkdir()
    (tmp_path / "configs" / "dummy.json").write_text(json.dumps({"name": "dummy"}))
    (tmp_path / "workloads" / "dummy.cell.json").write_text(json.dumps(
        {"kind": "volume", "limits": {"gap": 0.5}}))
    (tmp_path / "metrics" / "dummy_ms.cell.py").write_text(
        "def read(obs):\n    return obs.spans.mean_ms('part')\n")
    cat = harness.Catalog(tmp_path)
    assert cat.names("configs") == ["dummy"]
    assert cat.names("workloads") == ["dummy.cell"]
    assert cat.names("metrics") == ["dummy_ms.cell"]
    man = {"workloads": [{"name": "dummy.cell", "config": "dummy",
                          "traffic": "cell", "chips": 1, "why": "a test"}],
           "end_to_end": [{"name": "setup_s", "unit": "s"},
                          {"name": "rate", "unit": "Mvox/s",
                           "workloads": ["dummy.cell"]}],
           "per_layer": [{"name": "dummy_ms.cell", "unit": "ms",
                          "moves": "rate", "workloads": ["dummy.cell"]}]}

    class Dummy:
        def __init__(self, port, cfg, wl, seed, device):
            assert cfg["name"] == "dummy" and wl["kind"] == "volume"

        def setup(self, trace):
            pass

        def window(self, seconds, trace):
            from gpubench.observe import Obs, Spans

            spans = Spans()
            spans.add("part", 0.25)
            prof = {"busy_s": 1.0, "window_s": 2.0,
                    "breakdown": {"device_ops": [], "idle_gaps": []}}
            return {"obs": Obs(spans, prof, {}), "metrics": {"rate": 3.0},
                    "attempted": 1}

        def release(self):
            pass

        def check(self):
            return {"gap": 0.25}, 0

    for trace in (False, True):
        line, checks = harness.run_cell(None, man, "dummy.cell", 1, 0.0, trace,
                                        device="cpu", catalog=cat,
                                        cell_cls=Dummy)
        assert line["correct"] and checks == {"gap": {"value": 0.25, "limit": 0.5}}
        assert list(line)[-1] == "checks"
        if trace:
            assert line["metrics"] == {"dummy_ms.cell": {"value": 250.0,
                                                         "unit": "ms"}}
        else:
            assert set(line["metrics"]) == {"setup_s", "rate"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(harness.BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    harness.BENCH_DIR)))
def test_no_module_imports_jax(path):
    """Top-level names compared whole: flypylib_tpu_torch is the port."""
    assert not imported_tops(path) & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    ref = harness.BENCH_DIR / "reference.py"
    assert imported_tops(ref) <= {"__future__", "contextlib", "numpy", "torch",
                                  "scipy"}
    code = ("import sys; sys.path.insert(0, %r); import gpubench.reference, "
            "gpubench.compare; bad = sorted({m.split('.')[0] for m in "
            "sys.modules} & {'flypylib_tpu_torch', 'flypylib_tpu', 'jax'}); "
            "print(bad)" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "flypylib_tpu_torch_fake", object())
    assert "flypylib_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert "flax" in harness.forbidden_modules()
