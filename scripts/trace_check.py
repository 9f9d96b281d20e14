"""The port's tracer on the card, cell by cell of ``gpubench``: what it costs,
whether its spans add up, what they leave unexplained, and that it changes
no result.

    python3 scripts/trace_check.py [--cells a,b] [--seed N] [--seconds S]
        [--repeats R] [--out build/trace_check.jsonl]

For each cell (default: every cell of ``BENCHMARK.json``) it sets the cell
up as the benchmark does, then

1. **cost**: ``2 R`` windows of ``S`` seconds of the cell's untraced loop,
   the tracer off and on (``enable()``, no profiler) in turns (off, on, on,
   off, ...), each window's end-to-end rate;
2. **profiled stretch**: the cell's ``trace_calls`` calls under
   ``torch.profiler`` (``gpubench.observe.Profile``), where the spans record
   by themselves: the new per-layer metrics as the benchmark reads them,
   the device's idle seconds no ``fpl.*`` range covers
   (``gpubench.portspans.idle_unspanned_s``), the idle gaps by label and by
   the innermost ``fpl.*`` range at their middle, the kernels launched
   inside each ``fpl.*`` range, each span's host time a call (and the
   first call's, which starts on an idle card), and the sums of each
   parent's child spans against the parent's stream time
   (``detect.forward`` against its tile spans, ``train.step`` against its
   parts);
3. **results**: the volume cell's lists of every call made with the tracer
   on against those of the same volume with it off, bitwise; a train
   cell's parameters, first gradient and losses after its first
   ``check_steps`` steps, set up again with the tracer on and once more
   off, bitwise.

Each cell prints one JSON line (and appends it to ``--out``), with the
card's name and power limit.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpubench import harness, observe, portspans  # noqa: E402

CHILDREN = {"detect.forward": ("forward.gather", "forward.module",
                               "forward.scatter"),
            "train.step": ("train.sample", "train.forward", "train.loss",
                           "train.backward", "train.adam")}


def make_cell(port, man, catalog, name, seed, device, traced=False):
    """The cell's ``Cell``, set up (``traced``: with the port's tracer on
    through the set-up, then off)."""
    from flypylib_tpu_torch.utils import metrics as tm

    wl = catalog.workload(name)
    cfg = catalog.config(harness.cell_entry(man, name)["config"])
    cell = harness.kind_driver(wl["kind"])(port, cfg, wl, seed, device)
    if traced:
        tm.enable()
    cell.setup(False)
    if traced:
        sync(device)
        tm.disable()
    return cell


def one_call(cell, i):
    """One call of the cell's loop, as its window makes it."""
    if hasattr(cell, "_call"):
        cell._call(i)
    else:
        cell.step(cell.state, cell.gen, cell.data)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cost(cell, seconds, repeats, device):
    """End-to-end rates of the cell's window with the tracer off and on,
    in turns; also the indices of the volume results each window made."""
    from flypylib_tpu_torch.utils import metrics as tm

    order = ["off", "on", "on", "off"] * repeats
    rates, made = defaultdict(list), defaultdict(list)
    for side in order[:2 * repeats]:
        n0 = len(getattr(cell, "results", ()))
        if side == "on":
            tm.enable()
        out = cell.window(seconds, False)
        sync(cell.device)
        if side == "on":
            tm.disable()
        rates[side] += list(out["metrics"].values())
        made[side] += range(n0, len(getattr(cell, "results", ())))
    return rates, made


def children_share(rec):
    """For each parent in :data:`CHILDREN`, its children's stream time over
    its own, summed over the stretch."""
    spans = rec["spans"]
    out = {}
    for parent, kids in CHILDREN.items():
        own = kid = 0.0
        for s in spans:
            if s["name"] == parent and s["stream_ms"] is not None:
                own += s["stream_ms"]
                kid += sum(c["stream_ms"] for c in spans
                           if c["parent"] == s["id"] and c["name"] in kids
                           and c["stream_ms"] is not None)
        if own:
            out[parent] = {"parent_ms": own, "children_ms": kid,
                           "share": kid / own}
    return out


def _innermost_fpl(e):
    while e is not None and not e.name.startswith(portspans.PREFIX):
        e = e.cpu_parent
    return e.name if e is not None else "(none)"


def kernels_by_span(events, top: int = 4) -> dict:
    """Device seconds of the kernels launched inside each ``fpl.*`` range
    (the innermost), total and by kernel name (the ``top`` largest)."""
    by = defaultdict(lambda: defaultdict(float))
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.kernels:
            span = _innermost_fpl(e)
            for k in e.kernels:
                by[span][k.name[:60]] += k.duration / 1e6
    return {span: {"total_s": sum(d.values()),
                   "top": sorted(d.items(), key=lambda kv: -kv[1])[:top]}
            for span, d in by.items()}


def idle_by_span(events) -> dict:
    """The device's idle seconds inside the window by the innermost
    ``fpl.*`` range running at each gap's middle."""
    cpu, dev, win = [], [], None
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CPU:
            if e.name == observe.WINDOW:
                win = (s, t)
            elif e.name.startswith(portspans.PREFIX):
                cpu.append((s, t, e.name))
        elif not getattr(e, "is_user_annotation", False) and \
                not e.name.startswith(("gpubench.", portspans.PREFIX)) and t > s:
            dev.append((s, t))
    starts = np.array([c[0] for c in cpu] or [0.0])
    ends = np.array([c[1] for c in cpu] or [-1.0])
    out, at = defaultdict(float), win[0]
    for s, t in sorted(dev) + [(win[1], win[1])]:
        s, t = max(s, win[0]), min(t, win[1])
        if s > at:
            mid = (at + s) / 2
            cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = cpu[cover[np.argmin(ends[cover] - starts[cover])]][2] \
                if len(cover) else "(none)"
            out[name] += (s - at) / 1e6
        at = max(at, t)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def host_ms(rec, root_name: str) -> dict:
    """Each span name's host ms a root (mean over the roots named
    ``root_name``), and the first root's alone."""
    roots = [s["id"] for s in rec["spans"] if s["name"] == root_name]
    mean, first = defaultdict(float), defaultdict(float)
    for s in rec["spans"]:
        if s["root"] in roots:
            mean[s["name"]] += s["host_ms"] / len(roots)
            if s["root"] == roots[0]:
                first[s["name"]] += s["host_ms"]
    return {"mean": dict(mean), "first": dict(first)}


def profiled(cell, man, catalog, name, device):
    """The cell's profiled stretch, as a traced run's, and what it shows."""
    from flypylib_tpu_torch.utils import metrics as tm

    prof = observe.Profile()
    prof.start()
    for i in range(cell.wl["trace_calls"]):
        one_call(cell, i)
    prof.stop()
    events = prof.prof.events()
    summary = observe.summarize(events)
    rec = tm.take()
    obs = observe.Obs(observe.Spans(), summary, {})
    obs.trace = rec
    metrics = {}
    for m in harness.per_layer_for(man, name):
        if m["source"] in ("program_span", "program_counter"):
            v = catalog.reader(m["name"])(obs)
            if v is not None:  # the outside spans are not taken here
                metrics[m["name"]] = v
    annotations = Counter()
    for e in events:
        if e.name.startswith("fpl.") and e.device_type != \
                torch.autograd.DeviceType.CPU:
            annotations[bool(getattr(e, "is_user_annotation", False))] += 1
    unspanned = portspans.idle_unspanned_s(events)
    root = "detect" if cell.wl["kind"] == "volume" else "train.step"
    return {"window_s": summary["window_s"], "busy_s": summary["busy_s"],
            "idle_pct": 100 * (1 - summary["busy_s"] / summary["window_s"]),
            "idle_unspanned_s": unspanned,
            "idle_unspanned_pct": 100 * unspanned / summary["window_s"],
            "idle_gaps": summary["breakdown"]["idle_gaps"],
            "device_fpl_events_by_annotation": {
                str(k): v for k, v in annotations.items()},
            "idle_by_span": idle_by_span(events),
            "kernels_by_span": kernels_by_span(events),
            "host_ms": host_ms(rec, root),
            "spans": dict(Counter(s["name"] for s in rec["spans"])),
            "children": children_share(rec), "metrics": metrics}


def same_lists(a, b) -> bool:
    return all(np.array_equal(x.locs, y.locs) and np.array_equal(x.conf, y.conf)
               for x, y in zip(a, b, strict=True))


def volume_results(cell, made) -> dict:
    """Every traced call's lists against an untraced call's on its volume."""
    off = {}
    for i in made["off"]:
        k, lists = cell.results[i]
        off.setdefault(k, lists)
    pairs = [same_lists(cell.results[i][1], off[cell.results[i][0]])
             for i in made["on"] if cell.results[i][0] in off]
    return {"on_calls_compared": len(pairs), "bitwise": all(pairs)}


def train_state(cell):
    return ({n: p.cpu() for n, p in cell.p3.items()},
            {n: g.cpu() for n, g in cell.g1.items()}, list(cell.losses))


def states_equal(a, b) -> bool:
    return all(all(torch.equal(x[n], y[n]) for n in x) for x, y in
               zip(a[:2], b[:2])) and a[2] == b[2]


def card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return f"{torch.cuda.get_device_name(0)} ({harness.power_limit()})"


def check_cell(port, man, catalog, name, seed, seconds, repeats,
               device="cuda") -> dict:
    t0 = time.perf_counter()
    cell = make_cell(port, man, catalog, name, seed, device)
    rates, made = cost(cell, seconds, repeats, device)
    med = {k: statistics.median(v) for k, v in rates.items()}
    line = {"cell": name, "seed": seed, "card": card(), "seconds": seconds,
            "rates": dict(rates), "median": med,
            "on_vs_off": med["on"] / med["off"] - 1}
    line["profiled"] = profiled(cell, man, catalog, name, device)
    if cell.wl["kind"] == "volume":
        line["results"] = volume_results(cell, made)
        cell.release()
    else:
        base = train_state(cell)
        cell.release()
        states = []
        for traced in (True, False):
            again = make_cell(port, man, catalog, name, seed, device, traced)
            states.append(train_state(again))
            again.release()
        line["results"] = {"on_equals_off": states_equal(states[0], base),
                           "off_equals_off": states_equal(states[1], base)}
    line["took_s"] = time.perf_counter() - t0
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=None)
    ap.add_argument("--seed", type=int, default=1700000001)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="build/trace_check.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_check: needs a CUDA card", file=sys.stderr)
        return 2
    man = harness.manifest()
    names = (args.cells.split(",") if args.cells
             else [w["name"] for w in man["workloads"]])
    port = harness.import_port()
    catalog = harness.Catalog()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for k, name in enumerate(names):
        line = check_cell(port, man, catalog, name, args.seed + k,
                          args.seconds, args.repeats)
        text = json.dumps(line, default=float)
        print(text, flush=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
