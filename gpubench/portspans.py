"""The port's own spans and counters, as the per-layer readers see them.

The port's tracer (``flypylib_tpu_torch.utils.metrics``) records whenever a
``torch.profiler`` records, so a traced run's profiled stretch leaves the
port's spans in the port, and only that stretch's: the rest of the window
runs without the profiler.  :func:`records` takes them once, after the
stretch has ended (``observe.Profile.stop`` synchronises, so their CUDA
events are complete), and keeps them on the ``Obs`` for every reader of the
run.  A port without the tracer gives None, and so does every reader.

Each span record holds ``name``, ``id``, ``parent``, ``root``, ``thread``,
``start_ns`` / ``end_ns`` and ``host_ms`` (the host clock) and
``stream_ms`` (the elapsed time between the span's CUDA events on its
stream, None without events); counters are summed per root id.

:func:`idle_unspanned_s` reduces a profiler's events to the device's idle
seconds that no ``fpl.*`` range covers.
"""

from __future__ import annotations

import importlib

PREFIX = "fpl."


def records(obs) -> dict | None:
    """The port's records of the profiled stretch: ``obs.trace`` when the
    run carries them, else taken from the port once (and kept there)."""
    rec = getattr(obs, "trace", None)
    if rec is None:
        try:
            tracer = importlib.import_module("flypylib_tpu_torch.utils.metrics")
        except ImportError:
            return None
        take = getattr(tracer, "take", None)
        if take is None:  # a port without the tracer
            return None
        rec = obs.trace = take()
    return rec


def _roots(rec: dict, root: str) -> set:
    return {s["id"] for s in rec["spans"] if s["name"] == root}


def per_root_ms(obs, root: str, names, clock: str = "stream_ms"):
    """The ``clock`` milliseconds (``stream_ms`` or ``host_ms``) of the spans
    named in ``names`` under the roots named ``root``, summed, over the
    number of those roots: a mean a call or a step.  None when the roots,
    the spans or their clock are missing."""
    rec = records(obs)
    roots = _roots(rec, root) if rec else set()
    if not roots:
        return None
    vals = [s[clock] for s in rec["spans"]
            if s["root"] in roots and s["name"] in names]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(roots)


def first_root_ms(obs, root: str, clock: str = "host_ms"):
    """The ``clock`` milliseconds of the first span named ``root`` (the
    earliest to start) of the stretch; None without one or its clock."""
    rec = records(obs)
    roots = [s for s in rec["spans"] if s["name"] == root] if rec else []
    if not roots:
        return None
    return min(roots, key=lambda s: s["start_ns"])[clock]


def per_root_count(obs, root: str, name: str):
    """Counter ``name`` summed over the roots named ``root``, over their
    number; None without the roots or the counter."""
    rec = records(obs)
    roots = _roots(rec, root) if rec else set()
    if not roots:
        return None
    vals = [c[name] for r, c in rec["counters"].items()
            if r in roots and name in c]
    return sum(vals) / len(roots) if vals else None


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_unspanned_s(events, window: str = "gpubench.window") -> float:
    """The device's idle seconds inside the ``window`` range that no
    ``fpl.*`` host range covers, from ``torch.profiler``'s events (times in
    microseconds).  Device activity is counted as ``observe.summarize``
    counts it: every device event that is no annotation."""
    from torch.autograd import DeviceType

    win, dev, spans = None, [], []
    for e in events:
        name, s, t = e.name, e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            if name == window:
                win = (s, t)
            elif name.startswith(PREFIX):
                spans.append([s, t])
        elif not getattr(e, "is_user_annotation", False) and \
                not name.startswith(("gpubench.", PREFIX)) and t > s:
            dev.append([s, t])
    if win is None:
        raise RuntimeError(f"no {window} range in the trace")
    w0, w1 = win
    busy = _merge([[max(s, w0), min(t, w1)] for s, t in dev
                   if t > w0 and s < w1])
    gaps, at = [], w0
    for s, t in busy:
        if s > at:
            gaps.append([at, s])
        at = max(at, t)
    if w1 > at:
        gaps.append([at, w1])
    idle = sum(t - s for s, t in gaps)
    return (idle - _overlap(gaps, _merge(spans))) / 1e6
