"""What a traced run records, from the benchmark's own side of the calls.

- :class:`Spans`: named durations (seconds) of host-clock spans, each ended
  by a synchronise where it times device work, and of CUDA-event pairs.
- :class:`ForwardHooks`: forward pre- and post-hooks on the module the
  program runs: a CUDA event pair per module call, the host time at each
  pre-hook, and a ``gpubench.forward`` profiler range around the call.
- :class:`Profile`: ``torch.profiler`` over a stretch of the window, kept in
  memory (no trace file), reduced by :func:`summarize` to the device's busy
  time, the device time of kernels launched inside each named range, the
  device operations that took most time, and the device's idle gaps by
  what the host was doing.
- :class:`DeviceBusy`: the card's busy seconds over stretches of an
  untraced window, for a rate over the card's busy time.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType

WINDOW = "gpubench.window"
FORWARD = "gpubench.forward"


class Spans:
    """Named lists of durations in seconds."""

    def __init__(self):
        self.values = defaultdict(list)

    def add(self, name: str, seconds: float) -> None:
        self.values[name].append(float(seconds))

    def mean_ms(self, name: str) -> float | None:
        v = self.values.get(name)
        return 1e3 * float(np.mean(v)) if v else None


class ForwardHooks:
    """Hooks on ``module`` for the calls made while installed.

    ``sync_at`` (a count of module calls, reset by :meth:`reset`) makes the
    post-hook of that call synchronise the device and stamp the host clock
    (``last_post``): the end of a program call's last forward."""

    def __init__(self, module: torch.nn.Module, events: bool = True):
        self.events = events
        self.pairs: list = []
        self.pre_times: list = []
        self.count = 0
        self.sync_at: int | None = None
        self.last_post: float | None = None
        self._rf = None
        self._handles = [module.register_forward_pre_hook(self._pre),
                         module.register_forward_hook(self._post)]

    def _pre(self, module, args):
        self.pre_times.append(time.perf_counter())
        self._rf = torch.autograd.profiler.record_function(FORWARD)
        self._rf.__enter__()
        if self.events:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            self.pairs.append([e0, None])

    def _post(self, module, args, out):
        if self.events:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            self.pairs[-1][1] = e1
        self._rf.__exit__(None, None, None)
        self._rf = None
        self.count += 1
        if self.sync_at is not None and self.count == self.sync_at:
            torch.cuda.synchronize()
            self.last_post = time.perf_counter()

    def reset(self) -> None:
        """Start a new program call: clears the call count, the pre-hook
        times and the event pairs."""
        self.count = 0
        self.pre_times = []
        self.pairs = []
        self.last_post = None

    def device_seconds(self) -> float:
        """Device seconds of the module calls since :meth:`reset` (waits
        for the last event)."""
        if not self.pairs:
            return 0.0
        self.pairs[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


class Profile:
    """``torch.profiler`` (CPU and CUDA activity) from :meth:`start` to
    :meth:`stop`, inside a ``gpubench.window`` range; each end waits for
    the device."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self._rf = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof.start()
        self._rf = torch.autograd.profiler.record_function(WINDOW)
        self._rf.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._rf.__exit__(None, None, None)
        self.prof.stop()

    def summary(self) -> dict:
        return summarize(self.prof.events())


class DeviceBusy:
    """The card's busy time over stretches of work: ``torch.profiler`` with
    CUDA activity alone from :meth:`start` to :meth:`stop`, each of which
    waits for the device.  :meth:`stop` adds the union of the stretch's
    kernels, copies and sets (not the profiler's annotations) to ``busy_s``
    and their number to ``activities``.  Keep a stretch to a few seconds, so
    that the profiler's buffers hold all of its activity."""

    def __init__(self):
        self.busy_s = 0.0
        self.activities = 0
        self.stretches = 0
        self._prof = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.stop()
        starts, ends = [], []
        # the profiler's own records, without building its Python events
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation() \
                    or e.name().startswith("gpubench."):
                continue
            s = e.start_ns()
            if e.end_ns() > s:
                starts.append(s)
                ends.append(e.end_ns())
        self._prof = None
        self.busy_s += union_ns(starts, ends) / 1e9
        self.activities += len(starts)
        self.stretches += 1


def union_ns(starts, ends) -> int:
    """Length of the union of the intervals ``[starts[i], ends[i]]``."""
    if not len(starts):
        return 0
    order = np.argsort(np.asarray(starts, np.int64), kind="stable")
    s = np.asarray(starts, np.int64)[order]
    run = np.maximum.accumulate(np.asarray(ends, np.int64)[order])
    first = np.ones(len(s), bool)
    first[1:] = s[1:] > run[:-1]
    idx = np.flatnonzero(first)
    last = np.append(idx[1:] - 1, len(s) - 1)
    return int((run[last] - s[idx]).sum())


def _merge(intervals):
    """Sorted, merged ``[start, end]`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, top: int = 10) -> dict:
    """Reduce the profiler's events (times in microseconds).

    Returns ``window_s`` (the ``gpubench.window`` range), ``busy_s`` (the
    union of device activity inside it: kernels, copies and sets, not the
    profiler's own annotations), ``range_device_s`` (device seconds of the
    kernels launched inside each ``gpubench.*`` range, by name), and the
    ``breakdown``: ``device_ops`` (device seconds by operation name) and
    ``idle_gaps`` (idle device seconds inside the window, grouped by the
    host operation running at each gap's middle, or the one that ended
    last before it), each the ``top`` largest."""
    win = None
    dev, cpu = [], []
    ranges = defaultdict(float)
    for e in events:
        name = e.name
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            if name == WINDOW:
                win = (start, end)
            if name.startswith("gpubench."):
                ranges[name] += e.device_time_total / 1e6
            else:
                cpu.append((start, end, name, e.thread))
        elif not getattr(e, "is_user_annotation", False) and \
                not name.startswith("gpubench.") and end > start:
            dev.append((start, end, name))
    if win is None:
        raise RuntimeError("profile: no gpubench.window range in the trace")
    w0, w1 = win
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    merged = _merge([[s, e] for s, e, _ in inside])
    busy = sum(e - s for s, e in merged)
    ops = defaultdict(float)
    for s, e, n in inside:
        ops[n] += (e - s) / 1e6
    gaps, t = [], w0
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    labels = defaultdict(float)
    if cpu:
        starts = np.array([c[0] for c in cpu])
        ends = np.array([c[1] for c in cpu])
        names = [c[2] for c in cpu]
    for g0, g1 in gaps[:200]:
        label = "host"
        if cpu:
            mid = 0.5 * (g0 + g1)
            cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if len(cover):
                k = cover[np.argmin(ends[cover] - starts[cover])]
                label = names[k]
            else:
                before = np.nonzero(ends <= g0)[0]
                if len(before):
                    label = "after " + names[before[np.argmax(ends[before])]]
        labels[label] += (g1 - g0) / 1e6
    rest = sum((g1 - g0) / 1e6 for g0, g1 in gaps[200:])
    if rest:
        labels["smaller gaps"] += rest

    def best(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "range_device_s": dict(ranges),
            "breakdown": {"device_ops": best(ops), "idle_gaps": best(labels)}}


class Obs:
    """What a traced run hands the per-layer readers: ``spans``
    (:class:`Spans`), ``profile`` (:func:`summarize`'s dict over the
    profiled stretch) and ``work`` (``calls``: program calls in the
    profiled stretch; ``flops``: model operations of one call;
    ``bound_s``: the least seconds of one call's forward)."""

    def __init__(self, spans: Spans, profile: dict, work: dict):
        self.spans = spans
        self.profile = profile
        self.work = work
