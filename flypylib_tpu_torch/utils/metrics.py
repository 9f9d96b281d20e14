"""Observability: a span and counter tracer, stage timing, metric logs,
PR-curve dumps and plots, a profiler trace.

Counterpart of ``flypylib_tpu/utils/metrics.py``.  ``MetricsLog``,
``dump_pr_curve``, ``load_pr_curve`` and ``plot_pr_curve`` are copies (numpy
and the standard library; ``plot_pr_curve`` imports matplotlib inside).
``profile_trace`` is the ``torch.profiler`` counterpart of the reference's
``jax.profiler`` trace: a Chrome trace file.  ``StageTimer`` keeps the
reference's report; on a card it synchronises at each end of a stage.

**The tracer** (the port's own; the reference has none).  The detection
and training paths open spans (:func:`span`, :func:`timed`) at their layer
boundaries and add counters (:func:`count`).  It records while
:func:`enable` has turned it on, and while a ``torch.profiler`` records (so
a profiled stretch carries the port's spans without a call to the port);
otherwise :func:`span` returns one shared no-op and :func:`count` returns
at once.  :func:`take` returns the records and clears them.  What a
profiler's stretch records waits for :func:`take` in a store that keeps
only the newest :data:`PROFILED_LIMIT` spans and counters, so a program
that profiles and never takes holds no more than that.  (Recording under a
profiler stands in for explicit :func:`enable` / :func:`take` calls around
``gpubench``'s profiled stretch, which its harness does not make yet.)

- A span records its name, an id, its parent's id (the innermost span open
  on the same thread, or one handed over with :func:`attach`), the id of
  its root (so the spans of one ``detect_large`` call or one train step
  share it), its thread, its host start and end (``time.perf_counter_ns``)
  and its attributes.  With ``device=`` a CUDA device it also records a
  CUDA event pair on that device's current stream: :func:`take` reads the
  elapsed time between them (the span's *stream time*: the card's busy and
  idle time between the span's ends, as its stream saw them).
- Counters are named integers, summed per root.
- Nothing here waits for the card: no span or counter synchronises, and
  :func:`take` reads events the caller has waited for (it raises on one the
  card has not reached).
- Each recorded span also enters ``torch.profiler.record_function("fpl." +
  name)``, so in a profiled stretch the spans sit on the profiler's clock
  beside the kernels.
"""

from __future__ import annotations

import contextlib
import csv
import itertools
import json
import logging
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.autograd import profiler as _profiler

logger = logging.getLogger("flypylib_tpu_torch")


# the most spans, and counters, the profiler's store keeps (the newest)
PROFILED_LIMIT = 1 << 14


class _Trace:
    """The records of one tracing session: finished spans and per-root
    counters, appended to from any thread; with ``limit``, only the newest
    ``limit`` of each."""

    def __init__(self, limit: int | None = None):
        self.lock = threading.Lock()
        self.limit = limit
        self.spans: deque[Span] = deque(maxlen=limit)
        self.counters: dict = {}  # (root id, name) -> n

    def add(self, key, n: int) -> None:
        """Add ``n`` to counter ``key`` (the caller holds the lock)."""
        c = self.counters
        c[key] = c.get(key, 0) + n
        if self.limit is not None and len(c) > self.limit:
            del c[next(iter(c))]  # the oldest


# the session enable() opened, or None (off); spans made while a profiler
# records, with no session open, go to _PROFILED
_TRACE: _Trace | None = None
_PROFILED = _Trace(PROFILED_LIMIT)
_IDS = itertools.count(1)
_LOCAL = threading.local()


def _stack() -> list:
    """The spans open on this thread, innermost last."""
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def _active() -> _Trace | None:
    """The session spans record into now, or None."""
    trace = _TRACE
    if trace is None and _profiler._is_profiler_enabled:
        return _PROFILED
    return trace


class Span:
    """One span: a context manager (see the module docstring).  ``seconds``
    is its host time once it has ended."""

    __slots__ = ("trace", "name", "device", "attrs", "id", "parent", "root",
                 "thread", "start_ns", "end_ns", "events", "_rf")

    def __init__(self, trace: _Trace | None, name: str, device, attrs: dict):
        self.trace, self.name, self.attrs = trace, name, attrs
        self.device = device
        self.start_ns = self.end_ns = 0
        self.events = None

    def __enter__(self):
        if self.trace is not None:
            stack = _stack()
            up = stack[-1] if stack else None
            self.id = next(_IDS)
            self.parent = up.id if up is not None else 0
            self.root = up.root if up is not None else self.id
            self.thread = threading.get_ident()
            self._rf = _profiler.record_function("fpl." + self.name)
            self._rf.__enter__()
            dev = self.device
            if dev is not None and torch.device(dev).type == "cuda":
                stream = torch.cuda.current_stream(dev)
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record(stream)
            stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        trace = self.trace
        if trace is not None:
            if self.events is not None:
                self.events[1].record(torch.cuda.current_stream(self.device))
            self._rf.__exit__(*exc)
            self._rf = None
            _stack().remove(self)
            with trace.lock:
                trace.spans.append(self)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span (a mode chosen)."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def record(self) -> dict:
        """The span as a plain dict; ``stream_ms`` is None without events."""
        stream_ms = None
        if self.events is not None:
            if not self.events[1].query():
                raise RuntimeError(f"span {self.name!r}: the card has not "
                                   "reached its end event (synchronise "
                                   "before take())")
            stream_ms = self.events[0].elapsed_time(self.events[1])
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "root": self.root, "thread": self.thread,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "host_ms": (self.end_ns - self.start_ns) / 1e6,
                "stream_ms": stream_ms, "attrs": dict(self.attrs)}


class _NoSpan:
    """The span the tracer hands out while off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoSpan()


def span(name: str, device=None, **attrs):
    """A span named ``name`` (a context manager); ``device`` a CUDA device
    (or its name) adds a stream-time event pair.  Off: the shared no-op."""
    trace = _TRACE
    if trace is None:
        if not _profiler._is_profiler_enabled:
            return _NOOP
        trace = _PROFILED
    return Span(trace, name, device, attrs)


def timed(name: str, device=None, **attrs) -> Span:
    """A :func:`span` that times its host clock (``.seconds``) even while
    the tracer is off, for a caller that keeps the seconds itself."""
    return Span(_active(), name, device, attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span's root (root
    0 outside any span)."""
    trace = _active()
    if trace is None:
        return
    stack = _stack()
    root = stack[-1].root if stack else 0
    with trace.lock:
        trace.add((root, name), int(n))


def current_span():
    """The innermost span open on this thread (None when none is, or the
    tracer is off): hand it to another thread's :func:`attach`."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def attach(parent):
    """Spans this thread opens inside the block sit under ``parent`` (a
    :func:`current_span` of another thread; None attaches nothing)."""
    if parent is None:
        yield
        return
    stack = _stack()
    stack.append(parent)
    try:
        yield
    finally:
        stack.remove(parent)


def enable() -> None:
    """Turn the tracer on (a new session; a session already open stays)."""
    global _TRACE
    if _TRACE is None:
        _TRACE = _Trace()


def disable() -> dict:
    """Turn the tracer off; returns :func:`take`'s records."""
    global _TRACE
    out = take()
    _TRACE = None
    return out


def take() -> dict:
    """The records since the last call, cleared: ``{"spans": [...],
    "counters": {root: {name: n}}}``, spans in the order they ended
    (:meth:`Span.record`'s dicts).  Synchronise the card first."""
    spans, counters = [], defaultdict(dict)
    for trace in (t for t in (_TRACE, _PROFILED) if t is not None):
        with trace.lock:
            got, cnt = list(trace.spans), trace.counters
            trace.spans.clear()
            trace.counters = {}
        spans += [s.record() for s in got]
        for (root, name), n in cnt.items():
            counters[root][name] = counters[root].get(name, 0) + n
    return {"spans": spans, "counters": dict(counters)}


@dataclass
class StageTimer:
    """Accumulates per-stage wall clock + voxel counts -> Mvox/s.

    Each stage is also a tracer span of its own name.  Once CUDA is
    initialised, a stage synchronises the card at its entry and its exit,
    so its seconds are the work's, not the time to queue it (the
    reference's timer reads the host clock alone)."""

    stages: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, voxels: int = 0):
        cuda = torch.cuda.is_initialized()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
                if cuda:
                    torch.cuda.synchronize()
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
