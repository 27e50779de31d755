"""The port's tracing: spans at its layer boundaries, and reading a
``torch.profiler`` trace.

Spans. ``span(name)`` marks a stage of the serving path or of a training
step (``eval/inference.py``, ``train/trainer.py``, ``train/step.py``), or
a half of a model's forward (``models/rangenet.py``).
A span records only while a ``torch.profiler`` profile records in this
process; otherwise it is one check of torch's profiler flag and stores
nothing. A recorded span holds its name, its parent (the span open on the
same thread when it opened), a request id (given to a root span, the
served batch's number or the Trainer's step, inherited by its children),
its host start and end in nanoseconds on the clock of the profiler's own
events (``time.time_ns()``: Unix-epoch nanoseconds, as
``kineto_results.events()`` gives them), and, while CUDA is in use, a
pair of timing events recorded at its start and end on the stream that
was current when its root opened: the device time between the stream
reaching the one and the other.
Nothing is written to disk and no device operation is added to the
profiler's trace (the timing events show there as runtime calls only):
the spans live in a bounded buffer beside it, one traced slice at a time,
and :func:`traced_spans` resolves them after the trace has closed.

Reading a trace. ``host_sync_calls`` lists the CUDA runtime calls of a
trace that make the host wait for the stream (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``) or may (``cudaMemcpy``
family), each with the chain of operators it ran under, e.g.
``aten::to > aten::_to_copy > aten::copy_ > cudaMemcpyAsync``: the chain
names the op in the step that caused it.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
COPY_CALLS = ("cudaMemcpyAsync", "cudaMemcpy")
SPAN_LIMIT = 1 << 14      # spans kept of one slice; older ones are dropped


class _Span:
    """A recorded span; also the context manager that records it."""

    __slots__ = ("name", "sid", "parent", "rid", "start_ns", "end_ns",
                 "stream", "events", "last_child")

    def __init__(self, name: str, rid: int | None):
        self.name = name
        self.rid = rid
        self.stream = None
        self.events = None
        self.last_child = None

    def open(self, at: int | None = None) -> "_Span":
        """Start at ``at`` (a ``time.time_ns()`` read), or now."""
        stack = _LOCAL.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        self.parent = None
        if parent is not None:
            self.parent = parent.sid
            if self.rid is None:
                self.rid = parent.rid
            self.stream = parent.stream
            parent.last_child = self
        _BUFFER.add(self)
        if torch.cuda.is_initialized():
            # a root looks its stream up (the look-up costs more than the
            # two events' records together); its children take it
            if self.stream is None:
                self.stream = torch.cuda.current_stream()
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.start_ns = time.time_ns() if at is None else at
        self.end_ns = None
        stack.append(self)
        return self

    def close(self, at: int | None = None) -> None:
        """End at ``at`` (a ``time.time_ns()`` read), or now."""
        self.end_ns = time.time_ns() if at is None else at
        if self.events is not None:
            self.events[1].record(self.stream)
        stack = _LOCAL.stack
        if self in stack:           # and any child an exception left open
            del stack[stack.index(self):]

    __enter__ = open

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class _Off:
    """What ``span`` gives while no profiler records: does nothing."""

    def open(self, at=None):
        return self

    def close(self, at=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        pass


class _Buffer:
    """The spans of one traced slice, in the order they opened. Reading
    them ends the slice: the next span recorded starts a new one."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: collections.deque = collections.deque(maxlen=SPAN_LIMIT)
        self.ids = itertools.count()
        self.read = False

    def add(self, s: _Span) -> None:
        with self.lock:
            if self.read:
                self.spans.clear()
                self.read = False
            s.sid = next(self.ids)
            self.spans.append(s)

    def take(self) -> list[_Span]:
        with self.lock:
            self.read = True
            return list(self.spans)


NO_SPAN = _Off()    # what a span is while nothing records
_LOCAL = threading.local()
_BUFFER = _Buffer()


def span(name: str, rid: int | None = None):
    """A context manager that records the stage ``name`` while a
    ``torch.profiler`` profile records; ``.open(at)`` and ``.close(at)``
    do the same by hand, at ``time.time_ns()`` reads the caller took.
    ``rid`` is the request id of a root span (children take their
    parent's)."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _Span(name, rid)


def extend(name: str, at: int | None = None) -> None:
    """Move the end of the current span's last child, if it is ``name``,
    to ``at`` (or now): for a stage that a callee begins and its caller
    finishes."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = getattr(_LOCAL, "stack", None)
    child = stack[-1].last_child if stack else None
    if child is not None and child.name == name and child.end_ns is not None:
        child.close(at)


def traced_spans() -> list[dict]:
    """The closed spans of the last traced slice, in the order they opened:
    ``name``, ``id``, ``parent`` (an id or None), ``rid``, ``start_ns`` and
    ``end_ns`` (host), ``device_ms`` (between the stream reaching the
    span's start and its end; with no card, the host's duration, since the
    work ran inside the span). Synchronises the card if it was used."""
    spans = [s for s in _BUFFER.take() if s.end_ns is not None]
    if any(s.events is not None for s in spans):
        torch.cuda.synchronize()
    out = []
    for s in spans:
        if s.events is not None:
            device_ms = s.events[0].elapsed_time(s.events[1])
        else:
            device_ms = (s.end_ns - s.start_ns) * 1e-6
        out.append({"name": s.name, "id": s.sid, "parent": s.parent,
                    "rid": s.rid, "start_ns": s.start_ns,
                    "end_ns": s.end_ns, "device_ms": device_ms})
    return out


def add_spans_to_chrome_trace(path: str, spans: list[dict]) -> None:
    """Write ``spans`` into the Chrome trace ``path`` that
    ``torch.profiler`` exported, as complete events on a track of their
    own ("spans", thread 0) of this process, on the trace's time base."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    events = trace["traceEvents"]
    pid = os.getpid()
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "spans"}})
    for s in spans:
        events.append({
            "ph": "X", "cat": "span", "name": s["name"], "pid": pid,
            "tid": 0, "ts": (s["start_ns"] - base) / 1e3,
            "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
            "args": {"rid": s["rid"], "device_ms": s["device_ms"]}})
    with open(path, "w") as f:
        json.dump(trace, f)


def host_sync_calls(prof, names: tuple[str, ...] = SYNC_CALLS + COPY_CALLS
                    ) -> dict[str, int]:
    """{"op > op > runtime call": count} over a finished profile."""
    out: collections.Counter = collections.Counter()
    for evt in prof.events():
        if evt.name not in names:
            continue
        chain = [evt.name]
        parent = evt.cpu_parent
        while parent is not None:
            chain.append(parent.name)
            parent = parent.cpu_parent
        out[" > ".join(reversed(chain))] += 1
    return dict(out)


def count_calls(calls: dict[str, int], names: tuple[str, ...] = SYNC_CALLS
                ) -> int:
    """How many of ``host_sync_calls``' entries end in one of ``names``."""
    return sum(n for chain, n in calls.items()
               if chain.rsplit(" > ", 1)[-1] in names)
