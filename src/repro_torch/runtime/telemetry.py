"""The telemetry bus: spans, sinks and the trace exporters
(``repro.runtime.telemetry``).

One :class:`Telemetry` is a run's event stream.  The producers (the
engine, the checkpoint store and the supervisor) call
:meth:`Telemetry.emit` with a kind from the closed taxonomy of
:mod:`repro_torch.runtime.events` and wrap their phases in
:meth:`Telemetry.span`; the consumers are sinks: an in-memory ring
(:class:`RingSink`), a JSONL file (:class:`JSONLSink`), or any object
with a ``write(event)`` method.

Two contracts make it safe to leave on:

* **off is a true no-op**: the disabled singleton :data:`NULL_TELEMETRY`
  (what ``telemetry=None`` resolves to) is falsy, its ``emit`` returns
  before building any record, and its ``span`` hands back one reusable
  null context manager: no allocation, no lock, no clock read;
* **on is bit-identical**: telemetry only reads host values the engine
  already holds at an epoch's end (its taus, the stop rules' margins,
  the exchange tally), so turning it on changes no computation, no
  launch and no draw of the generator on any lane.

Spans nest per thread (a thread-local stack gives each event its
``parent``), and emission is thread-safe: the checkpoint publisher emits
from its background thread onto the same bus, told apart by ``tid``.

Exporters: :func:`chrome_trace` renders a stream as Chrome/Perfetto
trace-event JSON, and :func:`torch_profiler_trace` runs a block under
``torch.profiler`` (host and card activities) and writes its Chrome
trace into a directory.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

from .events import Event, from_json, to_json, validate_event

__all__ = ["Telemetry", "NULL_TELEMETRY", "RingSink", "JSONLSink",
           "NullSink", "resolve_telemetry", "chrome_trace",
           "write_chrome_trace", "torch_profiler_trace"]


class NullSink:
    """Swallows everything (the explicit no-op sink)."""

    def write(self, ev: Event):
        pass


class RingSink:
    """Keeps the newest ``capacity`` events in memory (0 = unbounded)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._events: list = []
        self._lock = threading.Lock()

    def write(self, ev: Event):
        with self._lock:
            self._events.append(ev)
            if self.capacity and len(self._events) > self.capacity:
                del self._events[: len(self._events) - self.capacity]

    @property
    def events(self) -> list:
        with self._lock:
            return list(self._events)


class JSONLSink:
    """Appends one JSON line an event to ``path`` (thread-safe; each line
    is flushed, so a crashed run leaves a readable prefix)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._f = open(self.path, "a")

    def write(self, ev: Event):
        line = to_json(ev)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.close()


class _NullSpan:
    """The reusable context manager a disabled bus's spans return."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    """One live span: emits ``span.begin`` on enter and ``span.end`` on
    exit (with its seconds, and an ``error`` field naming the exception
    it left on)."""

    __slots__ = ("_tel", "name", "fields", "span_id", "_t0")

    def __init__(self, tel: "Telemetry", name: str, fields: dict):
        self._tel = tel
        self.name = name
        self.fields = fields
        self.span_id = None
        self._t0 = 0.0

    def __enter__(self):
        tel = self._tel
        self.span_id = next(tel._span_ids)
        stack = tel._span_stack()
        parent = stack[-1] if stack else None
        self._t0 = tel._clock()
        tel._push(Event("span.begin", self._t0,
                        {"name": self.name, **self.fields},
                        span=self.span_id, parent=parent,
                        tid=threading.get_ident()))
        stack.append(self.span_id)
        return self

    def __exit__(self, exc_type, exc, tb):
        tel = self._tel
        stack = tel._span_stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        t1 = tel._clock()
        fields = {"name": self.name, "seconds": t1 - self._t0}
        if exc_type is not None:
            fields["error"] = exc_type.__name__
        parent = stack[-1] if stack else None
        tel._push(Event("span.end", t1, fields, span=self.span_id,
                        parent=parent, tid=threading.get_ident()))
        return False


class Telemetry:
    """The bus.  ``sinks``: objects with ``write(event)``;
    ``validate=True`` checks every event against the taxonomy as it is
    emitted (tests and the card's smoke turn it on)."""

    def __init__(self, sinks=(), *, enabled: bool = True,
                 validate: bool = False, clock=time.monotonic):
        self.sinks = list(sinks)
        self._enabled = bool(enabled)
        self._validate = bool(validate)
        self._clock = clock
        self._span_ids = itertools.count(1)
        self._local = threading.local()

    def __bool__(self) -> bool:
        return self._enabled

    def add_sink(self, sink) -> "Telemetry":
        self.sinks.append(sink)
        return self

    def _span_stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _push(self, ev: Event):
        if self._validate:
            validate_event(ev)
        for s in self.sinks:
            s.write(ev)

    def emit(self, kind: str, **fields):
        """Emit one instant event (a kind of the taxonomy)."""
        if not self._enabled:
            return
        stack = self._span_stack()
        self._push(Event(kind, self._clock(), fields,
                         parent=stack[-1] if stack else None,
                         tid=threading.get_ident()))

    def span(self, name: str, **fields):
        """A context manager timing a named phase; spans nest per thread
        and the end event carries the seconds."""
        if not self._enabled:
            return _NULL_SPAN
        return _SpanCtx(self, name, fields)

    def events(self) -> list:
        """The events of the first RingSink (empty without one)."""
        for s in self.sinks:
            if isinstance(s, RingSink):
                return s.events
        return []

    def close(self):
        for s in self.sinks:
            close = getattr(s, "close", None)
            if close is not None:
                close()


# The disabled singleton every telemetry=None resolves to.
NULL_TELEMETRY = Telemetry((), enabled=False)


def resolve_telemetry(arg) -> Telemetry:
    """A ``telemetry=`` argument as a bus: ``None`` -> the disabled
    singleton, a :class:`Telemetry` -> itself, a path -> a new bus
    writing JSONL there, a sink object -> a bus around it."""
    if arg is None:
        return NULL_TELEMETRY
    if isinstance(arg, Telemetry):
        return arg
    if isinstance(arg, (str, bytes)) or hasattr(arg, "__fspath__"):
        return Telemetry([JSONLSink(arg)])
    if hasattr(arg, "write"):
        return Telemetry([arg])
    raise TypeError(
        f"telemetry must be None, a Telemetry, a JSONL path or a sink "
        f"object with .write(event); got {type(arg).__name__}")


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def chrome_trace(events) -> dict:
    """An event stream (Events or parsed JSONL dicts) as Chrome/Perfetto
    trace-event JSON: each matched ``span.begin``/``span.end`` pair a
    ``"ph": "X"`` complete event (microseconds from the stream's first
    event, one track a thread), each instant event a ``"ph": "i"``
    instant with its payload as ``args``.  A span left open is closed at
    the stream's end, so a truncated trace still loads."""
    evs = [e if isinstance(e, Event) else from_json(e) for e in events]
    if not evs:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(e.t for e in evs)
    t_end = max(e.t for e in evs)

    def us(t):
        return (t - t0) * 1e6

    open_spans: dict = {}
    rows = []
    for e in evs:
        if e.kind == "span.begin":
            open_spans[e.span] = e
        elif e.kind == "span.end":
            b = open_spans.pop(e.span, None)
            if b is None:
                continue
            rows.append({
                "name": b.fields.get("name", f"span{e.span}"),
                "ph": "X", "ts": us(b.t), "dur": max(0.0, us(e.t) - us(b.t)),
                "pid": 0, "tid": b.tid,
                "args": {k: v for k, v in {**b.fields, **e.fields}.items()
                         if k != "name"}})
        else:
            rows.append({"name": e.kind, "ph": "i", "s": "t",
                         "ts": us(e.t), "pid": 0, "tid": e.tid,
                         "args": dict(e.fields)})
    for b in open_spans.values():
        rows.append({"name": b.fields.get("name", f"span{b.span}"),
                     "ph": "X", "ts": us(b.t),
                     "dur": max(0.0, us(t_end) - us(b.t)),
                     "pid": 0, "tid": b.tid,
                     "args": {k: v for k, v in b.fields.items()
                              if k != "name"}})
    rows.sort(key=lambda r: r["ts"])
    return {"traceEvents": rows, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, events) -> str:
    """Write :func:`chrome_trace` JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(events), f)
    return str(path)


_trace_ids = itertools.count()


@contextmanager
def torch_profiler_trace(logdir: Optional[str]):
    """With a directory, run the block under ``torch.profiler`` (CPU
    activity, and CUDA where a card is present) and write its Chrome
    trace there as ``trace-<pid>-<n>.json``; the context yields that
    path.  With ``None`` (or an empty string) it is a no-op that yields
    None, so a call site can pass a config value through as it is."""
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(str(logdir),
                        f"trace-{os.getpid()}-{next(_trace_ids)}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
