"""Typed telemetry events: the records the bus carries, and the schema
they are validated against (``repro.runtime.events``).

One :class:`Event` is one fact about a run, stamped at emit time with
``time.monotonic()`` (the trace clock; wall time is left out, so a trace
does not jump with the system clock).  The kind taxonomy is closed:
every kind a module under ``src/`` emits is registered in
:data:`EVENT_KINDS`, every span name in :data:`SPAN_NAMES`, and
``tools/check_events.py`` checks both packages' literals against the
JAX package's registry, which these tables equal entry for entry.  A
consumer (the sinks of :mod:`repro_torch.runtime.telemetry`, the Chrome
trace exporter, ``tools/trace_report.py``) can read any event that
validates.

JSONL wire format, the same as the JAX package's, so that either package
reads the other's traces: one event a line, the reserved columns
``kind`` / ``t`` / ``span`` / ``parent`` / ``tid`` at the top level and
the kind's payload flattened beside them, e.g. ``{"kind":
"epoch.stats", "t": 1.25, "tid": 0, "epoch": 3, "tau": 4000, ...}``.  A
payload field may not shadow a reserved column (:func:`validate_event`
rejects it), so :func:`to_json` and :func:`from_json` round-trip.
"""
from __future__ import annotations

import json
from typing import NamedTuple, Optional

__all__ = ["Event", "EVENT_KINDS", "SPAN_NAMES", "SUPERVISOR_EVENT_KINDS",
           "validate_event", "to_json", "from_json", "read_jsonl"]

# Reserved top-level JSONL columns (everything else is the payload).
_RESERVED = ("kind", "t", "span", "parent", "tid")


class Event(NamedTuple):
    """One telemetry record.

    ``t`` is ``time.monotonic()`` seconds at emit; ``span`` and
    ``parent`` are span ids (``span`` set on ``span.begin`` /
    ``span.end``, None on instant events); ``tid`` is the emitting
    thread's ident: the checkpoint publisher emits from its background
    thread, and the Chrome exporter puts its spans on their own track.
    """
    kind: str
    t: float
    fields: dict
    span: Optional[int] = None
    parent: Optional[int] = None
    tid: int = 0


# The kind taxonomy: kind -> (required payload fields, one-line doc),
# the JAX package's table entry for entry.  Optional payload fields are
# allowed; the required ones are what validate_event enforces.
EVENT_KINDS = {
    "run.start": (("lane", "metrics", "n_nodes", "eps", "delta"),
                  "run_adaptive entered; lane + instance identity"),
    "run.end": (("tau", "n_epochs", "converged"),
                "run_adaptive returning; the result's headline numbers"),
    "span.begin": (("name",),
                   "a span timer opened (name from the span schema)"),
    "span.end": (("name", "seconds"),
                 "the matching close; seconds = monotonic duration"),
    "epoch.stats": (("epoch", "tau", "samples", "seconds", "max_f",
                     "max_g"),
                    "one adaptive epoch: running tau, samples drawn this "
                    "epoch, wall time, per-estimator stop-rule margins"),
    "exchange.epoch": (("epoch", "levels_total", "levels_sparse",
                        "levels_dense_fallback", "levels_dense_only",
                        "bytes"),
                       "sharded lane: aggregated per-epoch frontier-"
                       "exchange protocol counts + ExchangePlan bytes"),
    "checkpoint.publish": (("step", "seconds", "ok"),
                           "async publish pipeline finished (background "
                           "thread); ok=False carries an error field"),
    "checkpoint.restore": (("step", "seconds", "ok"),
                           "a restore attempt of one step finished"),
    "checkpoint.quarantine": (("step",),
                              "a damaged step was renamed aside during "
                              "restore fallback"),
    "supervisor.fault": (("epoch", "attempt", "detail"),
                         "an injected fault fired at an epoch boundary"),
    "supervisor.failure": (("epoch", "attempt", "detail"),
                           "a run_adaptive call died (real or injected)"),
    "supervisor.retry": (("epoch", "attempt", "detail"),
                         "re-entering from the last good checkpoint "
                         "(rollback) after backoff"),
    "supervisor.shrink": (("epoch", "attempt", "detail"),
                          "device loss: re-entering on fewer devices"),
    "supervisor.degrade": (("epoch", "attempt", "detail"),
                           "retry budget exhausted: dropping one ladder "
                           "rung (sharded -> spmd -> single)"),
    "supervisor.migrate": (("epoch", "attempt", "detail"),
                           "checkpoint state re-fitted onto the new "
                           "lane's shapes"),
}

# The RunEvent kinds the supervisor re-emits as "supervisor.<kind>", in
# lockstep with the supervisor.* entries above.
SUPERVISOR_EVENT_KINDS = ("fault", "failure", "retry", "shrink", "degrade",
                          "migrate")

# The span schema: every literal name passed to Telemetry.span().
SPAN_NAMES = {
    "phase.diameter": "phase 1 — diameter estimation (+ lane setup)",
    "phase.calibration": "phase 2 — calibration draws + stop-rule params",
    "phase.epoch": "one adaptive epoch (fields: epoch)",
    "phase.flush": "the final flush of unconverged metrics",
    "checkpoint.publish": "async checkpoint publish (background thread)",
    "checkpoint.restore": "one checkpoint restore attempt",
    "supervisor.migrate": "elastic state migration onto a new rung",
}


def validate_event(ev) -> Event:
    """Validate one event (an :class:`Event` or a parsed JSONL dict)
    against the taxonomy; returns the Event or raises ``ValueError``
    naming what is wrong."""
    if isinstance(ev, dict):
        ev = from_json(ev)
    if not isinstance(ev, Event):
        raise ValueError(f"not an Event: {type(ev).__name__}")
    if ev.kind not in EVENT_KINDS:
        raise ValueError(f"unregistered event kind {ev.kind!r} (the "
                         "taxonomy is EVENT_KINDS)")
    if not isinstance(ev.t, (int, float)):
        raise ValueError(f"{ev.kind}: timestamp t={ev.t!r} is not a number")
    required, _doc = EVENT_KINDS[ev.kind]
    missing = [f for f in required if f not in ev.fields]
    if missing:
        raise ValueError(f"{ev.kind}: missing required fields {missing}")
    shadow = [f for f in ev.fields if f in _RESERVED]
    if shadow:
        raise ValueError(f"{ev.kind}: payload fields {shadow} shadow "
                         "reserved JSONL columns")
    if ev.kind in ("span.begin", "span.end") and ev.span is None:
        raise ValueError(f"{ev.kind}: span id missing")
    return ev


def to_json(ev: Event) -> str:
    """One JSONL line (no trailing newline)."""
    d = {"kind": ev.kind, "t": ev.t}
    if ev.span is not None:
        d["span"] = ev.span
    if ev.parent is not None:
        d["parent"] = ev.parent
    d["tid"] = ev.tid
    d.update(ev.fields)
    return json.dumps(d)


def from_json(line) -> Event:
    """Parse one JSONL line (or an already parsed dict) into an Event."""
    d = (dict(json.loads(line)) if isinstance(line, (str, bytes))
         else dict(line))
    return Event(kind=d.pop("kind"), t=float(d.pop("t")),
                 span=d.pop("span", None), parent=d.pop("parent", None),
                 tid=int(d.pop("tid", 0)), fields=d)


def read_jsonl(path: str, *, validate: bool = False) -> list:
    """Every event of a JSONL file, in file order; with ``validate=True``
    each line is checked against the taxonomy (raises ``ValueError`` at
    the first bad line, naming its number)."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = from_json(line)
                if validate:
                    validate_event(ev)
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                raise ValueError(f"{path}:{i}: bad event line: {e}") from e
            out.append(ev)
    return out
