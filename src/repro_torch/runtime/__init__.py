"""The runtime of the port (``repro.runtime``): resilience and telemetry
around the adaptive-sampling engine.

``faults`` is the seeded fault-injection harness (kill, shrink, corrupt,
truncate, nan, hang); ``supervisor`` is :class:`ResilientRunner`, which
drives ``repro_torch.core.engine.run_adaptive`` through them: bounded
retry with backoff, a watchdog on every epoch's state with rollback, and
the degradation ladder sharded -> SPMD -> single over the port's lanes.

``events`` and ``telemetry`` are the telemetry bus (the JAX package's
event taxonomy and JSONL wire format, span timers, sinks, the Chrome
trace export and a ``torch.profiler`` gate), threaded through the
engine, the checkpoint store and the supervisor; ``tools/trace_report.py``
reads its traces.
"""
from .events import (EVENT_KINDS, SPAN_NAMES, SUPERVISOR_EVENT_KINDS, Event,
                     read_jsonl, validate_event)
from .faults import (DeviceLoss, FaultContext, FaultSchedule, FaultSpec,
                     InjectedFault, apply_fault, available_faults)
from .supervisor import (EpochTimeoutError, InvariantViolation,
                         ResilienceExhausted, ResilientRunner,
                         ResilientRunResult, RetryPolicy, RunEvent,
                         check_state_invariants, elastic_migrate_state)
from .telemetry import (JSONLSink, NullSink, NULL_TELEMETRY, RingSink,
                        Telemetry, chrome_trace, resolve_telemetry,
                        torch_profiler_trace, write_chrome_trace)

__all__ = [
    "DeviceLoss", "FaultContext", "FaultSchedule", "FaultSpec",
    "InjectedFault", "apply_fault", "available_faults",
    "EpochTimeoutError", "InvariantViolation", "ResilienceExhausted",
    "ResilientRunner", "ResilientRunResult", "RetryPolicy", "RunEvent",
    "check_state_invariants", "elastic_migrate_state",
    "EVENT_KINDS", "SPAN_NAMES", "SUPERVISOR_EVENT_KINDS", "Event",
    "read_jsonl", "validate_event",
    "JSONLSink", "NullSink", "NULL_TELEMETRY", "RingSink", "Telemetry",
    "chrome_trace", "torch_profiler_trace", "resolve_telemetry",
    "write_chrome_trace",
]
