"""The port's event taxonomy and telemetry wire against the JAX package's
(``repro.runtime.events``, ``repro.runtime.telemetry``): the same
registries, the same JSONL lines read and validated by either package,
the same verdicts of the validator and the same Chrome trace."""
import json

import numpy as np
import pytest
import torch

import repro.runtime as jrt
import repro.runtime.events as jev
import repro.runtime.telemetry as jtel
import repro_torch.core as tc
import repro_torch.runtime as trt
import repro_torch.runtime.events as tev
import repro_torch.runtime.telemetry as ttel
from repro_torch.core import AdaptiveConfig

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registries_equal_the_reference():
    assert tev.EVENT_KINDS == jev.EVENT_KINDS
    assert tev.SPAN_NAMES == jev.SPAN_NAMES
    assert tev.SUPERVISOR_EVENT_KINDS == jev.SUPERVISOR_EVENT_KINDS
    assert trt.available_faults() == jrt.available_faults()


def test_runtime_exports_the_reference_names():
    """The port's ``__all__`` is the reference's, with
    ``torch_profiler_trace`` where the reference has
    ``jax_profiler_trace``."""
    want = set(jrt.__all__) - {"jax_profiler_trace"} | {
        "torch_profiler_trace"}
    assert set(trt.__all__) == want
    assert all(hasattr(trt, name) for name in trt.__all__)


def _every_kind_emitted(tel):
    """One event of each registered kind (the span kinds through a span
    of each name), through ``tel``."""
    payload = {"lane": "single", "metrics": ["betweenness"], "n_nodes": 9,
               "eps": 0.1, "delta": 0.1, "tau": 12, "n_epochs": 2,
               "converged": True, "epoch": 1, "samples": 4, "seconds": 0.5,
               "max_f": [0.25], "max_g": [0.125], "levels_total": 3,
               "levels_sparse": 1, "levels_dense_fallback": 2,
               "levels_dense_only": 0, "bytes": 4096, "step": 1, "ok": True,
               "attempt": 0, "detail": "x"}
    for kind, (required, _doc) in sorted(tev.EVENT_KINDS.items()):
        if kind.startswith("span."):
            continue
        tel.emit(kind, **{f: payload[f] for f in required})
    for name in sorted(tev.SPAN_NAMES):
        with tel.span(name, step=1):
            pass


@pytest.mark.parametrize("writer, reader", [(ttel, jev), (jtel, tev)],
                         ids=["port_to_reference", "reference_to_port"])
def test_jsonl_lines_read_across_the_packages(tmp_path, writer, reader):
    """A JSONL written by one package's bus, every kind and span in it,
    reads and validates line by line in the other, to the same events."""
    path = str(tmp_path / "t.jsonl")
    sink = writer.JSONLSink(path)
    ring = writer.RingSink(0)
    _every_kind_emitted(writer.Telemetry([sink, ring], validate=True))
    sink.close()
    got = reader.read_jsonl(path, validate=True)
    assert len(got) == len(ring.events) == len(tev.EVENT_KINDS) - 2 + 2 * len(
        tev.SPAN_NAMES)
    assert [tuple(e) for e in got] == [tuple(e) for e in ring.events]


def test_port_run_trace_reads_in_the_reference(tmp_path):
    """A port run's JSONL validates under the reference's taxonomy."""
    g = tc.erdos_renyi_graph(60, 5.0, seed=1, device=CPU)
    path = str(tmp_path / "run.jsonl")
    tel = ttel.Telemetry([ttel.JSONLSink(path)], validate=True)
    res = tc.run_adaptive(g, config=AdaptiveConfig(eps=0.1, n0_base=60),
                          seed=3, device=CPU, checkpoint_dir=str(
                              tmp_path / "ck"), telemetry=tel)
    tel.close()
    evs = jev.read_jsonl(path, validate=True)
    kinds = [e.kind for e in evs]
    assert kinds[0] == "run.start" and kinds[-1] == "run.end"
    assert kinds.count("epoch.stats") == res.n_epochs
    assert evs[-1].fields == {"tau": res.tau, "n_epochs": res.n_epochs,
                              "converged": res.converged}
    assert kinds.count("checkpoint.publish") == res.n_epochs


_BAD = [
    {"kind": "run.end", "t": 1.0, "tau": 1},
    {"kind": "no.such", "t": 1.0},
    {"kind": "run.end", "t": "x", "tau": 1, "n_epochs": 1,
     "converged": True},
    {"kind": "span.begin", "t": 1.0, "name": "phase.epoch"},
    {"kind": "checkpoint.quarantine", "t": 1.0, "step": 1, "tid": 3,
     "span": None},
    {"kind": "checkpoint.quarantine", "t": 1.0, "step": 1},
    {"kind": "epoch.stats", "t": 0.0, "epoch": 1, "tau": 2, "samples": 2,
     "seconds": 0.1, "max_f": [], "max_g": []},
]


@pytest.mark.parametrize("row", range(len(_BAD)))
def test_validate_event_gives_the_reference_verdict(row):
    def verdict(mod):
        try:
            mod.validate_event(dict(_BAD[row]))
        except ValueError:
            return False
        return True
    assert verdict(tev) == verdict(jev)


def test_shadowing_payload_is_refused_by_both():
    for mod in (tev, jev):
        ev = mod.Event("run.end", 1.0, {"tau": 1, "n_epochs": 1,
                                        "converged": True, "tid": 4})
        with pytest.raises(ValueError, match="shadow"):
            mod.validate_event(ev)


def test_wire_lines_are_the_reference_lines():
    rng = np.random.default_rng(0)
    for i in range(5):
        fields = {"epoch": i, "tau": int(rng.integers(1000)),
                  "samples": 64, "seconds": float(rng.random()),
                  "max_f": [float(rng.random())], "max_g": [0.5]}
        args = ("epoch.stats", float(rng.random()), fields)
        kw = {"span": None if i % 2 else i, "parent": i + 1, "tid": 7}
        line = tev.to_json(tev.Event(*args, **kw))
        assert line == jev.to_json(jev.Event(*args, **kw))
        assert tuple(tev.from_json(line)) == tuple(jev.from_json(line))
        assert tev.from_json(line) == tev.Event(*args, **kw)


def test_chrome_trace_is_the_references():
    """Both exporters render the same stream (a span left open, nested
    spans, instants from two threads) to the same JSON."""
    ring = ttel.RingSink(0)
    tel = ttel.Telemetry([ring], validate=True)
    _every_kind_emitted(tel)
    with tel.span("phase.epoch", epoch=1):
        with tel.span("checkpoint.restore", step=2):
            tel.emit("checkpoint.quarantine", step=2)
    evs = ring.events
    evs.append(tev.Event("span.begin", evs[-1].t + 1.0,
                         {"name": "phase.flush"}, span=999, tid=5))
    got = ttel.chrome_trace(evs)
    assert got == jtel.chrome_trace([jev.Event(*e) for e in evs])
    assert got == ttel.chrome_trace([json.loads(tev.to_json(e))
                                     for e in evs])
    assert ttel.chrome_trace([]) == jtel.chrome_trace([])
