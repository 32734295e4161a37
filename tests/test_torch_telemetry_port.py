"""The port's telemetry bus (``repro_torch.runtime.telemetry``) on the
CPU: off is a no-op, on is bitwise off on the single and ``ShardMesh``
lanes with the same levels and stop checks, the checkpoint store's
publish, restore and quarantine events, ``tools/trace_report.py`` on a
port trace, and the ``torch.profiler`` gate."""
import json
import os
import subprocess
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.checkpoint import (CheckpointManager,
                                    install_publish_fault_hook, restore,
                                    restore_arrays, save)
from repro_torch.core import AdaptiveConfig, ShardMesh, partition_graph
from repro_torch.kernels.stopcheck import ops as stop_ops
from repro_torch.runtime import (JSONLSink, NULL_TELEMETRY, NullSink,
                                 RingSink, Telemetry, read_jsonl,
                                 resolve_telemetry, torch_profiler_trace,
                                 write_chrome_trace)
from repro_torch.runtime.faults import corrupt_newest_step

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
sys.path.insert(0, TOOLS)
import trace_report  # noqa: E402

CPU = "cpu"
CFG = AdaptiveConfig(eps=0.1, delta=0.1, n0_base=60)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _er60():
    return tc.erdos_renyi_graph(60, 5.0, seed=1, device=CPU)


# ---------------------------------------------------------------------------
# The bus
# ---------------------------------------------------------------------------

def test_null_telemetry_is_falsy_and_swallows_everything():
    assert not NULL_TELEMETRY
    assert NULL_TELEMETRY.emit("run.end", tau=1) is None
    assert NULL_TELEMETRY.span("phase.epoch", epoch=1) is \
        NULL_TELEMETRY.span("phase.diameter")
    ring = RingSink()
    tel = Telemetry([ring], enabled=False)
    tel.emit("run.end", tau=1)
    with tel.span("phase.epoch"):
        pass
    assert not tel and ring.events == []


def test_null_telemetry_allocates_nothing():
    """Off, an emit and a span build no record: no allocation in the
    bus's module."""
    for _ in range(10):                 # warm any lazy state
        NULL_TELEMETRY.emit("epoch.stats", epoch=1)
        with NULL_TELEMETRY.span("phase.epoch", epoch=1):
            pass
    tracemalloc.start()
    snap0 = tracemalloc.take_snapshot()
    for i in range(1000):
        NULL_TELEMETRY.emit("epoch.stats", epoch=i)
        with NULL_TELEMETRY.span("phase.epoch"):
            pass
    snap1 = tracemalloc.take_snapshot()
    tracemalloc.stop()
    mine = [s for s in snap1.compare_to(snap0, "filename")
            if "runtime/telemetry.py" in str(s.traceback) and s.size_diff > 0]
    assert mine == []


def test_resolve_telemetry_forms(tmp_path):
    assert resolve_telemetry(None) is NULL_TELEMETRY
    tel = Telemetry([])
    assert resolve_telemetry(tel) is tel
    path = tmp_path / "x.jsonl"
    bus = resolve_telemetry(str(path))
    bus.emit("checkpoint.quarantine", step=3)
    bus.close()
    assert [e.kind for e in read_jsonl(str(path), validate=True)] == [
        "checkpoint.quarantine"]
    assert isinstance(resolve_telemetry(path).sinks[0], JSONLSink)
    sink = NullSink()
    assert resolve_telemetry(sink).sinks == [sink]
    with pytest.raises(TypeError):
        resolve_telemetry(3)


def test_ring_sink_keeps_the_newest():
    ring = RingSink(3)
    tel = Telemetry([ring])
    for s in range(5):
        tel.emit("checkpoint.quarantine", step=s)
    assert [e.fields["step"] for e in ring.events] == [2, 3, 4]
    assert tel.events() == ring.events


def test_spans_nest_per_thread_and_carry_errors():
    ring = RingSink(0)
    tel = Telemetry([ring], validate=True)

    def other():
        with tel.span("checkpoint.publish", step=9):
            pass

    with tel.span("phase.epoch", epoch=1):
        with tel.span("checkpoint.restore", step=4):
            th = threading.Thread(target=other)
            th.start()
            th.join()
    with pytest.raises(KeyError):
        with tel.span("phase.flush"):
            raise KeyError("x")
    evs = ring.events
    mine = [e for e in evs if e.tid == threading.get_ident()]
    theirs = [e for e in evs if e.tid != threading.get_ident()]
    ob, ib, ie, oe, fb, fe = mine
    assert ib.parent == ob.span and ob.parent is None
    assert (ie.span, oe.span) == (ib.span, ob.span)
    assert [e.parent for e in theirs] == [None, None]
    assert fe.fields["error"] == "KeyError" and fe.span == fb.span
    assert all(e.fields["seconds"] >= 0 for e in evs
               if e.kind == "span.end")


def test_jsonl_sink_appends_and_closes(tmp_path):
    path = str(tmp_path / "a.jsonl")
    for step in (1, 2):
        sink = JSONLSink(path)
        Telemetry([sink]).emit("checkpoint.quarantine", step=step)
        sink.close()
        sink.close()
    assert [e.fields["step"] for e in read_jsonl(path)] == [1, 2]


# ---------------------------------------------------------------------------
# On is bitwise off
# ---------------------------------------------------------------------------

def _count_stop_checks(monkeypatch):
    calls = []
    real = stop_ops.stopcheck

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(stop_ops, "stopcheck", counted)
    import repro_torch.core.kadabra as kadabra
    monkeypatch.setattr(kadabra, "stopcheck", counted)
    return calls


@pytest.mark.parametrize("lane", ["single", "sharded"])
def test_telemetry_on_is_bitwise_off(lane, tmp_path, monkeypatch):
    """The same scores, taus, epochs, levels and stop checks with the
    bus on as off; the trace holds one ``epoch.stats`` an epoch (and on
    the sharded lane one ``exchange.epoch`` with the epoch's tally) and
    ``run.end`` the result's numbers."""
    g = _er60()
    kw = dict(config=CFG, seed=3)
    if lane == "sharded":
        g = partition_graph(g, 4, block_v=16)
        kw["mesh"] = ShardMesh(4, CPU)
    else:
        kw["device"] = CPU
    checks = _count_stop_checks(monkeypatch)
    off = tc.run_adaptive(g, **kw)
    n_off = len(checks)
    ring = RingSink(0)
    on = tc.run_adaptive(g, telemetry=Telemetry([ring], validate=True),
                         **kw)
    assert len(checks) - n_off == n_off == off.n_epochs
    np.testing.assert_array_equal(on.reports[0].scores,
                                  off.reports[0].scores)
    assert (on.tau, on.n_epochs, on.bfs_levels) == (off.tau, off.n_epochs,
                                                    off.bfs_levels)
    assert [s.tau for s in on.stats] == [s.tau for s in off.stats]
    evs = ring.events
    start = evs[0]
    assert start.kind == "run.start" and start.fields["lane"] == lane
    stats = [e for e in evs if e.kind == "epoch.stats"]
    assert [e.fields["tau"] for e in stats] == [s.tau for s in on.stats]
    assert [e.fields["max_f"] for e in stats] == [list(s.max_f)
                                                 for s in on.stats]
    xch = [e.fields for e in evs if e.kind == "exchange.epoch"]
    if lane == "sharded":
        assert [{k: v for k, v in x.items() if k != "epoch"} for x in xch] \
            == [s.exchange for s in on.stats]
    else:
        assert xch == []
    assert evs[-1].kind == "run.end" and evs[-1].fields == {
        "tau": on.tau, "n_epochs": on.n_epochs, "converged": on.converged}
    spans = [e.fields["name"] for e in evs if e.kind == "span.end"]
    assert spans == ["phase.diameter", "phase.calibration"] + [
        "phase.epoch"] * on.n_epochs


def test_flush_span_when_the_epoch_cap_stops_the_run():
    ring = RingSink(0)
    tc.run_adaptive(_er60(), config=CFG, seed=3, device=CPU,
                    telemetry=Telemetry([ring], validate=True))
    ring2 = RingSink(0)
    res = tc.run_kadabra(_er60(), config=AdaptiveConfig(
        eps=0.1, n0_base=60, max_epochs=1), seed=3, device=CPU,
        telemetry=Telemetry([ring2], validate=True))
    names = [e.fields["name"] for e in ring2.events if e.kind == "span.end"]
    assert names[-1] == "phase.flush" and not res.converged
    assert "phase.flush" not in [e.fields["name"] for e in ring.events
                                 if e.kind == "span.end"]


# ---------------------------------------------------------------------------
# The checkpoint store's events
# ---------------------------------------------------------------------------

def _leaves():
    return (torch.arange(8.0), np.int64(3))


def test_checkpoint_publish_restore_quarantine_events(tmp_path):
    ring = RingSink(0)
    tel = Telemetry([ring], validate=True)
    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root, keep=0, save_every=1, telemetry=tel)
    main = threading.get_ident()
    for step in (1, 2):
        mgr.maybe_save(step, _leaves())
        mgr.wait()
    pubs = [e for e in ring.events if e.kind == "checkpoint.publish"]
    assert [(e.fields["step"], e.fields["ok"]) for e in pubs] == [
        (1, True), (2, True)]
    assert all(e.tid != main for e in pubs)
    spans = [e for e in ring.events if e.kind == "span.begin"]
    assert [e.fields["name"] for e in spans] == ["checkpoint.publish"] * 2
    assert corrupt_newest_step(root) is not None
    ring2 = RingSink(0)
    tel2 = Telemetry([ring2], validate=True)
    _, step, _ = restore(root, _leaves(), device=CPU, telemetry=tel2)
    assert step == 1
    got = [(e.kind, e.fields.get("step"), e.fields.get("ok"))
           for e in ring2.events if not e.kind.startswith("span")]
    assert got == [("checkpoint.restore", 2, False),
                   ("checkpoint.quarantine", 2, None),
                   ("checkpoint.restore", 1, True)]
    ring3 = RingSink(0)
    restore_arrays(root, step=1, telemetry=Telemetry([ring3]))
    assert [e.fields["ok"] for e in ring3.events
            if e.kind == "checkpoint.restore"] == [True]


def test_checkpoint_publish_failure_emits_an_error_event(tmp_path):
    ring = RingSink(0)
    tel = Telemetry([ring], validate=True)

    def hook(phase, step, i):
        if phase == "manifest":
            raise OSError("disk full")

    install_publish_fault_hook(hook)
    try:
        with pytest.raises(OSError):
            save(str(tmp_path / "ck"), 1, _leaves(), telemetry=tel)
    finally:
        install_publish_fault_hook(None)
    ev = [e for e in ring.events if e.kind == "checkpoint.publish"][0]
    assert ev.fields["ok"] is False and ev.fields["error"] == "OSError"
    end = [e for e in ring.events if e.kind == "span.end"][0]
    assert end.fields["error"] == "OSError"


# ---------------------------------------------------------------------------
# The tools
# ---------------------------------------------------------------------------

def test_trace_report_reads_a_port_trace(tmp_path):
    """``tools/trace_report.py`` gives a port run's exact tau and epoch
    count from its JSONL alone, in process and as a command."""
    path = str(tmp_path / "run.jsonl")
    res = tc.run_kadabra(_er60(), config=CFG, seed=3, device=CPU,
                         checkpoint_dir=str(tmp_path / "ck"),
                         telemetry=path)
    events = read_jsonl(path, validate=True)
    s = trace_report.summarize(events)
    assert (s["end"]["tau"], s["end"]["n_epochs"]) == (res.tau,
                                                       res.n_epochs)
    assert len(s["epochs"]) == res.n_epochs
    assert s["start"]["lane"] == "single"
    chrome = str(tmp_path / "t.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(TOOLS, "..", "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "trace_report.py"), path,
         "--validate", "--chrome", chrome], env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"tau={res.tau}" in out.stdout
    assert f"epochs={res.n_epochs}" in out.stdout
    with open(chrome) as f:
        assert json.load(f)["traceEvents"]


def test_write_chrome_trace_of_a_run(tmp_path):
    ring = RingSink(0)
    tc.run_adaptive(_er60(), config=CFG, seed=3, device=CPU,
                    telemetry=Telemetry([ring]))
    path = write_chrome_trace(str(tmp_path / "c.json"), ring.events)
    with open(path) as f:
        rows = json.load(f)["traceEvents"]
    assert {r["ph"] for r in rows} == {"X", "i"}
    assert sum(r["name"] == "phase.epoch" for r in rows) == sum(
        e.kind == "epoch.stats" for e in ring.events)


def test_torch_profiler_trace_writes_a_chrome_trace(tmp_path):
    with torch_profiler_trace(None) as path:
        assert path is None
    logdir = str(tmp_path / "prof")
    with torch_profiler_trace(logdir) as path:
        tc.run_kadabra(_er60(), eps=0.2, seed=3, device=CPU)
    assert os.path.dirname(path) == logdir
    with open(path) as f:
        doc = json.load(f)
    assert any(r.get("name", "").startswith("aten::")
               for r in doc["traceEvents"])
