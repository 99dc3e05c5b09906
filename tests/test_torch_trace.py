"""The serve path's tracer (``core/trace.py``) on the CPU.

* Off, a stablelm-smoke serve run records nothing, reads no clock
  (``time.time_ns`` counted) and allocates nothing in the tracer.
* On, through the stand-in graph of ``test_torch_graphs.py``: every tick
  is one ``sched.tick`` tiled by ``sched.clients``, ``sched.dispatch``
  and ``sched.drain``; every decode tick one ``decode`` tiled by
  ``decode.admit``, ``decode.serve`` (one ``graph.launch`` inside),
  ``decode.read`` and ``decode.deliver``; every prefill one ``prefill``
  tiled by ``prefill.launch`` and ``prefill.read``; every prefilled
  request one ``queue_wait`` with the prefill's id, ending where the
  prefill starts; no ``graph.capture`` after warm-up.
* The clock: a ``torch.profiler`` annotation opened inside a span lies
  inside it on the profiler's timestamps.
* The buffer's cap drops and counts.
"""
import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core import plan as plan_mod, trace
from repro_torch.launch import model_serve as ms
from repro_torch.runtime import Device, Runtime

from test_torch_graphs import fake_graphs

torch.set_num_threads(2)

PROMPTS = ["1,2,3;4,5,6,7", "8,9;10,11,12", "13,14,15,16,17;18", "19,20"]
GENS = ["3;5", "4", "2;6", "5;1"]
DECODE_PARTS = ["decode.admit", "decode.serve", "decode.read",
                "decode.deliver"]


@pytest.fixture(autouse=True)
def _tracer_off():
    # a fresh span count: other test files of the same process (the
    # benchmark's traced runs) turn the tracer on and begin spans
    trace.disable()
    trace.drain()
    trace.TRACER._next = 0
    yield
    trace.disable()
    trace.drain()
    plan_mod.clear_executable_cache()


def _runtime():
    """A stablelm-smoke hub with 4 slots and 4 closed-loop clients."""
    rt = Runtime(device="cpu")
    hub = Device("hub", device="cpu")
    hub.add_pipeline(ms.serve_pipeline(slots=4, max_seq=32))
    rt.add_device(hub)
    for i, (p, g) in enumerate(zip(PROMPTS, GENS)):
        d = Device(f"c{i}", device="cpu")
        d.add_pipeline(ms.client_pipeline(prompts=p, gens=g))
        rt.add_device(d)
    return rt


def test_off_records_nothing_reads_no_clock(monkeypatch):
    rt = _runtime()
    rt.run(2)
    calls = []
    real = time.time_ns
    monkeypatch.setattr(time, "time_ns", lambda: calls.append(1) or real())
    tracemalloc.start()
    try:
        rt.run(6)
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, trace.__file__)])
    finally:
        tracemalloc.stop()
    (b,) = rt.batchers()
    assert b.decode_ticks >= 5 and b.prefills >= 4
    assert calls == []
    assert sum(s.size for s in snap.statistics("filename")) == 0
    assert trace.TRACER._next == 0
    assert trace.drain() == ([], [], [])


def _tiled(parent, kids, names):
    assert [k.name for k in kids] == names, (parent, kids)
    assert kids[0].t0_ns >= parent.t0_ns and kids[-1].t1_ns <= parent.t1_ns
    for a, b in zip(kids, kids[1:]):
        assert a.t1_ns == b.t0_ns, (a, b)


def test_on_spans_nest_tile_and_carry_request_ids(monkeypatch):
    fake_graphs(monkeypatch)
    rt = _runtime()
    rt.run(3)                       # first prefills, eager tick, capture
    trace.enable()
    ticks = []
    for _ in range(8):
        rt.tick()
        ticks.append(trace.drain())
    trace.disable()
    n_decode = n_prefill = 0
    for spans, waits, counts in ticks:
        by_id = {s.sid: s for s in spans}
        kids = {}
        for s in spans:
            assert s.t0_ns <= s.t1_ns
            kids.setdefault(s.parent, []).append(s)
        for v in kids.values():
            v.sort(key=lambda s: s.t0_ns)
        (top,) = kids[-1]
        assert top.name == "sched.tick"
        _tiled(top, kids[top.sid], ["sched.clients", "sched.dispatch",
                                    "sched.drain"])
        assert not [s for s in spans if s.name == "graph.capture"]
        prefills = {}
        for s in spans:
            p = by_id.get(s.parent)
            if p is not None:
                assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, (p, s)
            if s.name == "decode":
                n_decode += 1
                assert by_id[s.parent].name == "sched.drain"
                parts = kids[s.sid]
                _tiled(s, parts, DECODE_PARTS)
                launch = kids.get(parts[1].sid, [])
                assert [k.name for k in launch] == ["graph.launch"]
                assert all(not kids.get(k.sid) for k in (parts[0], parts[2],
                                                         parts[3]))
            elif s.name == "prefill":
                n_prefill += 1
                _tiled(s, kids[s.sid], ["prefill.launch", "prefill.read"])
                assert s.rid is not None and s.rid not in prefills
                prefills[s.rid] = s
        assert len(waits) == len(prefills)
        for w in waits:
            assert w.kind == "queue_wait"
            assert w.t0_ns <= w.t1_ns == prefills[w.rid].t0_ns
        assert counts == []         # a dense model records no counter
    assert n_decode == 8 and n_prefill >= 4
    assert trace.TRACER.dropped == 0


def test_graph_capture_recorded_in_warm_up(monkeypatch):
    fake_graphs(monkeypatch)
    rt = _runtime()
    trace.enable()
    rt.run(3)
    spans, _, _ = trace.drain()
    names = {s.sid: s.name for s in spans}
    under = [s.name for s in spans if names.get(s.parent) == "decode.serve"]
    # the decode tick's binding: an eager first call, then a capture, then
    # replays (spans in the order they end)
    n = [s.name for s in spans].count("decode")
    assert n == 3
    assert under == ["graph.launch", "graph.capture"] + \
        ["graph.launch"] * (n - 1)


def test_profiler_annotation_lies_inside_the_span():
    """The span's stamps and the profiler's timestamps share one clock."""
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            sp = trace.TRACER.begin("outer")
            with record_function("inner"):
                torch.ones(64).sum()
            trace.TRACER.end(sp)
    trace.disable()
    spans, _, _ = trace.drain()
    inner = sorted((int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == "inner")
    assert len(inner) == len(spans) == 20
    for s, (a, b) in zip(sorted(spans, key=lambda s: s.t0_ns), inner):
        assert s.t0_ns <= a <= b <= s.t1_ns, (s, a, b)


def test_cap_drops_and_counts():
    tr = trace.Tracer(cap=5)
    for i in range(4):
        tr.end(tr.begin("x", i))
    tr.wait("queue_wait", 9, 1, 2)
    tr.wait("queue_wait", 10, 1, 2)
    tr.end(tr.begin("y"))
    assert len(tr.spans) == 4 and len(tr.waits) == 1 and tr.dropped == 2
    spans, waits, counts = tr.drain()
    assert [s.rid for s in spans] == [0, 1, 2, 3] and waits[0].rid == 9
    assert counts == []
    tr.end(tr.begin("z"))
    assert [s.name for s in tr.spans] == ["z"] and tr.dropped == 2
