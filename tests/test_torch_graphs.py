"""The port's CUDA-graph helper (``core/graphs.py``): its host logic on the
CPU, its whole call flow on the CPU through a stand-in graph, and on the
card (``cuda`` tests) the real graphs.

* Binding keys: params and donated state by address, args by shape, host
  leaves by value.
* The copy-back plan: rebound state leaves are copied into the caller's
  leaves, aliasing (a swap, a view) is broken first, a leaf kept in place
  needs nothing, and a changed shape or dtype raises.
* Output cloning: outputs that alias the state are detached, and every
  replay's outputs are fresh tensors.
* ``_resolve_donate``: on when the card is the default device.
* ``EagerGraph`` stands in for ``torch.cuda.CUDAGraph`` on the CPU: its
  capture runs the body once (a real capture records it and the first
  replay runs it), each later replay runs the body again into the same
  static tensors and leaves the kernel counters as a real replay does, so
  a call's first eager run, capture, replays, write-back, donation and
  launch accounting are all exercised here.  The other ``test_torch_*``
  files import it to run whole runtimes through the graph path.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import graphs, parse_launch, plan as plan_mod
from repro_torch.core.buffers import StreamBuffer, tree_flatten
from repro_torch.core.elements import TensorTransform
from repro_torch.core.graphs import (GraphCaptureError, GraphedCallable,
                                     binding_key, detach_outputs, write_back)
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels import quant8

torch.set_num_threads(2)


class EagerGraph:
    """CPU stand-in for a CUDA graph (module docstring)."""

    def __init__(self, device=None):
        self.body = None
        self.static = None
        self.fresh = False
        self.resets = 0

    def capture(self, body):
        self.body = body
        self.static = body()
        self.fresh = True
        return self.static

    def replay(self):
        if self.fresh:          # the capture's run is this first replay
            self.fresh = False
            return
        snap = graphs.counter_snapshot()
        new = self.body()
        graphs.counter_restore(snap)
        for i in (0, 2):        # out leaves, next-state leaves
            for s, n in zip(self.static[i], new[i]):
                if isinstance(s, torch.Tensor) and s is not n:
                    s.copy_(n)

    def reset(self):
        self.resets += 1


def fake_graphs(monkeypatch, donate=None):
    """Every cached executable made from here on takes the graph path on
    the CPU through :class:`EagerGraph`; ``donate`` overrides what
    ``donate=None`` resolves to."""
    plan_mod.clear_executable_cache()
    monkeypatch.setattr(plan_mod, "GraphedCallable", functools.partial(
        GraphedCallable, graph_factory=EagerGraph))
    if donate is not None:
        orig = ExecutionPlan._resolve_donate
        monkeypatch.setattr(ExecutionPlan, "_resolve_donate", staticmethod(
            lambda d: donate if d is None else orig(d)))


def _counter_fn(params, state, x):
    """A step with an in-place leaf (``acc``), a rebound leaf (``n``), an
    output that is a state leaf (``acc``) and one that is the old value of
    a rebound leaf (``n``), plus two counted launches."""
    quant8.LAUNCHES["quantize8"] += 2
    acc, n = state["acc"], state["n"]
    acc.add_(x * params["w"])
    out = {"acc": acc, "n_old": n, "y": x * 2}
    return out, {"acc": acc, "n": n + 1}


def _fresh():
    return ({"w": torch.tensor([2.0, 3.0])},
            {"acc": torch.zeros(2), "n": torch.zeros((), dtype=torch.int32)})


# ---------------------------------------------------------------------------
# host logic
# ---------------------------------------------------------------------------

def test_binding_key_addresses_shapes_and_host_values():
    params, state = _fresh()
    x = torch.ones(2)
    base = binding_key(params, state, (x,), {}, donate=True)
    assert binding_key(params, state, (torch.zeros(2),), {}, True) == base
    _, other_state = _fresh()
    # another pipeline's state: its own binding when donated (the graph
    # updates the state where it was captured), the same one when copied in
    assert binding_key(params, other_state, (x,), {}, True) != base
    assert binding_key(params, other_state, (x,), {}, False) == \
        binding_key(params, state, (x,), {}, False)
    other_params, _ = _fresh()
    assert binding_key(other_params, state, (x,), {}, True) != base
    assert binding_key(params, state, (torch.ones(3),), {}, True) != base
    assert binding_key(params, state, (x,), {"n": 3}, True) != \
        binding_key(params, state, (x,), {"n": 4}, True)
    b1 = StreamBuffer(tensors=(x,), pts=1)
    b2 = StreamBuffer(tensors=(x,), pts=2)
    assert binding_key(params, state, (b1,), {}, True) != \
        binding_key(params, state, (b2,), {}, True)
    assert binding_key(params, state, (np.arange(3),), {}, True) != \
        binding_key(params, state, (np.arange(3) + 1,), {}, True)


def test_write_back_copies_rebound_leaves_and_breaks_aliasing():
    a, b, c = torch.tensor([1.0]), torch.tensor([2.0]), torch.tensor([3.0])
    kept, rebound = c, torch.tensor([9.0])
    # a and b swap, c is kept, the fourth is rebound
    d = torch.tensor([4.0])
    write_back([a, b, kept, d], [b, a, kept, rebound])
    assert (a.item(), b.item(), kept.item(), d.item()) == (2.0, 1.0, 3.0,
                                                           9.0)
    # a rebound leaf that is a view of another state leaf
    s = torch.arange(4.0)
    t = torch.zeros(2)
    write_back([s, t], [s, s[1:3]])
    assert t.tolist() == [1.0, 2.0]
    with pytest.raises(GraphCaptureError):
        write_back([torch.zeros(2)], [torch.zeros(3)])
    with pytest.raises(GraphCaptureError):
        write_back([torch.zeros(2)], [torch.zeros(2, dtype=torch.int32)])
    with pytest.raises(GraphCaptureError):
        write_back([torch.zeros(2)], [torch.zeros(2), 1])


def test_detach_outputs_clones_only_what_aliases_the_state():
    s = torch.zeros(3)
    fresh = torch.ones(3)
    out = detach_outputs([s, s[1:], fresh, 7], [s])
    assert out[0] is not s and torch.equal(out[0], s)
    assert out[1].untyped_storage().data_ptr() != \
        s.untyped_storage().data_ptr()
    assert out[2] is fresh and out[3] == 7


def test_resolve_donate_follows_the_default_device():
    assert ExecutionPlan._resolve_donate(None) == torch.cuda.is_available()
    assert ExecutionPlan._resolve_donate(True) is True
    assert ExecutionPlan._resolve_donate(False) is False


def test_divisor_is_filled_on_the_device_with_the_same_value():
    for dt in (torch.float32, torch.bfloat16, torch.float64, torch.uint8):
        x = torch.zeros(2, dtype=dt)
        for arg in ("127.5", "255.0", "3", "0.1"):
            got = TensorTransform._divisor(x, arg)
            want_dt = dt if dt.is_floating_point else torch.float32
            want = torch.tensor(float(arg), dtype=want_dt)
            assert got.dtype == want.dtype and got.shape == ()
            assert torch.equal(got.view(-1).view(torch.uint8),
                               want.view(-1).view(torch.uint8))


# ---------------------------------------------------------------------------
# the call flow, through the stand-in graph
# ---------------------------------------------------------------------------

def _eager_run(calls):
    params, state = _fresh()
    outs = []
    for k in range(calls):
        o, state = _counter_fn(params, state, torch.full((2,), float(k)))
        outs.append({n: v.clone() for n, v in o.items()})
    return outs, state


@pytest.mark.parametrize("donate", [True, False])
def test_graphed_calls_equal_eager_calls(donate):
    calls = 5
    want, want_state = _eager_run(calls)
    quant8.reset_launches()
    fn = GraphedCallable(_counter_fn, donate, graph_factory=EagerGraph)
    params, state = _fresh()
    acc0, n0 = state["acc"], state["n"]
    outs = []
    for k in range(calls):
        caller = state
        o, state = fn(params, state, torch.full((2,), float(k)))
        outs.append(o)
        if donate:
            # the caller's own leaves, updated in place
            assert state["acc"] is acc0 and state["n"] is n0
        else:
            assert caller["acc"] is not state["acc"]
    assert fn.captures == 1 and fn.graphs() == 1
    for o, w in zip(outs, want):
        for name in w:
            assert torch.equal(o[name], w[name]), name
    assert torch.equal(state["acc"], want_state["acc"])
    assert torch.equal(state["n"], want_state["n"])
    # two replays' outputs are distinct tensors, not the graph's buffers
    assert outs[3]["y"].data_ptr() != outs[4]["y"].data_ptr()
    assert outs[3]["acc"].data_ptr() != outs[4]["acc"].data_ptr()
    # launch counts: the capture counted nothing, every call counted 2
    assert quant8.LAUNCHES["quantize8"] == 2 * calls


def test_undonated_calls_leave_the_callers_state_untouched():
    fn = GraphedCallable(_counter_fn, False, graph_factory=EagerGraph)
    params, state = _fresh()
    for k in range(3):
        fn(params, state, torch.ones(2))
    assert torch.equal(state["acc"], torch.zeros(2))
    assert int(state["n"]) == 0


def test_a_failed_capture_raises_and_restores_the_counters():
    class Refuses(EagerGraph):
        def capture(self, body):
            body()          # runs into what a capture would refuse
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    quant8.reset_launches()
    fn = GraphedCallable(_counter_fn, True, graph_factory=Refuses)
    params, state = _fresh()
    fn(params, state, torch.ones(2))
    assert quant8.LAUNCHES["quantize8"] == 2
    with pytest.raises(GraphCaptureError):
        fn(params, state, torch.ones(2))
    assert quant8.LAUNCHES["quantize8"] == 2
    assert fn.graphs() == 0


def test_bindings_are_lru_capped_and_release_frees_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "MAX_BINDINGS", 2)
    made = []

    def factory(dev):
        made.append(EagerGraph(dev))
        return made[-1]
    fn = GraphedCallable(_counter_fn, True, graph_factory=factory)
    runs = [_fresh() for _ in range(3)]
    for params, state in runs:            # two calls each: one capture each
        for _ in range(2):
            _, state = fn(params, state, torch.ones(2))
    assert len(made) == 3 and fn.graphs() == 2
    assert made[0].resets == 1            # the oldest binding was evicted
    fn.release()
    assert fn.graphs() == 0 and all(g.resets == 1 for g in made)


def test_a_state_that_changes_structure_is_returned_as_is():
    def grows(params, state):
        return {}, {**state, "extra": torch.zeros(1)}

    fn = GraphedCallable(grows, True, graph_factory=EagerGraph)
    params, state = _fresh()
    _, nxt = fn(params, state)
    assert sorted(nxt) == ["acc", "extra", "n"]
    with pytest.raises(GraphCaptureError):   # the same donated state again
        fn(params, state)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("donate", [True, False])
def test_cuda_graph_calls_equal_eager_calls(cuda, donate):
    calls = 5
    want, want_state = _eager_run(calls)
    quant8.reset_launches()
    fn = GraphedCallable(_counter_fn, donate)
    params, state = _fresh()
    params = {k: v.to(cuda) for k, v in params.items()}
    state = {k: v.to(cuda) for k, v in state.items()}
    outs = []
    for k in range(calls):
        o, state = fn(params, state, torch.full((2,), float(k), device=cuda))
        outs.append(o)
    assert fn.captures == 1 and fn.graphs() == 1
    for o, w in zip(outs, want):
        for name in w:
            assert torch.equal(o[name].cpu(), w[name]), name
    assert torch.equal(state["n"].cpu(), want_state["n"])
    assert outs[3]["y"].data_ptr() != outs[4]["y"].data_ptr()
    assert quant8.LAUNCHES["quantize8"] == 2 * calls
    fn.release()


@pytest.mark.cuda
def test_cuda_capture_of_a_host_sync_raises(cuda):
    def syncs(params, state, x):
        if x.sum().item() > 0:          # a host read of a device value
            x = x * 2
        return {"y": x}, state

    fn = GraphedCallable(syncs, True)
    x = torch.ones(4, device=cuda)
    fn({}, {}, x)                        # the eager first call is fine
    with pytest.raises(GraphCaptureError):
        fn({}, {}, x)
    # the card works on after the refused capture
    assert torch.equal((x + 1).cpu(), torch.full((4,), 2.0))


@pytest.mark.cuda
def test_cuda_compiled_step_equals_step(cuda):
    desc = ("testsrc width=8 height=8 ! tensor_converter ! tensor_transform "
            "mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_sparse_enc max_nnz=64 ! tensor_sparse_dec ! appsink name=o")
    pipe = parse_launch(desc).realize()
    params, s_eager = pipe.init(None, cuda), pipe.init_state(cuda)
    s_graph = pipe.init_state(cuda)
    step = pipe.compiled_step()
    for k in range(4):
        o1, s_eager = pipe.step(params, s_eager)
        o2, s_graph = step(params, s_graph)
        assert torch.equal(o1["o"].tensor, o2["o"].tensor), k
        assert int(o1["o"].pts) == int(o2["o"].pts)
    assert step.graphs() == 1
    leaves1, _ = tree_flatten(s_eager)
    leaves2, _ = tree_flatten(s_graph)
    assert all(torch.equal(a, b) for a, b in zip(leaves1, leaves2))


# ---------------------------------------------------------------------------
# whole runtimes through the graph path: the four kinds of entry
# ---------------------------------------------------------------------------

def _launches():
    from repro_torch.kernels import (flash_attn, rglru_scan, sparse_dec,
                                     sparse_enc)
    return {**flash_attn.LAUNCHES, **quant8.LAUNCHES, **sparse_enc.LAUNCHES,
            **sparse_dec.LAUNCHES, **rglru_scan.LAUNCHES}


def _reset_launches():
    from repro_torch.kernels import (flash_attn, rglru_scan, sparse_dec,
                                     sparse_enc)
    for mod in (flash_attn, quant8, sparse_enc, sparse_dec, rglru_scan):
        mod.reset_launches()


def _serve_run(device, jit, model):
    """A serve pipeline and 4 clients of 2 streams each -> answers."""
    from repro_torch.launch import model_serve as ms
    from repro_torch.runtime import Device, Runtime
    rt = Runtime(device=device)
    hub = Device("hub", device=device)
    hub.add_pipeline(ms.serve_pipeline(model=model, slots=4, max_seq=48),
                     jit=jit)
    rt.add_device(hub)
    runs = []
    for i in range(4):
        dev = Device(f"tv{i}", device=device)
        runs.append(dev.add_pipeline(ms.client_pipeline(
            prompts=f"{i + 1},{i + 2},{i + 3};{i + 5},{i + 1}",
            gens="6;9"), jit=jit))
        rt.add_device(dev)
        rt.tick()
    rt.run(24)
    return [[b.tensor.tolist() for b in r.sink_log["res"]] for r in runs]


def _burst_run(device, jit):
    """A quant8 publisher and a subscriber that is held for 3 ticks of
    every 4, so each of its steps drains the same 4-frame burst ->
    republished payloads."""
    from repro_torch.core.elements import register_model
    from repro_torch.core import TensorSpec
    from repro_torch.runtime import Device, Runtime
    register_model("tg_gate", lambda g, dev: {"w": torch.full(
        (16, 16), 0.05, device=dev)}, lambda p, x: x * torch.sigmoid(
        x @ p["w"]), out_specs=(TensorSpec((1, 8, 16), "float32"),))
    rt = Runtime(burst=8, device=device)
    pub = Device("pub", device=device)
    pub.add_pipeline(parse_launch(
        "testsrc width=8 height=1 channels=16 ! tensor_converter ! "
        "tensor_transform mode=arithmetic option=typecast:float32,div:64.0 "
        "! mqttsink pub-topic=act codec=quant8"), jit=jit)
    rt.add_device(pub)
    sub = Device("sub", device=device)
    sp = parse_launch("mqttsrc sub-topic=act codec=quant8 ! tensor_filter "
                      "model=tg_gate ! mqttsink pub-topic=out codec=quant8 "
                      "name=snk")
    run = sub.add_pipeline(sp, jit=jit)
    rt.add_device(sub)
    seen, push = [], sp.elements["snk"].channel.push
    sp.elements["snk"].channel.push = \
        lambda buf, nbytes=None: seen.append(buf) or push(buf, nbytes)
    for t in range(16):
        run.retired = t % 4 != 3
        rt.tick()
    assert run.bursts == 4 and run.burst_frames == 16
    return [tree_flatten(b.tensors)[0] for b in seen]


def _step_run(device, jit):
    """A pure pipeline stepped by the runtime -> its sink log."""
    from repro_torch.runtime import Device, Runtime
    rt = Runtime(device=device)
    d = Device("cam", device=device)
    run = d.add_pipeline(parse_launch(
        "testsrc width=8 height=2 ! tensor_converter ! tensor_transform "
        "mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
        "appsink name=o"), jit=jit)
    rt.add_device(d)
    rt.run(5)
    return [[b.tensor, b.pts] for b in run.sink_log["o"]]


def _offload_run(device, jit):
    """4 quant8 clients of one server: graphed client segments and fused
    serve batches -> answers."""
    from repro_torch.runtime import Device, Runtime
    rt = Runtime(device=device)
    hub = Device("hub", device=device)
    ps = parse_launch("tensor_query_serversrc operation=op name=ssrc ! "
                      "tensor_transform mode=arithmetic option=add:0.25,"
                      "mul:2.0 ! tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    hub.add_pipeline(ps, jit=jit)
    rt.add_device(hub)
    runs = []
    for i in range(4):
        dev = Device(f"tv{i}", device=device)
        runs.append(dev.add_pipeline(parse_launch(
            f"testsrc width=64 height=1 channels=128 ! tensor_converter ! "
            f"tensor_transform mode=arithmetic option=typecast:float32,"
            f"add:-127.5,div:128.0,mul:{1 + i / 8} ! tensor_query_client "
            f"operation=op codec=quant8 name=qc ! appsink name=res"),
            jit=jit))
        rt.add_device(dev)
    rt.run(4)
    return [[b.tensor for b in r.sink_log["res"]] for r in runs]


SCENARIOS = {
    "serve tick": lambda dev, jit: _serve_run(dev, jit, "stablelm-smoke"),
    "rglru serve tick": lambda dev, jit: _serve_run(
        dev, jit, "recurrentgemma-smoke"),
    "burst": _burst_run,
    "step": _step_run,
    "segments + fused batch": _offload_run,
}


def _assert_same(a, b, label):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), label
        for x, y in zip(a, b):
            _assert_same(x, y, label)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), label
    else:
        assert a == b, label


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_runtime_through_graphs_equals_eager(name, monkeypatch):
    """Each kind of entry, on the CPU through the stand-in graph with the
    state donated, is bitwise the same scenario at ``jit=False``."""
    eager = SCENARIOS[name]("cpu", False)
    fake_graphs(monkeypatch, donate=True)
    graphed = SCENARIOS[name]("cpu", True)
    _assert_same(graphed, eager, name)
    info = plan_mod.executable_cache_info()
    assert info["graphs"] >= 1, info
    plan_mod.clear_executable_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_cuda_runtime_graphs_equal_eager(cuda, name):
    """On the card: each kind of entry's CUDA graphs bitwise the eager
    route, with the same kernel launch counts, and graphs captured."""
    _reset_launches()
    eager = SCENARIOS[name]("cuda", False)
    eager_launches = _launches()
    plan_mod.clear_executable_cache()
    _reset_launches()
    before = graphs.graph_stats()["captured"]
    graphed = SCENARIOS[name]("cuda", True)
    torch.cuda.synchronize()
    assert _launches() == eager_launches
    assert graphs.graph_stats()["captured"] > before
    _assert_same(graphed, eager, name)
    plan_mod.clear_executable_cache()
