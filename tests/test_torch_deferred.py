"""Compiled deferred segments on the CPU: the port's
``run_deferred_compiled`` and compiled-mode ``PendingQuery.resume``
against its interpreted ``run_deferred`` and the JAX package's, and the
runtime's codec clients (whose segments run compiled on the fused wire
path) against the eager wire path, against the graph path (the stand-in
graph of ``test_torch_graphs.py``, state donated) and against the JAX
runtime.

Every model here is exact arithmetic (a power-of-two division, adds and
multiplies that cannot contract into an FMA), so the two packages agree
bitwise on answers as well as on request payloads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parse_launch as jparse
from repro.core.plan import PendingQuery as JPending
from repro.runtime import Device as JDevice
from repro.runtime import Runtime as JRuntime
from repro_torch.core import parse_launch
from repro_torch.core.buffers import tree_flatten
from repro_torch.core.plan import (_EXEC_CACHE, PendingQuery,
                                   clear_executable_cache)
from repro_torch.runtime import Device, Runtime
from test_torch_graphs import fake_graphs

torch.set_num_threads(2)

#: a client that pauses twice, with a value (the tee's second branch) live
#: across both pauses
TWO_CLIENTS = """
    testsrc width=8 height=1 channels=16 ! tensor_converter !
      tensor_transform mode=arithmetic option=typecast:float32,div:2.0 !
      tee name=t
    t. ! tensor_query_client operation=a name=qa !
      tensor_transform mode=arithmetic option=mul:3.0 !
      tensor_query_client operation=b name=qb ! mux.sink_0
    t. ! queue ! mux.sink_1
    tensor_mux name=mux ! appsink name=o
"""


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _answer(req, k):
    """The synthetic server: one exact op on the request."""
    return req.with_(tensors=tuple(t * 2.0 + float(k) for t in req.tensors))


def _walk(plan, params, state, compiled, pending_type):
    """One frame, answering every pause -> (requests, outputs, state)."""
    res = (plan.run_deferred_compiled(params, state) if compiled
           else plan.run_deferred(params, state))
    requests, k = [], 0
    while isinstance(res, pending_type):
        requests.append(res.request)
        res = res.resume(_answer(res.request, k))
        k += 1
    return requests, res[0], res[1]


def _frames(compiled, graphed=False, monkeypatch=None, n=3):
    if graphed:
        fake_graphs(monkeypatch, donate=True)
    pipe = parse_launch(TWO_CLIENTS).realize()
    assert pipe.plan.deferred_compilable
    assert pipe.plan.client_idxs == tuple(
        i for i, op in enumerate(pipe.plan.ops)
        if op.name in ("qa", "qb"))
    params, st = pipe.init(None, "cpu"), pipe.init_state("cpu")
    frames = []
    for _ in range(n):
        reqs, outs, st = _walk(pipe.plan, params, st, compiled, PendingQuery)
        frames.append((reqs, outs))
    return frames, st


def _jax_frames(compiled, n=3):
    pipe = jparse(TWO_CLIENTS).realize()
    params, st = pipe.init(jax.random.PRNGKey(0)), pipe.init_state()
    frames = []
    for _ in range(n):
        reqs, outs, st = _walk(pipe.plan, params, st, compiled, JPending)
        frames.append((reqs, outs))
    return frames, st


def _leaves(tree):
    """Leaves of a port tree (torch tensors) or of a JAX pytree."""
    leaves, _ = tree_flatten(tree)
    if any(isinstance(l, torch.Tensor) for l in leaves):
        return leaves
    return jax.tree_util.tree_leaves(tree)


def _same(a, b, label):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), label
    for x, y in zip(la, lb):
        x, y = _np(x), _np(y)
        if x.dtype != y.dtype:          # pts: int64 in the port, int32 in JAX
            x, y = x.astype(np.int64), y.astype(np.int64)
        np.testing.assert_array_equal(x, y, err_msg=label)


@pytest.mark.parametrize("graphed", [False, True])
def test_compiled_segments_match_the_interpreted_walk(graphed, monkeypatch):
    got, st = _frames(compiled=True, graphed=graphed,
                      monkeypatch=monkeypatch)
    want, wst = _frames(compiled=False)
    jgot, jst = _jax_frames(compiled=True)
    jwant, _ = _jax_frames(compiled=False)
    for k, ((r1, o1), (r2, o2), (r3, o3), (r4, o4)) in enumerate(
            zip(got, want, jgot, jwant)):
        assert len(r1) == len(r2) == len(r3) == len(r4) == 2
        for a, b in zip(r1, r2):
            _same(a, b, f"frame {k} request")
        for a, b in zip(r1, r3):
            _same(a, b, f"frame {k} request vs JAX")
        _same(o1, o2, f"frame {k} outputs")
        _same(o1, o3, f"frame {k} outputs vs JAX compiled")
        _same(o1, o4, f"frame {k} outputs vs JAX interpreted")
    _same(st, wst, "state")
    _same(st, jst, "state vs JAX")


def test_compiled_pending_query_carries_only_live_slots():
    pipe = parse_launch(TWO_CLIENTS).realize()
    plan = pipe.plan
    params, st = pipe.init(None, "cpu"), pipe.init_state("cpu")
    pq = plan.run_deferred_compiled(params, st)
    assert pq.is_compiled and pq.client.name == "qa"
    assert len(pq.live) == len(plan._live_slots(plan.client_idxs[0])) == 1
    pq = pq.resume(_answer(pq.request, 0))
    assert isinstance(pq, PendingQuery) and pq.client.name == "qb"
    assert len(pq.live) == len(plan._live_slots(plan.client_idxs[1])) == 1
    assert plan._next_client(plan.client_idxs[1]) is None


# ---------------------------------------------------------------------------
# the runtime: 4 codec clients
# ---------------------------------------------------------------------------

CLIENTS, TICKS = 4, 3
TRANSFORMS = {
    "quant8": "typecast:float32,add:-127.5,div:128.0,mul:{m}",
    "sparse:0.25": "typecast:float32,add:-230,clamp:0:25,mul:{m}",
}
SERVER = ("tensor_query_serversrc operation=op name=ssrc ! "
          "tensor_transform mode=arithmetic option=add:0.25,mul:2.0 ! "
          "tensor_query_serversink name=ssink")


def _client_desc(codec, i):
    opt = TRANSFORMS[codec].format(m=1 + i / 8)
    return (f"testsrc width=40 height=1 channels=160 ! tensor_converter ! "
            f"tensor_transform mode=arithmetic option={opt} ! "
            f"tensor_query_client operation=op codec={codec} name=qc ! "
            f"appsink name=res")


def _spy(endpoint):
    seen = []
    push = endpoint.requests.push

    def spy(buf, nbytes=None):
        seen.append((nbytes, buf))
        return push(buf, nbytes)
    endpoint.requests.push = spy
    return seen


def _port(codec, jit=True, **kw):
    rt = Runtime(device="cpu", **kw)
    hub = Device("hub", device="cpu")
    ps = parse_launch(SERVER)
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    hub.add_pipeline(ps, jit=jit)
    rt.add_device(hub)
    seen = _spy(ps.elements["ssrc"].endpoint)
    runs = []
    for i in range(CLIENTS):
        dev = Device(f"tv{i}", device="cpu")
        runs.append(dev.add_pipeline(parse_launch(_client_desc(codec, i)),
                                     jit=jit))
        rt.add_device(dev)
    rt.run(TICKS)
    return [[b for b in r.sink_log["res"]] for r in runs], seen


def _jax(codec):
    rt = JRuntime()
    hub = JDevice("hub")
    ps = jparse(SERVER)
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    hub.add_pipeline(ps)
    rt.add_device(hub)
    seen = _spy(ps.elements["ssrc"].endpoint)
    runs = []
    for i in range(CLIENTS):
        dev = JDevice(f"tv{i}")
        runs.append(dev.add_pipeline(jparse(_client_desc(codec, i))))
        rt.add_device(dev)
    rt.run(TICKS)
    return [[b for b in r.sink_log["res"]] for r in runs], seen


def _meta(buf):
    """A request's meta less its ``client_id`` (a process-wide counter)."""
    return {k: v for k, v in buf.meta.items() if k != "client_id"}


def _payload_leaves(buf):
    return [l for l in tree_flatten(buf.tensors)[0]]


def _jax_payload_leaves(buf):
    return jax.tree_util.tree_leaves(buf.tensors)


@pytest.mark.parametrize("codec", sorted(TRANSFORMS))
def test_codec_clients_fused_eager_graphed_and_jax_agree(codec,
                                                         monkeypatch):
    clear_executable_cache()
    runs = {"fused": _port(codec)}
    segs = [k for e in _EXEC_CACHE.values() for k in e["fns"]
            if k[0] == "defer_seg"]
    assert len(segs) == 2 * CLIENTS     # each client's two segments ran
    runs["eager"] = _port(codec, fused_wire=False)
    runs["no jit"] = _port(codec, jit=False)
    fake_graphs(monkeypatch, donate=True)
    runs["graphed"] = _port(codec)
    janswers, jseen = _jax(codec)
    ref_answers, ref_seen = runs["fused"]
    for label, (answers, seen) in runs.items():
        assert len(seen) == CLIENTS * TICKS
        for (n, buf), (n0, buf0) in zip(seen, ref_seen):
            assert n == n0 and _meta(buf) == _meta(buf0), label
            for a, b in zip(_payload_leaves(buf), _payload_leaves(buf0)):
                assert torch.equal(a, b), label
        for client, client0 in zip(answers, ref_answers):
            assert len(client) == len(client0) == TICKS, label
            for a, b in zip(client, client0):
                assert torch.equal(a.tensor, b.tensor), label
    for (n, buf), (jn, jbuf) in zip(ref_seen, jseen):
        assert n == jn and _meta(buf) == _meta(jbuf)
        for a, b in zip(_payload_leaves(buf), _jax_payload_leaves(jbuf)):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    for client, jclient in zip(ref_answers, janswers):
        for a, b in zip(client, jclient):
            np.testing.assert_array_equal(_np(a.tensor),
                                          np.asarray(b.tensor))
