"""Stream recovery (DESIGN.md §3, §7) in the port against the JAX package,
on the CPU: ``stablelm-smoke-flash`` servers with live KV-cache slots,
killed or hot-swapped mid-generation.

Twins of ``tests/test_model_serving.py``'s ``TestHotSwapMidDecode``,
``TestChaosStatefulFailover`` and
``test_pipelined_prompts_same_client_through_kill``.  Each scenario runs
in both packages, the port on the JAX package's weights
(``params_from_numpy``; a hot swap's new params are the JAX package's
too, put into ``rc.new_params`` before the commit tick).  Pinned: the
reference test's assertions on the port; every client's token streams and
error frames equal the JAX package's; the whole ``failover``,
``reconfig``, ``query_batching`` and ``tenants`` dicts equal key for key
(``replays`` included).

Then the port against itself: a kill mid-generation with a survivor gives
the fault-free twin's answers bitwise, and the graph route (the stand-in
graph of ``test_torch_graphs.py`` on the CPU; real CUDA graphs in the
``cuda`` tests) gives the ``jit=False`` route's answers and stats through
a kill, with its live graphs bounded over swap cycles.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core.buffers import StreamBuffer as JBuffer
from repro.core.element import element_factory as jfactory
from repro.launch import model_serve as jax_ms
from repro.models import transformer as jax_tf
from repro_torch.core import compression as comp
from repro_torch.core import plan as plan_mod
from repro_torch.core.buffers import StreamBuffer
from repro_torch.core.element import element_factory
from repro_torch.core.graphs import graph_stats
from repro_torch.launch import model_serve as ms
from repro_torch.models import transformer as tt
from test_torch_failover import Jax, Port, check_twin, same_logs
from test_torch_graphs import fake_graphs

torch.set_num_threads(2)

pytestmark = pytest.mark.modelserve

MAX_SEQ = 32


@pytest.fixture(scope="module")
def weights():
    """JAX PRNGKey(0) weights of both presets, and the port's copies."""
    out = {}
    for name in ("stablelm-smoke-flash", "stablelm-smoke"):
        jcfg = jax_ms.SERVE_MODELS[name]()
        jp = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
        out[name] = (jp, tt.params_from_numpy(
            jax.device_get(jp), ms.SERVE_MODELS[name](), "cpu"))
    return out


def _mod(pkg):
    return jax_ms if pkg is Jax else ms


def serve(pkg, rt, weights, name="hub", slots=8, jit=False):
    dev = pkg.device(name)
    ps = _mod(pkg).serve_pipeline(model="stablelm-smoke-flash", slots=slots,
                                  max_seq=MAX_SEQ)
    run = dev.add_pipeline(ps, jit=jit)
    # both packages serve the same tree (every server of a scenario does)
    run.params["lm"] = weights["stablelm-smoke-flash"][0 if pkg is Jax
                                                       else 1]
    rt.add_device(dev)
    return dev, run, ps


def client(pkg, rt, i, prompts, gens, jit=False):
    dev = pkg.device(f"tv{i}")
    run = dev.add_pipeline(_mod(pkg).client_pipeline(prompts=prompts,
                                                     gens=gens), jit=jit)
    rt.add_device(dev)
    return run


def answers(run):
    return [np.asarray(b.tensor.cpu() if isinstance(b.tensor, torch.Tensor)
                       else b.tensor).tolist()
            for b in run.sink_log.get("res", [])]


def _conserved(qb):
    return qb["tokens_generated"] == qb["tokens_delivered"] + \
        qb["tokens_dropped"] + qb["tokens_in_flight"]


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def _hot_swap(pkg, weights, new_params=None):
    """Swap ``lm`` for a stablelm-smoke ``model_serve`` while 3 streams are
    mid-generation; ``new_params`` (port only) replaces the new element's
    params before the commit tick."""
    rt = pkg.runtime(query_batch=8)
    _, srv, _ = serve(pkg, rt, weights)
    cls = [client(pkg, rt, i, f"{i+1},{i+2}", "8") for i in range(3)]
    rt.run(2)
    pre = [len(answers(r)) for r in cls]
    old = srv.params["lm"]
    elem = (element_factory if pkg is Port else jfactory)(
        "model_serve", model="stablelm-smoke", slots="8",
        max_seq=str(MAX_SEQ))
    rc = rt.reconfigure(srv, srv.pipe.reconfig().swap("lm", elem),
                        warm_ticks=1)
    status = rc.status
    if new_params is not None:
        rc.new_params["lm"] = new_params
    rt.run(2)
    committed = rc.status
    rt.run(14)
    return rt, cls, dict(srv=srv, rc=rc, pre=pre, old=old, status=status,
                         committed=committed)


def test_hot_swap_mid_decode_bitwise_fresh_build(weights):
    """The commit is not blocked by the in-flight streams; they replay on
    the new epoch, and every answer is bitwise a fresh build's."""
    jax_ = _hot_swap(Jax, weights)
    jnew = jax_[2]["rc"].new_params["lm"]
    tnew = tt.params_from_numpy(jax.device_get(jnew),
                                ms.SERVE_MODELS["stablelm-smoke"](), "cpu")
    port = _hot_swap(Port, weights, new_params=tnew)
    check_twin(port, jax_)
    rt, cls, ex = port
    assert ex["pre"] == [0, 0, 0]
    assert ex["status"] == "warming" and ex["committed"] == "committed"
    srv = ex["srv"]
    assert srv.params["lm"] is not ex["old"]
    cfg_new = srv.pipe.elements["lm"].cfg
    for i, run in enumerate(cls):
        got = run.sink_log["res"]
        assert len(got) >= 2
        for b in got:
            assert np.asarray(b.tensor).tolist() == ms.sequential_decode(
                srv.params["lm"], cfg_new, [i + 1, i + 2], 8, MAX_SEQ,
                slots=8, slot=b.meta["slot"], device="cpu")
    qb = rt.stats()["query_batching"]
    assert qb["replays"] == 3 and qb["tokens_dropped"] > 0
    assert _conserved(qb)
    assert rt.stats()["reconfig"]["planned"] == 1


def _kill_mid_generation(pkg, chaos, weights, fault=True, jit=False):
    ticks = 16
    rt = pkg.runtime(query_batch=8)
    devA, runA, psA = serve(pkg, rt, weights, name="hubA", jit=jit)
    devB, runB, psB = serve(pkg, rt, weights, name="hubB", jit=jit)
    got = [client(pkg, rt, i, f"{i+1},{i+2},{i+3}", "6", jit=jit)
           for i in range(3)]
    harness = chaos(rt)
    if fault:
        harness.kill_server(4, devA, psA.elements["ssrc"], crash=True)
    harness.run(ticks)
    return rt, got, dict(harness=harness, runB=runB)


def test_kill_mid_generation_zero_token_loss_bitwise(weights):
    """The serving device dies at tick 4 with live KV-cache slots; the
    orphaned streams re-dispatch to the survivor, which prefill-replays
    them: every answer is full length and bitwise the fault-free twin's
    (in the port and in the JAX package)."""
    from chaoslib import Chaos
    port = _kill_mid_generation(Port, Chaos, weights)
    jax_ = _kill_mid_generation(Jax, Chaos, weights)
    check_twin(port, jax_)
    ref = _kill_mid_generation(Port, Chaos, weights, fault=False)
    rt, got, ex = port
    for r0, r1 in zip(ref[1], got):
        a, b = answers(r0), answers(r1)
        assert len(b) >= 2
        assert a[:len(b)] == b
        assert all(len(y) == 6 for y in b)
    fo, qb = rt.stats()["failover"], rt.stats()["query_batching"]
    assert fo["redispatches"] >= 3
    assert qb["tokens_dropped"] > 0 and _conserved(qb)
    assert ex["runB"].frames > 0
    assert rt.stats()["reconfig"]["unplanned"] == 1


def _park_deadline(pkg, chaos, weights):
    rt = pkg.runtime(query_batch=8, park_deadline_ticks=3)
    dev, srv, ps = serve(pkg, rt, weights)
    cls = [client(pkg, rt, i, f"{i+1},{i+2}", "6") for i in range(2)]
    harness = chaos(rt)
    harness.kill_server(3, dev, ps.elements["ssrc"], crash=True)
    harness.run(10)
    return rt, cls, dict(harness=harness)


def test_park_deadline_expires_mid_stream_requests(weights):
    """No survivor: mid-generation requests park and expire at the
    deadline into client-visible error frames with the reference's meta."""
    from chaoslib import Chaos
    port = _park_deadline(Port, Chaos, weights)
    jax_ = _park_deadline(Jax, Chaos, weights)
    check_twin(port, jax_)
    rt, cls, _ = port
    assert rt.stats()["failover"]["parked_expired"] >= 2
    for r in cls:
        errs = r.sink_log.get("qc.error", [])
        assert len(errs) >= 1
        for e in errs:
            assert e.meta["error"] == "park-deadline"
            assert e.meta["operation"] == "lm"
            assert e.tensors == ()
    qb = rt.stats()["query_batching"]
    assert qb["tokens_dropped"] > 0 and qb["tokens_in_flight"] == 0


def _push_raw(pkg, ep, client_id, prompt, gen):
    if pkg is Port:
        buf = StreamBuffer(tensors=(torch.tensor(prompt, dtype=torch.int32),),
                           meta={"gen": gen, "client_id": client_id,
                                 "codec": "none"})
        payload, nbytes = comp.encode(buf, "none")
    else:
        buf = JBuffer(tensors=(np.asarray(prompt, np.int32),),
                      meta={"gen": gen, "client_id": client_id,
                            "codec": "none"})
        payload, nbytes = jcomp.encode(buf, "none")
    ep.requests.push(payload, nbytes)


def _pipelined_kill(pkg, weights):
    rt = pkg.runtime(query_batch=8)
    _, srv, ps = serve(pkg, rt, weights)
    ep = ps.elements["ssrc"].endpoint
    b = rt._batchers[ep.endpoint_id]
    _push_raw(pkg, ep, 777, [1, 2], 6)
    _push_raw(pkg, ep, 777, [3, 4], 6)
    for _ in range(3):
        rt.ticks += 1
        b.flush()
    before = (b.active_streams(), b.tokens_generated)
    ep.alive = False
    b.flush()
    return rt, b, before


def test_pipelined_prompts_same_client_through_kill(weights):
    """Two live streams of ONE client when the endpoint dies: both
    records' partial tokens are declared drops."""
    rt, b, (active, generated) = _pipelined_kill(Port, weights)
    jrt, jb, jbefore = _pipelined_kill(Jax, weights)
    assert (active, generated) == jbefore
    assert active == 2 and generated >= 4
    assert not b._by_client and b.tokens_dropped == generated
    st = b.stats()
    assert st["tokens_in_flight"] == 0 and _conserved(st)
    check_twin((rt, [], {}), (jrt, [], {}))


# ---------------------------------------------------------------------------
# the graph route through a kill, and graph bindings over swap cycles
# ---------------------------------------------------------------------------

def _graph_vs_eager_through_kill(weights):
    from chaoslib import Chaos
    graph = _kill_mid_generation(Port, Chaos, weights, jit=True)
    eager = _kill_mid_generation(Port, Chaos, weights, jit=False)
    check_twin(graph, eager)
    assert plan_mod.executable_cache_info()["graphs"] > 0


def _swap_cycles(pkg_weights, device, seeds=(1, 2, 3, 4)):
    """A stablelm-smoke-flash server swapped to fresh weights (from each
    seed's generator) four times under live streams; -> live graphs (and
    graph bytes) after each cycle, and the client runs."""
    from repro_torch.device import make_generator
    from repro_torch.runtime import Device, Runtime
    rt = Runtime(device=device, query_batch=8)
    hub = Device("hub", device=device)
    srv = hub.add_pipeline(ms.serve_pipeline(slots=4, max_seq=MAX_SEQ))
    rt.add_device(hub)
    cls = []
    for i in range(2):
        dev = Device(f"tv{i}", device=device)
        cls.append(dev.add_pipeline(ms.client_pipeline(
            prompts=f"{i + 1},{i + 2}", gens="5")))
        rt.add_device(dev)
    rt.run(3)
    live, held = [], []
    for seed in seeds:
        held.append(srv.params)     # no later tensor takes their addresses
        rc = rt.reconfigure(srv, srv.pipe.reconfig().swap(
            "lm", element_factory("model_serve",
                                  model="stablelm-smoke-flash", slots="4",
                                  max_seq=str(MAX_SEQ))),
            warm_ticks=1, rng=make_generator(seed, rt.device))
        rt.run(4)
        assert rc.status == "committed"
        live.append((plan_mod.executable_cache_info()["graphs"],
                     graph_stats()["bytes"]))
    return rt, srv, cls, live


def test_graph_route_equals_eager_through_kill(weights, monkeypatch):
    """Through the stand-in graph: the decode tick, serve batches and
    client segments take the graph path, and a kill mid-generation with
    prefill replay gives the eager route's answers, logs and stats."""
    fake_graphs(monkeypatch)
    _graph_vs_eager_through_kill(weights)
    plan_mod.clear_executable_cache()


def test_swap_cycles_keep_graph_bindings_bounded(monkeypatch):
    """Each swap gives the server fresh params and state; the commit
    releases the bindings keyed on the retired ones, so the live graphs
    after the fourth cycle are at most those after the first plus one."""
    fake_graphs(monkeypatch)
    rt, srv, cls, live = _swap_cycles(None, "cpu")
    graphs = [g for g, _ in live]
    assert graphs[0] > 0 and graphs[-1] <= graphs[0] + 1, graphs
    assert rt.stats()["reconfig"]["planned"] == 4
    assert _conserved(rt.stats()["query_batching"])
    plan_mod.clear_executable_cache()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plan_mod.clear_executable_cache()
    yield torch.device("cuda")
    plan_mod.clear_executable_cache()


def _to_card(tree):
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_card(v) for v in tree)
    return tree.cuda() if isinstance(tree, torch.Tensor) else tree


@pytest.mark.cuda
def test_graph_route_equals_eager_through_kill_on_card(weights, card):
    """On the card: real CUDA graphs through a kill with prefill replay
    give the ``jit=False`` route's token streams and stats."""
    from repro_torch.runtime import Device, Runtime
    card_weights = {k: (jp, _to_card(tp)) for k, (jp, tp) in weights.items()}

    class Card(Port):
        @staticmethod
        def runtime(**kw):
            return Runtime(**kw)

        @staticmethod
        def device(name):
            return Device(name)

    from chaoslib import Chaos
    graph = _kill_mid_generation(Card, Chaos, card_weights, jit=True)
    eager = _kill_mid_generation(Card, Chaos, card_weights, jit=False)
    check_twin(graph, eager)
    assert plan_mod.executable_cache_info()["graphs"] > 0
    cpu = _kill_mid_generation(Port, Chaos, weights)
    same_logs(graph[1], cpu[1])


@pytest.mark.cuda
def test_swap_cycles_keep_graph_memory_bounded_on_card(card):
    """On the card: graph bytes after the fourth swap cycle are at most
    those after the first plus one binding's."""
    rt, srv, cls, live = _swap_cycles(None, None)
    graphs = [g for g, _ in live]
    nbytes = [b for _, b in live]
    assert graphs[-1] <= graphs[0] + 1, graphs
    per_binding = max(nbytes) / max(1, max(graphs))
    assert nbytes[-1] <= nbytes[0] + per_binding, nbytes
    assert _conserved(rt.stats()["query_batching"])
