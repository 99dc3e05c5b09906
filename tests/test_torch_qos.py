"""Tenant QoS and elastic serving (DESIGN.md §9) in the port against the
JAX package, on the CPU.

Each test of ``tests/test_qos.py`` runs in both packages on the same
registered toy model (``y = float32(x) @ W``, W of halves: exact in both),
and so do ``examples/multitenant_fleet.py``'s scenario, a streaming fleet
of ``stablelm-smoke-flash`` servers on the JAX package's weights
(``params_from_numpy``) and a 2-stage chain whose stage 0 admits under
QoS.  Pinned for each:

* the reference test's own assertions, on the port's ``Runtime``;
* every client's sink log equals the JAX package's: answers bitwise, and
  the error frames' ``error``, ``reason``, ``tenant`` and ``tick`` (and a
  park expiry's ``parked_ticks``);
* ``stats()["tenants"]``, ``["failover"]``, ``["reconfig"]``,
  ``["query_batching"]`` and ``["autoscale"]`` equal as dicts.

Then the port alone: replicas an autoscaler grows from one seed hold
bitwise-equal params and answer ``sequential_decode`` on the first
replica's, and the heartbeat's host count of streams equals the slots the
plan state's active mask holds, across joins and leaves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaoslib import Chaos
from repro.core import admission as jadm
from repro.core.elements import register_model as jregister
from repro.core import TensorSpec as JSpec
from repro.launch import model_serve as jax_ms
from repro.models import transformer as jax_tf
from repro.runtime.autoscale import Autoscaler as JAutoscaler
from repro_torch.core import TensorSpec, admission as tadm
from repro_torch.core.batching import StreamingQueryBatcher
from repro_torch.core.buffers import tree_flatten
from repro_torch.core.elements import register_model
from repro_torch.device import make_generator
from repro_torch.launch import model_serve as ms
from repro_torch.models import transformer as tt
from repro_torch.runtime import Autoscaler, Device, Runtime
from test_torch_failover import Jax, Port, same_logs, same_stats

torch.set_num_threads(2)

pytestmark = pytest.mark.qos

W = np.full((12, 4), 0.5, np.float32)
#: error-frame meta the twins compare
ERROR_META = ("error", "reason", "tenant", "operation", "parked_ticks",
              "redispatches", "tick")
STATS = ("failover", "reconfig", "query_batching", "tenants")


@pytest.fixture(scope="module", autouse=True)
def models():
    register_model("qos_twin", lambda g, dev: {
        "w": torch.as_tensor(W, device=dev)},
        lambda p, x: x.to(torch.float32).reshape(1, -1) @ p["w"],
        out_specs=(TensorSpec((1, 4), "float32"),))
    jregister("qos_twin", lambda rng: {"w": jnp.asarray(W)},
              lambda p, x: x.astype(jnp.float32).reshape(1, -1) @ p["w"],
              out_specs=(JSpec((1, 4), "float32"),))


def adm(pkg):
    return jadm if pkg is Jax else tadm


def lm(pkg):
    return jax_ms if pkg is Jax else ms


def autoscaler(pkg):
    return JAutoscaler if pkg is Jax else Autoscaler


def serve_ps(pkg, operation="op"):
    ps = pkg.parse(
        f"tensor_query_serversrc operation={operation} name=ssrc ! "
        f"tensor_filter model=qos_twin ! tensor_query_serversink "
        f"name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    return ps


def server(pkg, rt, name="hub", operation="op"):
    dev = pkg.device(name)
    ps = serve_ps(pkg, operation)
    dev.add_pipeline(ps, jit=False)
    rt.add_device(dev)
    return dev, ps.elements["ssrc"]


def client(pkg, rt, name="tv", operation="op", tenant=None):
    dev = pkg.device(name)
    tprop = f" tenant={tenant}" if tenant else ""
    dev.add_pipeline(pkg.parse(
        f"testsrc width=2 height=2 ! tensor_converter ! "
        f"tensor_query_client operation={operation}{tprop} name=qc ! "
        f"appsink name=res"), jit=False)
    rt.add_device(dev)
    return dev


def check(port, jax_, keys=STATS):
    """Sink logs (answers, error frames' meta) and stats dicts equal."""
    (prt, pdevs), (jrt, jdevs) = port, jax_
    same_logs([d.runs[0] for d in pdevs], [d.runs[0] for d in jdevs],
              meta_of=ERROR_META)
    same_stats(prt, jrt, keys)


def twin(scenario, **kw):
    return scenario(Port, **kw), scenario(Jax, **kw)


# ---------------------------------------------------------------------------
# twins of tests/test_qos.py
# ---------------------------------------------------------------------------

def _parity(pkg, on):
    qos = lm(pkg).three_tier_qos() if on else None
    rt = pkg.runtime(qos=qos)
    server(pkg, rt)
    cdev = client(pkg, rt, tenant="realtime" if on else None)
    rt.run(4)
    return rt, [cdev]


def test_qos_on_answers_bitwise_equal():
    """Scheduling changes ordering and admission, never answers."""
    outs = {}
    for on in (False, True):
        port, jax_ = twin(_parity, on=on)
        check(port, jax_)
        run = port[1][0].runs[0]
        assert run.frames == 4
        outs[on] = np.asarray(run.last_outputs["res"].tensor)
    np.testing.assert_array_equal(outs[False], outs[True])


def _schema(pkg):
    rt = pkg.runtime(qos=lm(pkg).three_tier_qos())
    server(pkg, rt)
    devs = [client(pkg, rt, name="tv1", tenant="realtime"),
            client(pkg, rt, name="tv2")]
    rt.run(3)
    return rt, devs


def test_unified_stats_schema_and_conservation():
    port, jax_ = twin(_schema)
    check(port, jax_)
    rt = port[0]
    tenants = rt.stats()["tenants"]       # asserts conservation
    assert set(tenants) >= {"realtime", "default"}
    for t in tenants.values():
        assert set(t) >= {"priority", "admitted", "served", "shed",
                          "queued", "in_flight", "shed_reasons",
                          "p50_ticks", "p99_ticks"}
    assert tenants["realtime"]["served"] == 3
    assert tenants["realtime"]["shed"] == 0
    bs = next(iter(rt._batchers.values())).stats()
    assert set(bs) >= {"admitted_requests", "served_requests",
                       "shed_requests", "queued_requests"}


def _starved(pkg):
    A = adm(pkg)
    qos = A.QoSConfig(tenants=(A.TenantSpec("rt", priority=0),
                               A.TenantSpec("be", priority=2)),
                      serve_per_tick=1)
    rt = pkg.runtime(qos=qos)
    server(pkg, rt)
    devs = [client(pkg, rt, name="tv-rt", tenant="rt"),
            client(pkg, rt, name="tv-be", tenant="be")]
    rt.run(20)
    return rt, devs


def test_realtime_outranks_best_effort_under_starved_server():
    """serve_per_tick=1 against two 1-request-a-tick tenants: the budget
    holds requests queued (in flight, not errors), priority 0 gets more
    service and lower latency, and nothing is lost."""
    port, jax_ = twin(_starved)
    check(port, jax_)
    t = port[0].stats()["tenants"]
    assert t["rt"]["served"] > t["be"]["served"]
    assert t["rt"]["shed"] == 0 and t["be"]["shed"] == 0
    assert t["rt"]["p50_ticks"] <= t["be"]["p50_ticks"]


def _rate(pkg):
    A = adm(pkg)
    qos = A.QoSConfig(tenants=(
        A.TenantSpec("metered", priority=1, rate=0.25, burst=1),))
    rt = pkg.runtime(qos=qos)
    server(pkg, rt)
    devs = [client(pkg, rt, name="tv-m", tenant="metered")]
    rt.run(8)
    return rt, devs


def test_rate_shed_is_explicit_client_error():
    port, jax_ = twin(_rate)
    check(port, jax_)
    rt, (cdev,) = port
    t = rt.stats()["tenants"]["metered"]
    assert t["shed"] > 0
    assert t["shed_reasons"].get("rate", 0) == t["shed"]
    errs = cdev.runs[0].sink_log.get("qc.error", [])
    assert len(errs) == t["shed"]
    assert all(e.meta["error"] == "shed" and e.meta["reason"] == "rate"
               and e.meta["tenant"] == "metered" for e in errs)
    assert t["admitted"] == t["served"] + t["shed"] + t["queued"] + \
        t["in_flight"]


def _park(pkg):
    A = adm(pkg)
    qos = A.QoSConfig(tenants=(
        A.TenantSpec("gold", priority=0, deadline_ticks=3),))
    rt = pkg.runtime(qos=qos, park_deadline_ticks=50)
    devs = [client(pkg, rt, name="tv-g", tenant="gold")]
    rt.run(6)
    return rt, devs


def test_tenant_deadline_tightens_park_expiry():
    port, jax_ = twin(_park)
    check(port, jax_)
    rt, (cdev,) = port
    assert rt.parked_expired >= 1
    t = rt.stats()["tenants"]["gold"]
    assert t["shed_reasons"].get("deadline", 0) == rt.parked_expired
    assert t["priority"] == 0
    errs = cdev.runs[0].sink_log.get("qc.error", [])
    assert errs and errs[0].meta["error"] == "park-deadline"
    assert errs[0].meta["parked_ticks"] == 3      # the tenant's, not 50


def _fleet(pkg, n_clients=6, serve_per_tick=2, kill=False, ticks=(20, 25)):
    """One overloaded server and an autoscaler on topic query/op; with
    ``kill`` the device of the first half-warmed replica dies."""
    rt = pkg.runtime(qos=adm(pkg).QoSConfig(serve_per_tick=serve_per_tick))
    server(pkg, rt)
    devs = [client(pkg, rt, name=f"tv{i}") for i in range(n_clients)]
    asc = autoscaler(pkg)(rt, "query/op", lambda i: serve_ps(pkg),
                          high_load=3.0, low_load=0.5, max_replicas=3,
                          min_replicas=1, cooldown_ticks=3, warm_ticks=1)
    chaos = Chaos(rt)
    ex = dict(asc=asc, chaos=chaos, killed=[])
    if kill:
        asc.warm_ticks = 4              # a wide warm window to die inside

        def kill_pending():
            p = asc._pending
            if p is not None and p["kind"] == "up" and not ex["killed"]:
                p["device"].alive = False
                ex["killed"].append(rt.ticks)
        for t in range(2, 12):
            chaos.at(t, kill_pending, label=None)
        chaos.run(30)
        return rt, devs, ex
    chaos.run(ticks[0])
    ex["replicas_up"] = 1 + len(asc.replicas)
    ex["replica_served"] = sum(
        sum(t["served"] for t in
            rt._batchers[e.endpoint.endpoint_id].tenant_stats().values())
        for rep in asc.replicas
        for e in rep["run"].pipe.elements.values()
        if hasattr(e, "endpoint") and hasattr(e.endpoint, "requests"))
    for d in devs:                      # traffic stops; the fleet drains
        d.alive = False
    chaos.run(ticks[1])
    return rt, devs, ex


def test_scale_up_rebalances_and_scale_down_drains_zero_loss():
    (prt, pdevs, pex), (jrt, jdevs, jex) = twin(_fleet)
    check((prt, pdevs), (jrt, jdevs), STATS + ("autoscale",))
    assert pex["chaos"].log == jex["chaos"].log
    assert pex["replicas_up"] == jex["replicas_up"] >= 2
    assert pex["replica_served"] == jex["replica_served"] > 0
    asc = pex["asc"]
    assert asc.scale_ups >= 1 and asc.scale_downs >= 1
    t = prt.stats()["tenants"]["default"]
    assert t["shed"] == 0 and t["queued"] == 0 and t["in_flight"] == 0
    assert t["admitted"] == t["served"]
    for d in pdevs:
        assert not d.runs[0].sink_log.get("qc.error")


def test_replica_killed_mid_scale_up_rolls_back():
    (prt, pdevs, pex), (jrt, jdevs, jex) = twin(_fleet, kill=True)
    check((prt, pdevs), (jrt, jdevs), STATS + ("autoscale",))
    assert pex["killed"] == jex["killed"] != []
    asc = pex["asc"]
    assert asc.rollbacks >= 1
    assert all(not r["device"].alive or r["run"].retired is False
               for r in asc.replicas)
    assert sum(d.runs[0].frames for d in pdevs) > 0
    log = [row for row in prt.reconfig.log if row[2] == "rolled_back"]
    assert log and log[0][3] == "target-dead"
    assert log == [row for row in jrt.reconfig.log
                   if row[2] == "rolled_back"]


# ---------------------------------------------------------------------------
# examples/multitenant_fleet.py
# ---------------------------------------------------------------------------

TIERS = {"realtime": 3, "standard": 3, "best-effort": 3}
TICKS_LOAD, TICKS_DRAIN = 18, 20


def _multitenant(pkg):
    A = adm(pkg)
    qos = A.QoSConfig(
        tenants=(A.TenantSpec("realtime", priority=0, deadline_ticks=4),
                 A.TenantSpec("standard", priority=1, rate=1, burst=2),
                 A.TenantSpec("best-effort", priority=2, deadline_ticks=6,
                              max_queue=4)),
        default=A.TenantSpec(priority=2), serve_per_tick=3)
    rt = pkg.runtime(qos=qos)
    server(pkg, rt, operation="infer")
    devs = [client(pkg, rt, name=f"{tier}-{i}", operation="infer",
                   tenant=tier)
            for tier, n in TIERS.items() for i in range(n)]
    asc = autoscaler(pkg)(rt, "query/infer",
                          lambda i: serve_ps(pkg, "infer"),
                          high_load=3.0, low_load=0.5, max_replicas=2,
                          cooldown_ticks=3, warm_ticks=1)
    chaos = Chaos(rt)
    for dev in devs:
        chaos.at(TICKS_LOAD + 1, lambda d=dev: setattr(d, "alive", False),
                 label=None)
    chaos.run(TICKS_LOAD + TICKS_DRAIN)
    return rt, devs, asc


def test_multitenant_fleet_example_twin():
    """Nine 1-request-a-tick clients in three tiers against a 3-a-tick
    hub that grows to 2 replicas: the same sheds, error frames, ledgers
    and scaling events as the JAX package's example."""
    (prt, pdevs, asc), (jrt, jdevs, _) = twin(_multitenant)
    check((prt, pdevs), (jrt, jdevs), STATS + ("autoscale",))
    t = prt.stats()["tenants"]
    assert t["realtime"]["shed"] == 0 and t["standard"]["shed"] > 0
    assert t["realtime"]["p99_ticks"] <= t["best-effort"]["p99_ticks"]
    errs = sum(len(d.runs[0].sink_log.get("qc.error", [])) for d in pdevs)
    assert errs == sum(v["shed"] for v in t.values())
    assert asc.scale_ups == 1 and asc.scale_downs == 1


# ---------------------------------------------------------------------------
# streaming and staged serving under QoS
# ---------------------------------------------------------------------------

MAX_SEQ = 32
GENS = ("6;3", "4", "5;7")


@pytest.fixture(scope="module")
def smoke_weights():
    jcfg = jax_ms.SERVE_MODELS["stablelm-smoke-flash"]()
    jp = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, tt.params_from_numpy(
        jax.device_get(jp), ms.SERVE_MODELS["stablelm-smoke-flash"](), "cpu")


def _slot_owners(rt, cids):
    """{slot: client index} of every streaming batcher, in wiring order."""
    out = []
    for b in rt._batchers.values():
        if hasattr(b, "_slots"):
            out.append({s: cids[r["routing"]["client_id"]]
                        for s, r in sorted(b._slots.items())})
    return out


def _stream_fleet(pkg, weights, n_hubs=2, slots=4, ticks=24):
    """Two stablelm-smoke-flash hubs of 4 slots, 9 clients in three tiers
    with 2 requests each: the rate budget sheds standard and best-effort,
    the serve budget holds requests queued, join-shortest-queue spreads the
    streams and priority picks who gets a free slot."""
    rt = pkg.runtime(qos=lm(pkg).three_tier_qos(
        rate=0.5, deadline_ticks=3, max_queue=1, serve_per_tick=2))
    for h in range(n_hubs):
        dev = pkg.device(f"hub{h}")
        run = dev.add_pipeline(lm(pkg).serve_pipeline(
            model="stablelm-smoke-flash", slots=slots, max_seq=MAX_SEQ),
            jit=False)
        run.params["lm"] = weights[0 if pkg is Jax else 1]
        rt.add_device(dev)
    devs, cids = [], {}
    for i in range(9):
        tier = ("realtime", "standard", "best-effort")[i % 3]
        dev = pkg.device(f"tv{i}")
        run = dev.add_pipeline(lm(pkg).client_pipeline(
            prompts=f"{i + 1},{i + 2};{i + 3}", gens=GENS[i % 3],
            tenant=tier), jit=False)
        rt.add_device(dev)
        devs.append(dev)
        cids[run.pipe.elements["qc"].client_id] = i
    owners = []
    for _ in range(ticks):
        rt.tick()
        owners.append(_slot_owners(rt, cids))
    return rt, devs, owners


def test_streaming_fleet_under_qos_twin(smoke_weights):
    (prt, pdevs, pown), (jrt, jdevs, jown) = twin(_stream_fleet,
                                                  weights=smoke_weights)
    check((prt, pdevs), (jrt, jdevs))
    assert pown == jown                      # the same slot order
    t = prt.stats()["tenants"]
    assert t["standard"]["shed"] > 0 and t["best-effort"]["shed"] > 0
    assert t["realtime"]["shed"] == 0
    assert len([o for o in pown if o[0] and o[1]]) > 0   # both hubs used
    qb = prt.stats()["query_batching"]
    assert qb["tokens_generated"] == qb["tokens_delivered"] + \
        qb["tokens_dropped"] + qb["tokens_in_flight"]
    params, cfg = smoke_weights[1], ms.SERVE_MODELS["stablelm-smoke-flash"]()
    for i, dev in enumerate(pdevs):
        gens = [int(g) for g in GENS[i % 3].split(";")]
        prompts = [[i + 1, i + 2], [i + 3]]
        for j, b in enumerate(dev.runs[0].sink_log.get("res", [])):
            assert np.asarray(b.tensor).tolist() == ms.sequential_decode(
                params, cfg, prompts[j % 2], gens[j % len(gens)], MAX_SEQ,
                slots=4, slot=b.meta["slot"], device="cpu")


STAGED = "stablelm-smoke-4l"


@pytest.fixture(scope="module")
def staged_weights():
    from repro.runtime import Device as JDevice
    run = JDevice("w").add_pipeline(
        jax_ms.serve_pipeline(model=STAGED, slots=4, max_seq=MAX_SEQ),
        jit=False)
    jp = run.params["lm"]
    return jp, tt.params_from_numpy(jax.device_get(jp),
                                    ms.SERVE_MODELS[STAGED](), "cpu")


def _staged_qos(pkg, weights):
    rt = pkg.runtime(qos=lm(pkg).three_tier_qos(
        rate=0.5, deadline_ticks=3, max_queue=1, serve_per_tick=2))
    for k, ps in enumerate(lm(pkg).staged_serve_pipelines(
            model=STAGED, slots=4, max_seq=MAX_SEQ, n_stages=2)):
        dev = pkg.device(f"stage{k}")
        run = dev.add_pipeline(ps, jit=False)
        if pkg is Port:
            run.params["lm"] = tt.stage_params(
                weights[1], ms.SERVE_MODELS[STAGED](), k, 2)
        rt.add_device(dev)
    devs = []
    for i in range(6):
        dev = pkg.device(f"tv{i}")
        dev.add_pipeline(lm(pkg).client_pipeline(
            prompts=f"{i + 1},{i + 2}", gens=GENS[i % 3],
            tenant=("realtime", "standard", "best-effort")[i % 3]),
            jit=False)
        rt.add_device(dev)
        devs.append(dev)
    rt.run(24)
    return rt, devs


def test_staged_chain_stage0_under_qos_twin(staged_weights):
    """Stage 0 admits under the tenants' budgets; the hop servers stay
    pass-through FIFO (no shed, their ledgers balance)."""
    from repro_torch.core.batching import (StagedStreamingBatcher,
                                           StageQueryBatcher)
    port, jax_ = twin(_staged_qos, weights=staged_weights)
    check(port, jax_)
    rt = port[0]
    coord = next(b for b in rt._batchers.values()
                 if isinstance(b, StagedStreamingBatcher))
    hops = [b for b in rt._batchers.values()
            if isinstance(b, StageQueryBatcher)]
    assert coord.admission.enabled and hops
    assert not any(b.admission.enabled for b in hops)
    t = coord.tenant_stats()
    assert t["standard"]["shed"] > 0 and t["best-effort"]["shed"] > 0
    for b in hops:
        st = b.stats()
        assert st["shed_requests"] == 0
        assert st["admitted_requests"] == st["served_requests"]
    led = coord.stage_ledger(1)
    assert led["dispatched"] == led["completed"] + led["failed"]
    cfg = ms.SERVE_MODELS[STAGED]()
    for i, dev in enumerate(port[1]):
        gens = [int(g) for g in GENS[i % 3].split(";")]
        for j, b in enumerate(dev.runs[0].sink_log.get("res", [])):
            assert np.asarray(b.tensor).tolist() == ms.sequential_decode(
                staged_weights[1], cfg, [i + 1, i + 2],
                gens[j % len(gens)], MAX_SEQ, slots=4,
                slot=b.meta["slot"], device="cpu")


# ---------------------------------------------------------------------------
# the port alone: seeded replicas, slot counts
# ---------------------------------------------------------------------------

def _leaves(params):
    return tree_flatten(params)[0]


def test_autoscaled_replicas_hold_the_seed_params_bitwise():
    """A stream fleet grows a second replica from the first one's seed:
    its params are bitwise the first's, leaf by leaf (a generator is
    drawn fresh for every scale-up), answers on either replica are
    ``sequential_decode`` on the first's params, and a scale-down
    archives the replica's ledgers."""
    seed = 3
    rt = Runtime(device="cpu", qos=ms.three_tier_qos(serve_per_tick=2))
    hub = Device("hub", device="cpu")
    srv = hub.add_pipeline(ms.serve_pipeline(
        model="stablelm-smoke-flash", slots=2, max_seq=MAX_SEQ),
        generator=make_generator(seed, "cpu"))
    rt.add_device(hub)
    asc = Autoscaler(rt, "query/lm", lambda i: ms.serve_pipeline(
        model="stablelm-smoke-flash", slots=2, max_seq=MAX_SEQ),
        high_load=2.0, low_load=0.0, max_replicas=2, cooldown_ticks=2,
        seed=seed)
    clients = []
    for i in range(5):
        dev = Device(f"tv{i}", device="cpu")
        clients.append(dev.add_pipeline(ms.client_pipeline(
            prompts=f"{i + 1},{i + 2}", gens="5")))
        rt.add_device(dev)
    for _ in range(14):
        rt.tick()
    assert asc.scale_ups == 1
    rep = asc.replicas[0]["run"]
    a, b = _leaves(srv.params["lm"]), _leaves(rep.params["lm"])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert _batcher(rt, rep).streams_finished > 0    # JSQ used it
    for c in clients:
        c.retired = True
    for _ in range(12):
        rt.tick()
    st = rt.stats()
    assert st["autoscale"][0]["scale_downs"] == 1
    t = st["tenants"]["default"]
    assert t["served"] > 0 and t["queued"] == t["in_flight"] == 0
    cfg = srv.pipe.elements["lm"].cfg
    for i, run in enumerate(clients):
        assert run.sink_log["res"]
        for ans in run.sink_log["res"]:
            assert np.asarray(ans.tensor).tolist() == ms.sequential_decode(
                srv.params["lm"], cfg, [i + 1, i + 2], 5, MAX_SEQ, slots=2,
                slot=ans.meta["slot"], device="cpu")


def _batcher(rt, run) -> StreamingQueryBatcher:
    return next(b for b in rt._batchers.values() if b.run is run)


def test_active_streams_equal_the_active_mask_across_joins_and_leaves():
    """The heartbeat counts streams from the batcher's host records; the
    autoscaler's idle check reads the plan state's active mask.  After
    every tick the slotted streams equal the occupied slots."""
    rt = Runtime(device="cpu", qos=ms.three_tier_qos(serve_per_tick=1))
    hub = Device("hub", device="cpu")
    srv = hub.add_pipeline(ms.serve_pipeline(
        model="stablelm-smoke-flash", slots=3, max_seq=MAX_SEQ))
    rt.add_device(hub)
    for i in range(5):
        dev = Device(f"tv{i}", device="cpu")
        dev.add_pipeline(ms.client_pipeline(
            prompts=f"{i + 1}", gens=("3", "6;2", "4")[i % 3],
            tenant=("realtime", "standard", "best-effort")[i % 3]))
        rt.add_device(dev)
    b = _batcher(rt, srv)
    elem = srv.pipe.elements["lm"]
    seen = set()
    for _ in range(20):
        rt.tick()
        slotted = b.active_streams() - len(b._waiting)
        assert slotted == len(b._slots) == elem.active_slots(srv.state)
        seen.add((len(b._slots), len(b._waiting)))
    assert any(w > 0 for _, w in seen)       # streams waited for a slot
    assert len({s for s, _ in seen}) > 2     # joins and leaves happened


def test_runtime_qos_is_kept_and_load_counts_streams_only_under_qos():
    """Pre-QoS the heartbeat load stays channel plus admission; under
    QoS it adds the streams holding or waiting for slots."""
    loads = {}
    for on in (False, True):
        rt = Runtime(device="cpu",
                     qos=ms.three_tier_qos() if on else None)
        hub = Device("hub", device="cpu")
        hub.add_pipeline(ms.serve_pipeline(
            model="stablelm-smoke-flash", slots=2, max_seq=MAX_SEQ))
        rt.add_device(hub)
        for i in range(3):
            dev = Device(f"tv{i}", device="cpu")
            dev.add_pipeline(ms.client_pipeline(prompts="1,2", gens="8"))
            rt.add_device(dev)
        rt.run(3)
        rt._heartbeat_and_lease()
        reg = hub.runs[0].pipe.elements["ssrc"].registration
        loads[on] = reg.load
        assert (rt.qos is not None) == on
    assert loads == {False: 0.0, True: 3.0}
