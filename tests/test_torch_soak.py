"""200-tick soaks (DESIGN.md §3, §6, §7, §8) in the port against the JAX
package, on the CPU — ``pytest -m soak`` (pytest.ini keeps them out of
tier-1).

Twins of ``tests/test_soak.py``'s ``test_mixed_workload_soak`` and
``test_reconfig_soak``, ``tests/test_model_serving.py``'s
``test_decode_soak_conservation_through_churn`` and
``tests/test_pp_staged_serving.py``'s
``test_staged_soak_per_stage_conservation``.  Each runs one scenario in
both packages through the tick-scripted chaos harness and holds the port
to the reference test's own assertions, plus: every client's sink log
equals the JAX package's (answers bitwise, error frames' meta), and so do
the whole ``failover``, ``reconfig``, ``query_batching`` and ``tenants``
stats dicts and the harness logs.  The toy servers compute
``float32(x) @ W`` with W of quarters, exact in both packages; the model
soaks serve the JAX package's weights (``params_from_numpy``), a hot
swap's new weights included.  The lossy soak (``tests/test_netfault.py``'s
``TestLossySoak``) runs both packages' delivery layers over the same fault
schedule: sink logs, the ``delivery`` and ``netfault`` blocks (every link
ledger, the message conservation law exact on each) equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaoslib import Chaos
from repro.core import TensorSpec as JSpec
from repro.core.element import element_factory as jfactory
from repro.core.elements import register_model as jregister
from repro.core.plan import executable_cache_info as jcache_info
from repro.launch import model_serve as jax_ms
from repro.models import transformer as jax_tf
from repro_torch.core import TensorSpec
from repro_torch.core.element import element_factory
from repro_torch.core.elements import register_model
from repro_torch.core.plan import executable_cache_info
from repro_torch.launch import model_serve as ms
from repro_torch.models import transformer as tt
from test_torch_failover import Jax, Port, same_logs, same_stats

torch.set_num_threads(2)

pytestmark = pytest.mark.soak

TICKS = 200
N_PLAIN_CLIENTS = 3
W1 = ((np.arange(48).reshape(12, 4) % 7 - 3) / 4).astype(np.float32)
W2 = ((np.arange(48).reshape(12, 4) % 5 - 2) / 8).astype(np.float32)
B2 = np.ones((4,), np.float32)
STATS = ("failover", "reconfig", "query_batching", "tenants")


@pytest.fixture(scope="module", autouse=True)
def models():
    register_model("soak_twin", lambda g, dev: {
        "w": torch.as_tensor(W1, device=dev)},
        lambda p, x: x.to(torch.float32).reshape(1, -1) @ p["w"],
        out_specs=(TensorSpec((1, 4), "float32"),))
    register_model("soak_twin2", lambda g, dev: {
        "w": torch.as_tensor(W2, device=dev),
        "b": torch.as_tensor(B2, device=dev)},
        lambda p, x: x.to(torch.float32).reshape(1, -1) @ p["w"] + p["b"],
        out_specs=(TensorSpec((1, 4), "float32"),))
    jregister("soak_twin", lambda rng: {"w": jnp.asarray(W1)},
              lambda p, x: x.astype(jnp.float32).reshape(1, -1) @ p["w"],
              out_specs=(JSpec((1, 4), "float32"),))
    jregister("soak_twin2", lambda rng: {"w": jnp.asarray(W2),
                                         "b": jnp.asarray(B2)},
              lambda p, x: x.astype(jnp.float32).reshape(1, -1) @ p["w"]
              + p["b"], out_specs=(JSpec((1, 4), "float32"),))


def cache_info(pkg):
    return executable_cache_info() if pkg is Port else jcache_info()


def factory(pkg):
    return element_factory if pkg is Port else jfactory


def check(port, jax_, keys=STATS):
    (prt, pruns, pex), (jrt, jruns, jex) = port, jax_
    same_logs(pruns, jruns, meta_of=("error", "reason", "tenant",
                                     "operation", "parked_ticks",
                                     "redispatches", "tick"))
    same_stats(prt, jrt, keys)
    assert pex["harness"].log == jex["harness"].log


# ---------------------------------------------------------------------------
# tests/test_soak.py
# ---------------------------------------------------------------------------

def _mixed_fleet(pkg, filt=""):
    rt = pkg.runtime(query_batch=4, lease_ticks=3)
    viewer = pkg.device("viewer")
    vp = pkg.parse(
        "mqttsrc sub-topic=cam/live name=vsrc ! "
        "tensor_query_client operation=svc name=vqc ! appsink name=vres")
    viewer_run = viewer.add_pipeline(vp, jit=False)
    rt.add_device(viewer)
    cam = pkg.device("cam")
    cp = pkg.parse(
        "testsrc width=2 height=2 ! tensor_converter ! "
        "mqttsink pub-topic=cam/live name=csnk")
    cam_run = cam.add_pipeline(cp, jit=False)
    rt.add_device(cam)
    hub = pkg.device("hub")
    sp = pkg.parse(
        f"tensor_query_serversrc operation=svc name=ssrc ! "
        f"tensor_filter model=soak_twin {filt}! "
        f"tensor_query_serversink name=ssink")
    sp.elements["ssink"].pair_with(sp.elements["ssrc"])
    hub_run = hub.add_pipeline(sp, jit=False)
    rt.add_device(hub)
    client_runs = []
    for i in range(N_PLAIN_CLIENTS):
        dev = pkg.device(f"tv{i}")
        pc = pkg.parse(
            "testsrc width=2 height=2 ! tensor_converter ! "
            "tensor_query_client operation=svc name=qc ! appsink name=res")
        client_runs.append(dev.add_pipeline(pc, jit=False))
        rt.add_device(dev)
    return dict(rt=rt, viewer_run=viewer_run, vp=vp, cam_run=cam_run,
                cp=cp, hub=hub, hub_run=hub_run, sp=sp,
                client_runs=client_runs)


def _mixed(pkg, kill_at=60, revive_at=90):
    f = _mixed_fleet(pkg)
    harness = Chaos(f["rt"])
    harness.kill_server(kill_at, f["hub"], f["sp"].elements["ssrc"],
                        crash=True)
    harness.revive_server(revive_at, f["hub"], f["sp"].elements["ssrc"])
    harness.run(50)
    f["cache_mid"] = cache_info(pkg)
    harness.run(TICKS - 50)
    f["cache_end"] = cache_info(pkg)
    f["harness"] = harness
    return f["rt"], f["client_runs"] + [f["viewer_run"]], f


def _pubsub_conserved(f, stats):
    snk = f["cp"].elements["csnk"].channel
    vsrc = f["vp"].elements["vsrc"]
    assert snk.msgs_sent == f["cam_run"].frames
    still_queued = len(vsrc._rx) + len(vsrc._pushback)
    declared = stats["viewer/p0"]["drops"]
    assert snk.msgs_sent == f["viewer_run"].frames + declared + still_queued
    return declared, vsrc


def test_mixed_workload_soak_twin():
    port, jax_ = _mixed(Port), _mixed(Jax)
    check(port, jax_, STATS + ("viewer/p0", "cam/p0", "hub/p0"))
    rt, runs, f = port
    stats = rt.stats()
    assert stats["failover"]["parked_now"] == 0
    for run in runs:
        assert run.frames + run.skipped == TICKS
        assert len(run.sink_log[next(iter(run.sink_log))]) == run.frames
        assert run.frames >= TICKS - 30 - 2
    assert f["hub_run"].frames == sum(r.frames for r in runs)
    assert stats["failover"]["parked_total"] > 0
    declared, vsrc = _pubsub_conserved(f, stats)
    assert declared == vsrc._rx.drops > 0
    assert f["cache_end"]["fingerprints"] <= f["cache_mid"]["fingerprints"]
    assert f["cache_end"]["executables"] <= f["cache_mid"]["executables"]
    ep = f["sp"].elements["ssrc"].endpoint
    assert len(ep.responses) <= N_PLAIN_CLIENTS + 1


def _reconfig(pkg):
    f = _mixed_fleet(pkg, filt="name=filt ")
    rt, hub_run = f["rt"], f["hub_run"]
    harness = Chaos(rt)
    rcs = []

    def swap_to(model):
        def fire():
            rcs.append(rt.reconfigure(
                hub_run, hub_run.pipe.reconfig().swap(
                    "filt", factory(pkg)("tensor_filter", model=model)),
                warm_ticks=2))
        return fire

    harness.at(40, swap_to("soak_twin2"), "hot swap filt -> soak_twin2")
    harness.at(80, swap_to("soak_twin"), "hot swap filt -> soak_twin")
    harness.at(120, swap_to("soak_twin2"),
               "hot swap filt -> soak_twin2 (dies mid-warm)")
    harness.kill_server(121, f["hub"], f["sp"].elements["ssrc"], crash=True)
    harness.revive_server(130, f["hub"], f["sp"].elements["ssrc"])
    harness.at(160, swap_to("soak_twin2"), "hot swap filt -> soak_twin2")
    harness.run(100)
    f["cache_mid"] = cache_info(pkg)
    harness.run(TICKS - 100)
    f["cache_end"] = cache_info(pkg)
    f.update(harness=harness, rcs=rcs)
    return rt, f["client_runs"] + [f["viewer_run"]], f


def test_reconfig_soak_twin():
    port, jax_ = _reconfig(Port), _reconfig(Jax)
    check(port, jax_, STATS + ("viewer/p0", "cam/p0", "hub/p0"))
    rt, runs, f = port
    stats = rt.stats()
    rcs = f["rcs"]
    assert [rc.status for rc in rcs] == \
        ["committed", "committed", "rolled_back", "committed"]
    assert rcs[2].reason == "target-dead"
    rst = stats["reconfig"]
    assert rst["planned"] == 3 and rst["rollbacks"] == 1
    assert rst["unplanned"] >= 2 and rst["pending"] == 0
    assert "b" in f["hub_run"].params["filt"]
    assert stats["failover"]["parked_now"] == 0
    for run in runs:
        assert run.frames + run.skipped == TICKS
        assert len(run.sink_log[next(iter(run.sink_log))]) == run.frames
    assert f["hub_run"].frames == sum(r.frames for r in runs)
    assert stats["failover"]["parked_total"] > 0
    _pubsub_conserved(f, stats)
    assert f["cache_end"]["fingerprints"] <= f["cache_mid"]["fingerprints"]
    assert f["cache_end"]["executables"] <= f["cache_mid"]["executables"]


# ---------------------------------------------------------------------------
# tests/test_model_serving.py
# ---------------------------------------------------------------------------

MAX_SEQ = 32
GEN_MIX = ["4", "3;6", "5;2", "6"]


@pytest.fixture(scope="module")
def smoke_weights():
    jcfg = jax_ms.SERVE_MODELS["stablelm-smoke-flash"]()
    jp = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, tt.params_from_numpy(
        jax.device_get(jp), ms.SERVE_MODELS["stablelm-smoke-flash"](), "cpu")


def _mod(pkg):
    return jax_ms if pkg is Jax else ms


def _decode_soak(pkg, weights, new_params=None):
    """8 clients over 4 slots, a kill at 60 and revival at 90, a hot swap
    of ``lm`` at 140; ``new_params`` (port only) are the swap's weights."""
    kill_at, revive_at, swap_at = 60, 90, 140
    rt = pkg.runtime(query_batch=8)
    dev = pkg.device("hub")
    ps = _mod(pkg).serve_pipeline(model="stablelm-smoke-flash", slots=4,
                                  max_seq=MAX_SEQ)
    srv = dev.add_pipeline(ps, jit=False)
    srv.params["lm"] = weights[0 if pkg is Jax else 1]
    rt.add_device(dev)
    cls = []
    for i in range(8):
        cdev = pkg.device(f"tv{i}")
        cls.append(cdev.add_pipeline(_mod(pkg).client_pipeline(
            prompts=f"{i + 1},{i + 2}", gens=GEN_MIX[i % 4]), jit=False))
        rt.add_device(cdev)
    ex = dict(srv=srv, ps=ps)

    def swap():
        ex["old"] = srv.params["lm"]
        rc = rt.reconfigure(srv, srv.pipe.reconfig().swap(
            "lm", factory(pkg)("model_serve", model="stablelm-smoke-flash",
                               slots="4", max_seq=str(MAX_SEQ))),
            warm_ticks=1)
        if new_params is not None:
            rc.new_params["lm"] = new_params
        ex["rc"] = rc

    harness = Chaos(rt)
    harness.kill_server(kill_at, dev, ps.elements["ssrc"], crash=True)
    harness.revive_server(revive_at, dev, ps.elements["ssrc"])
    harness.at(swap_at, swap, "hot swap lm mid-run")
    harness.run(150)
    ex["cache_mid"] = cache_info(pkg)
    harness.run(TICKS - 150)
    ex.update(harness=harness, cache_end=cache_info(pkg))
    return rt, cls, ex


def test_decode_soak_conservation_through_churn_twin(smoke_weights):
    jax_ = _decode_soak(Jax, smoke_weights)
    jnew = jax_[2]["rc"].new_params["lm"]
    tnew = tt.params_from_numpy(jax.device_get(jnew),
                                ms.SERVE_MODELS["stablelm-smoke-flash"](),
                                "cpu")
    port = _decode_soak(Port, smoke_weights, new_params=tnew)
    check(port, jax_)
    rt, cls, ex = port
    qb = rt.stats()["query_batching"]
    assert qb["tokens_generated"] == qb["tokens_delivered"] + \
        qb["tokens_dropped"] + qb["tokens_in_flight"]
    assert qb["streams_finished"] >= 8 * 10
    assert qb["tokens_dropped"] > 0
    srv = ex["srv"]
    cfg = srv.pipe.elements["lm"].cfg
    refs = {}
    for i, run in enumerate(cls):
        gens = [int(g) for g in GEN_MIX[i % 4].split(";")]
        for j, b in enumerate(run.sink_log.get("res", [])):
            g, slot = gens[j % len(gens)], b.meta["slot"]
            ok = []
            for k, pr in enumerate((ex["old"], srv.params["lm"])):
                key = (k, i, g, slot)
                if key not in refs:
                    refs[key] = ms.sequential_decode(
                        pr, cfg, [i + 1, i + 2], g, MAX_SEQ, slots=4,
                        slot=slot, device="cpu")
                ok.append(refs[key])
            assert np.asarray(b.tensor).tolist() in ok, \
                f"client {i} answer {j} off-epoch"
    assert ex["cache_end"]["fingerprints"] <= ex["cache_mid"]["fingerprints"]
    assert ex["cache_end"]["executables"] <= ex["cache_mid"]["executables"]
    assert len(ex["ps"].elements["ssrc"].endpoint.responses) <= 8
    assert rt.stats()["failover"]["parked_now"] == 0


# ---------------------------------------------------------------------------
# tests/test_pp_staged_serving.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stage_weights():
    from test_torch_pp_staged_serving import W
    return W()


def _staged_soak(pkg, w):
    from test_torch_pp_staged_serving import client, staged, standby
    kill_at, revive_at = 60, 100
    rt = pkg.runtime(query_batch=8)
    stages = staged(pkg, rt, w, 2, slots=4)
    standby(pkg, rt, w, stage=1, n_stages=2, slots=4)
    cls = [client(pkg, rt, i, f"{i + 1},{i + 2}", GEN_MIX[i % 4])
           for i in range(8)]
    dev1, _, ps1 = stages[1]
    harness = Chaos(rt)
    harness.kill_server(kill_at, dev1, ps1.elements["ssrc"], crash=True)
    harness.revive_server(revive_at, dev1, ps1.elements["ssrc"])
    harness.run(TICKS)
    return rt, cls, dict(harness=harness)


def test_staged_soak_per_stage_conservation_twin(stage_weights):
    from test_torch_pp_staged_serving import coord
    w = stage_weights
    port, jax_ = _staged_soak(Port, w), _staged_soak(Jax, w)
    check(port, jax_)
    rt, cls, _ = port
    c = coord(rt)
    st = c.stats()
    assert st["tokens_generated"] == st["tokens_delivered"] + \
        st["tokens_dropped"] + st["tokens_in_flight"]
    assert st["tokens_dropped"] == 0
    assert st["streams_finished"] >= 8 * 10
    assert st["stage_replays"] >= 1
    for k in range(1, c.n_stages):
        led = c.stage_ledger(k)
        assert led["dispatched"] == led["completed"] + led["failed"], (k, led)
    refs = {}
    for i, run in enumerate(cls):
        gens = [int(g) for g in GEN_MIX[i % 4].split(";")]
        for j, b in enumerate(run.sink_log.get("res", [])):
            key = (i, gens[j % len(gens)], b.meta["slot"])
            if key not in refs:
                refs[key] = ms.sequential_decode(
                    w.tp, w.tcfg, [i + 1, i + 2], key[1], MAX_SEQ, slots=4,
                    slot=key[2], device="cpu")
            assert np.asarray(b.tensor).tolist() == refs[key], \
                f"client {i} answer {j}"


# ---------------------------------------------------------------------------
# tests/test_netfault.py
# ---------------------------------------------------------------------------

def _lossy_soak(pkg, weights, with_faults=True):
    """The 200-tick lossy soak: 5% drop, 2% dup and delay jitter on a plain
    query server (its request plane partitioned for ticks 80-100) and on a
    streaming server, both live in one runtime with the delivery layer.
    ``pkg`` is ``test_torch_netfault``'s P or J."""
    from chaoslib import lossy_endpoint
    from test_torch_netfault import J, clients, lm_client, policy, server
    lossy = dict(seed=51, drop=0.05, dup=0.02, delay=0.05,
                 delay_ticks=(1, 3))
    rt = pkg.runtime(query_batch=8, lease_ticks=4,
                     delivery=pkg.nf.DeliveryPolicy())
    _, _, ssrc = server(pkg, rt, name="hub")
    plain = clients(pkg, rt, 4)
    lmdev = pkg.device("lmhub")
    lmps = (jax_ms if pkg is J else ms).serve_pipeline(slots=8,
                                                       max_seq=MAX_SEQ)
    lmrun = lmdev.add_pipeline(lmps, jit=False)
    lmrun.params["lm"] = weights[0 if pkg is J else 1]
    rt.add_device(lmdev)
    lm = [lm_client(pkg, rt, i) for i in range(2)]
    fabric = None
    if with_faults:
        fabric = pkg.nf.FaultFabric()
        rt.fabric = fabric
        lossy_endpoint(fabric, ssrc.endpoint,
                       policy(pkg, {**lossy, "partitions": ((80, 100),)}),
                       policy(pkg, lossy), name="hub")
        lossy_endpoint(fabric, lmps.elements["ssrc"].endpoint,
                       policy(pkg, lossy), policy(pkg, lossy), name="lm")
    rt.run(TICKS)
    return rt, plain + lm, dict(fabric=fabric, plain=plain, lm=lm)


def test_200_tick_lossy_soak_conserves_everything_twin(smoke_weights):
    from test_torch_netfault import (P, assert_prefix_bitwise, check_twin,
                                     register_models, streaming_batcher,
                                     token_streams, twin)
    register_models()
    port, jax_ = twin(_lossy_soak, weights=smoke_weights)
    check_twin(port, jax_)
    rt, _, ex = port
    _, _, ref = _lossy_soak(P, smoke_weights, with_faults=False)
    # every client keeps answering well past the heal at tick 100
    assert_prefix_bitwise(ref["plain"], ex["plain"], min_answers=100)
    for r, g in zip(ref["lm"], ex["lm"]):
        a, b = token_streams(r), token_streams(g)
        assert len(b) >= len(a) // 2
        assert b == a[:len(b)]
    ex["fabric"].assert_conservation()
    st = rt.stats()
    d = st["delivery"]
    assert d["retransmits"] > 0 and d["deduped"] > 0
    assert sum(link["dropped_by_fault"]
               for link in st["netfault"].values()) > 0
    bs = streaming_batcher(rt).stats()
    assert bs["tokens_generated"] == bs["tokens_delivered"] + \
        bs["tokens_dropped"] + bs["tokens_in_flight"]
