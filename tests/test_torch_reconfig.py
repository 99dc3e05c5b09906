"""Live reconfiguration (DESIGN.md §6) in the port against the JAX
package, on the CPU.

Each test of ``tests/test_reconfig.py`` runs in both packages, plus
``test_exec_cache.py``'s swap-cycle churn.  Pinned for each: the
reference test's own assertions on the port's ``Runtime``; every sink log
equal to the JAX package's bitwise; the whole ``failover``, ``reconfig``,
``query_batching`` and ``tenants`` stats dicts equal key for key.

The swap-cycle churn counts the cache entries the port creates (where the
JAX package counts ``jax.jit`` calls): an unchanged fingerprint creates
none.  Through the stand-in graph of ``test_torch_graphs.py`` the port's
cached executables take the CUDA-graph path on the CPU, and a commit must
release the graph bindings keyed on the params it retired: the live graphs
stay bounded across swap cycles.

The swapped models are elementwise with fixed arrays of quarters, so both
packages compute them exactly and a swapped-in element's params are what
a fresh build holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TensorSpec as JSpec
from repro.core import plan as jplan
from repro.core.element import element_factory as jfactory
from repro.core.elements import register_model as jregister
from repro_torch.core import TensorSpec
from repro_torch.core import plan as plan_mod
from repro_torch.core.element import element_factory
from repro_torch.core.elements import register_model
from repro_torch.core.graphs import GraphedCallable
from repro_torch.core.reconfig import ReconfigError
from test_torch_failover import (Jax, Port, check_twin, clients, responses,
                                 same_logs, server, twin)
from test_torch_graphs import fake_graphs

torch.set_num_threads(2)

pytestmark = pytest.mark.reconfig

WA = ((np.arange(12).reshape(2, 2, 3) % 5 - 2) / 4).astype(np.float32)
WB = ((np.arange(12).reshape(2, 2, 3)[::-1] % 7 - 3) / 4).astype(np.float32)
WC = np.full((2, 2, 3), 0.75, np.float32)


@pytest.fixture(scope="module", autouse=True)
def models():
    out = (2, 2, 3)
    for name, w, b in (("rcA", WA, None), ("rcB", WB, 0.5),
                       ("churnA", WA, None), ("churnB", WB, None),
                       ("churnC", WC, None)):
        def init(g, dev, w=w, b=b):
            p = {"w": torch.tensor(w, device=dev)}     # a copy per init
            if b is not None:
                p["b"] = torch.full((), b, device=dev)
            return p

        def jinit(rng, w=w, b=b):
            p = {"w": jnp.asarray(w)}
            if b is not None:
                p["b"] = jnp.full((), b, jnp.float32)
            return p
        if b is None:
            register_model(name, init,
                           lambda p, x: x.to(torch.float32) * p["w"],
                           out_specs=(TensorSpec(out, "float32"),))
            jregister(name, jinit,
                      lambda p, x: x.astype(jnp.float32) * p["w"],
                      out_specs=(JSpec(out, "float32"),))
        else:
            register_model(name, init,
                           lambda p, x: x.to(torch.float32) * p["w"] * p["b"],
                           out_specs=(TensorSpec(out, "float32"),))
            jregister(name, jinit,
                      lambda p, x: x.astype(jnp.float32) * p["w"] * p["b"],
                      out_specs=(JSpec(out, "float32"),))


def factory(pkg):
    return element_factory if pkg is Port else jfactory


def _swap_filt(pkg, run, model):
    return run.pipe.reconfig().swap(
        "filt", factory(pkg)("tensor_filter", model=model))


class TestHotSwap:
    @pytest.mark.parametrize("query_batch", [1, 4, 8])
    def test_swap_commits_at_tick_boundary_bitwise_identical(self,
                                                             query_batch):
        """Swap the serving model under live traffic: every answer before
        the commit tick is the old model's, every answer from it on is
        what a pipeline BUILT with the new model computes, none is lost."""
        ticks_pre, ticks_post, n_clients = 4, 6, 3
        total = ticks_pre + ticks_post

        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=query_batch)
            _, hub_run, _ = server(pkg, rt, model="rcA", operation="svc")
            cl = clients(pkg, rt, n_clients, operation="svc")
            rt.run(ticks_pre)
            rc = rt.reconfigure(hub_run, _swap_filt(pkg, hub_run, "rcB"),
                                warm_ticks=1)
            status = rc.status
            rt.run(ticks_post)
            return rt, cl, dict(rc=rc, status=status, hub=hub_run)

        def fresh(pkg, chaos, model):
            rt = pkg.runtime(query_batch=query_batch)
            server(pkg, rt, model=model, operation="svc")
            cl = clients(pkg, rt, n_clients, operation="svc")
            rt.run(total)
            return rt, cl, {}

        port, jax_ = twin(scenario)
        check_twin(port, jax_)
        refs = {m: twin(fresh, model=m)[0][1] for m in ("rcA", "rcB")}
        rt, cl, ex = port
        rc = ex["rc"]
        assert ex["status"] == "warming"
        assert rc.status == "committed"
        assert rc.committed_tick == ticks_pre + 2
        assert jax_[2]["rc"].committed_tick == rc.committed_tick
        cut = rc.committed_tick - 1
        for ref_a, ref_b, got in zip(refs["rcA"], refs["rcB"], cl):
            assert got.frames == total
            a, b, g = responses(ref_a), responses(ref_b), responses(got)
            assert len(g) == total
            for x, y in zip(a[:cut], g[:cut]):
                np.testing.assert_array_equal(x, y)
            for x, y in zip(b[cut:], g[cut:]):
                np.testing.assert_array_equal(x, y)
        assert "b" in ex["hub"].params["filt"]
        st = rt.stats()["reconfig"]
        assert st["planned"] == 1 and st["reconfigs"] == 1
        assert st["rollbacks"] == 0 and st["pending"] == 0

    def test_relink_and_remove_reroute_midstream(self):
        """Re-route around an element and drop it mid-stream (the callable
        edit form): the sink's dtype flips exactly at the commit tick."""
        def scenario(pkg, chaos):
            rt = pkg.runtime()
            dev = pkg.device("edge")
            p = pkg.parse(
                "testsrc name=s width=3 height=2 ! tensor_converter name=c "
                "! tensor_transform mode=arithmetic option=typecast:float32 "
                "name=t ! appsink name=o")
            run = dev.add_pipeline(p, jit=False)
            rt.add_device(dev)
            rt.run(4)
            rc = rt.reconfigure(run, lambda plan: plan.relink("c", "o")
                                .remove("t"), warm_ticks=1)
            rt.run(4)
            return rt, [run], dict(rc=rc, run=run)
        port, jax_ = twin(scenario)
        check_twin(port, jax_)
        rt, (run,), ex = port
        rc = ex["rc"]
        assert rc.status == "committed"
        assert "t" not in run.pipe.elements
        log = run.sink_log["o"]
        assert len(log) == 8
        cut = rc.committed_tick - 1
        assert all(b.tensor.dtype == torch.float32 for b in log[:cut])
        assert all(b.tensor.dtype == torch.uint8 for b in log[cut:])

    def test_remove_all_decommissions_and_clients_rebind(self):
        total = 8

        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=8)
            _, run_a, ssrc_a = server(pkg, rt, model="rcA", name="hubA",
                                      operation="svc")
            _, run_b, _ = server(pkg, rt, model="rcA", name="hubB",
                                 operation="svc")
            cl = clients(pkg, rt, 3, operation="svc")
            rt.run(3)
            rc = rt.reconfigure(run_a, run_a.pipe.reconfig()
                                .remove("ssrc").remove("filt")
                                .remove("ssink"), warm_ticks=1)
            rt.run(total - 3)
            return rt, cl, dict(rc=rc, run_a=run_a, run_b=run_b,
                                ssrc_a=ssrc_a)
        port, jax_ = twin(scenario)
        check_twin(port, jax_)
        rt, cl, ex = port
        assert ex["rc"].status == "committed"
        assert ex["run_a"].retired
        assert ex["ssrc_a"].registration is None
        assert all(r.frames == total for r in cl)
        assert ex["run_b"].frames >= 3 * (total - ex["rc"].committed_tick
                                          + 1)
        st = rt.stats()["reconfig"]
        assert st["planned"] == 1 and st["unplanned"] == 0

    def test_hot_add_pubsub_binding_publishes_at_commit(self):
        total_pre = 6

        def scenario(pkg, chaos):
            rt = pkg.runtime()
            edge = pkg.device("edge")
            p = pkg.parse("testsrc name=s width=2 height=2 ! "
                          "tensor_converter name=c ! appsink name=o")
            run = edge.add_pipeline(p, jit=False)
            rt.add_device(edge)
            rt.run(3)
            snk = factory(pkg)("mqttsink", name="snk", pub_topic="cam/live")
            rc = rt.reconfigure(run, lambda plan: plan.remove("o").add(snk)
                                .link("c", "snk"), warm_ticks=1)
            pre_commit = snk.registration
            rt.run(total_pre - 3)
            published = snk.channel.msgs_sent
            viewer = pkg.device("viewer")
            vp = pkg.parse("mqttsrc sub-topic=cam/live name=vsrc ! "
                           "appsink name=vo")
            vrun = viewer.add_pipeline(vp, jit=False)
            rt.add_device(viewer)
            rt.run(4)
            return rt, [run, vrun], dict(rc=rc, snk=snk, run=run,
                                         pre_commit=pre_commit,
                                         published=published, vrun=vrun)
        port, jax_ = twin(scenario)
        check_twin(port, jax_)
        rt, _, ex = port
        assert ex["pre_commit"] is None
        assert ex["rc"].status == "committed"
        assert ex["snk"].registration is not None
        assert ex["run"].frames == total_pre + 4
        assert ex["published"] == total_pre - ex["rc"].committed_tick + 1
        assert ex["vrun"].frames == ex["published"] + 4

    def test_commit_defers_while_frame_in_flight(self):
        """Drain: a client run with a parked frame does not cut over
        mid-frame; the commit lands at the boundary after it resolves."""
        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=8)
            dev, _, ssrc = server(pkg, rt, model="rcA", operation="svc")
            (cl_run,) = clients(pkg, rt, 1, operation="svc")
            harness = chaos(rt)
            harness.kill_server(3, dev, ssrc)
            harness.revive_server(7, dev, ssrc)
            harness.run(6)
            rc = rt.reconfigure(cl_run, cl_run.pipe.reconfig().swap(
                "res", factory(pkg)("appsink")), warm_ticks=0)
            harness.run(1)
            mid = rc.status
            harness.run(1)
            return rt, [cl_run], dict(harness=harness, rc=rc, mid=mid)
        port, jax_ = twin(scenario)
        check_twin(port, jax_)
        rt, (cl_run,), ex = port
        assert ex["mid"] == "draining"
        assert ex["rc"].status == "committed"
        assert cl_run.frames == 4
        assert rt.stats()["failover"]["parked_now"] == 0


class TestRollback:
    def test_failed_prepare_rolls_back_with_explicit_stats(self):
        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=4)
            _, hub_run, _ = server(pkg, rt, model="rcA", operation="svc")
            cl = clients(pkg, rt, 2, operation="svc")
            rt.run(3)
            rc = rt.reconfigure(hub_run, hub_run.pipe.reconfig().swap(
                "nope", factory(pkg)("tensor_filter", model="rcB")))
            rc2 = rt.reconfigure(
                hub_run, hub_run.pipe.reconfig().relink("ghost", "ssink"))
            rt.run(3)
            return rt, cl, dict(rc=rc, rc2=rc2, hub=hub_run)
        port, jax_ = twin(scenario)
        check_twin(port, jax_)
        rt, cl, ex = port
        assert ex["rc"].status == "rolled_back"
        assert ex["rc"].reason == "prepare-failed"
        assert isinstance(ex["rc"].error, ReconfigError)
        assert ex["rc2"].status == "rolled_back"
        assert all(r.frames == 6 for r in cl)
        assert "b" not in ex["hub"].params["filt"]
        st = rt.stats()["reconfig"]
        assert st["rollbacks"] == 2
        assert st["planned"] == 0 and st["pending"] == 0

    def test_chaos_kill_mid_warm_rolls_back_never_limbo(self):
        total = 8

        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=8)
            dev_a, run_a, _ = server(pkg, rt, model="rcA", name="hubA",
                                     operation="svc")
            _, run_b, _ = server(pkg, rt, model="rcA", name="hubB",
                                 operation="svc")
            cl = clients(pkg, rt, 3, operation="svc")
            harness = chaos(rt)
            box = []
            harness.at(4, lambda: box.append(rt.reconfigure(
                run_a, _swap_filt(pkg, run_a, "rcB"), warm_ticks=3)),
                label="request swap on hubA")
            harness.kill_server(5, dev_a, run_a.pipe.elements["ssrc"])
            harness.run(total)
            return rt, cl, dict(harness=harness, rc=box[0], run_a=run_a,
                                run_b=run_b)
        port, jax_ = twin(scenario)
        check_twin(port, jax_)
        rt, cl, ex = port
        assert ex["rc"].status == "rolled_back"
        assert ex["rc"].reason == "target-dead"
        assert "b" not in ex["run_a"].params["filt"]
        st = rt.stats()["reconfig"]
        assert st["pending"] == 0 and st["rollbacks"] == 1
        assert st["unplanned"] >= 1
        assert all(r.frames == total for r in cl)
        assert ex["run_b"].frames >= 3 * (total - 5)


class TestFailoverIsAReconfiguration:
    def test_initial_construction_counts_no_reconfigs(self):
        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=4)
            server(pkg, rt, model="rcA", operation="svc")
            cl = clients(pkg, rt, 2, operation="svc")
            rt.run(3)
            return rt, cl, {}
        port, jax_ = twin(scenario)
        check_twin(port, jax_)
        assert port[0].stats()["reconfig"]["reconfigs"] == 0

    def test_kill_and_revival_are_unplanned_reconfigurations(self):
        total = 8

        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=8)
            dev_a, _, ssrc_a = server(pkg, rt, model="rcA", name="hubA",
                                      operation="svc")
            server(pkg, rt, model="rcA", name="hubB", operation="svc")
            cl = clients(pkg, rt, 2, operation="svc")
            harness = chaos(rt)
            harness.kill_server(3, dev_a, ssrc_a)
            harness.revive_server(6, dev_a, ssrc_a)
            harness.run(total)
            return rt, cl, dict(harness=harness)
        port, jax_ = twin(scenario)
        check_twin(port, jax_)
        rt, cl, _ = port
        st = rt.stats()["reconfig"]
        assert st["unplanned"] == 2 and st["planned"] == 0
        assert [(k, s) for _, k, s, _ in rt.reconfig.log] == \
            [("unplanned", "down"), ("unplanned", "register")]
        assert rt.reconfig.log == jax_[0].reconfig.log
        assert all(r.frames == total for r in cl)


# ---------------------------------------------------------------------------
# test_exec_cache.py: swap cycles interleaved with failover churn
# ---------------------------------------------------------------------------

def _churn_fleet(pkg, jit):
    rt = pkg.runtime(query_batch=8)
    _, hub_run, _ = server(pkg, rt, model="churnA", operation="churn",
                           jit=jit)
    bak, _, bssrc = server(pkg, rt, model="churnA", name="bak",
                           operation="churn", jit=jit)
    (cl_run,) = clients(pkg, rt, 1, operation="churn", jit=jit)
    return rt, hub_run, (bak, bssrc), cl_run


def _cycle(pkg, chaos, rt, hub_run, bak, bssrc, model):
    """One churn cycle: a planned swap of the serving model with a kill
    and revival of the backup server inside its warm window."""
    t = rt.ticks
    harness = chaos(rt)
    harness.kill_server(t + 1, bak, bssrc)
    harness.revive_server(t + 2, bak, bssrc)
    rc = rt.reconfigure(hub_run, _swap_filt(pkg, hub_run, model),
                        warm_ticks=1)
    harness.run(3)
    assert rc.status == "committed"
    return rc


CHURN = ("churnB", "churnA", "churnB", "churnA")


def test_swap_cycles_never_retrace_unchanged_fingerprints(monkeypatch):
    """Once both swap targets were seen, four more swap cycles (each with
    a kill and revival of the backup inside its warm window) create no
    cache entry in the port and no jit in the JAX package; a genuinely new
    topology does create entries.  Sink logs and stats equal the JAX
    package's throughout."""
    from chaoslib import Chaos
    plan_mod.clear_executable_cache()
    jplan.clear_executable_cache()
    made, jits = [], []
    monkeypatch.setattr(plan_mod, "GraphedCallable", lambda *a, **k: (
        made.append(a) or GraphedCallable(*a, **k)))
    orig_jit = jax.jit
    fleets = {}
    for pkg in (Port, Jax):
        rt, hub_run, (bak, bssrc), cl_run = _churn_fleet(pkg, jit=True)
        rt.run(2)
        _cycle(pkg, Chaos, rt, hub_run, bak, bssrc, "churnB")
        _cycle(pkg, Chaos, rt, hub_run, bak, bssrc, "churnA")
        fleets[pkg] = (rt, hub_run, bak, bssrc, cl_run)
    info_warm = plan_mod.executable_cache_info()
    n_made = len(made)
    monkeypatch.setattr(jax, "jit", lambda *a, **k: (
        jits.append(a) or orig_jit(*a, **k)))
    for pkg in (Port, Jax):
        rt, hub_run, bak, bssrc, cl_run = fleets[pkg]
        for model in CHURN:
            _cycle(pkg, Chaos, rt, hub_run, bak, bssrc, model)
        assert cl_run.frames == rt.ticks
    assert len(made) == n_made and jits == []
    assert plan_mod.executable_cache_info() == info_warm
    (prt, phub, pbak, pbssrc, pcl), jf = fleets[Port], fleets[Jax]
    same_logs([pcl], [jf[4]])
    check_twin((prt, [pcl], {}), (jf[0], [jf[4]], {}))
    # control: a new topology creates entries through the counted call
    _cycle(Port, Chaos, prt, phub, pbak, pbssrc, "churnC")
    assert len(made) > n_made
    assert plan_mod.executable_cache_info()["fingerprints"] > \
        info_warm["fingerprints"]
    plan_mod.clear_executable_cache()
    jplan.clear_executable_cache()


def test_swap_cycles_release_graph_bindings(monkeypatch):
    """Through the stand-in graph, every cached executable keeps a graph
    per binding, keyed on the params' addresses.  Each swap gives the
    server fresh params, so without the release at commit each cycle would
    pin one more graph; with it the live graphs after the fourth cycle are
    at most those after the first plus one binding, and the answers equal
    a ``jit=False`` twin's bitwise."""
    from chaoslib import Chaos
    fake_graphs(monkeypatch)
    rt, hub_run, (bak, bssrc), cl_run = _churn_fleet(Port, jit=True)
    ert, ehub, (ebak, ebssrc), ecl = _churn_fleet(Port, jit=False)
    rt.run(2)
    ert.run(2)
    live, held = [], []
    for model in CHURN:
        # retired params stay alive here, so no later params can take
        # their addresses (a reused address would hide a leaked binding)
        held.append(hub_run.params)
        _cycle(Port, Chaos, rt, hub_run, bak, bssrc, model)
        _cycle(Port, Chaos, ert, ehub, ebak, ebssrc, model)
        live.append(plan_mod.executable_cache_info()["graphs"])
    assert live[0] > 0
    assert live[-1] <= live[0] + 1, live
    same_logs([cl_run], [ecl])
    assert cl_run.frames == rt.ticks
    plan_mod.clear_executable_cache()
