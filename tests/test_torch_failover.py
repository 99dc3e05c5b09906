"""Failover (DESIGN.md §3) in the port against the JAX package, on the CPU.

Each scenario of ``tests/test_failover.py``, ``test_query_batching.py``'s
mid-stream failover and ``test_runtime_overload.py`` runs in both packages
through the same deterministic chaos harness (``tests/chaoslib.py``):
scripted kills, revivals and lease expiries at chosen ticks.  Pinned for
each:

* the reference test's own assertions, now on the port's ``Runtime``;
* every client's sink log (answers and park-deadline error frames) equals
  the JAX package's bitwise, and so does the port's fault-free twin where
  the reference test has one;
* the whole ``stats()["failover"]``, ``["reconfig"]``,
  ``["query_batching"]`` and ``["tenants"]`` dicts equal the JAX
  package's, key for key, and so do the harness logs.

The server model is elementwise, ``y = float32(x) * W`` with W a fixed
array of quarters, so both packages compute it exactly, whatever a codec
did to the request.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Channel as JChannel
from repro.core import StreamBuffer as JBuffer
from repro.core import TensorSpec as JSpec
from repro.core import parse_launch as jparse
from repro.core.elements import register_model as jregister
from repro.runtime import Device as JDevice
from repro.runtime import Runtime as JRuntime
from repro_torch.core import Channel, StreamBuffer, TensorSpec, parse_launch
from repro_torch.core.elements import register_model
from repro_torch.runtime import Device, Runtime

torch.set_num_threads(2)

W = ((np.arange(12).reshape(2, 2, 3) % 7 - 3) / 4).astype(np.float32)


class Port:
    parse = staticmethod(parse_launch)

    @staticmethod
    def runtime(**kw):
        return Runtime(device="cpu", **kw)

    @staticmethod
    def device(name):
        return Device(name, device="cpu")


class Jax:
    parse = staticmethod(jparse)
    runtime = JRuntime
    device = JDevice


PKGS = (Port, Jax)


@pytest.fixture(scope="module", autouse=True)
def models():
    out = (2, 2, 3)
    register_model("fo_twin", lambda g, dev: {
        "w": torch.as_tensor(W, device=dev)},
        lambda p, x: x.to(torch.float32) * p["w"],
        out_specs=(TensorSpec(out, "float32"),))
    jregister("fo_twin", lambda rng: {"w": jnp.asarray(W)},
              lambda p, x: x.astype(jnp.float32) * p["w"],
              out_specs=(JSpec(out, "float32"),))


def server(pkg, rt, name="hub", operation="op", model="fo_twin", jit=False,
           **specs):
    """One serving device; -> (device, run, serversrc).  Every server of a
    package computes the same answers, so a survivor is the fault-free
    twin."""
    dev = pkg.device(name)
    extra = " ".join(f"{k}={v}" for k, v in specs.items())
    ps = pkg.parse(
        f"tensor_query_serversrc operation={operation} name=ssrc {extra} ! "
        f"tensor_filter model={model} name=filt ! "
        f"tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    run = dev.add_pipeline(ps, jit=jit)
    rt.add_device(dev)
    return dev, run, ps.elements["ssrc"]


def clients(pkg, rt, n, operation="op", codec="none", prefix="tv",
            jit=False):
    runs = []
    for i in range(n):
        dev = pkg.device(f"{prefix}{i}")
        pc = pkg.parse(
            f"testsrc width=2 height=2 ! tensor_converter ! "
            f"tensor_query_client operation={operation} codec={codec} "
            f"name=qc ! appsink name=res")
        runs.append(dev.add_pipeline(pc, jit=jit))
        rt.add_device(dev)
    return runs


def responses(run):
    return [np.asarray(b.tensor) for b in run.sink_log.get("res", [])]


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _plain(v):
    """Stats and meta values as Python numbers, at any depth."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, (np.generic, np.ndarray)) or hasattr(v, "item"):
        return np.asarray(_host(v)).item()
    return v


def same_logs(port_runs, jax_runs, meta_of=("error", "operation",
                                            "parked_ticks", "redispatches",
                                            "tick")):
    """Every sink log of the port's runs equals the JAX runs' bitwise:
    tensors by value, dtype and shape, and the error frames' meta."""
    assert len(port_runs) == len(jax_runs)
    for pr, jr in zip(port_runs, jax_runs):
        assert sorted(pr.sink_log) == sorted(jr.sink_log)
        assert pr.frames == jr.frames
        for name in pr.sink_log:
            got, want = pr.sink_log[name], jr.sink_log[name]
            assert len(got) == len(want), name
            for g, w in zip(got, want):
                assert len(g.tensors) == len(w.tensors)
                for a, b in zip(g.tensors, w.tensors):
                    a, b = _host(a), np.asarray(b)
                    assert a.dtype == b.dtype and a.shape == b.shape
                    np.testing.assert_array_equal(a, b)
                keys = [k for k in meta_of if k in w.meta]
                assert {k: _plain(g.meta.get(k)) for k in keys} == \
                    {k: _plain(w.meta[k]) for k in keys}


STATS_KEYS = ("failover", "reconfig", "query_batching", "tenants")
#: the port's host timers, which the JAX package does not keep
PORT_ONLY = {"prefill_seconds", "decode_seconds"}


def _comparable(d):
    if isinstance(d, dict):
        return {k: _comparable(v) for k, v in d.items()
                if k not in PORT_ONLY}
    return _plain(d)


def same_stats(port_rt, jax_rt, keys=STATS_KEYS):
    got, want = port_rt.stats(), jax_rt.stats()
    for k in keys:
        assert _comparable(got[k]) == _comparable(want[k]), k


def twin(scenario, **kw):
    """Run ``scenario(pkg, chaos, **kw)`` in both packages; -> the port's
    result and the JAX package's, each ``(rt, client runs, extra)``."""
    from chaoslib import Chaos
    return scenario(Port, Chaos, **kw), scenario(Jax, Chaos, **kw)


def check_twin(port, jax, runs_key=1):
    (prt, pruns, pex), (jrt, jruns, jex) = port, jax
    same_logs(pruns, jruns)
    same_stats(prt, jrt)
    if isinstance(pex, dict) and "harness" in pex:
        assert pex["harness"].log == jex["harness"].log


# ---------------------------------------------------------------------------
# scenarios (one function per reference test, run in either package)
# ---------------------------------------------------------------------------

def _mid_batch(pkg, chaos, codec, fault):
    ticks, n_clients, kill_tick = 6, 6, 3
    rt = pkg.runtime(query_batch=8)
    devA, runA, ssrcA = server(pkg, rt, name="hubA")
    devB, runB, ssrcB = server(pkg, rt, name="hubB")
    cl = clients(pkg, rt, n_clients, codec=codec)
    harness = chaos(rt)
    if fault:
        harness.kill_server_mid_batch(kill_tick, devA, ssrcA, after_n=3)
    harness.run(ticks)
    return rt, cl, dict(harness=harness, runA=runA, runB=runB)


def _mid_flush(pkg, chaos, fault):
    ticks, kill_tick = 6, 3
    rt = pkg.runtime(query_batch=8)
    devA, runA, ssrcA = server(pkg, rt, name="hubA")
    devB, runB, ssrcB = server(pkg, rt, name="hubB")
    cl = clients(pkg, rt, 3) + clients(pkg, rt, 3, codec="quant8",
                                       prefix="q8tv")
    harness = chaos(rt)
    if fault:
        harness.kill_server_mid_flush(kill_tick, devA, ssrcA,
                                      runA.pipe.elements["ssink"],
                                      after_answers=3)
    harness.run(ticks)
    return rt, cl, dict(harness=harness, runA=runA, runB=runB)


class TestChaosAcceptance:
    @pytest.mark.parametrize("codec", ["none", "quant8"])
    def test_mid_batch_server_death_loses_nothing_bitwise(self, codec):
        """The server dies mid-gather with 3 of 6 requests stranded on it
        (with quant8, codec-fused batches in flight): the orphans
        re-dispatch to the survivor in the same tick, every answer is
        bitwise the fault-free twin's and the JAX package's."""
        ticks, n_clients, kill_tick = 6, 6, 3
        port, jax = twin(_mid_batch, codec=codec, fault=True)
        check_twin(port, jax)
        ref, _ = twin(_mid_batch, codec=codec, fault=False)
        rt, cl, ex = port
        assert any("mid-batch" in label and "DISARMED" not in label
                   for _, label in ex["harness"].log)
        for r0, r1 in zip(ref[1], cl):
            assert r1.frames == ticks
            a, b = responses(r0), responses(r1)
            assert len(a) == len(b) == ticks
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        fo = rt.stats()["failover"]
        assert fo["redispatches"] >= 1 and fo["parked_now"] == 0
        if codec == "quant8":
            qb = rt.stats()["query_batching"]
            assert qb["fused_frames"] == ticks * n_clients
        assert ex["runB"].frames >= (ticks - kill_tick) * n_clients

    def test_mid_flush_death_orphans_the_popped_remainder(self):
        """The death lands mid-serve, after the 3 plain answers: the 3
        quant8 requests the flush already popped go to the orphan ledger
        and re-dispatch, as do the 3 purged answers."""
        ticks, kill_tick = 6, 3
        port, jax = twin(_mid_flush, fault=True)
        check_twin(port, jax)
        ref, _ = twin(_mid_flush, fault=False)
        rt, cl, ex = port
        assert any("mid-flush" in label and "DISARMED" not in label
                   for _, label in ex["harness"].log)
        for r0, r1 in zip(ref[1], cl):
            assert r1.frames == ticks
            for x, y in zip(responses(r0), responses(r1)):
                np.testing.assert_array_equal(x, y)
        assert rt.stats()["query_batching"]["flush_orphans"] == 3
        fo = rt.stats()["failover"]
        assert fo["orphaned_requests"] >= 3 and fo["redispatches"] >= 6
        assert ex["runA"].frames == (kill_tick - 1) * 6 + 3
        assert ex["runB"].frames >= (ticks - kill_tick) * 6

    def test_dead_fleet_parks_then_recovers_within_two_ticks(self):
        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=8)
            dev, _, ssrc = server(pkg, rt)
            cl = clients(pkg, rt, 3)
            harness = chaos(rt)
            harness.kill_server(3, dev, ssrc, crash=True)
            harness.revive_server(6, dev, ssrc)
            harness.run(5)
            mid = (all(r.frames == 2 for r in cl),
                   rt.stats()["failover"]["parked_now"])
            revive_tick = rt.ticks + 1
            harness.run(2)
            return rt, cl, dict(harness=harness, mid=mid,
                                recovery=rt.ticks - revive_tick)
        port, jax = twin(scenario)
        check_twin(port, jax)
        rt, cl, ex = port
        assert ex["mid"] == (True, 3)
        assert ex["recovery"] <= 2
        assert rt.stats()["failover"]["parked_now"] == 0
        assert all(r.frames >= 3 for r in cl)

    def test_silent_death_detected_by_lease_expiry(self):
        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=8, lease_ticks=2)
            devA, _, ssrcA = server(pkg, rt, name="hubA")
            _, runB, _ = server(pkg, rt, name="hubB")
            cl = clients(pkg, rt, 4)
            harness = chaos(rt)
            harness.kill_server(4, devA, ssrcA, crash=False)
            harness.run(10)
            return rt, cl, dict(harness=harness, ssrcA=ssrcA, runB=runB)
        port, jax = twin(scenario)
        check_twin(port, jax)
        rt, cl, ex = port
        assert rt.broker.expiries >= 1
        assert ex["ssrcA"].registration.alive is False
        assert ex["ssrcA"].registration.down_reason == "lease-expired"
        assert all(r.frames == 10 for r in cl)
        assert ex["runB"].frames >= 4 * 6

    def test_forced_lease_expiry_fails_over(self):
        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=8, lease_ticks=50)
            devA, _, ssrcA = server(pkg, rt, name="hubA")
            _, runB, _ = server(pkg, rt, name="hubB")
            cl = clients(pkg, rt, 2)
            harness = chaos(rt)
            harness.expire_lease(4, devA, ssrcA.registration)
            harness.run(8)
            return rt, cl, dict(harness=harness, ssrcA=ssrcA, runB=runB)
        port, jax = twin(scenario)
        check_twin(port, jax)
        rt, cl, ex = port
        assert ex["ssrcA"].registration.down_reason == "lease-expired"
        assert rt.broker.expiries == 1
        assert all(r.frames == 8 for r in cl)
        assert ex["runB"].frames >= 2 * 5

    def test_leases_never_expire_for_heartbeating_devices(self):
        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=8, lease_ticks=1)
            server(pkg, rt)
            cl = clients(pkg, rt, 2)
            rt.run(8)
            return rt, cl, {}
        port, jax = twin(scenario)
        check_twin(port, jax)
        rt, cl, _ = port
        assert rt.broker.expiries == 0
        assert all(r.frames == 8 for r in cl)


class TestParkDeadline:
    def test_expiry_is_accounted_and_client_visible(self):
        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=8, park_deadline_ticks=3)
            dev, _, ssrc = server(pkg, rt)
            cl = clients(pkg, rt, 3)
            harness = chaos(rt)
            harness.kill_server(3, dev, ssrc, crash=True)
            harness.run(10)
            return rt, cl, dict(harness=harness)
        port, jax = twin(scenario)
        check_twin(port, jax)
        rt, cl, _ = port
        fo = rt.stats()["failover"]
        assert fo["parked_expired"] == 6 and fo["parked_now"] == 3
        assert rt.stats()["tenants"]["default"]["shed_reasons"] == {
            "deadline": 6}
        for r in cl:
            assert r.frames == 2
            errs = r.sink_log.get("qc.error", [])
            assert len(errs) == 2
            for e in errs:
                assert e.meta["error"] == "park-deadline"
                assert e.meta["operation"] == "op"
                assert e.meta["parked_ticks"] == 3
                assert e.tensors == ()

    def test_recovery_before_deadline_expires_nothing(self):
        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=8, park_deadline_ticks=5)
            dev, _, ssrc = server(pkg, rt)
            cl = clients(pkg, rt, 3)
            harness = chaos(rt)
            harness.kill_server(3, dev, ssrc, crash=True)
            harness.revive_server(5, dev, ssrc)
            harness.run(8)
            return rt, cl, dict(harness=harness)
        port, jax = twin(scenario)
        check_twin(port, jax)
        rt, cl, _ = port
        fo = rt.stats()["failover"]
        assert fo["parked_expired"] == 0 and fo["parked_now"] == 0
        for r in cl:
            assert "qc.error" not in r.sink_log
            assert r.frames == 8 - 2

    def test_deadline_measures_total_time_parked(self):
        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=8, park_deadline_ticks=4)
            dev, _, ssrc = server(pkg, rt)
            cl = clients(pkg, rt, 1)
            harness = chaos(rt)
            harness.kill_server(3, dev, ssrc, crash=True)
            harness.run(6)
            before = rt.stats()["failover"]["parked_expired"]
            harness.run(1)
            return rt, cl, dict(harness=harness, before=before)
        port, jax = twin(scenario)
        check_twin(port, jax)
        rt, _, ex = port
        assert ex["before"] == 0
        assert rt.stats()["failover"]["parked_expired"] == 1


class TestResponseChannelLifecycle:
    def test_kill_revive_cycles_keep_channels_bounded(self):
        def scenario(pkg, chaos):
            n_clients = 4
            rt = pkg.runtime(query_batch=8)
            devA, _, ssrcA = server(pkg, rt, name="hubA")
            server(pkg, rt, name="hubB")
            cl = clients(pkg, rt, n_clients)
            rt.run(2)
            ep = ssrcA.endpoint
            sizes = [len(ep.responses)]
            for _ in range(3):
                harness = chaos(rt)
                t = rt.ticks
                harness.kill_server(t + 1, devA, ssrcA)
                harness.revive_server(t + 3, devA, ssrcA)
                harness.run(5)
                sizes.append(len(ep.responses))
            return rt, cl, dict(sizes=sizes)
        port, jax = twin(scenario)
        check_twin(port, jax)
        rt, cl, ex = port
        assert ex["sizes"] == jax[2]["sizes"]
        assert ex["sizes"][0] == 4 and max(ex["sizes"][1:]) <= 4
        assert all(r.frames == rt.ticks for r in cl)

    def test_down_event_purges_channels_not_just_queues(self):
        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=8)
            _, _, ssrc = server(pkg, rt)
            cl = clients(pkg, rt, 3)
            rt.run(1)
            before = len(ssrc.endpoint.responses)
            ssrc.endpoint.alive = False
            rt.broker.mark_down(ssrc.registration)
            return rt, cl, dict(sizes=(before, len(ssrc.endpoint.responses)))
        port, jax = twin(scenario)
        check_twin(port, jax)
        assert port[2]["sizes"] == jax[2]["sizes"] == (3, 0)

    def test_client_churn_across_outages_does_not_accumulate(self):
        def scenario(pkg, chaos):
            rt = pkg.runtime(query_batch=8)
            dev, _, ssrc = server(pkg, rt)
            cl = clients(pkg, rt, 2)
            rt.run(1)
            harness = chaos(rt)
            for c in range(3):
                t = rt.ticks
                harness.kill_server(t + 1, dev, ssrc)
                harness.revive_server(t + 2, dev, ssrc)
                harness.run(3)
                cl += clients(pkg, rt, 2, prefix=f"gen{c}_")
            rt.run(1)
            return rt, cl, dict(harness=harness,
                                n=len(ssrc.endpoint.responses))
        port, jax = twin(scenario)
        check_twin(port, jax)
        assert port[2]["n"] == jax[2]["n"] and port[2]["n"] <= 8


def test_runtime_refreshes_load_from_queue_depth():
    def scenario(pkg, chaos):
        rt = pkg.runtime(query_batch=8)
        _, _, ssrc = server(pkg, rt)
        cl = clients(pkg, rt, 2)
        rt.run(1)
        return rt, cl, dict(load=ssrc.registration.load)
    port, jax = twin(scenario)
    check_twin(port, jax)
    assert port[2]["load"] == jax[2]["load"] == 0.0


def test_failover_mid_stream_keeps_batching():
    """``test_query_batching.py``'s pin: after the first server dies, all
    four clients re-bind to the second and are served in one batch."""
    def scenario(pkg, chaos):
        rt = pkg.runtime(query_batch=8)
        _, run1, ssrc1 = server(pkg, rt, name="hub1")
        _, run2, ssrc2 = server(pkg, rt, name="hub2")
        cl = clients(pkg, rt, 4)
        rt.run(1)
        first = (run1.frames, run2.frames)
        ssrc1.endpoint.alive = False
        rt.broker.mark_down(ssrc1.registration)
        rt.run(2)
        return rt, cl, dict(first=first, run2=run2)
    port, jax = twin(scenario)
    check_twin(port, jax)
    rt, cl, ex = port
    assert ex["first"] == (4, 0)
    assert ex["run2"].frames == 8
    assert all(r.frames == 3 for r in cl)
    assert rt.stats()["query_batching"]["batches"] == 3


# ---------------------------------------------------------------------------
# test_runtime_overload.py: leaky queues under a slow consumer
# ---------------------------------------------------------------------------

def _slow_consumer(pkg):
    rt = pkg.runtime()
    pub = pkg.device("cam")
    p = pkg.parse("testsrc width=8 height=8 ! tensor_converter ! "
                  "mqttsink pub-topic=live name=snk")
    pub.add_pipeline(p, jit=False)
    rt.add_device(pub)
    sub = pkg.device("screen")
    s = pkg.parse("mqttsrc sub-topic=live name=src ! appsink name=o")
    sub.add_pipeline(s, jit=False)
    rt.add_device(sub)
    run = sub.runs[0]
    for t in range(60):
        rt._ntp_ref.advance(rt.tick_ns)
        for dev in rt.devices:
            dev.clock.advance(rt.tick_ns)
        rt._run_once(pub.runs[0])
        if t % 3 == 0 and rt._ready(run):
            rt._run_once(run)
    rx = s.elements["src"]._rx
    return run, rx


def test_leaky_channel_bounds_latency_under_slow_consumer():
    (prun, prx), (jrun, jrx) = _slow_consumer(Port), _slow_consumer(Jax)
    assert prx is not None
    assert len(prx) <= prx.capacity and prx.drops > 0
    assert (len(prx), prx.drops) == (len(jrx), jrx.drops)
    same_logs([prun], [jrun])
    nxt, jnxt = prx.pop(), jrx.pop()
    assert int(nxt.pts) == int(jnxt.pts) >= 0
    np.testing.assert_array_equal(_host(nxt.tensor), np.asarray(jnxt.tensor))


def test_channel_capacity_one_keeps_only_freshest():
    ch, jch = Channel(capacity=1), JChannel(capacity=1)
    for i in range(5):
        ch.push(StreamBuffer(tensors=(torch.full((1,), float(i)),)))
        jch.push(JBuffer(tensors=(jnp.full((1,), float(i)),)))
    assert ch.drops == jch.drops == 4
    assert float(ch.pop().tensor[0]) == float(jch.pop().tensor[0]) == 4.0
