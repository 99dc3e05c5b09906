"""``Runtime.stats()`` of the port equals the JAX package's, key for key.

Five scenarios run in both packages on the CPU, and their whole stats
dicts are compared:

* a pub/sub pair (``testsrc ! ... ! mqttsink`` to ``mqttsrc ! appsink``),
  with no query server deployed, so ``query_batching`` holds only the keys
  every batcher reports, as 0;
* two clients offloading with ``codec=quant8`` to one ``tensor_filter``
  server, at ``query_batch`` 8 and 0;
* ``stablelm-smoke-flash`` serving 3 clients over 2 slots, the port on
  the JAX package's weights (``params_from_numpy``);
* the same server twice, the first killed mid-generation and revived:
  the streams re-dispatch to the second by prefill replay, and the revived
  server's slot table still holds the lanes of the streams it lost, which
  decode with no record listening until new streams overwrite them or
  their budget drains (``batched_frames`` counts them in both packages);
* ``stablelm-smoke-4l`` split into 2 stage pipelines serving 3 clients,
  stage 1 killed mid-generation: with a standby it is replayed there, with
  none the chain stalls until it revives (the coordinator's and the hop
  servers' keys: hops, stage prefills, replays and replay steps, slot
  steps, parked caches).

Left out of the comparison: the port's extra ``prefill_seconds`` and
``decode_seconds`` (host clocks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TensorSpec as JSpec
from repro.core import parse_launch as jparse
from repro.core.elements import register_model as jregister
from repro.launch import model_serve as jax_ms
from repro.runtime import Device as JDevice
from repro.runtime import Runtime as JRuntime
from repro_torch.core import TensorSpec, parse_launch
from repro_torch.core.elements import register_model
from repro_torch.launch import model_serve as ms
from repro_torch.models import transformer as tt
from repro_torch.runtime import Device, Runtime

torch.set_num_threads(2)

ROWS, CHANNELS = 8, 128
W = (0.05 * np.random.default_rng(16).standard_normal(
    (CHANNELS, CHANNELS))).astype(np.float32)
#: keys the port reports in addition (host clocks)
NOT_COMPARED = {"prefill_seconds", "decode_seconds"}


class Port:
    parse = staticmethod(parse_launch)

    @staticmethod
    def runtime(**kw):
        return Runtime(device="cpu", **kw)

    @staticmethod
    def device(name):
        return Device(name, device="cpu")

    @staticmethod
    def add(dev, pipe):
        return dev.add_pipeline(pipe)


class Jax:
    parse = staticmethod(jparse)
    runtime = JRuntime
    device = JDevice

    @staticmethod
    def add(dev, pipe):
        return dev.add_pipeline(pipe)


@pytest.fixture(scope="module", autouse=True)
def models():
    register_model("stats_gate", lambda g, dev: {
        "w": torch.as_tensor(W, device=dev)},
        lambda p, x: x * torch.sigmoid(x @ p["w"]),
        out_specs=(TensorSpec((1, ROWS, CHANNELS), "float32"),))
    jregister("stats_gate", lambda rng: {"w": jnp.asarray(W)},
              lambda p, x: x * (1.0 / (1.0 + jnp.exp(-(x @ p["w"])))),
              out_specs=(JSpec((1, ROWS, CHANNELS), "float32"),))


def _comparable(stats):
    """The stats dict without the keys named in NOT_COMPARED, at any
    depth, with numbers as Python numbers."""
    if isinstance(stats, dict):
        return {k: _comparable(v) for k, v in stats.items()
                if k not in NOT_COMPARED}
    if isinstance(stats, (list, tuple)):
        return [_comparable(v) for v in stats]
    if isinstance(stats, (np.generic, np.ndarray)) or hasattr(stats, "item"):
        return np.asarray(stats).item()
    return stats


def _pub_sub(pkg):
    rt = pkg.runtime()
    pub, sub = pkg.device("pub"), pkg.device("sub")
    pkg.add(pub, pkg.parse(
        "testsrc width=8 height=8 ! tensor_converter ! tensor_transform "
        "mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
        "mqttsink pub-topic=t transport=relay"))
    rt.add_device(pub)
    pkg.add(sub, pkg.parse("mqttsrc sub-topic=t transport=relay ! "
                           "appsink name=o"))
    rt.add_device(sub)
    rt.run(4)
    return rt


def _offload(pkg, query_batch):
    rt = pkg.runtime(query_batch=query_batch)
    hub = pkg.device("hub")
    ps = pkg.parse("tensor_query_serversrc operation=op name=ssrc ! "
                   "tensor_filter model=stats_gate ! "
                   "tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    pkg.add(hub, ps)
    rt.add_device(hub)
    for i in range(2):
        dev = pkg.device(f"tv{i}")
        pkg.add(dev, pkg.parse(
            f"testsrc width={ROWS} height=1 channels={CHANNELS} ! "
            f"tensor_converter ! tensor_transform mode=arithmetic "
            f"option=typecast:float32,add:-127.5,div:{100 + 20 * i} ! "
            f"tensor_query_client operation=op codec=quant8 name=qc ! "
            f"appsink name=res"))
        rt.add_device(dev)
    rt.run(3)
    return rt


def _serving(pkg, jax_params=None):
    rt = pkg.runtime()
    hub = pkg.device("hub")
    srv = pkg.add(hub, (jax_ms if pkg is Jax else ms).serve_pipeline(
        model="stablelm-smoke-flash", slots=2, max_seq=16))
    if pkg is Port:
        srv.params["lm"] = jax_params
    rt.add_device(hub)
    mod = jax_ms if pkg is Jax else ms
    for i in range(3):
        dev = pkg.device(f"tv{i}")
        pkg.add(dev, mod.client_pipeline(prompts=f"{i + 1},{i + 2}",
                                         gens=f"{3 + i}"))
        rt.add_device(dev)
    rt.run(10)
    return rt, srv


def _kill_revive(pkg, jax_params=None):
    """Two stablelm-smoke-flash servers of 4 slots, 3 clients; the first
    server dies at tick 3 with its streams mid-generation and revives at
    tick 6.  -> (runtime, first server's run, lanes it decoded with no
    record listening)."""
    from chaoslib import Chaos
    rt = pkg.runtime()
    mod = jax_ms if pkg is Jax else ms
    hubs = []
    for name in ("hubA", "hubB"):
        dev = pkg.device(name)
        run = pkg.add(dev, mod.serve_pipeline(model="stablelm-smoke-flash",
                                              slots=4, max_seq=16))
        if pkg is Port:
            run.params["lm"] = jax_params
        rt.add_device(dev)
        hubs.append((dev, run))
    for i in range(3):
        dev = pkg.device(f"tv{i}")
        pkg.add(dev, mod.client_pipeline(prompts=f"{i + 1},{i + 2};{i + 3}",
                                         gens="5;2"))
        rt.add_device(dev)
    (devA, runA), _ = hubs
    harness = Chaos(rt)
    harness.kill_server(3, devA, runA.pipe.elements["ssrc"], crash=True)
    harness.revive_server(6, devA, runA.pipe.elements["ssrc"])
    stale = 0
    for _ in range(14):
        harness.run(1)
        b = next(b for b in rt._batchers.values() if b.run is runA)
        active = np.asarray(runA.state["lm"]["active"]).sum()
        stale = max(stale, int(active) - len(b._slots))
    return rt, runA, stale


def _same_stats(port_rt, jax_rt):
    got, want = _comparable(port_rt.stats()), _comparable(jax_rt.stats())
    assert got == want


def test_pub_sub_pair_reports_the_reference_keys():
    rt, jrt = _pub_sub(Port), _pub_sub(Jax)
    _same_stats(rt, jrt)
    qb = rt.stats()["query_batching"]
    assert qb["sharded_batches"] == qb["flush_orphans"] == 0
    assert set(rt.stats()["failover"]) == {
        "redispatches", "parked_total", "parked_now", "inflight_now",
        "parked_expired", "orphaned_requests"}


@pytest.mark.parametrize("query_batch", [8, 0])
def test_quant8_offload_stats_match(query_batch):
    rt, jrt = _offload(Port, query_batch), _offload(Jax, query_batch)
    _same_stats(rt, jrt)
    tenants = rt.stats()["tenants"]
    if query_batch:
        assert tenants and all("p50_ticks" in t and "p99_ticks" in t
                               for t in tenants.values())


def test_model_serving_stats_match():
    jrt, jsrv = _serving(Jax)
    tp = tt.params_from_numpy(jax.device_get(jsrv.params["lm"]),
                              jsrv.pipe.elements["lm"].cfg, "cpu")
    rt, _ = _serving(Port, tp)
    _same_stats(rt, jrt)
    qb = rt.stats()["query_batching"]
    assert qb["streams_finished"] >= 3 and qb["decode_ticks"] > 0
    assert qb["tokens_generated"] == qb["tokens_delivered"] + \
        qb["tokens_dropped"] + qb["tokens_in_flight"]


def test_kill_and_revive_stats_match():
    """A kill mid-generation, prefill replay on the survivor, a revival
    with stale lanes in the revived server's slot table: the whole stats
    dicts still match, ``replays`` and ``reconfig`` included."""
    jrt, jrun, jstale = _kill_revive(Jax)
    tp = tt.params_from_numpy(jax.device_get(jrun.params["lm"]),
                              jrun.pipe.elements["lm"].cfg, "cpu")
    rt, run, stale = _kill_revive(Port, tp)
    _same_stats(rt, jrt)
    assert stale == jstale and stale > 0     # lanes no record listens to
    st = rt.stats()
    assert st["reconfig"]["unplanned"] == 2
    assert st["failover"]["redispatches"] >= 1
    qb = st["query_batching"]
    assert qb["tokens_dropped"] > 0 and qb["flush_orphans"] >= 1
    assert qb["tokens_generated"] == qb["tokens_delivered"] + \
        qb["tokens_dropped"] + qb["tokens_in_flight"]


def _staged(pkg, standby, shares=None):
    """A 2-stage ``stablelm-smoke-4l`` chain of 4 slots (and a standby for
    stage 1, or none), 3 clients; stage 1 dies at tick 4 and, with no
    standby, revives at tick 8.  The port serves ``shares``, the JAX
    stages' params.  -> (runtime, [stage 0, stage 1, standby] runs)."""
    from chaoslib import Chaos
    rt = pkg.runtime()
    mod = jax_ms if pkg is Jax else ms
    pipes = mod.staged_serve_pipelines(model="stablelm-smoke-4l", slots=4,
                                       max_seq=16, n_stages=2)
    if standby:
        pipes.append(mod.stage_pipeline(model="stablelm-smoke-4l", slots=4,
                                        max_seq=16, stage=1, n_stages=2))
    runs, devs = [], []
    for k, ps in enumerate(pipes):
        dev = pkg.device(f"stage{k}")
        run = pkg.add(dev, ps)
        if pkg is Port:
            run.params["lm"] = shares[k]
        rt.add_device(dev)
        runs.append(run)
        devs.append(dev)
    for i in range(3):
        dev = pkg.device(f"tv{i}")
        pkg.add(dev, mod.client_pipeline(prompts=f"{i + 1},{i + 2}",
                                         gens=f"{5 + i};3"))
        rt.add_device(dev)
    harness = Chaos(rt)
    ssrc = runs[1].pipe.elements["ssrc"]
    harness.kill_server(4, devs[1], ssrc, crash=True)
    if not standby:
        harness.revive_server(8, devs[1], ssrc)
    harness.run(16)
    return rt, runs


@pytest.mark.parametrize("standby", [True, False])
def test_staged_serving_stats_match(standby):
    """The whole stats dicts of a staged chain through a stage kill match,
    the coordinator's hop keys and the hop servers' keys included."""
    jrt, jruns = _staged(Jax, standby)
    shares = [tt.params_from_numpy(jax.device_get(r.params["lm"]),
                                   r.pipe.elements["lm"].cfg, "cpu")
              for r in jruns]
    rt, _ = _staged(Port, standby, shares)
    _same_stats(rt, jrt)
    qb = rt.stats()["query_batching"]
    assert qb["stage_replays"] >= 2 and qb["stage_replay_steps"] >= 1
    assert qb["decode_hops"] > 0 and qb["slot_steps"] > qb["decode_hops"]
    assert (qb["hops_failed"] > 0) == (not standby)
    assert qb["hops_dispatched"] == qb["hops_completed"] + qb["hops_failed"]
    assert qb["tokens_dropped"] == 0 and qb["streams_finished"] >= 3
