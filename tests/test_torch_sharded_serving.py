"""Mesh-sharded serving in the port (DESIGN.md §4), on the CPU: twins of the
17 tests of ``tests/sharding/test_sharded_serving.py`` on a mesh of 8
``cpu`` slots, the port's counterpart of the JAX package's 8 forged host
devices.

Laying a batch out along a mesh's data slots may change where frames run,
never what a client sees:

* answers under ``Runtime(mesh=...)`` are bitwise the port's meshless
  runtime's and the JAX package's meshless runtime's, at batch 1, 4 and 8,
  through codec groups, the eager wire path, every placement mode and a
  mid-batch kill;
* the whole ``query_batching`` stats dict (``sharded_frames``,
  ``fused_frames``, ...) equals the JAX package's on its own 8-device mesh
  in every scenario with a forced placement (the JAX runs need 8 devices,
  so they run once per module in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
  ``tests/test_distributed.py`` runs its mesh code);
* stateful plans keep the single-device FIFO scan, and the executable
  cache is mesh-aware.

The server models compute exactly in both packages: ``tsh_mm`` is the
reference's ``x.reshape(1, -1) @ W`` with W in quarters (integer testsrc
frames, so every partial sum is exact in any order), ``tsh_ew`` an
elementwise ``x * W`` for the codec scenarios (one rounding an element,
whatever the codec decoded).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TensorSpec as JSpec
from repro.core import parse_launch as jparse
from repro.core.element import Element as JElement
from repro.core.element import register_element as jregister_element
from repro.core.elements import register_model as jregister
from repro.runtime import Device as JDevice
from repro.runtime import Runtime as JRuntime
from repro_torch.core import TensorSpec, parse_launch
from repro_torch.core.batching import BatchingPolicy, QueryBatcher
from repro_torch.core.element import Element, register_element
from repro_torch.core.elements import register_model
from repro_torch.core.formats import Caps
from repro_torch.launch.mesh import (data_axis_size, make_host_mesh,
                                     mesh_fingerprint)
from repro_torch.runtime import Device, Runtime

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
SLOTS = 8
W_MM = ((np.arange(48).reshape(12, 4) % 7 - 3) / 4).astype(np.float32)
W_EW = ((np.arange(12).reshape(2, 2, 3) % 7 - 3) / 4).astype(np.float32)


def _register():
    register_model("tsh_mm", lambda g, dev: {
        "w": torch.as_tensor(W_MM, device=dev)},
        lambda p, x: x.to(torch.float32).reshape(1, -1) @ p["w"],
        out_specs=(TensorSpec((1, 4), "float32"),))
    register_model("tsh_mm2", lambda g, dev: {
        "w": torch.as_tensor(W_MM * 0.5, device=dev)},
        lambda p, x: x.to(torch.float32).reshape(1, -1) @ p["w"],
        out_specs=(TensorSpec((1, 4), "float32"),))
    register_model("tsh_ew", lambda g, dev: {
        "w": torch.as_tensor(W_EW, device=dev)},
        lambda p, x: x.to(torch.float32) * p["w"],
        out_specs=(TensorSpec((2, 2, 3), "float32"),))
    jregister("tsh_mm", lambda rng: {"w": jnp.asarray(W_MM)},
              lambda p, x: x.astype(jnp.float32).reshape(1, -1) @ p["w"],
              out_specs=(JSpec((1, 4), "float32"),))
    jregister("tsh_ew", lambda rng: {"w": jnp.asarray(W_EW)},
              lambda p, x: x.astype(jnp.float32) * p["w"],
              out_specs=(JSpec((2, 2, 3), "float32"),))


@register_element("tsh_running_sum4")
class RunningSum4(Element):
    """Stateful: accumulates the first 4 features of every frame it sees,
    so serving order shows in every answer."""

    def init_state(self, device):
        return {"acc": torch.zeros((1, 4), dtype=torch.float32,
                                   device=device)}

    def negotiate(self, in_caps):
        return [Caps(media="other/tensors",
                     tensors=(TensorSpec((1, 4), "float32"),))]

    def apply(self, params, inputs, ctx=None):
        buf = inputs[0]
        x = buf.tensors[0].to(torch.float32).reshape(1, -1)[:, :4]
        acc = ctx.get_state(self.name)["acc"] + x
        ctx.set_state(self.name, {"acc": acc})
        return [buf.with_(tensors=(acc,))]


@jregister_element("tsh_running_sum4")
class JRunningSum4(JElement):
    def init_state(self):
        return {"acc": jnp.zeros((1, 4), jnp.float32)}

    def negotiate(self, in_caps):
        from repro.core.formats import Caps as JCaps
        return [JCaps(media="other/tensors",
                      tensors=(JSpec((1, 4), "float32"),))]

    def apply(self, params, inputs, ctx=None):
        buf = inputs[0]
        x = buf.tensors[0].astype(jnp.float32).reshape(1, -1)[:, :4]
        acc = ctx.get_state(self.name)["acc"] + x
        ctx.set_state(self.name, {"acc": acc})
        return [buf.with_(tensors=(acc,))]


class Port:
    parse = staticmethod(parse_launch)

    @staticmethod
    def runtime(**kw):
        return Runtime(device="cpu", **kw)

    @staticmethod
    def device(name):
        return Device(name, device="cpu")

    @staticmethod
    def mesh():
        return make_host_mesh(devices=["cpu"] * SLOTS)


class Jax:
    parse = staticmethod(jparse)
    runtime = JRuntime
    device = JDevice

    @staticmethod
    def mesh():
        from repro.launch.mesh import make_host_mesh as jmesh
        return jmesh()


def _server(pkg, rt, name="hub", model="tsh_mm", filt=None, jit=True):
    dev = pkg.device(name)
    mid = filt or f"tensor_filter model={model}"
    ps = pkg.parse(f"tensor_query_serversrc operation=op name=ssrc ! "
                   f"{mid} ! tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    run = dev.add_pipeline(ps, jit=jit)
    rt.add_device(dev)
    return dev, run, ps.elements["ssrc"]


def _clients(pkg, rt, n, codec="none", prefix="tv"):
    runs = []
    for i in range(n):
        dev = pkg.device(f"{prefix}{i}")
        pc = pkg.parse(
            f"testsrc width=2 height=2 ! tensor_converter ! "
            f"tensor_query_client operation=op codec={codec} name=qc ! "
            f"appsink name=res")
        runs.append(dev.add_pipeline(pc, jit=False))
        rt.add_device(dev)
    return runs


def _responses(run):
    return [np.asarray(b.tensor.cpu() if isinstance(b.tensor, torch.Tensor)
                       else b.tensor) for b in run.sink_log["res"]]


def _same(runs_a, runs_b):
    assert len(runs_a) == len(runs_b)
    for ra, rb in zip(runs_a, runs_b):
        a, b = _responses(ra), _responses(rb)
        assert len(a) == len(b) and a
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if hasattr(v, "item"):
        return v.item()
    return v


# ---------------------------------------------------------------------------
# scenarios, each runnable in either package, with or without the mesh
# ---------------------------------------------------------------------------

def sc_parity(pkg, mesh, batch, mode="always"):
    rt = pkg.runtime(query_batch=batch, mesh=mesh, shard_mode=mode)
    _, srv, _ = _server(pkg, rt)
    runs = _clients(pkg, rt, 8)
    rt.run(3)
    return rt, runs, srv


def sc_codec(pkg, mesh, codecs, fused=True, ticks=2, mode="always"):
    rt = pkg.runtime(query_batch=8, mesh=mesh, shard_mode=mode,
                     fused_wire=fused)
    _, srv, _ = _server(pkg, rt, model="tsh_ew")
    runs = []
    for i, (codec, n) in enumerate(codecs):
        runs += _clients(pkg, rt, n, codec=codec, prefix=f"tv{i}_")
    rt.run(ticks)
    return rt, runs, srv


def sc_clients(pkg, mesh, n, ticks, mode="always"):
    rt = pkg.runtime(query_batch=8, mesh=mesh, shard_mode=mode)
    _, srv, _ = _server(pkg, rt)
    runs = _clients(pkg, rt, n)
    rt.run(ticks)
    return rt, runs, srv


def sc_stateful(pkg, mesh):
    rt = pkg.runtime(query_batch=8, mesh=mesh, shard_mode="always")
    _, srv, _ = _server(pkg, rt, filt="tsh_running_sum4 name=acc")
    runs = _clients(pkg, rt, 8)
    rt.run(3)
    return rt, runs, srv


def sc_mid_batch(pkg, mesh, fault=True):
    from chaoslib import Chaos
    ticks, kill_tick = 6, 3
    rt = pkg.runtime(query_batch=8, mesh=mesh, shard_mode="always")
    devA, runA, ssrcA = _server(pkg, rt, name="hubA")
    devB, runB, ssrcB = _server(pkg, rt, name="hubB")
    runs = _clients(pkg, rt, 8)
    harness = Chaos(rt)
    if fault:
        harness.kill_server_mid_batch(kill_tick, devA, ssrcA, after_n=3)
    harness.run(ticks)
    return rt, runs, dict(harness=harness, runB=runB)


#: name -> scenario of the forced placements, run in the JAX package on its
#: 8-device mesh to read its stats
SCENARIOS = {
    "parity_1": lambda pkg, m: sc_parity(pkg, m, 1),
    "parity_4": lambda pkg, m: sc_parity(pkg, m, 4),
    "parity_8": lambda pkg, m: sc_parity(pkg, m, 8),
    "uniform_quant8": lambda pkg, m: sc_codec(pkg, m, [("quant8", 8)]),
    "mixed": lambda pkg, m: sc_codec(pkg, m, [("none", 4), ("quant8", 4)]),
    "mixed_eager": lambda pkg, m: sc_codec(
        pkg, m, [("none", 4), ("quant8", 4)], fused=False),
    "batch8": lambda pkg, m: sc_clients(pkg, m, 8, 3),
    "non_tiling": lambda pkg, m: sc_clients(pkg, m, 5, 2),
    "never": lambda pkg, m: sc_clients(pkg, m, 8, 2, mode="never"),
    "stateful": sc_stateful,
    "mid_batch": sc_mid_batch,
}


def _stats(rt):
    st = rt.stats()
    return {"query_batching": _plain(st["query_batching"]),
            "failover": _plain(st["failover"])}


def _jax_mesh_main():
    """Subprocess entry: every scenario in the JAX package on its mesh."""
    _register()
    mesh = Jax.mesh()
    out = {"devices": int(np.prod(mesh.devices.shape))}
    for name, fn in SCENARIOS.items():
        rt = fn(Jax, mesh)[0]
        out[name] = _stats(rt)
    print("JSON" + json.dumps(out))


@pytest.fixture(scope="module", autouse=True)
def models():
    _register()


@pytest.fixture(scope="module")
def jax_mesh():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src") + os.pathsep + HERE
    code = textwrap.dedent("""
        import test_torch_sharded_serving as t
        t._jax_mesh_main()
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=HERE)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("JSON")][-1]
    got = json.loads(line[4:])
    assert got["devices"] == SLOTS
    return got


def _port_and_refs(name, **kw):
    """-> (port mesh run, port meshless run, JAX meshless run)."""
    fn = SCENARIOS[name]
    return fn(Port, Port.mesh()), fn(Port, None), fn(Jax, None)


# ---------------------------------------------------------------------------
# TestBitwiseParity
# ---------------------------------------------------------------------------

class TestBitwiseParity:
    @pytest.mark.parametrize("batch", [1, 4, 8])
    def test_sharded_matches_single_device_bitwise(self, batch, jax_mesh):
        """Answers at batch 1, 4 and 8 under the mesh == the port's and the
        JAX package's meshless runtimes', bitwise; only the 8-tiling batch
        shards, and the stats are the JAX mesh runtime's."""
        (rt_m, m_runs, srv), (_, ref_runs, _), (_, j_runs, _) = \
            _port_and_refs(f"parity_{batch}")
        for r in m_runs:
            assert r.frames == 3
        _same(m_runs, ref_runs)
        _same(m_runs, j_runs)
        assert srv.frames == 3 * 8
        qb = _stats(rt_m)["query_batching"]
        assert qb == jax_mesh[f"parity_{batch}"]["query_batching"]
        assert qb["sharded_frames"] == (24 if batch == 8 else 0)

    def test_uniform_codec_groups_still_shard_bitwise(self, jax_mesh):
        """A full batch of quant8 clients keeps the eager wire path (one
        stacked host decode, the sharded serve, the serversink's encode) and
        shards; answers bitwise the meshless runtimes'."""
        (rt_m, m_runs, _), (_, ref_runs, _), (_, j_runs, _) = \
            _port_and_refs("uniform_quant8")
        qb = _stats(rt_m)["query_batching"]
        assert qb["sharded_frames"] == 16
        assert qb == jax_mesh["uniform_quant8"]["query_batching"]
        _same(m_runs, ref_runs)
        _same(m_runs, j_runs)

    def test_mixed_codecs_on_a_mesh_split_by_codec_and_stay_bitwise(
            self, jax_mesh):
        """Mixed codecs split into groups of 4, which do not tile 8 slots:
        they serve codec-fused on one device."""
        (rt_m, m_runs, _), (_, ref_runs, _), (_, j_runs, _) = \
            _port_and_refs("mixed")
        qb = _stats(rt_m)["query_batching"]
        assert qb["sharded_frames"] == 0 and qb["fused_frames"] == 8
        assert qb == jax_mesh["mixed"]["query_batching"]
        _same(m_runs, ref_runs)
        _same(m_runs, j_runs)

    def test_eager_wire_path_keeps_mixed_codec_sharding(self, jax_mesh):
        """``fused_wire=False``: the codec is routing meta, mixed codecs
        stack into one sharded batch."""
        (rt_m, m_runs, _), (_, ref_runs, _), (_, j_runs, _) = \
            _port_and_refs("mixed_eager")
        qb = _stats(rt_m)["query_batching"]
        assert qb["sharded_frames"] == 16
        assert qb == jax_mesh["mixed_eager"]["query_batching"]
        _same(m_runs, ref_runs)
        _same(m_runs, j_runs)


# ---------------------------------------------------------------------------
# TestShardingMechanics
# ---------------------------------------------------------------------------

class TestShardingMechanics:
    def test_sharded_path_used_at_batch_8(self, jax_mesh):
        rt, _, srv = sc_clients(Port, Port.mesh(), 8, 3)
        assert data_axis_size(rt.mesh) == SLOTS
        qb = rt.stats()["query_batching"]
        assert qb["batched_frames"] == 24
        assert qb["sequential_frames"] == 0
        assert qb["sharded_batches"] == 3
        assert qb["sharded_frames"] == 24
        assert srv.frames == 24
        assert _stats(rt)["query_batching"] == \
            jax_mesh["batch8"]["query_batching"]

    def test_non_tiling_batch_falls_back_single_device(self, jax_mesh):
        """5 requests cannot tile 8 slots: served fully, not sharded."""
        (rt, runs, srv), (_, ref_runs, _), (_, j_runs, _) = \
            _port_and_refs("non_tiling")
        qb = rt.stats()["query_batching"]
        assert qb["batched_frames"] == 10
        assert qb["sharded_frames"] == 0
        assert srv.frames == 10
        assert all(r.frames == 2 for r in runs)
        assert _stats(rt)["query_batching"] == \
            jax_mesh["non_tiling"]["query_batching"]
        _same(runs, ref_runs)
        _same(runs, j_runs)

    def test_stateful_server_keeps_fifo_scan(self, jax_mesh):
        """A plan that threads state never shards; the running sum makes
        arrival order visible in every answer."""
        (rt, runs, _), (_, ref_runs, _), (_, j_runs, _) = \
            _port_and_refs("stateful")
        qb = rt.stats()["query_batching"]
        assert qb["sharded_frames"] == 0
        assert qb["batched_frames"] == 24
        assert _stats(rt)["query_batching"] == \
            jax_mesh["stateful"]["query_batching"]
        _same(runs, ref_runs)
        _same(runs, j_runs)
        last = _responses(runs[-1])
        assert np.all(np.abs(last[-1]) >= np.abs(last[0]))

    def test_runtime_mesh_auto_builds_host_mesh(self):
        """``mesh="auto"`` on the CPU is a mesh of the runtime's device, one
        slot: it serves exactly like ``mesh=None``.  On the card it spans
        every visible CUDA device; without one ``make_host_mesh()`` raises
        rather than fall back to the CPU."""
        rt = Runtime(device="cpu", query_batch=8, mesh="auto")
        assert rt.mesh is not None
        assert data_axis_size(rt.mesh) == 1
        assert {d.type for d in rt.mesh.devices.flat} == {"cpu"}
        _, srv, _ = _server(Port, rt)
        runs = _clients(Port, rt, 8)
        rt.run(2)
        assert rt.stats()["query_batching"]["sharded_frames"] == 0
        _same(runs, sc_clients(Port, None, 8, 2)[1])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_host_mesh()
        with pytest.raises(ValueError, match="runtime on cpu"):
            Runtime(device="cpu", mesh=make_host_mesh(
                devices=["meta"] * 2))


def _late_subscriber(mesh, mode="always", jit=True):
    """A subscriber joining after 8 published frames drains them in one
    burst (then steps): -> (runtime, its run)."""
    rt = Runtime(device="cpu", mesh=mesh, shard_mode=mode, burst=8)
    pub = Device("pub", device="cpu")
    pub.add_pipeline(parse_launch("testsrc width=2 height=2 ! "
                                  "tensor_converter ! mqttsink pub-topic=cam"))
    rt.add_device(pub)
    rt.run(8)
    sub = Device("sub", device="cpu")
    run = sub.add_pipeline(parse_launch(
        "mqttsrc sub-topic=cam ! tensor_filter model=tsh_ew ! "
        "appsink name=res"), jit=jit)
    rt.add_device(sub)
    rt.run(3)
    return rt, run


@pytest.mark.parametrize("jit", [True, False])
def test_hoisted_bursts_shard_under_always_and_stay_bitwise(jit):
    """A pub/sub burst of 8 frames shards over 8 slots under "always"
    (the params placed once, on the run), never under "auto"; the frames
    are bitwise the meshless runtime's either way."""
    rt, run = _late_subscriber(Port.mesh(), jit=jit)
    _, ref = _late_subscriber(None, jit=jit)
    _, auto = _late_subscriber(Port.mesh(), mode="auto", jit=jit)
    assert run.bursts == ref.bursts >= 1 and run.mesh_params is not None
    assert auto.mesh_params is None
    _same([run], [ref])
    _same([auto], [ref])


# ---------------------------------------------------------------------------
# TestPlacementPolicy
# ---------------------------------------------------------------------------

class TestPlacementPolicy:
    def test_auto_mode_calibrates_once_and_stays_correct(self):
        rt = Runtime(device="cpu", query_batch=8, mesh=Port.mesh())
        _, srv, ssrc = _server(Port, rt)
        runs = _clients(Port, rt, 8)
        rt.run(3)
        batcher = rt._batchers[ssrc.endpoint.endpoint_id]
        assert batcher.placements.get(8) in ("sharded", "single")
        assert srv.frames == 24
        assert all(r.frames == 3 for r in runs)
        qb = rt.stats()["query_batching"]
        if batcher.placements[8] == "sharded":
            assert qb["sharded_frames"] == 24
        else:
            assert qb["sharded_frames"] == 0
        assert qb["batched_frames"] == 24
        _same(runs, sc_clients(Jax, None, 8, 3)[1])

    def test_auto_matches_forced_modes_bitwise(self):
        streams = {}
        for mode in ("auto", "always", "never"):
            streams[mode] = sc_clients(Port, Port.mesh(), 8, 2, mode=mode)[1]
        for mode in ("always", "never"):
            _same(streams["auto"], streams[mode])
        _same(streams["auto"], sc_clients(Jax, None, 8, 2)[1])

    def test_auto_single_placement_reclaims_codec_fusion(self):
        """Only the probe-carrying flush of a size serves eager; once the
        probe says "single", groups of that size serve codec-fused."""
        rt, runs, srv = sc_codec(Port, Port.mesh(), [("quant8", 8)],
                                 ticks=3, mode="auto")
        batcher = next(iter(rt._batchers.values()))
        qb = rt.stats()["query_batching"]
        if batcher.placements.get(8) == "single":
            assert qb["fused_frames"] >= 16
        else:
            assert qb["sharded_frames"] > 0
        assert srv.frames == 24
        _same(runs, sc_codec(Jax, None, [("quant8", 8)], ticks=3)[1])

    def test_never_mode_stays_single_device(self, jax_mesh):
        rt, _, srv = sc_clients(Port, Port.mesh(), 8, 2, mode="never")
        assert rt.stats()["query_batching"]["sharded_frames"] == 0
        assert srv.frames == 16
        assert next(iter(rt._batchers.values())).placements == {}
        assert _stats(rt)["query_batching"] == \
            jax_mesh["never"]["query_batching"]

    def test_bad_mode_rejected(self):
        with pytest.raises(ValueError, match="shard_mode"):
            QueryBatcher(None, None, BatchingPolicy(), shard_mode="bogus")
        # a pub/sub-only deployment builds no batcher: the runtime checks
        with pytest.raises(ValueError, match="shard_mode"):
            Runtime(device="cpu", mesh=Port.mesh(), shard_mode="Always")

    def test_shardable_batch_predicate(self):
        mesh = Port.mesh()
        d = data_axis_size(mesh)
        ps = parse_launch("tensor_query_serversrc operation=x name=ssrc ! "
                          "tensor_filter model=tsh_mm ! "
                          "tensor_query_serversink name=ssink")
        ps.elements["ssink"].pair_with(ps.elements["ssrc"])
        ps.realize()
        plan = ps.plan
        assert plan.shardable_batch(d, {}, mesh)
        assert plan.shardable_batch(2 * d, {}, mesh)
        assert not plan.shardable_batch(d + 1, {}, mesh)
        assert not plan.shardable_batch(d, {}, None)
        assert not plan.shardable_batch(0, {}, mesh)
        assert not plan.shardable_batch(
            d, {"acc": {"v": torch.zeros((1,))}}, mesh)
        # a (data 2, model 4) mesh tiles on its 2 data slots only
        mesh24 = make_host_mesh(4, devices=["cpu"] * 8)
        assert plan.shardable_batch(2, {}, mesh24)
        assert not plan.shardable_batch(3, {}, mesh24)


# ---------------------------------------------------------------------------
# TestExecCacheMeshAware
# ---------------------------------------------------------------------------

class TestExecCacheMeshAware:
    def test_same_mesh_never_retraces_different_mesh_never_shares(self):
        mesh = Port.mesh()
        rt = Runtime(device="cpu", query_batch=8, mesh=mesh,
                     shard_mode="always")
        _, srv_run, _ = _server(Port, rt)
        _clients(Port, rt, 8)
        rt.run(1)
        plan = srv_run.pipe.plan
        fns = plan._cache()["fns"]
        n_after_first = len(fns)
        assert any(k[0] == "serve_batch" and k[2] == mesh_fingerprint(mesh)
                   for k in fns)
        rt.run(3)
        assert len(fns) == n_after_first
        mesh2 = Port.mesh()
        assert mesh_fingerprint(mesh2) == mesh_fingerprint(mesh)
        plan.compiled_serve_batch(mesh=mesh2)
        assert len(fns) == n_after_first
        # the single-device executable is its own entry (made eagerly as
        # the fallback); asking for it builds nothing
        assert ("serve_batch", False, None, None) in fns
        plan.compiled_serve_batch(mesh=None)
        assert len(fns) == n_after_first
        plan.compiled_serve_batch(codec="quant8")
        assert ("serve_batch", False, None, "quant8") in fns
        assert len(fns) == n_after_first + 1
        # another mesh is another entry: 4 slots never match 8
        mesh4 = make_host_mesh(devices=["cpu"] * 4)
        assert mesh_fingerprint(mesh4) != mesh_fingerprint(mesh)
        plan.compiled_serve_batch(mesh=mesh4)
        assert len(fns) == n_after_first + 3    # + its step_n entry
        with pytest.raises(ValueError, match="single-device"):
            plan.compiled_serve_batch(mesh=mesh, codec="quant8")

    def test_failover_rewire_reuses_sharded_executable(self):
        from chaoslib import Chaos
        rt = Runtime(device="cpu", query_batch=8, mesh=Port.mesh(),
                     shard_mode="always")
        dev, srv_run, ssrc = _server(Port, rt)
        cl = _clients(Port, rt, 8)
        harness = Chaos(rt)
        harness.kill_server(3, dev, ssrc)
        harness.revive_server(5, dev, ssrc)
        harness.run(2)
        fns = srv_run.pipe.plan._cache()["fns"]
        n_mid = len(fns)
        harness.run(5)
        assert len(fns) == n_mid
        assert all(r.frames >= 5 for r in cl)
        assert rt.stats()["query_batching"]["sharded_frames"] > 0


def _swap_under(mesh):
    """Two ticks on ``tsh_mm``, a hot swap of the filter to ``tsh_mm2``,
    three ticks more: -> (runtime, client runs, server run, batcher, the
    batcher's mesh copy before the swap, the reconfiguration)."""
    from repro_torch.core.element import element_factory
    rt = Port.runtime(query_batch=8, mesh=mesh, shard_mode="always")
    dev = Port.device("hub")
    ps = parse_launch("tensor_query_serversrc operation=op name=ssrc ! "
                      "tensor_filter model=tsh_mm name=filt ! "
                      "tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    run = dev.add_pipeline(ps)
    rt.add_device(dev)
    runs = _clients(Port, rt, 8)
    rt.run(2)
    batcher = next(iter(rt._batchers.values()))
    before = batcher._mesh_params
    rc = rt.reconfigure(run, run.pipe.reconfig().swap(
        "filt", element_factory("tensor_filter", model="tsh_mm2")))
    rt.run(3)
    return rt, runs, run, batcher, before, rc


def test_hot_swap_under_the_mesh_re_places_and_stays_bitwise():
    """A hot swap under the mesh: warm makes the new plan's mesh entry
    under the runtime's mesh, the commit drops the old mesh copy and the
    placements, the next sharded serve places the new params; answers
    bitwise the meshless runtime's through the same swap."""
    rt, runs, run, batcher, before, rc = _swap_under(Port.mesh())
    _, ref_runs, _, _, _, ref_rc = _swap_under(None)
    assert rc.status == ref_rc.status == "committed"
    assert before is not None and batcher._mesh_params is not before
    assert batcher._mesh_params.tree is run.params
    fns = run.pipe.plan._cache()["fns"]
    assert ("serve_batch", False, mesh_fingerprint(rt.mesh), None) in fns
    assert rt.stats()["query_batching"]["sharded_frames"] == 40
    _same(runs, ref_runs)


# ---------------------------------------------------------------------------
# TestChaosUnderSharding
# ---------------------------------------------------------------------------

class TestChaosUnderSharding:
    def test_mid_batch_server_death_sharded_loses_nothing_bitwise(
            self, jax_mesh):
        """The primary dies mid-gather; the orphans re-dispatch to the
        survivor (also sharded) within the tick: no request lost, answers
        bitwise the fault-free mesh twin's and the JAX package's meshless
        run of the same faults, failover and batching stats the JAX mesh
        runtime's."""
        ticks, kill_tick = 6, 3
        rt, runs, ex = sc_mid_batch(Port, Port.mesh())
        _, ref_runs, _ = sc_mid_batch(Port, Port.mesh(), fault=False)
        _, j_runs, _ = sc_mid_batch(Jax, None)
        harness = ex["harness"]
        assert any("mid-batch" in label and "DISARMED" not in label
                   for _, label in harness.log)
        for got in runs:
            assert got.frames == ticks
        _same(runs, ref_runs)
        _same(runs, j_runs)
        st = _stats(rt)
        assert st["failover"]["redispatches"] >= 1
        assert st["failover"]["parked_now"] == 0
        assert st["query_batching"]["sharded_frames"] > 0
        assert ex["runB"].frames >= (ticks - kill_tick) * 8
        assert st == jax_mesh["mid_batch"]


# ---------------------------------------------------------------------------
# on the card: slots of one device share one CUDA-graph binding
# ---------------------------------------------------------------------------

class Card(Port):
    @staticmethod
    def runtime(**kw):
        return Runtime(device="cuda", **kw)

    @staticmethod
    def device(name):
        return Device(name, device="cuda")

    @staticmethod
    def mesh():
        return make_host_mesh(devices=["cuda:0"] * SLOTS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs, cuda:0 slots)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["none", "quant8"])
def test_cuda_slots_are_bitwise_and_share_one_binding(cuda, codec):
    """8 ``cuda:0`` slots: the answers are the meshless graphed runtime's,
    bitwise; the slots' 1-frame slices replay one binding of the
    single-device burst entry, and the replicated params are the run's own
    tensors."""
    from repro_torch.core.plan import executable_cache_info
    rt, runs, srv = sc_codec(Card, Card.mesh(), [(codec, 8)], ticks=4)
    _, ref_runs, _ = sc_codec(Card, None, [(codec, 8)], ticks=4)
    _same(runs, ref_runs)
    assert rt.stats()["query_batching"]["sharded_frames"] == 32
    fns = srv.pipe.plan._cache()["fns"]
    single = fns[("step_n", True, True, True, None)]
    assert single.graphs() == 1 and single.captures == 1
    rep = next(iter(rt._batchers.values()))._mesh_params
    assert rep.nbytes() == 0
    assert executable_cache_info()["graphs"] >= 1
