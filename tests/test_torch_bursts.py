"""Bursts in the port: ``step_n`` / ``compiled_step_n`` and the runtime's
burst draining of backlogged subscriber pipelines, on the CPU, against the
port's own per-frame steps and against the JAX package.

* ``step_n`` and ``compiled_step_n`` equal sequential ``run`` calls
  bitwise: stacked outputs frame by frame and the final state.
* ``test_plan.py``'s burst cases (injected inputs, the late subscriber's
  replay cap, the runtime's burst draining: cap, cadence, query pipelines
  never burst, a live source stays on the tick cadence, unread frames)
  give the JAX runtime's frame, skip, burst and drop counts and sink logs.
* A codec-carrying subscriber (``mqttsrc codec=... ! ... ! mqttsink
  codec=...``) that joins late drains its backlog in one burst with one
  stacked decode, and republishes payloads bitwise equal to its
  ``burst=1`` twin's and to the JAX runtime's.
* On the card (``cuda`` marker): the same burst against its ``burst=1``
  twin and the CPU, with the K1–K4 launches counted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Channel as JChannel
from repro.core import StreamBuffer as JBuf
from repro.core import parse_launch as jparse
from repro.core import stack_buffers as jstack
from repro.core import unstack_buffers as junstack
from repro.core.elements import register_model as jregister
from repro.core import TensorSpec as JSpec
from repro.runtime import Device as JDevice
from repro.runtime import Runtime as JRuntime
from repro_torch.core import (Channel, MqttSrc, StreamBuffer, TensorSpec,
                              parse_launch, stack_buffers, unstack_buffers)
from repro_torch.core import compression as comp
from repro_torch.core.buffers import tree_flatten
from repro_torch.core.elements import register_model
from repro_torch.runtime import Device, Runtime

torch.set_num_threads(2)

W_CLS = (0.1 * np.random.default_rng(3).standard_normal((3, 10))).astype(
    np.float32)


@pytest.fixture(scope="module", autouse=True)
def models():
    register_model("tb_cls", lambda g, dev: {"w": torch.as_tensor(
        W_CLS, device=dev)}, lambda p, x: x.reshape(-1, 3).mean(0) @ p["w"],
        out_specs=(TensorSpec((10,), "float32"),))
    jregister("tb_cls", lambda rng: {"w": jnp.asarray(W_CLS)},
              lambda p, x: jnp.mean(x.reshape(-1, 3), 0) @ p["w"],
              out_specs=(JSpec((10,), "float32"),))
    # elementwise only, so the two packages agree bitwise; keeps zeros
    register_model("tb_gate", None, lambda p, x: torch.clamp(x, 0.0) * 0.5,
                   out_specs=())
    jregister("tb_gate", None, lambda p, x: jnp.maximum(x, 0.0) * 0.5,
              out_specs=())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_tree_equal(a, b, label=""):
    """Two port trees: same structure, every leaf bitwise (pts by value:
    a burst turns Python-int pts into numpy integers)."""
    la, ta = tree_flatten(a)
    lb, tb = tree_flatten(b)
    assert ta == tb, f"{label}: structure {ta} vs {tb}"
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            assert isinstance(x, torch.Tensor) and \
                isinstance(y, torch.Tensor), label
            assert x.dtype == y.dtype and torch.equal(x, y), label
        else:
            assert int(x) == int(y), label


def assert_port_equals_jax(buf, jbuf, label=""):
    assert int(buf.pts) == int(jbuf.pts), label
    assert buf.meta == jbuf.meta, label
    for x, y in zip(buf.tensors, jbuf.tensors):
        fx = [x.q, x.scale] if hasattr(x, "q") else \
            [x.values, x.indices, x.nnz] if hasattr(x, "nnz") else [x]
        fy = [y.q, y.scale] if hasattr(y, "q") else \
            [y.values, y.indices, y.nnz] if hasattr(y, "nnz") else [y]
        for u, v in zip(fx, fy):
            u, v = _np(u), _np(v)
            assert u.shape == v.shape and u.dtype == v.dtype, label
            np.testing.assert_array_equal(u, v, err_msg=label)


# ---------------------------------------------------------------------------
# step_n
# ---------------------------------------------------------------------------

PIPELINES = {
    "transform": """
        testsrc width=8 height=8 ! tensor_converter !
        tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 !
        appsink name=o""",
    "filter_cls": """
        testsrc width=8 height=8 ! tensor_converter !
        tensor_transform mode=arithmetic option=typecast:float32 !
        tensor_filter model=tb_cls ! tensor_decoder mode=classification !
        appsink name=o""",
    "mux_demux": """
        testsrc ! tensor_converter ! mux.sink_0
        testsrc width=4 height=4 ! tensor_converter ! mux.sink_1
        tensor_mux name=mux ! tensor_demux name=d
        d.src_0 ! appsink name=a
        d.src_1 ! appsink name=b""",
    "tee_compositor": """
        testsrc name=s width=12 height=12 ! tee name=t
        t. queue ! videoconvert ! cmp.sink_0
        t. videoconvert ! videoscale ! video/x-raw,width=6,height=6,format=RGB !
          videoconvert ! cmp.sink_1
        compositor name=cmp sink_0::zorder=1 sink_1::zorder=2 sink_1::xpos=3 !
          appsink name=out""",
    "tensor_if": """
        testsrc width=4 height=4 ! tensor_converter !
        tensor_transform mode=arithmetic option=typecast:float32,div:255.0 !
        tensor_if threshold=0.9 operator=GE ! appsink name=o""",
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
@pytest.mark.parametrize("compiled", [False, True])
def test_step_n_matches_sequential_runs_bitwise(name, compiled):
    n = 4
    pipe = parse_launch(PIPELINES[name]).realize()
    params = pipe.init(torch.Generator().manual_seed(0), "cpu")
    s0 = pipe.init_state("cpu")
    ref, st = [], dict(s0)
    for _ in range(n):
        o, st = pipe.step(params, st)
        ref.append(o)
    fn = pipe.compiled_step_n() if compiled else \
        (lambda p, s, n: pipe.step_n(p, s, n=n))
    outs, final = fn(params, dict(s0), n=n)
    per = unstack_buffers(outs, n)
    for k in range(n):
        assert_tree_equal(per[k], ref[k], f"{name}[{k}]")
    assert_tree_equal(final, st, f"{name}/state")
    if compiled:
        assert pipe.compiled_step_n() is pipe.compiled_step_n()
        assert pipe.compiled_step_n(hoist_io=True) is not fn


def test_step_n_with_injected_inputs_matches_sequential_and_jax():
    n = 4
    desc = """appsrc name=in ! tensor_transform mode=arithmetic
              option=typecast:float32,mul:2.0 ! appsink name=o"""
    pipe = parse_launch(desc).realize()
    params, s0 = pipe.init(None, "cpu"), pipe.init_state("cpu")
    frames = [StreamBuffer(tensors=(torch.full((3, 3), float(i)),), pts=i)
              for i in range(n)]
    ref, si = [], dict(s0)
    for f in frames:
        o, si = pipe.step(params, si, {"in": f})
        ref.append(o)
    outs, sb = pipe.step_n(params, dict(s0), {"in": stack_buffers(frames)})
    for k, per in enumerate(unstack_buffers(outs, n)):
        assert_tree_equal(per, ref[k], f"inject[{k}]")
    assert_tree_equal(sb, si, "inject-state")
    jpipe = jparse(desc).realize()
    jframes = [JBuf(tensors=(jnp.full((3, 3), i, jnp.float32),),
                    pts=jnp.int32(i)) for i in range(n)]
    jouts, _ = jpipe.step_n(jpipe.init(jax.random.PRNGKey(0)),
                            jpipe.init_state(), {"in": jstack(jframes)})
    for per, jper in zip(unstack_buffers(outs, n), junstack(jouts, n)):
        assert_port_equals_jax(per["o"], jper["o"])


def test_step_n_argument_errors():
    pipe = parse_launch("testsrc ! appsink name=o").realize()
    with pytest.raises(ValueError):
        pipe.step_n({}, pipe.init_state("cpu"))
    # the mesh is ported: a mesh entry takes a Mesh, and nothing else
    with pytest.raises(TypeError, match="expected a Mesh"):
        pipe.compiled_step_n(mesh="auto")
    from repro_torch.launch.mesh import make_host_mesh
    assert callable(pipe.compiled_step_n(
        mesh=make_host_mesh(devices=["cpu"] * 2)))


# ---------------------------------------------------------------------------
# the late subscriber's replay cap (Channel level)
# ---------------------------------------------------------------------------

class TestChannelReplayCap:
    def test_late_subscriber_replay_capped_at_capacity(self):
        res = []
        for Ch, frame in ((Channel, lambda i: StreamBuffer(
                tensors=(torch.full((1,), float(i)),))),
                (JChannel, lambda i: JBuf(tensors=(jnp.full((1,), i),)))):
            pub = Ch(capacity=64)
            for i in range(10):
                pub.push(frame(i))
            sub = pub.attach_consumer(capacity=4)
            res.append((len(sub), sub.drops,
                        [float(sub.pop().tensor[0]) for _ in range(4)]))
        assert res[0] == res[1] == (4, 6, [6.0, 7.0, 8.0, 9.0])

    def test_replay_within_capacity_is_lossless(self):
        pub = Channel(capacity=16)
        for i in range(3):
            pub.push(StreamBuffer(tensors=(torch.full((1,), float(i)),)))
        sub = pub.attach_consumer()
        assert len(sub) == 3 and sub.drops == 0


# ---------------------------------------------------------------------------
# the runtime's burst draining, against the JAX runtime
# ---------------------------------------------------------------------------

def _backlogged(port, burst, backlog=5, sub_desc=None):
    sub_desc = sub_desc or "mqttsrc sub-topic=live name=src ! appsink name=o"
    rt = Runtime(burst=burst, device="cpu") if port else \
        JRuntime(burst=burst)
    mk = (lambda n: Device(n, device="cpu")) if port else JDevice
    add = (lambda d, p: d.add_pipeline(p)) if port else \
        (lambda d, p: d.add_pipeline(p, jit=False))
    parse = parse_launch if port else jparse
    pub = mk("cam")
    add(pub, parse("testsrc width=8 height=8 ! tensor_converter ! "
                   "mqttsink pub-topic=live name=snk"))
    rt.add_device(pub)
    rt.run(backlog)
    sub = mk("screen")
    run = add(sub, parse(sub_desc))
    rt.add_device(sub)
    return rt, run


def _counts(rt, run):
    return (run.frames, run.skipped, run.bursts, run.burst_frames,
            rt.stats()["screen/p0"]["drops"])


def _assert_twins(run, jrun, name="o"):
    got, want = run.sink_log.get(name, []), jrun.sink_log.get(name, [])
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert_port_equals_jax(a, b, f"{name}[{i}]")


class TestRuntimeBurstDraining:
    def test_burst_drains_backlog_in_one_tick(self):
        (rt, run), (jrt, jrun) = _backlogged(True, 8), _backlogged(False, 8)
        rt.tick()
        jrt.tick()
        assert _counts(rt, run) == _counts(jrt, jrun) == (6, 0, 1, 6, 0)
        pts = [int(b.pts) for b in run.sink_log["o"]]
        assert pts == sorted(pts) and len(set(pts)) == 6
        _assert_twins(run, jrun)

    def test_burst_cap_respected(self):
        (rt, run), (jrt, jrun) = _backlogged(True, 4), _backlogged(False, 4)
        got, want = [], []
        for _ in range(2):
            rt.tick()
            jrt.tick()
            got.append(_counts(rt, run))
            want.append(_counts(jrt, jrun))
        assert got == want
        assert [g[0] for g in got] == [4, 7]   # 2 leftover + 2 fresh
        _assert_twins(run, jrun)

    def test_burst_disabled_matches_seed_cadence(self):
        (rt, run), (jrt, jrun) = _backlogged(True, 1), _backlogged(False, 1)
        rt.tick()
        jrt.tick()
        assert _counts(rt, run) == _counts(jrt, jrun) == (1, 0, 0, 0, 0)

    def test_burst_vs_per_frame_outputs_identical(self):
        rt1, run1 = _backlogged(True, 8)
        rt1.tick()
        rt2, run2 = _backlogged(True, 1)
        for _ in range(6):
            rt2.tick()
        n = min(len(run1.sink_log["o"]), len(run2.sink_log["o"]))
        assert n == 6
        for a, b in zip(run1.sink_log["o"][:n], run2.sink_log["o"][:n]):
            assert_tree_equal(a, b, "burst-vs-per-frame")

    def test_query_pipelines_never_burst(self):
        for parse in (parse_launch, jparse):
            srv = parse("tensor_query_serversrc operation=op name=ssrc ! "
                        "tensor_query_serversink name=ssink")
            srv.elements["ssink"].pair_with(srv.elements["ssrc"])
            srv.realize()
            assert not srv.plan.burstable and not srv.plan.pure

    @pytest.mark.parametrize("desc", [
        "testsrc ! tensor_converter ! appsink name=o",
        "mqttsrc sub-topic=x ! appsink name=o",
        "mqttsrc sub-topic=x ! tensor_transform mode=arithmetic "
        "option=typecast:float32 ! mqttsink pub-topic=y",
        "mqttsrc sub-topic=x ! mux.sink_0 testsrc ! mux.sink_1 "
        "tensor_mux name=mux ! appsink name=o",
        "appsrc name=in ! tensor_query_client operation=q ! appsink name=o",
    ])
    def test_plan_flags_match_jax(self, desc):
        p, j = parse_launch(desc).realize(), jparse(desc).realize()
        for flag in ("pure", "burstable", "all_sources_host_driven",
                     "has_query_clients"):
            assert getattr(p.plan, flag) == getattr(j.plan, flag), flag
        for which in ("host_sources", "host_sinks"):
            assert [e.factory_name for e in getattr(p.plan, which)] == \
                [e.factory_name for e in getattr(j.plan, which)], which

    def test_pure_pipeline_flags(self):
        p = parse_launch("testsrc ! tensor_converter ! appsink name=o")
        p.realize()
        assert p.plan.pure and p.plan.burstable
        assert not p.plan.all_sources_host_driven  # live source: no burst
        q = parse_launch("mqttsrc sub-topic=x ! appsink name=o").realize()
        assert not q.plan.pure and q.plan.burstable
        assert q.plan.all_sources_host_driven

    def test_mixed_live_source_stays_on_tick_cadence(self):
        desc = """
            mqttsrc sub-topic=live name=src ! queue ! mux.sink_0
            testsrc name=local width=8 height=8 ! tensor_converter ! mux.sink_1
            tensor_mux name=mux ! appsink name=o
        """
        (rt, run), (jrt, jrun) = (_backlogged(True, 8, sub_desc=desc),
                                  _backlogged(False, 8, sub_desc=desc))
        assert not run.pipe.plan.all_sources_host_driven
        for _ in range(3):
            rt.tick()
            jrt.tick()
        assert _counts(rt, run) == _counts(jrt, jrun) == (3, 0, 0, 0, 0)
        _assert_twins(run, jrun)

    def test_unread_frames_survive_and_replay_in_order(self):
        rt, run = _backlogged(True, 1)
        src = run.pipe.elements["src"]
        first, second = src.pull(), src.pull()
        src.unread([first, second])
        assert src.queued() >= 2
        got = src.pull_burst(2)
        assert got[0] is first and got[1] is second
        src.unread(got)
        rt.run(2)
        assert run.sink_log["o"][0] is first
        assert run.sink_log["o"][1] is second


def test_ragged_structures_replay_per_frame(monkeypatch):
    """Frames whose structures differ cannot stack: the burst replays
    the pulled frames one by one (the one fallback the JAX runtime has)."""
    rt, run = _backlogged(True, 8)
    src = run.pipe.elements["src"]
    odd = StreamBuffer(tensors=(torch.zeros(2, 2, dtype=torch.uint8),),
                       meta={"odd": 1})
    src.unread([odd])
    rt.tick()
    assert run.frames == 7 and run.bursts == 0
    assert run.sink_log["o"][0] is odd


# ---------------------------------------------------------------------------
# a codec-carrying subscriber: burst == burst=1 == the JAX runtime
# ---------------------------------------------------------------------------

CODEC_BACKLOG, CODEC_TICKS = 5, 3


def _codec_chain(port, codec, burst, ticks=CODEC_TICKS, device="cpu"):
    """A publisher of f32 frames and a late subscriber that transforms and
    republishes them, both with ``codec``.  -> (runtime, sub run, the
    subscriber's republished (payload, wire bytes))"""
    opt = ("typecast:float32,add:-127.5,div:127.5" if codec == "quant8"
           else "typecast:float32,add:-230,clamp:0:25")
    pub_desc = (f"testsrc width=40 height=1 channels=160 ! tensor_converter"
                f" ! tensor_transform mode=arithmetic option={opt} ! "
                f"mqttsink pub-topic=act codec={codec}")
    sub_desc = (f"mqttsrc sub-topic=act codec={codec} name=src ! "
                f"tensor_filter model=tb_gate ! mqttsink pub-topic=out "
                f"codec={codec} name=snk")
    if port:
        rt = Runtime(burst=burst, device=device)
        mk = lambda n: Device(n, device=device)       # noqa: E731
        add, parse = (lambda d, p: d.add_pipeline(p)), parse_launch
    else:
        rt, mk = JRuntime(burst=burst), JDevice
        add, parse = (lambda d, p: d.add_pipeline(p, jit=False)), jparse
    pub = mk("pub")
    add(pub, parse(pub_desc))
    rt.add_device(pub)
    rt.run(CODEC_BACKLOG)
    sub = mk("sub")
    sp = parse(sub_desc)
    run = add(sub, sp)
    rt.add_device(sub)
    seen = []
    push = sp.elements["snk"].channel.push

    def spy(buf, nbytes=None):
        seen.append((buf, nbytes))
        return push(buf, nbytes)
    sp.elements["snk"].channel.push = spy
    rt.run(ticks)
    return rt, run, seen


@pytest.mark.parametrize("codec", ["quant8", "sparse:0.15"])
def test_codec_burst_equals_per_frame_and_jax(codec, monkeypatch):
    calls = {"stacked": 0}
    real = comp.decode_stacked

    def counting(*a, **k):
        calls["stacked"] += 1
        return real(*a, **k)
    monkeypatch.setattr(comp, "decode_stacked", counting)
    rt, run, seen = _codec_chain(True, codec, burst=8)
    assert calls["stacked"] == 1            # the backlog: one stacked decode
    assert (run.frames, run.bursts, run.burst_frames) == \
        (CODEC_BACKLOG + CODEC_TICKS, 1, CODEC_BACKLOG + 1)
    rt1, run1, seen1 = _codec_chain(True, codec, burst=1,
                                    ticks=CODEC_BACKLOG + CODEC_TICKS)
    assert run1.bursts == 0 and run1.frames == len(seen1) == len(seen)
    for (a, na), (b, nb) in zip(seen, seen1):
        assert na == nb == comp.wire_nbytes(a)
        assert_tree_equal(a.tensors, b.tensors, "burst != burst=1")
        assert a.meta == b.meta
    jrt, jrun, jseen = _codec_chain(False, codec, burst=8)
    assert (jrun.frames, jrun.bursts, jrun.burst_frames) == \
        (run.frames, run.bursts, run.burst_frames)
    assert len(jseen) == len(seen)
    for (a, na), (b, nb) in zip(seen, jseen):
        assert na == nb
        assert_port_equals_jax(a, b, "republished payload")


@pytest.mark.parametrize("codec", ["quant8", "sparse:0.15"])
def test_pull_burst_stacked_decode_equals_per_frame_decode(codec):
    raws = [comp.encode(StreamBuffer(tensors=(torch.linspace(
        -3 + i, 3, 96 * 128).reshape(96, 128).clamp(min=0),), pts=i),
        codec)[0] for i in range(5)]
    burst = MqttSrc(sub_topic="t", codec=codec)._decode_burst(raws)
    single = [comp.decode(r, codec) for r in raws]
    for a, b in zip(burst, single):
        assert_tree_equal(a, b, "stacked decode")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA codec kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["quant8", "sparse:0.15"])
def test_codec_burst_on_the_card(cuda, codec):
    """The burst on the card: republished payloads bitwise its burst=1
    twin's and the CPU's; one stacked decode launch for the backlog and
    one encode launch per frame."""
    from repro_torch.kernels import quant8, sparse_dec, sparse_enc
    enc, dec = (("quantize8", "dequantize8") if codec == "quant8"
                else ("sparse_enc", "sparse_dec"))
    for mod in (quant8, sparse_enc, sparse_dec):
        mod.reset_launches()
    rt, run, seen = _codec_chain(True, codec, burst=8, device="cuda")
    launches = {**quant8.LAUNCHES, **sparse_enc.LAUNCHES,
                **sparse_dec.LAUNCHES}
    pub_frames = rt.devices[0].runs[0].frames
    assert launches[enc] == pub_frames + run.frames
    assert launches[dec] == run.bursts + run.frames - run.burst_frames
    _, run1, seen1 = _codec_chain(True, codec, burst=1,
                                  ticks=CODEC_BACKLOG + CODEC_TICKS,
                                  device="cuda")
    _, _, seen_cpu = _codec_chain(True, codec, burst=8)
    assert len(seen) == len(seen1) == len(seen_cpu)
    for (a, _), (b, _), (c, _) in zip(seen, seen1, seen_cpu):
        assert_tree_equal(a.tensors, b.tensors, "card burst != burst=1")
        la, _ = tree_flatten(a.tensors)
        lc, _ = tree_flatten(c.tensors)
        for x, y in zip(la, lc):
            assert torch.equal(x.cpu(), y), "card != CPU"
