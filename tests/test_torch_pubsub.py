"""The port's pub/sub elements (``mqttsink`` / ``mqttsrc``, paper §4.2.1)
against the JAX package on the CPU: the cases of ``test_pubsub.py`` and
``test_mqtt_unread.py``, each run through both packages on the same inputs.

* Channel: leaky drops of the oldest frame, byte accounting, ``pop_n``,
  broadcast to consumers and a late consumer's replay, capped at its
  capacity — counts and frames equal the JAX package's.
* Transports relay, hybrid and direct, the quant8 and sparse codecs over
  the channel, wildcard discovery and failover: frame and byte counts,
  broker relay accounting, wire payloads and decoded frames (pts after the
  clock rebase included) bitwise equal to the JAX runtime's.
* ``unread``: front of the line, in order, never decoded twice; the
  scheduler's burst surplus goes back to the front.
* Broadcast aliasing: a channel hands one frame object to every
  subscriber, so no element may write into a frame it received.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Broker as JBroker
from repro.core import Channel as JChannel
from repro.core import StreamBuffer as JBuf
from repro.core import parse_launch as jparse
from repro.core import compression as jcomp
from repro.runtime import Device as JDevice
from repro.runtime import Runtime as JRuntime
from repro_torch.core import (Broker, Channel, MqttSink, MqttSrc,
                              StreamBuffer, Transport, parse_launch)
from repro_torch.core import compression as comp
from repro_torch.core import pubsub
from repro_torch.runtime import Device, Runtime

torch.set_num_threads(2)


class Port:
    parse = staticmethod(parse_launch)
    Broker = Broker
    Channel = Channel

    @staticmethod
    def runtime(**kw):
        return Runtime(device="cpu", **kw)

    @staticmethod
    def device(name, **kw):
        return Device(name, device="cpu", **kw)

    @staticmethod
    def add(dev, pipe):
        return dev.add_pipeline(pipe)

    @staticmethod
    def frame(value, shape=(2, 2), pts=0):
        return StreamBuffer(tensors=(torch.full(shape, float(value)),),
                            pts=pts)


class Jax:
    parse = staticmethod(jparse)
    Broker = JBroker
    Channel = JChannel
    runtime = JRuntime
    device = JDevice

    @staticmethod
    def add(dev, pipe):
        return dev.add_pipeline(pipe, jit=False)

    @staticmethod
    def frame(value, shape=(2, 2), pts=0):
        return JBuf(tensors=(jnp.full(shape, value, jnp.float32),),
                    pts=jnp.int32(pts))


BOTH = (Port, Jax)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fields(t):
    name = type(t).__name__
    if name == "Quant8Payload":
        return [t.q, t.scale]
    if name == "SparsePayload":
        return [t.values, t.indices, t.nnz]
    return [t]


def assert_buf_equal(a, b, what=""):
    """A port buffer equals a JAX one: pts, meta, and every tensor (or
    codec payload field) with its shape and dtype, bitwise."""
    assert int(a.pts) == int(b.pts), what
    assert a.meta == b.meta, what
    assert len(a.tensors) == len(b.tensors), what
    for x, y in zip(a.tensors, b.tensors):
        assert type(x).__name__ == type(y).__name__ or \
            (isinstance(x, torch.Tensor) and not hasattr(y, "q")), what
        for u, v in zip(_fields(x), _fields(y)):
            u, v = _np(u), _np(v)
            assert u.shape == v.shape and u.dtype == v.dtype, what
            np.testing.assert_array_equal(u, v, err_msg=what)


def assert_logs_equal(run, jrun, name):
    got, want = run.sink_log.get(name, []), jrun.sink_log.get(name, [])
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert_buf_equal(a, b, f"{name}[{i}]")


def _spy(channel):
    """Record every (payload, wire bytes) pushed onto ``channel``."""
    seen = []
    push = channel.push

    def spy(buf, nbytes=None):
        seen.append((buf, nbytes))
        return push(buf, nbytes)
    channel.push = spy
    return seen


# ---------------------------------------------------------------------------
# Channel
# ---------------------------------------------------------------------------

def _channel_story(pkg):
    ch = pkg.Channel(capacity=2)
    oks = [ch.push(pkg.frame(i)) for i in range(4)]
    first = ch.pop()
    big = pkg.Channel()
    big.push(pkg.frame(0, shape=(10, 10)))
    for i in range(5):
        big.push(pkg.frame(i + 1))
    head = big.pop_n(3)
    return (oks, ch.drops, float(first.tensor[0, 0]), big.bytes_sent,
            big.msgs_sent, [float(b.tensor.reshape(-1)[0]) for b in head],
            len(big))


def test_channel_leaky_drop_bytes_and_pop_n_match_jax():
    got, want = _channel_story(Port), _channel_story(Jax)
    assert got == want
    assert got[:3] == ([True, True, False, False], 2, 2.0)  # oldest dropped
    assert got[3] == 400 + 5 * 16


@pytest.mark.parametrize("history,capacity", [(3, None), (10, 4), (20, 16),
                                              (5, 5)])
def test_late_consumer_replay_capped_at_capacity(history, capacity):
    """A late subscriber sees only the newest ``capacity`` frames of the
    publisher's history; the rest are booked as its drops."""
    res = []
    for pkg in BOTH:
        pub = pkg.Channel(capacity=64)
        for i in range(history):
            pub.push(pkg.frame(i, shape=(1,)))
        sub = pub.attach_consumer(capacity=capacity)
        got = []
        while len(sub):
            got.append(float(sub.pop().tensor[0]))
        res.append((got, sub.drops, sub.capacity))
    assert res[0] == res[1]
    got, drops, cap = res[0]
    assert got == [float(i) for i in range(history - len(got), history)]
    assert drops == history - min(history, cap)


def test_broadcast_push_reports_a_displacement_on_any_consumer():
    res = []
    for pkg in BOTH:
        pub = pkg.Channel(capacity=8)
        small = pub.attach_consumer(capacity=1)
        large = pub.attach_consumer()
        oks = [pub.push(pkg.frame(i)) for i in range(3)]
        res.append((oks, small.drops, large.drops, len(small), len(large),
                    len(pub), pub.msgs_sent))
    assert res[0] == res[1] == [([True, False, False], 2, 0, 1, 3, 0, 3)][0]


# ---------------------------------------------------------------------------
# transports and codecs through the runtime
# ---------------------------------------------------------------------------

def _pub_sub(pkg, transport, codec="none", ticks=4, width=16):
    rt = pkg.runtime()
    pub = pkg.device("pub")
    p = pkg.parse(
        f"testsrc width={width} height={width} ! tensor_converter ! "
        f"tensor_transform mode=arithmetic "
        f"option=typecast:float32,add:-127.5,div:127.5 ! "
        f"mqttsink pub-topic=t transport={transport} codec={codec} "
        f"name=snk")
    pkg.add(pub, p)
    seen = _spy(p.elements["snk"].channel)
    rt.add_device(pub)
    sub = pkg.device("sub")
    s = pkg.parse(f"mqttsrc sub-topic=t transport={transport} codec={codec} "
                  f"name=src ! appsink name=o")
    if transport == "direct":
        s.elements["src"].connect_direct(p.elements["snk"].channel)
    run = pkg.add(sub, s)
    rt.add_device(sub)
    rt.run(ticks)
    return rt, run, p.elements["snk"], seen


@pytest.mark.parametrize("transport", ["relay", "hybrid", "direct"])
def test_transports_match_jax(transport):
    rt, run, snk, _ = _pub_sub(Port, transport)
    jrt, jrun, jsnk, _ = _pub_sub(Jax, transport)
    assert rt.stats()["sub/p0"] == {
        "frames": jrun.frames, "skipped": jrun.skipped,
        "bursts": jrun.bursts, "burst_frames": jrun.burst_frames,
        "drops": jrt.stats()["sub/p0"]["drops"]}
    assert run.frames == 4
    b, jb = rt.stats()["broker"], jrt.stats()["broker"]
    assert b == {k: jb[k] for k in b}
    assert snk.channel.bytes_sent == jsnk.channel.bytes_sent > 0
    if transport == "relay":
        assert b["relay_msgs"] == 4
        assert b["relay_bytes"] == snk.channel.bytes_sent
    else:   # the MQTT-hybrid design point: zero broker data bytes
        assert b["relay_bytes"] == 0
    assert (snk.registration is None) == (transport == "direct")
    assert_logs_equal(run, jrun, "o")


@pytest.mark.parametrize("codec", ["quant8", "sparse:0.5"])
def test_codecs_over_the_channel_match_jax_bitwise(codec):
    comp.reset_codec_stats()
    jcomp.reset_codec_stats()
    _, run, snk, seen = _pub_sub(Port, "hybrid", codec)
    _, jrun, jsnk, jseen = _pub_sub(Jax, "hybrid", codec)
    assert len(seen) == len(jseen) == 4
    for (buf, n), (jbuf, jn) in zip(seen, jseen):
        assert n == jn == comp.wire_nbytes(buf)
        assert_buf_equal(buf, jbuf, "wire payload")
    assert snk.channel.bytes_sent == jsnk.channel.bytes_sent
    assert comp.codec_stats() == jcomp.codec_stats()
    assert_logs_equal(run, jrun, "o")
    assert all("codec" not in b.meta for b in run.sink_log["o"])
    if codec == "quant8":   # f32 frames: ~4x narrower on the wire
        _, _, raw, _ = _pub_sub(Port, "hybrid", "none")
        assert snk.channel.bytes_sent < 0.3 * raw.channel.bytes_sent


def _wildcard(pkg):
    rt = pkg.runtime()
    pub = pkg.device("pub")
    pkg.add(pub, pkg.parse("testsrc width=4 height=4 ! tensor_converter ! "
                           "mqttsink pub-topic=cam/left/rgb"))
    rt.add_device(pub)
    sub = pkg.device("sub")
    run = pkg.add(sub, pkg.parse("mqttsrc sub-topic=cam/# ! appsink name=o"))
    rt.add_device(sub)
    rt.run(2)
    return run


def test_wildcard_subscription_matches_jax():
    run, jrun = _wildcard(Port), _wildcard(Jax)
    assert run.frames == jrun.frames >= 1
    assert_logs_equal(run, jrun, "o")


def _failover(pkg):
    rt = pkg.runtime()
    for name in ("pubA", "pubB"):
        d = pkg.device(name)
        pkg.add(d, pkg.parse(
            f"testsrc width=4 height=4 ! tensor_converter ! "
            f"mqttsink pub-topic=svc/{name} name=sink_{name}"))
        rt.add_device(d)
    sub = pkg.device("sub")
    s = pkg.parse("mqttsrc sub-topic=svc/# name=src ! appsink name=o")
    run = pkg.add(sub, s)
    rt.add_device(sub)
    rt.run(2)
    src = s.elements["src"]
    first = src.binding.current
    rt.broker.mark_down(first)
    rt.run(2)
    return rt, run, src, first


def test_pubsub_failover_matches_jax():
    rt, run, src, first = _failover(Port)
    jrt, jrun, jsrc, jfirst = _failover(Jax)
    assert src.binding.current is not first
    assert src.binding.current.topic == jsrc.binding.current.topic
    assert run.frames == jrun.frames >= 3
    assert src.drops == jsrc.drops
    assert_logs_equal(run, jrun, "o")


def _wired(pkg, broker, topic="t", codec="none", sub_topic=None):
    """A realized publisher + subscribed MqttSrc pair on ``broker``."""
    pub = pkg.parse(f"appsrc name=in ! mqttsink pub-topic={topic} "
                    f"codec={codec} name=snk")
    sink = pub.elements["snk"].connect(broker)
    pub.realize()
    sub = pkg.parse(f"mqttsrc sub-topic={sub_topic or topic} codec={codec} "
                    f"name=src ! appsink name=o")
    src = sub.elements["src"].connect(broker)
    sub.realize()
    return sink, src


def _rebind_carry_over(pkg):
    """The bound publisher dies with frames still queued for us: they come
    out first, in order, then the survivor's."""
    broker = pkg.Broker()
    a, _ = _wired(pkg, broker, topic="svc/a")
    b, src = _wired(pkg, broker, topic="svc/b", sub_topic="svc/#")
    for i in range(3):
        a.apply({}, [pkg.frame(i, pts=i)])
        b.apply({}, [pkg.frame(10 + i, pts=10 + i)])
    first = src.pull()
    bound = src.binding.current
    broker.mark_down(bound)
    got = [first] + src.pull_burst(8)
    return ([int(f.pts) for f in got], bound.topic, src.drops,
            src.queued(), [float(f.tensor[0, 0]) for f in got])


def test_failover_rebind_carries_queued_frames_over():
    got, want = _rebind_carry_over(Port), _rebind_carry_over(Jax)
    assert got == want
    assert got[:4] == ([0, 1, 2, 10, 11, 12], "svc/a", 0, 0)


# ---------------------------------------------------------------------------
# unread and the burst surplus
# ---------------------------------------------------------------------------

def _unread_front(pkg):
    sink, src = _wired(pkg, pkg.Broker())
    for i in range(5):
        sink.apply({}, [pkg.frame(i, pts=i)])
    a, b = src.pull(), src.pull()
    src.unread([a, b])
    first = [int(f.pts) for f in src.pull_burst(5)]
    sink.apply({}, [pkg.frame(5, pts=5)])
    x = src.pull()
    src.unread([x])
    sink.apply({}, [pkg.frame(6, pts=6)])
    second = [int(f.pts) for f in src.pull_burst(3)]
    return first, second


def test_unread_comes_back_front_of_line_in_order():
    got, want = _unread_front(Port), _unread_front(Jax)
    assert got == want == ([0, 1, 2, 3, 4], [5, 6])


def test_unread_frames_never_decoded_twice(monkeypatch):
    sink, src = _wired(Port, Broker(), codec="quant8")
    for i in range(3):
        sink.apply({}, [Port.frame(i, pts=i)])
    decoded = [src.pull(), src.pull()]
    calls = {"n": 0}
    real = comp.decode

    def counting(buf, codec):
        calls["n"] += 1
        return real(buf, codec)
    monkeypatch.setattr(pubsub.comp, "decode", counting)
    src.unread(decoded)
    back = [src.pull(), src.pull()]
    assert back[0] is decoded[0] and back[1] is decoded[1]
    assert calls["n"] == 0      # pushed-back frames skip the codec
    assert int(src.pull().pts) == 2 and calls["n"] == 1


def _queued(pkg):
    sink, src = _wired(pkg, pkg.Broker())
    for i in range(4):
        sink.apply({}, [pkg.frame(i, pts=i)])
    x = src.pull()
    n1 = src.queued()
    src.unread([x])
    return n1, src.queued()


def test_queued_counts_pushback_plus_channel():
    assert _queued(Port) == _queued(Jax) == (3, 4)


def _two_source_run(pkg):
    """Mux over two mqttsrc topics with UNEQUAL backlogs."""
    rt = pkg.runtime(burst=8)
    cam = pkg.device("cam")
    pkg.add(cam, pkg.parse("""
        testsrc width=4 height=4 name=c1 ! tensor_converter ! mqttsink pub-topic=a name=s1
        testsrc width=4 height=4 name=c2 ! tensor_converter ! mqttsink pub-topic=b name=s2
    """))
    rt.add_device(cam)
    rt.run(4)
    proc = pkg.device("proc")
    run = pkg.add(proc, pkg.parse("""
        mqttsrc sub-topic=a name=sa ! mux.sink_0
        mqttsrc sub-topic=b name=sb ! mux.sink_1
        tensor_mux name=mux ! appsink name=o
    """))
    rt.add_device(proc)
    sb = run.pipe.elements["sb"]
    for _ in range(3):
        sb.pull()
    # a forced 4-frame burst: sa pulls 4, sb delivers 1, so one frame runs
    # and sa's surplus 3 go back to the front
    rt._run_burst(run, 4)
    after = (run.frames, run.pipe.elements["sa"].queued())
    rt.run(3)
    return rt, run, after


def test_burst_surplus_requeues_at_the_front_like_jax():
    rt, run, after = _two_source_run(Port)
    jrt, jrun, jafter = _two_source_run(Jax)
    assert after == jafter == (1, 3)
    pts = [int(b.pts) for b in run.sink_log["o"]]
    assert pts == sorted(pts) and len(pts) == len(set(pts))
    assert run.frames == jrun.frames and run.bursts == jrun.bursts
    assert_logs_equal(run, jrun, "o")


# ---------------------------------------------------------------------------
# broadcast aliasing
# ---------------------------------------------------------------------------

def _two_subscribers(pkg):
    rt = pkg.runtime()
    cam = pkg.device("cam")
    pkg.add(cam, pkg.parse(
        "testsrc width=8 height=6 ! tensor_converter ! tensor_transform "
        "mode=arithmetic option=typecast:float32 ! mqttsink pub-topic=v"))
    rt.add_device(cam)
    busy = pkg.device("busy")
    bus = pkg.add(busy, pkg.parse(
        "mqttsrc sub-topic=v ! tensor_transform mode=arithmetic "
        "option=add:1.0,mul:3.0,clamp:0:100 ! tensor_if threshold=50 "
        "operator=GE ! appsink name=o"))
    rt.add_device(busy)
    plain = pkg.device("plain")
    pl = pkg.add(plain, pkg.parse("mqttsrc sub-topic=v ! queue ! tee name=t "
                                  "t. ! appsink name=a t. ! appsink name=b"))
    rt.add_device(plain)
    rt.run(3)
    return bus, pl


def test_two_subscribers_see_identical_frames_after_one_transforms():
    """Both subscribers receive the same frame objects; the one that
    transforms its copy must leave the other's bitwise intact."""
    bus, pl = _two_subscribers(Port)
    jbus, jpl = _two_subscribers(Jax)
    assert_logs_equal(bus, jbus, "o")
    for name in ("a", "b"):
        assert_logs_equal(pl, jpl, name)
    for a, b in zip(pl.sink_log["a"], pl.sink_log["b"]):
        assert a.tensor is b.tensor         # the tee fans out one frame
    raw = Port.parse("testsrc width=8 height=6 ! tensor_converter ! "
                     "tensor_transform mode=arithmetic "
                     "option=typecast:float32 ! appsink name=o")
    st = raw.init_state("cpu")
    for got in pl.sink_log["a"]:
        out, st = raw.step({}, st)
        assert torch.equal(got.tensor, out["o"].tensor)


def test_transport_enum_and_exports():
    assert {t.value for t in Transport} == {"relay", "hybrid", "direct"}
    assert MqttSink.is_host_sink and MqttSrc.is_host_source


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA codec kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["quant8", "sparse:0.5"])
def test_codecs_over_the_channel_on_the_card(cuda, codec):
    """The same publisher and subscriber on the card: wire payloads and
    decoded frames bitwise the CPU run's, one encode launch per published
    frame and one decode launch per received one."""
    from repro_torch.kernels import quant8, sparse_dec, sparse_enc
    enc, dec = (("quantize8", "dequantize8") if codec == "quant8"
                else ("sparse_enc", "sparse_dec"))
    for mod in (quant8, sparse_enc, sparse_dec):
        mod.reset_launches()

    class Card(Port):
        @staticmethod
        def runtime(**kw):
            return Runtime(device="cuda", **kw)

        @staticmethod
        def device(name, **kw):
            return Device(name, device="cuda", **kw)
    _, run, _, seen = _pub_sub(Card, "hybrid", codec)
    launches = {**quant8.LAUNCHES, **sparse_enc.LAUNCHES,
                **sparse_dec.LAUNCHES}
    assert launches[enc] == len(seen) == 4 and launches[dec] == run.frames
    _, crun, _, cseen = _pub_sub(Port, "hybrid", codec)
    for (a, na), (b, nb) in zip(seen, cseen):
        assert na == nb and a.meta == b.meta
        for x, y in zip(a.tensors, b.tensors):
            for u, v in zip(_fields(x), _fields(y)):
                assert u.device.type == "cuda"
                assert torch.equal(u.cpu(), v)
    for a, b in zip(run.sink_log["o"], crun.sink_log["o"]):
        assert int(a.pts) == int(b.pts) and torch.equal(a.tensor.cpu(),
                                                        b.tensor)
