"""The paper's pub/sub scenarios and synchronous offloading on the port's
``Runtime(device="cpu")``, against the JAX runtime on the same inputs.

* Fig. 3 (``test_system.py``'s multi-camera scenario, with the skewed
  camera clock of ``examples/multicam_pubsub.py``): two cameras publish,
  a processing device detects and republishes, a display muxes both
  cameras and the inference.  Frame, skip, burst and drop counts per
  pipeline, pts after the clock rebase and after the mux, and the muxed
  frames are equal to the JAX runtime's; every published frame is
  delivered, dropped or still queued, per topic; the detector's outputs
  y = x W agree within 1e-5 · Σ_i |x_i W_ij| (the two packages' f32 GEMMs
  sum the 768 products in different orders).  The same scenario over relay transport puts every data byte
  through the broker.
* Fig. 5 (the gated multimodal worker): bitwise the JAX runtime's.
* ``query_batch=0`` (synchronous round trips inside
  ``tensor_query_client.apply``): answers bitwise equal to ``query_batch=8``
  and to the JAX runtime at ``query_batch=0``, for codecs none, quant8 and
  sparse; a model_serve server answers one-token generations and raises on
  longer ones, as the JAX runtime does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SimClock as JSimClock
from repro.core import TensorSpec as JSpec
from repro.core import parse_launch as jparse
from repro.core.broker import BrokerError as JBrokerError
from repro.core.elements import register_model as jregister
from repro.launch import model_serve as jms
from repro.runtime import Device as JDevice
from repro.runtime import Runtime as JRuntime
from repro_torch.core import (BrokerError, MqttSink, MqttSrc, SimClock,
                              TensorSpec, parse_launch)
from repro_torch.core.elements import register_model
from repro_torch.launch import model_serve as ms
from repro_torch.runtime import Device, Runtime

torch.set_num_threads(2)

W_DET = (0.05 * np.random.default_rng(5).standard_normal((768, 8))).astype(
    np.float32)
#: the port detector's inputs, in call order
DET_INPUTS = []
#: the detector's tolerance: |Δy_j| ≤ GEMM_TOL · Σ_i |x_i W_ij| (two f32
#: sums of 768 products in different orders)
GEMM_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def models():
    def detect(p, x):
        DET_INPUTS.append(x)
        return (x.to(torch.float32).reshape(1, -1) @ p["w"],)
    register_model("ts_detector", lambda g, dev: {"w": torch.as_tensor(
        W_DET, device=dev)}, detect,
        out_specs=(TensorSpec((1, 8), "float32"),))
    jregister("ts_detector", lambda rng: {"w": jnp.asarray(W_DET)},
              lambda p, x: (x.astype(jnp.float32).reshape(1, -1) @ p["w"],),
              out_specs=(JSpec((1, 8), "float32"),))
    # elementwise only, so the two packages agree bitwise
    register_model("ts_gate", None,
                   lambda p, x: torch.clamp(x, 0.0) * 0.5 - 0.125,
                   out_specs=())
    jregister("ts_gate", None,
              lambda p, x: jnp.maximum(x, 0.0) * 0.5 - 0.125, out_specs=())


class Port:
    parse = staticmethod(parse_launch)
    clock = SimClock

    @staticmethod
    def runtime(**kw):
        return Runtime(device="cpu", **kw)

    @staticmethod
    def device(name, **kw):
        return Device(name, device="cpu", **kw)

    @staticmethod
    def add(dev, pipe):
        return dev.add_pipeline(pipe)


class Jax:
    parse = staticmethod(jparse)
    clock = JSimClock
    runtime = JRuntime
    device = JDevice

    @staticmethod
    def add(dev, pipe):
        return dev.add_pipeline(pipe, jit=False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _meta(buf):
    """Meta without ``client_id`` (each package numbers its own clients)."""
    return {k: v for k, v in buf.meta.items() if k != "client_id"}


def assert_bufs_equal(a, b, label):
    assert int(a.pts) == int(b.pts), label
    assert _meta(a) == _meta(b), label
    assert len(a.tensors) == len(b.tensors), label
    for x, y in zip(a.tensors, b.tensors):
        x, y = _np(x), _np(y)
        assert x.shape == y.shape and x.dtype == y.dtype, label
        np.testing.assert_array_equal(x, y, err_msg=label)


def _counts(rt, devices):
    st = rt.stats()
    return {k: v for k, v in st.items() if "/" in k}, \
        {k: st["broker"][k] for k in ("relay_msgs", "relay_bytes",
                                      "suspicions", "heals")}


# ---------------------------------------------------------------------------
# Fig. 3: two cameras, a processing device, a display
# ---------------------------------------------------------------------------

def _fig3(pkg, transport="hybrid", ticks=8):
    rt = pkg.runtime()
    snks = []
    for side, skew_ms in (("left", 0), ("right", 40)):
        cam = pkg.device(f"cam_{side}",
                         clock=pkg.clock(skew_ns=skew_ms * 1_000_000))
        p = pkg.parse(
            f"testsrc width=32 height=32 ! tensor_converter ! "
            f"queue leaky=2 ! mqttsink pub-topic=cam/{side} "
            f"transport={transport}")
        pkg.add(cam, p)
        snks += [e for e in p.elements.values()
                 if type(e).__name__ == "MqttSink"]
        rt.add_device(cam)
    proc = pkg.device("coral")
    pp = pkg.parse(f"""
        mqttsrc sub-topic=cam/left transport={transport} name=src ! videoscale !
          video/x-raw,width=16,height=16,format=RGB ! tensor_converter !
          tensor_transform mode=arithmetic option=typecast:float32,div:255.0 !
          tensor_filter model=ts_detector !
          mqttsink pub-topic=edge/inference transport={transport}
    """)
    # videoscale negotiates from the publisher's caps, so the source
    # discovers it before the pipeline is realized
    pp.elements["src"].connect(rt.broker)
    prun = pkg.add(proc, pp)
    snks += [e for e in pp.elements.values()
             if type(e).__name__ == "MqttSink"]
    rt.add_device(proc)
    disp = pkg.device("lcd")
    pd = pkg.parse(f"""
        mqttsrc sub-topic=cam/left transport={transport} ! queue ! mux.sink_0
        mqttsrc sub-topic=cam/right transport={transport} ! queue ! mux.sink_1
        tensor_mux name=mux ! appsink name=out
        mqttsrc sub-topic=edge/inference transport={transport} ! appsink name=infer
    """)
    drun = pkg.add(disp, pd)
    rt.add_device(disp)
    rt.run(ticks)
    return rt, prun, drun, snks


def test_fig3_multicamera_matches_jax():
    DET_INPUTS.clear()
    rt, prun, drun, snks = _fig3(Port)
    jrt, jprun, jdrun, jsnks = _fig3(Jax)
    assert _counts(rt, None) == _counts(jrt, None)
    assert drun.frames >= 4
    got, want = drun.sink_log["out"], jdrun.sink_log["out"]
    assert len(got) == len(want) == drun.frames
    for i, (a, b) in enumerate(zip(got, want)):
        assert_bufs_equal(a, b, f"out[{i}]")
    got, want = drun.sink_log["infer"], jdrun.sink_log["infer"]
    assert len(got) == len(want) == drun.frames <= len(DET_INPUTS)
    for i, (a, b) in enumerate(zip(got, want)):
        assert int(a.pts) == int(b.pts) and _meta(a) == _meta(b)
        x = DET_INPUTS[i].reshape(1, -1).double().abs().numpy()
        bound = GEMM_TOL * (x @ np.abs(W_DET.astype(np.float64)))
        assert (np.abs(_np(a.tensor) - _np(b.tensor)) <= bound).all(), i
    assert len(drun.last_outputs["out"].tensors) == 2
    assert drun.last_outputs["infer"].tensor.shape == (1, 8)
    # the broker carries no data bytes on hybrid
    assert rt.broker.relay_bytes == 0
    assert [s.channel.bytes_sent for s in snks] == \
        [s.channel.bytes_sent for s in jsnks]


def _published_by_topic(snks):
    return {s.topic: s.channel.msgs_sent for s in snks}


def test_fig3_conserves_frames_per_topic_and_mux_takes_min_pts():
    rt, prun, drun, snks = _fig3(Port, ticks=10)
    published = _published_by_topic(snks)
    devs = {d.name: d for d in rt.devices}
    for run in (prun, drun):
        for e in run.pipe.elements.values():
            if isinstance(e, MqttSrc):
                pub = published[e.topic_filter]
                assert run.frames + e.drops + e.queued() == pub, \
                    (e.topic_filter, run.frames, e.drops, e.queued(), pub)
    # the mux's pts is the earliest of its inputs, rebased into the
    # display's running time
    lcd = devs["lcd"].pipeline_clock.base_time_utc()
    delta = {side: devs[f"cam_{side}"].pipeline_clock.base_time_utc() - lcd
             for side in ("left", "right")}
    assert delta["left"] != delta["right"]
    for k, buf in enumerate(drun.sink_log["out"]):
        pts = k * (16_666_667 // 1000)
        assert int(buf.pts) == min(pts + delta["left"], pts + delta["right"])


def test_fig3_relay_puts_every_data_byte_through_the_broker():
    rt, _, drun, snks = _fig3(Port, transport="relay", ticks=5)
    jrt, _, jdrun, _ = _fig3(Jax, transport="relay", ticks=5)
    assert _counts(rt, None) == _counts(jrt, None)
    assert rt.broker.relay_bytes == sum(s.channel.bytes_sent for s in snks)
    assert rt.broker.relay_msgs == sum(s.channel.msgs_sent for s in snks)
    assert drun.frames == jdrun.frames >= 3


# ---------------------------------------------------------------------------
# Fig. 5: the gated multimodal worker
# ---------------------------------------------------------------------------

def _fig5(pkg):
    rt = pkg.runtime()
    wear = pkg.device("watch")
    pkg.add(wear, pkg.parse("testsrc width=8 height=4 ! tensor_converter ! "
                            "mqttsink pub-topic=wearable/imu"))
    rt.add_device(wear)
    mobile = pkg.device("phone")
    run = pkg.add(mobile, pkg.parse("""
        mqttsrc sub-topic=wearable/imu !
        tensor_transform mode=arithmetic option=typecast:float32,div:255.0 !
        tensor_if threshold=0.5 operator=GE name=gate ! appsink name=decision
    """))
    rt.add_device(mobile)
    rt.run(4)
    return rt, run


def test_fig5_gated_worker_matches_jax_bitwise():
    rt, run = _fig5(Port)
    jrt, jrun = _fig5(Jax)
    assert _counts(rt, None) == _counts(jrt, None)
    assert run.frames >= 3
    got, want = run.sink_log["decision"], jrun.sink_log["decision"]
    assert len(got) == len(want) == run.frames
    for i, (a, b) in enumerate(zip(got, want)):
        assert_bufs_equal(a, b, f"decision[{i}]")
        assert int(a.tensors[-1]) in (0, 1)


# ---------------------------------------------------------------------------
# query_batch=0: synchronous round trips
# ---------------------------------------------------------------------------

_SERVER = ("tensor_query_serversrc operation=op name=ssrc ! "
           "tensor_filter model=ts_gate ! tensor_query_serversink name=ssink")


def _offload(pkg, codec, n_clients=3, ticks=3, **kw):
    rt = pkg.runtime(**kw)
    hub = pkg.device("hub")
    ps = pkg.parse(_SERVER)
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    srv = pkg.add(hub, ps)
    rt.add_device(hub)
    runs = []
    for i in range(n_clients):
        dev = pkg.device(f"tv{i}")
        runs.append(pkg.add(dev, pkg.parse(
            f"testsrc width=40 height=1 channels=160 ! tensor_converter ! "
            f"tensor_transform mode=arithmetic "
            f"option=typecast:float32,add:-200,div:50.0 ! "
            f"tensor_query_client operation=op codec={codec} name=qc ! "
            f"appsink name=res")))
        rt.add_device(dev)
    rt.run(ticks)
    return rt, srv, runs


@pytest.mark.parametrize("codec", ["none", "quant8", "sparse:0.5"])
def test_query_batch_zero_equals_batch_eight_and_jax(codec):
    rt0, srv0, runs0 = _offload(Port, codec, query_batch=0)
    rt8, _, runs8 = _offload(Port, codec, query_batch=8)
    jrt, _, jruns = _offload(Jax, codec, query_batch=0)
    qb = rt0.stats()["query_batching"]
    assert qb["max_batch"] == 0 and qb["batched_frames"] == 0
    assert qb["sequential_frames"] == srv0.frames == 9
    assert rt8.stats()["query_batching"]["batched_frames"] == 9
    for r0, r8, jr in zip(runs0, runs8, jruns):
        assert r0.frames == r8.frames == jr.frames == 3
        for i, (a, b, c) in enumerate(zip(r0.sink_log["res"],
                                          r8.sink_log["res"],
                                          jr.sink_log["res"])):
            assert_bufs_equal(a, c, f"batch 0 vs JAX [{i}]")
            assert _meta(a) == _meta(b)
            assert torch.equal(a.tensor, b.tensor), f"batch 0 vs 8 [{i}]"


def _serve_batch_zero(pkg, gens):
    rt = pkg.runtime(query_batch=0)
    hub = pkg.device("hub")
    srv = (ms if pkg is Port else jms).serve_pipeline(
        model="stablelm-smoke", slots=2, max_seq=16)
    pkg.add(hub, srv)
    rt.add_device(hub)
    tv = pkg.device("tv0")
    cli = pkg.add(tv, (ms if pkg is Port else jms).client_pipeline(
        prompts="1,2,3", gens=gens))
    rt.add_device(tv)
    rt.run(3)
    return rt, cli


def test_model_serve_at_query_batch_zero_behaves_like_jax():
    """The synchronous client waits one flush: a one-token generation is
    answered by its prefill; a longer one has no answer yet and raises."""
    rt, cli = _serve_batch_zero(Port, "1")
    jrt, jcli = _serve_batch_zero(Jax, "1")
    assert cli.frames == jcli.frames == 3
    assert [len(b.tensors[0]) for b in cli.sink_log["res"]] == [1, 1, 1]
    qb, jqb = rt.stats()["query_batching"], jrt.stats()["query_batching"]
    for k in ("prefills", "decode_ticks", "tokens_generated",
              "tokens_delivered", "streams_finished", "sequential_frames"):
        assert qb[k] == jqb[k], k
    rt8 = Runtime(device="cpu", query_batch=8)
    hub = Device("hub", device="cpu")
    hub.add_pipeline(ms.serve_pipeline(model="stablelm-smoke", slots=2,
                                       max_seq=16))
    rt8.add_device(hub)
    tv = Device("tv0", device="cpu")
    cli8 = tv.add_pipeline(ms.client_pipeline(prompts="1,2,3", gens="1"))
    rt8.add_device(tv)
    rt8.run(3)
    for a, b in zip(cli.sink_log["res"], cli8.sink_log["res"]):
        assert torch.equal(torch.as_tensor(a.tensors[0]),
                           torch.as_tensor(b.tensors[0]))
    with pytest.raises(BrokerError, match="no answer"):
        _serve_batch_zero(Port, "3")
    with pytest.raises(JBrokerError, match="no answer"):
        _serve_batch_zero(Jax, "3")
