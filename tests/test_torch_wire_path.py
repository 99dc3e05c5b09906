"""The port's codec-carrying query offloading (the fused wire path) on the
CPU, against itself and against the JAX package's runtime.

Four clients run ``testsrc ! tensor_converter ! tensor_transform !
tensor_query_client codec=... ! appsink`` against one server
``tensor_query_serversrc ! tensor_filter ! tensor_query_serversink``.  The
server model is ``y = x * sigmoid(x @ W)`` (it keeps the request's zeros,
so sparse answers stay sparse), with W drawn once from numpy and shared by
both packages.

* In the port, the fused path (``query_batch`` 1, 4 and 8), the eager path
  (``fused_wire=False``) and every batch size give the same answers,
  bitwise, and the same codec stats.
* The request wire buffers pushed onto the server's channel equal the JAX
  runtime's, bitwise, with equal wire bytes and meta.
* The answers agree with the JAX runtime's within one quant step of their
  (32, 128) tile (quant8: the two packages' f32 GEMMs sum in different
  orders, and a rounding flip moves a value by one step) or rtol 1e-5
  (sparse: values pass through unchanged).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TensorSpec as JSpec
from repro.core import compression as jcomp
from repro.core import parse_launch as jparse
from repro.core.elements import register_model as jregister
from repro.runtime import Device as JDevice
from repro.runtime import Runtime as JRuntime
from repro_torch.core import TensorSpec, parse_launch
from repro_torch.core import compression as comp
from repro_torch.core.buffers import (Quant8Payload, SparsePayload,
                                      tree_flatten)
from repro_torch.core.elements import register_model
from repro_torch.kernels import ops, ref
from repro_torch.runtime import Device, Runtime

torch.set_num_threads(2)

ROWS, CHANNELS, CLIENTS, TICKS = 40, 160, 4, 2
W = (0.05 * np.random.default_rng(12).standard_normal(
    (CHANNELS, CHANNELS))).astype(np.float32)
TRANSFORMS = {
    "quant8": "typecast:float32,add:-127.5,div:127.5,mul:{m}",
    "sparse:0.25": "typecast:float32,add:-230,clamp:0:25,mul:{m}",
    "none": "typecast:float32,add:-127.5,div:127.5,mul:{m}",
}
CODECS = ["quant8", "sparse:0.25"]


@pytest.fixture(scope="module", autouse=True)
def models():
    out = (TensorSpec((1, ROWS, CHANNELS), "float32"),)
    register_model("twp_gate", lambda g, dev: {
        "w": torch.as_tensor(W, device=dev)},
        lambda p, x: x * torch.sigmoid(x @ p["w"]), out_specs=out)
    jregister("twp_gate", lambda rng: {"w": jnp.asarray(W)},
              lambda p, x: x * (1.0 / (1.0 + jnp.exp(-(x @ p["w"])))),
              out_specs=(JSpec((1, ROWS, CHANNELS), "float32"),))


def _client_desc(codec, i):
    opt = TRANSFORMS[codec].format(m=1 + i / 8)
    return (f"testsrc width={ROWS} height=1 channels={CHANNELS} ! "
            f"tensor_converter ! tensor_transform mode=arithmetic "
            f"option={opt} ! tensor_query_client operation=op "
            f"codec={codec} name=qc ! appsink name=res")


_SERVER = ("tensor_query_serversrc operation=op name=ssrc ! "
           "tensor_filter model=twp_gate ! "
           "tensor_query_serversink name=ssink")


def _port(codecs, ticks=TICKS, **kw):
    """-> (runtime, server run, client runs, [(wire bytes, request)])"""
    rt = Runtime(device="cpu", **kw)
    hub = Device("hub", device="cpu")
    ps = parse_launch(_SERVER)
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    srv = hub.add_pipeline(ps)
    rt.add_device(hub)
    seen = _spy(ps.elements["ssrc"].endpoint)
    runs = []
    for i, codec in enumerate(codecs):
        dev = Device(f"tv{i}", device="cpu")
        runs.append(dev.add_pipeline(parse_launch(_client_desc(codec, i))))
        rt.add_device(dev)
    rt.run(ticks)
    return rt, srv, runs, seen


def _jax(codecs, ticks=TICKS, **kw):
    rt = JRuntime(**kw)
    hub = JDevice("hub")
    ps = jparse(_SERVER)
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    hub.add_pipeline(ps)
    rt.add_device(hub)
    seen = _spy(ps.elements["ssrc"].endpoint)
    runs = []
    for i, codec in enumerate(codecs):
        dev = JDevice(f"tv{i}")
        runs.append(dev.add_pipeline(jparse(_client_desc(codec, i))))
        rt.add_device(dev)
    rt.run(ticks)
    return rt, runs, seen


def _spy(endpoint):
    """Record every request buffer pushed onto the server's channel."""
    seen = []
    push = endpoint.requests.push

    def spy(buf, nbytes=None):
        seen.append((nbytes, buf))
        return push(buf, nbytes)
    endpoint.requests.push = spy
    return seen


def _answers(runs):
    return [[b.tensor for b in r.sink_log["res"]] for r in runs]


def _fields(payload):
    if isinstance(payload, Quant8Payload) or \
            type(payload).__name__ == "Quant8Payload":
        return [payload.q, payload.scale]
    if isinstance(payload, SparsePayload) or \
            type(payload).__name__ == "SparsePayload":
        return [payload.values, payload.indices, payload.nnz]
    return [payload]


# ---------------------------------------------------------------------------
# the port against itself: fused == eager == every batch size, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("batch", [1, 4, 8])
def test_fused_matches_eager_and_batch_one_bitwise(codec, batch):
    streams, stats = {}, {}
    for label, kw in (("fused", dict(query_batch=batch)),
                      ("eager", dict(query_batch=batch, fused_wire=False)),
                      ("batch 1", dict(query_batch=1))):
        comp.reset_codec_stats()
        rt, srv, runs, _ = _port([codec] * CLIENTS, **kw)
        streams[label] = _answers(runs)
        stats[label] = comp.codec_stats()
        qb = rt.stats()["query_batching"]
        assert qb["fused_frames"] == (0 if label == "eager"
                                      else TICKS * CLIENTS), (label, qb)
        assert srv.frames == TICKS * CLIENTS
    assert stats["fused"] == stats["eager"] == stats["batch 1"]
    for label in ("eager", "batch 1"):
        for ref_, got in zip(streams["fused"], streams[label]):
            assert len(ref_) == len(got) == TICKS
            for a, b in zip(ref_, got):
                assert a.dtype == b.dtype and torch.equal(a, b), label


def test_fused_batches_launch_one_codec_call_per_group(monkeypatch):
    """A tick of 4 same-codec clients encodes its requests in ONE stacked
    call and the server re-encodes its answers in one more."""
    calls = {"single": 0, "stacked": 0}
    real_single, real_stacked = ops.quantize8, ops.quantize8_stacked

    def single(*a, **k):
        calls["single"] += 1
        return real_single(*a, **k)

    def stacked(*a, **k):
        calls["stacked"] += 1
        return real_stacked(*a, **k)
    monkeypatch.setattr(ops, "quantize8", single)
    monkeypatch.setattr(ops, "quantize8_stacked", stacked)
    rt, _, _, _ = _port(["quant8"] * CLIENTS, ticks=1, query_batch=8)
    assert calls == {"single": 0, "stacked": 2}
    qb = rt.stats()["query_batching"]
    assert qb["fused_batches"] == 1 and qb["fused_frames"] == CLIENTS


# ---------------------------------------------------------------------------
# the port against the JAX package's runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
def test_requests_on_the_channel_match_the_jax_runtime(codec):
    _, _, _, seen = _port([codec] * CLIENTS)
    _, _, jseen = _jax([codec] * CLIENTS)
    assert len(seen) == len(jseen) == TICKS * CLIENTS
    for (n, buf), (jn, jbuf) in zip(seen, jseen):
        assert n == jn == comp.wire_nbytes(buf)
        assert buf.meta["codec"] == jbuf.meta["codec"] == codec
        assert {k: v for k, v in buf.meta.items() if k != "client_id"} == \
            {k: v for k, v in jbuf.meta.items() if k != "client_id"}
        for p, jp in zip(buf.tensors, jbuf.tensors):
            for a, b in zip(_fields(p), _fields(jp)):
                a, b = a.numpy(), np.asarray(b)
                assert a.shape == b.shape and a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _quant_step_excess(a, b):
    """Largest |a - b| beyond one quant step of its (32, 128) tile."""
    a2, b2 = ops._pad_tiles(ops._as2d(a)), ops._pad_tiles(ops._as2d(b))
    ta, tb = ref._tiles(a2), ref._tiles(b2)
    step = torch.maximum(ta.abs().amax(dim=(2, 3)),
                         tb.abs().amax(dim=(2, 3))) / 127
    return ((ta - tb).abs() - step[:, :, None, None] * (1 + 1e-5)).max()


@pytest.mark.parametrize("codec", CODECS)
def test_answers_match_the_jax_runtime(codec):
    comp.reset_codec_stats()
    jcomp.reset_codec_stats()
    _, _, runs, _ = _port([codec] * CLIENTS)
    _, jruns, _ = _jax([codec] * CLIENTS)
    assert comp.codec_stats() == jcomp.codec_stats()
    for got, want in zip(_answers(runs), _answers(jruns)):
        assert len(got) == len(want) == TICKS
        for a, b in zip(got, want):
            b = torch.as_tensor(np.array(b))
            assert a.shape == b.shape and a.dtype == b.dtype
            if codec == "quant8":
                assert _quant_step_excess(a, b) <= 0
            else:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
                assert torch.equal(a == 0, b == 0)     # zeros kept


# ---------------------------------------------------------------------------
# meta, grouping and serving modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
def test_decoded_answers_never_claim_a_codec(codec):
    _, _, runs, seen = _port([codec] * CLIENTS, query_batch=4)
    for r in runs:
        for buf in r.sink_log["res"]:
            assert "codec" not in buf.meta
            assert "sparse_dropped" not in buf.meta
    # ... while the requests in flight do claim theirs, parameter and all
    kind = Quant8Payload if codec == "quant8" else SparsePayload
    for _, buf in seen:
        assert buf.meta["codec"] == codec
        assert all(isinstance(t, kind) for t in buf.tensors)


def test_wire_payloads_stay_on_the_frames_device():
    _, _, _, seen = _port(["quant8"] * 2, ticks=1)
    for _, buf in seen:
        leaves, _ = tree_flatten(buf.tensors)
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in leaves)


def test_mixed_codecs_group_by_codec():
    """Two codec=none and two quant8 clients at batch 8: each tick splits
    into one group per codec, only the quant8 group fuses, and every client
    matches its batch-1 stream bitwise."""
    codecs = ["none", "none", "quant8", "quant8"]
    rt, _, runs, _ = _port(codecs, query_batch=8)
    qb = rt.stats()["query_batching"]
    assert qb["batches"] == 2 * TICKS
    assert qb["fused_frames"] == 2 * TICKS
    _, _, one, _ = _port(codecs, query_batch=1)
    for got, want in zip(_answers(runs), _answers(one)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_eager_wire_path_batches_mixed_codecs_together():
    codecs = ["none", "none", "quant8", "quant8"]
    rt, _, runs, _ = _port(codecs, query_batch=8, fused_wire=False)
    qb = rt.stats()["query_batching"]
    assert qb["batches"] == TICKS and qb["fused_frames"] == 0
    _, _, fused, _ = _port(codecs, query_batch=8)
    for got, want in zip(_answers(runs), _answers(fused)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_non_batchable_server_plan_serves_sequentially():
    rt = Runtime(device="cpu", query_batch=8)
    hub = Device("hub", device="cpu")
    ps = parse_launch(_SERVER)
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    srv = hub.add_pipeline(ps)
    rt.add_device(hub)
    srv.pipe.plan.query_batchable = False
    runs = []
    for i in range(CLIENTS):
        dev = Device(f"tv{i}", device="cpu")
        runs.append(dev.add_pipeline(parse_launch(_client_desc("quant8",
                                                               i))))
        rt.add_device(dev)
    rt.run(TICKS)
    qb = rt.stats()["query_batching"]
    assert qb["sequential_frames"] == TICKS * CLIENTS
    assert qb["batched_frames"] == 0 and qb["fused_frames"] == 0
    _, _, fused, _ = _port(["quant8"] * CLIENTS)
    for got, want in zip(_answers(runs), _answers(fused)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
