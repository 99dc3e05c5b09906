"""The port's edge package (``repro_torch.edge``) against the JAX package's
(``repro.edge``), on the CPU.

Twins of ``tests/test_edge_wire.py`` and ``test_substrates.py::TestEdge``:

* ``pack_buffer`` bytes are bitwise ``repro.edge.pack_buffer``'s over all
  11 dtypes, 0-dim, empty and mixed tensors and the signed pts range, and
  each package unpacks the other's frames;
* every malformed frame (bad magic, unknown version or dtype tag, size
  mismatch, every truncation, trailing bytes, every payload bit, the
  trailer) raises the same error class with the same message in both;
* an ``EdgeSensor``'s numpy frames reach a port subscriber pipeline, which
  places them on its device; ``EdgeQueryClient.infer`` round-trips through
  a port server (with and without the delivery layer) and returns numpy;
  ``EdgeOutput.poll`` reads a port publisher's frames as numpy.

The ``cuda`` tests repeat the pipeline round trips on the card.
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import TensorSpec as JSpec
from repro.core import parse_launch as jparse
from repro.core.elements import register_model as jregister
from repro.edge import edge as jedge
from repro.runtime import Device as JDevice
from repro.runtime import Runtime as JRuntime
from repro_torch.core import TensorSpec, parse_launch
from repro_torch.core.elements import register_model
from repro_torch.core.netfault import DeliveryPolicy
from repro_torch.edge import (ChecksumError, EdgeOutput, EdgeQueryClient,
                              EdgeSensor, pack_buffer, unpack_buffer)
from repro_torch.edge import edge as pedge
from repro_torch.edge.edge import _DTYPES, _MAGIC
from repro_torch.runtime import Device, Runtime

torch.set_num_threads(2)


def _arr(dtype: str, shape=(3, 4)) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, dtype)))
    if dtype.startswith("float"):
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, size=shape,
                        dtype=np.dtype(dtype))


def _same_bytes_and_roundtrip(tensors, pts=0):
    wire = pack_buffer(tensors, pts)
    assert wire == jedge.pack_buffer(tensors, pts)
    for unpack in (unpack_buffer, jedge.unpack_buffer):
        got, got_pts = unpack(wire)
        assert got_pts == pts and len(got) == len(tensors)
        for a, b in zip(tensors, got):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _same_rejection(wire, checksum=False):
    """Both packages reject ``wire`` with the same error class and
    message (a ``ChecksumError`` when ``checksum``, else another
    ``ValueError``); returns the port's error."""
    with pytest.raises(ValueError) as port:
        unpack_buffer(wire)
    with pytest.raises(ValueError) as ref:
        jedge.unpack_buffer(wire)
    assert type(port.value).__name__ == type(ref.value).__name__
    assert str(port.value) == str(ref.value)
    assert isinstance(port.value, ChecksumError) == checksum
    assert isinstance(ref.value, jedge.ChecksumError) == checksum
    return port.value


class TestRoundTrip:
    def test_the_format_constants_are_the_reference_s(self):
        assert _DTYPES == jedge._DTYPES and _MAGIC == jedge._MAGIC
        assert len(_DTYPES) == 11

    @pytest.mark.parametrize("dtype", _DTYPES)
    def test_all_dtypes(self, dtype):
        _same_bytes_and_roundtrip([_arr(dtype)])

    @pytest.mark.parametrize("dtype", _DTYPES)
    def test_zero_dim(self, dtype):
        _same_bytes_and_roundtrip([_arr(dtype, shape=())])

    @pytest.mark.parametrize("shape", [(0,), (0, 3), (4, 0, 2)])
    def test_empty_tensors(self, shape):
        _same_bytes_and_roundtrip([np.zeros(shape, np.float32)])

    def test_multi_tensor_mixed_dtypes(self):
        _same_bytes_and_roundtrip([_arr("uint8", (5,)), _arr("float64", (2, 3)),
                                   _arr("int16", ()), _arr("float32", (0, 2))])

    @pytest.mark.parametrize("pts", [0, -1, -(2 ** 62), 2 ** 62])
    def test_pts_signed_range(self, pts):
        _same_bytes_and_roundtrip([_arr("int32", (2,))], pts=pts)

    def test_no_tensors(self):
        _same_bytes_and_roundtrip([])

    def test_memoryview_input_accepted(self):
        wire = pack_buffer([_arr("uint16", (4,))])
        got, _ = unpack_buffer(memoryview(wire))
        assert got[0].dtype == np.uint16

    @given(st.integers(1, 5), st.integers(1, 20),
           st.sampled_from(["uint8", "float32", "int32"]))
    @settings(max_examples=20, deadline=None)
    def test_wire_roundtrip(self, nt, n, dtype):
        tensors = [np.arange(n * (i + 1), dtype=dtype).reshape(-1)
                   for i in range(nt)]
        _same_bytes_and_roundtrip(tensors, pts=123)


class TestRejection:
    def test_bad_magic(self):
        wire = bytearray(pack_buffer([_arr("uint8")]))
        wire[:4] = b"XXSE"
        assert "magic" in str(_same_rejection(bytes(wire)))

    def test_unknown_version(self):
        wire = bytearray(pack_buffer([_arr("uint8")]))
        struct.pack_into("<H", wire, 4, 99)
        assert "version 99" in str(_same_rejection(bytes(wire)))

    def test_unknown_dtype_tag(self):
        wire = bytearray(pack_buffer([_arr("uint8", (2,))]))
        struct.pack_into("<H", wire, 16, len(_DTYPES))
        assert "dtype tag" in str(_same_rejection(bytes(wire)))

    def test_payload_size_mismatch(self):
        wire = bytearray(pack_buffer([_arr("float32", (2, 2))]))
        struct.pack_into("<Q", wire, 16 + 12, 15)
        assert "payload size" in str(_same_rejection(bytes(wire)))

    def test_every_truncation_rejected(self):
        wire = pack_buffer([_arr("uint8", (3,)), _arr("float64", (2, 2))],
                           pts=-7)
        for cut in range(len(wire)):
            _same_rejection(wire[:cut])

    def test_trailing_garbage_rejected(self):
        wire = pack_buffer([_arr("int32", (2, 2))])
        assert "trailing" in str(_same_rejection(wire + b"\x00"))


class TestChecksum:
    def test_payload_bit_flip_rejected(self):
        wire = bytearray(pack_buffer([_arr("float32", (4, 4))]))
        wire[40] ^= 0x10
        err = _same_rejection(bytes(wire), checksum=True)
        assert "checksum mismatch" in str(err)

    def test_every_payload_bit_position_rejected(self):
        body = pack_buffer([_arr("uint8", (8,))])
        payload_start = 16 + 2 + 2 + 4 + 8
        for pos in range(payload_start, payload_start + 8):
            for bit in range(8):
                wire = bytearray(body)
                wire[pos] ^= 1 << bit
                _same_rejection(bytes(wire), checksum=True)

    def test_trailer_corruption_rejected(self):
        wire = bytearray(pack_buffer([_arr("int32", (2,))]))
        wire[-1] ^= 0x80
        _same_rejection(bytes(wire), checksum=True)

    def test_checksum_error_is_value_error(self):
        assert issubclass(ChecksumError, ValueError)

    def test_structural_damage_keeps_specific_error(self):
        wire = bytearray(pack_buffer([_arr("uint8", (2,))]))
        struct.pack_into("<H", wire, 16, len(_DTYPES))
        err = _same_rejection(bytes(wire))
        assert "dtype tag" in str(err)

    def test_v1_frame_without_trailer_accepted(self):
        arr = _arr("int16", (3,))
        wire = bytearray(pack_buffer([arr])[:-4])
        struct.pack_into("<H", wire, 4, 1)
        for unpack in (unpack_buffer, jedge.unpack_buffer):
            got, _ = unpack(bytes(wire))
            np.testing.assert_array_equal(got[0], arr)

    def test_empty_frame_has_valid_trailer(self):
        got, pts = unpack_buffer(pack_buffer([], pts=5))
        assert got == [] and pts == 5
        wire = bytearray(pack_buffer([], pts=5))
        wire[8] ^= 0x01
        _same_rejection(bytes(wire), checksum=True)


# -- the edge clients against the port's pipelines ----------------------------

@pytest.fixture(scope="module", autouse=True)
def models():
    register_model("edge_twin", lambda g, dev: {},
                   lambda p, x: torch.sum(x).reshape(1),
                   out_specs=(TensorSpec((1,), "float32"),))
    jregister("edge_twin", lambda r: {},
              lambda p, x: jnp.sum(x).reshape(1),
              out_specs=(JSpec((1,), "float32"),))


def _sensor_run(edge, runtime, device, parse, frames=3, **rt_kw):
    rt = runtime(**rt_kw)
    sensor = edge.EdgeSensor(rt.broker, "sensor/imu")
    sub = device("hub")
    p = parse("mqttsrc sub-topic=sensor/# ! appsink name=o")
    sub.add_pipeline(p, jit=False)
    rt.add_device(sub)
    for i in range(frames):
        sensor.publish([np.full((6,), i, np.float32)], pts=i * 1000)
        rt.tick()
    return sub.runs[0]


def _query_server(runtime, device, parse, **rt_kw):
    rt = runtime(**rt_kw)
    dev = device("hub")
    ps = parse("tensor_query_serversrc operation=sum name=ssrc ! "
               "tensor_filter model=edge_twin ! "
               "tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    dev.add_pipeline(ps, jit=False)
    rt.add_device(dev)
    return rt


def _port(device="cpu"):
    return (lambda **kw: Runtime(device=device, **kw),
            lambda name: Device(name, device=device), parse_launch)


JAX = (JRuntime, JDevice, jparse)


class TestEdge:
    def test_edge_sensor_to_pipeline(self):
        """A numpy-only sensor publishes; a port subscriber pipeline takes
        the frames as torch tensors on its device, equal to the JAX
        package's frame for frame."""
        run = _sensor_run(pedge, *_port())
        ref = _sensor_run(jedge, *JAX)
        assert run.frames >= 2 and run.frames == ref.frames
        got, want = run.sink_log["o"], ref.sink_log["o"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            t = g.tensors[0]
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), np.asarray(w.tensors[0]))
            assert int(g.pts) == int(w.pts)

    @pytest.mark.parametrize("delivery", [False, True])
    def test_edge_query_client(self, delivery):
        kw = {"delivery": DeliveryPolicy()} if delivery else {}
        rt = _query_server(*_port(), **kw)
        client = EdgeQueryClient(rt.broker, "sum")
        out = client.infer([np.ones((4,), np.float32)])
        assert isinstance(out[0], np.ndarray) and float(out[0][0]) == 4.0
        x = np.arange(5, dtype=np.float32)
        jrt = _query_server(*JAX)
        want = jedge.EdgeQueryClient(jrt.broker, "sum").infer([x])
        got = client.infer([x])
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        if delivery:
            # an edge client stamps nothing: its frames pass the guard
            assert rt.stats()["delivery"]["accepted"] == 2

    def test_edge_output_polls_a_port_publisher(self):
        rt = Runtime(device="cpu")
        dev = Device("cam", device="cpu")
        dev.add_pipeline(parse_launch(
            "testsrc width=2 height=2 ! tensor_converter ! "
            "mqttsink pub-topic=cam/0"), jit=False)
        rt.add_device(dev)
        out = EdgeOutput(rt.broker, "cam/#")
        rt.run(2)
        frames = [out.poll(), out.poll()]
        assert out.poll() is None
        for tensors, pts in frames:
            assert isinstance(tensors[0], np.ndarray)
            assert tensors[0].shape == (2, 2, 3) and isinstance(pts, int)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    yield torch.device("cuda")


@pytest.mark.cuda
def test_edge_frames_reach_pipelines_on_the_card(card):
    run = _sensor_run(pedge, *_port("cuda"))
    assert run.frames >= 2
    for b in run.sink_log["o"]:
        assert b.tensors[0].device.type == "cuda"
    rt = _query_server(*_port("cuda"), delivery=DeliveryPolicy())
    out = EdgeQueryClient(rt.broker, "sum").infer(
        [np.arange(5, dtype=np.float32)])
    assert isinstance(out[0], np.ndarray) and float(out[0][0]) == 10.0
