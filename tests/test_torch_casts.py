"""Float -> integer casts and compositor offsets of the port, against the
JAX package on the CPU, bitwise.

* ``core.formats.saturating_cast`` gives XLA's conversion: truncation
  toward zero, saturation at the target's min and max, NaN -> 0 (torch's
  own ``to`` wraps), including at 2**31 - 1, which float32 cannot hold.
* It reaches pipeline output through every float -> integer cast of the
  elements: ``tensor_transform`` typecast, ``tensor_decoder
  mode=direct_video``, the cast back in ``compositor`` and in
  ``videoscale``, and the quant8 codec's decode to an integer dtype.
* ``compositor`` starts each frame where ``jax.lax.dynamic_update_slice``
  starts it in the JAX package (jax 0.9): a negative ``xpos``/``ypos``
  counts from the canvas's far edge, and the start is clamped so that the
  frame lies inside the canvas (``xpos=-2`` puts a 6-wide frame at
  column 4 of a 10-wide canvas, ``xpos=-50`` at column 0).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import StreamBuffer as JBuf
from repro.core import compression as jcomp
from repro.core import element_factory as jfactory
from repro.core import parse_launch as jparse
from repro.runtime import Device as JDevice
from repro.runtime import Runtime as JRuntime
from repro_torch.core import StreamBuffer, element_factory, parse_launch
from repro_torch.core import compression as comp
from repro_torch.core.formats import TORCH_DTYPES, saturating_cast
from repro_torch.runtime import Device, Runtime

torch.set_num_threads(2)

VALUES = [-300.7, 256.0, 1e10, float("nan"), -1e10, float("inf"),
          float("-inf"), 2147483520.0, 2147483648.0, -2147483648.0,
          -2147483904.0, 127.5, -128.9, 0.999, -0.999, 65535.9, -32768.5,
          255.0, 254.99, 0.0, -0.0]


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("src", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dst", ["uint8", "int8", "int16", "uint16",
                                 "int32"])
def test_saturating_cast_matches_xla(src, dst):
    npsrc = ml_dtypes.bfloat16 if src == "bfloat16" else np.dtype(src)
    with np.errstate(over="ignore", invalid="ignore"):
        x = np.array(VALUES, np.float64).astype(npsrc)
    got = _np(saturating_cast(_torch(x), TORCH_DTYPES[dst]))
    want = np.asarray(jnp.asarray(x).astype(jnp.dtype(dst)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_out_of_range_values_saturate():
    x = torch.tensor([-300.7, 256.0, 1e10, float("nan")])
    assert saturating_cast(x, torch.uint8).tolist() == [0, 255, 255, 0]
    assert saturating_cast(x, torch.int32).tolist() == [
        -300, 256, 2147483647, 0]
    # other casts are plain ``to``
    assert saturating_cast(x[:2], torch.float64).tolist() == [
        float(np.float32(-300.7)), 256.0]
    ints = torch.tensor([300, -5], dtype=torch.int32)
    assert saturating_cast(ints, torch.uint8).tolist() == [44, 251]


def test_saturating_cast_to_64_bits():
    """int64 limits are not float64 values either: the 64-bit route masks
    after the cast (the JAX package, without x64, has no int64 to hold it
    against)."""
    x = torch.tensor([-1e30, 1e30, float("nan"), 3.7, -3.7, 2.0 ** 63,
                      -(2.0 ** 63), float("inf")], dtype=torch.float64)
    info = torch.iinfo(torch.int64)
    assert saturating_cast(x, torch.int64).tolist() == [
        info.min, info.max, 0, 3, -3, info.max, info.min, info.max]
    assert saturating_cast(x.float(), torch.int64).tolist() == [
        info.min, info.max, 0, 3, -3, info.max, info.min, info.max]


PIPE = ("testsrc width=4 height=2 ! tensor_converter ! tensor_transform "
        "mode=arithmetic option=typecast:float32,mul:{mul},add:{add},"
        "typecast:{dst} ! {tail}appsink name=out")


def _run(pkg, desc, ticks=2):
    if pkg == "port":
        rt, dev = Runtime(device="cpu"), Device("d", device="cpu")
        run = dev.add_pipeline(parse_launch(desc))
    else:
        rt, dev = JRuntime(), JDevice("d")
        run = dev.add_pipeline(jparse(desc))
    rt.add_device(dev)
    rt.run(ticks)
    return [_np(b.tensors[0]) for b in run.sink_log["out"]]


@pytest.mark.parametrize("mul,add,dst,tail", [
    (2.0, -100, "uint8", ""),                   # the fault's pipeline
    (4.0, -200, "int8", ""),
    (67108864, -1073741824, "int32", ""),       # exact in float32
    (-3.0, 400, "uint8", ""),
    (2.0, -100, "float32", "tensor_decoder mode=direct_video ! "),
])
def test_typecast_pipelines_match_jax_bitwise(mul, add, dst, tail):
    desc = PIPE.format(mul=mul, add=add, dst=dst, tail=tail)
    ours, theirs = _run("port", desc), _run("jax", desc)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the inputs do leave the target's range, so the cast saturates
    if dst != "float32":
        info = np.iinfo(dst)
        flat = np.concatenate([a.ravel() for a in ours])
        assert ((flat == info.min) | (flat == info.max)).any()


def _pair(factory, **props):
    return element_factory(factory, **props), jfactory(factory, **props)


def _bufs(arrays):
    return (StreamBuffer(tensors=tuple(torch.as_tensor(a) for a in arrays)),
            JBuf(tensors=tuple(jnp.asarray(a) for a in arrays)))


def _same(buf, jbuf):
    for x, y in zip(buf.tensors, jbuf.tensors):
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_direct_video_saturates_like_jax():
    x = np.array(VALUES[:7] + [3.7, 12.2], np.float32).reshape(3, 3, 1)
    ours, theirs = _pair("tensor_decoder", mode="direct_video")
    buf, jbuf = _bufs([x])
    out = ours.apply({}, [buf])[0]
    _same(out, theirs.apply({}, [jbuf])[0])
    assert _np(out.tensors[0]).ravel().tolist() == [0, 255, 255, 0, 0, 255,
                                                    0, 3, 12]


def test_compositor_cast_back_saturates_like_jax():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
    over = rng.uniform(-400, 700, (4, 5, 3)).astype(np.float32)
    ours, theirs = _pair("compositor")
    for el in (ours, theirs):
        el.set_pad_prop(1, "xpos", 2)
        el.set_pad_prop(1, "ypos", 1)
    buf, jbuf = zip(*(_bufs([a]) for a in (base, over)))
    _same(ours.apply({}, list(buf))[0], theirs.apply({}, list(jbuf))[0])


@pytest.mark.parametrize("value", [2147483647, -2147483648])
def test_videoscale_cast_back_saturates_like_jax(value):
    x = np.full((8, 8, 1), value, np.int32)
    ours, theirs = _pair("videoscale", width=4, height=4)
    buf, jbuf = _bufs([x])
    out = ours.apply({}, [buf])[0]
    _same(out, theirs.apply({}, [jbuf])[0])
    assert (_np(out.tensors[0]) == value).all()


def test_quant8_decode_to_integers_saturates_like_jax():
    # int32 values at the ends of the range dequantize to about +-2**31
    x = np.array([[2147483647, -2147483648, 1000, -7] * 32] * 32, np.int32)
    enc, _ = comp.encode(StreamBuffer(tensors=(torch.as_tensor(x),)),
                         "quant8")
    jenc, _ = jcomp.encode(JBuf(tensors=(jnp.asarray(x),)), "quant8")
    got = _np(comp.decode(enc, "quant8").tensors[0])
    want = np.asarray(jcomp.decode(jenc, "quant8").tensors[0])
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.max() == 2147483647


@pytest.mark.parametrize("pads", [
    {1: {"xpos": -2}},
    {1: {"ypos": -1}},
    {1: {"xpos": -2, "ypos": -1}},
    {1: {"xpos": -50, "ypos": 3}},               # far left, clipped below
    {0: {"zorder": 2}, 1: {"zorder": 1, "xpos": -3, "ypos": -2},
     2: {"xpos": 8, "ypos": -4}},
    {1: {"xpos": 5, "ypos": 4}},                 # positive: unchanged
    {1: {"xpos": 20}},                           # off the canvas
])
def test_compositor_negative_offsets_clamp_like_jax(pads):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (8, 10, 4), dtype=np.uint8),
              rng.integers(0, 256, (6, 6, 3), dtype=np.uint8),
              rng.integers(0, 256, (3, 4, 4), dtype=np.uint8)]
    frames = frames[:max(2, max(pads) + 1)]
    ours, theirs = _pair("compositor")
    for el in (ours, theirs):
        for pad, props in pads.items():
            for k, v in props.items():
                el.set_pad_prop(pad, k, v)
    buf, jbuf = zip(*(_bufs([f]) for f in frames))
    _same(ours.apply({}, list(buf))[0], theirs.apply({}, list(jbuf))[0])
