"""The M1 elements of the port against the JAX package on the CPU, on the
same numpy-seeded inputs: videoscale, compositor, tensor_decoder (three
modes), tensor_mux, tensor_demux, tee, queue, queue2 and tensor_if (five
operators), each alone and inside whole pipelines (``test_plan.py``'s
parity graphs, Listing 1 included).

Tolerances: every element is bitwise equal to the JAX package except
videoscale.  Its float32 resize (antialiased bilinear on downscale in both
packages) sums its taps in a different order: |Δ| ≤ 1e-5 · max(|y|, 1).
The uint8 result truncates that float, so a value within 1e-5 of an
integer can land one lower: |Δ| ≤ 1 on at most 1% of the values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import StreamBuffer as JBuf
from repro.core import TensorSpec as JSpec
from repro.core import element_factory as jfactory
from repro.core import parse_launch as jparse
from repro.core.elements import register_model as jregister
from repro_torch.core import (StreamBuffer, TensorSpec, element_factory,
                              parse_launch)
from repro_torch.core.elements import register_model

torch.set_num_threads(2)

VS_RTOL = 1e-5          # videoscale float32: |Δ| ≤ VS_RTOL · max(|y|, 1)
VS_U8_SHARE = 0.01      # videoscale uint8: |Δ| ≤ 1 on at most this share

W_CLS = (0.1 * np.random.default_rng(7).standard_normal((3, 10))).astype(
    np.float32)
BOXES = np.array([[0.1, 0.1, 0.5, 0.6], [0.2, 0.3, 0.4, 0.5]], np.float32)
SCORES = np.array([0.9, 0.1], np.float32)


@pytest.fixture(scope="module", autouse=True)
def models():
    register_model("te_cls", lambda g, dev: {"w": torch.as_tensor(
        W_CLS, device=dev)}, lambda p, x: x.reshape(-1, 3).mean(0) @ p["w"],
        out_specs=(TensorSpec((10,), "float32"),))
    jregister("te_cls", lambda rng: {"w": jnp.asarray(W_CLS)},
              lambda p, x: jnp.mean(x.reshape(-1, 3), 0) @ p["w"],
              out_specs=(JSpec((10,), "float32"),))
    register_model("te_det", None, lambda p, x: (
        torch.as_tensor(BOXES), torch.as_tensor(SCORES)),
        out_specs=(TensorSpec((2, 4), "float32"),
                   TensorSpec((2,), "float32")))
    jregister("te_det", lambda rng: {}, lambda p, x: (
        jnp.asarray(BOXES), jnp.asarray(SCORES)),
        out_specs=(JSpec((2, 4), "float32"), JSpec((2,), "float32")))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_buf_equal(buf, jbuf, label=""):
    assert int(buf.pts) == int(jbuf.pts), label
    assert buf.meta == jbuf.meta, label
    assert len(buf.tensors) == len(jbuf.tensors), label
    for x, y in zip(buf.tensors, jbuf.tensors):
        x, y = _np(x), _np(y)
        assert x.shape == y.shape and x.dtype == y.dtype, label
        np.testing.assert_array_equal(x, y, err_msg=label)


def _pair(factory, **props):
    """The same element from both packages, with its input caps left
    free (``apply`` alone)."""
    return element_factory(factory, **props), jfactory(factory, **props)


def _bufs(arrays, pts=0, meta=None):
    return (StreamBuffer(tensors=tuple(torch.as_tensor(a) for a in arrays),
                         pts=pts, meta=dict(meta or {})),
            JBuf(tensors=tuple(jnp.asarray(a) for a in arrays),
                 pts=jnp.int32(pts), meta=dict(meta or {})))




# ---------------------------------------------------------------------------
# videoscale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((48, 64), (16, 16)), ((12, 12), (6, 6)),
                                     ((16, 16), (24, 40)), ((24, 32), (10, 7)),
                                     ((100, 60), (33, 90))])
def test_videoscale_matches_jax_image_resize(src, dst):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    ours, theirs = _pair("videoscale", width=dst[1], height=dst[0])
    # float32, before the cast back
    f = ours.apply({}, [StreamBuffer(tensors=(torch.as_tensor(x).float(),))])
    jf = theirs.apply({}, [JBuf(tensors=(jnp.asarray(x, jnp.float32),))])
    a, b = _np(f[0].tensor), _np(jf[0].tensor)
    assert a.shape == b.shape == dst + (3,) and a.dtype == b.dtype
    assert (np.abs(a - b) <= VS_RTOL * np.maximum(np.abs(b), 1)).all()
    # uint8
    buf, jbuf = _bufs([x], pts=5)
    out, jout = ours.apply({}, [buf])[0], theirs.apply({}, [jbuf])[0]
    a, b = _np(out.tensor), _np(jout.tensor)
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= VS_U8_SHARE
    assert int(out.pts) == 5


def test_videoscale_without_a_target_passes_through():
    ours, _ = _pair("videoscale")
    buf, _ = _bufs([np.zeros((4, 4, 3), np.uint8)])
    assert ours.apply({}, [buf])[0] is buf


# ---------------------------------------------------------------------------
# compositor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pads", [
    {0: {"zorder": 2}, 1: {"zorder": 1}},
    {0: {"zorder": 1}, 1: {"zorder": 2, "xpos": 3}},
    {1: {"xpos": 5, "ypos": 4}},                 # clipped at the edge
    {1: {"xpos": 20}},                           # fully outside
    {0: {"zorder": 3}, 1: {"zorder": 1, "ypos": 2}, 2: {"zorder": 2,
                                                        "xpos": 1}},
])
def test_compositor_matches_jax(pads):
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
    bufs = [_bufs([f], pts=i) for i, f in enumerate(frames)]
    out = ours.apply({}, [b for b, _ in bufs])[0]
    jout = theirs.apply({}, [j for _, j in bufs])[0]
    assert_buf_equal(out, jout)


# ---------------------------------------------------------------------------
# tensor_decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["direct_video_f32", "direct_video_u8",
                                  "classification", "boxes", "boxes_clip",
                                  "boxes_tie"])
def test_tensor_decoder_matches_jax(case):
    rng = np.random.default_rng(0)
    if case.startswith("direct_video"):
        props = dict(mode="direct_video")
        x = (rng.integers(0, 256, (5, 7, 3)).astype(np.float32) + 0.75
             if case.endswith("f32") else
             rng.integers(0, 256, (5, 7, 3), dtype=np.uint8))
        arrays = [x]
    elif case == "classification":
        props = dict(mode="classification")
        arrays = [rng.standard_normal((4, 10)).astype(np.float32)]
    else:
        props = dict(mode="bounding_boxes", option4="20:12")
        boxes = rng.uniform(0, 1, (5, 4)).astype(np.float32)
        if case == "boxes_clip":
            boxes = boxes * 3 - 1
        scores = rng.uniform(0, 1, (5,)).astype(np.float32)
        if case == "boxes_tie":
            scores[:] = 0.5
        arrays = [boxes, scores]
    ours, theirs = _pair("tensor_decoder", **props)
    buf, jbuf = _bufs(arrays, pts=3, meta={"k": 1})
    assert_buf_equal(ours.apply({}, [buf])[0], theirs.apply({}, [jbuf])[0])


# ---------------------------------------------------------------------------
# mux, demux, tee, queue, queue2
# ---------------------------------------------------------------------------

def test_tensor_mux_takes_the_earliest_pts_and_merges_meta():
    rng = np.random.default_rng(0)
    ours, theirs = _pair("tensor_mux")
    a = rng.standard_normal((2, 3)).astype(np.float32)
    b = rng.integers(0, 9, (4,), dtype=np.int32)
    c = rng.standard_normal((1,)).astype(np.float32)
    ins = [_bufs([a], pts=40, meta={"x": 1, "y": 2}),
           _bufs([b, c], pts=-7, meta={"y": 3}),
           _bufs([c], pts=12, meta={"z": 4})]
    out = ours.apply({}, [p for p, _ in ins])[0]
    jout = theirs.apply({}, [j for _, j in ins])[0]
    assert_buf_equal(out, jout)
    assert int(out.pts) == -7 and out.meta == {"x": 1, "y": 3, "z": 4}


def test_tensor_demux_tee_and_queues_match_jax():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((3,)).astype(np.float32),
              rng.integers(0, 255, (2, 2), dtype=np.uint8)]
    buf, jbuf = _bufs(arrays, pts=9, meta={"m": 1})
    ours, theirs = _pair("tensor_demux")
    outs, jouts = ours.apply({}, [buf]), theirs.apply({}, [jbuf])
    assert len(outs) == len(jouts) == 2
    for o, j in zip(outs, jouts):
        assert_buf_equal(o, j)
    for factory in ("tee", "queue", "queue2"):
        ours, theirs = _pair(factory)
        outs, jouts = ours.apply({}, [buf]), theirs.apply({}, [jbuf])
        assert len(outs) == len(jouts) == 1
        assert outs[0] is buf                   # identity: no copy
        assert_buf_equal(outs[0], jouts[0])
    q, jq = _pair("queue", leaky=2, max_size_buffers=5)
    assert (q.leaky, q.max_size) == (jq.leaky, jq.max_size) == (2, 5)


# ---------------------------------------------------------------------------
# tensor_if
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("operator", ["GE", "GT", "LE", "LT", "EQ"])
@pytest.mark.parametrize("threshold", [0.25, 0.5, 0.75])
def test_tensor_if_matches_jax(operator, threshold):
    rng = np.random.default_rng(0)
    x = np.array([[0.1, 0.5], [0.2, 0.3]], np.float32)
    y = rng.integers(0, 9, (3,), dtype=np.int32)
    ours, theirs = _pair("tensor_if", operator=operator, threshold=threshold)
    buf, jbuf = _bufs([x, y], pts=2, meta={"a": 1})
    out, jout = ours.apply({}, [buf])[0], theirs.apply({}, [jbuf])[0]
    assert_buf_equal(out, jout)
    flag = out.tensors[-1]
    assert flag.dtype == torch.int32 and flag.dim() == 0
    assert "gate_open" in out.meta and "gate_open" not in buf.meta
    want = {"GE": 0.5 >= threshold, "GT": 0.5 > threshold,
            "LE": 0.5 <= threshold, "LT": 0.5 < threshold,
            "EQ": 0.5 == threshold}[operator]
    assert int(flag) == int(want)
    assert torch.equal(out.tensors[0], torch.as_tensor(x) * int(want))


# ---------------------------------------------------------------------------
# whole pipelines (test_plan.py's parity graphs), frame by frame
# ---------------------------------------------------------------------------

PIPELINES = {
    "listing1": """
        v4l2src name=cam ! tee name=ts
        ts. queue leaky=2 ! videoconvert ! mix.sink_1
        ts. videoconvert ! videoscale !
          video/x-raw,width=16,height=16,format=RGB !
          tensor_converter !
          tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 !
          tensor_filter model=te_det !
          tensor_decoder mode=bounding_boxes option4=64:48 ! queue ! mix.sink_0
        compositor name=mix sink_0::zorder=2 sink_1::zorder=1 ! videoconvert !
          appsink name=display""",
    "tee_compositor": """
        testsrc name=s width=12 height=12 ! tee name=t
        t. queue ! videoconvert ! cmp.sink_0
        t. videoconvert ! videoscale ! video/x-raw,width=6,height=6,format=RGB !
          videoconvert ! cmp.sink_1
        compositor name=cmp sink_0::zorder=1 sink_1::zorder=2 sink_1::xpos=3 !
          appsink name=out""",
    "mux_forward_ref": """
        testsrc ! tensor_converter ! mux.sink_0
        testsrc ! tensor_converter ! mux.sink_1
        tensor_mux name=mux ! appsink name=o""",
    "demux": """
        testsrc ! tensor_converter ! mux.sink_0
        testsrc ! tensor_converter ! mux.sink_1
        tensor_mux name=mux ! tensor_demux name=d
        d.src_0 ! appsink name=a
        d.src_1 ! appsink name=b""",
    "filter_cls": """
        testsrc width=8 height=8 ! tensor_converter !
        tensor_transform mode=arithmetic option=typecast:float32 !
        tensor_filter model=te_cls ! tensor_decoder mode=classification !
        appsink name=o""",
    "tensor_if": """
        testsrc width=4 height=4 ! tensor_converter !
        tensor_transform mode=arithmetic option=typecast:float32,div:255.0 !
        tensor_if threshold=0.9 operator=GE ! appsink name=o""",
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipelines_match_jax_frame_by_frame(name):
    pipe = parse_launch(PIPELINES[name]).realize()
    jpipe = jparse(PIPELINES[name]).realize()
    params = pipe.init(torch.Generator().manual_seed(0), "cpu")
    jparams = jpipe.init(jax.random.PRNGKey(0))
    st, jst = pipe.init_state("cpu"), jpipe.init_state()
    assert [c.describe() for e in pipe._order for c in e.out_caps] == \
        [c.describe() for e in jpipe._order for c in e.out_caps]
    for k in range(3):
        out, st = pipe.step(params, st)
        jout, jst = jpipe.step(jparams, jst)
        assert sorted(out) == sorted(jout)
        for sink in out:
            assert_buf_equal(out[sink], jout[sink], f"{name}[{k}].{sink}")
