"""Stock pipeline elements — port of ``src/repro/core/elements.py``: the
NNStreamer/GStreamer element set of the paper's examples (Listings 1 and
2): sources and sinks, converters, transforms, NN filters, decoders,
mux/demux, tee, queue, compositor, tensor_if and sparse enc/dec.

No element writes into a tensor it received: a publisher's channel hands
one frame object to every subscriber (``core/pubsub.py``), so an in-place
op would reach another subscriber's frame.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .buffers import SparsePayload, StreamBuffer
from .element import Element, PipelineContext, register_element
from .formats import (TORCH_DTYPES, Caps, TensorFormat, TensorSpec,
                      saturating_cast)


@register_element("appsrc")
class AppSrc(Element):
    """Application-fed source: the step receives its frame from the caller
    (``inputs`` dict, keyed by element name)."""

    n_sink_pads = 0

    def __init__(self, name=None, caps: Optional[Caps] = None, **props):
        super().__init__(name=name, **props)
        self.declared_caps = caps or Caps.ANY

    def negotiate(self, in_caps):
        return [self.declared_caps]

    def apply(self, params, inputs, ctx=None):
        return list(inputs)


@register_element("testsrc")
class TestSrc(Element):
    """videotestsrc analogue: deterministic synthetic uint8 frames from the
    frame counter kept in state, an int32 0-dim tensor on the device as in
    the JAX package (so a cached executable advances it on the device);
    pts is an int64 0-dim tensor, ~60 Hz in microseconds."""

    n_sink_pads = 0

    def __init__(self, name=None, width=64, height=48, channels=3, **props):
        super().__init__(name=name, **props)
        self.shape = (int(height), int(width), int(channels))

    def negotiate(self, in_caps):
        return [Caps(media="video/x-raw",
                     tensors=(TensorSpec(self.shape, "uint8"),))]

    def init_state(self, device):
        return {"frame": torch.zeros((), dtype=torch.int32, device=device)}

    def apply(self, params, inputs, ctx: PipelineContext = None):
        i = ctx.get_state(self.name)["frame"]
        dev = i.device
        h, w, c = self.shape
        yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None, None]
        xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :, None]
        cc = torch.arange(c, dtype=torch.int32, device=dev)[None, None, :]
        frame = ((yy * 3 + xx * 5 + cc * 17 + i * 7) % 256).to(torch.uint8)
        ctx.set_state(self.name, {"frame": i + 1})
        return [StreamBuffer(tensors=(frame,),
                             pts=i.to(torch.int64) * (16_666_667 // 1000))]


@register_element("appsink")
class AppSink(Element):
    """Terminal sink: the step returns its input buffer keyed by name."""

    n_src_pads = 0

    def apply(self, params, inputs, ctx=None):
        return list(inputs)


@register_element("fakesink")
class FakeSink(AppSink):
    pass


@register_element("capsfilter")
class CapsFilter(Element):
    """Caps assertion element (``video/x-raw,width=300,...`` tokens)."""

    def __init__(self, name=None, caps: Caps = None, **props):
        super().__init__(name=name, **props)
        self.filter_caps = caps or Caps.ANY

    def negotiate(self, in_caps):
        return [in_caps[0].intersect(self.filter_caps)]

    def apply(self, params, inputs, ctx=None):
        return list(inputs)


@register_element("videoconvert")
class VideoConvert(Element):
    def apply(self, params, inputs, ctx=None):
        return list(inputs)


@register_element("videoscale")
class VideoScale(Element):
    """Resizes to ``width``/``height`` (or the target of a downstream
    capsfilter, folded in by ``Pipeline.realize``); without a target it is
    pass-through.  Bilinear with antialiasing on downscale, as the JAX
    package's ``jax.image.resize(..., "bilinear")``, then cast back."""

    def __init__(self, name=None, width=None, height=None, **props):
        super().__init__(name=name, **props)
        self.target = (int(height), int(width)) if width and height else None

    def negotiate(self, in_caps):
        if self.target is None:
            return [in_caps[0]]
        src = in_caps[0].tensors[0]
        h, w = self.target
        c = src.shape[-1] if len(src.shape) == 3 else 1
        return [Caps(media="video/x-raw", tensors=(TensorSpec((h, w, c), src.dtype),))]

    def apply(self, params, inputs, ctx=None):
        if self.target is None:
            return list(inputs)
        buf = inputs[0]
        x = buf.tensor
        nchw = x.to(torch.float32).permute(2, 0, 1)[None]
        y = F.interpolate(nchw, size=self.target, mode="bilinear",
                          antialias=True, align_corners=False)
        y = saturating_cast(y[0].permute(1, 2, 0), x.dtype).contiguous()
        return [buf.with_(tensors=(y,))]


def _update_start(start: int, size: int, n: int) -> int:
    """Where ``jax.lax.dynamic_update_slice`` writes ``n`` elements into an
    axis of ``size`` when asked to start at ``start``."""
    if start < 0:
        start += size
    return min(max(start, 0), size - n)


@register_element("compositor")
class Compositor(Element):
    """Overlay N video frames by zorder, each at its pad's xpos/ypos
    (``mix.sink_0::xpos=...`` in Listing 2) and clipped to the first
    frame's canvas.  Each write starts where ``jax.lax.dynamic_update_slice``
    starts it in the JAX package: a negative offset counts from the
    canvas's far edge (``allow_negative_indices``), and the start is then
    clamped so that the frame lies inside the canvas."""

    n_sink_pads = None  # request pads

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.pad_props = {}

    def set_pad_prop(self, pad: int, key: str, val):
        self.pad_props.setdefault(pad, {})[key] = int(val)

    def negotiate(self, in_caps):
        return [in_caps[0]]

    def apply(self, params, inputs, ctx=None):
        base = inputs[0].tensor
        h, w = base.shape[0], base.shape[1]
        order = sorted(range(len(inputs)), key=lambda i: self.pad_props.get(
            i, {}).get("zorder", 0))
        canvas = torch.zeros(base.shape, dtype=torch.float32,
                             device=base.device)
        for i in order:
            frame = inputs[i].tensor
            props = self.pad_props.get(i, {})
            xpos, ypos = props.get("xpos", 0), props.get("ypos", 0)
            fh = min(frame.shape[0], h - ypos)
            fw = min(frame.shape[1], w - xpos)
            if fh <= 0 or fw <= 0:
                continue
            y0 = _update_start(ypos, h, fh)
            x0 = _update_start(xpos, w, fw)
            canvas[y0:y0 + fh, x0:x0 + fw, :frame.shape[2]] = \
                frame[:fh, :fw].to(torch.float32)
        return [inputs[0].with_(tensors=(saturating_cast(canvas,
                                                         base.dtype),))]


# ---------------------------------------------------------------------------
# Tensor elements
# ---------------------------------------------------------------------------


@register_element("tensor_converter")
class TensorConverter(Element):
    """media stream -> other/tensors: a video/x-raw HWC frame becomes one
    tensor; flexible frames keep their FLEXIBLE specs."""

    def negotiate(self, in_caps):
        src = in_caps[0]
        if src.media == "other/flexbuf" or (
                src.tensors and src.tensors[0].format == TensorFormat.FLEXIBLE):
            specs = tuple(t.with_format(TensorFormat.FLEXIBLE)
                          for t in src.tensors) \
                or (TensorSpec((0,), "float32", TensorFormat.FLEXIBLE),)
            return [Caps(media="other/tensors", tensors=specs)]
        return [Caps(media="other/tensors", tensors=src.tensors)]

    def apply(self, params, inputs, ctx=None):
        return [inputs[0]]


@register_element("tensor_transform")
class TensorTransform(Element):
    """``mode=arithmetic option=typecast:float32,add:-127.5,div:127.5`` (the
    TROPT preprocessing string of Listing 1, plus ``sub``, ``mul`` and
    ``clamp:lo:hi``), or ``mode=transpose option=1:0:2``."""

    def __init__(self, name=None, mode="arithmetic", option="", **props):
        super().__init__(name=name, **props)
        self.mode = mode
        self.ops = [tok for tok in str(option).split(",") if tok]

    @staticmethod
    def _divisor(x: torch.Tensor, arg: str) -> torch.Tensor:
        # a 0-dim tensor on x's device, not a Python scalar: on the card a
        # CPU-scalar divisor becomes a multiply by its reciprocal, which
        # the CPU and the JAX package's eager division do not do.  Filled
        # on the device: a host-to-device copy could not be captured in a
        # CUDA graph
        dt = x.dtype if x.is_floating_point() else torch.float32
        return torch.full((), float(arg), dtype=dt, device=x.device)

    def _arith(self, x):
        for op in self.ops:
            kind, _, arg = op.partition(":")
            if kind == "typecast":
                x = saturating_cast(x, TORCH_DTYPES[arg])
            elif kind == "add":
                x = x + float(arg)
            elif kind == "sub":
                x = x - float(arg)
            elif kind == "mul":
                x = x * float(arg)
            elif kind == "div":
                x = x / self._divisor(x, arg)
            elif kind == "clamp":
                lo, hi = arg.split(":") if ":" in arg else arg.split("-")
                x = torch.clamp(x, float(lo), float(hi))
            else:
                raise ValueError(f"unknown arithmetic op {op!r}")
        return x

    def negotiate(self, in_caps):
        src = in_caps[0]
        if self.mode == "arithmetic" and src.tensors:
            dt = None
            for op in self.ops:
                if op.startswith("typecast:"):
                    dt = op.split(":", 1)[1]
            if dt:
                specs = tuple(TensorSpec(t.shape, dt, t.format, t.max_nnz)
                              for t in src.tensors)
                return [Caps(media="other/tensors", tensors=specs)]
        if self.mode == "transpose" and src.tensors:
            perm = tuple(int(i) for i in self.ops[0].split(":"))
            t0 = src.tensors[0]
            shape = tuple(t0.shape[i] for i in perm)
            return [Caps(media="other/tensors",
                         tensors=(TensorSpec(shape, t0.dtype),))]
        return [src]

    def apply(self, params, inputs, ctx=None):
        buf = inputs[0]
        if self.mode == "arithmetic":
            out = tuple(self._arith(t) for t in buf.tensors)
        elif self.mode == "transpose":
            perm = tuple(int(i) for i in self.ops[0].split(":"))
            out = tuple(t.permute(perm).contiguous() for t in buf.tensors)
        else:
            raise ValueError(f"unknown transform mode {self.mode!r}")
        return [buf.with_(tensors=out)]


#: tensor_filter model=<key> resolves through here, so pipeline
#: descriptions stay strings (like model file paths in NNStreamer)
MODEL_REGISTRY = {}


def register_model(key: str, init_fn: Optional[Callable],
                   apply_fn: Callable, out_specs: Sequence[TensorSpec] = ()):
    """``init_fn(generator, device) -> params`` (the port's
    ``Element.init_params`` signature); ``apply_fn(params, *tensors)``
    returns a tensor or a tuple of them."""
    MODEL_REGISTRY[key] = (init_fn, apply_fn, tuple(out_specs))


@register_element("tensor_filter")
class TensorFilter(Element):
    """The NN inference element.  ``model`` is a registry key, or pass
    ``apply_fn``/``init_fn`` programmatically."""

    def __init__(self, name=None, model=None, framework="torch",
                 apply_fn=None, init_fn=None, out_specs=(), **props):
        super().__init__(name=name, framework=framework, **props)
        if apply_fn is not None:
            self._init_fn, self._apply_fn = init_fn, apply_fn
            self._out_specs = tuple(out_specs)
            self.model_key = name
        else:
            if model not in MODEL_REGISTRY:
                raise KeyError(f"tensor_filter model={model!r} not "
                               f"registered; known: {sorted(MODEL_REGISTRY)}")
            self._init_fn, self._apply_fn, self._out_specs = \
                MODEL_REGISTRY[model]
            self.model_key = model

    def plan_signature_extra(self):
        # model behavior lives in callables, not attributes; registry models
        # share function objects, so identical keys share cached callables
        return (self.model_key, id(self._apply_fn), id(self._init_fn))

    def negotiate(self, in_caps):
        if self._out_specs:
            return [Caps(media="other/tensors", tensors=self._out_specs)]
        return [Caps(media="other/tensors")]

    def init_params(self, generator, device):
        return self._init_fn(generator, device) if self._init_fn else {}

    def apply(self, params, inputs, ctx=None):
        buf = inputs[0]
        outs = self._apply_fn(params, *buf.tensors)
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        return [buf.with_(tensors=tuple(outs))]


@register_element("tensor_decoder")
class TensorDecoder(Element):
    """NN output -> media.  Modes: direct_video (tensor -> uint8 frame),
    bounding_boxes (outline of the best-scoring box on an RGBA canvas of
    ``option4=W:H``), classification (argmax)."""

    def __init__(self, name=None, mode="direct_video", **props):
        super().__init__(name=name, **props)
        self.mode = mode
        self.opts = {k: v for k, v in props.items() if k.startswith("option")}

    def negotiate(self, in_caps):
        if self.mode in ("direct_video", "bounding_boxes"):
            return [Caps(media="video/x-raw")]
        return [Caps(media="other/tensors")]

    def apply(self, params, inputs, ctx=None):
        buf = inputs[0]
        if self.mode == "direct_video":
            return [buf.with_(tensors=(saturating_cast(buf.tensors[0],
                                                       torch.uint8),))]
        if self.mode == "classification":
            logits = buf.tensors[0]
            return [buf.with_(tensors=(
                torch.argmax(logits, dim=-1).to(torch.int32),))]
        if self.mode == "bounding_boxes":
            w, h = (int(v) for v in self.opts.get("option4", "64:48")
                    .split(":"))
            boxes, scores = buf.tensors[0], buf.tensors[1]
            # index_select: indexing by a 0-dim tensor reads it on the host
            best = torch.index_select(boxes, 0, torch.argmax(scores)[None])
            box = torch.clamp(best[0], 0.0, 1.0)
            x0, y0, x1, y1 = box[0] * w, box[1] * h, box[2] * w, box[3] * h
            dev = boxes.device
            yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
            xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
            on_edge = (
                (((yy - y0).abs() < 1) | ((yy - y1).abs() < 1))
                & (xx >= x0) & (xx <= x1)
            ) | (
                (((xx - x0).abs() < 1) | ((xx - x1).abs() < 1))
                & (yy >= y0) & (yy <= y1)
            )
            canvas = (on_edge.to(torch.uint8) * 255)[..., None]
            return [buf.with_(tensors=(
                canvas.expand(h, w, 4).contiguous(),))]   # RGBA overlay
        raise ValueError(f"unknown decoder mode {self.mode!r}")


def _earliest(a, b):
    """min of two pts, either a number or a 0-dim tensor, without reading a
    tensor on the host (a comparison's truth value would)."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, max=b)
    if isinstance(b, torch.Tensor):
        return torch.clamp(b, max=a)
    return min(a, b)


@register_element("tensor_mux")
class TensorMux(Element):
    """Merge N streams into one multi-tensor buffer with the earliest pts
    (paper §4.2.3: muxing is where cross-device sync matters) and the
    inputs' meta merged in pad order."""

    n_sink_pads = None

    def negotiate(self, in_caps):
        specs = tuple(t for c in in_caps for t in c.tensors)
        return [Caps(media="other/tensors", tensors=specs)]

    def apply(self, params, inputs, ctx=None):
        tensors = tuple(t for b in inputs for t in b.tensors)
        pts = inputs[0].pts
        for b in inputs[1:]:
            pts = _earliest(pts, b.pts)
        meta = {}
        for b in inputs:
            meta.update(b.meta)
        return [StreamBuffer(tensors=tensors, pts=pts, meta=meta)]


@register_element("tensor_demux")
class TensorDemux(Element):
    """Split a multi-tensor buffer into per-tensor streams (dmux.src_N)."""

    n_src_pads = None

    def negotiate(self, in_caps):
        return [Caps(media="other/tensors", tensors=(t,))
                for t in in_caps[0].tensors]

    def apply(self, params, inputs, ctx=None):
        buf = inputs[0]
        return [buf.with_(tensors=(t,)) for t in buf.tensors]


@register_element("tee")
class Tee(Element):
    """Fan one stream out to N branches."""

    n_src_pads = None

    def negotiate(self, in_caps):
        return [in_caps[0]]  # grown per request pad by Pipeline.realize

    def apply(self, params, inputs, ctx=None):
        return [inputs[0]] * max(1, len(self.out_caps))


@register_element("queue")
class Queue(Element):
    """``leaky=2`` drops old buffers when full (paper §5.1).  In a
    synchronous pipeline step a queue is the identity; leaky and
    backpressure semantics live on the pub/sub channels."""

    def __init__(self, name=None, leaky=0, **props):
        super().__init__(name=name, **props)
        self.leaky = int(leaky)
        self.max_size = int(props.get("max_size_buffers",
                                      props.get("max-size-buffers", 2)))

    def apply(self, params, inputs, ctx=None):
        return list(inputs)


@register_element("queue2")
class Queue2(Queue):
    """The paper's latency-injection queue when testing timestamp sync."""


#: tensor_if operators: the control tensor's max against the threshold
_IF_OPS = {"GE": torch.ge, "GT": torch.gt, "LE": torch.le, "LT": torch.lt,
           "EQ": torch.eq}


@register_element("tensor_if")
class TensorIf(Element):
    """Conditional gate (Fig. 5's DETECT path): compares the max of the
    first tensor (as float32) against ``threshold`` with ``operator``.
    Data still flows: a closed gate zeroes every tensor; the gate flag is
    appended as an int32 0-d tensor, and ``meta["gate_open"]`` marks the
    buffer as gated."""

    n_sink_pads = 1

    def __init__(self, name=None, compared_value="A1", operator="GE",
                 threshold=0.5, **props):
        super().__init__(name=name, **props)
        self.threshold = float(threshold)
        self.operator = operator

    def apply(self, params, inputs, ctx=None):
        buf = inputs[0]
        score = buf.tensors[0].to(torch.float32).max()
        ok = _IF_OPS[self.operator](score, self.threshold)
        gated = tuple(torch.where(ok, t, torch.zeros_like(t))
                      for t in buf.tensors)
        return [buf.with_(tensors=gated + (ok.to(torch.int32),),
                          meta={**buf.meta, "gate_open": None})]


# ---------------------------------------------------------------------------
# Sparse conversion elements (paper §4.1) over K3/K4
# ---------------------------------------------------------------------------


@register_element("tensor_sparse_enc")
class TensorSparseEnc(Element):
    def __init__(self, name=None, max_nnz=None, threshold=0.0, **props):
        super().__init__(name=name, **props)
        self.max_nnz = int(max_nnz) if max_nnz else None
        self.threshold = float(threshold)

    def negotiate(self, in_caps):
        t0 = in_caps[0].tensors[0]
        nnz = self.max_nnz or max(1, t0.nelem // 4)
        return [Caps(media="other/tensors",
                     tensors=(TensorSpec(t0.shape, t0.dtype,
                                         TensorFormat.SPARSE, nnz),))]

    def apply(self, params, inputs, ctx=None):
        buf = inputs[0]
        x = buf.tensors[0]
        cap = self.max_nnz or max(1, x.numel() // 4)
        values, indices, nnz = kops.sparse_enc(x.reshape(-1), cap,
                                               self.threshold)
        sp = SparsePayload(values=values, indices=indices, nnz=nnz,
                           dense_shape=tuple(x.shape))
        return [buf.with_(tensors=(sp,))]


@register_element("tensor_sparse_dec")
class TensorSparseDec(Element):
    def negotiate(self, in_caps):
        t0 = in_caps[0].tensors[0]
        return [Caps(media="other/tensors",
                     tensors=(TensorSpec(t0.shape, t0.dtype),))]

    def apply(self, params, inputs, ctx=None):
        buf = inputs[0]
        sp: SparsePayload = buf.tensors[0]
        n = int(np.prod(sp.dense_shape))
        dense = kops.sparse_dec(sp.values, sp.indices, sp.nnz, n)
        return [buf.with_(tensors=(dense.reshape(sp.dense_shape),))]
