"""Stock pipeline elements — the part of ``src/repro/core/elements.py`` that
the serve and query-offloading paths and caps negotiation need: appsrc,
testsrc, appsink, fakesink, capsfilter, videoconvert, tensor_converter,
tensor_transform (arithmetic and transpose), tensor_filter with its model
registry, tensor_sparse_enc/dec, and videoscale/compositor as far as
negotiation and ``parse_launch`` touch them.  tensor_decoder, mux/demux,
tee, queue and tensor_if are ROADMAP M1.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..kernels import ops as kops
from .buffers import SparsePayload, StreamBuffer
from .element import Element, PipelineContext, register_element
from .formats import TORCH_DTYPES, Caps, TensorFormat, TensorSpec


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
    frame counter kept in state (same pattern as the JAX package)."""

    n_sink_pads = 0

    def __init__(self, name=None, width=64, height=48, channels=3, **props):
        super().__init__(name=name, **props)
        self.shape = (int(height), int(width), int(channels))

    def negotiate(self, in_caps):
        return [Caps(media="video/x-raw",
                     tensors=(TensorSpec(self.shape, "uint8"),))]

    def init_state(self, device):
        self._device = device
        return {"frame": 0}

    def apply(self, params, inputs, ctx: PipelineContext = None):
        i, dev = ctx.get_state(self.name)["frame"], self._device
        h, w, c = self.shape
        yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None, None]
        xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :, None]
        cc = torch.arange(c, dtype=torch.int32, device=dev)[None, None, :]
        frame = ((yy * 3 + xx * 5 + cc * 17 + i * 7) % 256).to(torch.uint8)
        ctx.set_state(self.name, {"frame": i + 1})
        return [StreamBuffer(tensors=(frame,), pts=i * (16_666_667 // 1000))]


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
    """Negotiates the scaled caps (the target comes from a downstream
    capsfilter, folded in by ``Pipeline.realize``)."""

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
        raise NotImplementedError("videoscale resizing: ROADMAP M1")


@register_element("compositor")
class Compositor(Element):
    """Overlay of N video frames; negotiation and pad properties
    (``mix.sink_0::xpos=...``) only."""

    n_sink_pads = None  # request pads

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.pad_props = {}

    def set_pad_prop(self, pad: int, key: str, val):
        self.pad_props.setdefault(pad, {})[key] = int(val)

    def negotiate(self, in_caps):
        return [in_caps[0]]

    def apply(self, params, inputs, ctx=None):
        raise NotImplementedError("compositor overlay: ROADMAP M1")


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
        # the CPU and the JAX package's eager division do not do
        dt = x.dtype if x.is_floating_point() else torch.float32
        return torch.tensor(float(arg), dtype=dt, device=x.device)

    def _arith(self, x):
        for op in self.ops:
            kind, _, arg = op.partition(":")
            if kind == "typecast":
                x = x.to(TORCH_DTYPES[arg])
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
