"""Stock pipeline elements — the part of ``src/repro/core/elements.py`` that
the serve path and caps negotiation need: appsrc, testsrc, appsink,
fakesink, capsfilter, videoconvert, and videoscale/compositor as far as
negotiation and ``parse_launch`` touch them.  The rest of the element set
(tensor_converter/transform/filter/decoder, mux/demux, tee, queue,
tensor_if, sparse enc/dec) is ROADMAP M1 and M2.
"""
from __future__ import annotations

from typing import Optional

import torch

from .buffers import StreamBuffer
from .element import Element, PipelineContext, register_element
from .formats import Caps, TensorSpec


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
