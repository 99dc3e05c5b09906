"""Element base class + factory registry (GStreamer element analogue).

Port of ``src/repro/core/element.py``.  An Element transforms StreamBuffers
between typed pads; caps negotiation happens at link time (``realize``), so
incompatible pipelines fail at construction, not mid-stream.  State (KV
caches, frame counters) lives in the pipeline's state dict, not on the
element; the port may update state tensors in place, and says so where it
does.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence, Type

from .buffers import StreamBuffer
from .formats import Caps, CapsError

__all__ = ["Element", "PipelineContext", "register_element",
           "element_factory", "FACTORY"]

FACTORY: Dict[str, Type["Element"]] = {}


def register_element(factory_name: str):
    def deco(cls: Type["Element"]):
        cls.factory_name = factory_name
        FACTORY[factory_name] = cls
        return cls
    return deco


def element_factory(factory_name: str, name: Optional[str] = None, **props) -> "Element":
    try:
        cls = FACTORY[factory_name]
    except KeyError as e:
        raise KeyError(
            f"no such element factory {factory_name!r}; "
            f"known: {sorted(FACTORY)}") from e
    return cls(name=name, **props)


class Element:
    """Base element.  Subclasses declare pad counts and caps templates and
    implement ``apply``.

    * ``n_sink_pads`` / ``n_src_pads`` — fixed pad counts (None = request
      pads, grown on demand).
    * ``negotiate(in_caps)`` — given negotiated input caps, the output caps.
    * ``init_params(generator, device)`` / ``init_state(device)``.
    * ``apply(params, inputs, ctx)`` — list[StreamBuffer] -> list[StreamBuffer].
    """

    factory_name = "element"
    n_sink_pads: Optional[int] = 1
    n_src_pads: Optional[int] = 1

    #: element performs host-level side effects in ``apply`` (channel I/O)
    host_impure = False
    #: host-impure source whose frame the scheduler can pull & inject
    is_host_source = False
    #: host-impure terminal sink whose input frame can be captured
    is_host_sink = False

    _uid = 0

    def __init__(self, name: Optional[str] = None, **props):
        if name is None:
            Element._uid += 1
            name = f"{self.factory_name}{Element._uid}"
        self.name = name
        self.props = props
        self.in_caps: List[Caps] = []
        self.out_caps: List[Caps] = []

    # -- caps ---------------------------------------------------------------
    def sink_caps_template(self, pad: int = 0) -> Caps:
        return Caps.ANY

    def negotiate(self, in_caps: Sequence[Caps]) -> List[Caps]:
        """Default: single pass-through pad."""
        n_out = self.n_src_pads if self.n_src_pads is not None else 1
        base = in_caps[0] if in_caps else Caps.ANY
        return [base] * n_out

    def accept_caps(self, pad: int, caps: Caps) -> Caps:
        tmpl = self.sink_caps_template(pad)
        try:
            return caps.intersect(tmpl)
        except CapsError as e:
            raise CapsError(f"{self.name}.sink_{pad}: {e}") from e

    # -- plan fingerprinting -------------------------------------------------
    def plan_signature(self) -> tuple:
        """Static-config fingerprint, part of the executable-cache key:
        class, name, scalar/tuple config attributes, props, negotiated caps."""
        cfg = []
        for k, v in sorted(vars(self).items()):
            if k.startswith("_") or k in ("in_caps", "out_caps", "props"):
                continue
            if isinstance(v, (str, int, float, bool, type(None))):
                cfg.append((k, v))
            elif isinstance(v, (tuple, list, dict, enum.Enum)):
                cfg.append((k, repr(v)))
        return (type(self).__name__, self.factory_name, self.name,
                tuple(cfg), repr(sorted(self.props.items())),
                tuple(c.describe() for c in self.in_caps),
                tuple(c.describe() for c in self.out_caps),
                self.plan_signature_extra())

    def plan_signature_extra(self) -> tuple:
        return ()

    # -- params / state ------------------------------------------------------
    def init_params(self, generator, device) -> dict:
        return {}

    def init_state(self, device) -> dict:
        """Per-stream mutable state threaded through steps."""
        return {}

    # -- execution ------------------------------------------------------------
    def apply(self, params, inputs: List[StreamBuffer], ctx=None) -> List[StreamBuffer]:
        raise NotImplementedError(self.factory_name)

    def __repr__(self):
        kv = " ".join(f"{k}={v}" for k, v in self.props.items())
        return f"<{self.factory_name} {self.name}{' ' + kv if kv else ''}>"


class PipelineContext:
    """Per-step context handed to elements: stream state in and out."""

    def __init__(self, state: dict):
        self.state = state
        self.next_state = dict(state)

    def get_state(self, name: str):
        return self.state.get(name)

    def set_state(self, name: str, value):
        self.next_state[name] = value
