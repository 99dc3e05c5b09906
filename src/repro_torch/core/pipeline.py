"""Pipeline: a DAG of Elements with a static execution plan, plus
``parse_launch`` — a gst-launch-style textual pipeline description parser
so the paper's Listing 1/2 pipelines can be written as strings.

Port of ``src/repro/core/pipeline.py``: parsing, caps negotiation
(``realize``), ``init``/``init_state``, ``step`` (the plan),
``step_interpreted`` (the seed interpreter, the parity baseline), the
bursts ``step_n``, the cached executables ``compiled_step`` /
``compiled_step_n``, and ``reconfig()``, the edit script of a live
reconfiguration (``core/reconfig.py``).

Grammar subset (sufficient for the paper's examples)::

    v4l2src ! videoconvert ! video/x-raw,width=300,height=300,format=RGB !
      tensor_converter ! tensor_filter model=ssd ! appsink name=out
    ts. queue leaky=2 ! videoconvert ! mix.sink_1
    compositor name=mix sink_0::zorder=2 sink_1::zorder=1 ! appsink

* ``!`` links elements left to right.
* ``name=x`` names an element; ``x.`` continues a chain from it (tee/demux
  request pads); ``x.sink_N`` / ``x.src_N`` addresses a specific pad.
* A token containing ``/`` is a caps filter.
* ``pad::prop=v`` sets a pad property (compositor zorder/xpos/ypos).
"""
from __future__ import annotations

import shlex
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

from .buffers import StreamBuffer
from .element import Element, PipelineContext, element_factory
from .elements import AppSink, AppSrc, CapsFilter, Compositor
from .formats import Caps, CapsError, TensorFormat, TensorSpec

__all__ = ["Pipeline", "parse_launch", "parse_caps"]


# ---------------------------------------------------------------------------
# Caps string parsing
# ---------------------------------------------------------------------------

_VIDEO_CHANNELS = {"RGB": 3, "BGR": 3, "RGBA": 4, "BGRA": 4, "GRAY8": 1}


def _split_caps_fields(body: str) -> Dict[str, str]:
    """Split "k=v,k2=v2,cont,k3=v3" where a comma-segment without '=' continues
    the previous value (NNStreamer dimension lists)."""
    fields: Dict[str, str] = {}
    last_key = None
    for seg in body.split(","):
        seg = seg.strip().strip('"')
        if "=" in seg:
            k, v = seg.split("=", 1)
            fields[k.strip()] = v.strip().strip('"')
            last_key = k.strip()
        elif last_key is not None:
            fields[last_key] += "," + seg
    return fields


def _dims_to_shape(dims: str) -> Tuple[int, ...]:
    """NNStreamer dims are innermost-first ("4:20:1:1"); convert to row-major
    shape dropping leading 1s."""
    parts = [int(p) for p in dims.split(":")]
    shape = tuple(reversed(parts))
    while len(shape) > 1 and shape[0] == 1:
        shape = shape[1:]
    return shape


def parse_caps(token: str) -> Caps:
    media, _, body = token.partition(",")
    media = media.strip()
    fields = _split_caps_fields(body) if body else {}
    if media == "video/x-raw":
        h = int(fields.get("height", 0))
        w = int(fields.get("width", 0))
        c = _VIDEO_CHANNELS.get(fields.get("format", "RGB"), 3)
        tensors = (TensorSpec((h, w, c), "uint8"),) if h and w else ()
        return Caps(media=media, tensors=tensors)
    if media in ("other/tensor", "other/tensors"):
        fmt = TensorFormat(fields.get("format", "static"))
        if "dimensions" in fields:
            dims = fields["dimensions"].split(",")
            types = fields.get("types", "float32").split(",")
            if len(types) == 1:
                types = types * len(dims)
            tensors = tuple(TensorSpec(_dims_to_shape(d), t.strip(), fmt)
                            for d, t in zip(dims, types))
        else:
            tensors = ()
        return Caps(media="other/tensors", tensors=tensors)
    if media == "other/flexbuf":
        return Caps(media="other/flexbuf")
    return Caps(media=media)


# ---------------------------------------------------------------------------
# Pipeline graph
# ---------------------------------------------------------------------------

class Link:
    __slots__ = ("src", "src_pad", "dst", "dst_pad")

    def __init__(self, src, src_pad, dst, dst_pad):
        self.src, self.src_pad, self.dst, self.dst_pad = src, src_pad, dst, dst_pad

    def __repr__(self):
        return f"{self.src.name}.src_{self.src_pad}->{self.dst.name}.sink_{self.dst_pad}"


class Pipeline:
    def __init__(self, name: str = "pipeline"):
        self.name = name
        self.elements: Dict[str, Element] = {}
        self.links: List[Link] = []
        self.plan = None  # ExecutionPlan, built by realize()
        self._realized = False

    # -- construction ---------------------------------------------------------
    def add(self, elem: Element) -> Element:
        if elem.name in self.elements:
            raise ValueError(f"duplicate element name {elem.name!r}")
        self.elements[elem.name] = elem
        return elem

    def link(self, src: Element, dst: Element,
             src_pad: Optional[int] = None, dst_pad: Optional[int] = None):
        if src.name not in self.elements:
            self.add(src)
        if dst.name not in self.elements:
            self.add(dst)
        if src_pad is None:
            used = [l.src_pad for l in self.links if l.src is src]
            if src.n_src_pads is None:
                src_pad = (max(used) + 1) if used else 0  # request pad
            else:
                src_pad = 0
                if src.n_src_pads == 0:
                    raise CapsError(f"{src.name} has no src pads")
        if dst_pad is None:
            used = [l.dst_pad for l in self.links if l.dst is dst]
            if dst.n_sink_pads is None:
                dst_pad = (max(used) + 1) if used else 0
            else:
                taken = set(used)
                dst_pad = next(i for i in range(dst.n_sink_pads or 1) if i not in taken) \
                    if dst.n_sink_pads else 0
        self.links.append(Link(src, src_pad, dst, dst_pad))
        self._realized = False
        return dst

    # -- realization: topo sort + caps negotiation -----------------------------
    def _toposort(self) -> List[Element]:
        indeg = {n: 0 for n in self.elements}
        succ = defaultdict(list)
        for l in self.links:
            indeg[l.dst.name] += 1
            succ[l.src.name].append(l.dst.name)
        # deque keeps Kahn's algorithm O(V+E); popleft preserves the exact
        # FIFO visit order the seed's list.pop(0) produced (deterministic)
        order, stack = [], deque(sorted(n for n, d in indeg.items() if d == 0))
        while stack:
            n = stack.popleft()
            order.append(n)
            for m in succ[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    stack.append(m)
        if len(order) != len(self.elements):
            cyc = set(self.elements) - set(order)
            raise CapsError(f"pipeline has a cycle involving {sorted(cyc)}")
        return [self.elements[n] for n in order]

    def realize(self):
        """Negotiate caps along every link (GStreamer link-time checks)."""
        from .elements import VideoScale
        # videoscale takes its target from the *downstream* capsfilter (real
        # GStreamer negotiates bidirectionally; we fold the one pattern the
        # paper's pipelines use: `videoscale ! video/x-raw,width=..,height=..`)
        for l in self.links:
            if isinstance(l.src, VideoScale) and l.src.target is None \
                    and isinstance(l.dst, CapsFilter) and l.dst.filter_caps.tensors:
                h, w = l.dst.filter_caps.tensors[0].shape[:2]
                l.src.target = (h, w)
        order = self._toposort()
        in_links: Dict[str, List[Link]] = defaultdict(list)
        for l in self.links:
            in_links[l.dst.name].append(l)
        for elem in order:
            links = sorted(in_links[elem.name], key=lambda l: l.dst_pad)
            in_caps = []
            for l in links:
                up = l.src.out_caps[l.src_pad] if l.src.out_caps else Caps.ANY
                in_caps.append(elem.accept_caps(l.dst_pad, up))
            elem.in_caps = in_caps
            out = elem.negotiate(in_caps)
            # grow request src pads (tee): replicate caps across linked pads
            n_links_out = max([l.src_pad for l in self.links if l.src is elem],
                              default=-1) + 1
            if elem.n_src_pads is None and len(out) < n_links_out:
                out = out * n_links_out if len(out) == 1 else out
            elem.out_caps = out
        self._order = order
        self._in_links = in_links
        # compile the graph once: flatten topo order + wiring into a static
        # slot-indexed schedule (see core/plan.py) — stepping never re-sorts
        from .plan import ExecutionPlan
        self.plan = ExecutionPlan(self)
        self._realized = True
        return self

    def reconfig(self):
        """Start a topology edit script against this pipeline (DESIGN.md
        §6): a :class:`~.reconfig.ReconfigPlan` of swap/relink/add/link/
        remove edits, for ``Runtime.reconfigure`` to prepare, warm and
        commit while the stream runs."""
        from .reconfig import ReconfigPlan
        return ReconfigPlan(self)

    # -- params / state --------------------------------------------------------
    def init(self, generator, device) -> Dict[str, dict]:
        """Parameters of every element, drawn from ``generator`` in topo
        order (the JAX package splits one PRNG key per element; a torch
        generator is simply consumed in the same order)."""
        if not self._realized:
            self.realize()
        params = {}
        for elem in self._order:
            p = elem.init_params(generator, device)
            if p:
                params[elem.name] = p
        return params

    def init_state(self, device) -> Dict[str, dict]:
        if not self._realized:
            self.realize()
        state = {}
        for elem in self._order:
            s = elem.init_state(device)
            if s:
                state[elem.name] = s
        return state

    # -- execution --------------------------------------------------------------
    def sources(self) -> List[str]:
        """Names of the app sources (the inputs ``step`` takes)."""
        return [e.name for e in self.elements.values()
                if isinstance(e, AppSrc)]

    def sinks(self) -> List[str]:
        """Names of the app sinks (the outputs ``step`` returns)."""
        return [e.name for e in self.elements.values()
                if isinstance(e, AppSink)]

    def step(self, params: dict, state: dict,
             inputs: Optional[Dict[str, StreamBuffer]] = None
             ) -> Tuple[Dict[str, StreamBuffer], dict]:
        """Run one frame through the precompiled plan schedule."""
        if not self._realized:
            self.realize()
        return self.plan.run(params, state, inputs)

    def step_interpreted(self, params: dict, state: dict,
                         inputs: Optional[Dict[str, StreamBuffer]] = None
                         ) -> Tuple[Dict[str, StreamBuffer], dict]:
        """The seed per-frame interpreter (re-sorts links and rebuilds dicts
        every step), kept as the parity baseline for the plan; semantics
        match :meth:`step` bitwise."""
        if not self._realized:
            self.realize()
        inputs = inputs or {}
        ctx = PipelineContext(state)
        produced: Dict[Tuple[str, int], StreamBuffer] = {}
        outputs: Dict[str, StreamBuffer] = {}
        for elem in self._order:
            links = sorted(self._in_links[elem.name], key=lambda l: l.dst_pad)
            ins = [produced[(l.src.name, l.src_pad)] for l in links]
            if isinstance(elem, AppSrc) and elem.name in inputs:
                ins = [inputs[elem.name]]
            outs = elem.apply(params.get(elem.name, {}), ins, ctx)
            for i, o in enumerate(outs):
                produced[(elem.name, i)] = o
            if isinstance(elem, AppSink) and outs:
                outputs[elem.name] = outs[0]
        return outputs, ctx.next_state

    def step_n(self, params: dict, state: dict,
               inputs: Optional[Dict[str, StreamBuffer]] = None,
               n: Optional[int] = None, hoist_queries: bool = False
               ) -> Tuple[Dict[str, StreamBuffer], dict]:
        """N-frame burst (``ExecutionPlan.step_n``): ``inputs`` holds
        *stacked* per-source frames, or pass ``n`` for self-driven
        pipelines.  Frame ``i`` of the stacked outputs is bitwise what the
        ``i``-th sequential :meth:`step` returns."""
        if not self._realized:
            self.realize()
        return self.plan.step_n(params, state, inputs, n=n,
                                hoist_queries=hoist_queries)

    def compiled_step(self, donate: Optional[bool] = None):
        """The cached single-frame executable, shared process-wide across
        pipelines with the same topology fingerprint (a CUDA graph per
        binding on the card; see ``core/graphs.py``)."""
        if not self._realized:
            self.realize()
        return self.plan.compiled_step(donate=donate)

    def compiled_step_n(self, hoist_io: bool = False,
                        hoist_queries: bool = False,
                        donate: Optional[bool] = None, mesh=None):
        """The cached burst executable (see :meth:`step_n`); ``hoist_io``
        injects the host sources' frames and captures the host sinks'."""
        if not self._realized:
            self.realize()
        return self.plan.compiled_step_n(hoist_io=hoist_io,
                                         hoist_queries=hoist_queries,
                                         donate=donate, mesh=mesh)

    def describe(self) -> str:
        if not self._realized:
            self.realize()
        lines = [f"pipeline {self.name}:"]
        for l in self.links:
            caps = l.src.out_caps[l.src_pad].describe() if l.src.out_caps else "ANY"
            lines.append(f"  {l} [{caps}]")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# parse_launch
# ---------------------------------------------------------------------------

def _is_caps_token(tok: str) -> bool:
    head = tok.split(",")[0]
    return "/" in head and "=" not in head


def parse_launch(description: str, pipeline: Optional[Pipeline] = None) -> Pipeline:
    pipe = pipeline or Pipeline()
    # normalize: treat newlines as chain separators unless the line continues
    # with '!' — gst-launch is whitespace-insensitive, we keep that.
    toks: List[str] = []
    for line in description.strip().splitlines():
        line = line.strip()
        # '#' only comments whole lines: inline '#' is the MQTT wildcard
        # ("mqttsrc sub-topic=objdetect/#")
        if not line or line.startswith("#"):
            continue
        toks.extend(shlex.split(line, comments=False))
    # merge standalone '!' handling: tokens may contain '!' glued — split them
    tokens: List[str] = []
    for t in toks:
        while t.endswith("!") and t != "!":
            t = t[:-1]
            if t:
                tokens.append(t)
            tokens.append("!")
            t = ""
        if t:
            tokens.append(t)

    cur: Optional[Element] = None          # chain tail element
    cur_src_pad: Optional[int] = None      # explicit src pad for next link
    pending_link = False                   # saw '!' awaiting next element
    deferred: List[tuple] = []             # forward refs: (src, src_pad, name, pad)

    def attach(elem: Element, dst_pad: Optional[int] = None):
        nonlocal cur, cur_src_pad, pending_link
        if elem.name not in pipe.elements and elem not in pipe.elements.values():
            pipe.add(elem)
        if pending_link and cur is not None:
            pipe.link(cur, elem, src_pad=cur_src_pad, dst_pad=dst_pad)
        cur, cur_src_pad, pending_link = elem, None, False

    i = 0
    while i < len(tokens):
        tok = tokens[i]
        i += 1
        if tok == "!":
            pending_link = True
            continue
        # pad / element reference:  name.  |  name.sink_0  |  name.src_2
        if "." in tok and not _is_caps_token(tok) and "=" not in tok:
            ref, _, pad = tok.partition(".")
            if ref not in pipe.elements and pad.startswith("sink_") \
                    and pending_link and cur is not None:
                # forward reference (gst-launch resolves these at the end)
                deferred.append((cur, cur_src_pad, ref, int(pad[5:])))
                cur, cur_src_pad, pending_link = None, None, False
                continue
            if ref in pipe.elements:
                elem = pipe.elements[ref]
                if pad.startswith("sink_"):
                    attach(elem, dst_pad=int(pad[5:]))
                elif pad.startswith("src_"):
                    # starts a new chain from a specific src pad; the next
                    # element links implicitly (gst-launch `dmux.src_0 !` or
                    # bare `ts. queue` both work)
                    cur, cur_src_pad, pending_link = elem, int(pad[4:]), True
                else:
                    cur, cur_src_pad, pending_link = elem, None, True
                continue
        if _is_caps_token(tok):
            attach(CapsFilter(caps=parse_caps(tok)))
            continue
        if "=" in tok and cur is not None and "::" in tok:
            padspec, _, val = tok.partition("=")
            pad, _, prop = padspec.partition("::")
            if isinstance(cur, Compositor):
                cur.set_pad_prop(int(pad.split("_")[-1]), prop, val)
            continue
        if "=" in tok and not _is_caps_token(tok):
            # property of current element — must re-create with prop (elements
            # take props in __init__), so collect props *before* instantiation:
            # handled below by look-ahead at element creation.  If we reach
            # here the element already exists: name= is the only mutable prop.
            key, _, val = tok.partition("=")
            if key == "name" and cur is not None:
                pipe.elements.pop(cur.name, None)
                cur.name = val
                pipe.elements[val] = cur
            else:
                cur.props[key] = val
                _late_prop(cur, key, val)
            continue
        # factory name: gather following k=v props via look-ahead
        props = {}
        j = i
        while j < len(tokens):
            t2 = tokens[j]
            if t2 == "!" or _is_caps_token(t2) or "=" not in t2 or "::" in t2:
                break
            k, _, v = t2.partition("=")
            props[k.replace("-", "_")] = v
            j += 1
        i = j
        name = props.pop("name", None)
        # v4l2src in descriptions maps to our deterministic testsrc
        factory = {"v4l2src": "testsrc", "ximagesink": "appsink",
                   "autovideosink": "appsink"}.get(tok, tok)
        elem = element_factory(factory, name=name, **props)
        attach(elem)
    for src, src_pad, ref, dst_pad in deferred:
        if ref not in pipe.elements:
            raise KeyError(f"dangling pad reference {ref}.sink_{dst_pad}")
        pipe.link(src, pipe.elements[ref], src_pad=src_pad, dst_pad=dst_pad)
    return pipe


def _late_prop(elem: Element, key: str, val: str):
    """Apply a property set after element construction (rare path)."""
    if key == "leaky" and hasattr(elem, "leaky"):
        elem.leaky = int(val)
