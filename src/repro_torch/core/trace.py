"""Host spans inside the serve path, on the profiler's clock.

One process-wide tracer, :data:`TRACER`, off by default (as the kernels'
launch counters are module-level).  A site reads ``TRACER.on`` once and
branches: with the tracer off it reads no clock and allocates nothing.
With it on, it keeps three kinds of record in memory until :func:`drain`:

* host spans (:class:`Span`): name, ``t0_ns``, ``t1_ns``, the span's id,
  the id of the span open around it (-1 at the top) and an optional
  request id.  A span is recorded when it ends, so a drain between ticks
  returns the spans that ended in the tick, children before parents.
* request intervals (:class:`Wait`): kind, request id, ``t0_ns``,
  ``t1_ns``;
* counters (:class:`Count`): name and a tuple of integers.

Stamps are ``time.time_ns()``, the wall clock that ``torch.profiler``
converts its events to, so a span and the device operations of a CUDA
trace share one clock.  The buffer holds at most ``cap`` records between
drains; past that, records are counted in ``dropped`` and not kept.

The serve path's sites (a span's self time is its duration less the part
its children cover):

==================  =====================================================
``sched.tick``      ``Runtime.tick``, the whole tick
``sched.clients``   the client runs' segments
``sched.dispatch``  the round's dispatch
``sched.drain``     the drain; the batchers' flushes nest inside it
``prefill``         one prefill in ``StreamingQueryBatcher._admit``
                    (replays too), with the request's id
``prefill.launch``  ``host_prefill`` up to the first token's host read
``prefill.read``    the first token's host read
``decode``          one ``StreamingQueryBatcher._decode_tick``
``decode.admit``    slot choice and the joiners' admission
``decode.serve``    the serve tick's call: the executable's lookup, its
                    binding key and copies, and its launch
``graph.launch``    ``GraphedCallable``: the graph's replay and its
                    outputs' clones, or the eager call
``graph.capture``   ``GraphedCallable``: a capture
``decode.read``     the lanes' host read
``decode.deliver``  finished streams' answers through the serversink
``queue_wait``      (interval) a request's wait from its admission
                    queue's ``ingest`` to the start of its ``prefill``
``mla``             (eager prefill, inside ``prefill.launch``) one
                    layer's latent attention (``models/transformer.py``
                    ``block_prefill``)
``moe``             (eager prefill, inside ``prefill.launch``) one
                    layer's routed and shared experts
``moe.prefill``     (counter, read at ``prefill.read``) each MoE layer
                    of the prefill: ``(tokens, pairs, dropped)``, its
                    tokens, its (token, held expert) choices and those
                    that capacity turned away (``models/moe.py``
                    ``count_into``)
``moe.decode``      (counter, read at ``decode.read``) the same of each
                    MoE layer of the decode tick, every slot's row
                    counted, from the buffer the graphed tick fills
==================  =====================================================

The ``mla`` and ``moe`` spans time the host's launch of the layer's work
(the card runs it later, unless its queue is full); nothing is recorded
inside a graph's capture or replay.  The counters are device tensors the
layers write with no host read; the serve path reads them only while the
tracer is on, after the host read that ends the prefill or tick.

The request id is the admission record's ``seq``.  A site that raises
leaves its span open; the next span that ends around it closes the stack
down to itself, and :func:`enable` starts a fresh stack.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

__all__ = ["Span", "Wait", "Count", "Tracer", "TRACER", "CAP", "enable",
           "disable", "drain"]

#: records the buffer holds between drains
CAP = 1 << 16


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    sid: int
    parent: int
    rid: Optional[int]


class Wait(NamedTuple):
    kind: str
    rid: int
    t0_ns: int
    t1_ns: int


class Count(NamedTuple):
    name: str
    values: Tuple[int, ...]


class Tracer:
    """The tracer (module docstring).  ``begin`` returns a token that
    ``end`` or ``then`` takes; sites call them only while ``on``."""

    def __init__(self, cap: int = CAP):
        self.on = False
        self.cap = cap
        self.spans: List[Span] = []
        self.waits: List[Wait] = []
        self.counts: List[Count] = []
        self.dropped = 0
        self._open: List[int] = []      # ids of the open spans, innermost last
        self._next = 0

    def begin(self, name: str, rid: Optional[int] = None,
              t0: Optional[int] = None) -> Tuple:
        sid = self._next
        self._next = sid + 1
        parent = self._open[-1] if self._open else -1
        self._open.append(sid)
        return (name, time.time_ns() if t0 is None else t0, sid, parent, rid)

    def end(self, tok: Tuple, t1: Optional[int] = None) -> int:
        """Close the span of ``tok``; -> its end stamp."""
        t1 = time.time_ns() if t1 is None else t1
        name, t0, sid, parent, rid = tok
        st = self._open
        if sid in st:
            del st[st.index(sid):]
        if self._full():
            self.dropped += 1
        else:
            self.spans.append(Span(name, t0, t1, sid, parent, rid))
        return t1

    def then(self, tok: Tuple, name: str, rid: Optional[int] = None) -> Tuple:
        """Close ``tok``'s span and open its sibling ``name`` on one
        stamp, so that the two tile."""
        t = self.end(tok)
        return self.begin(name, rid, t)

    def wait(self, kind: str, rid: int, t0: int, t1: int):
        if self._full():
            self.dropped += 1
        else:
            self.waits.append(Wait(kind, rid, t0, t1))

    def count(self, name: str, values: Tuple[int, ...]):
        if self._full():
            self.dropped += 1
        else:
            self.counts.append(Count(name, tuple(values)))

    def _full(self) -> bool:
        return len(self.spans) + len(self.waits) + len(self.counts) >= \
            self.cap

    def drain(self) -> Tuple[List[Span], List[Wait], List[Count]]:
        """The spans, intervals and counters recorded since the last drain,
        which leave the buffer."""
        out = (self.spans, self.waits, self.counts)
        self.spans, self.waits, self.counts = [], [], []
        return out


#: the process's tracer
TRACER = Tracer()


def enable():
    """Start recording, with no span open."""
    TRACER._open.clear()
    TRACER.on = True


def disable():
    """Stop recording; what was recorded stays until :func:`drain`."""
    TRACER.on = False


def drain() -> Tuple[List[Span], List[Wait], List[Count]]:
    return TRACER.drain()
