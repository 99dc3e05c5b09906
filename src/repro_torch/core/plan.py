"""Pipeline execution plan — port of ``src/repro/core/plan.py``.

``ExecutionPlan`` turns a realized pipeline into a static slot-indexed
schedule once, at ``realize()`` time, so stepping a frame never re-sorts
links or rebuilds dicts.  What the serve path needs:

* ``run(params, state, inputs, hoist_io, hoist_queries)`` — one frame
  through the schedule.  ``hoist_queries`` injects the serversrc request and
  captures the serversink answer instead of doing channel I/O, so a batcher
  can drive a server pipeline directly.
* ``run_deferred`` and :class:`PendingQuery` — a client frame paused at its
  ``tensor_query_client`` until the scheduler has the answer.
* ``compiled_serve_tick(state)`` — the stateful decode tick of a
  ``stream_serving`` plan, cached in a process-wide registry keyed by the
  plan's topology fingerprint and the state's :func:`structure_key`.

The registry holds plain callables (PyTorch runs eagerly); it is kept
fingerprint-keyed and LRU-capped like the JAX package's executable cache so
that CUDA-graph captures can take the callables' place later.  Bursts,
mesh sharding, the fused wire path and compiled deferred segments wait
(ROADMAP M1, M3, M11).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from .buffers import StreamBuffer, structure_key
from .element import Element, PipelineContext

__all__ = ["ExecutionPlan", "PendingQuery", "PlanOp",
           "clear_executable_cache", "executable_cache_info"]


class PlanOp:
    """One scheduled element: static wiring resolved to value slots."""

    __slots__ = ("elem", "name", "in_slots", "out_slots", "injectable",
                 "is_sink", "is_host_sink", "is_query_src", "is_query_sink",
                 "is_query_client")

    def __init__(self, elem: Element, in_slots: Tuple[int, ...],
                 out_slots: Tuple[int, ...], injectable: bool,
                 is_sink: bool, is_host_sink: bool):
        self.elem = elem
        self.name = elem.name
        self.in_slots = in_slots
        self.out_slots = out_slots
        self.injectable = injectable
        self.is_sink = is_sink
        self.is_host_sink = is_host_sink
        self.is_query_src = getattr(elem, "is_query_source", False)
        self.is_query_sink = getattr(elem, "is_query_sink", False)
        self.is_query_client = getattr(elem, "is_query_client", False)


# Process-wide executable registry: fingerprint -> {"fns": {key: callable}}.
# Two plans with equal fingerprints behave identically (the fingerprint
# covers element class, static config, wiring and negotiated caps), so the
# first plan's callables serve all of them.  LRU-capped.
_EXEC_CACHE: "OrderedDict[Any, Dict[str, Any]]" = OrderedDict()
_EXEC_CACHE_MAX = 128


def clear_executable_cache():
    _EXEC_CACHE.clear()


def executable_cache_info() -> Dict[str, int]:
    return {"fingerprints": len(_EXEC_CACHE),
            "executables": sum(len(e["fns"]) for e in _EXEC_CACHE.values())}


class ExecutionPlan:
    """Static schedule + executable cache for one realized pipeline."""

    def __init__(self, pipeline):
        from .elements import AppSink, AppSrc

        order: List[Element] = pipeline._order
        links = pipeline.links
        slot_of: Dict[Tuple[str, int], int] = {}
        for l in links:
            key = (l.src.name, l.src_pad)
            if key not in slot_of:
                slot_of[key] = len(slot_of)
        self.n_slots = len(slot_of)

        in_links: Dict[str, list] = {e.name: [] for e in order}
        for l in links:
            in_links[l.dst.name].append(l)

        ops: List[PlanOp] = []
        for elem in order:
            lk = sorted(in_links[elem.name], key=lambda l: l.dst_pad)
            in_slots = tuple(slot_of[(l.src.name, l.src_pad)] for l in lk)
            max_pad = max((l.src_pad for l in links if l.src is elem),
                          default=-1)
            out_slots = tuple(slot_of.get((elem.name, p), -1)
                              for p in range(max_pad + 1))
            injectable = isinstance(elem, AppSrc) or \
                getattr(elem, "is_host_source", False)
            ops.append(PlanOp(elem, in_slots, out_slots,
                              injectable=injectable,
                              is_sink=isinstance(elem, AppSink),
                              is_host_sink=getattr(elem, "is_host_sink",
                                                   False)))
        self.ops = ops
        impure = [op.elem for op in ops
                  if getattr(op.elem, "host_impure", False)]
        self.query_sources = [op.elem for op in ops if op.is_query_src]
        self.query_sinks = [op.elem for op in ops if op.is_query_sink]
        #: pipeline contains tensor_query_client elements (run deferred)
        self.has_query_clients = any(op.is_query_client for op in ops)
        #: server pipeline whose impure elements are exactly one serversrc
        #: plus serversinks, so a batcher can drive it hoisted
        self.query_batchable = (
            len(self.query_sources) == 1 and bool(self.query_sinks)
            and all(getattr(e, "is_query_source", False)
                    or getattr(e, "is_query_sink", False) for e in impure)
            and all(op.is_query_src for op in ops if not op.in_slots))
        #: query-batchable server whose serve element decodes a stream:
        #: decode state is plan state carried across ticks
        self.stream_serving = self.query_batchable and any(
            getattr(op.elem, "is_stream_serve", False) for op in ops)
        self.fingerprint = self._fingerprint(order, links)

    @staticmethod
    def _fingerprint(order: List[Element], links) -> Tuple:
        elems = tuple(e.plan_signature() for e in order)
        wiring = tuple((l.src.name, l.src_pad, l.dst.name, l.dst_pad)
                       for l in links)
        return (elems, wiring)

    # -- single-frame execution ------------------------------------------------
    def _exec_ops(self, params: dict, ctx: PipelineContext, vals: List[Any],
                  outputs: Dict[str, StreamBuffer],
                  inputs: Dict[str, StreamBuffer], start: int,
                  hoist_io: bool, hoist_queries: bool, defer_queries: bool
                  ) -> Optional[Tuple[int, StreamBuffer]]:
        """Walk ``ops[start:]`` mutating ``vals``/``outputs``/``ctx``.
        Returns None when the schedule completes, or ``(op_idx, request)``
        when ``defer_queries`` and a query client is reached."""
        for idx in range(start, len(self.ops)):
            op = self.ops[idx]
            ins = [vals[s] for s in op.in_slots]
            injectable = op.injectable or (hoist_queries and op.is_query_src)
            if injectable and op.name in inputs:
                ins = [inputs[op.name]]
                if getattr(op.elem, "is_host_source", False) or \
                        (hoist_queries and op.is_query_src):
                    # the injected, already-decoded frame IS the pull
                    if op.out_slots and op.out_slots[0] >= 0:
                        vals[op.out_slots[0]] = ins[0]
                    continue
            elif hoist_io and getattr(op.elem, "is_host_source", False):
                raise ValueError(
                    f"{op.name}: hoisted execution requires an injected "
                    f"input frame for every host-driven source")
            elif hoist_queries and op.is_query_src:
                raise ValueError(
                    f"{op.name}: hoisted query serving requires an injected "
                    f"request frame for every serversrc")
            if (hoist_io and op.is_host_sink) or \
                    (hoist_queries and op.is_query_sink):
                # capture instead of the impure push
                outputs[op.name] = ins[0]
                continue
            if defer_queries and op.is_query_client:
                return idx, ins[0]
            outs = op.elem.apply(params.get(op.name, {}), ins, ctx)
            for i, o in enumerate(outs):
                if i < len(op.out_slots) and op.out_slots[i] >= 0:
                    vals[op.out_slots[i]] = o
            if op.is_sink and outs:
                outputs[op.name] = outs[0]
        return None

    def run(self, params: dict, state: dict,
            inputs: Optional[Dict[str, StreamBuffer]] = None,
            hoist_io: bool = False, hoist_queries: bool = False
            ) -> Tuple[Dict[str, StreamBuffer], dict]:
        """One frame through the static schedule -> (outputs, next_state)."""
        inputs = inputs or {}
        ctx = PipelineContext(state)
        vals: List[Any] = [None] * self.n_slots
        outputs: Dict[str, StreamBuffer] = {}
        self._exec_ops(params, ctx, vals, outputs, inputs, 0,
                       hoist_io, hoist_queries, defer_queries=False)
        return outputs, ctx.next_state

    def run_deferred(self, params: dict, state: dict,
                     inputs: Optional[Dict[str, StreamBuffer]] = None):
        """Start one frame, pausing at the first un-answered query client:
        ``(outputs, next_state)`` when no client is on the frame's path,
        else a :class:`PendingQuery` whose ``request`` is the buffer the
        client was about to send."""
        inputs = inputs or {}
        ctx = PipelineContext(state)
        vals: List[Any] = [None] * self.n_slots
        outputs: Dict[str, StreamBuffer] = {}
        res = self._exec_ops(params, ctx, vals, outputs, inputs, 0,
                             hoist_io=False, hoist_queries=False,
                             defer_queries=True)
        if res is None:
            return outputs, ctx.next_state
        return PendingQuery(self, params, inputs, ctx, vals, outputs, *res)

    # -- cached executables ----------------------------------------------------
    def _cache(self) -> Dict[str, Any]:
        ent = _EXEC_CACHE.get(self.fingerprint)
        if ent is None:
            ent = {"fns": {}}
            _EXEC_CACHE[self.fingerprint] = ent
            while len(_EXEC_CACHE) > _EXEC_CACHE_MAX:
                _EXEC_CACHE.popitem(last=False)
        else:
            _EXEC_CACHE.move_to_end(self.fingerprint)
        return ent

    def compiled_serve_tick(self, state: dict) -> Callable:
        """Stateful decode tick ``(params, state, inputs) -> (outputs,
        next_state)`` for a ``stream_serving`` plan: one hoisted ``run``.
        The batch lives inside the plan state (slot axis of the cache plus
        the active mask), so joins and leaves never change the callable;
        the cache key carries ``structure_key(state)``, so two serve
        configurations with different slot counts or cache layouts never
        share an entry and the same structure never builds a new one."""
        fns = self._cache()["fns"]
        key = ("serve_tick", structure_key(state))
        if key not in fns:
            def serve_tick(params, st, inputs, _self=self):
                return _self.run(params, st, inputs, hoist_io=True,
                                 hoist_queries=True)
            fns[key] = serve_tick
        return fns[key]


class PendingQuery:
    """A frame paused mid-schedule at a query client, awaiting its answer.

    ``request`` is the StreamBuffer the client was about to ship;
    ``resume(answer)`` continues the walk, returning ``(outputs,
    next_state)`` on completion or ``self`` again if a later client pauses
    the frame.  ``endpoint`` records where the scheduler shipped the
    request."""

    __slots__ = ("plan", "params", "inputs", "ctx", "vals", "outputs",
                 "op_idx", "request", "endpoint", "redispatches")

    def __init__(self, plan: ExecutionPlan, params: dict, inputs: dict,
                 ctx: PipelineContext, vals: List[Any],
                 outputs: Dict[str, StreamBuffer], op_idx: int,
                 request: StreamBuffer):
        self.plan = plan
        self.params = params
        self.inputs = inputs
        self.ctx = ctx
        self.vals = vals
        self.outputs = outputs
        self.op_idx = op_idx
        self.request = request
        self.endpoint = None
        self.redispatches = 0

    @property
    def client(self):
        """The tensor_query_client element this frame is paused at."""
        return self.plan.ops[self.op_idx].elem

    def resume(self, answer: StreamBuffer):
        """Inject the answer as the paused client's output and run on."""
        op = self.plan.ops[self.op_idx]
        if op.out_slots and op.out_slots[0] >= 0:
            self.vals[op.out_slots[0]] = answer
        if op.is_sink:
            self.outputs[op.name] = answer
        res = self.plan._exec_ops(self.params, self.ctx, self.vals,
                                  self.outputs, self.inputs,
                                  self.op_idx + 1, hoist_io=False,
                                  hoist_queries=False, defer_queries=True)
        if res is None:
            return self.outputs, self.ctx.next_state
        self.op_idx, self.request = res
        self.endpoint = None
        return self
